"""Hyperparameter tuning: optuna when available, the built-in TPE engine
otherwise (``search``), and trial lanes of the vanilla SR U-Net on one card
(``parallel``, constant-liar batched asks)."""

from adunet_torch.tune.parallel import BatchedVanillaSRTuner, group_trials_by
from adunet_torch.tune.search import (
    RandomSampler,
    Study,
    TPESampler,
    Trial,
    TrialPruned,
    create_study,
)

__all__ = [
    "Study",
    "Trial",
    "TrialPruned",
    "TPESampler",
    "RandomSampler",
    "create_study",
    "BatchedVanillaSRTuner",
    "group_trials_by",
]
