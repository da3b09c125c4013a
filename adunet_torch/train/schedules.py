"""Learning-rate schedule and optimizer.

Port of ``adunet/train/schedules.py``: Adam with the Keras defaults (b1 0.9,
b2 0.999, **eps 1e-7**, where ``torch.optim.Adam`` defaults to 1e-8) and an
optional Keras ``CosineDecay``. Adam's update is optax's: torch divides the
bias-corrected first moment by ``sqrt(v) / sqrt(1 - b2^t) + eps``, which is
optax's ``m_hat / (sqrt(v_hat) + eps)``.

A schedule is counted as optax counts it: the k-th update (from 0) runs at
``schedule(k)``; ``TrainState.apply_gradients`` sets the rate from its step
before each update. The learning rate of a ``torch.optim`` optimizer is
always mutable; ``inject_lr=True`` marks the optimizer whose rate the fit
loop may rescale (ReduceLROnPlateau), as ``optax.inject_hyperparams`` does in
the reference, and it refuses a schedule for the same reason (:39-49).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

__all__ = ["Adam", "cosine_decay_schedule", "make_optimizer"]


def cosine_decay_schedule(initial_lr: float, decay_steps: int, alpha: float = 0.0
                          ) -> Callable[[int], float]:
    """Keras CosineDecay(initial_lr, decay_steps, alpha), flat past the end."""

    def schedule(step: int) -> float:
        frac = min(step / max(decay_steps, 1), 1.0)
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return initial_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` with the reference's hyperparameters, an optional
    schedule over the update count and the ``inject_lr`` mark."""

    def __init__(self, params: Iterable, learning_rate: float,
                 schedule: Optional[Callable[[int], float]] = None, inject_lr: bool = False,
                 foreach: Optional[bool] = None):
        lr = schedule(0) if schedule is not None else learning_rate
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-7, foreach=foreach)
        self.schedule = schedule
        self.inject_lr = inject_lr

    def set_update_count(self, count: int) -> None:
        """Set the rate of the next update from the schedule, if any."""
        if self.schedule is not None:
            lr = self.schedule(count)
            for group in self.param_groups:
                group["lr"] = lr


def make_optimizer(
    params: Iterable,
    learning_rate: float,
    *,
    cosine_decay_steps: int | None = None,
    cosine_alpha: float = 0.0,
    inject_lr: bool = False,
) -> Adam:
    """Adam (eps 1e-7) over ``params``; optional cosine schedule."""
    schedule = None
    if cosine_decay_steps is not None:
        if inject_lr:
            raise ValueError(
                "cosine_decay_steps and inject_lr are mutually exclusive: the "
                "schedule would overwrite any runtime learning-rate edit on "
                "the next optimizer update."
            )
        schedule = cosine_decay_schedule(learning_rate, cosine_decay_steps, cosine_alpha)
    return Adam(params, learning_rate, schedule=schedule, inject_lr=inject_lr)
