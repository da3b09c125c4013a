"""Training: optimizer and schedule, train state, SR, segmentation and joint
SR + segmentation steps, precise-BN, checkpoints, fit."""

from adunet_torch.train.checkpoint import CheckpointManager
from adunet_torch.train.joint import make_joint_eval_step, make_joint_train_step
from adunet_torch.train.loop import (
    EpochLog,
    FitResult,
    fit,
    make_plateau_state,
    open_tb_writer,
    plateau_update,
    repeat,
)
from adunet_torch.train.schedules import Adam, cosine_decay_schedule, make_optimizer
from adunet_torch.train.seg import (
    make_bn_refresh_step,
    make_precise_bn_program,
    make_seg_eval_step,
    make_seg_train_step,
    metric_finalizers_of,
    precise_batch_stats,
    snapshot_refresh_batches,
)
from adunet_torch.train.sr import (
    DATA_LR_SHRINK,
    lift_per_sample,
    make_sr_device_cache_train_step,
    make_sr_eval_step,
    make_sr_train_step,
    make_sr_val_step,
    make_vanilla_sr_train_step,
    make_vanilla_sr_val_step,
    sr_loss_and_metrics,
)
from adunet_torch.train.state import TrainState, create_train_state

__all__ = [
    "CheckpointManager",
    "EpochLog",
    "FitResult",
    "fit",
    "make_plateau_state",
    "plateau_update",
    "repeat",
    "open_tb_writer",
    "Adam",
    "cosine_decay_schedule",
    "make_optimizer",
    "DATA_LR_SHRINK",
    "lift_per_sample",
    "make_sr_device_cache_train_step",
    "make_sr_eval_step",
    "make_sr_train_step",
    "make_sr_val_step",
    "make_vanilla_sr_train_step",
    "make_vanilla_sr_val_step",
    "sr_loss_and_metrics",
    "make_seg_train_step",
    "make_seg_eval_step",
    "metric_finalizers_of",
    "make_bn_refresh_step",
    "precise_batch_stats",
    "snapshot_refresh_batches",
    "make_precise_bn_program",
    "make_joint_train_step",
    "make_joint_eval_step",
    "TrainState",
    "create_train_state",
]
