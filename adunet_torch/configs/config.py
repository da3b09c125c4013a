"""The SR trainer's config: the port's copy of
``adunet/configs/config.py::SRTrainConfig`` (same fields, defaults and
checks, so a run writes the reference's ``config.json`` payload), plus the
port's ``device``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["SRTrainConfig"]


@dataclass
class SRTrainConfig:
    scale: float
    batch_size: int = 4
    epochs: int = 100
    learning_rate: float = 1e-4
    loss: str = "charbonnier"  # charbonnier | l1 | combined
    patience: int = 10
    val_split: float = 0.1
    test_split: float = 0.1
    limit: Optional[int] = None
    seed: int = 1234
    patch_size: int = 256
    patches_per_image: int = 4
    eval_stride: Optional[int] = None
    shuffle_buffer: int = 1024
    eval_shave: Optional[int] = None
    depth_override: Optional[int] = None
    max_depth: int = 7
    mixed_precision: bool = False  # bf16 compute / f32 params
    base_channels: int = 64
    residual_head_channels: int = 64
    model_dir: str = "runs/models"
    log_dir: str = "runs/logs"
    run_name: Optional[str] = None
    high_res_dir: Optional[str] = None
    low_res_dir: Optional[str] = None
    image_suffix: str = ".png"
    resume_from: Optional[str] = None
    initial_epoch: int = 0
    # training degrades at a constant 0.5 whatever --scale (the reference's
    # quirk); consistent_degradation trains at the model scale instead
    data_lr_shrink: float = 0.5
    consistent_degradation: bool = False
    remat: bool = False
    remat_levels: Optional[int] = None
    grad_accum: int = 1
    n_devices: Optional[int] = None
    model_shards: int = 1
    profile: bool = False
    preview_patches: int = 3
    vgg19_npz: Optional[str] = None
    uint8_feed: bool = False
    cache_decoded: bool = False
    device_cache: bool = False
    async_checkpoint: bool = False
    ckpt_every: int = 1
    device: str = "cuda"

    def train_degrade_scale(self) -> float:
        return self.scale if self.consistent_degradation else self.data_lr_shrink

    def validate(self) -> None:
        if self.patch_size <= 0:
            raise ValueError("patch_size: expected an integer >= 1.")
        if self.patches_per_image <= 0:
            raise ValueError("patches_per_image: expected a value >= 1.")
        if self.eval_stride is not None and self.eval_stride <= 0:
            raise ValueError("eval_stride: when set, expected a value >= 1.")
        if self.shuffle_buffer < 0:
            raise ValueError("shuffle_buffer: expected a value >= 0.")
        if self.max_depth < 1:
            raise ValueError("max_depth: expected a value >= 1.")
        if self.initial_epoch < 0:
            raise ValueError("initial_epoch: expected a value >= 0.")
        if self.grad_accum < 1:
            raise ValueError("grad_accum: expected a value >= 1.")
        if self.grad_accum > 1 and self.batch_size % self.grad_accum != 0:
            raise ValueError("batch_size must be divisible by grad_accum.")
        if self.initial_epoch >= self.epochs:
            raise ValueError("initial_epoch must be smaller than epochs to resume training.")
        if not 0 < self.scale < 1:
            raise ValueError("scale must be in (0, 1).")
        if self.val_split < 0 or self.test_split < 0:
            raise ValueError("val_split/test_split must be non-negative.")
        if self.val_split + self.test_split == 0:
            raise ValueError(
                "val_split + test_split must be > 0 (the split keeps >= 1 "
                "validation and >= 1 test image)."
            )
        if 1.0 - (self.val_split + self.test_split) <= 0:
            raise ValueError("val_split + test_split consume the whole corpus; nothing left to train on.")
