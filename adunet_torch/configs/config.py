"""The trainers' configs: the port's copies of
``adunet/configs/config.py``'s ``SRTrainConfig``, ``ProtocolConfig``,
``PROTOCOLS`` and ``SegTrainConfig`` (same fields, defaults and checks, so a
run writes the reference's ``config.json`` payload), plus the port's
``device``."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["SRTrainConfig", "ProtocolConfig", "PROTOCOLS", "SegTrainConfig"]


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


@dataclass
class ProtocolConfig:
    """A segmentation training protocol preset."""

    key: str
    description: str
    loss: str  # "hybrid_ce_dice" | "bce_dice", weighted by loss_alpha / loss_beta
    loss_alpha: float
    loss_beta: float
    initial_lr: float
    epochs: int
    batch_size: int
    cosine_schedule: bool
    early_stopping_patience: Optional[int]


PROTOCOLS: Dict[str, ProtocolConfig] = {
    "A": ProtocolConfig(
        key="A",
        description="MSCA-UNet hybrid loss (0.4*CE + 0.6*Dice) with cosine annealing",
        loss="hybrid_ce_dice",
        loss_alpha=0.4,
        loss_beta=0.6,
        initial_lr=1e-3,
        epochs=100,
        batch_size=8,
        cosine_schedule=True,
        early_stopping_patience=15,
    ),
    "B": ProtocolConfig(
        key="B",
        description="D2HU-Net BCE+Dice loss (0.5*BCE + 1.0*Dice)",
        loss="bce_dice",
        loss_alpha=0.5,
        loss_beta=1.0,
        initial_lr=3e-4,
        epochs=200,
        batch_size=16,
        cosine_schedule=False,
        early_stopping_patience=None,
    ),
}


@dataclass
class SegTrainConfig:
    protocol: str = "A"
    epochs: int = 0  # 0 keeps the protocol's
    batch_size: int = 0  # 0 keeps the protocol's
    base_channels: int = 64
    depth: int = 4
    image_size: int = 256
    seed: int = 42
    patience: Optional[int] = None  # None keeps the protocol's
    mixed_precision: bool = False
    model_dir: str = "runs/models"
    log_dir: str = "runs/logs"
    run_name: Optional[str] = None
    train_images: Optional[str] = None
    train_masks: Optional[str] = None
    val_images: Optional[str] = None
    val_masks: Optional[str] = None
    limit: Optional[int] = None
    threshold: float = 0.5
    augment: bool = True
    n_devices: Optional[int] = None
    # precise-BN: before each validation, population BatchNorm statistics
    # from this many un-augmented training batches (0 keeps the EMA)
    precise_bn: int = 0
    async_checkpoint: bool = False
    cache_decoded: bool = False
    # keep the validation batches on the device between epochs
    val_device_cache: bool = True
    device: str = "cuda"

    def resolved(self) -> "SegTrainConfig":
        """Zero / None fields filled from the protocol's preset."""
        proto = PROTOCOLS[self.protocol]
        return dataclasses.replace(
            self,
            epochs=self.epochs or proto.epochs,
            batch_size=self.batch_size or proto.batch_size,
            patience=self.patience if self.patience is not None else proto.early_stopping_patience,
        )
