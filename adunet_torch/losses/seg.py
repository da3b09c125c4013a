"""Segmentation losses: BCE, categorical CE, Dice and the protocol hybrids.

Port of ``adunet/losses/seg.py``: ``binary_crossentropy`` /
``categorical_crossentropy`` are Keras's on probabilities (clip to
[1e-7, 1 - 1e-7], mean over pixels), ``dice_loss`` is 1 - soft Dice, hybrid
A is 0.4 CE + 0.6 Dice and hybrid B 0.5 BCE + 1.0 Dice. Every loss takes
``(y_true, y_pred)`` and returns a float32 0-d tensor.
"""

from __future__ import annotations

from typing import Callable

import torch

from adunet_torch.metrics.seg import dice_coefficient

__all__ = [
    "binary_crossentropy",
    "categorical_crossentropy",
    "make_weighted_ce_loss",
    "dice_loss",
    "make_hybrid_ce_dice_loss",
    "make_bce_dice_loss",
]

_EPS = 1e-7

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _clipped(y_pred: torch.Tensor) -> torch.Tensor:
    return torch.clamp(y_pred.to(torch.float32), _EPS, 1.0 - _EPS)


def binary_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    t, p = y_true.to(torch.float32), _clipped(y_pred)
    return torch.mean(-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)))


def categorical_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """-Σ_c y log p per pixel, mean over pixels (the softmax head's loss)."""
    return torch.mean(-torch.sum(y_true.to(torch.float32) * torch.log(_clipped(y_pred)), dim=-1))


def make_weighted_ce_loss(class_weights) -> Loss:
    """Categorical CE with each pixel's term scaled by the weight of its true
    class, mean over all pixels."""
    w = torch.as_tensor(class_weights, dtype=torch.float32)

    def loss_fn(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        t = y_true.to(torch.float32)
        return torch.mean(-torch.sum(w.to(t.device) * t * torch.log(_clipped(y_pred)), dim=-1))

    loss_fn.__name__ = "weighted_categorical_crossentropy"
    return loss_fn


def dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return 1.0 - dice_coefficient(y_true, y_pred)


def make_hybrid_ce_dice_loss(alpha: float, beta: float) -> Loss:
    def loss_fn(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        return alpha * binary_crossentropy(y_true, y_pred) + beta * dice_loss(y_true, y_pred)

    loss_fn.__name__ = "hybrid_ce_dice"
    return loss_fn


def make_bce_dice_loss(bce_weight: float, dice_weight: float) -> Loss:
    def loss_fn(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        return bce_weight * binary_crossentropy(y_true, y_pred) + dice_weight * dice_loss(y_true, y_pred)

    loss_fn.__name__ = "bce_dice"
    return loss_fn
