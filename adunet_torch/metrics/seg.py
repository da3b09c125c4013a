"""Segmentation metrics: soft Dice / IoU, hard mIoU, pooled whole-set metrics.

Port of ``adunet/metrics/seg.py``: the same formulas in float32 over NHWC
tensors (probabilities in ``y_pred``), each returning a 0-d tensor on the
inputs' device. Soft metrics clip the prediction to [1e-7, 1 - 1e-7] and use
smooth 1e-6, as the reference.

``PooledMetric`` carries a metric that pools over the evaluation set
(whole-batch Dice, precision / recall, hard mIoU): its batch value, the
component sums the fit loop accumulates per sample (``stats``), and the
host-side ``finalize`` of the summed components (:117-144).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "dice_coefficient",
    "iou_score",
    "mean_iou",
    "global_dice_coefficient",
    "binary_accuracy",
    "precision",
    "recall",
    "PooledMetric",
    "pooled_global_dice",
    "pooled_precision",
    "pooled_recall",
    "pooled_mean_iou",
]

_CLIP_LO = 1e-7
_CLIP_HI = 1.0 - 1e-7


def _soft(y_true: torch.Tensor, y_pred: torch.Tensor):
    return y_true.to(torch.float32), torch.clamp(y_pred.to(torch.float32), _CLIP_LO, _CLIP_HI)


def dice_coefficient(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = 1e-6) -> torch.Tensor:
    """Soft Dice over (N, H, W, C), mean over the batch."""
    t, p = _soft(y_true, y_pred)
    intersection = torch.sum(t * p, dim=(1, 2, 3))
    union = torch.sum(t + p, dim=(1, 2, 3))
    return torch.mean((2.0 * intersection + smooth) / (union + smooth))


def iou_score(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = 1e-6) -> torch.Tensor:
    """Soft IoU over (N, H, W, C), mean over the batch."""
    t, p = _soft(y_true, y_pred)
    intersection = torch.sum(t * p, dim=(1, 2, 3))
    union = torch.sum(t + p, dim=(1, 2, 3)) - intersection
    return torch.mean((intersection + smooth) / (union + smooth))


def _confusion(y_true: torch.Tensor, y_pred: torch.Tensor, num_classes: int):
    """Per-class (intersection, union) of the argmaxed label and prediction maps."""
    t1 = F.one_hot(torch.argmax(y_true, dim=-1), num_classes).to(torch.float32)
    p1 = F.one_hot(torch.argmax(y_pred, dim=-1), num_classes).to(torch.float32)
    axes = tuple(range(t1.dim() - 1))
    inter = torch.sum(t1 * p1, dim=axes)
    return inter, torch.sum(t1, dim=axes) + torch.sum(p1, dim=axes) - inter


def mean_iou(y_true: torch.Tensor, y_pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Hard mIoU over one-hot labels and class probabilities; classes absent
    from both label and prediction are left out of the mean."""
    inter, union = _confusion(y_true, y_pred, num_classes)
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0), 0.0)
    return torch.sum(iou) / torch.clamp(present.to(torch.float32).sum(), min=1.0)


def global_dice_coefficient(y_true: torch.Tensor, y_pred: torch.Tensor,
                            smooth: float = 1e-6) -> torch.Tensor:
    """Whole-batch Dice (sums over every element, no clip): the vanilla
    trainer's variant."""
    t, p = y_true.to(torch.float32), y_pred.to(torch.float32)
    return (2.0 * torch.sum(t * p) + smooth) / (torch.sum(t + p) + smooth)


def _hard(y_pred: torch.Tensor, threshold: float) -> torch.Tensor:
    return (y_pred.to(torch.float32) > threshold).to(torch.float32)


def binary_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return torch.mean((_hard(y_pred, threshold) == y_true.to(torch.float32)).to(torch.float32))


def precision(y_true: torch.Tensor, y_pred: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    t, pred = y_true.to(torch.float32), _hard(y_pred, threshold)
    tp = torch.sum(pred * t)
    return tp / torch.clamp(tp + torch.sum(pred * (1.0 - t)), min=1e-12)


def recall(y_true: torch.Tensor, y_pred: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    t, pred = y_true.to(torch.float32), _hard(y_pred, threshold)
    tp = torch.sum(pred * t)
    return tp / torch.clamp(tp + torch.sum((1.0 - pred) * t), min=1e-12)


class PooledMetric(NamedTuple):
    """A metric pooled over the evaluation set: ``batch_fn(y_true, y_pred)``
    its batch value; ``stats(y_true, y_pred)`` its component sums over the
    batch ({name: 0-d or (K,) tensor}), which add across batches;
    ``finalize({name: np.ndarray})`` the epoch value from the summed
    components."""

    batch_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    stats: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]
    finalize: Callable[[Dict[str, np.ndarray]], float]


def pooled_global_dice(smooth: float = 1e-6) -> PooledMetric:
    """Whole-set Dice: (2 Σ t·p + smooth) / (Σ (t + p) + smooth)."""

    def stats(y_true, y_pred):
        t, p = y_true.to(torch.float32), y_pred.to(torch.float32)
        return {"num": 2.0 * torch.sum(t * p), "den": torch.sum(t + p)}

    def finalize(c):
        return float((c["num"] + smooth) / (c["den"] + smooth))

    return PooledMetric(functools.partial(global_dice_coefficient, smooth=smooth), stats, finalize)


def pooled_precision(threshold: float = 0.5) -> PooledMetric:
    """Whole-set precision: true positives over predicted positives."""

    def stats(y_true, y_pred):
        pred = _hard(y_pred, threshold)
        return {"tp": torch.sum(pred * y_true.to(torch.float32)), "pp": torch.sum(pred)}

    def finalize(c):
        return float(c["tp"] / max(float(c["pp"]), 1e-12))

    return PooledMetric(functools.partial(precision, threshold=threshold), stats, finalize)


def pooled_recall(threshold: float = 0.5) -> PooledMetric:
    """Whole-set recall: true positives over actual positives."""

    def stats(y_true, y_pred):
        t = y_true.to(torch.float32)
        return {"tp": torch.sum(_hard(y_pred, threshold) * t), "ap": torch.sum(t)}

    def finalize(c):
        return float(c["tp"] / max(float(c["ap"]), 1e-12))

    return PooledMetric(functools.partial(recall, threshold=threshold), stats, finalize)


def pooled_mean_iou(num_classes: int) -> PooledMetric:
    """Whole-set hard mIoU (one confusion matrix over the epoch), classes
    absent from the whole set left out."""

    def stats(y_true, y_pred):
        inter, union = _confusion(y_true, y_pred, num_classes)
        return {"inter": inter, "union": union}

    def finalize(c):
        inter, union = np.asarray(c["inter"]), np.asarray(c["union"])
        present = union > 0
        iou = np.where(present, inter / np.maximum(union, 1.0), 0.0)
        return float(iou.sum() / max(present.sum(), 1))

    return PooledMetric(functools.partial(mean_iou, num_classes=num_classes), stats, finalize)
