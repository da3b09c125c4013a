"""Quality metrics: PSNR / SSIM / MS-SSIM (tf.image semantics) and the
segmentation metrics (soft Dice / IoU, hard mIoU, pooled whole-set metrics)."""

from adunet_torch.metrics.psnr_ssim import (
    msssim_power_factors_for,
    mse_per_image,
    psnr,
    ssim,
    ssim_multiscale,
)
from adunet_torch.metrics.seg import (
    PooledMetric,
    binary_accuracy,
    dice_coefficient,
    global_dice_coefficient,
    iou_score,
    mean_iou,
    pooled_global_dice,
    pooled_mean_iou,
    pooled_precision,
    pooled_recall,
    precision,
    recall,
)

__all__ = [
    "psnr",
    "mse_per_image",
    "ssim",
    "ssim_multiscale",
    "msssim_power_factors_for",
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
