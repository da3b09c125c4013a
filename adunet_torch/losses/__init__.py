"""SR losses and the training PSNR metric."""

from adunet_torch.losses.sr import (
    build_losses_and_metrics,
    charbonnier_loss,
    l1_loss,
    mse_loss,
    psnr_metric,
    ssim_loss,
)

__all__ = [
    "charbonnier_loss",
    "l1_loss",
    "mse_loss",
    "ssim_loss",
    "psnr_metric",
    "build_losses_and_metrics",
]
