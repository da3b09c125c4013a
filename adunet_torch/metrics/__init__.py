"""Quality metrics: PSNR / SSIM / MS-SSIM (tf.image semantics)."""

from adunet_torch.metrics.psnr_ssim import (
    msssim_power_factors_for,
    mse_per_image,
    psnr,
    ssim,
    ssim_multiscale,
)

__all__ = ["psnr", "mse_per_image", "ssim", "ssim_multiscale", "msssim_power_factors_for"]
