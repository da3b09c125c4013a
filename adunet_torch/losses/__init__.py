"""Losses: SR (charbonnier, l1, mse, SSIM, the PSNR metric, the combined
cocktail with its VGG19 perceptual term) and segmentation (BCE, categorical
CE, Dice, the protocol hybrids)."""

from adunet_torch.losses.perceptual import (
    VGG19Features,
    load_vgg19_params,
    make_perceptual_fn,
    vgg19_preprocess,
)
from adunet_torch.losses.seg import (
    binary_crossentropy,
    categorical_crossentropy,
    dice_loss,
    make_bce_dice_loss,
    make_hybrid_ce_dice_loss,
    make_weighted_ce_loss,
)
from adunet_torch.losses.sr import (
    build_losses_and_metrics,
    charbonnier_loss,
    l1_loss,
    mse_loss,
    psnr_metric,
    ssim_loss,
)

__all__ = [
    "VGG19Features",
    "vgg19_preprocess",
    "load_vgg19_params",
    "make_perceptual_fn",
    "charbonnier_loss",
    "l1_loss",
    "mse_loss",
    "ssim_loss",
    "psnr_metric",
    "build_losses_and_metrics",
    "binary_crossentropy",
    "categorical_crossentropy",
    "make_weighted_ce_loss",
    "dice_loss",
    "make_hybrid_ce_dice_loss",
    "make_bce_dice_loss",
]
