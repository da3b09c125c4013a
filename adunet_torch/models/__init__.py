"""Model families: the adaptive SR U-Net."""

from adunet_torch.models.sr_adaptive import AdaptiveSRUNet, build_super_resolution_unet

__all__ = ["AdaptiveSRUNet", "build_super_resolution_unet"]
