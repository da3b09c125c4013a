"""Model families: the adaptive and vanilla SR U-Nets, the two segmentation U-Nets and
the joint SR + segmentation U-Net."""

from adunet_torch.models.joint import JointSRSegUNet, build_joint_unet
from adunet_torch.models.seg_adaptive import AdaptiveSegUNet, build_adaptive_depth_unet
from adunet_torch.models.seg_vanilla import VanillaSegUNet, build_unet
from adunet_torch.models.sr_adaptive import AdaptiveSRUNet, build_super_resolution_unet
from adunet_torch.models.sr_vanilla import VanillaSRUNet, build_vanilla_sr_unet

__all__ = [
    "AdaptiveSRUNet",
    "build_super_resolution_unet",
    "VanillaSRUNet",
    "build_vanilla_sr_unet",
    "AdaptiveSegUNet",
    "build_adaptive_depth_unet",
    "VanillaSegUNet",
    "build_unet",
    "JointSRSegUNet",
    "build_joint_unet",
]
