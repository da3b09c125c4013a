"""Depth policies and building blocks."""

from adunet_torch.nn.blocks import (
    BN_MOMENTUM,
    BatchNorm,
    Conv,
    ConvBlock,
    ConvTranspose,
    LayerNormReLU,
    max_pool2x2,
)
from adunet_torch.nn.depth_policy import (
    custom_depth_from_scale,
    encoder_sizes,
    estimate_bottleneck_size,
)

__all__ = [
    "BN_MOMENTUM",
    "BatchNorm",
    "ConvTranspose",
    "max_pool2x2",
    "Conv",
    "ConvBlock",
    "LayerNormReLU",
    "custom_depth_from_scale",
    "estimate_bottleneck_size",
    "encoder_sizes",
]
