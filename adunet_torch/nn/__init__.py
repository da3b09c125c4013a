"""Depth policies and building blocks."""

from adunet_torch.nn.blocks import Conv, ConvBlock, LayerNormReLU
from adunet_torch.nn.depth_policy import (
    custom_depth_from_scale,
    encoder_sizes,
    estimate_bottleneck_size,
)

__all__ = [
    "Conv",
    "ConvBlock",
    "LayerNormReLU",
    "custom_depth_from_scale",
    "estimate_bottleneck_size",
    "encoder_sizes",
]
