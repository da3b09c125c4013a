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
    depth_and_sizes,
    encoder_sizes,
    estimate_bottleneck_size,
    infer_depth_from_scale,
)

__all__ = [
    "BN_MOMENTUM",
    "BatchNorm",
    "ConvTranspose",
    "max_pool2x2",
    "Conv",
    "ConvBlock",
    "LayerNormReLU",
    "infer_depth_from_scale",
    "custom_depth_from_scale",
    "depth_and_sizes",
    "estimate_bottleneck_size",
    "encoder_sizes",
]
