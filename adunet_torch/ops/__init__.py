"""Image ops: fractional resize (banded kernel on the card, dense matmul on
the CPU), degradation, luma, residual add."""

from adunet_torch.ops.image import clipped_residual_add, degrade, rgb_to_luma_bt601
from adunet_torch.ops.resize import (
    resize,
    resize_by_scale,
    resize_matrix,
    resize_to_match,
    scaled_size,
)

__all__ = [
    "resize",
    "resize_by_scale",
    "resize_to_match",
    "scaled_size",
    "resize_matrix",
    "degrade",
    "rgb_to_luma_bt601",
    "clipped_residual_add",
]
