"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: K1 fused LayerNorm+ReLU, K2 64->64 3x3 SAME conv (and its
halo-row mode for a height split over processes) and K2's backward (dx, dw,
db); ``ops`` names K1 and K2's forwards as ``torch.library`` ops for
exported programs."""

from adunet_torch.kernels.conv64 import (
    conv3x3_rows,
    conv3x3_rows_plain,
    conv3x3_same,
    conv3x3_same_backward,
    conv3x3_same_backward_plain,
    conv3x3_same_plain,
    supported,
)
from adunet_torch.kernels.fused_norm import layer_norm_relu, layer_norm_relu_plain
from adunet_torch.kernels import ops  # registers the adunet_torch:: ops

__all__ = [
    "layer_norm_relu",
    "layer_norm_relu_plain",
    "conv3x3_same",
    "conv3x3_same_plain",
    "conv3x3_same_backward",
    "conv3x3_same_backward_plain",
    "conv3x3_rows",
    "conv3x3_rows_plain",
    "supported",
]
