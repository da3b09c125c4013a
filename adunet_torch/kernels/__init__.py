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

# every launch counter of the wrappers: (wrapper, attribute)
_COUNTERS = (
    (layer_norm_relu, "launches"),
    (layer_norm_relu, "backward_launches"),
    (conv3x3_same, "launches"),
    (conv3x3_rows, "launches"),
    (conv3x3_same_backward, "launches"),
    (conv3x3_same_backward, "rows_launches"),
)


def launch_counts() -> tuple:
    """The wrappers' launch counters, in ``_COUNTERS``' order."""
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def add_launches(counts: tuple) -> None:
    """Add ``counts`` (in ``launch_counts``' order) to the counters: a CUDA
    graph's replay launches the kernels its capture counted, without their
    wrappers."""
    for (fn, name), n in zip(_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)

__all__ = [
    "add_launches",
    "launch_counts",
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
