"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: K1 fused LayerNorm+ReLU, K2 64->64 3x3 SAME conv (and its
halo-row mode for a height split over processes) and K2's backward (dx, dw,
db), and the banded resize (forward and backward; its plain version is the
dense product, ``resize_band.resize_band_plain``); ``ops`` names K1 and K2's
forwards and the resize as ``torch.library`` ops for exported programs."""

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
from adunet_torch.kernels.resize_band import resize_band
from adunet_torch.kernels import ops  # registers the adunet_torch:: ops

# every launch counter of the wrappers: (wrapper, attribute); K1's and K2's
# six first, in the order ``launch_counts`` gives them
_COUNTERS = (
    (layer_norm_relu, "launches"),
    (layer_norm_relu, "backward_launches"),
    (conv3x3_same, "launches"),
    (conv3x3_rows, "launches"),
    (conv3x3_same_backward, "launches"),
    (conv3x3_same_backward, "rows_launches"),
    (resize_band, "launches"),
)


# K1's forward and backward launches that took a conv's bias: kept out of
# ``_COUNTERS``, whose seven ``all_launch_counts`` gives and callers unpack
_BIAS_COUNTERS = (
    (layer_norm_relu, "bias_launches"),
    (layer_norm_relu, "bias_backward_launches"),
)


def all_launch_counts() -> tuple:
    """Every launch counter, in ``_COUNTERS``' order."""
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def bias_launch_counts() -> tuple:
    """K1's forward and backward launches that took a conv's bias."""
    return tuple(getattr(fn, name) for fn, name in _BIAS_COUNTERS)


def launch_counts() -> tuple:
    """K1's and K2's six launch counters (K1, K1 backward, K2, K2 halo rows,
    K2 backward, K2 backward halo rows), the first six of ``_COUNTERS``."""
    return all_launch_counts()[:6]


def add_launches(counts: tuple) -> None:
    """Add ``counts`` (in the order of ``all_launch_counts() +
    bias_launch_counts()``; a shorter tuple adds to the first counters) to
    the counters: a CUDA graph's replay launches the kernels its capture
    counted, without their wrappers."""
    for (fn, name), n in zip(_COUNTERS + _BIAS_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)

__all__ = [
    "add_launches",
    "all_launch_counts",
    "bias_launch_counts",
    "launch_counts",
    "layer_norm_relu",
    "layer_norm_relu_plain",
    "conv3x3_same",
    "conv3x3_same_plain",
    "conv3x3_same_backward",
    "conv3x3_same_backward_plain",
    "conv3x3_rows",
    "conv3x3_rows_plain",
    "resize_band",
    "supported",
]
