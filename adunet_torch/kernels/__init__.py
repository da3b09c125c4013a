"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: K1 fused LayerNorm+ReLU, K2 64->64 3x3 SAME conv (and its
halo-row mode for a height split over processes) and K2's backward (dx, dw,
db), K3 the float32 3x3 SAME conv at the channel counts K2 refuses where no
gradient is wanted (``conv3x3_f32``; the function shadows its submodule),
and the banded resize (forward and backward; its plain version is the
dense product, ``resize_band.resize_band_plain``); ``ops`` names K1, K2 and
K3's forwards and the resize as ``torch.library`` ops for exported programs.
``_route`` holds the one rule that picks what each op runs; every launch
counter is registered here, once (``_COUNTERS``)."""

from adunet_torch.kernels.conv64 import (
    conv3x3_rows,
    conv3x3_rows_plain,
    conv3x3_same,
    conv3x3_same_backward,
    conv3x3_same_backward_plain,
    conv3x3_same_plain,
    supported,
)
from adunet_torch.kernels.conv3x3_f32 import conv3x3_f32
from adunet_torch.kernels.fused_norm import layer_norm_relu, layer_norm_relu_plain
from adunet_torch.kernels.resize_band import resize_band
from adunet_torch.kernels import ops  # registers the adunet_torch:: ops

# every launch counter, in order: (wrapper, attribute); the first seven are
# ``all_launch_counts``', then K1's launches that took a conv's bias, then K3's
_COUNTERS = (
    (layer_norm_relu, "launches"),
    (layer_norm_relu, "backward_launches"),
    (conv3x3_same, "launches"),
    (conv3x3_rows, "launches"),
    (conv3x3_same_backward, "launches"),
    (conv3x3_same_backward, "rows_launches"),
    (resize_band, "launches"),
    (layer_norm_relu, "bias_launches"),
    (layer_norm_relu, "bias_backward_launches"),
    (conv3x3_f32, "launches"),
)


def launch_snapshot() -> tuple:
    """Every launch counter, in ``_COUNTERS``' order (ten)."""
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def launches_since(before: tuple) -> tuple:
    """The launches counted since ``launch_snapshot()`` gave ``before``."""
    return tuple(a - b for a, b in zip(launch_snapshot(), before))


def all_launch_counts() -> tuple:
    """K1, K1 backward, K2, K2 halo rows, K2 backward, K2 backward halo rows
    and the resize: the first seven of ``launch_snapshot``."""
    return launch_snapshot()[:7]


def add_launches(counts: tuple) -> None:
    """Add ``counts``, a whole snapshot's worth (``launches_since``), to the
    counters: a CUDA graph's replay launches the kernels its capture
    counted, without their wrappers."""
    if len(counts) != len(_COUNTERS):
        raise ValueError(f"add_launches: {len(counts)} counts for {len(_COUNTERS)} counters")
    for (fn, name), n in zip(_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for fn, name in _COUNTERS:
        setattr(fn, name, 0)


__all__ = [
    "add_launches",
    "all_launch_counts",
    "launch_snapshot",
    "launches_since",
    "reset_launches",
    "layer_norm_relu",
    "layer_norm_relu_plain",
    "conv3x3_same",
    "conv3x3_same_plain",
    "conv3x3_same_backward",
    "conv3x3_same_backward_plain",
    "conv3x3_rows",
    "conv3x3_rows_plain",
    "conv3x3_f32",
    "resize_band",
    "supported",
]
