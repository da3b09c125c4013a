"""K3: float32 3x3 stride-1 SAME conv + bias at the channel counts K2's
gate refuses, where no gradient is wanted — a CUDA kernel.

Replaces no TPU kernel: the reference leaves these convs to XLA
(``adunet/nn/blocks.py`` ``conv3x3``, :59), and the port sent them to
cuDNN, whose float32 heuristics take FFT convolutions at the served
flagship's shapes. The CUDA source is ``adunet_torch/csrc/conv3x3_f32.cu``:
an implicit GEMM (M = output pixels, N = C_out, K = 9 C_in) on CUDA cores in
full float32 FMAs (no TF32, no tensor cores), each block an output tile of
16,384 outputs (128 pixels x 128 channels, or 256 x 64 where C_out is not a
multiple of 128; the tile's width 32, 64 or 128 by the image's), each thread
8 pixels x 8 channels in registers; per chunk of 8 input channels the input
slab with its halo (zero outside the image) and the chunk's weights are
staged in shared memory once for all 9 taps, double-buffered with cp.async.
Bound: operations, 18 C_in C_out FLOP per output pixel at 67 TFLOP/s (e.g.
~0.58 ms at (8, 32, 32, 512) -> 512). A launch is one C call of two device
kernels: the pack of the OIHW weights into (9, C_in, C_out) on the card
(``pack_w3x3_f32_kernel``, the layout of ``conv64.pack_weights`` at any
channel count), then the conv (``conv3x3_f32_igemm_kernel``).

``takes`` is the gate: float32 ``x``, ``w`` and bias, a 3x3 kernel, C_in %
8 == 0, C_out % 64 == 0, a shape K2 does not take, and no gradient wanted
(grad mode off, or no argument requiring one). ``nn.blocks.Conv`` asks it
after K2's gate and off the space mesh; everything else goes to
``F.conv2d``, which also keeps every forward that a backward follows.

``conv3x3_f32`` is routed by ``kernels._route``: the op
``adunet_torch::conv3x3_f32`` while exporting, the launch on a CUDA tensor,
and on a CPU tensor the plain version, K2's channel-general
``conv64.conv3x3_same_plain`` (the explicit sum of the 9 taps' float32
matmuls). It has no autograd Function: called where a gradient is wanted
it raises. ``conv3x3_f32.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from adunet_torch.kernels import _build, conv64
from adunet_torch.kernels._route import route

__all__ = ["conv3x3_f32", "conv3x3_f32_plain", "supported", "takes"]

conv3x3_f32_plain = conv64.conv3x3_same_plain


def supported(x_shape, w_shape) -> bool:
    """Kernel applicability for x (B, H, W, C_in) and an OIHW weight: 3x3,
    C_in % 8 == 0 and matching x, C_out % 64 == 0, B, H, W >= 1, and not a
    shape K2 takes (``conv64.supported``)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    bsz, h, wd, c = x_shape
    co, ci, kh, kw = w_shape
    return ((kh, kw) == (3, 3) and c == ci and ci % 8 == 0 and ci > 0 and co % 64 == 0
            and co > 0 and min(bsz, h, wd) >= 1 and not conv64.supported(x_shape, w_shape))


def takes(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> bool:
    """Whether ``conv3x3_f32`` computes this conv: float32 x, w and bias at a
    ``supported`` shape, where no gradient is wanted."""
    args = (x, w) if bias is None else (x, w, bias)
    return (all(a.dtype == torch.float32 for a in args) and supported(x.shape, w.shape)
            and not (torch.is_grad_enabled() and any(a.requires_grad for a in args)))


def _launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The CUDA kernels on CUDA tensors, one C call that packs ``w`` on the
    card and runs the conv; raises on what they do not take."""
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError(f"conv3x3_f32: kernel takes float32 x, w and bias, got {x.dtype}, "
                        f"{w.dtype}, {None if bias is None else bias.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_f32: kernel takes a contiguous, 16-byte aligned NHWC tensor")
    index = x.get_device()
    if w.get_device() != index or (bias is not None and bias.get_device() != index):
        raise ValueError("conv3x3_f32: weights must be on x's device")
    w = w.contiguous()
    if bias is not None:
        bias = bias.contiguous()
    bsz, h, wd, c_in = x.shape
    c_out = w.shape[0]
    y = x.new_empty((bsz, h, wd, c_out))
    scratch = x.new_empty(9 * c_in * c_out)  # the packed weights
    _build.check(_build.library().adunet_conv3x3_f32(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        scratch.data_ptr(), y.data_ptr(), bsz, h, wd, c_in, c_out, index,
        _build.current_stream(index)), "conv3x3_f32")
    conv3x3_f32.launches += 1
    return y


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """3x3 SAME conv of float32 NHWC ``x`` with float32 OIHW ``w`` (+ bias)
    at a ``supported`` shape, where no gradient is wanted (see ``takes``).

    Routed by ``kernels._route`` (its op: ``adunet_torch::conv3x3_f32``).
    CUDA: contiguous x; anything else raises. ``conv3x3_f32.launches``
    counts kernel launches."""
    if not supported(x.shape, w.shape):
        raise ValueError(f"conv3x3_f32: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    return route("conv3x3_f32", (x, w, bias), None, _launch, conv3x3_f32_plain,
                 torch.ops.adunet_torch.conv3x3_f32)


conv3x3_f32.launches = 0
