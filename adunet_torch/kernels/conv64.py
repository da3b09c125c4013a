"""K2: 3x3 stride-1 SAME conv + bias for 64 -> 64 channels — a CUDA kernel.

Replaces the Pallas TPU kernel ``adunet/kernels/conv64.py:132``
(``conv3x3_same_pallas``; ``pl.pallas_call`` at :154). The CUDA source is
``adunet_torch/csrc/conv64.cu``: a direct implicit GEMM on CUDA cores with a
2 x 128 x 64 output tile per block, 8 input channels (plus the 1-pixel halo,
zero outside the image) staged in shared memory per pass, and 64 float32
accumulators per thread. Its bound on an H100 is operations: 73,728 FLOP per
output pixel, in float32 at 67 TFLOP/s (no TF32), e.g. ~0.58 ms for one
(8, 256, 256, 64) launch.

The gate ``supported`` is the reference's (``adunet/kernels/conv64.py:49``)
unchanged, so the same four convs of the flagship reach the kernel; callers
send every other conv to ``F.conv2d``, as the reference sends them to XLA.
Dispatch is by the tensor's device: a CPU tensor takes the plain version
below, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adunet_torch.kernels import _build

__all__ = ["conv3x3_same", "conv3x3_same_plain", "pack_weights", "supported"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supported(x_shape, w_shape) -> bool:
    """Kernel applicability for x (B, H, W, C) and an OIHW weight: 3x3,
    C_in = C_out = 64, H % 8 == 0, W % 128 == 0, H >= 16, W >= 128."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, h, w, c = x_shape
    co, ci, kh, kw = w_shape
    return (
        (kh, kw) == (3, 3)
        and c == ci == 64
        and co == 64
        and h % 8 == 0
        and w % 128 == 0
        and h >= 16
        and w >= 128
    )


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 64, 3, 3) -> float32 (9, C_in, C_out), tap index 3*dy + dx."""
    return w.detach().to(torch.float32).permute(2, 3, 1, 0).reshape(9, 64, 64).contiguous()


def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The plain version: the explicit sum of the 9 taps' matmuls in float32
    over a zero-padded NHWC input, plus bias, cast to x.dtype."""
    _, h, wd, _ = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    wt = w.to(torch.float32).permute(2, 3, 1, 0)  # (3, 3, C_in, C_out)
    out = None
    for dy in range(3):
        for dx in range(3):
            term = torch.matmul(xp[:, dy : dy + h, dx : dx + wd, :], wt[dy, dx])
            out = term if out is None else out + term
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` with OIHW ``w`` at a ``supported`` shape.

    CUDA: float32 or bf16 ``x``, contiguous; anything else raises. CPU: the
    plain version. ``conv3x3_same.launches`` counts kernel launches."""
    if not supported(tuple(x.shape), tuple(w.shape)):
        raise ValueError(f"conv3x3_same: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv3x3_same: kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_same: kernel takes a contiguous, 16-byte aligned NHWC tensor")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3x3_same: weights must be on x's device")
    wp = pack_weights(w)
    b = (torch.zeros(64, device=x.device) if bias is None
         else bias.detach().to(torch.float32).contiguous())
    y = torch.empty_like(x)
    bsz, h, wd, _ = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.adunet_conv3x3_c64(
            x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(),
            bsz, h, wd, _DTYPE_CODES[x.dtype], stream,
        )
    _build.check(code, "conv3x3_same")
    conv3x3_same.launches += 1
    return y


conv3x3_same.launches = 0
