"""K2: 3x3 stride-1 SAME conv + bias for 64 -> 64 channels — CUDA kernels.

Replaces the Pallas TPU kernel ``adunet/kernels/conv64.py:132``
(``conv3x3_same_pallas``; ``pl.pallas_call`` at :154). The CUDA source is
``adunet_torch/csrc/conv64.cu``, one kernel per type:

- float32: a direct implicit GEMM on CUDA cores (full float32, no TF32),
  with a 2 x 128 x 64 output tile per block, 8 input channels (plus the
  1-pixel halo, zero outside the image) staged in shared memory per pass,
  and 64 float32 accumulators per thread. Bound: operations, 73,728 FLOP per
  output pixel at 67 TFLOP/s, e.g. ~0.58 ms for one (8, 256, 256, 64) launch.
- bf16: an implicit GEMM on the tensor cores (``wgmma``, float32
  accumulators), a persistent grid over 4 x 64-pixel tiles whose input and
  halo arrive by TMA (zero-filled outside the image) and whose weights sit in
  shared memory as ``pack_weights_bf16`` lays them out. Bound: bytes and
  operations tie, ~0.16 ms for one (32, 256, 256, 64) launch.

``conv3x3_same`` is a ``torch.autograd.Function``, the counterpart of the
reference's custom VJP (:191-227). It saves x and w. Its backward is the
reference's ``_bwd`` (:203-227), which runs as XLA convolutions outside any
Pallas kernel; here they are library convolutions on the NCHW views of the
channels-last tensors (``aten.convolution_backward``): dx is the correlation
of the cotangent with the flipped, io-swapped kernel, dw the contraction
over batch and pixels, db the float32 sum over B, H and W. Each comes back
in its input's dtype.

The gate ``supported`` is the reference's (``adunet/kernels/conv64.py:49``)
unchanged, so the same four convs of the flagship reach the kernel; callers
send every other conv to ``F.conv2d``, as the reference sends them to XLA.
Dispatch is by the tensor's device: a CPU tensor takes the plain version
below, a CUDA tensor launches the kernel or raises.

``conv3x3_rows`` is the kernels' halo-row mode, for an image whose height is
split over the processes of a space mesh (``adunet_torch.parallel.spatial``):
its input holds H + 2 rows, the top and bottom ones the neighbours' edge rows
(zeros at the image's border), and it writes H rows, SAME in W and VALID in
H. The gate applies to the output's shape. Its backward pads H by 0, so dx
covers all H + 2 input rows and the exchange sends the halo rows' share back
to their owners. ``conv3x3_rows.launches`` counts its launches apart from
``conv3x3_same.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adunet_torch.kernels import _build

__all__ = [
    "conv3x3_same",
    "conv3x3_same_plain",
    "conv3x3_same_backward",
    "conv3x3_rows",
    "conv3x3_rows_plain",
    "pack_weights",
    "pack_weights_bf16",
    "supported",
]

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


def pack_weights_bf16(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 64, 3, 3) -> bf16 (9, C_out, C_in), tap index 3*dy + dx, as
    the bf16 kernel's ``wgmma`` reads B from shared memory: K-major (a row of
    64 input channels, 128 bytes, per output channel) with the 128-byte
    swizzle, i.e. the 16-byte chunk j of row n lies at chunk j ^ (n % 8)."""
    taps = w.detach().to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 64, 8, 8)
    n = torch.arange(64, device=w.device)
    src = torch.arange(8, device=w.device)[None, :] ^ (n[:, None] % 8)  # XOR is its own inverse
    return torch.gather(taps, 2, src[None, :, :, None].expand(9, 64, 8, 8)).reshape(9, 64, 64)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (so gradcheck sees full precision)."""
    return torch.promote_types(dtype, torch.float32)


def _plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, pad_h: int) -> torch.Tensor:
    acc = _acc_dtype(x.dtype)
    _, h, wd, _ = x.shape
    h += 2 * pad_h - 2  # output rows
    xp = F.pad(x.to(acc), (0, 0, 1, 1, pad_h, pad_h))
    wt = w.to(acc).permute(2, 3, 1, 0)  # (3, 3, C_in, C_out)
    out = None
    for dy in range(3):
        for dx in range(3):
            term = torch.matmul(xp[:, dy : dy + h, dx : dx + wd, :], wt[dy, dx])
            out = term if out is None else out + term
    if bias is not None:
        out = out + bias.to(acc)
    return out.to(x.dtype)


def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The plain version: the explicit sum of the 9 taps' matmuls in float32
    over a zero-padded NHWC input, plus bias, cast to x.dtype."""
    return _plain(x, w, bias, 1)


def conv3x3_rows_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The halo-row mode's plain version: (B, H + 2, W, C) in, (B, H, W, C)
    out, zero-padded in W only, otherwise as ``conv3x3_same_plain``."""
    return _plain(x, w, bias, 0)


def conv3x3_same_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          need_dx: bool = True, need_dw: bool = True, need_db: bool = True,
                          bias_dtype: torch.dtype | None = None, pad_h: int = 1):
    """(dx, dw, db) of the 3x3 SAME conv of NHWC ``x`` with OIHW ``w`` for
    the NHWC output cotangent ``g``; an entry not asked for is None. db is
    summed in float32 and returned in ``bias_dtype`` (default w's dtype).
    ``pad_h=0`` is the halo-row mode's (dx covers x's H + 2 rows)."""
    g = g.to(x.dtype)
    dx = dw = db = None
    if need_dx or need_dw:
        gn = g.permute(0, 3, 1, 2)  # NCHW views of channels-last memory
        xn = x.permute(0, 3, 1, 2)
        dxn, dw, _ = torch.ops.aten.convolution_backward(
            gn, xn, w.to(x.dtype), None, [1, 1], [pad_h, 1], [1, 1], False, [0, 0], 1,
            [need_dx, need_dw, False],
        )
        dx = dxn.permute(0, 2, 3, 1) if need_dx else None
        dw = dw.to(w.dtype) if need_dw else None
    if need_db:
        db = g.to(_acc_dtype(g.dtype)).sum(dim=(0, 1, 2)).to(bias_dtype or w.dtype)
    return dx, dw, db


def _launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
            halo: int = 0) -> torch.Tensor:
    """The CUDA kernel on a CUDA tensor (``halo`` 1: the halo-row mode);
    raises on what it does not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv3x3_same: kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_same: kernel takes a contiguous, 16-byte aligned NHWC tensor")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3x3_same: weights must be on x's device")
    wp = pack_weights_bf16(w) if x.dtype == torch.bfloat16 else pack_weights(w)
    b = (torch.zeros(64, device=x.device) if bias is None
         else bias.detach().to(torch.float32).contiguous())
    bsz, h, wd, _ = x.shape
    h -= 2 * halo  # output rows
    y = torch.empty((bsz, h, wd, 64), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.adunet_conv3x3_c64(
            x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(),
            bsz, h, wd, halo, _DTYPE_CODES[x.dtype], stream,
        )
    _build.check(code, "conv3x3_rows" if halo else "conv3x3_same")
    if halo:
        conv3x3_rows.launches += 1
    else:
        conv3x3_same.launches += 1
    return y


class _Conv3x3Same(torch.autograd.Function):
    halo = 0  # 1: the halo-row mode (_Conv3x3Rows)

    @classmethod
    def forward(cls, ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        if x.device.type == "cpu":
            plain = conv3x3_rows_plain if cls.halo else conv3x3_same_plain
            return plain(x, w, bias)
        return _launch(x, w, bias, cls.halo)

    @classmethod
    def backward(cls, ctx, g):
        x, w = ctx.saved_tensors
        need_dx, need_dw, need_db = ctx.needs_input_grad
        return conv3x3_same_backward(x, w, g, need_dx, need_dw,
                                     need_db and ctx.bias_dtype is not None, ctx.bias_dtype,
                                     pad_h=1 - cls.halo)


class _Conv3x3Rows(_Conv3x3Same):
    halo = 1


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` with OIHW ``w`` at a ``supported`` shape;
    differentiable in x, w and bias.

    CUDA: float32 or bf16 ``x``, contiguous; anything else raises. CPU: the
    plain version. ``conv3x3_same.launches`` counts kernel launches."""
    if not supported(tuple(x.shape), tuple(w.shape)):
        raise ValueError(f"conv3x3_same: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_same: no kernel for device {x.device}")
    return _Conv3x3Same.apply(x, w, bias)


def conv3x3_rows(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """K2's halo-row mode: the 3x3 conv of NHWC ``x`` of H + 2 rows with OIHW
    ``w``, SAME in W and VALID in H, H rows out, where the output's shape is
    ``supported``; differentiable in x, w and bias. As ``conv3x3_same``
    otherwise; ``conv3x3_rows.launches`` counts kernel launches."""
    out_shape = (x.shape[0], x.shape[1] - 2, *x.shape[2:])
    if x.dim() != 4 or not supported(out_shape, tuple(w.shape)):
        raise ValueError(f"conv3x3_rows: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_rows: no kernel for device {x.device}")
    return _Conv3x3Rows.apply(x, w, bias)


conv3x3_same.launches = 0
conv3x3_rows.launches = 0
