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
  accumulators, both operands read from shared memory), a persistent,
  warp-specialised grid over 4 x 64-pixel tiles: a producer warpgroup keeps
  a ring of three TMA stages of input and halo in flight (zero-filled
  outside the image) and loads the weights, laid out as ``pack_weights_bf16``
  lays them, once per block; two consumer warpgroups each take tiles of
  their own, so one's epilogue (bias, bf16, stores from registers) runs
  under the other's ``wgmma``. Bound: bytes and operations tie, ~0.16 ms for
  one (32, 256, 256, 64) launch.

A launch is one C call: the wrapper hands over the weight and bias as the
model holds them (float32 parameters, whatever the compute type), and the
call packs them on the card (``pack_conv3x3_weights_kernel``, into scratch
allocated here) just before the conv. The weights round to x's type
(nearest even) before they are packed, and the bias rounds to x's type and
widens to float32, as a cast of the parameters to the compute type would, so
the output is the same as from parameters cast by the caller.
``pack_weights`` / ``pack_weights_bf16`` are the plain description of the
two layouts (and the tests' oracle for the pack on the card).

``conv3x3_same`` is a ``torch.autograd.Function``, the counterpart of the
reference's custom VJP (:191-227), and runs only where a gradient is wanted.
It saves x and w. Its backward, ``conv3x3_same_backward``, is the
reference's ``_bwd`` (:203-227), which runs as XLA convolutions outside any
Pallas kernel there; here it is one C call of four device kernels in the
same source (``adunet_conv3x3_c64_backward``):

- dx, the correlation of the cotangent with the flipped, io-swapped kernel:
  float32, the weight pack in flip mode (``pack_weights_flipped`` is its
  plain layout), then the forward kernel run on the cotangent; bf16, the
  weights packed as for the forward and the forward kernel run on the
  cotangent reading tap 8 - t of the pack transposed (an MN-major wgmma
  operand: the pack's row of an output channel is a K row of dx's GEMM);
- dw and db: a persistent grid over cotangent tiles (bf16: ``wgmma`` with
  the shifted x and the cotangent from shared memory, clusters of blocks
  whose sums meet in distributed shared memory; float32: CUDA cores, no
  TF32) that writes float32 partial rows of the 9 x 64 x 64 dw sums and the
  64 db sums (one a cluster in bf16, one a block in float32), then a
  fixed-order sum of the rows (no atomics: two calls give the same bits),
  which rounds dw to x's type, then to w's, and db to x's type, then to the
  bias's, as the reference's ``_bwd`` rounds them to the compute type and a
  cast's backward widens them.

``conv3x3_same_backward_plain`` is its plain version (explicit taps in
float32, float64 for float64 inputs), which the CPU path runs.
``conv3x3_same_backward.launches`` counts the backward's C calls in the
SAME mode and ``conv3x3_same_backward.rows_launches`` in the halo-row mode.

The gate ``supported`` is the reference's (``adunet/kernels/conv64.py:49``)
unchanged, so the same four convs of the flagship reach the kernel; callers
send every other conv to ``F.conv2d``, as the reference sends them to XLA.
A CPU tensor takes the plain version below, a CUDA tensor the kernel.

``conv3x3_rows`` is the kernels' halo-row mode, for an image whose height is
split over the processes of a space mesh (``adunet_torch.parallel.spatial``):
its input holds H + 2 rows, the top and bottom ones the neighbours' edge rows
(zeros at the image's border), and it writes H rows, SAME in W and VALID in
H. The gate applies to the output's shape. Its backward covers all H + 2
input rows with dx, and the exchange sends the halo rows' share back
to their owners (there dx is a full correlation in H: the cotangent's H
rows give H + 2). ``conv3x3_rows.launches`` counts its launches apart from
``conv3x3_same.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from adunet_torch.kernels import _build
from adunet_torch.kernels._route import on_device, route

__all__ = [
    "conv3x3_same",
    "conv3x3_same_plain",
    "conv3x3_same_backward",
    "conv3x3_same_backward_plain",
    "conv3x3_rows",
    "conv3x3_rows_plain",
    "pack_weights",
    "pack_weights_bf16",
    "pack_weights_flipped",
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


def _flipped(w: torch.Tensor) -> torch.Tensor:
    """The OIHW kernel of the backward's dx: w flipped in H and W with its
    input and output channels swapped (the reference's ``w_flip``)."""
    return w.flip(2, 3).transpose(0, 1)


def pack_weights_flipped(w: torch.Tensor) -> torch.Tensor:
    """``pack_weights`` of the flipped, io-swapped kernel: float32 (9, C_in,
    C_out) of the correlation that gives dx (packed tap t reads w's tap 8 - t,
    C_in and C_out swapped), as the pack's flip mode writes it."""
    return pack_weights(_flipped(w))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (so gradcheck sees full precision)."""
    return torch.promote_types(dtype, torch.float32)


def _plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, pad_h: int) -> torch.Tensor:
    acc = _acc_dtype(x.dtype)
    bsz, h, wd, c_in = x.shape
    h += 2 * pad_h - 2  # output rows
    xp = F.pad(x.to(acc), (0, 0, 1, 1, pad_h, pad_h))
    wt = w.to(x.dtype).to(acc).permute(2, 3, 1, 0)  # (3, 3, C_in, C_out)
    # the three column shifts copied once; a tap's rows of one are a view
    # (of one image) or one copy, and each tap's product is accumulated in
    # place: few, large CPU ops, which stay fast when the cores are shared
    cols = [xp[:, :, dx : dx + wd, :].contiguous() for dx in range(3)]
    out = None
    for dy in range(3):
        for dx in range(3):
            a = cols[dx][:, dy : dy + h].reshape(-1, c_in)
            out = a @ wt[dy, dx] if out is None else out.addmm_(a, wt[dy, dx])
    out = out.view(bsz, h, wd, -1)
    if bias is not None:
        out = out + bias.to(x.dtype).to(acc)
    return out.to(x.dtype)


def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The plain version: the weights and bias rounded to x.dtype, then the
    explicit sum of the 9 taps' matmuls in float32 over a zero-padded NHWC
    input, in tap order (3 dy + dx), plus bias, cast to x.dtype. Any 3x3
    channel counts (K3's plain version too)."""
    return _plain(x, w, bias, 1)


def conv3x3_rows_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The halo-row mode's plain version: (B, H + 2, W, C) in, (B, H, W, C)
    out, zero-padded in W only, otherwise as ``conv3x3_same_plain``."""
    return _plain(x, w, bias, 0)


def conv3x3_same_backward_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                                need_dx: bool = True, need_dw: bool = True,
                                need_db: bool = True, bias_dtype: torch.dtype | None = None,
                                pad_h: int = 1):
    """The backward's plain version: the kernels' arithmetic with explicit
    taps in float32 (float64 for float64 inputs). dx is the plain conv of
    ``g`` (cast to x's dtype) with the flipped, io-swapped ``w`` rounded to
    x's dtype (padded by 1 row for SAME; ``pad_h=0``, the halo-row mode, pads
    ``g`` by 2 rows so dx covers x's H + 2 rows), in x's dtype; dw the nine
    matmuls of the shifted, zero-padded x with ``g``, rounded to x's dtype and
    returned in w's (OIHW); db ``_bias_grad_f32`` rounded to x's dtype and
    returned in ``bias_dtype`` (default w's dtype). Any 3x3 channel counts."""
    if g.dtype is not x.dtype:
        g = g.to(x.dtype)
    dx = dw = db = None
    if need_dx:
        dx = _plain(g, _flipped(w), None, 2 - pad_h)
    if need_dw:
        acc = _acc_dtype(x.dtype)
        _, h, wd, c_out = g.shape
        xp = F.pad(x.to(acc), (0, 0, 1, 1, pad_h, pad_h))
        gm = g.to(acc).reshape(-1, c_out)
        taps = [xp[:, dy: dy + h, dx_: dx_ + wd, :].reshape(-1, x.shape[-1]).T @ gm
                for dy in range(3) for dx_ in range(3)]  # (C_in, C_out) each
        dw = torch.stack(taps).reshape(3, 3, x.shape[-1], c_out).permute(3, 2, 0, 1)
        dw = dw.to(x.dtype).to(w.dtype).contiguous()
    if need_db:
        db = _bias_grad_f32(g).to(x.dtype).to(bias_dtype or w.dtype)
    return dx, dw, db


def conv3x3_same_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          need_dx: bool = True, need_dw: bool = True, need_db: bool = True,
                          bias_dtype: torch.dtype | None = None, pad_h: int = 1):
    """(dx, dw, db) of the 3x3 SAME conv of NHWC ``x`` with OIHW ``w`` (any
    float dtype: it is cast to x's) for the NHWC output cotangent ``g``; an
    entry not asked for is None. dx comes in x's dtype; dw rounds to x's
    dtype and returns in w's; db is summed in float32, rounded to x's dtype
    and returned in ``bias_dtype`` (default w's dtype). ``pad_h=0`` is the
    halo-row mode's (dx covers x's H + 2 rows).

    CUDA: the backward kernels, one C call (``supported`` shapes, float32 or
    bf16 x; anything else raises). CPU: ``conv3x3_same_backward_plain``."""
    run = on_device("conv3x3_same_backward", x, _launch_backward, conv3x3_same_backward_plain)
    return run(x, w, g, need_dx, need_dw, need_db, bias_dtype, pad_h)


def _bias_grad_f32(g: torch.Tensor) -> torch.Tensor:
    """The bias gradient before any rounding: the sum of the NHWC cotangent
    over B, H and W, accumulated in float32 (float64 for float64) as the
    reduction reads ``g`` in its own type: no float32 copy of ``g`` is made
    on the card."""
    return g.sum(dim=(0, 1, 2), dtype=_acc_dtype(g.dtype))


# bytes of the packed weights (9 x 64 x 64 of x's type) and bias (64 float32)
_SCRATCH_BYTES = {torch.float32: 9 * 64 * 64 * 4 + 64 * 4, torch.bfloat16: 9 * 64 * 64 * 2 + 64 * 4}


def _launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
            halo: int = 0) -> torch.Tensor:
    """The CUDA kernel on a CUDA tensor (``halo`` 1: the halo-row mode), one
    C call that packs ``w`` and ``bias`` (float32 or bf16, as the model holds
    them) on the card and runs the conv; raises on what it does not take."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"conv3x3_same: kernel takes float32 or bfloat16, got {x.dtype}")
    ptr = x.data_ptr()
    if not x.is_contiguous() or ptr % 16:
        raise ValueError("conv3x3_same: kernel takes a contiguous, 16-byte aligned NHWC tensor")
    index = x.get_device()
    w_code = _DTYPE_CODES.get(w.dtype)
    if w_code is None:
        raise TypeError(f"conv3x3_same: kernel takes float32 or bfloat16 weights, got {w.dtype}")
    if w.get_device() != index or (bias is not None and bias.get_device() != index):
        raise ValueError("conv3x3_same: weights must be on x's device")
    if not w.is_contiguous():
        w = w.contiguous()
    if bias is None:
        b_ptr, b_code = None, -1
    else:
        b_code = _DTYPE_CODES.get(bias.dtype)
        if b_code is None:
            raise TypeError(f"conv3x3_same: kernel takes a float32 or bfloat16 bias, got {bias.dtype}")
        if not bias.is_contiguous():
            bias = bias.contiguous()
        b_ptr = bias.data_ptr()
    bsz, h, wd, _ = x.shape
    h -= 2 * halo  # output rows
    y = x.new_empty((bsz, h, wd, 64))
    scratch = x.new_empty(_SCRATCH_BYTES[x.dtype], dtype=torch.uint8)
    _build.check(_build.library().adunet_conv3x3_c64(
        ptr, w.data_ptr(), w_code, b_ptr, b_code, scratch.data_ptr(), y.data_ptr(),
        bsz, h, wd, halo, code, index, _build.current_stream(index)),
        "conv3x3_rows" if halo else "conv3x3_same")
    if halo:
        conv3x3_rows.launches += 1
    else:
        conv3x3_same.launches += 1
    return y


# the backward's scratch: the packed weights' room (as the C entry lays it
# out), then float32 partial rows (9 x 64 x 64 dw, 64 db): one per block of
# the float32 wgrad grid, one per cluster of the bf16 one
_BWD_PACK_BYTES = 9 * 64 * 64 * 4 + 64 * 4
_PARTIAL_FLOATS = 9 * 64 * 64 + 64
_partials_per_device: dict[tuple[int, int], int] = {}


def _n_partials(lib, index: int, code: int) -> int:
    """The partial rows the backward's scratch must hold on device ``index``
    for x of type ``code`` (the most rows its wgrad grid can write), asked
    of the library once per device and type."""
    n = _partials_per_device.get((index, code))
    if n is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _build.check(lib.adunet_conv3x3_c64_backward_partials(ctypes.addressof(out), code),
                         "conv3x3_same_backward")
        n = _partials_per_device[(index, code)] = out.value
    return n


def _launch_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, need_dx: bool,
                     need_dw: bool, need_db: bool, bias_dtype: torch.dtype | None, pad_h: int):
    """The backward kernels on CUDA tensors, one C call: (dx, dw, db) as
    ``conv3x3_same_backward`` returns them; raises on what they do not take."""
    halo = 1 - pad_h
    what = "conv3x3_rows backward" if halo else "conv3x3_same backward"
    code = _DTYPE_CODES.get(x.dtype)
    w_code = _DTYPE_CODES.get(w.dtype)
    db_dtype = bias_dtype or w.dtype
    if code is None or w_code is None or (need_db and db_dtype not in _DTYPE_CODES):
        raise TypeError(f"{what}: kernels take float32 or bfloat16 x, w and bias, got "
                        f"{x.dtype}, {w.dtype}, {db_dtype}")
    bsz, hx, wd, _ = x.shape
    h = hx - 2 * halo
    index = x.get_device()
    if (tuple(g.shape) != (bsz, h, wd, 64) or not supported((bsz, h, wd, 64), w.shape)
            or g.get_device() != index or w.get_device() != index):
        raise ValueError(f"{what}: unsupported shapes or devices x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} g={tuple(g.shape)}")
    if g.dtype is not x.dtype or not g.is_contiguous():
        g = g.to(x.dtype).contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    if not x.is_contiguous() or x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"{what}: kernels take contiguous, 16-byte aligned NHWC tensors")
    if not (need_dx or need_dw or need_db):
        return None, None, None
    lib = _build.library()
    n = _n_partials(lib, index, code) if need_dw or need_db else 0
    scratch = x.new_empty(_BWD_PACK_BYTES + n * _PARTIAL_FLOATS * 4, dtype=torch.uint8)
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty(w.shape, dtype=w.dtype, device=x.device) if need_dw else None
    db = x.new_empty(64, dtype=db_dtype) if need_db else None
    _build.check(lib.adunet_conv3x3_c64_backward(
        x.data_ptr(), w.data_ptr(), w_code, g.data_ptr(), int(need_dx), int(need_dw),
        int(need_db), scratch.data_ptr(), None if dx is None else dx.data_ptr(),
        None if dw is None else dw.data_ptr(), None if db is None else db.data_ptr(),
        _DTYPE_CODES.get(db_dtype, -1), bsz, h, wd, halo, code, index,
        _build.current_stream(index)), what)
    if halo:
        conv3x3_same_backward.rows_launches += 1
    else:
        conv3x3_same_backward.launches += 1
    return dx, dw, db


def _launch_rows(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    return _launch(x, w, bias, 1)


class _Conv3x3Same(torch.autograd.Function):
    halo = 0  # 1: the halo-row mode (_Conv3x3Rows)

    @classmethod
    def forward(cls, ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        if cls.halo:
            return on_device("conv3x3_rows", x, _launch_rows, conv3x3_rows_plain)(x, w, bias)
        return on_device("conv3x3_same", x, _launch, conv3x3_same_plain)(x, w, bias)

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
    differentiable in x, w and bias. ``w`` and ``bias`` may be float32 or
    bf16 whatever x's type (they round to it, as a cast would).

    Routed by ``kernels._route`` (its op: ``adunet_torch::conv3x3_c64``).
    CUDA: float32 or bf16 ``x``, contiguous; anything else raises.
    ``conv3x3_same.launches`` counts kernel launches."""
    if not supported(x.shape, w.shape):
        raise ValueError(f"conv3x3_same: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    return route("conv3x3_same", (x, w, bias), _Conv3x3Same, _launch, conv3x3_same_plain,
                 torch.ops.adunet_torch.conv3x3_c64)


def conv3x3_rows(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """K2's halo-row mode: the 3x3 conv of NHWC ``x`` of H + 2 rows with OIHW
    ``w``, SAME in W and VALID in H, H rows out, where the output's shape is
    ``supported``; differentiable in x, w and bias. As ``conv3x3_same``
    otherwise, but with no op: a program holds no space mesh.
    ``conv3x3_rows.launches`` counts kernel launches."""
    out_shape = (x.shape[0], x.shape[1] - 2, *x.shape[2:])
    if x.dim() != 4 or not supported(out_shape, w.shape):
        raise ValueError(f"conv3x3_rows: unsupported shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    return route("conv3x3_rows", (x, w, bias), _Conv3x3Rows, _launch_rows, conv3x3_rows_plain)


conv3x3_same.launches = 0
conv3x3_rows.launches = 0
conv3x3_same_backward.launches = 0
conv3x3_same_backward.rows_launches = 0
