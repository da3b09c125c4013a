"""Resizes as one banded CUDA kernel, forward and backward, beside the
sampling-weight matrices and their dense product.

``resize_matrix`` is the port of ``adunet/ops/resize.py:93``: the dense
(out, in) float32 sampling-weight matrix of a resize along one axis (kernels
``area`` (box overlap, cv2.INTER_AREA), ``bilinear`` (triangle,
antialias-stretched on downsampling, tf.image.resize), ``bicubic`` (Keys
a=-0.5), ``bicubic_cv2`` (Keys a=-0.75, cv2.INTER_CUBIC), ``nearest``,
``lanczos3`` / ``lanczos5``; half-pixel coordinates throughout). The
reference applies the matrices as XLA einsums (:175); ``resize_band_plain``
is that dense product in float32 matmuls, the CPU path and the kernel's
plain version. The matrices live here rather than in ``adunet_torch.ops``
so that a serving program runs without the model's packages.

The kernel replaces no TPU kernel. Its source is
``adunet_torch/csrc/resize_band.cu``. Each matrix is banded, so the kernel
reads it from two tables (``band_tables``): for each output index, where
its band starts and K weights (K the widest band, padded with the matrix's
zeros), taken from the same ``resize_matrix`` the dense product uses, so
the numbers are that product's. One launch applies the H tables, then the
W tables, to an NHWC tensor: it reads x once (bf16 or float32), keeps the
H-pass sums in float32 in shared memory, and writes the output once in the
type asked for (bf16 or float32). Its bound on an H100 is bytes: (read x +
write y) / 3.35 TB/s, e.g. ~0.1 ms for the flagship's (32, 256, 256, 64)
bf16 -> 128 px resize.

``resize_band`` is a ``torch.autograd.Function`` where a gradient is wanted.
Its backward is the same kernel on the tables of the transposed matrices
(``resize_matrix(...).T``), from the cotangent to x's shape: a gather, with
no atomics, so its bits repeat over calls and graph replays. dx is float32
sums rounded once to x's type, as the dense path's casts give it.

The tables and each shape's launch plan are built once and cached (the
tables on the device), so a CUDA graph's capture, which the compiled train
step makes after two eager calls, finds them made. ``resize_band.launches``
counts the kernel's launches, forward and backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from adunet_torch.kernels import _build
from adunet_torch.kernels._route import route

__all__ = ["resize_band", "resize_band_plain", "resize_matrix", "band_tables", "plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 4                 # output rows a block owns (the kernel's kRows)
_SMEM = 96 * 1024         # dynamic shared memory a block may take (the kernel's kMaxSmem)
_SMEM_SHARED = 56 * 1024  # a block's share when four blocks share an SM (228 KiB)
_COLUMNS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)  # a tile's widths


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys piecewise-cubic kernel. a=-0.5 (TF/Catmull-Rom), a=-0.75 (cv2)."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a, 0.0),
    )


def _lanczos(x: np.ndarray, radius: float) -> np.ndarray:
    y = np.pi * x
    with np.errstate(invalid="ignore", divide="ignore"):
        out = radius * np.sin(y) * np.sin(y / radius) / (y * y)
    out = np.where(np.abs(x) < 1e-9, 1.0, out)
    return np.where(np.abs(x) < radius, out, 0.0)


_KERNELS = {
    "bilinear": (_triangle, 1.0),
    "bicubic": (lambda x: _keys_cubic(x, -0.5), 2.0),
    "bicubic_cv2": (lambda x: _keys_cubic(x, -0.75), 2.0),
    "lanczos3": (lambda x: _lanczos(x, 3.0), 3.0),
    "lanczos5": (lambda x: _lanczos(x, 5.0), 5.0),
}


@functools.lru_cache(maxsize=None)
def resize_matrix(
    in_size: int,
    out_size: int,
    method: str = "bilinear",
    antialias: bool = True,
) -> np.ndarray:
    """Dense (out_size, in_size) float32 sampling-weight matrix; rows sum to 1.

    Same construction as ``adunet/ops/resize.py:93``, including the identity
    for ``in == out`` (except ``area``, :106) and the edge rule (:138-160):
    TF-style kernels drop out-of-range taps and renormalise, ``bicubic_cv2``
    clamps them to the border as cv2 does.
    """
    if in_size <= 0 or out_size <= 0:
        raise ValueError("in_size and out_size must be positive.")
    if in_size == out_size and method != "area":
        return np.eye(out_size, dtype=np.float32)

    s = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)

    if method == "area":
        for i in range(out_size):
            lo, hi = i * s, (i + 1) * s
            for j in range(int(math.floor(lo)), min(int(math.ceil(hi)), in_size)):
                w = min(hi, j + 1) - max(lo, j)
                if w > 0:
                    mat[i, j] += w / s
        mat /= mat.sum(axis=1, keepdims=True)
        return mat.astype(np.float32)

    if method == "nearest":
        for i in range(out_size):
            mat[i, min(int(math.floor((i + 0.5) * s)), in_size - 1)] = 1.0
        return mat.astype(np.float32)

    if method not in _KERNELS:
        raise ValueError(f"Unknown resize method '{method}'.")
    kernel, radius = _KERNELS[method]
    clamp_edges = method == "bicubic_cv2"
    kscale = max(s, 1.0) if antialias else 1.0
    support = radius * kscale
    for i in range(out_size):
        center = (i + 0.5) * s - 0.5
        js = np.arange(int(math.floor(center - support)) + 1, int(math.ceil(center + support)) + 1)
        w = kernel((js - center) / kscale)
        if clamp_edges:
            js = np.clip(js, 0, in_size - 1)
        else:
            keep = (js >= 0) & (js < in_size)
            js, w = js[keep], w[keep]
        np.add.at(mat[i], js, w)
    mat /= mat.sum(axis=1, keepdims=True)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_matrix(in_size: int, out_size: int, method: str, antialias: bool,
                   device: torch.device) -> torch.Tensor:
    # made outside inference mode even when first asked for while serving: an
    # inference tensor cannot be saved for backward, and training reuses it;
    # and outside any dispatch mode, so that while torch.export traces it is a
    # real tensor, which the program takes as a lifted constant (a fake one
    # cached here would reach every later call)
    with torch.inference_mode(False), _disable_current_modes():
        return torch.from_numpy(resize_matrix(in_size, out_size, method, antialias)).to(device)


def resize_band_plain(
    x: torch.Tensor,
    out_hw: Tuple[int, int] | Sequence[int],
    method: str = "bilinear",
    antialias: bool = True,
) -> torch.Tensor:
    """The plain version, the dense product: x cast to float32, times the
    (out, in) float32 matrix along H (``torch.matmul``), then along W; an
    axis whose size is unchanged is skipped. Float32 out. The CPU path of
    every resize, and the kernel's oracle on the card."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    *lead, h, w, c = x.shape
    y = x.to(torch.float32).reshape(-1, h, w * c)
    if h != out_h:
        wh = _device_matrix(h, out_h, method, antialias, y.device)
        y = torch.matmul(wh, y)  # (N, out_h, W*C)
        h = out_h
    if w != out_w:
        ww = _device_matrix(w, out_w, method, antialias, y.device)
        y = torch.matmul(ww, y.reshape(-1, w, c))  # (N*H, out_w, C)
        w = out_w
    return y.reshape(*lead, h, w, c)


def band_tables(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(start, weight) of a banded (out, in) float32 matrix: ``start`` (out,)
    int32, nondecreasing, where each row's band may begin, and ``weight``
    (out, K) float32, ``m[i, start[i]:start[i] + K]``, where K is the fewest
    columns that hold every row's nonzeros from its start. A row's start is
    the first nonzero column of it or of any later row (a row whose taps at
    an edge of its support weigh exactly 0 starts later than the next one),
    moved back where the band would pass the input's end, so ``start + K <=
    in``; the band is padded with the matrix's own zeros."""
    out_size, in_size = m.shape
    nz = m != 0
    has = nz.any(axis=1)
    first = np.where(has, nz.argmax(axis=1), in_size)
    last = np.where(has, in_size - 1 - nz[:, ::-1].argmax(axis=1), -1)
    start = np.minimum.accumulate(first[::-1])[::-1]
    k = int((last - start + 1)[has].max()) if has.any() else 1
    start = np.minimum(start, in_size - k).astype(np.int32)
    cols = start[:, None] + np.arange(k)[None, :]
    weight = np.take_along_axis(m, cols, axis=1).astype(np.float32)
    return start, weight


@functools.lru_cache(maxsize=None)
def _tables(in_size: int, out_size: int, method: str, antialias: bool, transposed: bool):
    """The band tables of ``resize_matrix(in_size, out_size, ...)``, or of
    its transpose (the backward's: from out_size back to in_size)."""
    m = resize_matrix(in_size, out_size, method, antialias)
    return band_tables(m.T if transposed else m)


@functools.lru_cache(maxsize=None)
def _device_tables(in_size: int, out_size: int, method: str, antialias: bool, transposed: bool,
                   device: torch.device):
    # made outside inference mode and outside any dispatch mode, as
    # _device_matrix is: the first call may come while serving
    start, weight = _tables(in_size, out_size, method, antialias, transposed)
    with torch.inference_mode(False), _disable_current_modes():
        return (torch.from_numpy(start).to(device), torch.from_numpy(weight).to(device))


def _footprint(start: np.ndarray, k: int, tile: int) -> int:
    """The most input indices a tile of ``tile`` consecutive outputs reads."""
    first = start[::tile]
    last = start[np.minimum(np.arange(0, len(start), tile) + tile, len(start)) - 1]
    return int((last + k - first).max())


def _smem(tj: int, cg: int, vec: int, fh: int, fw: int, kh: int, kw: int, in_bytes: int) -> int:
    """A block's shared memory (``smem_bytes`` in ``csrc/resize_band.cu``)."""
    footprint = (fh * fw * cg * vec * in_bytes + 15) // 16 * 16
    inter = (_ROWS * fw * cg * vec + 3) // 4 * 4
    return footprint + 4 * (inter + _ROWS * kh + tj * kw) + 4 * (tj + _ROWS)


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, oh: int, ow: int, method: str, antialias: bool,
         transposed: bool, vec: int, dtype_in: int, dtype_out: int):
    """The kernel's launch plan for x (n, h, w, c) -> (n, oh, ow, c), as the
    16 C ints of ``Plan`` in ``csrc/resize_band.cu``. The tile adapts to the
    shape: 4 output rows; up to 8 groups of 8 channels (64 channels of a
    pixel: a 128-byte bf16 run) or 64 single channels; and the most output
    columns (4 to 256, no wider than the output needs) whose block leaves
    four blocks an SM (56 KiB of shared memory), since a wider tile moves
    longer runs of each row. ``transposed``: the
    backward's plan, (h, w) and (oh, ow) being the cotangent's and dx's
    sizes and the tables those of the forward from (oh, ow) to (h, w),
    transposed."""
    sizes_h = (oh, h) if transposed else (h, oh)
    sizes_w = (ow, w) if transposed else (w, ow)
    hs, hw = _tables(*sizes_h, method, antialias, transposed)
    ws, ww = _tables(*sizes_w, method, antialias, transposed)
    kh, kw = hw.shape[1], ww.shape[1]
    in_bytes = 2 if dtype_in else 4
    cg = min(8 if vec == 8 else 64, c // vec)
    fh = _footprint(hs, kh, _ROWS)

    def fits(tj, cap):
        return _smem(tj, cg, vec, fh, _footprint(ws, kw, tj), kh, kw, in_bytes) <= cap

    widths = [t for t in _COLUMNS if t < ow]
    widths.append(next((t for t in _COLUMNS if t >= ow), _COLUMNS[-1]))
    while True:
        # the widest tile that leaves four blocks an SM, else the widest that fits
        for cap in (_SMEM_SHARED, _SMEM):
            tj = next((t for t in reversed(widths) if fits(t, cap)), None)
            if tj is not None:
                return (ctypes.c_int * 16)(n, h, w, c, oh, ow, kh, kw, _ROWS, tj, cg, fh,
                                           _footprint(ws, kw, tj), vec, dtype_in, dtype_out)
        if cg == 1:
            raise ValueError(f"resize_band: a {method} resize {w} -> {ow} has bands too wide "
                             f"({kw}) for the kernel's shared memory")
        cg //= 2


def _launch(x: torch.Tensor, oh: int, ow: int, method: str, antialias: bool,
            dtype: torch.dtype, transposed: bool = False) -> torch.Tensor:
    """One kernel launch: x (..., H, W, C) on a CUDA device to (..., oh, ow,
    C) of ``dtype`` (an unchanged axis: a table of one weight of 1). It reads
    and writes bf16 or float32; another type is read as float32 and its
    result cast. ``transposed``: the backward's launch, x being the
    cotangent of a resize of (oh, ow) to x's (H, W)."""
    if x.dtype not in _DTYPE_CODES:
        x = x.to(torch.float32)
    out = dtype if dtype in _DTYPE_CODES else torch.float32
    *lead, h, w, c = x.shape
    y = torch.empty((*lead, oh, ow, c), dtype=out, device=x.device)
    if y.numel() == 0 or x.numel() == 0:
        return y.to(dtype)
    x = x.contiguous()
    n = x.numel() // (h * w * c)
    vec = 8 if c % 8 == 0 and x.data_ptr() % 16 == 0 else 1
    p = plan(n, h, w, c, oh, ow, method, antialias, transposed, vec, _DTYPE_CODES[x.dtype],
             _DTYPE_CODES[out])
    index = x.get_device()
    device = x.device
    sizes_h = (oh, h) if transposed else (h, oh)
    sizes_w = (ow, w) if transposed else (w, ow)
    hs, hw = _device_tables(*sizes_h, method, antialias, transposed, device)
    ws, ww = _device_tables(*sizes_w, method, antialias, transposed, device)
    _build.check(_build.library().adunet_resize_band(
        x.data_ptr(), y.data_ptr(), hs.data_ptr(), hw.data_ptr(), ws.data_ptr(), ww.data_ptr(),
        ctypes.addressof(p), index, _build.current_stream(index)), "resize_band")
    resize_band.launches += 1
    return y.to(dtype)


def _plain(x: torch.Tensor, oh: int, ow: int, method: str, antialias: bool,
           dtype: torch.dtype) -> torch.Tensor:
    return resize_band_plain(x, (oh, ow), method, antialias).to(dtype)


class _ResizeBand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, oh, ow, method, antialias, dtype):
        ctx.args = (x.shape[-3], x.shape[-2], x.dtype, method, antialias)
        return _launch(x, oh, ow, method, antialias, dtype)

    @staticmethod
    def backward(ctx, g):
        h, w, dtype, method, antialias = ctx.args
        return _launch(g, h, w, method, antialias, dtype, transposed=True), None, None, None, None, None


def resize_band(x: torch.Tensor, out_hw, method: str = "bilinear", antialias: bool = True,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Resize the spatial dims of a (..., H, W, C) tensor to ``out_hw`` with
    ``resize_matrix``'s weights, as a ``dtype`` tensor (x cast where neither
    size changes); differentiable in x. Routed by ``kernels._route``: CUDA,
    the kernel; CPU, the dense product ``resize_band_plain`` cast to
    ``dtype``, which autograd differentiates as it runs; exporting, the op.
    ``resize_band.launches`` counts the launches."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (x.shape[-3], x.shape[-2]) == (oh, ow):
        return x.to(dtype)
    return route("resize_band", (x, oh, ow, method, antialias, dtype), _ResizeBand, _launch, _plain,
                 torch.ops.adunet_torch.resize_band, plain_grad=True)


resize_band.launches = 0
