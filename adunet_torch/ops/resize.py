"""Fractional image resize as two matrix products.

Port of ``adunet/ops/resize.py``. A resize of the spatial dims of a
(..., H, W, C) tensor is

    out[b, i, j, c] = sum_h sum_w  Wh[i, h] * Ww[j, w] * x[b, h, w, c]

with (out, in) sampling-weight matrices built once in numpy and cached on the
device. In the reference these are XLA einsums (not Pallas), so here they are
``torch.matmul`` in float32 — with TF32 off on the card
(``adunet_torch.utils.runtime.setup_runtime``), the counterpart of the
reference's ``Precision.HIGHEST``.

Under a space mesh (``adunet_torch.parallel.spatial``) a tensor holds its
process's rows of the image: ``space`` (a ``SpaceShard``) and ``height`` (the
global height of x) make the resize along H a row-sharded product
(``SpaceShard.resize_rows``), and every size comes from the global height.

Kernels: ``area`` (box overlap, cv2.INTER_AREA), ``bilinear`` (triangle,
antialias-stretched on downsampling, tf.image.resize), ``bicubic`` (Keys
a=-0.5), ``bicubic_cv2`` (Keys a=-0.75, cv2.INTER_CUBIC), ``nearest``,
``lanczos3`` / ``lanczos5``. Half-pixel coordinate mapping throughout.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

__all__ = ["resize", "resize_by_scale", "resize_to_match", "scaled_size", "resize_matrix"]


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


def resize(
    x: torch.Tensor,
    out_hw: Tuple[int, int] | Sequence[int],
    method: str = "bilinear",
    antialias: bool = True,
    space=None,
    height: int | None = None,
) -> torch.Tensor:
    """Resize the spatial dims of a (..., H, W, C) tensor; float32 in, float32
    out (``resize_by_scale`` / ``resize_to_match`` cast back). With ``space``,
    x holds that shard's rows of an image of ``height`` rows, ``out_hw[0]`` is
    the global output height, and the result holds the shard's output rows."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    *lead, h, w, c = x.shape
    y = x.to(torch.float32).reshape(-1, h, w * c)
    if space is not None:
        if height is None:
            raise ValueError("a row-sharded resize needs the image's global height")
        if height != out_h:
            y = space.resize_rows(y, height, out_h, method, antialias)
            h = y.shape[1]
    elif h != out_h:
        wh = _device_matrix(h, out_h, method, antialias, y.device)
        y = torch.matmul(wh, y)  # (N, out_h, W*C)
        h = out_h
    if w != out_w:
        ww = _device_matrix(w, out_w, method, antialias, y.device)
        y = torch.matmul(ww, y.reshape(-1, w, c))  # (N*H, out_w, C)
        w = out_w
    return y.reshape(*lead, h, w, c)


def scaled_size(size: int, scale: float) -> int:
    """ceil(size * scale), floored at 1 (``adunet/ops/resize.py:194``)."""
    return max(1, int(math.ceil(size * float(scale))))


def resize_by_scale(
    x: torch.Tensor, scale: float, method: str = "bilinear", antialias: bool = True,
    space=None, height: int | None = None,
) -> torch.Tensor:
    """Fractional resize by ``scale``; preserves the dtype. With ``space``,
    ``height`` is x's global height (see ``resize``)."""
    h = x.shape[-3] if space is None else height
    out = (scaled_size(h, scale), scaled_size(x.shape[-2], scale))
    return resize(x, out, method, antialias, space, height).to(x.dtype)


def resize_to_match(
    x: torch.Tensor, ref: torch.Tensor, method: str = "bilinear", antialias: bool = True,
    space=None, height: int | None = None, ref_height: int | None = None,
) -> torch.Tensor:
    """Resize ``x`` to ``ref``'s spatial dims; preserves x's dtype. With
    ``space``, ``height`` and ``ref_height`` are the two global heights."""
    out_h = ref.shape[-3] if space is None else ref_height
    return resize(x, (out_h, ref.shape[-2]), method, antialias, space, height).to(x.dtype)
