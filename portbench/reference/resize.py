"""Fractional resizes as dense sampling-weight matrices, built in numpy.

A frozen copy of the construction the SR U-Net's resizes use (half-pixel
mapping; ``bilinear`` with the antialias stretch on downsampling, ``area``
as box overlap, ``bicubic_cv2`` as Keys a=-0.75 with the taps clamped to
the border as OpenCV does). A resize of the two spatial axes is two matrix
products in float32."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a, 0.0),
    )


_KERNELS = {"bilinear": (_triangle, 1.0), "bicubic_cv2": (lambda x: _keys_cubic(x, -0.75), 2.0)}


@functools.lru_cache(maxsize=None)
def matrix(in_size: int, out_size: int, method: str, antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) float32 weights whose rows sum to 1; the identity
    where the sizes agree (but for ``area``)."""
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
    else:
        kernel, radius = _KERNELS[method]
        kscale = max(s, 1.0) if antialias else 1.0
        support = radius * kscale
        for i in range(out_size):
            center = (i + 0.5) * s - 0.5
            js = np.arange(int(math.floor(center - support)) + 1,
                           int(math.ceil(center + support)) + 1)
            w = kernel((js - center) / kscale)
            if method == "bicubic_cv2":
                js = np.clip(js, 0, in_size - 1)
            else:
                keep = (js >= 0) & (js < in_size)
                js, w = js[keep], w[keep]
            np.add.at(mat[i], js, w)
    mat /= mat.sum(axis=1, keepdims=True)
    return mat.astype(np.float32)


def resize_nchw(x: torch.Tensor, out_h: int, out_w: int, method: str = "bilinear",
                antialias: bool = True) -> torch.Tensor:
    """Resize the last two axes of an (N, C, H, W) tensor; float32 out."""
    y = x.to(torch.float32)
    h, w = y.shape[-2:]
    if h != out_h:
        wh = torch.from_numpy(matrix(h, out_h, method, antialias)).to(y.device)
        y = torch.matmul(wh, y)
    if w != out_w:
        ww = torch.from_numpy(matrix(w, out_w, method, antialias)).to(y.device)
        y = torch.matmul(y, ww.t())
    return y


def scaled(size: int, scale: float) -> int:
    """ceil(size * scale), at least 1."""
    return max(1, int(math.ceil(size * float(scale))))
