"""Fractional image resize: two banded sampling-weight products.

Port of ``adunet/ops/resize.py``. A resize of the spatial dims of a
(..., H, W, C) tensor is

    out[b, i, j, c] = sum_h sum_w  Wh[i, h] * Ww[j, w] * x[b, h, w, c]

with (out, in) sampling-weight matrices built once in numpy. In the
reference these are XLA einsums (not Pallas). Here a CUDA tensor takes one
hand-written kernel, ``adunet_torch.kernels.resize_band``, which reads the
matrices' bands from tables and applies both in one launch, forward and
backward; a CPU tensor takes the dense product, ``resize_band_plain``: two
``torch.matmul`` in float32 by the matrices cached on the device (the
kernel's plain version, and what the CPU tests hold against JAX). Both add
in float32 (on the card with TF32 off, ``adunet_torch.utils.runtime.
setup_runtime``, the counterpart of the reference's ``Precision.HIGHEST``).
While ``torch.export`` traces a program, the op ``adunet_torch::resize_band``
(``kernels/ops.py``) stands in the graph for a resize that changes a size.

Under a space mesh (``adunet_torch.parallel.spatial``) a tensor holds its
process's rows of the image: ``space`` (a ``SpaceShard``) and ``height`` (the
global height of x) make the resize along H a row-sharded product
(``SpaceShard.resize_rows``), every size comes from the global height, and
the resize along W is the dense product on every device.

The matrices (``resize_matrix``: ``area``, ``bilinear``, ``bicubic``,
``bicubic_cv2``, ``nearest``, ``lanczos3`` / ``lanczos5``, half-pixel
coordinates) and the dense product live beside the kernel, in
``adunet_torch/kernels/resize_band.py``, so that a program runs either
without this package.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from adunet_torch.kernels.resize_band import resize_band, resize_band_plain, resize_matrix

__all__ = ["resize", "resize_by_scale", "resize_to_match", "scaled_size", "resize_matrix"]


def _resize(x, out_hw, method, antialias, space, height, dtype) -> torch.Tensor:
    """The resize as a ``dtype`` tensor: the kernel on a CUDA tensor, the op
    while exporting, the dense product on the CPU; with ``space``, the
    row-sharded product along H, then the dense product along W."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if space is not None:
        if height is None:
            raise ValueError("a row-sharded resize needs the image's global height")
        *lead, h, w, c = x.shape
        y = x.to(torch.float32)
        if height != out_h:
            y = space.resize_rows(y.reshape(-1, h, w * c), height, out_h, method, antialias)
            h = y.shape[1]
        y = y.reshape(*lead, h, w, c)
        return resize_band_plain(y, (h, out_w), method, antialias).to(dtype)
    if (x.shape[-3], x.shape[-2]) == (out_h, out_w):
        return x.to(dtype)
    if torch.compiler.is_exporting():
        return torch.ops.adunet_torch.resize_band(x, out_h, out_w, method, antialias, dtype)
    if x.is_cuda:
        return resize_band(x, (out_h, out_w), method, antialias, dtype)
    return resize_band_plain(x, (out_h, out_w), method, antialias).to(dtype)


def resize(
    x: torch.Tensor,
    out_hw: Tuple[int, int] | Sequence[int],
    method: str = "bilinear",
    antialias: bool = True,
    space=None,
    height: int | None = None,
) -> torch.Tensor:
    """Resize the spatial dims of a (..., H, W, C) tensor; float32 out
    (``resize_by_scale`` / ``resize_to_match`` keep x's type). With ``space``,
    x holds that shard's rows of an image of ``height`` rows, ``out_hw[0]`` is
    the global output height, and the result holds the shard's output rows."""
    return _resize(x, out_hw, method, antialias, space, height, torch.float32)


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
    return _resize(x, out, method, antialias, space, height, x.dtype)


def resize_to_match(
    x: torch.Tensor, ref: torch.Tensor, method: str = "bilinear", antialias: bool = True,
    space=None, height: int | None = None, ref_height: int | None = None,
) -> torch.Tensor:
    """Resize ``x`` to ``ref``'s spatial dims; preserves x's dtype. With
    ``space``, ``height`` and ``ref_height`` are the two global heights."""
    out_h = ref.shape[-3] if space is None else ref_height
    return _resize(x, (out_h, ref.shape[-2]), method, antialias, space, height, x.dtype)
