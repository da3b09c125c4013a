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
global height of x) hand the resize to ``SpaceShard.resize``, a row-sharded
product along H, every size from the global height, then the dense product
along W on every device.

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

from adunet_torch.kernels.resize_band import resize_band, resize_matrix

__all__ = ["resize", "resize_by_scale", "resize_to_match", "scaled_size", "resize_matrix"]


def _resize(x, out_hw, method, antialias, space, height, dtype) -> torch.Tensor:
    """The resize as a ``dtype`` tensor: with ``space``, ``SpaceShard.resize``;
    otherwise ``resize_band``, which routes it by device and export."""
    if space is not None:
        return space.resize(x, out_hw, method, antialias, height, dtype)
    return resize_band(x, out_hw, method, antialias, dtype)


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
