"""Host-side patch sampling and tiling (numpy).

Port of ``adunet/data/patches.py``: ``random_patch`` (:46) and
``random_patches`` (:61), the training stream's crops, and the grid tiling
of the evaluation stream (``grid_patch_count`` :82, ``grid_patches`` :112):
row-major tiles at a stride, counted in closed form from the image size.

The random crops keep the reference's pinned RNG contract (:8-13), so a
seeded stream is byte for byte the reference's: for each crop the
generator draws the vertical offset first, then the horizontal one, each by
``Generator.integers(0, span + 1)`` and each only when that axis has slack
(span > 0).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["random_patch", "random_patches", "grid_patches", "grid_patch_count"]


def _check_crop(shape, size: int) -> None:
    """An (H, W, 3) image that a square crop of ``size`` fits."""
    if size <= 0:
        raise ValueError(f"crop size must be >= 1, got {size}")
    if len(shape) != 3 or shape[-1] != 3:
        raise ValueError(f"expected an RGB array of shape (H, W, 3), got {tuple(shape)}")
    if shape[0] < size or shape[1] < size:
        raise ValueError(f"crop size {size} does not fit inside a {shape[0]}x{shape[1]} image")


def _draw_corner(rng: np.random.Generator, span_y: int, span_x: int) -> tuple:
    """One (top, left) draw: y before x, an axis without slack draws nothing."""
    top = int(rng.integers(0, span_y + 1)) if span_y > 0 else 0
    left = int(rng.integers(0, span_x + 1)) if span_x > 0 else 0
    return top, left


def random_patch(image: np.ndarray, patch_size: int, *,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """One uniformly placed square crop of an (H, W, 3) image (a view)."""
    _check_crop(image.shape, patch_size)
    rng = rng if rng is not None else np.random.default_rng()
    top, left = _draw_corner(rng, image.shape[0] - patch_size, image.shape[1] - patch_size)
    return image[top : top + patch_size, left : left + patch_size, :]


def random_patches(image: np.ndarray, patch_size: int, count: int, *,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """``count`` independent random crops, stacked into (count, P, P, 3)."""
    if count <= 0:
        raise ValueError(f"need at least one patch, got count={count}")
    _check_crop(image.shape, patch_size)
    rng = rng if rng is not None else np.random.default_rng()
    span_y, span_x = image.shape[0] - patch_size, image.shape[1] - patch_size
    out = np.empty((count, patch_size, patch_size, image.shape[2]), dtype=image.dtype)
    for i in range(count):
        top, left = _draw_corner(rng, span_y, span_x)
        out[i] = image[top : top + patch_size, left : left + patch_size, :]
    return out


def grid_patch_count(height: int, width: int, patch_size: int, *,
                     stride: Optional[int] = None) -> int:
    """Tile count of ``grid_patches`` for an (height, width) image."""
    step = stride or patch_size
    if patch_size <= 0:
        raise ValueError(f"crop size must be >= 1, got {patch_size}")
    if step <= 0:
        raise ValueError(f"tile stride must be >= 1, got {step}")
    if height < patch_size or width < patch_size:
        raise ValueError(f"crop size {patch_size} does not fit inside a {height}x{width} image")
    return ((height - patch_size) // step + 1) * ((width - patch_size) // step + 1)


def grid_patches(image: np.ndarray, patch_size: int, *, stride: Optional[int] = None) -> np.ndarray:
    """Row-major strided tiling of an (H, W, 3) image into (N, P, P, 3)."""
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected an RGB array of shape (H, W, 3), got {tuple(image.shape)}")
    step = stride or patch_size
    grid_patch_count(image.shape[0], image.shape[1], patch_size, stride=step)  # checks the geometry
    windows = np.lib.stride_tricks.sliding_window_view(
        image, (patch_size, patch_size), axis=(0, 1)
    )[::step, ::step]
    rows, cols = windows.shape[:2]
    return np.ascontiguousarray(
        windows.transpose(0, 1, 3, 4, 2).reshape(rows * cols, patch_size, patch_size, image.shape[2])
    )
