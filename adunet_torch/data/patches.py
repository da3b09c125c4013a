"""Grid tiling of an RGB image into square patches (numpy).

Port of the grid half of ``adunet/data/patches.py`` (``grid_patch_count``
:82, ``grid_patches`` :112): row-major tiles at a stride, counted in closed
form from the image size alone. The random-crop half serves the streamed
training pipeline, which is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["grid_patches", "grid_patch_count"]


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
