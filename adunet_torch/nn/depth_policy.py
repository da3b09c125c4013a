"""Encoder-depth policies — pure functions of the config.

The port's own copy of ``adunet/nn/depth_policy.py``; the reference package
is never imported.
- ``infer_depth_from_scale``   ← ``adunet/nn/depth_policy.py:29`` (design table)
- ``depth_and_sizes``          ← ``adunet/nn/depth_policy.py:42``
- ``custom_depth_from_scale``  ← ``adunet/nn/depth_policy.py:54`` (the one the
  SR trainers use)
- ``estimate_bottleneck_size`` ← ``adunet/nn/depth_policy.py:85``
- ``encoder_sizes``            ← ``adunet/nn/depth_policy.py:93``
"""

from __future__ import annotations

from math import ceil
from typing import List, Tuple

__all__ = [
    "infer_depth_from_scale",
    "custom_depth_from_scale",
    "depth_and_sizes",
    "estimate_bottleneck_size",
    "encoder_sizes",
]


def infer_depth_from_scale(scale: float, min_depth: int = 1, max_depth: int = 4) -> int:
    """Design-table policy: scale<=0.25 -> 1, <=0.45 -> 2, else 3 (clamped)."""
    if not (0.05 < scale < 1.0):
        raise ValueError("scale: expected a value strictly inside (0, 1).")
    if scale <= 0.25:
        depth = 1
    elif scale <= 0.45:
        depth = 2
    else:
        depth = 3
    return max(min_depth, min(depth, max_depth))


def depth_and_sizes(scale: float, min_res: int = 21, max_depth: int = 7) -> Tuple[int, List[int]]:
    """Shrink a 256-px extent by ``scale`` until < min_res or max_depth."""
    depth = 1
    sizes = [256]
    res = 256
    while res > min_res and depth < max_depth:
        res = ceil(res * scale)
        sizes.append(res)
        depth += 1
    return min(depth, max_depth), sizes


def custom_depth_from_scale(
    scale: float,
    min_depth: int = 1,
    max_depth: int = 7,
    *,
    base_resolution: int = 256,
    min_feature: int = 21,
) -> int:
    """Geometric policy: deepen while ceil(extent*scale) stays >= min_feature."""
    if not (0.05 < scale < 1.0):
        raise ValueError("scale: expected a value strictly inside (0, 1).")
    if min_depth < 1:
        raise ValueError("min_depth: expected a value >= 1.")
    if max_depth < 1:
        raise ValueError("max_depth: expected a value >= 1.")
    if base_resolution <= 0:
        raise ValueError("base_resolution: expected a value >= 1.")
    if min_feature < 1:
        raise ValueError("min_feature: expected a pixel extent >= 1.")

    depth = max(min_depth, 1)
    extent = base_resolution
    while depth < max_depth:
        candidate = ceil(extent * scale)
        if candidate < min_feature:
            break
        extent = candidate
        depth += 1
    return max(min_depth, min(depth, max_depth))


def estimate_bottleneck_size(hr: int, scale: float, depth: int) -> int:
    """Spatial extent after ``depth`` shrinks (round-based, for diagnostics)."""
    size = hr
    for _ in range(depth):
        size = max(1, int(round(size * scale)))
    return size


def encoder_sizes(input_size: int, scale: float, depth: int) -> List[int]:
    """Per-level spatial sizes of the adaptive encoder: level 0 is the input,
    each next level ceil(prev*scale) floored at 1; depth+1 entries."""
    sizes = [int(input_size)]
    for _ in range(depth):
        sizes.append(max(1, ceil(sizes[-1] * float(scale))))
    return sizes
