"""On-device segmentation augmentation with static shapes.

Port of ``adunet/data/augment.py``: rot90 (k in 0..3), left-right and
up-down flips, then a 1.0-1.15x scale jitter with an aligned random crop back
to the input size, the image sampled bilinearly with clamped taps and the
mask by nearest neighbour and re-binarised at 0.5. As in the reference, the
"resize to round(u * S), then crop" of the original trainer is written as a
gather at static coordinates: crop pixel i of the resized image is the
original sampled at ``(o + i + 0.5) * S / scaled - 0.5`` (image) or
``floor((o + i + 0.5) * S / scaled)`` (mask).

Each op is split into a **draw** (``draw_augment`` / ``draw_flips``, from a
``torch.Generator`` on the batch's device) and a deterministic **apply** that
takes the draws: k, flip_lr, flip_ud, scaled and the crop offsets oy, ox, one
per sample. jax.random's stream cannot be reproduced in torch, so the tests
hold the apply to the reference's fed the draws the reference makes from a
given key.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "draw_flips",
    "draw_augment",
    "apply_flips",
    "apply_augment",
    "flip_pair_batch",
    "augment_pair_batch",
]

Draws = Dict[str, torch.Tensor]


def draw_flips(n: int, generator: torch.Generator) -> Draws:
    """Per sample: flip left-right, flip up-down (each with probability 1/2)."""
    dev = generator.device
    return {"flip_lr": torch.rand(n, generator=generator, device=dev) > 0.5,
            "flip_ud": torch.rand(n, generator=generator, device=dev) > 0.5}


def draw_augment(n: int, size: int, generator: torch.Generator, min_scale: float = 1.0,
                 max_scale: float = 1.15) -> Draws:
    """Per sample: rot90 count k, the flips, the scaled size
    ``round(u * size)`` for u uniform in [min_scale, max_scale), and crop
    offsets oy, ox uniform in [0, scaled - size]."""
    dev = generator.device
    k = torch.randint(0, 4, (n,), generator=generator, device=dev)
    draws = {"k": k, **draw_flips(n, generator)}
    u = min_scale + (max_scale - min_scale) * torch.rand(n, generator=generator, device=dev)
    scaled = torch.round(u * size).to(torch.int64)
    span = (scaled - size + 1).to(torch.float32)
    draws["scaled"] = scaled
    for name in ("oy", "ox"):
        draws[name] = torch.floor(torch.rand(n, generator=generator, device=dev) * span).to(torch.int64)
    return draws


def _flip_index(size: int, flip: torch.Tensor) -> torch.Tensor:
    """(N, size) source index along one axis: reversed where ``flip``."""
    idx = torch.arange(size, device=flip.device)
    return torch.where(flip[:, None], size - 1 - idx, idx)


def _gather_hw(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[n, rows[n, i, j], cols[n, i, j], :] for (N, S, S) index maps."""
    n = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[n, rows, cols]


def _rot_flip_index(size: int, k: torch.Tensor, flip_lr: torch.Tensor, flip_ud: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source (row, col) maps of ``rot90(x, k)`` then the flips, as one gather:
    out[i, j] = rot[ud(i), lr(j)], and rot90 by k (counter-clockwise, axes
    (0, 1)) reads x[j, S-1-i], x[S-1-i, S-1-j], x[S-1-j, i] for k = 1, 2, 3."""
    a = _flip_index(size, flip_ud)[:, :, None].expand(-1, size, size)  # rot's row
    b = _flip_index(size, flip_lr)[:, None, :].expand(-1, size, size)  # rot's col
    kk = k[:, None, None]
    last = size - 1
    rows = torch.where(kk == 0, a, torch.where(kk == 1, b, torch.where(kk == 2, last - a, last - b)))
    cols = torch.where(kk == 0, b, torch.where(kk == 1, last - a, torch.where(kk == 2, last - b, a)))
    return rows, cols


def apply_flips(images: torch.Tensor, masks: torch.Tensor, flip_lr: torch.Tensor,
                flip_ud: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flips of (N, S, S, C) images and masks, one pair of draws per sample."""
    size = images.shape[1]
    rows = _flip_index(size, flip_ud)[:, :, None].expand(-1, size, size)
    cols = _flip_index(size, flip_lr)[:, None, :].expand(-1, size, size)
    return _gather_hw(images, rows, cols), _gather_hw(masks, rows, cols)


def _linear_gather(x: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    """Sample (N, S, S, C) ``x`` along ``axis`` (1 or 2) at per-sample
    fractional ``coords`` (N, S), with clamped bilinear taps."""
    n = x.shape[axis]
    i0 = torch.floor(coords)
    frac = coords - i0
    i0 = i0.to(torch.int64)
    lo, hi = torch.clamp(i0, 0, n - 1), torch.clamp(i0 + 1, 0, n - 1)
    batch = torch.arange(x.shape[0], device=x.device)[:, None]
    if axis == 1:
        a, b, w = x[batch, lo], x[batch, hi], frac[:, :, None, None]
    else:
        a, b, w = x[batch, :, lo].transpose(1, 2), x[batch, :, hi].transpose(1, 2), frac[:, None, :, None]
    return a * (1.0 - w) + b * w


def _nearest_gather(x: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.clamp(torch.floor(coords).to(torch.int64), 0, n - 1)
    batch = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[batch, idx] if axis == 1 else x[batch, :, idx].transpose(1, 2)


def apply_augment(images: torch.Tensor, masks: torch.Tensor, k: torch.Tensor,
                  flip_lr: torch.Tensor, flip_ud: torch.Tensor, scaled: torch.Tensor,
                  oy: torch.Tensor, ox: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """rot90^k, the flips, then the scale-jitter crop, for (N, S, S, C)
    images and (N, S, S, 1) masks; float32 out, masks in {0, 1}."""
    size = images.shape[1]
    rows, cols = _rot_flip_index(size, k, flip_lr, flip_ud)
    images = _gather_hw(images.to(torch.float32), rows, cols)
    masks = _gather_hw(masks.to(torch.float32), rows, cols)

    ratio = size / scaled.to(torch.float32)[:, None]
    idx = torch.arange(size, dtype=torch.float32, device=images.device)[None, :]
    oyf, oxf = oy.to(torch.float32)[:, None], ox.to(torch.float32)[:, None]
    ys, xs = (oyf + idx + 0.5) * ratio, (oxf + idx + 0.5) * ratio
    img = _linear_gather(_linear_gather(images, ys - 0.5, 1), xs - 0.5, 2)
    msk = _nearest_gather(_nearest_gather(masks, ys, 1), xs, 2)
    return img, torch.where(msk > 0.5, 1.0, 0.0)


def flip_pair_batch(images: torch.Tensor, masks: torch.Tensor, generator: torch.Generator):
    """Flips only (the vanilla trainer's augmentation), drawn from ``generator``."""
    d = draw_flips(images.shape[0], generator)
    return apply_flips(images, masks, d["flip_lr"], d["flip_ud"])


def augment_pair_batch(images: torch.Tensor, masks: torch.Tensor, generator: torch.Generator,
                       min_scale: float = 1.0, max_scale: float = 1.15):
    """rot90, flips and scale-jitter crop (the protocol trainer's), drawn
    from ``generator``."""
    d = draw_augment(images.shape[0], images.shape[1], generator, min_scale, max_scale)
    return apply_augment(images, masks, **d)
