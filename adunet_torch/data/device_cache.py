"""Device-resident training corpus: the images live on the card as uint8 and
each train step samples its own patches there.

Port of ``adunet/data/device_cache.py``. ``load_device_cache`` stacks a
uniform-size corpus into one (N, H, W, 3) uint8 tensor on the device (DIV2K's
800 training images are ~5 GB as uint8; an H100 holds 80 GB).
``sample_patch_batch`` draws uniform image indices and crop offsets from a
``torch.Generator`` on the images' device and gathers the crops there, so a
step moves nothing from the host. ``jax.random``'s stream cannot be
reproduced, so a given seed crops other patches than the reference does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from adunet_torch.data.io import load_rgb_image_full_u8
from adunet_torch.utils.runtime import resolve_device

__all__ = ["load_device_cache", "sample_patch_batch"]


def load_device_cache(paths: Sequence[str], device: str | torch.device = "cuda") -> torch.Tensor:
    """Decode a uniform-size corpus into one (N, H, W, 3) uint8 tensor on
    ``device``. Raises on mixed image sizes."""
    dev = resolve_device(device)
    images = [load_rgb_image_full_u8(p) for p in paths]
    shapes = {im.shape for im in images}
    if len(shapes) != 1:
        raise ValueError(
            f"Device cache needs uniform image sizes, got {sorted(shapes)}; "
            "stage a uniform corpus or use the streaming patch pipeline."
        )
    return torch.from_numpy(np.stack(images)).to(dev)


def sample_patch_batch(images_u8: torch.Tensor, generator: torch.Generator,
                       batch_size: int, patch_size: int) -> torch.Tensor:
    """A (B, P, P, 3) float32 batch in [0, 1] of uniformly placed crops of
    uniformly chosen images, drawn and gathered on the images' device (the
    generator must live there too). Image index, then row, then column."""
    n, h, w, _ = images_u8.shape
    if h < patch_size or w < patch_size:
        raise ValueError(f"patch {patch_size} does not fit the cached {h}x{w} images")
    dev = images_u8.device
    idx = torch.randint(0, n, (batch_size,), generator=generator, device=dev)
    ys = torch.randint(0, h - patch_size + 1, (batch_size,), generator=generator, device=dev)
    xs = torch.randint(0, w - patch_size + 1, (batch_size,), generator=generator, device=dev)
    offs = torch.arange(patch_size, device=dev)
    rows = (ys[:, None] + offs)[:, :, None]  # (B, P, 1)
    cols = (xs[:, None] + offs)[:, None, :]  # (B, 1, P)
    batch = images_u8[idx[:, None, None], rows, cols]  # (B, P, P, 3)
    return batch.to(torch.float32) * (1.0 / 255.0)
