"""Inputs made from a run's seed on the run's device: the weights and the
training corpus. Both sides, the program and the reference, are handed
these same tensors.

- ``sub_seed(seed, stream)``: one seed per use, so that weights, corpus,
  patch sampling and tiles draw from streams of their own.
- ``weights``: every parameter of the configuration's model
  (``param_shapes`` of its module, ``portbench/models/``) from one
  ``torch.rand`` call on the device, by the leaves' names and shapes:
  conv kernels (4-D) Glorot-uniform (as the model's own init), except the
  1x1 residual head (``residual_rgb.*``), drawn in +-0.002 (the model's
  zero head would make it the identity, which passes no gradient
  upstream; a small head keeps it near the identity, as the model starts,
  so that the loss follows the patches' content); LayerNorm scales and
  offsets (``*.norm*``) in 1 +- 0.1 and +-0.1; every other leaf, a conv's
  bias, in +-0.02. All float32.
- ``corpus``: an (N, H, W, 3) uint8 image tensor, made in chunks: each
  image a mix, in proportions of its own, of broad shading (a bicubic
  enlargement of 1/64-size noise), fine detail (of 1/4-size noise) and
  grain, so that patches differ in content as a photo corpus's do (flat
  to busy) and in their loss.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench import catalog


def sub_seed(seed: int, stream: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = catalog.model(cfg).param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)  # U(-1, 1)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = u[at:at + n].view(shape)
        at += n
        if name.startswith("residual_rgb."):
            leaf = leaf * 0.002
        elif len(shape) == 4:
            o, i, kh, kw = shape
            leaf = leaf * math.sqrt(6.0 / ((i + o) * kh * kw))
        elif ".norm" in name:
            leaf = 1.0 + 0.1 * leaf if name.endswith(".weight") else 0.1 * leaf
        else:  # a conv's bias
            leaf = leaf * 0.02
        out[name] = leaf.contiguous()
    return out


def corpus(seed: int, images: int, height: int, width: int, device,
           chunk: int = 32) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "corpus"))
    out = torch.empty((images, height, width, 3), dtype=torch.uint8, device=device)

    def field(n: int, cell: int) -> torch.Tensor:
        low = torch.rand((n, 3, height // cell + 2, width // cell + 2), generator=gen,
                         device=device)
        return F.interpolate(low, size=(height, width), mode="bicubic", align_corners=False) - 0.5

    for start in range(0, images, chunk):
        n = min(chunk, images - start)
        # per image: how much broad shading, fine detail and grain it has
        a, b, c = torch.rand((3, n, 1, 1, 1), generator=gen, device=device)
        img = field(n, 64).mul_(0.4 + 0.6 * a).add_(field(n, 4).mul_(0.8 * b * b))
        img.add_(torch.randn(img.shape, generator=gen, device=device).mul_(0.08 * c * c))
        out[start:start + n] = img.add_(0.5).clamp_(0.0, 1.0).mul_(255.0).round_().to(
            torch.uint8).permute(0, 2, 3, 1)
    return out
