"""Vanilla fixed-depth SR U-Net (the baseline trainer's model).

Port of ``adunet/models/sr_vanilla.py`` (``VanillaSRUNet``), with the
reference's parameter and ``batch_stats`` tree:

- per encoder level: BatchNorm ConvBlock → 2x2 max-pool; channels double
  (64 → 128 → 256 → 512, bottleneck 1024 at base 64, depth 4);
- bottleneck BatchNorm ConvBlock;
- per decoder level: bilinear 2x upsample without antialias (TF's
  half-pixel rule, Keras ``UpSampling2D(interpolation="bilinear")``) in
  float32, cast to the compute dtype → ``dec{i}_smooth`` conv3x3 + ReLU →
  concat ``[h, skip]`` → BatchNorm ConvBlock;
- 1x1 ``enhanced_rgb`` head → float32 sigmoid.

``train()`` / ``eval()`` select batch or running statistics, which a
training forward updates as flax's mutable ``batch_stats``. No LayerNorm, so
no K1; at base 64 and 256 px, ``enc0.conv1`` and ``dec0.conv1`` (64 → 64 at
256 px) run K2, two launches per forward.
"""

from __future__ import annotations

import torch
from torch import nn

from adunet_torch.nn.blocks import Conv, ConvBlock, init_parameters, max_pool2x2
from adunet_torch.ops import resize
from adunet_torch.utils.runtime import resolve_device

__all__ = ["VanillaSRUNet", "build_vanilla_sr_unet"]


class VanillaSRUNet(nn.Module):
    def __init__(self, base_channels: int = 64, depth: int = 4, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        self.depth = int(depth)
        self.dtype = dtype
        nf, in_ch = base_channels, 3
        for level in range(self.depth):
            self.add_module(f"enc{level}", ConvBlock(in_ch, nf, norm="batch", device=device))
            in_ch, nf = nf, nf * 2
        self.bottleneck = ConvBlock(in_ch, nf, norm="batch", device=device)
        for level in reversed(range(self.depth)):
            self.add_module(f"dec{level}_smooth", Conv(nf, nf // 2, 3, device=device))
            nf //= 2
            self.add_module(f"dec{level}", ConvBlock(2 * nf, nf, norm="batch", device=device))
        self.enhanced_rgb = Conv(base_channels, 3, 1, device=device)
        init_parameters(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        skips = []
        for level in range(self.depth):
            skip = getattr(self, f"enc{level}")(h)
            h = max_pool2x2(skip)
            skips.append(skip)
        h = self.bottleneck(h)
        for level in reversed(range(self.depth)):
            h = resize(h, (h.shape[-3] * 2, h.shape[-2] * 2), "bilinear", antialias=False)
            h = torch.relu(getattr(self, f"dec{level}_smooth")(h.to(self.dtype)))
            h = getattr(self, f"dec{level}")(torch.cat([h, skips[level]], dim=-1))
        return torch.sigmoid(self.enhanced_rgb(h).to(torch.float32))


def build_vanilla_sr_unet(base_channels: int = 64, depth: int = 4,
                          dtype: torch.dtype = torch.float32,
                          device: str | torch.device = "cuda", seed: int = 0) -> VanillaSRUNet:
    """Build the model on ``device`` (CUDA by default; raises without a GPU
    unless ``device="cpu"``; ``"meta"`` builds no storage)."""
    return VanillaSRUNet(base_channels=base_channels, depth=depth, dtype=dtype,
                         device=resolve_device(device), seed=seed)
