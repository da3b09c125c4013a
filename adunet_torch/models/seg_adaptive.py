"""Adaptive-depth segmentation U-Net (the protocol trainer's model).

Port of ``adunet/models/seg_adaptive.py`` (``AdaptiveSegUNet`` :23-49,
``build_adaptive_depth_unet`` :52), with the reference's parameter tree
(``enc0.norm0.weight`` is flax's ``params/enc0/norm0/scale``, the buffer
``enc0.norm0.running_mean`` its ``batch_stats/enc0/norm0/mean``):

- per encoder level: BatchNorm ConvBlock → 2x2 max-pool (VALID); channels
  double;
- bottleneck ConvBlock;
- per decoder level: bilinear 2x upsample (``resize``, no antialias, float32)
  cast back to the compute dtype → concat ``[h, skip]`` → ConvBlock;
- 1x1 ``lesion_mask`` conv → float32 sigmoid.

Input and output are NHWC; the output is float32 probabilities (B, H, W, 1).
``dtype`` is the compute dtype; parameters and BatchNorm statistics stay
float32. ``train()`` / ``eval()`` select batch or running statistics, as
flax's ``train=True`` / ``False``. The 64->64 3x3 convs at a shape K2's gate
accepts (``enc0.conv1`` and ``dec0.conv1`` at 256 px) run K2.
"""

from __future__ import annotations

import torch
from torch import nn

from adunet_torch.nn.blocks import Conv, ConvBlock, init_parameters, max_pool2x2
from adunet_torch.ops import resize
from adunet_torch.utils.runtime import resolve_device

__all__ = ["AdaptiveSegUNet", "build_adaptive_depth_unet"]


class AdaptiveSegUNet(nn.Module):
    def __init__(self, depth: int = 4, base_channels: int = 64,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        self.depth = int(depth)
        self.dtype = dtype
        nf, in_ch = base_channels, 3
        for level in range(self.depth):
            self.add_module(f"enc{level}", ConvBlock(in_ch, nf, norm="batch", device=device))
            in_ch, nf = nf, nf * 2
        self.bottleneck = ConvBlock(in_ch, nf, norm="batch", device=device)
        for level in reversed(range(self.depth)):
            nf //= 2
            self.add_module(f"dec{level}", ConvBlock(3 * nf, nf, norm="batch", device=device))
        self.lesion_mask = Conv(base_channels, 1, 1, device=device)
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
            h = torch.cat([h.to(self.dtype), skips[level]], dim=-1)
            h = getattr(self, f"dec{level}")(h)
        return torch.sigmoid(self.lesion_mask(h).to(torch.float32))


def build_adaptive_depth_unet(input_size: int, base_channels: int, depth: int,
                              dtype: torch.dtype = torch.float32,
                              device: str | torch.device = "cuda", seed: int = 0
                              ) -> AdaptiveSegUNet:
    """Build the model on ``device`` (CUDA by default; raises without a GPU
    unless ``device="cpu"``; ``"meta"`` builds no storage). Refuses a depth
    that pools the input to nothing."""
    if input_size // (2**depth) < 1:
        raise ValueError(
            f"depth={depth} collapses a {input_size}px input to zero extent "
            f"(needs input_size >= 2^depth = {2**depth})."
        )
    return AdaptiveSegUNet(depth=depth, base_channels=base_channels, dtype=dtype,
                           device=resolve_device(device), seed=seed)
