"""Vanilla segmentation U-Net (the baseline trainer's model).

Port of ``adunet/models/seg_vanilla.py`` (``VanillaSegUNet`` :22-60,
``build_unet`` :63), with the reference's parameter tree:

- per encoder level: LayerNorm ConvBlock (K1) → 2x2 max-pool; channels double;
- bottleneck ConvBlock;
- per decoder level: ``dec{i}_up`` 2x2 stride-2 ``ConvTranspose`` → concat
  ``[h, skip]`` → ConvBlock;
- 1x1 ``mask_logits`` conv → float32 sigmoid (one class) or softmax over
  the classes.

At base 32 and 256 px its LN+ReLU pairs run K1 at C = 32 ... 512 and its
64->64 convs at 128 px (``enc1.conv1``, ``dec1.conv1``) run K2.
"""

from __future__ import annotations

import torch
from torch import nn

from adunet_torch.nn.blocks import Conv, ConvBlock, ConvTranspose, init_parameters, max_pool2x2
from adunet_torch.utils.runtime import resolve_device

__all__ = ["VanillaSegUNet", "build_unet"]


class VanillaSegUNet(nn.Module):
    def __init__(self, num_classes: int = 1, base_channels: int = 32, depth: int = 4,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        self.num_classes = int(num_classes)
        self.depth = int(depth)
        self.dtype = dtype
        nf, in_ch = base_channels, 3
        for level in range(self.depth):
            self.add_module(f"enc{level}", ConvBlock(in_ch, nf, norm="layer", device=device))
            in_ch, nf = nf, nf * 2
        self.bottleneck = ConvBlock(in_ch, nf, norm="layer", device=device)
        for level in reversed(range(self.depth)):
            self.add_module(f"dec{level}_up", ConvTranspose(nf, nf // 2, device=device))
            nf //= 2
            self.add_module(f"dec{level}", ConvBlock(2 * nf, nf, norm="layer", device=device))
        self.mask_logits = Conv(base_channels, self.num_classes, 1, device=device)
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
            h = getattr(self, f"dec{level}_up")(h)
            h = getattr(self, f"dec{level}")(torch.cat([h, skips[level]], dim=-1))
        out = self.mask_logits(h).to(torch.float32)
        if self.num_classes == 1:
            return torch.sigmoid(out)
        return torch.softmax(out, dim=-1)


def build_unet(input_size: int, num_classes: int = 1, base_channels: int = 32, depth: int = 4,
               dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda",
               seed: int = 0) -> VanillaSegUNet:
    """Build the model on ``device`` (CUDA by default; raises without a GPU
    unless ``device="cpu"``). ``input_size`` is taken for the reference's
    signature and not used, as there."""
    del input_size
    return VanillaSegUNet(num_classes=num_classes, base_channels=base_channels, depth=depth,
                          dtype=dtype, device=resolve_device(device), seed=seed)
