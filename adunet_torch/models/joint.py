"""Joint SR + segmentation U-Net with a shared encoder (BASELINE config 5).

Port of ``adunet/models/joint.py`` (``JointSRSegUNet`` :29-91,
``build_joint_unet`` :94), with the reference's parameter tree:

- shared encoder: per level a LayerNorm ConvBlock ``enc{i}`` → fractional
  ``resize_by_scale``; channels double; then the ``bottleneck`` ConvBlock;
- two decoders off the bottleneck, ``sr`` and ``seg``, each per level:
  ``resize_to_match`` → ``{tag}_dec{i}_smooth`` conv3x3 + ReLU → concat
  ``[d, skip]`` → ConvBlock ``{tag}_dec{i}``;
- SR head: ``sr_head`` ConvBlock → zero-init 1x1 ``residual_rgb`` →
  ``clipped_residual_add`` in float32 (the tie-splitting clip), so an
  untrained model restores to its input;
- seg head: 1x1 ``mask_logits`` in float32 → sigmoid for one class, softmax
  over channels for more.

``forward`` returns ``(sr, mask)``, both float32. The input is cast to the
compute ``dtype`` (``torch.bfloat16`` for mixed precision); parameters stay
float32. ``remat=True`` checkpoints every ConvBlock as the SR model does
(``torch.utils.checkpoint``, non-reentrant). On the card every LN+ReLU pair
runs K1 and every 64->64 3x3 conv at a shape K2's gate accepts runs K2
(at 256 px: ``enc0.conv1``, ``sr_dec0.conv1``, ``seg_dec0.conv1`` and both
``sr_head`` convs).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from adunet_torch.nn.blocks import Conv, ConvBlock, init_parameters
from adunet_torch.nn.depth_policy import custom_depth_from_scale, estimate_bottleneck_size
from adunet_torch.ops import clipped_residual_add, resize_by_scale, resize_to_match
from adunet_torch.utils.runtime import resolve_device

__all__ = ["JointSRSegUNet", "build_joint_unet"]

_TAGS = ("sr", "seg")


class JointSRSegUNet(nn.Module):
    def __init__(
        self,
        scale: float,
        depth: int,
        base_channels: int = 64,
        residual_head_channels: int = 64,
        num_classes: int = 1,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        self.scale = float(scale)
        self.depth = int(depth)
        self.num_classes = int(num_classes)
        self.dtype = dtype
        self.remat = bool(remat)
        nf, in_ch = base_channels, 3
        for level in range(self.depth):
            self.add_module(f"enc{level}", ConvBlock(in_ch, nf, device=device))
            in_ch, nf = nf, nf * 2
        self.bottleneck = ConvBlock(in_ch, nf, device=device)
        for tag in _TAGS:
            dn = nf
            for level in reversed(range(self.depth)):
                dn //= 2
                self.add_module(f"{tag}_dec{level}_smooth", Conv(2 * dn, dn, 3, device=device))
                self.add_module(f"{tag}_dec{level}", ConvBlock(2 * dn, dn, device=device))
        self.sr_head = ConvBlock(base_channels, residual_head_channels, device=device)
        self.residual_rgb = Conv(residual_head_channels, 3, 1, zero_init=True, device=device)
        self.mask_logits = Conv(base_channels, self.num_classes, 1, device=device)
        init_parameters(self, seed)

    def _block(self, name: str, h: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, h, use_reentrant=False, preserve_rng_state=False)
        return block(h)

    def _decoder(self, tag: str, h: torch.Tensor, skips) -> torch.Tensor:
        for level in reversed(range(self.depth)):
            skip = skips[level]
            h = resize_to_match(h, skip)
            h = torch.relu(getattr(self, f"{tag}_dec{level}_smooth")(h))
            h = torch.cat([h, skip], dim=-1)
            h = self._block(f"{tag}_dec{level}", h)
        return h

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        inputs = x
        h = x.to(self.dtype)
        skips = []
        for level in range(self.depth):
            skip = self._block(f"enc{level}", h)
            h = resize_by_scale(skip, self.scale)
            skips.append(skip)
        bottleneck = self._block("bottleneck", h)

        sr = self._block("sr_head", self._decoder("sr", bottleneck, skips))
        residual = self.residual_rgb(sr)
        sr_out = clipped_residual_add(inputs.to(torch.float32), residual.to(torch.float32))

        logits = self.mask_logits(self._decoder("seg", bottleneck, skips)).to(torch.float32)
        mask = torch.sigmoid(logits) if self.num_classes == 1 else torch.softmax(logits, dim=-1)
        return sr_out, mask


def build_joint_unet(
    scale: float,
    base_channels: int = 64,
    residual_head_channels: int = 64,
    num_classes: int = 1,
    depth_override: int | None = None,
    input_size: int = 256,
    max_depth: int = 7,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> Tuple[JointSRSegUNet, Dict[str, object]]:
    """Resolve depth through the SR depth policy and build the model on
    ``device`` (CUDA by default; raises without a GPU unless ``device="cpu"``;
    ``"meta"`` builds no storage)."""
    dev = resolve_device(device)
    depth = (
        depth_override
        if depth_override is not None
        else custom_depth_from_scale(scale, max_depth=max_depth, base_resolution=input_size)
    )
    model = JointSRSegUNet(
        scale=scale,
        depth=depth,
        base_channels=base_channels,
        residual_head_channels=residual_head_channels,
        num_classes=num_classes,
        dtype=dtype,
        remat=remat,
        device=dev,
        seed=seed,
    )
    info = {
        "scale": scale,
        "depth": depth,
        "bottleneck_size": estimate_bottleneck_size(input_size, scale, depth),
        "base_channels": base_channels,
        "num_classes": num_classes,
    }
    return model, info
