"""Adaptive-depth super-resolution U-Net — the flagship model.

Port of ``adunet/models/sr_adaptive.py`` (``AdaptiveSRUNet`` :38-105,
``build_super_resolution_unet`` :108), with exactly the reference's
parameter tree (names mirror flax: ``enc0.conv0.weight`` is flax's
``enc0/conv0/kernel`` in OIHW, ``enc0.norm0.weight`` its ``scale``):

- per encoder level: ConvBlock → fractional ``resize_by_scale`` (bilinear,
  antialias); channels double;
- bottleneck ConvBlock;
- per decoder level: ``resize_to_match`` → ``dec{i}_smooth`` conv3x3 + ReLU
  (no norm) → concat ``[h, skip]`` → ConvBlock;
- head ConvBlock → zero-init 1x1 ``residual_rgb`` → ``clipped_residual_add``
  in float32, so an untrained model is the identity.

Input and output are NHWC; the output is float32. ``dtype`` is the compute
dtype (``torch.bfloat16`` for mixed precision); parameters stay float32.

On a space mesh (``space``, set by ``adunet_torch.parallel.spatial.attach``)
the input holds this process's rows of each image and ``forward`` takes the
image's global ``height``: every level's height is computed from it
(``scaled_size``), never read from a tensor, and the resizes are
row-sharded, so the skip and the upsampled tensor of a level hold the same
rows.

Rematerialisation (:44-72): ``remat=True`` checkpoints every ConvBlock;
``remat_levels=N`` (which overrides ``remat``) checkpoints only the encoder
and decoder blocks of the N shallowest levels, whose activations are the
largest, and never the bottleneck or the head. A checkpointed block keeps
only its input for the backward and runs its forward again there
(``torch.utils.checkpoint``, non-reentrant), so on the card its K1 and K2
kernels launch a second time per training step. The block draws no random
numbers, so no RNG state is stashed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from adunet_torch.nn.blocks import Conv, ConvBlock, init_parameters
from adunet_torch.nn.depth_policy import custom_depth_from_scale, estimate_bottleneck_size
from adunet_torch.ops import clipped_residual_add, resize_by_scale, resize_to_match, scaled_size
from adunet_torch.utils.runtime import resolve_device

__all__ = ["AdaptiveSRUNet", "build_super_resolution_unet"]


class AdaptiveSRUNet(nn.Module):
    supports_space = True  # adunet_torch.parallel.spatial.attach covers it

    def __init__(
        self,
        scale: float,
        depth: int,
        base_channels: int = 64,
        residual_head_channels: int = 64,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        remat_levels: int | None = None,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        self.scale = float(scale)
        self.depth = int(depth)
        self.dtype = dtype
        self.remat = bool(remat)
        self.remat_levels = remat_levels
        nf, in_ch = base_channels, 3
        for level in range(self.depth):
            self.add_module(f"enc{level}", ConvBlock(in_ch, nf, device=device))
            in_ch, nf = nf, nf * 2
        self.bottleneck = ConvBlock(in_ch, nf, device=device)
        for level in reversed(range(self.depth)):
            nf //= 2
            self.add_module(f"dec{level}_smooth", Conv(2 * nf, nf, 3, device=device))
            self.add_module(f"dec{level}", ConvBlock(2 * nf, nf, device=device))
        self.head = ConvBlock(base_channels, residual_head_channels, device=device)
        self.residual_rgb = Conv(residual_head_channels, 3, 1, zero_init=True, device=device)
        self.space = None
        init_parameters(self, seed)

    def _uses_remat(self, level: int | None) -> bool:
        """Whether the block at ``level`` (None: bottleneck or head) is
        checkpointed."""
        if self.remat_levels is not None:
            return level is not None and level < self.remat_levels
        return self.remat

    def _block(self, name: str, h: torch.Tensor, level: int | None = None) -> torch.Tensor:
        block = getattr(self, name)
        if torch.is_grad_enabled() and self._uses_remat(level):
            return checkpoint(block, h, use_reentrant=False, preserve_rng_state=False)
        return block(h)

    def forward(self, x: torch.Tensor, height: int | None = None) -> torch.Tensor:
        """``height``: on a space mesh, the global height of x's images."""
        space = self.space
        if space is not None and height is None:
            raise ValueError("on a space mesh the forward needs the images' global height")
        rows = height if space is not None else None  # this level's global height
        inputs = x
        h = x.to(self.dtype)
        skips = []
        for level in range(self.depth):
            skip = self._block(f"enc{level}", h, level)
            h = resize_by_scale(skip, self.scale, space=space, height=rows)
            skips.append((skip, rows))
            rows = scaled_size(rows, self.scale) if space is not None else None
        h = self._block("bottleneck", h)
        for level in reversed(range(self.depth)):
            skip, skip_rows = skips[level]
            h = resize_to_match(h, skip, space=space, height=rows, ref_height=skip_rows)
            rows = skip_rows
            h = torch.relu(getattr(self, f"dec{level}_smooth")(h))
            h = torch.cat([h, skip], dim=-1)
            h = self._block(f"dec{level}", h, level)
        h = self._block("head", h)
        residual = self.residual_rgb(h)
        return clipped_residual_add(inputs.to(torch.float32), residual.to(torch.float32))


def build_super_resolution_unet(
    scale: float,
    base_channels: int = 64,
    residual_head_channels: int = 64,
    depth_override: int | None = None,
    input_size: int = 256,
    max_depth: int = 7,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
    remat_levels: int | None = None,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> Tuple[AdaptiveSRUNet, Dict[str, object]]:
    """Resolve depth and build the model on ``device`` (CUDA by default; raises
    without a GPU unless ``device="cpu"``; ``"meta"`` builds no storage)."""
    dev = resolve_device(device)
    depth = (
        depth_override
        if depth_override is not None
        else custom_depth_from_scale(scale, max_depth=max_depth, base_resolution=input_size)
    )
    model = AdaptiveSRUNet(
        scale=scale,
        depth=depth,
        base_channels=base_channels,
        residual_head_channels=residual_head_channels,
        dtype=dtype,
        remat=remat,
        remat_levels=remat_levels,
        device=dev,
        seed=seed,
    )
    info = {
        "scale": scale,
        "depth": depth,
        "bottleneck_size": estimate_bottleneck_size(input_size, scale, depth),
        "base_channels": base_channels,
        "max_depth": max_depth,
    }
    return model, info
