"""Building blocks of the SR U-Net, NHWC in and out.

Port of ``adunet/nn/blocks.py``:
- ``Conv``          ← ``conv3x3`` :59 / ``conv1x1`` :73 / ``PallasConv3x3`` :35.
  A SAME, stride-1 conv with bias and an OIHW ``weight``. A 3x3 conv at a
  shape the K2 gate accepts runs the K2 kernel (``conv3x3_same``, an
  autograd Function); every other conv goes to ``F.conv2d`` on the NHWC
  tensor's NCHW view (a contiguous NHWC tensor permuted is an NCHW tensor in
  channels_last memory format, so no copy is made).
- ``LayerNormReLU`` ← ``FusedLayerNormReLU`` :87 — K1 (``layer_norm_relu``,
  an autograd Function), eps 1e-3, with flax's ``scale``/``bias`` as
  ``weight``/``bias``.

Parameters are float32 whatever the compute dtype. A conv casts its weight
and bias to the activations' dtype (flax's ``kernel.astype(dtype)``), and the
gradients reach the float32 parameters back through those casts.
- ``ConvBlock``     ← :102 — (conv3x3 → norm → ReLU) x2. ``norm="layer"`` or
  ``"none"``; ``"batch"`` belongs to the segmentation models and raises.

Init follows the reference (Keras defaults): glorot-uniform kernels, zero
biases, LayerNorm scale 1 and bias 0; every random draw comes from the
``torch.Generator`` handed to ``reset_parameters``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adunet_torch.kernels import conv3x3_same, layer_norm_relu, supported

__all__ = ["Conv", "LayerNormReLU", "ConvBlock"]


class Conv(nn.Module):
    """SAME conv (stride 1, bias) over NHWC with an OIHW weight."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 zero_init: bool = False, device=None):
        super().__init__()
        k = int(kernel_size)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.zero_init = zero_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                o, i, kh, kw = self.weight.shape
                limit = math.sqrt(6.0 / ((i + o) * kh * kw))
                draw = torch.empty(self.weight.shape).uniform_(-limit, limit, generator=generator)
                self.weight.copy_(draw)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype)
        if supported(tuple(x.shape), tuple(w.shape)):
            return conv3x3_same(x.contiguous(), w, b)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=w.shape[-1] // 2)
        return y.permute(0, 2, 3, 1)


class LayerNormReLU(nn.Module):
    """LayerNorm over channels (eps 1e-3) + ReLU through K1."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_relu(x.contiguous(), self.weight, self.bias, 1e-3)


class ConvBlock(nn.Module):
    """(Conv3x3 → Norm → ReLU) x2 at constant spatial size."""

    def __init__(self, in_channels: int, features: int, norm: str = "layer", device=None):
        super().__init__()
        if norm == "batch":
            raise NotImplementedError(
                "ConvBlock(norm='batch') belongs to the segmentation models, "
                "which are not ported yet."
            )
        if norm not in ("layer", "none"):
            raise ValueError(f"unknown norm {norm!r} (expected layer|none)")
        self.norm = norm
        self.conv0 = Conv(in_channels, features, 3, device=device)
        self.conv1 = Conv(features, features, 3, device=device)
        if norm == "layer":
            self.norm0 = LayerNormReLU(features, device=device)
            self.norm1 = LayerNormReLU(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"conv{i}")(x)
            x = getattr(self, f"norm{i}")(x) if self.norm == "layer" else torch.relu(x)
        return x
