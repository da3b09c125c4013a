"""Building blocks of the U-Nets, NHWC in and out.

Port of ``adunet/nn/blocks.py``:
- ``Conv``          ← ``conv3x3`` :59 / ``conv1x1`` :73 / ``PallasConv3x3`` :35.
  A SAME, stride-1 conv with bias and an OIHW ``weight``. A 3x3 conv at a
  shape the K2 gate accepts runs the K2 kernel (``conv3x3_same``, an
  autograd Function whose backward, ``conv3x3_same_backward``, runs K2's
  backward kernels for dx, dw and db: no cuDNN call); a float32 3x3 conv
  that K2 refuses, at C_in % 8 == 0 and C_out % 64 == 0, where no gradient
  is wanted (eval, serving, programs) and off a space mesh runs K3
  (``conv3x3_f32``, with its bias; ``kernels.conv3x3_f32.takes`` decides);
  every other conv (bf16, any forward a backward follows, C_in = 3, 1x1)
  goes to ``F.conv2d`` on the NHWC
  tensor's NCHW view (a contiguous NHWC tensor permuted is an NCHW tensor in
  channels_last memory format, so no copy is made). On a space mesh
  (``space``, set by ``adunet_torch.parallel.spatial.attach``) x holds this
  process's rows of the image: a 3x3 conv takes one row of each neighbour
  (``SpaceShard.halo``) and runs VALID in H, SAME in W: K2's halo-row mode
  (``conv3x3_rows``, its backward's dx on all H + 2 input rows) where the
  gate takes the output's shape, else ``F.conv2d`` with padding (0, 1).
- ``LayerNormReLU`` ← ``FusedLayerNormReLU`` :87 — K1 (``layer_norm_relu``,
  an autograd Function), eps 1e-3, with flax's ``scale``/``bias`` as
  ``weight``/``bias``; it takes the bias of a conv that left it out.

Parameters are float32 whatever the compute dtype. A conv casts its weight
and bias to the activations' dtype (flax's ``kernel.astype(dtype)``), and the
gradients reach the float32 parameters back through those casts; K2 takes
the float32 parameters uncast and rounds them the same way on the card
(its Function rounds their gradients to the compute dtype, then widens
them, as the cast's backward would).
- ``BatchNorm``     ← flax's ``nn.BatchNorm`` as ``ConvBlock`` configures it
  (:143-149), written out (not ``nn.BatchNorm2d``) because flax's semantics
  differ from torch's: statistics over (N, H, W) in float32 with the fast
  variance ``max(0, E[x^2] - E[x]^2)``, eps 1e-3, output float32, and the
  running update ``new = 0.99 old + 0.01 batch`` with the *biased* batch
  variance (torch's ``running_var`` takes the unbiased one). The buffers
  ``running_mean`` / ``running_var`` are flax's ``batch_stats/.../mean|var``;
  ``train()`` / ``eval()`` pick batch or running statistics.
- ``ConvBlock``     ← :102 — (conv3x3 → norm → ReLU) x2. ``norm="layer"``
  (K1), ``"batch"`` (BatchNorm in float32, ReLU, cast back to the compute
  dtype, :142-150) or ``"none"``. With K1, a conv that goes to the library
  runs without its bias (``Conv``'s ``hand_off_bias`` decides) and K1 adds
  it (cast to the compute dtype, as the conv took it) as it reads the conv's
  output, and sums its gradient in its backward: on the card bit for bit
  what cuDNN's conv and PyTorch's bias add after it gave, with no broadcast
  add and no bias sum of their own. K2 and K3 add their own bias; an exported
  program keeps the bias in the conv (K1's op takes none).
- ``ConvTranspose`` ← flax ``nn.ConvTranspose(kernel (2, 2), strides 2,
  "SAME")`` of ``adunet/models/seg_vanilla.py:43``: out[2i + a, 2j + b] =
  x[i, j] @ k[1 - a, 1 - b], since flax correlates the dilated input with the
  kernel unflipped. The weight is torch's (in, out, 2, 2), i.e. the flax
  kernel flipped in both spatial axes (``adunet_torch.convert``).
- ``max_pool2x2``   ← ``nn.max_pool(x, (2, 2), strides=(2, 2))``, VALID.

Init follows the reference (Keras defaults): glorot-uniform kernels, zero
biases, norm scale 1 and bias 0, running mean 0 and variance 1; every random
draw comes from the ``torch.Generator`` handed to ``reset_parameters``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adunet_torch.kernels import conv3x3_f32, conv3x3_rows, conv3x3_same, layer_norm_relu, supported
from adunet_torch.kernels.conv3x3_f32 import takes as conv3x3_f32_takes

__all__ = ["BN_MOMENTUM", "Conv", "LayerNormReLU", "BatchNorm", "ConvBlock", "ConvTranspose",
           "max_pool2x2", "init_parameters"]

# Keras' BatchNormalization default, as ``adunet/nn/blocks.py:30``.
BN_MOMENTUM = 0.99


def _glorot_(weight: torch.Tensor, fan_in: int, fan_out: int, generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    weight.copy_(torch.empty(weight.shape).uniform_(-limit, limit, generator=generator))


class Conv(nn.Module):
    """SAME conv (stride 1, bias) over NHWC with an OIHW weight."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 zero_init: bool = False, device=None):
        super().__init__()
        k = int(kernel_size)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.zero_init = zero_init
        self.space = None  # adunet_torch.parallel.spatial.SpaceShard on a space mesh

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                o, i, kh, kw = self.weight.shape
                _glorot_(self.weight, i * kh * kw, o * kh * kw, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, hand_off_bias: bool = False):
        """The conv of x; with ``hand_off_bias``, ``(y, bias_left_out)``: on
        the library route, unless exporting, y without the bias and the bias
        cast to x's type for the caller (``ConvBlock``: K1); else y with it and
        None. A module call, so that hooks (FSDP's weight gathers) run."""
        w, b = self.weight, self.bias  # K2 and K3 take them as they are (K2 rounds them itself)
        space = self.space is not None and w.shape[-1] == 3
        xp = self.space.halo(x, 1) if space else x
        if supported(x.shape, w.shape):  # K2
            y = conv3x3_rows(xp, w, b) if space else conv3x3_same(x.contiguous(), w, b)
        elif self.space is None and conv3x3_f32_takes(x, w, b):  # K3: float32, no gradient
            y = conv3x3_f32(x.contiguous(), w, b)
        else:
            leave = hand_off_bias and not torch.compiler.is_exporting()
            y = F.conv2d(xp.permute(0, 3, 1, 2), w.to(x.dtype), None if leave else b.to(x.dtype),
                         padding=(0, 1) if space else w.shape[-1] // 2).permute(0, 2, 3, 1)
            return (y, b.to(x.dtype) if leave else None) if hand_off_bias else y
        return (y, None) if hand_off_bias else y


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

    def forward(self, x: torch.Tensor, conv_bias: torch.Tensor | None = None) -> torch.Tensor:
        return layer_norm_relu(x.contiguous(), self.weight, self.bias, 1e-3, conv_bias)


def _global_moments(xf: torch.Tensor, axes, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, fast variance) per channel over every process's batch."""
    from torch.distributed.nn.functional import all_reduce

    c = xf.shape[-1]
    count = xf.new_full((1,), xf.numel() // c)
    sums = all_reduce(torch.cat([xf.sum(dim=axes), xf.square().sum(dim=axes), count]),
                      group=group)
    mean = sums[:c] / sums[-1]
    return mean, torch.clamp(sums[c : 2 * c] / sums[-1] - mean.square(), min=0.0)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3, dtype=float32)`` over
    the channels of an NHWC tensor; returns float32.

    In training mode the statistics are the batch's and the running buffers
    take ``momentum * old + (1 - momentum) * batch`` (no gradient). When
    ``stats_sink`` is a list, a training-mode forward appends its batch
    (mean, variance) there instead and leaves the buffers alone (precise-BN,
    ``adunet_torch.train.seg``).

    With a process group in ``sync_group`` (set by
    ``adunet_torch.parallel.data_parallel``), the training statistics are
    the global batch's, as flax's ``BatchNorm`` reduces over the whole
    batch sharded over a mesh: the per-channel sum, sum of squares and
    count are summed over the group in float32 by an all-reduce whose
    backward all-reduces the gradients too, and the running update and
    ``stats_sink`` see the global statistics."""

    def __init__(self, features: int, momentum: float = BN_MOMENTUM, eps: float = 1e-3,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.stats_sink: list | None = None
        self.sync_group = None

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            axes = tuple(range(xf.dim() - 1))
            if self.sync_group is not None:
                mean, var = _global_moments(xf, axes, self.sync_group)
            else:
                mean = xf.mean(dim=axes)
                var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
            if self.stats_sink is not None:
                self.stats_sink.append((mean.detach(), var.detach()))
            else:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class ConvBlock(nn.Module):
    """(Conv3x3 → Norm → ReLU) x2 at constant spatial size."""

    def __init__(self, in_channels: int, features: int, norm: str = "layer", device=None):
        super().__init__()
        if norm not in ("layer", "batch", "none"):
            raise ValueError(f"unknown norm {norm!r} (expected layer|batch|none)")
        self.norm = norm
        self.conv0 = Conv(in_channels, features, 3, device=device)
        self.conv1 = Conv(features, features, 3, device=device)
        if norm != "none":
            norm_cls = LayerNormReLU if norm == "layer" else BatchNorm
            self.norm0 = norm_cls(features, device=device)
            self.norm1 = norm_cls(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            conv = getattr(self, f"conv{i}")
            if self.norm == "layer":  # K1 adds a bias the conv left out (module docstring)
                x = getattr(self, f"norm{i}")(*conv(x, hand_off_bias=True))
            elif self.norm == "batch":  # float32 statistics, ReLU, then the compute dtype
                x = conv(x)
                x = torch.relu(getattr(self, f"norm{i}")(x)).to(x.dtype)
            else:
                x = torch.relu(conv(x))
        return x


class ConvTranspose(nn.Module):
    """flax's 2x2, stride-2, SAME ``ConvTranspose`` over NHWC (doubles H and W),
    with torch's (in, out, 2, 2) weight: the flax kernel flipped."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, 2, 2, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            i, o, kh, kw = self.weight.shape
            _glorot_(self.weight, i * kh * kw, o * kh * kw, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=2)
        return y.permute(0, 2, 3, 1)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, VALID, over NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def init_parameters(model: nn.Module, seed: int) -> None:
    """Draw every parameter of ``model`` from one seeded ``torch.Generator``,
    module by module in registration order (nothing on the meta device)."""
    if next(model.parameters()).device.type == "meta":
        return
    generator = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
