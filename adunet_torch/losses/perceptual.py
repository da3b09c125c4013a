"""VGG19 perceptual features for the ``combined`` SR loss.

Port of ``adunet/losses/perceptual.py``:

- ``vgg19_preprocess``: [0, 1] RGB → caffe BGR (x 255, channel flip, minus
  the BGR means), in float32 before any cast to the compute dtype;
- ``VGG19Features``: the tower truncated after ``block4_conv4``'s ReLU
  (conv stacks 2-2-4-4 with ReLU, 2x2 max-pool between blocks), NHWC in,
  float32 features out. Its convolutions are library convolutions
  (``F.conv2d`` on the NHWC tensor's NCHW view), as the reference's are
  ``nn.Conv`` and not Pallas;
- ``load_vgg19_params``: ``block{i}_conv{j}/kernel|bias`` arrays of an
  ``.npz`` (HWIO kernels) as the tower's state_dict (OIHW weights);
- ``make_perceptual_fn``: a function of RGB in [0, 1] with the weights
  frozen: they take no gradient, and the features of its input carry the
  gradient to the input.

Without an ``.npz`` the tower takes seeded random weights: flax's default
conv init (LeCun normal, truncated at two standard deviations, zero bias)
drawn from ``torch.Generator().manual_seed(19)``. These numbers cannot equal
those flax draws from ``jax.random.key(19)``, so without an ``.npz`` the
perceptual terms of the two packages differ; with the same ``.npz`` they
agree.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adunet_torch.nn.blocks import max_pool2x2
from adunet_torch.utils.runtime import resolve_device

__all__ = ["VGG19Features", "vgg19_preprocess", "load_vgg19_params", "make_perceptual_fn"]

# (block, convs, features) of the tower through block4_conv4
_CFG = [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512)]
# caffe BGR means of keras.applications.vgg19.preprocess_input
_BGR_MEANS = (103.939, 116.779, 123.68)
_INIT_SEED = 19


def _conv_names():
    return [(f"block{b}_conv{c}", f) for b, n, f in _CFG for c in range(1, n + 1)]


@functools.lru_cache(maxsize=None)
def _bgr_means(device: torch.device) -> torch.Tensor:
    # made once per device, outside a CUDA graph's capture (a host-to-device
    # copy cannot be captured) and outside inference mode
    with torch.inference_mode(False):
        return torch.tensor(_BGR_MEANS, dtype=torch.float32, device=device)


def vgg19_preprocess(rgb01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., 3) → caffe BGR in float32."""
    x = rgb01.to(torch.float32) * 255.0
    return x.flip(-1) - _bgr_means(x.device)


class VGG19Features(nn.Module):
    """The VGG19 tower through ``block4_conv4`` (after its ReLU)."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        in_ch = 3
        for name, features in _conv_names():
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.empty(features, in_ch, 3, 3, device=device))
            conv.bias = nn.Parameter(torch.empty(features, device=device))
            self.add_module(name, conv)
            in_ch = features

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default conv init: LeCun normal truncated at +-2 std, zero bias."""
        with torch.no_grad():
            for name, _ in _conv_names():
                conv = getattr(self, name)
                fan_in = conv.weight.shape[1] * 9
                # the std of a unit normal truncated to [-2, 2] is 0.8796...
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(conv.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                conv.weight.copy_(w)
                conv.bias.zero_()

    def forward(self, rgb01: torch.Tensor) -> torch.Tensor:
        x = vgg19_preprocess(rgb01).to(self.dtype)
        for block, n_convs, _ in _CFG:
            for c in range(1, n_convs + 1):
                conv = getattr(self, f"block{block}_conv{c}")
                y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                             padding=1)
                x = torch.relu(y.permute(0, 2, 3, 1))
            if block < 4:
                x = max_pool2x2(x)
        return x.to(torch.float32)


def load_vgg19_params(path: str | Path) -> Dict[str, torch.Tensor]:
    """The tower's state_dict from an ``.npz`` of ``block{i}_conv{j}/kernel``
    (HWIO) and ``/bias`` arrays."""
    out: Dict[str, torch.Tensor] = {}
    with np.load(str(path)) as data:
        for name, _ in _conv_names():
            kernel = np.asarray(data[f"{name}/kernel"], dtype=np.float32)
            out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
            out[f"{name}.bias"] = torch.from_numpy(np.asarray(data[f"{name}/bias"], dtype=np.float32))
    return out


def make_perceptual_fn(weights_path: str | Path | None = None, input_size: int = 256,
                       dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn(rgb01) -> block4_conv4 features`` with frozen weights: from
    ``weights_path`` if given, else seeded random ones. ``input_size`` is
    taken for the reference's signature (its init traces a sample of that
    size) and not used."""
    del input_size
    module = VGG19Features(dtype=dtype, device=resolve_device(device))
    if weights_path is not None:
        module.load_state_dict(load_vgg19_params(weights_path))
    else:
        module.reset_parameters(torch.Generator().manual_seed(_INIT_SEED))
    module.requires_grad_(False)
    module.eval()

    def perceptual_fn(rgb01: torch.Tensor) -> torch.Tensor:
        return module(rgb01)

    perceptual_fn.module = module
    return perceptual_fn
