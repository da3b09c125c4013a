"""K1, K2 and K3's forwards and the resize as ``torch.library`` custom ops,
for programs.

An exported program (``torch.export``, ``adunet_torch.export.program``)
cannot hold the kernels' ctypes calls: a launch reads ``data_ptr()`` of
tensors that are fake while the program is traced. These ops give the four
forward kernels a name in the graph instead, and dispatch by device when the
program runs:

- ``adunet_torch::layer_norm_relu(Tensor x, Tensor gamma, Tensor beta, float eps) -> Tensor``
  (K1, ``fused_norm.layer_norm_relu``);
- ``adunet_torch::conv3x3_c64(Tensor x, Tensor w, Tensor? bias) -> Tensor``
  (K2 in its SAME mode, ``conv64.conv3x3_same``; the halo-row mode serves no
  program);
- ``adunet_torch::conv3x3_f32(Tensor x, Tensor w, Tensor? bias) -> Tensor``
  (K3, ``conv3x3_f32.conv3x3_f32``: the float32 3x3 SAME convs K2's gate
  refuses, at C_in % 8 == 0 and C_out % 64 == 0);
- ``adunet_torch::resize_band(Tensor x, int out_h, int out_w, str method, bool antialias, ScalarType dtype) -> Tensor``
  (the banded resize, ``resize_band.resize_band``; its plain version is the
  dense product, ``resize_band.resize_band_plain``). Callers name it only
  where a size changes, so its output is never x.

CUDA runs the kernel (the wrappers' ``_launch``: one C call, the launch
counters bumped as in eager) or raises; CPU runs the plain version (picked
by ``kernels._route``; the resize's wrapper picks itself); the fake kernels
give the output's shape and type and read no data. No autograd
formula is registered, so differentiating through a program raises: a
program serves, as the reference's StableHLO programs do.

The eager wrappers call these ops only while ``torch.compiler.is_exporting()``
is true (``kernels._route``); an eager call keeps its one C call with no
dispatcher in front.
Importing this module (``adunet_torch.kernels`` does) registers the ops,
which a process must do before it loads a program.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.kernels._route import on_device
from adunet_torch.kernels.conv3x3_f32 import _launch as _k3_launch
from adunet_torch.kernels.conv3x3_f32 import conv3x3_f32_plain as _k3_plain
from adunet_torch.kernels.conv3x3_f32 import supported as _k3_supported
from adunet_torch.kernels.resize_band import resize_band as _resize_band

__all__ = ["layer_norm_relu", "conv3x3_c64", "conv3x3_f32", "resize_band"]


@torch.library.custom_op("adunet_torch::layer_norm_relu", mutates_args=(),
                         device_types=("cpu", "cuda"))
def layer_norm_relu(x: Tensor, gamma: Tensor, beta: Tensor, eps: float) -> Tensor:
    run = on_device("layer_norm_relu", x, fused_norm._launch, fused_norm.layer_norm_relu_plain)
    return run(x.contiguous(), gamma, beta, eps)


@layer_norm_relu.register_fake
def _layer_norm_relu_fake(x: Tensor, gamma: Tensor, beta: Tensor, eps: float) -> Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _gate(name: str, supported, x: Tensor, w: Tensor) -> None:
    if not supported(x.shape, w.shape):
        raise ValueError(f"adunet_torch::{name}: unsupported shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)}")


@torch.library.custom_op("adunet_torch::conv3x3_c64", mutates_args=(),
                         device_types=("cpu", "cuda"))
def conv3x3_c64(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
    _gate("conv3x3_c64", conv64.supported, x, w)
    return on_device("conv3x3_c64", x, conv64._launch, conv64.conv3x3_same_plain)(
        x.contiguous(), w, bias)


@conv3x3_c64.register_fake
def _conv3x3_c64_fake(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
    _gate("conv3x3_c64", conv64.supported, x, w)
    return x.new_empty((x.shape[0], x.shape[1], x.shape[2], w.shape[0]))


@torch.library.custom_op("adunet_torch::conv3x3_f32", mutates_args=(),
                         device_types=("cpu", "cuda"))
def conv3x3_f32(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
    _gate("conv3x3_f32", _k3_supported, x, w)
    return on_device("conv3x3_f32", x, _k3_launch, _k3_plain)(x.contiguous(), w, bias)


@conv3x3_f32.register_fake
def _conv3x3_f32_fake(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
    _gate("conv3x3_f32", _k3_supported, x, w)
    return x.new_empty((x.shape[0], x.shape[1], x.shape[2], w.shape[0]))


@torch.library.custom_op("adunet_torch::resize_band", mutates_args=(),
                         device_types=("cpu", "cuda"))
def resize_band(x: Tensor, out_h: int, out_w: int, method: str, antialias: bool,
                dtype: torch.dtype) -> Tensor:
    return _resize_band(x, (out_h, out_w), method, antialias, dtype)


@resize_band.register_fake
def _resize_band_fake(x: Tensor, out_h: int, out_w: int, method: str, antialias: bool,
                      dtype: torch.dtype) -> Tensor:
    return x.new_empty((*x.shape[:-3], out_h, out_w, x.shape[-1]), dtype=dtype)
