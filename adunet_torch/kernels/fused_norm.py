"""K1: fused LayerNorm(channels) + ReLU — a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``adunet/kernels/fused_norm.py:48``
(``_pallas_forward``; ``pl.pallas_call`` at :59). The CUDA source is
``adunet_torch/csrc/fused_norm.cu``: one warp per row of the (rows, C) view,
the row held in registers between the two float32 reductions, so x is read
once and y written once. Its bound on an H100 is bytes: (read x + write y) /
3.35 TB/s, e.g. ~80 us for the 524,288 x 64 float32 level of the flagship.

Dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
version below, a CUDA tensor launches the kernel or raises. There is no
fallback from a failed launch.
"""

from __future__ import annotations

import torch

from adunet_torch.kernels import _build

__all__ = ["layer_norm_relu", "layer_norm_relu_plain", "SUPPORTED_CHANNELS"]

SUPPORTED_CHANNELS = (64, 128, 256, 512, 1024, 2048)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_relu_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """The plain version: float32 statistics over the last axis, affine,
    ReLU, cast back to x.dtype — the recipe of the reference's
    ``layer_norm_relu_reference`` (``adunet/kernels/fused_norm.py:26``)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.to(torch.float32) + beta.to(torch.float32)
    return torch.relu(y).to(x.dtype)


def layer_norm_relu(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """LayerNorm over the last axis of (..., C), then ReLU.

    CUDA: float32 or bf16 ``x``, contiguous, C in ``SUPPORTED_CHANNELS``;
    anything else raises. CPU: the plain version. ``layer_norm_relu.launches``
    counts kernel launches."""
    if x.device.type == "cpu":
        return layer_norm_relu_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_relu: no kernel for device {x.device}")
    c = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm_relu: kernel takes float32 or bfloat16, got {x.dtype}")
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"layer_norm_relu: kernel takes C in {SUPPORTED_CHANNELS}, got {c}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_relu: kernel takes a contiguous (..., C) tensor")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"layer_norm_relu: gamma/beta must be ({c},)")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("layer_norm_relu: gamma/beta must be on x's device")
    g = gamma.detach().to(torch.float32).contiguous()
    b = beta.detach().to(torch.float32).contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    if x.data_ptr() % 16:
        raise ValueError("layer_norm_relu: kernel takes a 16-byte aligned tensor")
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.adunet_layer_norm_relu(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            rows, c, float(eps), _DTYPE_CODES[x.dtype], stream,
        )
    _build.check(code, "layer_norm_relu")
    layer_norm_relu.launches += 1
    return y


layer_norm_relu.launches = 0
