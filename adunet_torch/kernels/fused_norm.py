"""K1: fused LayerNorm(channels) + ReLU — a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``adunet/kernels/fused_norm.py:48``
(``_pallas_forward``; ``pl.pallas_call`` at :59). The CUDA source is
``adunet_torch/csrc/fused_norm.cu``: each lane loads 16-byte vectors, a row
is held by L = min(32, C / vector) lanes (so at C <= 64 in float32 and C <=
128 in bf16 a warp holds 32 / L rows), and the row stays in registers
between the two float32 reductions, so x is read once and y written once.
Its bound on an H100 is bytes: (read x + write y) / 3.35 TB/s, e.g. ~80 us
for the 524,288 x 64 float32 level of the flagship.

``layer_norm_relu`` is a ``torch.autograd.Function``, the counterpart of the
reference's custom VJP (:86-136). It saves x, gamma and beta. Forward: the
kernel above. Backward: the reference's ``_bwd`` (:109-133), a float32
recompute from the inputs, as a second kernel in the same source: the
forward's split and statistics code, so the ReLU mask is the forward
kernel's; x and the cotangent held as raw words; dgamma / dbeta by a
deterministic two-level sum, each lane's column partials in registers at C
<= 512 and in its warp's slice of shared memory at C >= 1024, over a grid
sized to the blocks that fit on the card. Its bound is bytes too: read x
and the cotangent, write dx, e.g. ~0.24 ms at 2,097,152 x 64 bf16.
``layer_norm_relu_backward`` is its plain version.

Conv bias: ``conv_bias``, the bias of a library conv whose output x is (the
conv ran without it: ``nn.blocks.ConvBlock``, which passes the bias cast to
x's type as the conv took it), is added by the kernels to each element as
they read it, as PyTorch's add after the conv did: the sum rounded once to
x's type. The backward returns its gradient too, dx summed over the rows as
stored (float32 sums rounded to x's type, as the conv's bias sum gave it).
So a library conv's output is read once, by K1, with no broadcast add before
it and no bias sum beside the backward.

A CPU tensor takes the plain PyTorch version below, a CUDA tensor launches
the kernel or raises (``kernels._route``); no failed launch falls back.
"""

from __future__ import annotations

import ctypes

import torch

from adunet_torch.kernels import _build
from adunet_torch.kernels._route import on_device, route

__all__ = [
    "layer_norm_relu",
    "layer_norm_relu_plain",
    "layer_norm_relu_backward",
    "SUPPORTED_CHANNELS",
]

SUPPORTED_CHANNELS = (16, 32, 64, 128, 256, 512, 1024, 2048)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (so gradcheck sees full precision)."""
    return torch.promote_types(dtype, torch.float32)


def _plus_bias(x: torch.Tensor, conv_bias: torch.Tensor | None) -> torch.Tensor:
    """x + conv_bias as a conv's bias add computes it: the bias cast to x's
    type, one rounding of the sum to x's type; x where there is no bias."""
    return x if conv_bias is None else x + conv_bias.to(x.dtype)


def layer_norm_relu_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3,
    conv_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version: float32 statistics over the last axis, affine,
    ReLU, cast back to x.dtype — the recipe of the reference's
    ``layer_norm_relu_reference`` (``adunet/kernels/fused_norm.py:26``) —
    of x plus ``conv_bias`` where one is given (``_plus_bias``)."""
    acc = _acc_dtype(x.dtype)
    xf = _plus_bias(x, conv_bias).to(acc)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.to(acc) + beta.to(acc)
    return torch.relu(y).to(x.dtype)


def layer_norm_relu_backward(x, gamma, beta, g, eps: float = 1e-3, conv_bias=None):
    """(dx, dgamma, dbeta) of ``layer_norm_relu`` at (x, gamma, beta) for the
    output cotangent ``g``, and dbias after them where ``conv_bias`` is
    given: the reference's ``_bwd``, recomputed in float32; the backward
    kernel's plain version (the CPU path, and its oracle on the card).
    dgamma / dbeta are summed over every axis but the last; dbias is the
    returned dx summed the same way in float32, rounded to x's type and
    given the bias's type. The statistics and the ReLU mask use the plain forward's operations
    in its order, so the mask is the forward's bit for bit (a value one
    rounding either side of 0 would flip a whole element of dx); the rest
    reuses temporaries made here in place to spare passes over the (rows, C)
    float32 tensors."""
    acc = _acc_dtype(x.dtype)
    xf = _plus_bias(x, conv_bias).to(acc)
    mean = xf.mean(dim=-1, keepdim=True)
    xhat = xf - mean
    inv = torch.rsqrt(xhat.square().mean(dim=-1, keepdim=True) + eps)
    xhat.mul_(inv)
    del xf
    gamma_f = gamma.to(acc)
    gm = torch.where(xhat * gamma_f + beta.to(acc) > 0, g.to(acc), 0.0)
    reduce_axes = tuple(range(x.dim() - 1))
    dgamma = torch.sum(gm * xhat, dim=reduce_axes).to(gamma.dtype)
    dbeta = torch.sum(gm, dim=reduce_axes).to(beta.dtype)
    gx_hat = gm.mul_(gamma_f)
    mean_g = gx_hat.mean(dim=-1, keepdim=True)
    mean_gx = (gx_hat * xhat).mean(dim=-1, keepdim=True)
    dx = gx_hat.sub_(mean_g).addcmul_(xhat, mean_gx, value=-1.0).mul_(inv).to(x.dtype)
    if conv_bias is None:
        return dx, dgamma, dbeta
    dbias = dx.to(acc).sum(dim=reduce_axes).to(x.dtype).to(conv_bias.dtype)
    return dx, dgamma, dbeta, dbias


_F32 = torch.float32
_SUPPORTED = frozenset(SUPPORTED_CHANNELS)


def _params(c: int, index: int, dtype: torch.dtype, gamma: torch.Tensor,
            beta: torch.Tensor, conv_bias: torch.Tensor | None) -> list:
    """gamma and beta as the kernels read them, contiguous float32 (C,) on
    device ``index``, and the conv bias (or None) in x's type ``dtype``: as
    they are where they are so (one branch each), anything else cast; raises
    on a wrong shape or device."""
    out = []
    for p, want in ((gamma, _F32), (beta, _F32), (conv_bias, dtype)):
        if p is not None:
            if p.shape != (c,):
                raise ValueError(f"layer_norm_relu: gamma/beta/conv_bias must be ({c},)")
            if p.get_device() != index:
                raise ValueError("layer_norm_relu: gamma/beta/conv_bias must be on x's device")
            if p.dtype is not want or not p.is_contiguous():
                p = p.to(want).contiguous()
        out.append(p)
    return out


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _check_x(x: torch.Tensor) -> tuple[int, int]:
    """(C, dtype code) of a CUDA tensor the kernels take; raises on anything else."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"layer_norm_relu: kernel takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    if c not in _SUPPORTED:
        raise ValueError(f"layer_norm_relu: kernel takes C in {SUPPORTED_CHANNELS}, got {c}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_relu: kernel takes a contiguous (..., C) tensor")
    return c, code


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
            conv_bias: torch.Tensor | None = None) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, one C call; raises on what it
    does not take."""
    c, code = _check_x(x)
    index = x.get_device()
    gamma, beta, bias = _params(c, index, x.dtype, gamma, beta, conv_bias)
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    ptr = x.data_ptr()
    if ptr % 16:
        raise ValueError("layer_norm_relu: kernel takes a 16-byte aligned tensor")
    _build.check(_build.library().adunet_layer_norm_relu(
        ptr, gamma.data_ptr(), beta.data_ptr(), _ptr(bias), y.data_ptr(), rows, c, eps, code,
        index, _build.current_stream(index)), "layer_norm_relu")
    layer_norm_relu.launches += 1
    if bias is not None:
        layer_norm_relu.bias_launches += 1
    return y


_partials_per_device: dict[int, int] = {}


def _n_partials(lib, device: torch.device) -> int:
    """The (2, C) or (3, C) partials the backward kernel's scratch must hold on
    ``device`` (the most blocks its grid can have), asked of the library once
    per device. Call with ``device`` current."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _partials_per_device.get(index)
    if n is None:
        out = ctypes.c_int(0)
        _build.check(lib.adunet_layer_norm_relu_backward_partials(ctypes.addressof(out)),
                     "layer_norm_relu backward")
        n = _partials_per_device[index] = out.value
    return n


def _launch_backward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     g: torch.Tensor, eps: float, conv_bias: torch.Tensor | None = None):
    """The backward kernel on CUDA tensors: (dx, dgamma, dbeta[, dbias]) as
    ``layer_norm_relu_backward`` returns them, one C call; raises on what it
    does not take. The (2, C) sums and the kernel's per-block partials
    ((3, C) each with a conv bias) share one float32 allocation, and dgamma /
    dbeta of float32 parameters are views of its first rows; dbias comes in
    x's type, as the bias is passed (``ConvBlock``: cast to x's type)."""
    c, code = _check_x(x)
    index = x.get_device()
    if g.shape != x.shape or g.get_device() != index:
        raise ValueError("layer_norm_relu: the cotangent must match x's shape and device")
    if g.dtype is not x.dtype or not g.is_contiguous():
        g = g.to(x.dtype).contiguous()
    ga, be, bias = _params(c, index, x.dtype, gamma, beta, conv_bias)
    dx = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        zeros = (torch.zeros_like(gamma), torch.zeros_like(beta))
        return (dx, *zeros) if bias is None else (dx, *zeros, torch.zeros_like(conv_bias))
    xp, gp = x.data_ptr(), g.data_ptr()
    if xp % 16 or gp % 16:
        raise ValueError("layer_norm_relu: kernel takes 16-byte aligned tensors")
    lib = _build.library()
    n = _partials_per_device.get(index)
    if n is None:
        with torch.cuda.device(index):
            n = _n_partials(lib, x.device)
    ns = 2 if bias is None else 3  # partial sums: dgamma, dbeta(, dbias)
    sums = x.new_empty((2 + n * ns) * c, dtype=_F32)  # dgamma, dbeta, then the partials
    dbias = None if bias is None else torch.empty_like(bias)
    base = sums.data_ptr()
    _build.check(lib.adunet_layer_norm_relu_backward(
        xp, gp, ga.data_ptr(), be.data_ptr(), _ptr(bias), dx.data_ptr(), base, _ptr(dbias),
        base + 8 * c, rows, c, eps, code, index, _build.current_stream(index)),
        "layer_norm_relu backward")
    layer_norm_relu.backward_launches += 1
    dgamma, dbeta = sums.narrow(0, 0, c), sums.narrow(0, c, c)
    if gamma.dtype is not _F32:
        dgamma = dgamma.to(gamma.dtype)
    if beta.dtype is not _F32:
        dbeta = dbeta.to(beta.dtype)
    if bias is None:
        return dx, dgamma, dbeta
    layer_norm_relu.bias_backward_launches += 1
    return dx, dgamma, dbeta, dbias if conv_bias.dtype is x.dtype else dbias.to(conv_bias.dtype)


class _LayerNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, conv_bias):
        ctx.save_for_backward(x, gamma, beta, conv_bias)
        ctx.eps = eps
        return on_device("layer_norm_relu", x, _launch, layer_norm_relu_plain)(
            x, gamma, beta, eps, conv_bias)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, conv_bias = ctx.saved_tensors
        grads = on_device("layer_norm_relu", x, _launch_backward, layer_norm_relu_backward)(
            x, gamma, beta, g, ctx.eps, conv_bias)
        return *grads[:3], None, grads[3] if conv_bias is not None else None


def _op(x, gamma, beta, eps, conv_bias):
    if conv_bias is not None:
        raise ValueError("layer_norm_relu: a program's op takes no conv bias")
    return torch.ops.adunet_torch.layer_norm_relu(x, gamma, beta, eps)


def layer_norm_relu(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3,
    conv_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """LayerNorm over the last axis of (..., C), then ReLU, of x plus
    ``conv_bias`` where one is given (the bias a library conv left out of its
    output x, module docstring); differentiable in x, gamma, beta and the
    conv bias.

    Routed by ``kernels._route``. CUDA: float32 or bf16 ``x``, contiguous, C
    in ``SUPPORTED_CHANNELS``; anything else raises. The op
    ``adunet_torch::layer_norm_relu`` takes no conv bias: an exported block
    keeps the bias in its conv.
    ``layer_norm_relu.launches`` counts forward kernel launches,
    ``layer_norm_relu.backward_launches`` backward kernel launches, and
    ``.bias_launches`` / ``.bias_backward_launches`` those of them that took
    a conv bias."""
    return route("layer_norm_relu", (x, gamma, beta, eps, conv_bias), _LayerNormReLU, _launch,
                 layer_norm_relu_plain, _op)


layer_norm_relu.launches = 0
layer_norm_relu.backward_launches = 0
layer_norm_relu.bias_launches = 0
layer_norm_relu.bias_backward_launches = 0
