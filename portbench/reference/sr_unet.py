"""The adaptive-depth SR U-Net written out in plain PyTorch ops.

The architecture (KunalNN/Adaptive-Depth-U-Net-for-Image-Super-Resolution-
Segmentation, ``Super_resolution/code/train_adaptive_unet.py:217-287``):

- per encoder level a ConvBlock, then a bilinear antialiased resize by
  ``scale`` (sizes ceil(size * scale)); the channels double per level;
- a bottleneck ConvBlock;
- per decoder level a bilinear resize to the skip's size, a 3x3 conv + ReLU,
  the concatenation [h, skip] and a ConvBlock;
- a head ConvBlock, a 1x1 conv to RGB and ``clip(input + residual, 0, 1)``.

A ConvBlock is (3x3 SAME conv with bias -> LayerNorm over the channels, eps
1e-3 -> ReLU) twice. Parameters are float32 and named as the program names
them (``enc0.conv0.weight`` OIHW, ``enc0.norm0.weight``), so both sides can
be handed one set of tensors. ``dtype`` is the compute type: float32, or
bfloat16 for mixed precision, cast where the program casts (the conv's
inputs and parameters, each LayerNorm's output, each resize's output); the
LayerNorm statistics, the resizes, the residual add and the loss stay in
float32. ``quant`` (optional) rounds each conv's input and weight before
the conv: the lower-precision control.

Tensors here are NCHW; ``forward`` takes and returns NHWC as the program
does. ``conv_layers`` / ``norm_layers`` give every conv's and LayerNorm's
shapes for a batch: the shapes the benchmark counts work from.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.resize import resize_nchw, scaled

LN_EPS = 1e-3


def _blocks(cfg: dict):
    """(name, in_channels, out_channels, level) of every ConvBlock and
    (name, in, out, k, level) of every loose conv, in the model's order;
    level None is the bottleneck's or the head's (size index: depth or 0)."""
    depth, base, head = int(cfg["depth"]), int(cfg["base_channels"]), int(cfg["residual_head_channels"])
    blocks, convs = [], []
    nf, in_ch = base, 3
    for level in range(depth):
        blocks.append((f"enc{level}", in_ch, nf, level))
        in_ch, nf = nf, nf * 2
    blocks.append(("bottleneck", in_ch, nf, depth))
    for level in reversed(range(depth)):
        nf //= 2
        convs.append((f"dec{level}_smooth", 2 * nf, nf, 3, level))
        blocks.append((f"dec{level}", 2 * nf, nf, level))
    blocks.append(("head", base, head, 0))
    convs.append(("residual_rgb", head, 3, 1, 0))
    return blocks, convs


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's name and shape."""
    blocks, convs = _blocks(cfg)
    shapes: Dict[str, tuple] = {}
    for name, cin, cout, _ in blocks:
        for i, ci in enumerate((cin, cout)):
            shapes[f"{name}.conv{i}.weight"] = (cout, ci, 3, 3)
            shapes[f"{name}.conv{i}.bias"] = (cout,)
            shapes[f"{name}.norm{i}.weight"] = (cout,)
            shapes[f"{name}.norm{i}.bias"] = (cout,)
    for name, cin, cout, k, _ in convs:
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)
    return shapes


def sizes(cfg: dict, size: int) -> List[int]:
    """The spatial size of each level, input first (depth + 1 entries)."""
    out = [int(size)]
    for _ in range(int(cfg["depth"])):
        out.append(scaled(out[-1], float(cfg["scale"])))
    return out


def conv_layers(cfg: dict, batch: int, size: int) -> List[dict]:
    """Every conv of one forward: name, n, h, w, cin, cout, k, and whether
    it is ConvBlock ``block``'s (whose forward a full remat runs again) and
    ``first`` (its input is the image, which takes no gradient)."""
    blocks, convs = _blocks(cfg)
    hw = sizes(cfg, size)
    out = []
    for name, cin, cout, level in blocks:
        s = hw[level]
        for i, ci in enumerate((cin, cout)):
            out.append(dict(name=f"{name}.conv{i}", n=batch, h=s, w=s, cin=ci, cout=cout, k=3,
                            block=name, first=(name == "enc0" and i == 0)))
    for name, cin, cout, k, level in convs:
        s = hw[level]
        out.append(dict(name=name, n=batch, h=s, w=s, cin=cin, cout=cout, k=k, block=None,
                        first=False))
    return out


def norm_layers(cfg: dict, batch: int, size: int) -> List[dict]:
    """Every LayerNorm of one forward: name, rows (pixels), c, block."""
    blocks, _ = _blocks(cfg)
    hw = sizes(cfg, size)
    return [dict(name=f"{name}.norm{i}", rows=batch * hw[level] ** 2, c=cout, block=name)
            for name, _, cout, level in blocks for i in range(2)]


def _conv(x, w, b, dtype, quant):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x.to(dtype), w.to(dtype), b.to(dtype), padding=w.shape[-1] // 2)


def _norm_relu(x, gamma, beta, dtype):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    y = y * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)
    return torch.relu(y).to(dtype)


def _block(p, name, h, dtype, quant):
    for i in range(2):
        h = _conv(h, p[f"{name}.conv{i}.weight"], p[f"{name}.conv{i}.bias"], dtype, quant)
        h = _norm_relu(h, p[f"{name}.norm{i}.weight"], p[f"{name}.norm{i}.bias"], dtype)
    return h


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            dtype: torch.dtype = torch.float32,
            quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The restoration of NHWC float32 images ``x`` in [0, 1]: NHWC float32."""
    depth, scale = int(cfg["depth"]), float(cfg["scale"])
    inputs = x.permute(0, 3, 1, 2).to(torch.float32)
    h = inputs.to(dtype)
    skips = []
    for level in range(depth):
        skip = _block(p, f"enc{level}", h, dtype, quant)
        hh, ww = skip.shape[-2:]
        h = resize_nchw(skip, scaled(hh, scale), scaled(ww, scale)).to(dtype)
        skips.append(skip)
    h = _block(p, "bottleneck", h, dtype, quant)
    for level in reversed(range(depth)):
        skip = skips[level]
        h = resize_nchw(h, *skip.shape[-2:]).to(dtype)
        h = torch.relu(_conv(h, p[f"dec{level}_smooth.weight"], p[f"dec{level}_smooth.bias"],
                             dtype, quant))
        h = torch.cat([h, skip], dim=1)
        h = _block(p, f"dec{level}", h, dtype, quant)
    h = _block(p, "head", h, dtype, quant)
    residual = _conv(h, p["residual_rgb.weight"], p["residual_rgb.bias"], dtype, quant)
    out = inputs + residual.to(torch.float32)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    one = torch.ones((), dtype=out.dtype, device=out.device)
    return torch.minimum(torch.maximum(out, zero), one).permute(0, 2, 3, 1)


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448), returned in t's type; the gradient passes straight
    through (the conv saves the rounded values for its backward)."""
    amax = t.detach().abs().max().to(torch.float32).clamp(min=1e-12)
    s = 448.0 / amax
    q = (t.detach().to(torch.float32) * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return t + (q.to(t.dtype) - t).detach()
