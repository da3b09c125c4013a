"""Image-space ops: synthetic LR degradation, BT.601 luma, clipped residual.

Port of ``adunet/ops/image.py``:
- ``degrade``              ← :20 (cv2 INTER_AREA down, INTER_CUBIC a=-0.75 up)
- ``rgb_to_luma_bt601``    ← :50
- ``clipped_residual_add`` ← :63
"""

from __future__ import annotations

import torch

from adunet_torch.ops.resize import resize

__all__ = ["degrade", "rgb_to_luma_bt601", "clipped_residual_add"]

_LUMA = (65.481, 128.553, 24.966)


def degrade(hr: torch.Tensor, scale: float, output_size: int | None = None, space=None,
            height: int | None = None) -> torch.Tensor:
    """Shrink an HR (..., H, W, C) image to ``round(size*scale)`` with an area
    filter and bring it back with cv2's cubic. The size uses Python's
    round-half-to-even, as the reference does (:41-42), and the output is
    NOT clipped: cubic overshoot is kept. Returns float32. With ``space``
    (``adunet_torch.parallel.spatial``), hr holds that shard's rows of an
    image of ``height`` rows and both resizes are row-sharded."""
    if not 0 < scale < 1:
        raise ValueError("degrade scale: expected a value strictly inside (0, 1).")
    h, w = (hr.shape[-3] if space is None else height), hr.shape[-2]
    if output_size is not None and output_size > 0:
        target_h = target_w = int(output_size)
    else:
        target_h, target_w = h, w
    down_h = max(1, int(round(target_h * scale)))
    down_w = max(1, int(round(target_w * scale)))
    x = hr.to(torch.float32).clamp(0.0, 1.0)
    down = resize(x, (down_h, down_w), method="area", space=space, height=h)
    return resize(down, (target_h, target_w), method="bicubic_cv2", antialias=False,
                  space=space, height=down_h)


def rgb_to_luma_bt601(image: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] → BT.601 luma in [0,1], (..., H, W, 1), float32."""
    image = image.to(torch.float32)
    coeffs = torch.tensor(_LUMA, dtype=torch.float32, device=image.device)
    y = torch.sum(image * coeffs, dim=-1, keepdim=True) + 16.0
    return torch.clamp(y / 255.0, 0.0, 1.0)


def clipped_residual_add(inp: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """clip(input + residual, 0, 1) computed in float32, cast to input dtype.

    The clip is ``minimum(maximum(x, 0), 1)``, as ``jnp.clip`` computes it,
    so a value exactly at a bound passes half the gradient (both frameworks
    split a tie of ``maximum`` / ``minimum`` evenly). ``torch.clamp`` would
    pass all of it. An untrained model's output equals its input, so every
    pixel of the input at exactly 0 or 1 is such a tie in the first step."""
    out = inp.to(torch.float32) + residual.to(torch.float32)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    one = torch.ones((), dtype=out.dtype, device=out.device)
    return torch.minimum(torch.maximum(out, zero), one).to(inp.dtype)
