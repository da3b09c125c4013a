"""Weight-only int8 quantization of the conv kernels, as the serving
artifact defines it: per output channel, scale = max |w| / 127 (at least
1e-12), q = clip(round(w / scale), -127, 127) with halves rounded to even,
and the served kernel q * scale in float32. Other parameters stay float32."""

from __future__ import annotations

from typing import Dict

import torch


def dequantized(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for name, w in params.items():
        if w.dim() != 4:
            out[name] = w
            continue
        w = w.to(torch.float32)
        scale = torch.clamp(w.abs().amax(dim=(1, 2, 3)) / 127.0, min=1e-12).view(-1, 1, 1, 1)
        q = torch.clamp(torch.round(w / scale), -127, 127)
        out[name] = q * scale
    return out
