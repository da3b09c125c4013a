"""The work a step or a forward needs, counted from the reference's layer
shapes, whatever the program computes it with; and the card's peaks.

Peaks of one NVIDIA H100 SXM (the data sheet's dense rates): 989 TFLOP/s
bf16, 67 TFLOP/s float32 outside the tensor cores (the port runs float32
with TF32 off), 3.35 TB/s of HBM.

- ``conv_flops``: 2 * N * Ho * Wo * Cin * Cout * k^2 for one conv's forward;
  its input gradient and its weight gradient cost as much again each. A
  training step counts the forward, the weight gradient of every conv and
  the input gradient of every conv but the first (the image takes none);
  a full remat's recomputed forwards are not counted. Resizes are not
  counted: a banded resize does far fewer operations for the same function.
- ``k1_bound_ms`` / ``k2_bound_ms``: the larger of bytes / HBM rate and
  operations / peak for one launch of the LayerNorm + ReLU kernel (K1) or
  the 64 -> 64 3x3 conv kernel (K2), forward or backward, each input read
  once and each output written once (the arithmetic of the kernels' own
  bounds in the port's smoke test, copied).
- ``resize_bound_ms``: the same for one pass of one resize by the banded
  kernel, forward or backward (which reads the cotangent and writes the
  input's gradient: the same bytes): x read once and y written once, beside
  the float32 operations of its two passes, the H pass (``K_h`` taps for
  each of ``oh * w`` outputs a channel) and the W pass (``K_w`` for each of
  ``oh * ow``), ``K`` the band width of the reference's sampling matrix
  (``reference/resize.py`` ``matrix``).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from portbench.reference.resize import matrix

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def conv_flops(layer: dict) -> float:
    """Forward operations of one conv layer (``reference.sr_unet.conv_layers``)."""
    return 2.0 * layer["n"] * layer["h"] * layer["w"] * layer["cin"] * layer["cout"] * layer["k"] ** 2


def forward_flops(convs: Iterable[dict]) -> float:
    return sum(conv_flops(c) for c in convs)


def train_flops(convs: Iterable[dict]) -> float:
    """Forward, weight gradient and input gradient (none for the first conv)."""
    total = 0.0
    for c in convs:
        f = conv_flops(c)
        total += f * (2.0 if c["first"] else 3.0)
    return total


def bound_ms(bytes_moved: float, flops: float, dtype: str) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3


def k1_bound_ms(rows: int, c: int, dtype: str, backward: bool = False) -> float:
    es = ELEMENT_BYTES[dtype]
    if backward:  # read x and the cotangent, write dx; gamma and beta in, their grads out
        return bound_ms(3 * rows * c * es + 4 * c * 4, 20 * rows * c, dtype)
    return bound_ms(2 * rows * c * es + 2 * c * 4, 9 * rows * c, dtype)


def k2_bound_ms(n: int, h: int, w: int, dtype: str, backward: bool = False) -> float:
    es = ELEMENT_BYTES[dtype]
    px = n * h * w
    if backward:  # read x and the cotangent, write dx; dx's taps and dw's
        return bound_ms(3 * px * 64 * es + 2 * 9 * 64 * 64 * 4 + 64 * 4,
                        2 * 9 * 64 * 64 * 2 * px + px * 64, dtype)
    return bound_ms(2 * px * 64 * es + 9 * 64 * 64 * 4 + 64 * 4, 2 * px * 64 * 64 * 9 + px * 64,
                    dtype)


def k2_layers(convs: Iterable[dict]) -> List[dict]:
    """The convs the K2 kernel is built for: 3x3, 64 -> 64, H a multiple of
    8 and at least 16, W a multiple of 128."""
    return [c for c in convs if c["k"] == 3 and c["cin"] == 64 and c["cout"] == 64
            and c["h"] % 8 == 0 and c["h"] >= 16 and c["w"] % 128 == 0]


def band_width(in_size: int, out_size: int, method: str, antialias: bool) -> int:
    """The fewest columns that hold every row's nonzeros of the resize's
    sampling matrix, each row's band starting at its first nonzero column
    or at any later row's, whichever is smaller (the bands start in order)."""
    nz = matrix(in_size, out_size, method, antialias) != 0
    has = nz.any(axis=1)
    first = np.where(has, nz.argmax(axis=1), in_size)
    last = np.where(has, in_size - 1 - nz[:, ::-1].argmax(axis=1), -1)
    start = np.minimum.accumulate(first[::-1])[::-1]
    return int((last - start + 1)[has].max()) if has.any() else 1


def resize_bound_ms(r: dict) -> float:
    """One pass of one resize (``resize_layers`` of a model module)."""
    kh = band_width(r["h"], r["oh"], r["method"], r["antialias"])
    kw = band_width(r["w"], r["ow"], r["method"], r["antialias"])
    moved = (r["n"] * r["h"] * r["w"] + r["n"] * r["oh"] * r["ow"]) * r["c"]
    return bound_ms(moved * ELEMENT_BYTES[r["dtype"]],
                    2.0 * r["n"] * r["c"] * (r["oh"] * r["w"] * kh + r["oh"] * r["ow"] * kw),
                    "float32")
