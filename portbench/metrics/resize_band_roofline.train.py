"""The banded resize kernel's share of its roofline in a training step, in
%: the bound of every launch a step makes (each resize of the model's
``resize_layers`` forward and backward, the degradation's two float32
resizes forward only; ``lib.work.resize_bound_ms``) over the device time of
the kernels named ``resize_band``, the traced window's. Layer: ops
(``kernels/resize_band.py``, ``csrc/resize_band.cu``); moves
``train_img_per_s``.

It reads nothing (None) where the resize launches a step (the fifth of
``ctx["launches"]``) differ from the launches the listed resizes make: the
work counted would not be the kernel's."""

from portbench.lib import trace, work

NAME = "resize_band"


def read(ctx):
    tr, steps, launches = ctx.get("trace"), ctx.get("steps", 0), ctx.get("launches")
    if tr is None or steps <= 0 or not launches:
        return None
    layers = ctx["resizes"]
    if launches[4] != sum(2 if r["grad"] else 1 for r in layers):
        return None
    bound = sum((2 if r["grad"] else 1) * work.resize_bound_ms(r) for r in layers)
    seconds = trace.device_seconds(tr, lambda name: NAME in name)
    return 100.0 * bound * steps / (seconds * 1e3) if seconds > 0 else None
