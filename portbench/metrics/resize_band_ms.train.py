"""Device milliseconds a training step spends in the banded resize kernel
(``adunet_torch/csrc/resize_band.cu``: the encoder's and decoder's resizes,
their gradients, and the degradation of the batch), over the traced window.
Layer: ops; moves ``train_img_per_s``.

The class: kernels whose name holds ``resize_band``. It reads nothing
(None) where the program has no such kernel, or its launch counter (the
fifth of ``ctx["launches"]``, ``portbench/program.py``) shows no launch in
the window."""

from portbench.lib import trace

NAME = "resize_band"


def read(ctx):
    tr, steps, launches = ctx.get("trace"), ctx.get("steps", 0), ctx.get("launches")
    if tr is None or steps <= 0 or not launches or launches[4] <= 0:
        return None
    seconds = trace.device_seconds(tr, lambda name: NAME in name)
    return seconds * 1e3 / steps if seconds > 0 else None
