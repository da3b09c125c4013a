"""Device milliseconds a training step spends in the banded resize kernel
(``adunet_torch/csrc/resize_band.cu``: the encoder's and decoder's resizes,
their gradients, and the degradation of the batch), over the traced window.
Layer: ops; moves ``train_img_per_s``.

The class: kernels whose name holds ``resize_band``. It reads nothing
(None) where the program has no such kernel, or its wrapper's launch counter
(``adunet_torch.kernels.resize_band.resize_band.launches``, read from the
module the program loaded; nothing is imported here) shows no launch."""

import sys

from portbench.lib import trace

NAME = "resize_band"


def launches() -> int:
    module = sys.modules.get("adunet_torch.kernels.resize_band")
    wrapper = getattr(module, "resize_band", None)
    return int(getattr(wrapper, "launches", 0) or 0)


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps", 0)
    if tr is None or steps <= 0 or launches() <= 0:
        return None
    seconds = trace.device_seconds(tr, lambda name: NAME in name)
    return seconds * 1e3 / steps if seconds > 0 else None
