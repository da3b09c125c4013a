"""The training step's share of the card's bf16 peak (989 TFLOP/s), in %:
the convolutions' operations a step (forward, weight and input gradients,
from the reference's layer shapes; a remat's recompute and the resizes not
counted) times the steps in the traced window, over its wall time. Layer:
the steps and the compiled step (``train/sr.py``, ``train/compiled.py``);
moves ``train_img_per_s``."""

from portbench.lib import work


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("steps", 0) <= 0 or tr.window_s <= 0:
        return None
    flops = work.train_flops(ctx["convs"]) * ctx["steps"]
    return 100.0 * flops / tr.window_s / work.PEAK_FLOPS[ctx["dtype"]]
