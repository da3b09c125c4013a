"""The served program's share of the card's float32 peak (67 TFLOP/s, TF32
off), in %: the convolutions' forward operations of the tiles answered in
the traced window (from the reference's layer shapes; padding rows and the
resizes not counted), over its wall time. Layer: the served program
(``export/program.py``, ``models/``); moves ``serve_tiles_per_s``."""

from portbench.lib import work


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("tiles", 0) <= 0 or tr.window_s <= 0:
        return None
    flops = work.forward_flops(ctx["convs"]) * ctx["tiles"]
    return 100.0 * flops / tr.window_s / work.PEAK_FLOPS[ctx["dtype"]]
