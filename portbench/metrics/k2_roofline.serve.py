"""K2's (the 64 -> 64 3x3 conv kernel's) share of its roofline in the served
forward, in %: the bound of every launch a forward makes
(``lib.work.k2_bound_ms`` from the reference's conv shapes that K2 is built
for, at the program's static batch, float32) times the forwards in the
traced window, over the device time of K2's kernels (weight pack and conv)
there. Layer: kernels (``kernels/conv64.py``, ``csrc/conv64.cu``); moves
``serve_tiles_per_s``.

It reads nothing (None) where the launches a forward differ from the convs
the shapes list."""

from portbench.lib import trace, work

NAMES = ("conv3x3_c64", "pack_conv3x3_weights")


def read(ctx):
    tr, forwards, launches = ctx.get("trace"), ctx.get("forwards", 0), ctx.get("launches")
    if tr is None or not forwards or not launches:
        return None
    layers, dtype = work.k2_layers(ctx["convs_batch"]), ctx["dtype"]
    if launches[2] != len(layers):
        return None
    bound = sum(work.k2_bound_ms(c["n"], c["h"], c["w"], dtype) for c in layers)
    seconds = trace.device_seconds(tr, lambda name: any(s in name for s in NAMES))
    return 100.0 * bound * forwards / (seconds * 1e3) if seconds > 0 else None
