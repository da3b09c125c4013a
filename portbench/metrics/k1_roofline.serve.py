"""K1's (the fused LayerNorm + ReLU kernel's) share of its roofline in the
served forward, in %: the bound of every launch a forward makes
(``lib.work.k1_bound_ms`` from the reference's LayerNorm shapes at the
program's static batch, float32) times the forwards in the traced window,
over the device time of K1's kernels there. Layer: kernels
(``kernels/fused_norm.py``, ``csrc/fused_norm.cu``); moves
``serve_tiles_per_s``.

It reads nothing (None) where the launches a forward differ from the
LayerNorms the shapes list."""

from portbench.lib import trace, work

NAMES = ("layer_norm_relu",)


def read(ctx):
    tr, forwards, launches = ctx.get("trace"), ctx.get("forwards", 0), ctx.get("launches")
    if tr is None or not forwards or not launches:
        return None
    norms, dtype = ctx["norms"], ctx["dtype"]
    if launches[0] != len(norms):
        return None
    bound = sum(work.k1_bound_ms(n["rows"], n["c"], dtype) for n in norms)
    seconds = trace.device_seconds(tr, lambda name: any(s in name for s in NAMES))
    return 100.0 * bound * forwards / (seconds * 1e3) if seconds > 0 else None
