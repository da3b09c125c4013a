"""K1's (the fused LayerNorm + ReLU kernel's) share of its roofline in a
training step, in %: the bound of every launch a step makes (forward, a
full remat's second forward, backward; ``lib.work.k1_bound_ms`` from the
reference's LayerNorm shapes) over the device time of K1's kernels, the
traced window's. Layer: kernels (``kernels/fused_norm.py``,
``csrc/fused_norm.cu``); moves ``train_img_per_s``.

It reads nothing (None) where the launches a step differ from the
LayerNorms the shapes list: the work counted would not be the kernel's."""

from portbench.lib import trace, work

NAMES = ("layer_norm_relu",)


def read(ctx):
    tr, steps, launches = ctx.get("trace"), ctx.get("steps", 0), ctx.get("launches")
    if tr is None or steps <= 0 or not launches:
        return None
    norms, dtype = ctx["norms"], ctx["dtype"]
    forwards = 2 if ctx.get("remat") else 1
    if (launches[0], launches[1]) != (forwards * len(norms), len(norms)):
        return None
    bound = sum(forwards * work.k1_bound_ms(n["rows"], n["c"], dtype)
                + work.k1_bound_ms(n["rows"], n["c"], dtype, backward=True) for n in norms)
    seconds = trace.device_seconds(tr, lambda name: any(s in name for s in NAMES))
    return 100.0 * bound * steps / (seconds * 1e3) if seconds > 0 else None
