"""K2's (the 64 -> 64 3x3 conv kernel's) share of its roofline in a training
step, in %: the bound of every launch a step makes (forward, a full remat's
second forward, backward; ``lib.work.k2_bound_ms`` from the reference's
conv shapes that K2 is built for) over the device time of K2's kernels
(the weight pack, the conv, the weight-gradient and its sum), the traced
window's. Layer: kernels (``kernels/conv64.py``, ``csrc/conv64.cu``);
moves ``train_img_per_s``.

It reads nothing (None) where the launches a step differ from the convs
the shapes list: the work counted would not be the kernel's."""

from portbench.lib import trace, work

NAMES = ("conv3x3_c64", "pack_conv3x3_weights")


def read(ctx):
    tr, steps, launches = ctx.get("trace"), ctx.get("steps", 0), ctx.get("launches")
    if tr is None or steps <= 0 or not launches:
        return None
    layers, dtype = work.k2_layers(ctx["convs"]), ctx["dtype"]
    forwards = 2 if ctx.get("remat") else 1
    if (launches[2], launches[3]) != (forwards * len(layers), len(layers)):
        return None
    bound = sum(forwards * work.k2_bound_ms(c["n"], c["h"], c["w"], dtype)
                + work.k2_bound_ms(c["n"], c["h"], c["w"], dtype, backward=True) for c in layers)
    seconds = trace.device_seconds(tr, lambda name: any(s in name for s in NAMES))
    return 100.0 * bound * steps / (seconds * 1e3) if seconds > 0 else None
