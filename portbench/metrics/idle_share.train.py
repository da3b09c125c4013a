"""Device idle share over a training cell's traced window, in %: 1 - the
union of the device's activity (kernels, copies, sets) / the window's wall
time. Layer: the device; moves ``train_img_per_s``."""

from portbench.lib import trace


def read(ctx):
    tr = ctx.get("trace")
    share = trace.idle_share(tr) if tr is not None else None
    return None if share is None else 100.0 * share
