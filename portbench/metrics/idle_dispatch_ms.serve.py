"""Device-idle time inside the batcher's dispatches, in ms a forward: the
traced window's idle time (no kernel, copy or set running) that falls inside
the program's ``batch.dispatch`` spans (stacking the batch, the program's
copy in, launches and copy back, handing results back), over the window's
forwards. Layer: the served program; moves ``serve_tiles_per_s``."""

from portbench.lib import spans as program_spans


def read(ctx):
    return program_spans.idle_ms_a_forward(ctx, "batch.dispatch")
