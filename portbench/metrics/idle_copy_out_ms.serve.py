"""Device-idle time inside one phase of the batcher's dispatches, in ms a
forward: the traced window's idle time that falls inside the program's
``program.copy_out`` spans (the program's copy back to numpy, which waits for
the forward's kernels), over the window's forwards. A child of
``batch.dispatch``: with its siblings it splits ``idle_dispatch_ms.serve``.
Layer: the served program; moves ``serve_tiles_per_s``."""

from portbench.lib import spans as program_spans


def read(ctx):
    return program_spans.idle_ms_a_forward(ctx, "program.copy_out")
