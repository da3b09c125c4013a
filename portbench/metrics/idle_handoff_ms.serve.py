"""Device-idle time inside one phase of the batcher's dispatches, in ms a
forward: the traced window's idle time that falls inside the program's
``batch.handoff`` spans (the batcher handing each request its rows
(``set_result``)), over the window's forwards. A child of ``batch.dispatch``:
with its siblings it splits ``idle_dispatch_ms.serve``. Layer: the HTTP front
end and batcher; moves ``serve_tiles_per_s``."""

from portbench.lib import spans as program_spans


def read(ctx):
    return program_spans.idle_ms_a_forward(ctx, "batch.handoff")
