"""Device-idle time while the batcher collects a batch, in ms a forward: the
traced window's idle time that falls inside the program's ``batch.collect``
spans (waiting for a first request, then the batch window), over the
window's forwards: the card waiting on an empty queue. Layer: the HTTP front
end and batcher; moves ``serve_tiles_per_s``."""

from portbench.lib import spans as program_spans


def read(ctx):
    return program_spans.idle_ms_a_forward(ctx, "batch.collect")
