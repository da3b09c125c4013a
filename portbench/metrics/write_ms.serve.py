"""One step of the HTTP front end's own time for a request, in ms: the median
duration of the program's ``serve.write`` spans (writing the reply to the
socket) that end in the traced window. A child of ``serve.request``: it shows
which step of ``front_end_ms.serve`` moved. Layer: the HTTP front end and
batcher; moves ``serve_p95_ms``."""

from portbench.lib import spans as program_spans


def read(ctx):
    return program_spans.median_ms(ctx, "serve.write")
