"""How long a served tile waits in the batcher's queue, in ms: the 95th
percentile of the program's ``batch.queued`` spans (the request queues the
tile, to the start of the dispatch that carries it) that end in the traced
window. Layer: the HTTP front end and batcher; moves ``serve_p95_ms``."""

from portbench.lib import spans as program_spans
from portbench.lib import stats


def read(ctx):
    spans = program_spans.taken(ctx)
    if not spans:
        return None
    tr = ctx["trace"]
    waits = [(s.end_ns - s.start_ns) / 1e6
             for s in program_spans.ending_in(spans, "batch.queued", tr.start_ns, tr.end_ns)]
    return stats.percentile(waits, 95.0) if waits else None
