"""The HTTP front end's own time for a request, in ms: the median, over the
program's ``serve.request`` spans that end in the traced window (admitted to
reply written), of the span's duration less its ``serve.wait`` child (the
wait on the batcher): reading, decoding, encoding and writing. Layer: the
HTTP front end and batcher; moves ``serve_p95_ms``."""

from portbench.lib import spans as program_spans
from portbench.lib import stats


def read(ctx):
    spans = program_spans.taken(ctx)
    if not spans:
        return None
    tr = ctx["trace"]
    requests = program_spans.ending_in(spans, "serve.request", tr.start_ns, tr.end_ns)
    waited = {}
    for s in spans:
        if s.name == "serve.wait":
            waited[s.parent] = waited.get(s.parent, 0) + s.end_ns - s.start_ns
    own = [(s.end_ns - s.start_ns - waited.get(s.id, 0)) / 1e6 for s in requests]
    return stats.percentile(own, 50.0) if own else None
