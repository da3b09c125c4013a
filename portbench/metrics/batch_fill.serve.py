"""How full the served program's batches ran, in %: the batcher's rows over
its device calls times the program's static batch, over the traced window
(``cli/serve.py``'s ``snapshot_stats``). Layer: the HTTP front end and
batcher; moves ``serve_p95_ms``."""


def read(ctx):
    calls = ctx.get("forwards") or 0
    if calls <= 0:
        return None
    return 100.0 * ctx["rows"] / (calls * ctx["program_batch"])
