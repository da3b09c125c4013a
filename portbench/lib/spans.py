"""The program's own spans over a traced window, laid over the device's
timeline: taken from the program (``adunet_torch.utils.spans``, through
``portbench/program.py``) once a run, and the arithmetic the readers
of the serving cells share.

The program records spans only while the profiler runs, stamped with
``time.time_ns()``, the profiler's clock (``lib/trace.py``); the server
runs in the benchmark's process, so its spans are in this process's
recorder. Taking them empties the recorder, so every reader goes through
``taken``, which keeps them in the run's context. A program without the
recorder yields no spans, and the readers then report nothing.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

from portbench.lib import stats
from portbench.lib import trace as tracing


def _take(lo_ns: int, hi_ns: int) -> list:
    from portbench import program

    got = program.take_spans(lo_ns, hi_ns)
    if got is None:  # a program without the recorder
        return []
    out, dropped = got
    # in the run's log: a ring that overflowed lost the window's first spans
    print(f"[spans] {len(out)} program spans over the traced window; "
          f"{dropped} dropped by the recorder's ring", file=sys.stderr, flush=True)
    return out


def taken(ctx: dict) -> Optional[list]:
    """The program's spans that overlap the traced window, taken once a run
    (``ctx["spans"]``); None without a trace or without device activity."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    if "spans" not in ctx:
        ctx["spans"] = _take(tr.start_ns, tr.end_ns)
    return ctx["spans"] if tr.device else None


def ending_in(spans: Sequence, name: str, lo_ns: int, hi_ns: int) -> list:
    """The spans called ``name`` that end inside ``[lo_ns, hi_ns]``."""
    return [s for s in spans if s.name == name and lo_ns <= s.end_ns <= hi_ns]


def overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Nanoseconds covered by both of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_ns(trace: tracing.Trace, intervals: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds of the window inside ``intervals`` in which the device ran
    nothing (idle as ``lib/trace.idle_share`` counts it)."""
    lo, hi = trace.start_ns, trace.end_ns
    inside = tracing.union(tracing.clip(list(intervals), lo, hi))
    busy = tracing.union(tracing.clip([(s, e) for _, s, e in trace.device], lo, hi))
    return sum(e - s for s, e in inside) - overlap_ns(inside, busy)


def idle_ms_a_forward(ctx: dict, name: str) -> Optional[float]:
    """Device-idle ms inside the spans called ``name``, over the window's
    forwards; None without such spans or forwards."""
    spans, forwards = taken(ctx), ctx.get("forwards") or 0
    if not spans or forwards <= 0:
        return None
    intervals = [(s.start_ns, s.end_ns) for s in spans if s.name == name]
    if not intervals:
        return None
    return idle_inside_ns(ctx["trace"], intervals) / 1e6 / forwards


def median_ms(ctx: dict, name: str) -> Optional[float]:
    """The median duration, in ms, of the spans called ``name`` that end in
    the traced window; None without such spans."""
    spans = taken(ctx)
    if not spans:
        return None
    tr = ctx["trace"]
    took = [(s.end_ns - s.start_ns) / 1e6 for s in ending_in(spans, name, tr.start_ns, tr.end_ns)]
    return stats.percentile(took, 50.0) if took else None
