"""A traced window: ``torch.profiler`` over a run's measured window, reduced
to plain lists of device intervals (kernels, copies, sets) and host
operations, and the arithmetic the per-layer readers share.

Times are nanoseconds on the profiler's clock, which is the host's wall
clock (``time.time_ns``); the window is the host's, from the call that
starts the work to the synchronise that ends it. Device user annotations
(ranges such as ``Optimizer.step`` that the profiler also puts on the
device's timeline) are not device activity and are dropped.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

Interval = Tuple[str, int, int]  # (name, start ns, end ns)


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def record(fn: Callable[[], object], device_sync: Callable[[], None]) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler (host and CUDA activity); the window
    ends once ``device_sync`` has returned."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.time_ns()
        result = fn()
        device_sync()
        end = time.time_ns()
    trace = Trace(start_ns=start, end_ns=end)
    for e in prof.profiler.kineto_results.events():
        s, t = int(e.start_ns()), int(e.end_ns())
        if t <= s:
            continue
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                trace.device.append((e.name(), s, t))
        else:
            trace.host.append((e.name(), s, t))
    return result, trace


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted, non-overlapping intervals."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def clip(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some device activity ran."""
    spans = union(clip([(s, e) for _, s, e in trace.device], trace.start_ns, trace.end_ns))
    return sum(e - s for s, e in spans) / 1e9


def idle_share(trace: Trace) -> float | None:
    """1 - busy / window; None where the device ran nothing."""
    if not trace.device or trace.end_ns <= trace.start_ns:
        return None
    return 1.0 - busy_s(trace) / trace.window_s


def device_seconds(trace: Trace, select: Callable[[str], bool]) -> float:
    """Device seconds of the activity whose name ``select`` takes (summed,
    overlaps counted twice, as a kernel's time is its own)."""
    return sum(e - s for name, s, e in trace.device if select(name)) / 1e9


def top_device_ops(trace: Trace, n: int = 10) -> List[list]:
    totals: Dict[str, float] = {}
    for name, s, e in trace.device:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e9
    return [[k[:200], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def top_idle_gaps(trace: Trace, n: int = 10) -> List[list]:
    """The longest gaps between device activity in the window, each named by
    the longest host operation that overlaps it (or "no host operation")."""
    spans = union(clip([(s, e) for _, s, e in trace.device], trace.start_ns, trace.end_ns))
    edges = [trace.start_ns] + [x for s, e in spans for x in (s, e)] + [trace.end_ns]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:n]
    host = sorted(trace.host, key=lambda h: h[1])
    out = []
    for s, e in gaps:
        best, best_len = "no host operation", 0
        for name, hs, he in host:
            if hs >= e:
                break
            overlap = min(he, e) - max(hs, s)
            if overlap > best_len:
                best, best_len = name, overlap
        out.append([best[:200], (e - s) / 1e9])
    return out
