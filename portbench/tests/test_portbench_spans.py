"""The readers of the program's spans (``lib/spans.py`` and the ``*.serve``
readers that use it) on synthetic spans and device intervals: idle time
inside and outside spans and inside each child of a dispatch, a request's
self time and its steps' medians, the queue wait's 95th percentile; nothing
without a trace, without device activity, or from a program that records no
spans."""

from __future__ import annotations

from collections import namedtuple

import pytest

from portbench import catalog
from portbench.lib import spans as program_spans
from portbench.lib import trace

S = namedtuple("S", "name start_ns end_ns id parent rid thread")
DISPATCH_CHILDREN = {"idle_stack_ms.serve": "batch.stack",
                     "idle_copy_in_ms.serve": "program.copy_in",
                     "idle_forward_ms.serve": "program.forward",
                     "idle_copy_out_ms.serve": "program.copy_out",
                     "idle_handoff_ms.serve": "batch.handoff"}
FRONT_END_STEPS = {"read_ms.serve": "serve.read", "decode_ms.serve": "serve.decode",
                   "encode_ms.serve": "serve.encode", "write_ms.serve": "serve.write"}
READERS = ("queue_wait_ms.serve", "front_end_ms.serve", "idle_dispatch_ms.serve",
           "idle_collect_ms.serve", *DISPATCH_CHILDREN, *FRONT_END_STEPS)


def _ctx(spans, device=(("k", 20, 60), ("k", 120, 150)), forwards=2):
    ctx = {"trace": trace.Trace(device=list(device), start_ns=0, end_ns=200),
           "forwards": forwards}
    ctx["spans"] = list(spans)  # as taken from the program, once a run
    return ctx


def _read(name, ctx):
    return catalog.metric_reader(name)(ctx)


def test_overlap_and_idle_inside_spans():
    assert program_spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert program_spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    tr = trace.Trace(device=[("k", 20, 60), ("k", 120, 150)], start_ns=0, end_ns=200)
    # the window idles on [0, 20), [60, 120), [150, 200)
    assert program_spans.idle_inside_ns(tr, [(0, 100)]) == 20 + 40
    assert program_spans.idle_inside_ns(tr, [(0, 100), (50, 130)]) == 20 + 60
    assert program_spans.idle_inside_ns(tr, [(180, 260)]) == 20  # clipped to the window
    assert program_spans.idle_inside_ns(tr, [(25, 55)]) == 0


def test_idle_readers_split_the_window_by_span():
    spans = [S("batch.collect", 0, 30, 1, 0, 0, 9), S("batch.dispatch", 30, 130, 2, 0, 0, 9),
             S("batch.collect", 130, 140, 3, 0, 1, 9), S("batch.dispatch", 140, 200, 4, 0, 1, 9)]
    ctx = _ctx(spans)
    # collect: 20 idle in [0, 30), none in [130, 140); dispatch: 60 in [30, 130), 50 in [140, 200)
    assert _read("idle_collect_ms.serve", ctx) == pytest.approx(20 / 1e6 / 2)
    assert _read("idle_dispatch_ms.serve", ctx) == pytest.approx(110 / 1e6 / 2)
    assert _read("idle_dispatch_ms.serve", dict(ctx, forwards=0)) is None
    assert _read("idle_collect_ms.serve", _ctx(spans[1::2])) is None  # no collect span


def test_front_end_self_time_and_queue_wait():
    spans = [S("serve.request", 0, 100, 1, 0, 0, 5), S("serve.wait", 10, 90, 2, 1, 0, 5),
             S("serve.request", 20, 60, 3, 0, 1, 6), S("serve.wait", 25, 30, 4, 3, 1, 6),
             S("serve.request", 30, 95, 5, 0, 2, 7), S("serve.read", 30, 40, 6, 5, 2, 7),
             S("serve.request", 150, 260, 7, 0, 3, 8), S("serve.wait", 160, 250, 8, 7, 3, 8)]
    spans += [S("batch.queued", 0, k, 10 + k, 0, k, 9) for k in range(1, 21)]
    spans.append(S("batch.queued", 190, 250, 40, 0, 21, 9))  # ends after the window
    ctx = _ctx(spans, device=[("k", 0, 10)])
    # self times 100 - 80, 40 - 5 and 65 (no wait): median 35 ns; the last
    # request ends after the window
    assert _read("front_end_ms.serve", ctx) == pytest.approx(35e-6)
    # waits 1..20 ns end in the window: p95 at rank 19 * 0.95 = 18.05
    assert _read("queue_wait_ms.serve", ctx) == pytest.approx(19.05e-6)


def test_dispatch_children_split_its_idle_time():
    # one dispatch over [30, 200): stack [30, 70), copy in [70, 80), forward
    # [80, 125), copy out [125, 190), hand-off [190, 200); the device runs
    # [20, 60), [120, 150)
    kids = [("batch.stack", 30, 70), ("program.copy_in", 70, 80),
            ("program.forward", 80, 125), ("program.copy_out", 125, 190),
            ("batch.handoff", 190, 200)]
    spans = [S("batch.dispatch", 30, 200, 1, 0, None, 9)]
    spans += [S(name, a, b, 2 + k, 1, None, 9) for k, (name, a, b) in enumerate(kids)]
    ctx = _ctx(spans)
    idle = {"batch.stack": 10, "program.copy_in": 10, "program.forward": 40,
            "program.copy_out": 40, "batch.handoff": 10}
    got = {DISPATCH_CHILDREN[n]: _read(n, ctx) for n in DISPATCH_CHILDREN}
    assert got == pytest.approx({k: v / 1e6 / 2 for k, v in idle.items()})
    assert sum(got.values()) == pytest.approx(_read("idle_dispatch_ms.serve", ctx))
    assert _read("idle_stack_ms.serve", _ctx(spans[:1])) is None  # no such child


def test_front_end_steps_are_medians_of_their_spans():
    spans = [S("serve.decode", 0, 3, 1, 0, 0, 5), S("serve.decode", 10, 17, 2, 0, 1, 6),
             S("serve.decode", 20, 24, 3, 0, 2, 7), S("serve.decode", 190, 230, 4, 0, 3, 8),
             S("serve.write", 40, 41, 5, 0, 0, 5)]
    ctx = _ctx(spans)
    assert _read("decode_ms.serve", ctx) == pytest.approx(4e-6)  # the last ends after
    assert _read("write_ms.serve", ctx) == pytest.approx(1e-6)
    assert _read("read_ms.serve", ctx) is None and _read("encode_ms.serve", ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_trace_device_activity_or_spans(name, monkeypatch):
    spans = [S("batch.dispatch", 0, 50, 1, 0, None, 1), S("batch.collect", 50, 60, 2, 0, None, 1),
             S("batch.queued", 0, 10, 3, 1, 0, 2), S("serve.request", 0, 90, 4, 0, 0, 2)]
    spans += [S(child, 5, 15, 10 + k, 1, None, 1)
              for k, child in enumerate(DISPATCH_CHILDREN.values())]
    spans += [S(step, 20, 25, 20 + k, 4, 0, 2) for k, step in enumerate(FRONT_END_STEPS.values())]
    assert _read(name, _ctx(spans)) is not None
    assert _read(name, {"forwards": 2}) is None
    assert _read(name, _ctx(spans, device=())) is None
    assert _read(name, _ctx([])) is None
    # a program without the recorder (the parent of the change that adds it)
    monkeypatch.setattr(program_spans, "_take", lambda lo, hi: [])
    ctx = _ctx(spans)
    del ctx["spans"]
    assert _read(name, ctx) is None


def test_spans_are_taken_once_a_run(monkeypatch):
    calls = []
    monkeypatch.setattr(program_spans, "_take",
                        lambda lo, hi: calls.append((lo, hi))
                        or [S("batch.queued", 0, 9, 1, 0, 0, 1)])
    ctx = {"trace": trace.Trace(device=[("k", 0, 10)], start_ns=0, end_ns=100), "forwards": 1}
    for name in READERS:
        _read(name, ctx)
    assert calls == [(0, 100)] and len(ctx["spans"]) == 1
    assert _read("queue_wait_ms.serve", ctx) == pytest.approx(9e-6)


def test_taking_logs_the_count_and_the_rings_drops(capsys):
    from adunet_torch.utils import spans as recorder

    recorder.take(0, 2**63)
    ctx = {"trace": trace.Trace(device=[("k", 0, 10)], start_ns=0, end_ns=100), "forwards": 1}
    assert program_spans.taken(ctx) == []
    assert "0 program spans over the traced window; 0 dropped" in capsys.readouterr().err
