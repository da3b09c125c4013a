"""The port's span recorder (``adunet_torch.utils.spans``) and the spans the
server records, on the CPU.

- Nothing is recorded while no profiler runs; the recorder reads the
  profiler's process-wide Python flag, which threads the profiler did not
  start see too (pinned here: it is a private name).
- Under ``torch.profiler`` a span falls inside a ``record_function`` range
  wrapped around it: spans and the profiler's events share one clock.
- Spans nest per thread, ``add`` records across threads, and the ring drops
  its oldest records and counts them; a profiled run's spans, untaken, are
  cleared once recording turns on again.
- A served request under the profiler yields ``serve.request`` and its
  children, and a ``batch.queued`` whose parent is the ``batch.dispatch``
  that holds the program's spans; the server counts its refusals and reads
  a refused body, so the client reads the 503.
"""

import http.client
import io
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from adunet_torch.utils import spans

torch.set_num_threads(2)

PATCH, BATCH = 32, 4


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.fixture(autouse=True)
def empty_recorder():
    spans.take(0, 2**63)
    yield
    spans.take(0, 2**63)


def test_profiler_flag_is_process_wide():
    assert autograd_profiler._is_profiler_enabled is False
    seen = []
    with _profiled():
        assert autograd_profiler._is_profiler_enabled is True
        _thread(lambda: seen.append((spans.enabled(),
                                     torch._C._autograd._profiler_enabled())))
    assert seen == [(True, False)]  # the C++ check is the starting thread's alone
    assert spans.enabled() is False


def test_nothing_recorded_without_the_profiler():
    with spans.span("a", 1) as sid:
        with spans.span("b"):
            pass
    spans.add("c", 1, 2)
    assert sid == 0 and spans.stamp() == 0
    assert spans.take(0, 2**63) == []


def test_span_shares_the_profilers_clock():
    with _profiled() as prof:
        with record_function("outer"):
            with spans.span("inner", 7) as sid:
                sum(range(1000))
    (rec,) = spans.take(0, 2**63)
    assert (rec.name, rec.id, rec.rid, rec.parent) == ("inner", sid, 7, 0) and sid > 0
    (outer,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    assert outer.start_ns() <= rec.start_ns < rec.end_ns <= outer.end_ns()


def test_threads_started_under_the_profiler_record_and_nest_on_their_own():
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span(f"{tag}.outer", tag):
            barrier.wait()  # both outers open at once
            with spans.span(f"{tag}.inner", tag):
                barrier.wait()

    with _profiled():
        threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    got = {s.name: s for s in spans.take(0, 2**63)}
    assert set(got) == {"1.outer", "1.inner", "2.outer", "2.inner"}
    for k in (1, 2):
        outer, inner = got[f"{k}.outer"], got[f"{k}.inner"]
        assert outer.parent == 0 and inner.parent == outer.id
        assert inner.thread == outer.thread and inner.rid == k
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert got["1.outer"].thread != got["2.outer"].thread


def test_add_records_a_span_begun_on_another_thread():
    begun = []
    with _profiled():
        with spans.span("req", 3):
            assert spans.current_rid() == 3
            _thread(lambda: begun.append((spans.stamp(), spans.current_rid())))
            with spans.span("dispatch") as sid:
                spans.add("queued", begun[0][0], spans.stamp(), rid=3, parent=sid)
                spans.add("child", begun[0][0], spans.stamp())
    assert begun[0][0] > 0 and begun[0][1] is None  # the other thread had nothing open
    got = {s.name: s for s in spans.take(0, 2**63)}
    assert got["queued"].parent == got["dispatch"].id and got["queued"].rid == 3
    assert got["child"].parent == got["dispatch"].id
    assert got["queued"].start_ns == begun[0][0] <= got["queued"].end_ns


def test_ring_drops_the_oldest_and_counts_them():
    ring = spans.Recorder(3)
    for k in range(5):
        ring.push(spans.Span(f"s{k}", 10 * k, 10 * k + 5, ring.new_id(), 0, None, 0))
    assert ring.dropped == 2
    assert [s.name for s in ring.take(0, 100)] == ["s2", "s3", "s4"]
    assert ring.take(0, 100) == []
    for k in range(3):
        ring.push(spans.Span(f"t{k}", 10 * k, 10 * k + 5, ring.new_id(), 0, None, 0))
    assert [s.name for s in ring.take(12, 21)] == ["t1", "t2"]  # those overlapping the window


def test_recording_turning_on_again_clears_the_last_runs_spans():
    with _profiled():
        with spans.span("first"):
            pass
    with spans.span("off"):  # a server's spans go on being opened, and see it off
        pass
    spans.RECORDER.dropped = 5
    with _profiled():
        with spans.span("second"):
            pass
    assert spans.RECORDER.dropped == 0
    assert [s.name for s in spans.take(0, 2**63)] == ["second"]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    from adunet_torch.export import save_artifact
    from adunet_torch.models import build_super_resolution_unet

    torch.manual_seed(0)
    model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                           depth_override=1, input_size=PATCH, device="cpu")
    return save_artifact(model, tmp_path_factory.mktemp("spans") / "artifact",
                         image_size=PATCH, batch_size=BATCH)


def _serving(artifact, **kw):
    from adunet_torch.cli.serve import make_server

    server = make_server(str(artifact), port=0, device="cpu", **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.batcher.close()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(port, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/predict", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_served_requests_record_their_spans(artifact):
    server, thread = _serving(artifact, batch_window_ms=300.0)
    port, statuses = server.server_address[1], []
    rng = np.random.default_rng(0)
    bodies = [_npy(rng.random((PATCH, PATCH, 3), dtype=np.float32)) for _ in range(3)]
    try:
        with _profiled():
            posts = [threading.Thread(target=lambda b=b: statuses.append(_post(port, b)[0]))
                     for b in bodies]
            for t in posts:
                t.start()
            for t in posts:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        _stop(server, thread)
    assert statuses == [200, 200, 200]
    got = spans.take(0, 2**63)
    by_id = {s.id: s for s in got}
    requests = [s for s in got if s.name == "serve.request"]
    assert sorted(s.rid for s in requests) == [0, 1, 2]
    for req in requests:
        kids = [s for s in got if s.parent == req.id]
        assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == [
            "serve.read", "serve.decode", "serve.wait", "serve.encode", "serve.write"]
        assert all(k.rid == req.rid and req.start_ns <= k.start_ns <= k.end_ns <= req.end_ns
                   for k in kids)
    queued = [s for s in got if s.name == "batch.queued"]
    assert sorted(s.rid for s in queued) == [0, 1, 2]
    for q in queued:
        dispatch = by_id[q.parent]
        assert dispatch.name == "batch.dispatch" and q.end_ns <= dispatch.end_ns
        kids = sorted((s for s in got if s.parent == dispatch.id and s.name != "batch.queued"),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["batch.stack", "program.copy_in", "program.forward",
                                          "program.copy_out", "batch.handoff"]
        assert dispatch.rid is None and all(k.rid is None for k in kids)  # a batch's spans
    # the first batch's collect began before the profiler, and is not recorded
    batcher = by_id[queued[0].parent].thread
    collects = [s for s in got if s.name == "batch.collect"]
    assert collects and all(s.thread == batcher and s.parent == 0 for s in collects)


def test_refusal_reads_the_body_and_is_counted(artifact):
    server, thread = _serving(artifact, batch_window_ms=1500.0, max_concurrent_requests=1)
    port, first = server.server_address[1], []
    try:
        held = threading.Thread(target=lambda: first.append(
            _post(port, _npy(np.zeros((PATCH, PATCH, 3), np.float32)))[0]))
        held.start()  # admitted, then waits for its batch's window to close
        for _ in range(200):
            if server.batcher.snapshot_stats()["requests"]:
                break
            threading.Event().wait(0.01)
        # a body far larger than the socket buffers: unread, the client's
        # send meets a reset instead of the reply
        status, payload = _post(port, b"\0" * (8 << 20))
        held.join(timeout=60)
        assert not held.is_alive()
        stats = server.batcher.snapshot_stats()
    finally:
        _stop(server, thread)
    assert status == 503 and b"saturated" in payload and first == [200]
    assert stats["refused"] == 1 and stats["failed"] == 0 and stats["requests"] == 1
