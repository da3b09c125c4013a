"""HTTP model server over an SR or segmentation serving artifact: the port's
program (``model.pt2``), or, for a reference int8 artifact, the port's model
rebuilt from its weights (``adunet_torch.export.load_artifact``).

Port of ``adunet/cli/serve.py``: the same endpoints (``GET /v1/health``,
``GET /v1/metadata`` with the manifest and live serving stats,
``POST /v1/predict`` with ``.npy`` bodies in and out), the same cross-request
micro-batching into the artifact's static batch, the same zero padding of a
partial batch, and the same 400 / 413 / 503 behaviour. The model runs on
``--device`` (CUDA by default; without a GPU the server refuses to start
unless ``--device cpu`` is given). The batcher thread runs the model's
``call``, which enters ``torch.inference_mode()`` in that thread (the mode is
thread-local) and brings results back to numpy with ``.cpu().numpy()``.
A reply holds one array per request: (N, P, P, 3) restored tiles for an SR
artifact, (N, P, P, C) mask probabilities for a segmentation one.

The serving stats count requests, images, device calls, batched rows, the
admission refusals (``refused``; a refused body is read and discarded, so
the client reads the 503) and the 500s (``failed``). While ``torch.profiler``
runs, the handler and batcher threads record spans
(``adunet_torch.utils.spans``): per request ``serve.request`` with
``serve.read``, ``serve.decode``, ``serve.wait``, ``serve.encode`` and
``serve.write``, all carrying the request's id; per batch the ``_Batcher``'s.

A joint SR + segmentation artifact is refused at start: its call returns two
arrays, which the batcher's one row per request cannot carry. The reference
starts on one and then answers every request with a 500, since its batcher
indexes the call's dict as an array (``adunet/cli/serve.py:147-149``).

Run: ``python -m adunet_torch.cli.serve --artifact <dir> [--device cuda] --port 8500``
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from adunet_torch.utils import spans


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Serve an adunet SR or segmentation artifact "
                                                 "with the PyTorch port.")
    parser.add_argument("--artifact", type=str, required=True,
                        help="Artifact directory (manifest.json, the program model.pt2 "
                             "and weights.npz; a reference int8 artifact has no program).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device for the model (default cuda; 'cpu' to run on the CPU).")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="How long the batcher waits for more requests to fill "
                             "the artifact's static batch before dispatching.")
    parser.add_argument("--max-body-mb", type=float, default=64.0,
                        help="Reject request bodies larger than this (HTTP 413).")
    parser.add_argument("--max-concurrent-requests", type=int, default=16,
                        help="Predict requests admitted at once; beyond this the "
                             "server replies 503 immediately.")
    return parser.parse_args(argv)


# a queued image: (image, its future, when it was queued: spans.stamp(), 0
# while no profiler runs; the id of the request that queued it)
_Item = Tuple[np.ndarray, Future, int, Optional[int]]


class _Batcher:
    """Pools single-image requests into the artifact's static batch.

    With a profiler running it records, for each batch, ``batch.collect``
    (waiting for the first image until the batch closes, the window
    included) and ``batch.dispatch`` with its children ``batch.stack``, the
    call's own spans and ``batch.handoff``; and for each image
    ``batch.queued`` (queued to the dispatch's start), whose parent is its
    batch's ``batch.dispatch`` and whose ``rid`` is that of the request that
    queued it: the handler's open ``serve.request`` span at ``submit``."""

    def __init__(self, call, batch_size: int, window_ms: float):
        self._call = call
        self.batch_size = int(batch_size)
        self.window_s = float(window_ms) / 1000.0
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        # refused: admission's 503s; failed: the 500s
        self.stats = {"requests": 0, "images": 0, "device_calls": 0, "batched_rows": 0,
                      "refused": 0, "failed": 0}
        self._stats_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def bump(self, **deltas: int) -> None:
        with self._stats_lock:
            for k, d in deltas.items():
                self.stats[k] += d

    def snapshot_stats(self) -> Dict[str, int]:
        with self._stats_lock:
            return dict(self.stats)

    def submit(self, image: np.ndarray) -> Future:
        # (stop-check, enqueue) is atomic against close(): anything enqueued
        # is enqueued before stop, so close()'s drain sees it
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("server shutting down")
            fut: Future = Future()
            self._q.put((image, fut, spans.stamp(), spans.current_rid()))
            return fut

    def close(self) -> None:
        with self._submit_lock:
            self._stop.set()
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=5)
        while True:  # fail requests still queued: nobody else will
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("server shutting down"))

    def _collect(self) -> List[_Item]:
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.monotonic() + self.window_s
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self) -> None:
        while not self._stop.is_set():
            with spans.span("batch.collect"):
                items = self._collect()
            if items:
                self._dispatch(items)

    def _dispatch(self, items: List[_Item]) -> None:
        with spans.span("batch.dispatch") as span_id:
            start = spans.stamp()
            for _, _, queued, rid in items:
                if queued:
                    spans.add("batch.queued", queued, start, rid, parent=span_id)
            with spans.span("batch.stack"):
                batch = np.stack([item[0] for item in items])
                n = batch.shape[0]
                if n < self.batch_size:
                    pad = np.zeros((self.batch_size - n, *batch.shape[1:]), batch.dtype)
                    batch = np.concatenate([batch, pad])
            try:
                out = np.asarray(self._call(batch))
                self.bump(device_calls=1, batched_rows=n)
                with spans.span("batch.handoff"):
                    for i, item in enumerate(items):
                        item[1].set_result(out[i])
            except Exception as exc:  # device failure: surface to every caller
                for item in items:
                    if not item[1].done():
                        item[1].set_exception(exc)


def _decode_request(body: bytes, patch: int) -> np.ndarray:
    try:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as exc:
        raise ValueError(f"body is not a .npy array: {exc}") from exc
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[1:] != (patch, patch, 3) or arr.shape[0] == 0:
        raise ValueError(
            f"expected ({patch}, {patch}, 3) image(s); got array of shape {tuple(arr.shape)}."
        )
    return arr


def make_server(artifact_dir: str, host: str = "127.0.0.1", port: int = 0,
                batch_window_ms: float = 5.0,
                max_body_bytes: int = 64 * 1024 * 1024,
                max_concurrent_requests: int = 16,
                device: str = "cuda") -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server with the model on ``device``."""
    from adunet_torch.export import load_artifact

    call, manifest = load_artifact(artifact_dir, device=device)
    if manifest.get("model") == "joint_sr_seg_unet":
        raise ValueError(
            f"artifact at {artifact_dir!r} is a joint SR + segmentation model, whose call "
            "returns two arrays ('sr' and 'mask'); the server replies with one array per "
            "request, so it serves SR and segmentation artifacts only."
        )
    if "input_shape" not in manifest:
        raise ValueError(
            f"artifact at {artifact_dir!r} has no 'input_shape' in its manifest; the "
            "server needs the static batch and patch dimensions."
        )
    batch, patch = int(manifest["input_shape"][0]), int(manifest["input_shape"][1])
    batcher = _Batcher(call, batch, batch_window_ms)
    # admission control bounds the decoded bodies held in RAM at once:
    # ThreadingHTTPServer has no connection cap of its own
    admission = threading.Semaphore(max(1, int(max_concurrent_requests)))
    request_ids = itertools.count()  # next() is atomic: one id per admitted request

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: bytes, ctype: str, extra=()) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def _reply_json(self, code: int, obj: Dict[str, Any], extra=()) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json", extra)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/v1/health":
                self._reply_json(200, {"status": "ok"})
            elif self.path == "/v1/metadata":
                self._reply_json(200, {"manifest": manifest, "serving": batcher.snapshot_stats()})
            else:
                self._reply_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/predict":
                self._reply_json(404, {"error": f"unknown path {self.path}"})
                return
            if not admission.acquire(blocking=False):
                batcher.bump(refused=1)
                self._discard_body()
                self._reply_json(503, {
                    "error": f"server saturated ({max_concurrent_requests} "
                             "concurrent predict requests in flight); retry."
                }, extra=(("Retry-After", "1"),))
                return
            rid = next(request_ids)
            try:
                with spans.span("serve.request", rid):
                    self._do_predict(rid)
            finally:
                admission.release()

        def _discard_body(self) -> None:
            """Read a body this server will not use, so that the client reads
            the reply and not a connection reset by a close with its body
            unread; a body over the size limit is left unread."""
            try:
                left = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                return
            if left > max_body_bytes:
                return
            while left > 0:
                chunk = self.rfile.read(min(left, 1 << 16))
                if not chunk:
                    return
                left -= len(chunk)

        def _do_predict(self, rid: int):
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._reply_json(400, {"error": "invalid Content-Length header"})
                return
            if length <= 0:
                self._reply_json(400, {"error": "empty request body"})
                return
            if length > max_body_bytes:
                self._reply_json(413, {
                    "error": f"request body {length} bytes exceeds the "
                             f"{max_body_bytes}-byte limit (--max-body-mb)."
                })
                return
            with spans.span("serve.read", rid):
                body = self.rfile.read(length)
            try:
                with spans.span("serve.decode", rid):
                    images = _decode_request(body, patch)
            except ValueError as exc:
                self._reply_json(400, {"error": str(exc)})
                return
            batcher.bump(requests=1, images=images.shape[0])
            try:
                futures = [batcher.submit(img) for img in images]
            except RuntimeError as exc:  # submit raced a shutdown
                self._reply_json(503, {"error": str(exc)})
                return
            try:
                with spans.span("serve.wait", rid):
                    out = np.stack([f.result(timeout=120) for f in futures])
            except Exception as exc:  # device failure or shutdown: a real 500
                batcher.bump(failed=1)
                self._reply_json(500, {"error": f"inference failed: {exc}"})
                return
            with spans.span("serve.encode", rid):
                buf = io.BytesIO()
                np.save(buf, out)
            with spans.span("serve.write", rid):
                self._reply(200, buf.getvalue(), "application/octet-stream")

        def log_message(self, fmt, *args):  # quiet; stats live in /v1/metadata
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    server.manifest = manifest
    return server


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    server = make_server(args.artifact, args.host, args.port, args.batch_window_ms,
                         max_body_bytes=int(args.max_body_mb * 1024 * 1024),
                         max_concurrent_requests=args.max_concurrent_requests,
                         device=args.device)
    b, p = server.manifest["input_shape"][0], server.manifest["input_shape"][1]
    print(f"[serve] artifact batch {b} x {p}px on {args.device} — "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
