"""The serving load generator, run as its own process (so that its threads
do not share the server's interpreter lock) with numpy and the standard
library only.

It reads one JSON job from standard input: the server's port, the tiles' size, the
traffic mix, the seed and the window's length. It builds its pool of tiles
(``lib.tiles``), warms the server up with a few requests a client, prints
``READY`` and waits for ``GO`` on standard input; then it runs the window:

- ``loop: "closed"``: ``clients`` threads, each sending its next request
  when the last one is answered, until the window's end;
- ``loop: "open"``: ``round(rate_per_s * seconds)`` requests at uniformly
  drawn times in the window, sorted (a Poisson process given its count); a
  dispatcher hands each request to a pool of sender threads at its due
  time, whatever is still in flight.

Each request POSTs one tile of the pool as a uint8 ``.npy`` body. A request
is timed from when it was due (closed loop: when it was sent) to when its
reply was read; a reply that is not a 200 with an array of the expected
size counts as failed. A connection that the server closed with no reply
is recorded with the status ``check.RESET``: the server's admission control
refuses a request before it reads the body, and closing a socket with the
body unread resets it, so a refusal can reach the client as a reset. At the window's end it prints
``END``, waits for what is still in flight, and prints ``RESULT <json
bytes> <npz bytes>`` followed by the records (JSON) and the replies it kept
(npz): the requests whose id a rule drawn from the seed picks, at most
``check_max``.
"""

from __future__ import annotations

import http.client
import io
import json
import queue
import sys
import threading
import time

import numpy as np

from portbench.check import RESET
from portbench.lib.tiles import pool as tile_pool


def _post(port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/predict", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Load:
    def __init__(self, job: dict):
        self.port = int(job["port"])
        self.traffic = job["traffic"]
        self.seed = int(job["seed"])
        self.seconds = float(job["seconds"])
        t = self.traffic
        self.patch = int(job["patch"])
        self.tiles = tile_pool(self.seed, int(t["pool_tiles"]), self.patch)
        self.rng = np.random.default_rng([self.seed % 2**64, 11])
        self.salt = int(self.rng.integers(0, 2**31))
        self.every = int(t["check_every"])
        self.check_max = int(t["check_max"])
        self.lock = threading.Lock()
        self.records: list = []
        self.kept: dict = {}
        self.next_id = 0

    def body(self, tile: int) -> bytes:
        buf = io.BytesIO()
        np.save(buf, self.tiles[tile])
        return buf.getvalue()

    def keeps(self, rid: int) -> bool:
        return ((rid * 2654435761 + self.salt) & 0xFFFFFFFF) % self.every == 0

    def send(self, rid: int, tile: int, due: float, t0: float, count: bool = True) -> None:
        body = self.body(tile)
        start = time.perf_counter()
        status, data, ok = 0, b"", False
        try:
            status, data = _post(self.port, body, timeout=120.0)
            expect = 4 * self.patch * self.patch * 3
            ok = status == 200 and len(data) >= expect and len(data) <= expect + 256
        except ConnectionError:  # closed by the server with no reply (incl. RemoteDisconnected)
            status = RESET
        except Exception:  # noqa: BLE001  no reply at all (a timeout): a failed request
            pass
        end = time.perf_counter()
        if not count:
            return
        with self.lock:
            self.records.append([rid, tile, due - t0, start - t0, end - t0, status, ok])
            if ok and self.keeps(rid) and len(self.kept) < self.check_max:
                self.kept[rid] = (tile, np.load(io.BytesIO(data)))

    def warm(self) -> None:
        n = int(self.traffic.get("warm_requests_per_client", 2))
        workers = int(self.traffic.get("clients", 16))
        threads = [threading.Thread(target=lambda w=w: [self.send(-1, w + i, 0, 0, count=False)
                                                        for i in range(n)])
                   for w in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    def closed(self, t0: float) -> None:
        end_at = t0 + self.seconds

        def worker(w: int) -> None:
            rng = np.random.default_rng([self.seed % 2**64, 13, w])
            while time.perf_counter() < end_at:
                with self.lock:
                    rid = self.next_id
                    self.next_id += 1
                self.send(rid, int(rng.integers(0, len(self.tiles))), time.perf_counter(), t0)

        self.threads = [threading.Thread(target=worker, args=(w,))
                        for w in range(int(self.traffic["clients"]))]
        for th in self.threads:
            th.start()

    def open(self, t0: float) -> None:
        t = self.traffic
        arrivals = int(round(float(t["rate_per_s"]) * self.seconds))
        due = np.sort(self.rng.uniform(0.0, self.seconds, arrivals))
        tile_ids = self.rng.integers(0, len(self.tiles), arrivals)
        q: "queue.Queue" = queue.Queue()
        self.lateness: list = []

        def sender() -> None:
            while True:
                item = q.get()
                if item is None:
                    return
                rid, tile, at = item
                with self.lock:
                    self.lateness.append(time.perf_counter() - at)
                self.send(rid, tile, at, t0)

        senders = [threading.Thread(target=sender) for _ in range(int(t["senders"]))]
        for th in senders:
            th.start()

        def dispatch() -> None:
            for rid, at in enumerate(due):
                at = t0 + float(at)
                wait = at - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                q.put((rid, int(tile_ids[rid]), at))
            for _ in senders:
                q.put(None)

        dispatcher = threading.Thread(target=dispatch)
        dispatcher.start()
        self.threads = [dispatcher, *senders]


def main() -> int:
    job = json.loads(sys.stdin.readline())
    load = Load(job)
    load.warm()
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        return 1
    t0 = time.perf_counter()
    (load.closed if load.traffic["loop"] == "closed" else load.open)(t0)
    time.sleep(max(0.0, t0 + load.seconds - time.perf_counter()))
    print("END", flush=True)
    for th in load.threads:
        th.join(timeout=180.0)
    with load.lock:
        records = list(load.records)
        kept = dict(load.kept)
        late = list(getattr(load, "lateness", []))
    meta = json.dumps({"records": records, "lateness": late,
                       "kept": [[rid, tile] for rid, (tile, _) in kept.items()]}).encode()
    buf = io.BytesIO()
    outs = [arr for _, arr in kept.values()]
    np.save(buf, np.stack(outs) if outs else np.zeros((0, load.patch, load.patch, 3), np.float32))
    blob = buf.getvalue()
    out = sys.stdout.buffer
    out.write(f"RESULT {len(meta)} {len(blob)}\n".encode())
    out.write(meta)
    out.write(blob)
    out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
