"""The serving driver: one run of a ``serve`` traffic mix.

Set-up writes the configuration's serving artifact (its model module's
``save_artifact``, ``portbench/models/``: the flagship's int8 weights and
``model.pt2`` program) from the seed's weights into a directory under
``TMPDIR``, starts the program's HTTP server on 127.0.0.1 (an ephemeral
port) in this process, and starts the load generator
(``portbench.clients``) as a process of its own, which warms the server
up. The window is the load generator's; this process waits for it (under
the profiler with ``--trace 1``). After it, the server is shut down, the
program freed, and the reference (the model's ``reference_tiles``)
restores the sampled requests' tiles from the same weights, quantized
again by its own code.
"""

from __future__ import annotations

import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from portbench import catalog, check, program
from portbench.lib import inputs, stats, tiles as tile_lib, trace as tracing


def _read_result(proc) -> tuple:
    line = proc.stdout.readline().decode()
    if not line.startswith("RESULT"):
        raise RuntimeError(f"load generator ended without a result ({line!r})")
    _, n_meta, n_blob = line.split()
    meta = json.loads(proc.stdout.read(int(n_meta)))
    return meta, np.load(io.BytesIO(proc.stdout.read(int(n_blob))))


def _expect(proc, word: str) -> None:
    line = proc.stdout.readline().decode().strip()
    if line != word:
        raise RuntimeError(f"load generator said {line!r}, expected {word}")


def run(cell: dict, seed: int, seconds: float, trace: bool, device, log) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    model = catalog.model(cfg)
    cuda = torch.device(device).type == "cuda"
    patch = int(cfg["patch_size"])
    batch = int(cfg["serve"]["batch_size"])
    tmp = tempfile.mkdtemp(prefix="portbench_artifact_")
    server = thread = proc = None
    try:
        net = model.build(cfg, inputs.weights(cfg, seed, device), cfg["serve"]["dtype"], device)
        model.save_artifact(net, tmp, cfg)
        del net
        gc.collect()
        server = program.server(tmp, traffic, device)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        env = dict(os.environ, PYTHONPATH=str(catalog.ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.Popen([sys.executable, "-m", "portbench.clients"], cwd=str(catalog.ROOT),
                                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        job = {"port": server.server_address[1], "patch": patch, "traffic": traffic,
               "seed": seed, "seconds": seconds}
        proc.stdin.write((json.dumps(job) + "\n").encode())
        proc.stdin.flush()
        _expect(proc, "READY")
        stats0, counts0 = server.batcher.snapshot_stats(), program.launch_counts()
        setup_end = time.time()
        proc.stdin.write(b"GO\n")
        proc.stdin.flush()
        sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
        if trace:
            _, tr = tracing.record(lambda: _expect(proc, "END"), sync)
            stats_end = server.batcher.snapshot_stats()
        else:
            _expect(proc, "END")
            tr, stats_end = None, None
        meta, kept = _read_result(proc)
        proc.wait(timeout=60)
        stats1, counts1 = server.batcher.snapshot_stats(), program.launch_counts()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        if server is not None:
            server.shutdown()
            server.batcher.close()
            server.server_close()
            thread.join(timeout=30)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    records = meta["records"]  # [rid, tile, due, start, end, status, ok]
    in_window = [r for r in records if r[2] < seconds]
    failed = sum(1 for r in in_window if not r[6])
    lat_ms = [(r[4] - r[2]) * 1e3 if r[6] else math.inf for r in in_window]
    p95 = stats.percentile(lat_ms, 95.0) if lat_ms else math.inf
    if p95 == math.inf:  # a failure ranks last: it stands at the window's length
        p95 = max([seconds * 1e3] + [v for v in lat_ms if v != math.inf])
    answered = sum(1 for r in records if r[6] and r[4] <= seconds)
    if meta["lateness"]:
        late = sorted(meta["lateness"])
        log(f"[generator] {len(late)} arrivals sent; lateness median "
            f"{stats.percentile(late, 50) * 1e3:.3f} ms, p99 {stats.percentile(late, 99) * 1e3:.3f} "
            f"ms, max {late[-1] * 1e3:.3f} ms")
    calls = stats1["device_calls"] - stats0["device_calls"]
    launches = tuple((b - a) / calls for a, b in zip(counts0, counts1)) if calls else None
    log(f"[launches] K1 / K1 backward / K2 / K2 backward / resize a forward: "
        f"{' / '.join(f'{v:g}' for v in launches) if launches else 'no forward'}; "
        f"{calls} forwards, {stats1['batched_rows'] - stats0['batched_rows']} rows")
    log(f"[serve] {len(in_window)} requests in the window, {failed} failed, {answered} tiles "
        f"answered in it; p50 {stats.percentile(lat_ms, 50) if lat_ms else math.nan:.3f} ms")
    admitted = stats1["requests"] - stats0["requests"]
    kinds = {k: sum(1 for r in records if r[5] == s)
             for k, s in (("503", 503), ("reset", check.RESET), ("no reply", 0))}
    log(f"[refusals] {len(records)} requests sent, {admitted} admitted by the server; "
        + ", ".join(f"{n} {k}" for k, n in kinds.items()))
    thirds = [[v for r, v in zip(in_window, lat_ms) if k * seconds / 3 <= r[2] < (k + 1) * seconds / 3]
              for k in (0, 2)]
    if all(thirds):
        log(f"[backlog] median latency of the requests due in the window's first third "
            f"{stats.percentile(thirds[0], 50):.3f} ms, in its last third "
            f"{stats.percentile(thirds[1], 50):.3f} ms")

    pool = tile_lib.pool(seed, int(traffic["pool_tiles"]), patch)
    ids = [rid for rid, _ in meta["kept"]]
    tile_ids = [tile for _, tile in meta["kept"]]
    x = pool[tile_ids] if tile_ids else np.zeros((0, patch, patch, 3), np.uint8)
    ref = model.reference_tiles(cfg, seed, x, device) if len(x) else x.astype(np.float32)
    numbers = check.serve_numbers({rid: kept[i] for i, rid in enumerate(ids)},
                                  {rid: ref[i] for i, rid in enumerate(ids)},
                                  check.missing([r[5] for r in records], admitted))
    log(f"[check] {len(ids)} sampled requests compared with the reference: tile_gap "
        f"{numbers['tile_gap']!r}, missing {numbers['missing']}")

    window_stats = stats_end or stats1
    ctx = {"trace": tr, "program_batch": batch, "dtype": cfg["serve"]["dtype"],
           "convs": model.conv_layers(cfg, 1, patch), "norms": model.norm_layers(cfg, batch, patch),
           "convs_batch": model.conv_layers(cfg, batch, patch),
           "forwards": window_stats["device_calls"] - stats0["device_calls"],
           "rows": window_stats["batched_rows"] - stats0["batched_rows"],
           "tiles": answered, "launches": launches}
    return {"setup_end": setup_end,
            "end_to_end": {"serve_tiles_per_s": answered / seconds, "serve_p95_ms": p95},
            "ctx": ctx, "numbers": numbers, "attempted": len(in_window), "failed": failed,
            "memory_peak_bytes": peak}

