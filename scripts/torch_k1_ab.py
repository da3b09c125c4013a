#!/usr/bin/env python3
"""K1's forward and backward kernels of one checkout, timed on a CUDA GPU at
every shape ``chip_smoke.py`` holds them.

``--root`` names the checkout whose ``adunet_torch`` is timed (default: the
one this script lies in); its kernels are built into its own ``build/``.
The shapes, the seeded inputs and the profiler's device time per launch
(``profiled_device_ms``: no host cost, "not measured" where the tracer
dropped records) come from this script's own ``chip_smoke.py``, so two
checkouts are timed on the same inputs in the same way. To compare two of
them on one card, run this for each in turns in one call, e.g. for a
``git archive`` of the parent commit unpacked under ``build/parent``:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_k1_ab.py --root $r --json build/ab/k1_$(basename $r).json
    done

It also times the host's cost of one call of each kernel's wrapper
(``_launch``, ``_launch_backward``) at 2,048 x 512 bf16, where the kernels
take a few microseconds on the card: back-to-back calls then wait on the
host, so the wall time per call is the wrapper's own (the median of 5 runs of
2,000 calls, each run ending in one synchronize).

Each line printed names the card and its power limit; ``--json PATH``
appends the run's rows to a JSON list there.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the wrappers' host cost: the shape, the calls of one run, the runs
HOST_SHAPE, HOST_CALLS, HOST_RUNS = (2_048, 512), 2_000, 5


def host_us(fn) -> float:
    """Median over HOST_RUNS runs of the wall time per call, in
    microseconds, of HOST_CALLS back-to-back calls of ``fn`` and one
    synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(HOST_RUNS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    return statistics.median(per_call)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose kernels are timed")
    ap.add_argument("--json", default=None, help="append the rows to a JSON list in this file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # that checkout's adunet_torch, before any other
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from adunet_torch.kernels import fused_norm
    from adunet_torch.utils import gpu_identity

    if not Path(fused_norm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {fused_norm.__file__}, not {root}'s adunet_torch")
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_ab: needs a CUDA GPU")
    cs.setup_runtime()
    ident = gpu_identity().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    rows_out = []
    for kind, cases in (("K1", cs._k1_cases()), ("K1_bwd", cs._k1_bwd_cases())):
        for (rows, c), _, dtype, path in cases:
            x, a, b = cs._k1_inputs(gen, rows, c, dtype)
            if kind == "K1":
                ms, n = cs.profiled_device_ms(lambda: fused_norm.layer_norm_relu(x, a, b),
                                              "layer_norm_relu_kernel")
            else:
                gy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
                ms, n = cs.profiled_device_ms(
                    lambda: fused_norm._launch_backward(x, a, b, gy, 1e-3), cs.K1_BWD_KERNEL,
                    per_run=2)
                del gy
            rows_out.append({"root": str(root), "kernel": kind, "path": path, "rows": rows, "C": c,
                             "dtype": cs._dname(dtype), "device_ms": ms, "launches": n})
            cs.log(f"[k1 ab] {ident} {root.name}: {kind} {path} {rows} x {c} {dtype}: device "
                   f"{cs._ms(ms)} over {n} launches")
            del x, a, b
            torch.cuda.empty_cache()
    rows, c = HOST_SHAPE
    x, a, b = cs._k1_inputs(gen, rows, c, torch.bfloat16)
    gy = torch.randn(rows, c, generator=gen, device="cuda").to(torch.bfloat16)
    for kind, fn in (("K1", lambda: fused_norm._launch(x, a, b, 1e-3)),
                     ("K1_bwd", lambda: fused_norm._launch_backward(x, a, b, gy, 1e-3))):
        us = host_us(fn)
        rows_out.append({"root": str(root), "kernel": kind, "path": "host", "rows": rows, "C": c,
                         "dtype": "bfloat16", "host_us_per_call": us})
        cs.log(f"[k1 ab] {ident} {root.name}: {kind} wrapper's host cost {us:.2f} us a call at "
               f"{rows} x {c} bfloat16 (median of {HOST_RUNS} runs of {HOST_CALLS} calls)")
    if args.json:
        path = Path(args.json)
        prior = json.loads(path.read_text()) if path.exists() else []
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(prior + [{"gpu": ident, "rows": rows_out}]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
