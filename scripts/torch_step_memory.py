#!/usr/bin/env python3
"""Device memory a train step leaves reserved once it is dropped, on a CUDA
GPU, for one checkout.

``--root`` names the checkout (default: the one this script lies in); its
``adunet_torch`` builds and runs the steps. For each of ``chip_smoke.py``'s
space cases in one process (the float32 flagship at batch 32, the bf16
flagship at batch 32, the bf16 deep config at batch 8), the phase's own
``_space_step`` runs 5 steps (a compiled step captures at its third), drops
the step, its state and its model, then ``gc.collect()`` and
``torch.cuda.empty_cache()``; the script prints the memory still allocated
and reserved, the reserved memory by pool (the caching allocator's own, or a
CUDA graph's) and stream, and the largest segments that a live block keeps
reserved. What one process keeps reserved is what a second process on the
card cannot have (``chip_smoke.py``'s ``space_ranks`` and ``ddp_ranks``
phases start two). To compare two commits, run this for each in one call,
e.g. for a ``git archive`` of the parent unpacked under ``build/parent``:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_step_memory.py --root $r
    done

Each line printed names the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose steps are run")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # that checkout's adunet_torch, before any other
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    if not Path(cs.fused_norm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {cs.fused_norm.__file__}, not {root}'s adunet_torch")
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_memory: needs a CUDA GPU")
    cs.setup_runtime()
    ident = cs.gpu_identity().splitlines()[0]
    synth = cs._synth()
    rng = np.random.default_rng(23)
    for case, (_, _, batch, _) in cs.SPACE_CASES.items():
        hr = np.stack([np.round(synth(rng, cs.TRAIN_PATCH) * 255).astype(np.uint8)
                       for _ in range(batch)])
        with cs.deterministic_cudnn():
            peak = cs._space_step(case, hr)["peak_gb"]
        gc.collect()
        torch.cuda.empty_cache()
        by_pool = collections.defaultdict(float)
        held = []
        for seg in torch.cuda.memory_snapshot():
            pool = "graph" if tuple(seg["segment_pool_id"]) != (0, 0) else "allocator"
            by_pool[f"{pool} pool, stream {seg['stream']}"] += seg["total_size"] / 1e9
            if seg["allocated_size"]:
                held.append((seg["total_size"] / 1e9, seg["allocated_size"] / 1e9, pool))
        held.sort(reverse=True)
        cs.log(f"[step memory] {ident} {root.name}: after {case} (5 steps, peak {peak:.2f} GB) "
               f"dropped: allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB, reserved "
               f"{torch.cuda.memory_reserved() / 1e9:.3f} GB; by pool and stream "
               + ", ".join(f"{k} {v:.3f} GB" for k, v in sorted(by_pool.items()))
               + "; largest segments a live block holds "
               + ", ".join(f"{t:.3f} GB ({a:.3f} live, {p} pool)" for t, a, p in held[:3]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
