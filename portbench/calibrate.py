"""The readings the correctness limits are set from, on the card, at each
cell's own size: for each seed, the program's numbers against the
reference, and the control's (the reference in the next lower precision,
put in the program's place) and, for training, the planted faults'.

- training: the program's first steps (as a run's set-up drives them)
  against the reference; the control is the reference with every conv's
  input and weight rounded to float8 e4m3 (one scale a tensor); the faults:
  the loss taken over half of the batch (in the reference put in the
  program's place), and a step that leaves the state unchanged (its
  ``change_gap`` reads 1 by construction and needs no run);
- serving: a short run of the cell (``--seconds``), its sampled tiles
  against the reference; the control is the reference in TF32 against the
  reference in float32, on the pool's first tiles.

    python3 -m portbench.calibrate --workload <name> --seeds 12 [--first-seed N]
        [--seconds 4] [--json calibrate.jsonl]

Each seed's readings go out as one JSON line; the last line sums them up.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import catalog, check
from portbench.lib import tiles as tile_lib


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_seed(cell: dict, seed: int) -> dict:
    from portbench import train_cell

    cfg, traffic = cell["config"], cell["traffic"]
    steps = int(traffic["checked_steps"])
    prepared = train_cell.setup(cfg, traffic, seed, "cuda")
    readings, data = prepared.pop("readings"), prepared.pop("data")
    prepared.clear()
    _free()
    t0 = time.perf_counter()
    ref = train_cell.reference_readings(cfg, seed, data, steps, "cuda")
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    control = train_cell.reference_readings(cfg, seed, data, steps, "cuda",
                                            quant=catalog.model(cfg).control_quant)
    half = train_cell.reference_readings(cfg, seed, data, steps, "cuda",
                                         loss_rows=int(cfg["train"]["batch_size"]) // 2)
    unchanged = dict(readings, change_norms={k: 0.0 for k in readings["change_norms"]})
    out = {"program": check.train_numbers(readings, ref),
           "control": check.train_numbers(control, ref),
           "half_batch": check.train_numbers(half, ref),
           "unchanged": check.train_numbers(unchanged, ref),
           "reference_s": ref_s, "losses": readings["losses"], "ref_losses": ref["losses"]}
    del data
    _free()
    return out


def serve_seed(cell: dict, seed: int, seconds: float) -> dict:
    from portbench import run

    t0 = time.perf_counter()
    result = run.run_cell(cell, seed, seconds, False, "cuda")
    _free()
    cfg, traffic = cell["config"], cell["traffic"]
    patch = int(cfg["patch_size"])
    x = tile_lib.pool(seed, int(traffic["pool_tiles"]), patch)[:16]
    t1 = time.perf_counter()
    model = catalog.model(cfg)
    ref = model.reference_tiles(cfg, seed, x, "cuda")
    ref_s = time.perf_counter() - t1
    tf32 = model.reference_tiles(cfg, seed, x, "cuda", tf32=True)
    _free()
    return {"program": {k: v["value"] for k, v in result["checks"].items()},
            "control": {"tile_gap": float(np.abs(tf32 - ref).max())},
            "attempted": result["attempted"], "failed": result["failed"],
            "reference_s_16_tiles": ref_s, "run_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=3_000_000_017)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--json", default=None)
    parser.add_argument("--dtype", default=None,
                        help="train in this type instead of the configuration's (a witness run)")
    args = parser.parse_args(argv)
    cell = catalog.cell(args.workload)
    if args.dtype:
        cell["config"]["train"]["dtype"] = args.dtype
    driver = cell["traffic"]["driver"]
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        row = (train_seed(cell, seed) if driver == "train"
               else serve_seed(cell, seed, args.seconds))
        row["seed"] = seed
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.json:
            with open(args.json, "a") as f:
                f.write(line + "\n")
    summary = {}
    for side in ("program", "control", "half_batch", "unchanged"):
        if side not in rows[0]:
            continue
        for k, v in rows[0][side].items():
            if isinstance(v, (int, float)):
                vals = [r[side][k] for r in rows]
                summary[f"{side}.{k}"] = [min(vals), max(vals)]
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "min_max": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
