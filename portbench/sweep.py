"""Offer open-loop load at several fixed rates to a serving cell's server and
report, for each, the tail, the failures and whether the backlog grows (the
median latency of the window's first third against its last third): how the
open-loop cell's rate was found, once, on the card.

    python3 -m portbench.sweep --workload sr_flagship.serve_bulk --traffic serve_poisson
        --rates 41 48 54 61 68 [--seconds 20] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import catalog, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--traffic", required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=4_000_000_007)
    args = parser.parse_args(argv)
    cell = catalog.cell(args.workload)
    cell["traffic"] = catalog.traffic(args.traffic)
    cell["end_to_end"] = [m for m in catalog.benchmark()["end_to_end"]
                          if m["name"] in ("setup_s", "serve_tiles_per_s", "serve_p95_ms")]
    for i, rate in enumerate(args.rates):
        cell["traffic"] = dict(cell["traffic"], rate_per_s=rate)
        print(f"[sweep] rate {rate} requests/s", file=sys.stderr, flush=True)
        result = run.run_cell(cell, args.seed + i, args.seconds, False, "cuda")
        print(json.dumps({"rate_per_s": rate, "attempted": result["attempted"],
                          "failed": result["failed"],
                          **{k: v["value"] for k, v in result["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
