"""One run of one cell of the benchmark; a fresh process each time.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. It loads,
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints as the last line of its standard
output one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device`` and, last, ``checks``: each number compared,
with its limit. The same numbers close its standard error. Earlier lines
(standard error) give the card, its power limit and clocks, the kernels'
launches, and the load generator's lateness.

It exits with 2, printing no result, without a CUDA device or with fewer
than the cell's chips, and with 3 if a module of the JAX stack or of the
JAX package was loaded in this process.

``setup_s`` runs from the process's start (read from ``/proc``) to the first
timed step or request. The kernel library is built at first use into
``build/adunet_torch_kernels/`` inside the checkout, so only a checkout's
first run builds it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def process_start_time() -> float:
    """The wall-clock time this process started (``/proc``; 10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.time()


START = process_start_time()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line(torch) -> str:
    import subprocess

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,"
             "temperature.gpu,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi not readable"
    return f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}"


def read_per_layer(cell: dict, ctx: dict) -> dict:
    from portbench import catalog

    out = {}
    for m in cell["per_layer"]:
        value = catalog.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """Run the cell on ``device`` and return the result object (without
    checking for a card: the CPU tests drive this at toy sizes)."""
    import torch

    from portbench import catalog, check
    from portbench.lib import trace as tracing

    out = catalog.driver(cell["traffic"])(cell, seed, seconds, trace, device, log)
    numbers = {k: float(v) for k, v in out["numbers"].items() if isinstance(v, (int, float))}
    correct, compared = check.verdict(numbers, cell["limits"].get("numbers", {}))
    if trace:
        metrics = read_per_layer(cell, out["ctx"])
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_end"] - START)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    tr = out["ctx"].get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tracing.busy_s(tr)
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tracing.top_device_ops(tr),
                               "idle_gaps": tracing.top_idle_gaps(tr)}
    if not cuda:
        result["measurement"] = "none: a CPU run at toy sizes, no device metric"
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import catalog
    from portbench.lib import guard

    cell = catalog.cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(card_line(torch))
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = guard.loaded_forbidden()
    if found:
        log(f"portbench: modules of the JAX stack or package were loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
