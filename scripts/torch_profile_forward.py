#!/usr/bin/env python3
"""Where the time of one flagship serving forward goes, on a CUDA GPU.

Loads the trained flagship artifact (``experiments/round3_flagship/export_int8``,
scale 0.5, depth 3) with the PyTorch port, times the float32 forward at the
artifact's batch (8 x 256 px) with CUDA events, then traces a few forwards
with ``torch.profiler`` and prints the device time per forward of the
PyTorch operators (children's kernels included) and of the individual
kernels, the device's busy and idle share, and the card's name and power
limit. Last it times the same forward with ``torch.backends.cudnn.benchmark``
on (cuDNN autotunes its algorithms; the port runs with its heuristics).
``--json PATH`` also writes the full result as JSON.

Run from the repository root on a machine with a GPU:

    python3 scripts/torch_profile_forward.py [--iters 5] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from adunet_torch.export import load_artifact  # noqa: E402
from adunet_torch.utils import gpu_identity  # noqa: E402


def _device_time(evt, self_only: bool) -> float:
    """Device microseconds of a profiler average (attribute names vary by version)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--json", type=Path, default=None, help="write the full result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_forward: needs a CUDA GPU", file=sys.stderr)
        return 2

    ident = gpu_identity().splitlines()[0]
    call, manifest = load_artifact(ROOT / "experiments" / "round3_flagship" / "export_int8")
    model = call.model
    bsz, patch = manifest["input_shape"][0], manifest["input_shape"][1]
    x = torch.rand(bsz, patch, patch, 3, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))

    def forward_ms() -> float:
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            model(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    with torch.inference_mode():
        fwd_ms = forward_ms()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                model(x)
            torch.cuda.synchronize()
        # the same forward with cuDNN's algorithms autotuned instead of
        # chosen by its heuristics (the port runs with the heuristics)
        torch.backends.cudnn.benchmark = True
        fwd_ms_tuned = forward_ms()
        torch.backends.cudnn.benchmark = False

    ops, kernels = [], []
    for evt in prof.key_averages():
        on_device = str(getattr(evt, "device_type", "")).endswith("CUDA")
        if on_device:
            kernels.append({"name": evt.key, "count": evt.count // args.iters,
                            "ms": _device_time(evt, True) / 1e3 / args.iters})
        elif evt.key.startswith("aten::") and _device_time(evt, False) > 0:
            ops.append({"name": evt.key, "count": evt.count // args.iters,
                        "ms": _device_time(evt, False) / 1e3 / args.iters})
    ops.sort(key=lambda r: -r["ms"])
    kernels.sort(key=lambda r: -r["ms"])
    busy = sum(k["ms"] for k in kernels)
    result = {"gpu": ident, "torch": torch.__version__, "batch": bsz, "patch": patch,
              "forward_ms": fwd_ms, "img_per_s": bsz * 1e3 / fwd_ms,
              "forward_ms_cudnn_benchmark": fwd_ms_tuned, "device_busy_ms": busy,
              "idle_share": max(0.0, 1.0 - busy / fwd_ms) if busy else None,
              "ops": ops[:25], "kernels": kernels[:40]}

    print(f"[profile] {ident}: f32 forward, batch {bsz} x {patch} px: {fwd_ms:.3f} ms "
          f"({result['img_per_s']:.1f} img/s); device busy {busy:.3f} ms per forward; "
          f"with cudnn.benchmark on: {fwd_ms_tuned:.3f} ms ({bsz * 1e3 / fwd_ms_tuned:.1f} img/s)")
    if not busy:
        print("[profile] the profiler recorded no device time")
    for r in ops[:15]:
        print(f"[op] {r['ms']:9.3f} ms  x{r['count']:<4d} {r['name']}")
    for r in kernels[:20]:
        print(f"[kernel] {r['ms']:9.3f} ms  x{r['count']:<4d} {r['name'][:110]}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
