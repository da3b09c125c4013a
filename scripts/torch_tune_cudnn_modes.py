#!/usr/bin/env python3
"""The tuner's float32 lane step under three cuDNN settings, on a CUDA GPU.

The vanilla SR U-Net (base 64, depth 4, float32, BatchNorm) with the
combined loss over the seeded VGG19 tower, one lane of
``adunet_torch.tune.BatchedVanillaSRTuner``, at batch 4, 8 and 16 x 256 px
on synthetic images (``scripts/make_synth_corpus.py::synth_image``, seed 5)
held on the card. For each batch size and each setting of cuDNN (TF32 off
in all three):

- ``default``: PyTorch's defaults (heuristic algorithm choice, which may
  pick non-deterministic algorithms);
- ``deterministic``: ``torch.backends.cudnn.deterministic = True``;
- ``benchmark``: ``torch.backends.cudnn.benchmark = True`` (cuDNN times the
  algorithms at each new shape and keeps the fastest);

it prints the step's time (CUDA events over ``--steps`` steps after 2
warm-up steps), the device kernels the profiler records in one step and the
largest one by device time, and whether two runs of the same 3 steps from
the same weights give bit-equal losses. With the defaults it also prints
the five convolution calls (forward or backward, by input shapes) that take
the most device time in one step. Then the card's name and power limit.
``--json PATH`` also writes the rows.

    python3 scripts/torch_tune_cudnn_modes.py [--steps 5] [--json PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from make_synth_corpus import synth_image  # noqa: E402

from adunet_torch.ops import degrade  # noqa: E402
from adunet_torch.tune import BatchedVanillaSRTuner  # noqa: E402
from adunet_torch.utils import gpu_identity  # noqa: E402

MODES = {"default": dict(deterministic=False, benchmark=False),
         "deterministic": dict(deterministic=True, benchmark=False),
         "benchmark": dict(deterministic=False, benchmark=True)}
CONFIG = {"lr": 1e-4, "alpha": 1.0, "beta": 0.1, "gamma": 0.01}


@contextlib.contextmanager
def _cudnn(deterministic: bool, benchmark: bool):
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = deterministic, benchmark
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _self_ms(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name)) / 1e3
    return 0.0


def _total_ms(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name)) / 1e3
    return 0.0


def _losses(runner, data, n: int) -> list:
    lanes = runner.lanes([CONFIG])
    out = []
    for _ in range(n):
        runner.train_step(lanes, data)
        out.append(runner.val_losses(lanes, data))
    return [float(v) for v in torch.cat(out).cpu()]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_tune_cudnn_modes: needs a CUDA GPU", file=sys.stderr)
        return 2
    rng = np.random.default_rng(5)
    hr = np.stack([synth_image(rng, 256) for _ in range(16)]).astype(np.float32)
    lr = degrade(torch.from_numpy(hr), 0.5).numpy()
    runner = BatchedVanillaSRTuner(lr, hr, np.arange(16), np.arange(16), device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = []
    for batch in (4, 8, 16):
        data = (torch.from_numpy(lr[:batch]).cuda(), torch.from_numpy(hr[:batch]).cuda())
        for mode, flags in MODES.items():
            with _cudnn(**flags):
                lanes = runner.lanes([CONFIG])
                for _ in range(2):
                    runner.train_step(lanes, data)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.steps):
                    runner.train_step(lanes, data)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / args.steps
                with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
                    runner.train_step(lanes, data)
                    torch.cuda.synchronize()
                convs = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                                if e.key in ("aten::cudnn_convolution",
                                             "aten::convolution_backward")),
                               key=_total_ms, reverse=True)[:5]
                kernels = [e for e in prof.key_averages()
                           if str(getattr(e, "device_type", "")).endswith("CUDA")
                           and not getattr(e, "is_user_annotation", False)]
                top = max(kernels, key=_self_ms, default=None)
                repeat = _losses(runner, data, 3) == _losses(runner, data, 3)
            row = {"batch": batch, "mode": mode, "ms_per_step": ms,
                   "kernel_launches": sum(e.count for e in kernels),
                   "top_kernel": None if top is None else top.key[:100],
                   "top_kernel_ms": None if top is None else _self_ms(top),
                   "top_kernel_launches": None if top is None else top.count,
                   "repeatable": repeat,
                   "top_convs": [{"op": e.key, "shapes": str(e.input_shapes)[:160],
                                  "calls": e.count, "ms": _total_ms(e)} for e in convs]}
            rows.append(row)
            print(f"[cudnn] batch {batch:2d} {mode:13s}: {ms:9.3f} ms/step, "
                  f"{row['kernel_launches']} kernel launches a step, largest "
                  f"{row['top_kernel_ms']:.3f} ms x{row['top_kernel_launches']} "
                  f"{row['top_kernel']}; two runs bit-equal: {repeat}", flush=True)
            if mode == "default":
                for c in row["top_convs"]:
                    print(f"[conv] batch {batch:2d}: {c['ms']:9.3f} ms x{c['calls']} {c['op']} "
                          f"{c['shapes']}", flush=True)
            del lanes
            torch.cuda.empty_cache()
    ident = gpu_identity().splitlines()[0]
    print(ident)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"gpu": ident, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
