#!/usr/bin/env python3
"""Where the time of one segmentation training step goes, on a CUDA GPU.

Builds a segmentation U-Net of the PyTorch port at full width (``protocol``:
``AdaptiveSegUNet`` base 64, depth 4, BatchNorm, 31,390,721 params, protocol
A's hybrid loss and augmentation on the card; ``vanilla``: ``VanillaSegUNet``
base 32, depth 4, LayerNorm through K1, ConvTranspose decoder, BCE and the
vanilla trainer's metrics, flips), float32 params, ``--dtype`` compute, Adam
1e-3, and runs its train step at batch 8 x 256 px on synthetic lesion pairs
(``scripts/make_synth_isic.py::synth_pair``) already on the card. It times
steps with CUDA events after a warm-up, then traces a few steps with
``torch.profiler`` and prints the device time per step of the kernels (K1,
K1 backward, K2), cuDNN's convolutions forward and backward, BatchNorm's
operators, the augmentation's gathers, Adam and the other operators, the
device's busy and idle share, the peak memory, and the card's name and
power limit. ``--json PATH`` also writes the full result as JSON.

Run from the repository root on a machine with a GPU:

    python3 scripts/torch_profile_seg.py --model protocol|vanilla [--dtype bfloat16|float32]
        [--steps 5] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from make_synth_isic import synth_pair  # noqa: E402
from torch_profile_train import _device_us  # noqa: E402

from adunet_torch.losses import binary_crossentropy, make_hybrid_ce_dice_loss  # noqa: E402
from adunet_torch.metrics import (  # noqa: E402
    binary_accuracy,
    pooled_global_dice,
    pooled_precision,
    pooled_recall,
)
from adunet_torch.models import build_adaptive_depth_unet, build_unet  # noqa: E402
from adunet_torch.train import create_train_state, make_optimizer, make_seg_train_step  # noqa: E402
from adunet_torch.utils import gpu_identity, setup_runtime  # noqa: E402

# label -> ("kernel", substring of a device kernel's name) or ("op", exact name
# of an operator whose device time, its children's included, is reported)
GROUPS = {
    "K1 forward (kernel)": ("kernel", "layer_norm_relu_kernel"),
    "K1 backward (kernels: rows, column sums)": ("kernel", "layer_norm_relu_bwd"),
    "K2 forward (kernel)": ("kernel", "conv3x3_c64"),
    "K2 backward (cuDNN)": ("op", "autograd::engine::evaluate_function: _Conv3x3SameBackward"),
    "cuDNN conv forward (other convs)": ("op", "aten::cudnn_convolution"),
    "conv backward (all convs)": ("op", "aten::convolution_backward"),
    "transposed conv forward": ("op", "aten::cudnn_convolution_transpose"),
    "max-pool forward": ("op", "aten::max_pool2d_with_indices"),
    "resize matmuls": ("op", "aten::bmm"),
    "augmentation gathers": ("op", "aten::index"),
    "casts (aten::to copies)": ("op", "aten::copy_"),
    "Adam": ("op", "Optimizer.step#Adam.step"),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=["protocol", "vanilla"], required=True)
    parser.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--json", type=Path, default=None, help="write the full result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_seg: needs a CUDA GPU", file=sys.stderr)
        return 2
    setup_runtime()
    ident = gpu_identity().splitlines()[0]
    dtype = getattr(torch, args.dtype)

    rng = np.random.default_rng(31)
    pairs = [synth_pair(rng, 256) for _ in range(args.batch)]
    batch = (torch.from_numpy(np.stack([p[0] for p in pairs])).cuda(),
             torch.from_numpy(np.stack([p[1] for p in pairs])[..., None]).cuda())
    if args.model == "protocol":
        model = build_adaptive_depth_unet(256, 64, 4, dtype=dtype, device="cuda", seed=0)
        step = make_seg_train_step(model, make_hybrid_ce_dice_loss(0.4, 0.6), augment="full")
    else:
        model = build_unet(256, base_channels=32, depth=4, dtype=dtype, device="cuda", seed=0)
        extra = {"accuracy": binary_accuracy, "precision": pooled_precision(),
                 "recall": pooled_recall(), "dice_coefficient": pooled_global_dice()}
        step = make_seg_train_step(model, binary_crossentropy, augment="flips", extra_metrics=extra)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
    gen = torch.Generator("cuda").manual_seed(0)
    for _ in range(3):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step(state, batch, gen)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / args.steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
    kernels, ops = [], []
    for evt in prof.key_averages():
        on_device = str(getattr(evt, "device_type", "")).endswith("CUDA")
        if on_device and getattr(evt, "is_user_annotation", False):
            continue  # a range such as Optimizer.step's on the device timeline, not a kernel
        if on_device:
            kernels.append({"name": evt.key, "count": evt.count // args.steps,
                            "ms": _device_us(evt, True) / 1e3 / args.steps})
        elif _device_us(evt, False) > 0:
            ops.append({"name": evt.key, "count": evt.count // args.steps,
                        "ms": _device_us(evt, False) / 1e3 / args.steps})
    kernels.sort(key=lambda r: -r["ms"])
    ops.sort(key=lambda r: -r["ms"])
    busy = sum(k["ms"] for k in kernels)
    groups = {}
    for label, (kind, key) in GROUPS.items():
        rows = ([k for k in kernels if key in k["name"]] if kind == "kernel"
                else [o for o in ops if o["name"] == key])
        groups[label] = {"ms": sum(r["ms"] for r in rows), "count": sum(r["count"] for r in rows)}
    result = {"gpu": ident, "torch": torch.__version__, "model": args.model, "dtype": args.dtype,
              "batch": args.batch, "size": 256, "step_ms": step_ms,
              "img_per_s": args.batch * 1e3 / step_ms, "device_busy_ms": busy,
              "idle_share": max(0.0, 1.0 - busy / step_ms) if busy else None,
              "groups": groups, "ops": ops[:40], "kernels": kernels[:40], "peak_gb": peak_gb}

    print(f"[profile] {ident}: {args.model} {args.dtype} seg train step, batch {args.batch} x "
          f"256 px: {step_ms:.3f} ms/step ({result['img_per_s']:.1f} img/s); device busy "
          f"{busy:.3f} ms per step; peak memory {peak_gb:.2f} GB")
    if not busy:
        print("[profile] the profiler recorded no device time")
    for label, g in groups.items():
        print(f"[group] {g['ms']:9.3f} ms  x{g['count']:<4d} {label}")
    for r in ops[:25]:
        print(f"[op] {r['ms']:9.3f} ms  x{r['count']:<4d} {r['name'][:110]}")
    for r in kernels[:25]:
        print(f"[kernel] {r['ms']:9.3f} ms  x{r['count']:<4d} {r['name'][:110]}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
