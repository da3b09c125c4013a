#!/usr/bin/env python3
"""Where the time of one flagship or joint training step goes, on a CUDA GPU.

``--model flagship`` (the default) builds the flagship SR U-Net with the
PyTorch port (scale 0.5, depth 3, base 64, 8,637,379 params, bf16 compute,
float32 params, Adam 1e-4), holds a synthetic corpus
(``scripts/make_synth_corpus.py::synth_image``, seed 5) on the card as
uint8, and runs the device-cache train step at batch 32 x 256 px: sample,
degrade, forward, Charbonnier loss, backward, Adam. ``--model joint`` builds
the joint SR + segmentation U-Net at ``train_joint``'s defaults (scale 0.5,
base 64, depth 4 from the depth policy, 50,273,348 params, bf16, Adam 1e-4)
and runs its train step at batch 8 x 256 px on synthetic lesion pairs
(``scripts/make_synth_isic.py::synth_pair``, seed 61) held on the card:
degrade, both heads, Charbonnier + BCE-Dice, backward, Adam.
``--model vanilla_f32`` runs the tuner's float32 lane step
(``adunet_torch.tune.BatchedVanillaSRTuner.train_step``, one lane): the
vanilla SR U-Net (base 64, depth 4, 34,525,251 params, BatchNorm) on LR
images degraded at 0.5 from synthetic 256-px images (seed 5) held on the
card, the combined loss over the seeded VGG19 tower (its HR forward, the
prediction's forward and backward), backward, Adam, with cuDNN's
deterministic algorithms as the tuner's CLI runs them; batch 8 by default.
It times
steps with CUDA events after a warm-up, then traces a few steps with
``torch.profiler`` and prints the device time per step of the kernels'
forward (K1, K2) and of K1's backward kernels by their device kernels'
names, of K2's autograd backward (``_Conv3x3SameBackward``, cuDNN), of
cuDNN's convolutions forward and backward, of
the other operators, the device's busy and idle share, and the card's name
and power limit. ``--json PATH`` also writes the full result as JSON.

Run from the repository root on a machine with a GPU:

    python3 scripts/torch_profile_train.py [--model flagship|joint|vanilla_f32] [--steps 5]
        [--batch N]
        [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from make_synth_corpus import synth_image  # noqa: E402
from make_synth_isic import synth_pair  # noqa: E402

from adunet_torch.data import load_device_cache  # noqa: E402
from adunet_torch.losses import charbonnier_loss, make_bce_dice_loss  # noqa: E402
from adunet_torch.models import build_joint_unet, build_super_resolution_unet  # noqa: E402
from adunet_torch.ops import degrade  # noqa: E402
from adunet_torch.train import (  # noqa: E402
    create_train_state,
    make_joint_train_step,
    make_optimizer,
    make_sr_device_cache_train_step,
)
from adunet_torch.tune import BatchedVanillaSRTuner  # noqa: E402
from adunet_torch.utils import gpu_identity  # noqa: E402

# label -> ("kernel", substring of a device kernel's name) or ("op", exact name
# of an operator whose device time, its children's included, is reported)
GROUPS = {
    "K1 forward (kernel)": ("kernel", "layer_norm_relu_kernel"),
    "K1 backward (kernels: rows, column sums)": ("kernel", "layer_norm_relu_bwd"),
    "K2 forward (bf16 tensor-core kernel)": ("kernel", "conv3x3_c64_wgmma_kernel"),
    "K2 forward (float32 kernel)": ("kernel", "conv3x3_c64_kernel"),
    "K2 backward (cuDNN)": ("op", "autograd::engine::evaluate_function: _Conv3x3SameBackward"),
    "cuDNN conv forward (other convs)": ("op", "aten::cudnn_convolution"),
    "conv backward (all convs)": ("op", "aten::convolution_backward"),
    "resize matmuls": ("op", "aten::bmm"),
    "Adam": ("op", "Optimizer.step#Adam.step"),
}


def _device_us(evt, self_only: bool) -> float:
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def flagship_step(batch: int):
    """The flagship's device-cache step and its argument-free call."""
    with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
        rng = np.random.default_rng(5)
        paths = []
        for i in range(16):
            path = Path(tmp) / f"synth{i:03d}.npy"
            np.save(path, np.round(synth_image(rng, 512) * 255).astype(np.uint8))
            paths.append(str(path))
        cache = load_device_cache(paths, "cuda")
    model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=torch.bfloat16,
                                           device="cuda", seed=0)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_sr_device_cache_train_step(model, charbonnier_loss, cache, patch_size=256,
                                           batch_size=batch)
    gen = torch.Generator("cuda").manual_seed(0)
    return lambda: step(state, None, gen)


def joint_step(batch: int):
    """The joint model's train step on one batch of lesion pairs on the card."""
    rng = np.random.default_rng(61)
    pairs = [synth_pair(rng, 256) for _ in range(batch)]
    images = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    masks = torch.from_numpy(np.stack([p[1] for p in pairs])[..., None]).cuda()
    model, _ = build_joint_unet(0.5, dtype=torch.bfloat16, device="cuda", seed=0)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_joint_train_step(model, charbonnier_loss, make_bce_dice_loss(0.5, 1.0))
    return lambda: step(state, (images, masks))


def vanilla_f32_step(batch: int):
    """The tuner's float32 lane step (one lane) on one batch held on the card,
    with cuDNN's deterministic algorithms, as the tuner's CLI runs it."""
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(5)
    hr = np.stack([synth_image(rng, 256) for _ in range(batch)]).astype(np.float32)
    lr = degrade(torch.from_numpy(hr), 0.5).numpy()
    runner = BatchedVanillaSRTuner(lr, hr, np.arange(batch), np.arange(batch), device="cuda")
    lanes = runner.lanes([{"lr": 1e-4, "alpha": 1.0, "beta": 0.1, "gamma": 0.01}])
    data = (torch.from_numpy(lr).cuda(), torch.from_numpy(hr).cuda())
    return lambda: runner.train_step(lanes, data)


STEPS = {"flagship": (flagship_step, 32, "bf16 flagship train step, device cache"),
         "joint": (joint_step, 8, "bf16 joint SR + segmentation train step"),
         "vanilla_f32": (vanilla_f32_step, 8, "the tuner's float32 vanilla SR lane step")}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--model", choices=sorted(STEPS), default="flagship")
    parser.add_argument("--batch", type=int, default=None,
                        help="batch size (default 32 for the flagship, 8 otherwise)")
    parser.add_argument("--json", type=Path, default=None, help="write the full result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: needs a CUDA GPU", file=sys.stderr)
        return 2

    ident = gpu_identity().splitlines()[0]
    make, default_batch, what = STEPS[args.model]
    args.batch = args.batch or default_batch
    run = make(args.batch)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        run()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels, ops = [], []
    for evt in averages:
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
    result = {"gpu": ident, "torch": torch.__version__, "model": args.model,
              "batch": args.batch, "patch": 256,
              "step_ms": step_ms, "img_per_s": args.batch * 1e3 / step_ms,
              "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / step_ms) if busy else None,
              "groups": groups, "ops": ops[:30], "kernels": kernels[:40],
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    print(f"[profile] {ident}: {what}, batch {args.batch} x 256 px: "
          f"{step_ms:.3f} ms/step ({result['img_per_s']:.1f} img/s); device busy "
          f"{busy:.3f} ms per step; peak memory {result['peak_gb']:.2f} GB")
    if not busy:
        print("[profile] the profiler recorded no device time")
    for label, g in groups.items():
        print(f"[group] {g['ms']:9.3f} ms  x{g['count']:<4d} {label}")
    for r in ops[:20]:
        print(f"[op] {r['ms']:9.3f} ms  x{r['count']:<4d} {r['name'][:110]}")
    for r in kernels[:25]:
        print(f"[kernel] {r['ms']:9.3f} ms  x{r['count']:<4d} {r['name'][:110]}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
