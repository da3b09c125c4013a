#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adunet_torch``) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one NVIDIA Hopper card (the kernels are built for sm_90a) and
exits non-zero without one. Every phase raises on failure:

1. builds the CUDA kernels from ``adunet_torch/csrc`` with ``nvcc`` (again
   if the library came from the build cache) and fails if ptxas's report
   shows a byte of spill in any of the 16 instantiations of K1's backward
   row kernel;
2. prints the card's name and power limit (``nvidia-smi``);
3. holds each kernel's forward against its plain PyTorch version on the
   card, at every shape the flagship's float32 serving forward (batch 8) and
   bf16 training step (batch 32) give it, and times the kernel (CUDA events,
   and the profiler's device time per launch, since at the small shapes the
   wrapper's host cost exceeds the kernel), the plain version and one
   PyTorch library call that computes the same function (a yardstick only:
   the port never calls it; events and device time) beside the least time
   the card could take;
4. holds each autograd Function's gradients (K1: dx, dgamma, dbeta; K2: dx,
   dw, db) against autograd through the plain version on the same CUDA
   tensors, at the training shapes in bf16 and the serving shapes in
   float32, and times forward + backward of each; then holds K1's backward
   kernel alone against ``layer_norm_relu_backward`` at the same shapes
   (counting the ReLU mask elements on which the two disagree), checks that
   its dgamma / dbeta repeat bit for bit, and times it beside its bytes
   bound, the plain backward and the library's backward;
5. serves the trained flagship artifact over HTTP (launch counts set to 0
   just before, read just after: 16 K1 + 4 K2 per device call, no K1
   backward);
6. re-derives the flagship's pinned eval numbers on the 48-tile seed-777
   corpus and times the serving forward;
7. trains the flagship (scale 0.5, depth 3, base 64, bf16 compute, f32
   params, Adam 1e-4; a seeded random 1x1 head in place of the zero one)
   on a device cache of synthetic images for a few device-cache steps at
   batch 32 x 256 px (counts set to 0 just before: 16 K1 forward, 16 K1
   backward and 4 K2 per step),
   checks that every parameter gets a finite, nonzero gradient in the first
   step and that the loss falls by a quarter over the steps, and times the
   step;
8. takes one float32 step of the flagship at batch 1 on the card and on the
   CPU (plain paths) from the same params and tile, and compares the loss,
   the gradients and the updated params;
9. runs the ``adunet_torch.cli.train_sr`` entry point for 2 short epochs at
   flagship width and checks its config, CSV, checkpoints and eval lines,
   its launches (16 K1 + 4 K2 per forward, 16 K1 backward per step), and
   that the best checkpoint restores the live weights;
10. trains the two segmentation U-Nets at full width on synthetic lesion
    pairs (``scripts/make_synth_isic.py::synth_pair``) at batch 8 x 256 px:
    the protocol model (base 64, depth 4, BatchNorm; augmentation on the
    card) in bf16 and in float32, and the vanilla model (base 32, depth 4,
    LayerNorm, ConvTranspose; flips) in bf16. Counts set to 0 just before
    each: 2 K2 and no K1 per protocol step; 18 K1, 18 K1 backward and 2 K2
    per vanilla step. Every parameter gets a finite nonzero gradient in the
    first step, the BatchNorm buffers move, the loss falls; the step is
    timed;
11. takes one float32 step of the protocol model at batch 2 on the card and
    on the CPU from the same weights and batch and compares the loss, the
    gradients, the updated params and the running statistics;
12. runs ``adunet_torch.cli.train_seg`` (protocol A, bf16, precise-BN over 2
    batches) and ``adunet_torch.cli.train_seg_vanilla`` (float32, flips) for
    2 epochs at full width on ``.npy`` ISIC-style pairs and checks their
    ``config.json`` keys, ``epoch_metrics.csv``, checkpoints and launches;
13. runs ``train_sr`` on the streamed path (no ``--device_cache``:
    ``--uint8_feed --cache_decoded``, bf16, batch 32 x 256 px) for 2 epochs
    and checks its launches, then times the same model's streamed step
    (host crops, pinned copy one batch ahead) and device-cache step in turns
    (counts set to 0 just before the first streamed run: 16 K1, 16 K1
    backward, 4 K2 per step), the host's wait on the feed, and both steps'
    device idle share under the profiler;
14. trains the deep config (scale 0.8, depth 5, base 64, 138,427,843
    params, bf16, batch 8 x 256 px) without and with ``remat_levels=2``
    (counts set to 0 just before each: 24 / 24 / 4 and 32 / 24 / 6 per
    step) and times it beside its convolutions' share of the bf16 peak;
    then holds one float32 step's gradients with and without remat equal;
15. trains the vanilla SR U-Net (base 64, depth 4, 34,525,251 params,
    BatchNorm) in bf16 with the combined loss over the seeded VGG19 tower at
    batch 8 x 256 px (counts set to 0 just before: 2 K2 per step, no K1),
    checks gradients, the BatchNorm buffers and the falling loss, times the
    step, and compares one float32 step with the CPU's;
16. runs ``train_sr_vanilla`` for 2 epochs, ``evaluate`` and ``restore`` on
    the streamed run's checkpoint (odd image sizes, overlap 32), and an
    ``--async_checkpoint`` run of ``train_sr`` whose best and latest states
    load bit-equal to a synchronous run's;
17. trains the joint SR + segmentation U-Net at ``train_joint``'s defaults
    (scale 0.5, base 64, depth 4 from the depth policy, 50,273,348 params,
    bf16, Adam 1e-4; a seeded random ``residual_rgb``) on synthetic lesion
    pairs at batch 8 x 256 px (counts set to 0 just before: 28 K1, 28 K1
    backward and 5 K2 per step), checks every gradient and the falling loss,
    and times the step beside its peak memory and device idle share;
18. takes one float32 step of the joint model at batch 1 x 256 px on the
    card and on the CPU from the same params and compares them as phase 8
    does;
19. runs ``train_joint`` for 2 epochs at full width (its ``config.json`` and
    ``result.json`` keys as the reference's), ``export_model --workload joint
    --quantize int8`` and one forward of the artifact on the card (28 K1, no
    K1 backward, 5 K2), then exports phase 12's protocol checkpoint, serves it
    over HTTP and holds the masks to the checkpoint's live model;
20. drives the tuner (``adunet_torch.cli.tune``) at full width: a 3-trial,
    2-epoch vanilla SR study (float32, base 64, 256 px, on 20 synthetic
    images) with a 1-epoch retrain, the same study with
    ``--parallel-trials 3``, and a 2-trial seg study at 256 px with the
    search's own base channels (counts set to 0 just before each: 2 K2 per
    lane per training step and per validation forward, no K1; the seg
    trials as their drawn widths give K2); holds 3 lanes of one group
    against the same configs run alone (1e-6 relative) and times the group
    against them, and the float32 lane step at batch 4, 8 and 16 beside its
    peak memory and device idle share;
21. prints one JSON line with each kernel's launches, error and times, the
    card's identity line, and last ``{"ok": true, "device": {...}}``.

At the start of each phase it prints a host probe (a fixed numpy and Python
timing, the load average, the live threads, torch's CPU threads), and
beside each K1-backward row the device time it had before the kernel's
redesign.

Phases 3 and 4 also hold K1 at C = 16 and 32 (forward and backward kernels,
float32 and bf16, full and ragged row counts) and K2 at the vanilla model's
(8, 128, 128, 64), at every shape the segmentation steps give them, K2 in
float32 at the tuner's (4, 256, 256, 64) and (16, 256, 256, 64), and K1
at every (rows, C) of the deep config up to C = 1024 and 2048 (bf16; float32
and ragged row counts at the two widest), and K1 and its backward at every
(rows, C) of the joint model's bf16 step, 2,048 x 1024 among them.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from adunet_torch.cli.serve import make_server
from adunet_torch.evaluate import infer_eval_shave
from adunet_torch.export import load_artifact
from adunet_torch.kernels import _build, conv64, fused_norm
from adunet_torch.metrics import msssim_power_factors_for, psnr, ssim, ssim_multiscale
from adunet_torch.ops import degrade, rgb_to_luma_bt601, scaled_size
from adunet_torch.utils import deterministic_cudnn, gpu_identity, setup_runtime

ROOT = Path(__file__).resolve().parent
ARTIFACT = ROOT / "experiments" / "round3_flagship" / "export_int8"
PINNED = ROOT / "experiments" / "round3_flagship" / "evaluation" / "metrics.json"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# (rows, C) -> LN+ReLU pairs per forward of the flagship (depth 3, 256 px):
# float32 serving at batch 8, bf16 training at batch 32
K1_SERVE = {(524_288, 64): 6, (131_072, 128): 4, (32_768, 256): 4, (8_192, 512): 2}
K1_TRAIN = {(2_097_152, 64): 6, (524_288, 128): 4, (131_072, 256): 4, (32_768, 512): 2}
# x (B, H, W, C) -> 64->64 3x3 convs per forward (enc0.conv1, dec0.conv1, head.conv0/1)
K2_SERVE = {(8, 256, 256, 64): 4}
K2_TRAIN = {(32, 256, 256, 64): 4}
K1_PER_CALL = sum(K1_SERVE.values())  # 16
# the device kernel K2 launches for each type (a substring of its name)
K2_KERNEL = {torch.float32: "conv3x3_c64_kernel", torch.bfloat16: "conv3x3_c64_wgmma_kernel"}
K1_BWD_KERNEL = "layer_norm_relu_bwd"  # its rows kernel and its column-sum kernel
# K1's backward kernel's profiler device times per launch before its
# redesign (this script's run on NVIDIA H100 80GB HBM3, 700.00 W, at the
# commit before it; PERF.md §6), keyed (path, rows, C, dtype): printed beside
# this run's
K1_BWD_PRIOR_MS = {
    ("train", 2_097_152, 64, "bfloat16"): 0.4414, ("train", 524_288, 128, "bfloat16"): 0.1931,
    ("train", 131_072, 256, "bfloat16"): 0.1127, ("train", 32_768, 512, "bfloat16"): 0.0924,
    ("serve", 524_288, 64, "float32"): 0.1523, ("serve", 131_072, 128, "float32"): 0.0766,
    ("serve", 32_768, 256, "float32"): 0.0447, ("serve", 8_192, 512, "float32"): 0.0297,
    ("vanilla", 524_288, 32, "bfloat16"): 0.0582, ("vanilla", 131_072, 64, "bfloat16"): 0.0356,
    ("vanilla", 32_768, 128, "bfloat16"): 0.0163, ("vanilla", 8_192, 256, "bfloat16"): 0.0096,
    ("vanilla", 2_048, 512, "bfloat16"): 0.0089, ("narrow", 524_288, 32, "float32"): 0.0762,
    ("narrow", 524_288, 16, "float32"): 0.0407, ("narrow", 524_288, 16, "bfloat16"): 0.0337,
    ("narrow", 524_283, 32, "float32"): 0.0762, ("narrow", 524_283, 32, "bfloat16"): 0.0576,
    ("narrow", 524_283, 16, "bfloat16"): 0.0342, ("deep", 524_288, 64, "bfloat16"): 0.1196,
    ("deep", 336_200, 128, "bfloat16"): 0.1287, ("deep", 215_168, 256, "bfloat16"): 0.1611,
    ("deep", 139_392, 512, "bfloat16"): 0.2356, ("deep", 89_888, 1024, "bfloat16"): 0.2686,
    ("deep", 57_800, 2048, "bfloat16"): 0.8426, ("wide", 89_888, 1024, "float32"): 0.3853,
    ("wide", 57_800, 2048, "float32"): 1.1469, ("wide", 89_885, 1024, "bfloat16"): 0.2687,
    ("wide", 89_885, 1024, "float32"): 0.3857, ("wide", 57_797, 2048, "bfloat16"): 0.8375,
    ("wide", 57_797, 2048, "float32"): 1.1541,
}
# the backward's row kernel is built for these (C, type) pairs
K1_BWD_INSTANCES = {(c, t) for c in fused_norm.SUPPORTED_CHANNELS for t in ("F32", "BF16")}
# K2 bf16 against its plain version: the absolute term beside one bf16 ulp,
# a few times the largest this script has read (its K2 lines print the term
# each run needs; PERF.md, "K2, the bf16 tolerance"). K1's bf16 keeps 1e-6.
K2_BF16_ATOL = 1e-5
K2_PER_CALL = sum(K2_SERVE.values())  # 4
TRAIN_BATCH, TRAIN_PATCH, TRAIN_STEPS, TIMED_STEPS = 32, 256, 6, 5

# The segmentation U-Nets at batch 8 x 256 px. The vanilla model (base 32,
# depth 4): (rows, C) -> LN+ReLU pairs per forward, and its 64->64 convs at
# 128 px (enc1.conv1, dec1.conv1). The protocol model (base 64, depth 4) has
# no LayerNorm; its enc0.conv1 and dec0.conv1 are K2's (8, 256, 256, 64).
K1_VANILLA = {(524_288, 32): 4, (131_072, 64): 4, (32_768, 128): 4, (8_192, 256): 4,
              (2_048, 512): 2}
K2_VANILLA = {(8, 128, 128, 64): 2}
K2_PROTOCOL = {(8, 256, 256, 64): 2}
# K1's narrow rows beside the vanilla path's bf16 ones: float32 at its C = 32
# level, C = 16 (a base-16 model's first level) and ragged row counts
K1_NARROW = [((524_288, 32), torch.float32), ((524_288, 16), torch.float32),
             ((524_288, 16), torch.bfloat16), ((524_283, 32), torch.float32),
             ((524_283, 32), torch.bfloat16), ((524_283, 16), torch.bfloat16)]
SEG_BATCH, SEG_SIZE, SEG_STEPS, SEG_LR = 8, 256, 8, 1e-3

# The deep config (scale 0.8, depth 5, base 64: 138,427,843 params) in bf16 at
# batch 8 x 256 px: its levels run at 256, 205, 164, 132 and 106 px and its
# bottleneck at 85 px, so K1 takes C = 64 ... 2048. (rows, C) -> LN+ReLU pairs
# per forward: enc and dec of each level, the head at level 0, the bottleneck.
DEEP_SCALE, DEEP_DEPTH, DEEP_BATCH, DEEP_STEPS = 0.8, 5, 8, 3
DEEP_PARAMS = 138_427_843
_DEEP_SIZES = [256]
for _ in range(DEEP_DEPTH):
    _DEEP_SIZES.append(scaled_size(_DEEP_SIZES[-1], DEEP_SCALE))
K1_DEEP = {(DEEP_BATCH * s * s, 64 << i): (6 if i == 0 else 2 if i == DEEP_DEPTH else 4)
           for i, s in enumerate(_DEEP_SIZES)}
K2_DEEP = {(DEEP_BATCH, 256, 256, 64): 4}
# K1 at C = 1024 and 2048 beside the deep path's bf16 rows: float32, and row
# counts that leave a block part-filled
K1_WIDE = ([((rows, c), torch.float32) for rows, c in K1_DEEP if c >= 1024]
           + [((rows - 3, c), dtype) for rows, c in K1_DEEP if c >= 1024
              for dtype in (torch.bfloat16, torch.float32)])
# launches per training step (K1, K1 backward, K2) without and with
# remat_levels=2: the recompute runs the forward of enc0/1 and dec0/1 again
DEEP_PER_STEP = {None: (24, 24, 4), 2: (32, 24, 6)}
# The streamed flagship: (K1, K1 backward, K2) per step, and the steps timed
STREAM_PER_STEP, STREAM_STEPS = (16, 16, 4), 20
# The vanilla SR U-Net (base 64, depth 4: 34,525,251 params) at batch 8 x 256
# px: no LayerNorm; enc0.conv1 and dec0.conv1 run K2
VANILLA_SR_PARAMS = 34_525_251
K2_VANILLA_SR = {(8, 256, 256, 64): 2}
# launches per step (K1, K1 backward, K2)
SEG_PER_STEP = {"protocol": (0, 0, sum(K2_PROTOCOL.values())),
                "vanilla": (sum(K1_VANILLA.values()), sum(K1_VANILLA.values()),
                            sum(K2_VANILLA.values()))}

# The joint SR + segmentation U-Net at train_joint's defaults (scale 0.5, base
# 64, 256 px: depth 4 from the depth policy, 50,273,348 params) in bf16 at
# batch 8 x 256 px: levels at 256, 128, 64 and 32 px, bottleneck at 16 px.
# (rows, C) -> LN+ReLU pairs per forward: enc, sr_dec and seg_dec of each
# level, the sr_head at level 0, the bottleneck. K2: enc0.conv1, sr_dec0.conv1,
# seg_dec0.conv1, sr_head.conv0 and .conv1 (the decoders' conv0 take the
# 128-channel concat, which K2's gate sends to cuDNN).
JOINT_PARAMS = 50_273_348
JOINT_BATCH, JOINT_SIZE, JOINT_STEPS = 8, 256, 6
K1_JOINT = {(524_288, 64): 8, (131_072, 128): 6, (32_768, 256): 6, (8_192, 512): 6,
            (2_048, 1024): 2}
K2_JOINT = {(JOINT_BATCH, 256, 256, 64): 5}
# The served joint forward runs K1 in float32 at K1_JOINT's rows: the serving
# checks hold the first four, and this one the bottleneck's
K1_JOINT_SERVED = {(2_048, 1024): K1_JOINT[(2_048, 1024)]}
# launches (K1, K1 backward, K2) per training step and per served forward
JOINT_PER_STEP = (sum(K1_JOINT.values()), sum(K1_JOINT.values()), sum(K2_JOINT.values()))
JOINT_PER_FORWARD = (JOINT_PER_STEP[0], 0, JOINT_PER_STEP[2])

# The tuner (adunet_torch.cli.tune): the vanilla SR U-Net (base 64, depth 4)
# trains in float32 at 256 px and batch 4, 8 or 16; enc0.conv1 and dec0.conv1
# run K2 at (B, 256, 256, 64), 2 launches per forward. Batch 8 is the serving
# row's shape; these are the two new ones.
TUNE_BATCHES = (4, 8, 16)
K2_TUNE = {(4, 256, 256, 64): 2, (16, 256, 256, 64): 2}
K2_TUNE_PER_FORWARD = 2
# 20 HR images: the tuner's seeded 0.8 / 0.2 split gives 16 train, 4 val
TUNE_IMAGES, TUNE_TRAIN, TUNE_VAL = 20, 16, 4
# lanes against single lanes: 8 train / 2 val pairs
TUNE_LANE_SPLIT = (8, 2)
TUNE_CONFIGS = [{"lr": 3e-4, "alpha": 1.0, "beta": 0.1, "gamma": 0.01},
                {"lr": 1e-4, "alpha": 1.7, "beta": 0.02, "gamma": 0.001},
                {"lr": 5e-5, "alpha": 0.6, "beta": 0.3, "gamma": 0.05}]
TUNE_RESULT_KEYS = {"direction", "sampler", "n_trials", "n_complete", "n_pruned", "best_value",
                    "best_params", "trials"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check_k1_bwd_spills(build_log: str) -> list[dict]:
    """Registers, stack frame and spills of each instantiation of K1's
    backward row kernel, from ptxas's report in the build log (``-Xptxas
    -v``: a "Function properties for <name>" line, then the stack and spill
    line, then the registers line). Raises if an instantiation is missing
    from the report or spills any bytes."""
    found, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        inst = re.search(r"layer_norm_relu_bwd_rows_kernelI\w*?_\d+(F32|BF16)ELi(\d+)E", name or "")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if inst and m:
            found[(int(inst.group(2)), inst.group(1))] = dict(
                C=int(inst.group(2)), type=inst.group(1), stack=int(m.group(1)),
                spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if inst and m and (int(inst.group(2)), inst.group(1)) in found:
            found[(int(inst.group(2)), inst.group(1))]["registers"] = int(m.group(1))
    rows = [found[k] for k in sorted(found)]
    for r in rows:
        log(f"[spill] K1 backward C={r['C']} {r['type']}: {r.get('registers')} registers, stack "
            f"{r['stack']} bytes, spill stores {r['spill_stores']} bytes, spill loads "
            f"{r['spill_loads']} bytes")
    if set(found) != K1_BWD_INSTANCES:
        raise AssertionError(f"ptxas reported K1 backward instantiations {sorted(found)}, "
                             f"expected {sorted(K1_BWD_INSTANCES)}")
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"K1 backward spills: {spilled}")
    return rows


def host_probe(phase: str) -> dict:
    """A fixed host workload's time and the host's load at the start of a
    phase: numpy sorts a seeded 2^18-element array, Python sums 200,000
    squares in a loop; the load average, the live Python threads and
    torch's CPU threads. A later phase whose probe runs slower than the
    first shows a host slowed by its neighbours or by this process."""
    arr = np.random.default_rng(0).random(1 << 18)
    t0 = time.perf_counter()
    np.sort(arr)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    total = 0
    for i in range(200_000):
        total += i * i
    python_ms = (time.perf_counter() - t0) * 1e3
    probe = {"phase": phase, "numpy_sort_ms": numpy_ms, "python_loop_ms": python_ms,
             "loadavg": list(os.getloadavg()), "threads": threading.active_count(),
             "torch_threads": torch.get_num_threads()}
    log(f"[host] {phase}: numpy sort {numpy_ms:.3f} ms, python loop {python_ms:.3f} ms, load "
        f"average {' / '.join(f'{v:.2f}' for v in probe['loadavg'])}, {probe['threads']} "
        f"Python threads, torch {probe['torch_threads']} CPU threads")
    return probe


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    """Self device microseconds of a profiler average (names vary by version)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled_device_ms(fn, kernel_name: str | None = None, iters: int = 20,
                       per_run: int = 1) -> tuple[float | None, int]:
    """Device time per run of ``fn`` over ``iters`` runs under
    ``torch.profiler`` (no host cost included), and the number of kernel
    launches the profiler recorded: of the kernels whose names contain
    ``kernel_name``, which launch ``per_run`` times per run, or of every
    kernel.

    The tracer sometimes drops records, a few launches or a whole session.
    Such a session is repeated, up to 3 times in all. A named kernel's time
    comes only from a session that recorded each of its ``iters * per_run``
    launches, the time of every kernel from a session that recorded any.
    If none did, the time is None ("not measured"); no host-clock time ever
    stands in for it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    want = iters * per_run
    count = 0
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")
                and (kernel_name is None or kernel_name in e.key)]
        count = sum(e.count for e in hits)
        if kernel_name is not None and count > want:
            raise AssertionError(f"profiler saw {count} launches of {kernel_name}, expected {want}")
        if hits and (kernel_name is None or count == want):
            return sum(_device_us(e) for e in hits) / iters / 1e3, count
    log(f"[profiler] 3 sessions recorded {count} launches of {kernel_name or 'any kernel'} "
        f"(made {want if kernel_name else 'some'}): device time not measured")
    return None, count


def _ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def close_enough(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype, atol_f32: float,
                 atol_bf16: float = 1e-6) -> float:
    """Max |got - want|; raises past the tolerance. float32: ``atol_f32``
    (another summation / rsqrt order). bf16: one bf16 ulp relative (2^-7)
    plus ``atol_bf16``, since an f32 difference in the last bits can flip
    the rounding to bf16."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    err = (g - w).abs()
    limit = atol_f32 if dtype == torch.float32 else (2.0**-7) * w.abs() + atol_bf16
    if not bool(torch.all(err <= limit)) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"kernel disagrees with its plain version: max |err| {err.max().item():.3e}")
    return err.max().item()


def grad_close(what: str, got: torch.Tensor, want: torch.Tensor, rel: float) -> float:
    """Max |got - want| / max |want|; raises past ``rel`` or past one bf16 ulp
    relative per element plus ``rel * max|want|`` for bf16 tensors."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    scale = w.abs().max().clamp_min(1e-30)
    err = (g - w).abs()
    ulp = (2.0**-7) * w.abs() if got.dtype == torch.bfloat16 else 0.0
    if got.dtype != want.dtype or not bool(torch.all(err <= ulp + rel * scale)) \
            or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: gradient disagrees with autograd through the plain "
                             f"version: max |err| / max |want| {(err.max() / scale).item():.3e}")
    return (err.max() / scale).item()


def bound_ms(bytes_moved: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dname(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


def _k1_inputs(gen, rows, c, dtype):
    x = torch.randn(rows, c, generator=gen, device="cuda").mul_(2.0).add_(0.3).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda").mul_(0.1).add_(1.0)
    b = torch.randn(c, generator=gen, device="cuda").mul_(0.1)
    return x, g, b


def _k2_inputs(gen, shape, dtype):
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    wt = (torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05).to(dtype)
    bias = (torch.randn(64, generator=gen, device="cuda") * 0.1).to(dtype)
    return x, wt, bias


def _k1_cases():
    return ([(s, n, torch.float32, "serve") for s, n in K1_SERVE.items()]
            + [(s, n, torch.bfloat16, "serve") for s, n in K1_SERVE.items()]
            + [(s, n, torch.bfloat16, "train") for s, n in K1_TRAIN.items()]
            + [(s, n, torch.bfloat16, "vanilla") for s, n in K1_VANILLA.items()]
            + [(s, 0, dtype, "narrow") for s, dtype in K1_NARROW]
            + [(s, n, torch.bfloat16, "deep") for s, n in K1_DEEP.items()]
            + [(s, 0, dtype, "wide") for s, dtype in K1_WIDE]
            + [(s, n, torch.bfloat16, "joint") for s, n in K1_JOINT.items()]
            + [(s, n, torch.float32, "joint_served") for s, n in K1_JOINT_SERVED.items()])


def _k1_bwd_cases():
    return ([(s, n, torch.bfloat16, "train") for s, n in K1_TRAIN.items()]
            + [(s, n, torch.float32, "serve") for s, n in K1_SERVE.items()]
            + [(s, n, torch.bfloat16, "vanilla") for s, n in K1_VANILLA.items()]
            + [(s, 0, dtype, "narrow") for s, dtype in K1_NARROW]
            + [(s, n, torch.bfloat16, "deep") for s, n in K1_DEEP.items()]
            + [(s, 0, dtype, "wide") for s, dtype in K1_WIDE]
            + [(s, n, torch.bfloat16, "joint") for s, n in K1_JOINT.items()])


def _k2_cases():
    return ([(s, n, torch.float32, "serve") for s, n in K2_SERVE.items()]
            + [(s, n, torch.bfloat16, "serve") for s, n in K2_SERVE.items()]
            + [(s, n, torch.bfloat16, "train") for s, n in K2_TRAIN.items()]
            + [(s, n, dtype, "vanilla") for s, n in K2_VANILLA.items()
               for dtype in (torch.bfloat16, torch.float32)]
            + [(s, n, torch.float32, "tune") for s, n in K2_TUNE.items()])


def check_k1(gen: torch.Generator) -> list[dict]:
    rows_out = []
    for (rows, c), per_call, dtype, path in _k1_cases():
        x, g, b = _k1_inputs(gen, rows, c, dtype)
        got = fused_norm.layer_norm_relu(x, g, b)
        want = fused_norm.layer_norm_relu_plain(x, g, b)
        torch.cuda.synchronize()
        err = close_enough(got, want, dtype, 1e-5)
        # elements within a rounding of 0 that one ReLU keeps and the other zeroes
        n_flip = int(((got > 0) != (want > 0)).sum())
        gl, bl = g.to(dtype), b.to(dtype)
        ms = cuda_ms(lambda: fused_norm.layer_norm_relu(x, g, b), 50)
        dev_ms, dev_n = profiled_device_ms(lambda: fused_norm.layer_norm_relu(x, g, b),
                                           "layer_norm_relu_kernel")
        plain = cuda_ms(lambda: fused_norm.layer_norm_relu_plain(x, g, b), 10)
        lib = cuda_ms(lambda: F.relu(F.layer_norm(x, (c,), gl, bl, 1e-3)), 50)
        lib_dev, lib_n = profiled_device_ms(lambda: F.relu(F.layer_norm(x, (c,), gl, bl, 1e-3)))
        es = x.element_size()
        bnd, by = bound_ms(2 * rows * c * es + 2 * c * 4, 9 * rows * c, dtype)
        rows_out.append(dict(kernel="K1", path=path, shape=[rows, c], dtype=_dname(dtype),
                             per_call=per_call, max_abs_err=err, mask_disagreements=n_flip,
                             ms=ms, device_ms=dev_ms,
                             device_launches_recorded=dev_n, plain_ms=plain, library_ms=lib,
                             library_device_ms=lib_dev, library_kernels_recorded=lib_n,
                             bound_ms=bnd, bound_by=by))
        log(f"[K1] {path} rows={rows} C={c} {dtype}: max|err|={err:.2e}, mask disagreements "
            f"{n_flip}; kernel {ms:.4f} ms "
            f"(events; profiler device time {_ms(dev_ms)} over {dev_n} launches), plain "
            f"{plain:.4f} ms, F.layer_norm+relu {lib:.4f} ms (device time {_ms(lib_dev)}), "
            f"bound {bnd:.4f} ms ({by})")
        del x, got, want
    return rows_out


def _k2_bound(shape, dtype) -> tuple[float, str]:
    bsz, h, w, c = shape
    pixels = bsz * h * w
    es = torch.empty((), dtype=dtype).element_size()
    return bound_ms(2 * pixels * c * es + 9 * 64 * 64 * 4 + 64 * 4,
                    2 * pixels * 64 * 64 * 9 + pixels * 64, dtype)


def check_k2(gen: torch.Generator) -> list[dict]:
    rows_out = []
    for shape, per_call, dtype, path in _k2_cases():
        x, wt, bias = _k2_inputs(gen, shape, dtype)
        got = conv64.conv3x3_same(x, wt, bias)
        want = conv64.conv3x3_same_plain(x, wt, bias)
        torch.cuda.synchronize()
        # bf16: the tensor cores and cuBLAS add the 576 float32 products in
        # other orders, so an output near 0, where one bf16 ulp is tiny,
        # keeps their float32 difference: one bf16 ulp plus K2_BF16_ATOL
        err = close_enough(got, want, dtype, 1e-4, atol_bf16=K2_BF16_ATOL)
        extra = {}
        if dtype == torch.bfloat16:  # the absolute term this comparison needs
            excess = (got.float() - want.float()).abs() - (2.0**-7) * want.float().abs()
            extra = {"abs_term_needed": max(float(excess.max()), 0.0),
                     "past_1e-6": int((excess > 1e-6).sum()), "elements": excess.numel()}
            del excess
        ms = cuda_ms(lambda: conv64.conv3x3_same(x, wt, bias), 20)
        dev_ms, dev_n = profiled_device_ms(lambda: conv64.conv3x3_same(x, wt, bias),
                                           K2_KERNEL[dtype])
        plain = cuda_ms(lambda: conv64.conv3x3_same_plain(x, wt, bias), 5)
        xn = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        lib = cuda_ms(lambda: F.conv2d(xn, wt, bias, padding=1), 20)
        lib_dev, lib_n = profiled_device_ms(lambda: F.conv2d(xn, wt, bias, padding=1))
        bnd, by = _k2_bound(shape, dtype)
        rows_out.append(dict(kernel="K2", path=path, shape=list(shape), dtype=_dname(dtype),
                             per_call=per_call, max_abs_err=err, **extra, ms=ms,
                             device_ms=dev_ms, device_launches_recorded=dev_n, plain_ms=plain,
                             library_ms=lib, library_device_ms=lib_dev,
                             library_kernels_recorded=lib_n, bound_ms=bnd, bound_by=by))
        needed = (f" (absolute term needed {extra['abs_term_needed']:.3e}; {extra['past_1e-6']} "
                  f"of {extra['elements']} past 1e-6)" if extra else "")
        log(f"[K2] {path} x={'x'.join(map(str, shape))} {dtype}: max|err|={err:.2e}{needed} "
            f"kernel {ms:.4f} ms (events; profiler device time {_ms(dev_ms)} over {dev_n} "
            f"launches), plain {plain:.4f} ms, F.conv2d (cuDNN, TF32 off) {lib:.4f} ms (device "
            f"time {_ms(lib_dev)}), bound {bnd:.4f} ms ({by})")
        del x, got, want
    return rows_out


def _k1_flips(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Where K1's ReLU mask on the card (the forward kernel's, which its
    backward kernel shares) differs from the plain forward's."""
    with torch.no_grad():
        return ((fused_norm.layer_norm_relu(x, gamma, beta) > 0)
                != (fused_norm.layer_norm_relu_plain(x, gamma, beta) > 0))


def k1_dx_close(what: str, got: torch.Tensor, want: torch.Tensor, flips: torch.Tensor,
                rel: float) -> tuple[float, float, int, int]:
    """K1's dx against the plain backward's: (max |err| / max |want|, max
    |err|, elements whose masks disagree, rows left out). The kernel's
    float32 warp sums round otherwise than torch's ``mean``, so an element
    within a rounding of 0 can be in one ReLU mask and not in the other. At
    most 1e-5 of the elements may disagree. Such an element moves its row's
    two means, and so every dx of the row: the rows that hold one are left
    out of the tolerance (``grad_close``) and counted."""
    c = got.shape[-1]
    flat = flips.reshape(-1, c)
    n_flip = int(flat.sum())
    if n_flip > 1e-5 * flat.numel():
        raise AssertionError(f"{what}: {n_flip} of {flat.numel()} ReLU mask elements disagree")
    keep = ~flat.any(dim=1)
    g, w = got.reshape(-1, c)[keep], want.reshape(-1, c)[keep]
    err = grad_close(what, g, w, rel)
    return err, float((g.float() - w.float()).abs().max()), n_flip, int((~keep).sum())


def k1_params_close(what: str, got, want, flips: torch.Tensor, rerun) -> tuple[float, float]:
    """K1's dgamma / dbeta against the plain backward's at 1e-3 relative. An
    element on which the two ReLU masks disagree moves its column's sums by
    its cotangent, so where any does, both are computed again over the rows
    without one (``rerun(keep) -> (got, want)``, each a (dgamma, dbeta)
    pair): the masks are row-local, so those rows agree."""
    if bool(flips.any()):
        keep = ~flips.reshape(-1, flips.shape[-1]).any(dim=1)
        got, want = rerun(keep)
    return (grad_close(what + " dgamma", got[0], want[0], 1e-3),
            grad_close(what + " dbeta", got[1], want[1], 1e-3))


def check_k1_backward(gen: torch.Generator) -> list[dict]:
    """K1's backward kernel against ``layer_norm_relu_backward`` on the same
    CUDA tensors, at every training (bf16) and serving (float32) shape, and
    its time beside its bytes bound, the plain backward's and the library's
    backward (autograd through ``F.layer_norm`` + ``relu``, graph kept).
    Tolerances as ``check_backward``'s: dx 1e-5 (float32) / 1e-4 plus one
    bf16 ulp (bf16) of max |dx| outside the rows with a mask disagreement;
    dgamma / dbeta 1e-3 relative (float32 sums over up to 2,097,152 rows in
    another order), over the rows without a mask disagreement where there is
    one (``k1_params_close``). dgamma / dbeta must be bit-identical over two
    runs."""
    rows_out = []
    for (rows, c), per_call, dtype, path in _k1_bwd_cases():
        x, a, b = _k1_inputs(gen, rows, c, dtype)
        gy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)

        def bwd():
            return fused_norm._launch_backward(x, a, b, gy, 1e-3)

        got = bwd()
        want = fused_norm.layer_norm_relu_backward(x, a, b, gy)
        flips = _k1_flips(x, a, b)
        again = bwd()
        torch.cuda.synchronize()
        what = f"K1 backward {path} {rows}x{c} {dtype}"
        dx_rel, dx_abs, n_flip, n_out = k1_dx_close(
            what + " dx", got[0], want[0], flips, 1e-5 if dtype == torch.float32 else 1e-4)
        dg_rel, db_rel = k1_params_close(
            what, got[1:], want[1:], flips,
            lambda keep: (fused_norm._launch_backward(x[keep], a, b, gy[keep], 1e-3)[1:],
                          fused_norm.layer_norm_relu_backward(x[keep], a, b, gy[keep])[1:]))
        if not (torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])):
            raise AssertionError(f"{what}: dgamma / dbeta differ between two runs")
        del got, want, again, flips
        ms = cuda_ms(bwd, 20)
        dev_ms, dev_n = profiled_device_ms(bwd, K1_BWD_KERNEL, per_run=2)
        plain = cuda_ms(lambda: fused_norm.layer_norm_relu_backward(x, a, b, gy), 3)
        xl = x.detach().requires_grad_(True)
        al, bl = (t.to(dtype).requires_grad_(True) for t in (a, b))
        yl = F.relu(F.layer_norm(xl, (c,), al, bl, 1e-3))

        def lib_bwd():
            return torch.autograd.grad(yl, [xl, al, bl], gy, retain_graph=True)

        lib = cuda_ms(lib_bwd, 20)
        lib_dev, lib_n = profiled_device_ms(lib_bwd)
        # read x and g, write dx, plus gamma / beta and their gradients; the
        # arithmetic is float32 whatever the storage type
        bnd, by = bound_ms(3 * rows * c * x.element_size() + 4 * c * 4, 20 * rows * c,
                           torch.float32)
        prior = K1_BWD_PRIOR_MS.get((path, rows, c, _dname(dtype)))
        rows_out.append(dict(kernel="K1_bwd", path=path, shape=[rows, c], dtype=_dname(dtype),
                             per_call=per_call, max_abs_err=dx_abs,
                             rel_err={"dx": dx_rel, "dgamma": dg_rel, "dbeta": db_rel},
                             mask_disagreements=n_flip, rows_left_out=n_out, ms=ms,
                             device_ms=dev_ms, device_launches_recorded=dev_n, plain_ms=plain,
                             library_ms=lib, library_device_ms=lib_dev,
                             library_kernels_recorded=lib_n, bound_ms=bnd, bound_by=by,
                             prior_device_ms=prior))
        log(f"[K1 bwd] {path} rows={rows} C={c} {dtype}: rel err dx {dx_rel:.1e} (max |err| "
            f"{dx_abs:.2e}), dgamma {dg_rel:.1e}, dbeta {db_rel:.1e}; mask disagreements "
            f"{n_flip} ({n_out} rows left out); kernel {ms:.4f} ms (events; profiler device "
            f"time {_ms(dev_ms)} over {dev_n} launches; before the redesign {_ms(prior)}), "
            f"plain {plain:.4f} ms, library backward {lib:.4f} ms (device time {_ms(lib_dev)}), "
            f"bound {bnd:.4f} ms ({by})")
        del x, gy, xl, yl
        torch.cuda.empty_cache()
    return rows_out


def _fwd_bwd(fn, inputs, cotangent):
    return torch.autograd.grad(fn(*inputs), [t for t in inputs if t is not None], cotangent)


def check_backward(gen: torch.Generator) -> list[dict]:
    """Each Function's gradients against autograd through its plain version.

    Tolerances, relative to the largest |gradient| of the tensor: dx 1e-5
    (float32) / 1e-4 (bf16, plus one bf16 ulp per element: the two
    formulas round to bf16 from float32 values that differ in the last
    bits); parameter gradients 1e-3 (float32 sums over up to 2,097,152 rows
    or pixels in another order, plus one bf16 ulp for K2's bf16 dw / db).
    K2's float32 dx / dw come from cuDNN (TF32 off), whose FFT and Winograd
    algorithms keep ~1e-5 relative, so dx is held at 1e-4 there. K1's dx is
    compared outside the rows where the kernel's and the plain forward's ReLU
    masks disagree (``k1_dx_close``)."""
    out = []
    cases = [("K1", s, torch.bfloat16, "train") for s in K1_TRAIN] \
        + [("K1", s, torch.float32, "serve") for s in K1_SERVE] \
        + [("K1", (524_288, 32), torch.bfloat16, "vanilla")] \
        + [("K2", s, torch.bfloat16, "train") for s in K2_TRAIN] \
        + [("K2", s, torch.float32, "serve") for s in K2_SERVE] \
        + [("K2", s, torch.bfloat16, "vanilla") for s in K2_VANILLA] \
        + [("K2", s, torch.float32, "tune") for s in K2_TUNE]
    for kid, shape, dtype, path in cases:
        if kid == "K1":
            x, a, b = _k1_inputs(gen, *shape, dtype)
            fn, plain = fused_norm.layer_norm_relu, fused_norm.layer_norm_relu_plain
            names, rels = ("dx", "dgamma", "dbeta"), (1e-5 if dtype == torch.float32 else 1e-4, 1e-3, 1e-3)

            def lib_fn(x_, a_, b_, c=shape[1]):
                return F.relu(F.layer_norm(x_, (c,), a_.to(x_.dtype), b_.to(x_.dtype), 1e-3))
        else:
            x, a, b = _k2_inputs(gen, shape, dtype)
            fn, plain = conv64.conv3x3_same, conv64.conv3x3_same_plain
            names, rels = ("dx", "dw", "db"), (1e-4, 1e-3, 1e-3)

            def lib_fn(x_, a_, b_):
                return F.conv2d(x_.permute(0, 3, 1, 2), a_, b_, padding=1).permute(0, 2, 3, 1)
        inputs = [t.requires_grad_(True) for t in (x, a, b)]
        gy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        got = _fwd_bwd(fn, inputs, gy)
        want = _fwd_bwd(plain, inputs, gy)
        torch.cuda.synchronize()
        if kid == "K1":  # dx, dgamma, dbeta outside the rows where the ReLU masks disagree
            flips = _k1_flips(x.detach(), a.detach(), b.detach())
            errs = {"dx": k1_dx_close(f"K1 {path} dx", got[0], want[0], flips, rels[0])[0]}

            def rerun(keep):
                sub = [x.detach()[keep].requires_grad_(True), a, b]
                return (_fwd_bwd(fn, sub, gy[keep])[1:], _fwd_bwd(plain, sub, gy[keep])[1:])

            errs["dgamma"], errs["dbeta"] = k1_params_close(f"K1 {path}", got[1:], want[1:],
                                                            flips, rerun)
            del flips
        else:
            errs = {"dx": grad_close(f"K2 {path} dx", got[0], want[0], rels[0])}
            errs.update({n: grad_close(f"{kid} {path} {n}", g_, w_, r)
                         for n, g_, w_, r in zip(names[1:], got[1:], want[1:], rels[1:])})
        del got, want
        ms = cuda_ms(lambda: _fwd_bwd(fn, inputs, gy), 10)
        plain_ms = cuda_ms(lambda: _fwd_bwd(plain, inputs, gy), 3)
        lib_ms = cuda_ms(lambda: _fwd_bwd(lib_fn, inputs, gy), 10)
        out.append(dict(kernel=kid, path=path, shape=list(shape), dtype=_dname(dtype),
                        rel_err=errs, fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain_ms,
                        library_fwd_bwd_ms=lib_ms))
        log(f"[{kid} grad] {path} {list(shape)} {dtype}: rel err "
            + ", ".join(f"{n} {e:.1e}" for n, e in errs.items())
            + f"; forward+backward {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms")
        del inputs, x, a, b, gy
        torch.cuda.empty_cache()
    return out


def _post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))


def _zero_counts() -> None:
    fused_norm.layer_norm_relu.launches = 0
    fused_norm.layer_norm_relu.backward_launches = 0
    conv64.conv3x3_same.launches = 0


def _counts() -> tuple[int, int, int]:
    """Launches of K1's forward, K1's backward and K2."""
    return (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
            conv64.conv3x3_same.launches)


def serve_flagship(call) -> dict:
    """The serving path: the HTTP server over the flagship artifact on the card."""
    _zero_counts()
    server = make_server(str(ARTIFACT), port=0, batch_window_ms=200.0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(0)
    single = rng.random((256, 256, 3), dtype=np.float32)
    stack = rng.random((3, 256, 256, 3), dtype=np.float32)
    conc = rng.random((8, 256, 256, 3), dtype=np.float32)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        out_single = _post_npy(base + "/v1/predict", single)
        out_stack = _post_npy(base + "/v1/predict", stack)
        results: list = [None] * 8
        errors: list = []

        def worker(i: int) -> None:
            try:
                results[i] = _post_npy(base + "/v1/predict", conc[i])
            except Exception as exc:  # reported below: the phase fails
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"concurrent requests failed: {errors}")
        with urllib.request.urlopen(base + "/v1/metadata", timeout=30) as r:
            stats = json.load(r)["serving"]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    k1, k1b, k2 = _counts()
    calls = stats["device_calls"]
    log(f"[serve] stats {stats}; K1 launches {k1}, K2 launches {k2}, K1 backward {k1b}")
    if calls < 1 or k1 != K1_PER_CALL * calls or k2 != K2_PER_CALL * calls or k1b:
        raise AssertionError(f"expected {K1_PER_CALL} K1 and {K2_PER_CALL} K2 launches per "
                             f"device call; got {k1} and {k2} over {calls} calls")
    if stats["images"] != 12 or stats["batched_rows"] != 12:
        raise AssertionError(f"server saw {stats}, expected 12 images")

    def direct(x: np.ndarray) -> np.ndarray:
        padded = np.zeros((8, 256, 256, 3), np.float32)
        padded[: len(x)] = x
        return call(padded)[: len(x)]

    worst = max(
        np.abs(out_single - direct(single[None])).max(),
        np.abs(out_stack - direct(stack)).max(),
        max(np.abs(results[i][0] - direct(conc[i : i + 1])[0]).max() for i in range(8)),
    )
    if not worst <= 1e-5:
        raise AssertionError(f"served answers differ from the direct call by {worst:.3e}")
    log(f"[serve] 12 images over {calls} device calls; max |served - direct| {worst:.2e}")
    return {"launches": {"K1": k1, "K1_bwd": k1b, "K2": k2}, "device_calls": calls}


def _synth():
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_synth_corpus import synth_image

    return synth_image


def golden(call) -> dict:
    """The flagship's pinned eval numbers, re-derived on the card."""
    synth_image = _synth()
    pinned = json.loads(PINNED.read_text())
    rng = np.random.default_rng(777)
    tiles = []
    for _ in range(12):
        img = synth_image(rng, 512)
        img = np.round(img * 255).astype(np.uint8).astype(np.float32) / 255.0
        for ty in range(0, 512, 256):
            for tx in range(0, 512, 256):
                tiles.append(img[ty : ty + 256, tx : tx + 256])
    tiles = np.stack(tiles)
    shave = infer_eval_shave(0.5)
    pf = msssim_power_factors_for(256 - 2 * shave)
    p, s, m = [], [], []
    for i in range(0, len(tiles), 8):
        hr = torch.from_numpy(tiles[i : i + 8]).cuda()
        lr = degrade(hr, 0.5, 256)
        pred = torch.from_numpy(call(lr.cpu().numpy())).cuda()
        hr_y = rgb_to_luma_bt601(hr)[:, shave:-shave, shave:-shave]
        pr_y = rgb_to_luma_bt601(pred)[:, shave:-shave, shave:-shave]
        p.append(psnr(hr_y, pr_y))
        s.append(ssim(hr_y, pr_y))
        m.append(ssim_multiscale(hr_y, pr_y, power_factors=pf))
    got = {k: float(torch.cat(v).double().mean()) for k, v in
           (("psnr_mean", p), ("ssim_mean", s), ("msssim_mean", m))}
    log(f"[golden] 48 tiles: PSNR(Y) {got['psnr_mean']:.4f} dB (pinned {pinned['psnr_mean']:.4f}), "
        f"SSIM {got['ssim_mean']:.6f} ({pinned['ssim_mean']:.6f}), "
        f"MS-SSIM {got['msssim_mean']:.6f} ({pinned['msssim_mean']:.6f})")
    if (abs(got["psnr_mean"] - pinned["psnr_mean"]) > 0.15
            or abs(got["ssim_mean"] - pinned["ssim_mean"]) > 2e-3
            or abs(got["msssim_mean"] - pinned["msssim_mean"]) > 2e-3):
        raise AssertionError(f"golden mismatch: {got} vs {pinned}")
    return got


def forward_speed(call, ident: str) -> dict:
    model = call.model
    x = torch.rand(8, 256, 256, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model(x), 20)
    xs = x.cpu().numpy()
    call(xs)
    t0 = time.perf_counter()
    for _ in range(10):
        call(xs)
    e2e = (time.perf_counter() - t0) / 10 * 1e3
    log(f"[speed] {ident}: flagship forward, batch 8 x 256 px, f32: {fwd:.3f} ms on the card "
        f"({8e3 / fwd:.1f} img/s); call() numpy in/out {e2e:.3f} ms ({8e3 / e2e:.1f} img/s)")
    return {"forward_ms": fwd, "img_per_s": 8e3 / fwd, "call_ms": e2e}


def write_corpus(directory: Path, n: int, size: int, seed: int) -> list[str]:
    """``n`` synthetic uint8 ``.npy`` images (``make_synth_corpus.synth_image``)."""
    synth_image = _synth()
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        img = np.round(synth_image(rng, size) * 255).astype(np.uint8)
        path = directory / f"synth{i:03d}.npy"
        np.save(path, img)
        paths.append(str(path))
    return paths


def train_flagship(tmp: Path, ident: str) -> dict:
    """The training path: device-cache steps of the bf16 flagship at batch 32."""
    from adunet_torch.data import load_device_cache
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import create_train_state, make_optimizer, make_sr_device_cache_train_step

    corpus_dir = tmp / "cache"
    corpus_dir.mkdir()
    cache = load_device_cache(write_corpus(corpus_dir, 16, 512, seed=5), "cuda")
    model, info = build_super_resolution_unet(0.5, depth_override=3, dtype=torch.bfloat16,
                                              device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 8_637_379:
        raise AssertionError(f"flagship has {n_params} params, expected 8,637,379")
    # The zero-init 1x1 head makes a fresh model the identity: the first
    # step then sends gradient to the head alone, and a few steps at lr 1e-4
    # barely move the identity's loss. A seeded random head (std 0.01) starts
    # from a residual that the step must learn to shrink, so a cut autograd
    # edge or a wrong update shows within the first steps. The train_sr phase
    # below trains from the zero head.
    with torch.no_grad():
        model.residual_rgb.weight.normal_(0.0, 0.01, generator=torch.Generator("cuda").manual_seed(1))
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_sr_device_cache_train_step(model, charbonnier_loss, cache,
                                           patch_size=TRAIN_PATCH, batch_size=TRAIN_BATCH)
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    losses = []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, None, gen)
        losses.append(metrics["loss"])
        if i == 0:
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())
                   or not bool(p.grad.abs().max() > 0)]
            if bad:
                raise AssertionError(f"parameters without a finite nonzero gradient: {bad}")
    torch.cuda.synchronize()
    k1, k1b, k2 = _counts()
    if (k1, k1b, k2) != (16 * TRAIN_STEPS, 16 * TRAIN_STEPS, 4 * TRAIN_STEPS):
        raise AssertionError(f"expected {16 * TRAIN_STEPS} K1, {16 * TRAIN_STEPS} K1 backward "
                             f"and {4 * TRAIN_STEPS} K2 launches over {TRAIN_STEPS} steps; "
                             f"got {k1}, {k1b} and {k2}")
    losses = [float(v) for v in losses]
    log(f"[train] {TRAIN_STEPS} steps, losses {', '.join(f'{v:.5f}' for v in losses)}; "
        f"every parameter had a finite nonzero gradient after step 1; K1 {k1}, K1 backward "
        f"{k1b}, K2 {k2} launches")
    # each step samples its own patches; the drop from the random head's
    # residual is far larger than the spread between batches
    if not all(np.isfinite(losses)) or not losses[-1] < 0.75 * losses[0]:
        raise AssertionError(f"the training loss did not fall by a quarter: {losses}")
    ms = cuda_ms(lambda: step(state, None, gen), TIMED_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {ident}: flagship bf16 train step, batch {TRAIN_BATCH} x {TRAIN_PATCH} px, "
        f"device cache: {ms:.3f} ms/step ({TRAIN_BATCH * 1e3 / ms:.1f} img/s); "
        f"peak device memory {peak_gb:.2f} GB")
    del cache, state, model
    torch.cuda.empty_cache()
    return {"launches": {"K1": k1, "K1_bwd": k1b, "K2": k2}, "steps": TRAIN_STEPS,
            "losses": losses,
            "ms_per_step": ms,
            "img_per_s": TRAIN_BATCH * 1e3 / ms, "peak_gb": peak_gb, "depth": info["depth"]}


def card_vs_cpu_step() -> dict:
    """One float32 step of the flagship at batch 1, on the card and on the CPU
    (plain versions), from the same params and HR tile.

    Tolerances: loss 1e-5 relative; each parameter's gradient 1e-3 in
    relative L2 norm (float32 convolutions summed in other orders; cuDNN's
    FFT / Winograd algorithms keep ~1e-5 relative); updated params within
    2 x lr, with fewer than 0.1 % of elements apart by more than lr / 2
    (Adam's first update is ~lr * sign(grad), so a near-zero gradient that
    differs in sign costs up to 2 x lr)."""
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step

    lr = 1e-4
    cpu_model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cpu", seed=3)
    with torch.no_grad():  # break the identity start
        pgen = torch.Generator().manual_seed(4)
        for p in cpu_model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=pgen))
    gpu_model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    img = _synth()(np.random.default_rng(21), 256)[None]
    hr = np.round(img * 255).astype(np.uint8)
    out = {}
    for name, model in (("card", gpu_model), ("cpu", cpu_model)):
        state = create_train_state(model, make_optimizer(model.parameters(), lr))
        t0 = time.perf_counter()
        _, metrics = make_sr_train_step(model, charbonnier_loss)(state, hr)
        out[name] = {"loss": float(metrics["loss"]), "seconds": time.perf_counter() - t0,
                     "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
    loss_rel = abs(out["card"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"])
    grad_rel = max(float((out["card"]["grads"][n] - g).norm() / g.norm().clamp_min(1e-30))
                   for n, g in out["cpu"]["grads"].items())
    diffs = torch.cat([(out["card"]["params"][n] - p).abs().flatten()
                       for n, p in out["cpu"]["params"].items()])
    far = float((diffs > lr / 2).float().mean())
    log(f"[f32 step] batch 1 x 256 px: loss card {out['card']['loss']:.7f} / CPU "
        f"{out['cpu']['loss']:.7f} (rel {loss_rel:.1e}); worst gradient rel L2 {grad_rel:.1e}; "
        f"updated params max |diff| {float(diffs.max()):.2e}, share > lr/2 {far:.2e}; "
        f"CPU step {out['cpu']['seconds']:.1f} s")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-3 and float(diffs.max()) <= 2 * lr + 1e-6
            and far < 1e-3):
        raise AssertionError("the card's float32 step disagrees with the CPU's")
    return {"loss_rel": loss_rel, "grad_rel_l2": grad_rel, "param_max_diff": float(diffs.max()),
            "param_far_share": far}


def train_entry_point(tmp: Path) -> dict:
    """``adunet_torch.cli.train_sr.main`` for 2 short epochs at flagship width."""
    from adunet_torch.cli.train_sr import main as train_main
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer
    from adunet_torch.models import build_super_resolution_unet

    corpus_dir = tmp / "cli_corpus"
    corpus_dir.mkdir()
    write_corpus(corpus_dir, 10, 512, seed=8)  # 8 train / 1 val / 1 test images
    epochs, ppi = 2, 8  # 8 x 8 patches -> 2 steps of 32 per epoch
    args = ["--scale", "0.5", "--depth_override", "3", "--device_cache", "--mixed_precision",
            "--batch_size", "32", "--patch_size", "256", "--patches_per_image", str(ppi),
            "--epochs", str(epochs), "--high_res_dir", str(corpus_dir), "--image_suffix", ".npy",
            "--model_dir", str(tmp / "models"), "--log_dir", str(tmp / "logs"),
            "--run_name", "smoke", "--seed", "11"]
    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = train_main(args)
    seconds = time.perf_counter() - t0
    k1, k1b, k2 = _counts()
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"[train_sr] {line}")
    run_dir = tmp / "logs" / "smoke"
    ckpt_dir = Path(result["ckpt_dir"])
    cfg = json.loads((run_dir / "config.json").read_text())
    rows = (run_dir / "epoch_metrics.csv").read_text().strip().splitlines()
    steps = epochs * cfg["steps_per_epoch"]
    forwards = steps + epochs * 1 + 2  # train, val (4 tiles), eval
    if (k1, k1b, k2) != (16 * forwards, 16 * steps, 4 * forwards):
        raise AssertionError(f"train_sr: expected {16 * forwards} K1 / {16 * steps} K1 backward "
                             f"/ {4 * forwards} K2 launches, got {k1} / {k1b} / {k2}")
    if (cfg["steps_per_epoch"], cfg["n_params"], len(rows)) != (2, 8_637_379, epochs + 1):
        raise AssertionError(f"train_sr wrote {cfg['steps_per_epoch']} steps/epoch, "
                             f"{cfg['n_params']} params, {len(rows)} CSV lines")
    if printed.count("PSNR(Y)") != 2 or "Validation patches evaluated: 4" not in printed \
            or "Test patches evaluated: 4" not in printed:
        raise AssertionError("train_sr did not print the Validation / Test PSNR(Y) lines")
    ckpt = CheckpointManager(ckpt_dir)
    best, latest = ckpt.best_step(), ckpt.latest_step()
    if latest != epochs or best is None or not (ckpt_dir / "config.json").exists():
        raise AssertionError(f"checkpoints: best {best}, latest {latest}")
    live = result["state"].model.state_dict()
    matches = {}
    for which, restore in (("best", ckpt.restore_best), ("latest", ckpt.restore_latest)):
        fresh_model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=torch.bfloat16,
                                                     device="cuda", seed=99)
        fresh = create_train_state(fresh_model, make_optimizer(fresh_model.parameters(), 1e-4))
        restore(fresh)
        matches[which] = all(torch.equal(fresh_model.state_dict()[n], v) for n, v in live.items())
    # fit restores the best epoch's weights; the latest checkpoint holds them
    # too exactly when the best epoch is the last
    if not matches["best"] or matches["latest"] != (best == latest):
        raise AssertionError(f"restored checkpoints vs live params: {matches} (best {best}, "
                             f"latest {latest})")
    log(f"[train_sr] {epochs} epochs in {seconds:.1f} s; K1 {k1}, K1 backward {k1b}, K2 {k2} "
        f"launches; best epoch "
        f"{best}, latest {latest}; restored best == live params, latest == live: {matches['latest']}")
    return {"launches": {"K1": k1, "K1_bwd": k1b, "K2": k2}, "seconds": seconds, "best": best,
            "latest": latest,
            "eval": {k: v["psnr_mean"] for k, v in result["eval"].items()}}


def _synth_isic():
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_synth_isic import synth_pair

    return synth_pair


def seg_pairs(n: int, size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` synthetic lesion images (n, size, size, 3) and masks (n, size, size, 1)."""
    synth_pair = _synth_isic()
    rng = np.random.default_rng(seed)
    pairs = [synth_pair(rng, size) for _ in range(n)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])[..., None]


def _seg_setup(kind: str, dtype: torch.dtype, device: str, seed: int = 0):
    """(model, loss, augment mode, extra metrics) of a segmentation trainer at
    full width: the protocol model with protocol A's loss and augmentation,
    or the vanilla model with BCE, flips and the vanilla trainer's metrics."""
    from adunet_torch.losses import binary_crossentropy, make_hybrid_ce_dice_loss
    from adunet_torch.metrics import (binary_accuracy, pooled_global_dice, pooled_precision,
                                      pooled_recall)
    from adunet_torch.models import build_adaptive_depth_unet, build_unet

    if kind == "protocol":
        model = build_adaptive_depth_unet(SEG_SIZE, 64, 4, dtype=dtype, device=device, seed=seed)
        return model, make_hybrid_ce_dice_loss(0.4, 0.6), "full", None
    model = build_unet(SEG_SIZE, base_channels=32, depth=4, dtype=dtype, device=device, seed=seed)
    extra = {"accuracy": binary_accuracy, "precision": pooled_precision(),
             "recall": pooled_recall(), "dice_coefficient": pooled_global_dice()}
    return model, binary_crossentropy, "flips", extra


def train_seg(kind: str, dtype: torch.dtype, ident: str) -> dict:
    """``SEG_STEPS`` training steps of a segmentation U-Net at full width on the
    card (Adam at ``SEG_LR``, augmentation drawn on the card), alternating two
    batches of 8 synthetic lesion pairs; the launch counts, gradients, BatchNorm
    buffers and loss are checked, then the step is timed."""
    from adunet_torch.train import create_train_state, make_optimizer, make_seg_train_step

    images, masks = seg_pairs(2 * SEG_BATCH, SEG_SIZE, seed=31)
    batches = [(torch.from_numpy(images[i : i + SEG_BATCH]).cuda(),
                torch.from_numpy(masks[i : i + SEG_BATCH]).cuda()) for i in (0, SEG_BATCH)]
    model, loss_fn, augment, extra = _seg_setup(kind, dtype, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    state = create_train_state(model, make_optimizer(model.parameters(), SEG_LR))
    step = make_seg_train_step(model, loss_fn, augment=augment, extra_metrics=extra)
    gen = torch.Generator("cuda").manual_seed(0)
    buffers0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    losses = []
    for i in range(SEG_STEPS):
        state, metrics = step(state, batches[i % 2], gen)
        losses.append(metrics["loss"])
        if i == 0:
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())
                   or not bool(p.grad.abs().max() > 0)]
            if bad:
                raise AssertionError(f"{kind}: parameters without a finite nonzero gradient: {bad}")
    torch.cuda.synchronize()
    counts = _counts()
    want = tuple(SEG_PER_STEP[kind][j] * SEG_STEPS for j in range(3))
    if counts != want:
        raise AssertionError(f"{kind} {dtype}: expected {want} K1 / K1 backward / K2 launches "
                             f"over {SEG_STEPS} steps, got {counts}")
    still = [n for n, b in model.named_buffers() if torch.equal(b, buffers0[n])]
    if still or (kind == "protocol") != bool(buffers0):
        raise AssertionError(f"{kind}: BatchNorm buffers that did not move: {still}")
    losses = [float(v) for v in losses]
    log(f"[seg {kind}] {dtype}, {n_params:,} params, {SEG_STEPS} steps at batch {SEG_BATCH} x "
        f"{SEG_SIZE} px: losses {', '.join(f'{v:.4f}' for v in losses)}; finite nonzero gradients "
        f"after step 1; {len(buffers0)} BatchNorm buffers moved; K1 {counts[0]}, K1 backward "
        f"{counts[1]}, K2 {counts[2]} launches")
    # two alternating batches, augmented anew each step: compare the means of
    # the first and last two steps
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"{kind}: the training loss did not fall: {losses}")
    ms = cuda_ms(lambda: step(state, batches[0], gen), TIMED_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[seg {kind}] {ident}: {dtype} train step, batch {SEG_BATCH} x {SEG_SIZE} px: "
        f"{ms:.3f} ms/step ({SEG_BATCH * 1e3 / ms:.1f} img/s); peak device memory {peak_gb:.2f} GB")
    del state, model, batches
    torch.cuda.empty_cache()
    return {"launches": dict(zip(("K1", "K1_bwd", "K2"), counts)), "steps": SEG_STEPS,
            "losses": losses, "ms_per_step": ms, "img_per_s": SEG_BATCH * 1e3 / ms,
            "peak_gb": peak_gb, "n_params": n_params}


def seg_card_vs_cpu_step() -> dict:
    """One float32 step of the protocol model (full width, training mode) at
    batch 2 on the card and on the CPU (plain versions) from the same weights
    and batch, no augmentation.

    Tolerances: loss 1e-5 relative; each gradient 2e-2 in relative L2 norm:
    float32 itself keeps this BatchNorm model's gradients only to ~5e-3
    against float64 (``scripts/torch_seg_grad_precision.py``; the fast
    variance E[x^2] - E[x]^2 cancels where mean^2 >> var, as in the
    reference), and the two sides round independently. The biases of the
    convs that feed a BatchNorm have a true gradient of 0 (the norm removes
    any per-channel shift; both sides give float32 noise): each within 2e-4
    of the largest gradient norm. Updated params within 2 x lr with fewer
    than 0.1 % of elements apart by more than lr / 2 (Adam's first update is
    ~lr * sign(grad)); running statistics rtol 1e-4 / atol 1e-5 (means over
    131,072 positions summed in another order)."""
    from adunet_torch.train import create_train_state, make_optimizer, make_seg_train_step

    lr = 1e-4
    cpu_model, loss_fn, _, _ = _seg_setup("protocol", torch.float32, "cpu", seed=3)
    gpu_model, _, _, _ = _seg_setup("protocol", torch.float32, "cuda", seed=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    images, masks = seg_pairs(2, SEG_SIZE, seed=41)
    out = {}
    for name, model in (("card", gpu_model), ("cpu", cpu_model)):
        state = create_train_state(model, make_optimizer(model.parameters(), lr))
        t0 = time.perf_counter()
        _, metrics = make_seg_train_step(model, loss_fn, augment="none")(state, (images, masks))
        out[name] = {"loss": float(metrics["loss"]), "seconds": time.perf_counter() - t0,
                     "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     "state": {n: v.detach().cpu() for n, v in model.state_dict().items()}}
    card, cpu = out["card"], out["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    top = max(float(g.norm()) for g in cpu["grads"].values())
    pre_bn = {n.replace("norm", "conv").replace("running_mean", "bias")
              for n in cpu["state"] if n.endswith(".running_mean")}
    grad_rel = max(float((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30))
                   for n, g in cpu["grads"].items() if n not in pre_bn)
    bias_abs = max(max(float(card["grads"][n].norm()), float(cpu["grads"][n].norm()))
                   for n in pre_bn) / top
    params = [n for n in cpu["grads"]]
    diffs = torch.cat([(card["state"][n] - cpu["state"][n]).abs().flatten() for n in params])
    far = float((diffs > lr / 2).float().mean())
    stats_ok = all(torch.allclose(card["state"][n], v, rtol=1e-4, atol=1e-5)
                   for n, v in cpu["state"].items() if "running" in n)
    stats_err = max(float((card["state"][n] - v).abs().max())
                    for n, v in cpu["state"].items() if "running" in n)
    log(f"[seg f32 step] protocol model, batch 2 x {SEG_SIZE} px: loss card {card['loss']:.7f} / "
        f"CPU {cpu['loss']:.7f} (rel {loss_rel:.1e}); worst gradient rel L2 {grad_rel:.1e} "
        f"(pre-BatchNorm biases {bias_abs:.1e} of the largest gradient norm); updated params max "
        f"|diff| {float(diffs.max()):.2e}, share > lr/2 {far:.2e}; running statistics max |diff| "
        f"{stats_err:.2e}; CPU step {cpu['seconds']:.1f} s")
    if not (loss_rel <= 1e-5 and grad_rel <= 2e-2 and bias_abs <= 2e-4 and stats_ok
            and float(diffs.max()) <= 2 * lr + 1e-6 and far < 1e-3):
        raise AssertionError("the card's float32 segmentation step disagrees with the CPU's")
    return {"loss_rel": loss_rel, "grad_rel_l2": grad_rel, "pre_bn_bias_abs": bias_abs,
            "param_max_diff": float(diffs.max()), "param_far_share": far,
            "running_stats_max_diff": stats_err}


# config.json keys of the reference's segmentation CLIs
# (adunet/cli/train_seg.py:274-299, adunet/cli/train_seg_vanilla.py:219-231)
PROTOCOL_CONFIG_KEYS = [
    "protocol", "description", "epochs_requested", "epochs_ran", "initial_lr", "batch_size",
    "image_size", "depth", "base_channels", "n_params", "n_devices", "train_samples",
    "val_samples", "train_steps_per_epoch", "seed", "mixed_precision", "threshold",
    "model_checkpoint", "train_images", "train_masks", "val_images", "val_masks", "metrics",
    "created_at"]
VANILLA_CONFIG_KEYS = [
    "run_name", "n_params", "num_classes", "monitor", "epochs_ran", "best_epoch",
    "best_val_metric", "best_val_dice", "checkpoint", "final_checkpoint", "created_at"]


def write_isic_corpus(directory: Path, n_train: int, n_val: int, size: int, seed: int) -> None:
    """ISIC-style ``.npy`` pairs (``ISIC_0000123.npy`` +
    ``ISIC_0000123_segmentation.npy``) under train_img / train_mask / val_img / val_mask."""
    images, masks = seg_pairs(n_train + n_val, size, seed)
    for i in range(n_train + n_val):
        split = "train" if i < n_train else "val"
        for sub in ("img", "mask"):
            (directory / f"{split}_{sub}").mkdir(parents=True, exist_ok=True)
        np.save(directory / f"{split}_img" / f"ISIC_{i:07d}.npy", images[i])
        np.save(directory / f"{split}_mask" / f"ISIC_{i:07d}_segmentation.npy", masks[i, ..., 0])


def seg_entry_points(tmp: Path) -> dict:
    """Both segmentation CLIs for 2 epochs at full width: ``train_seg``
    (protocol A, bf16, precise-BN over 2 batches) and ``train_seg_vanilla``
    (float32, flips), on 16 train / 8 val pairs of 288 px resized to 256."""
    from adunet_torch.cli.train_seg import main as protocol_main
    from adunet_torch.cli.train_seg_vanilla import main as vanilla_main
    from adunet_torch.train import CheckpointManager

    corpus = tmp / "isic"
    write_isic_corpus(corpus, 16, 8, 288, seed=51)
    epochs, steps = 2, 2  # 16 pairs at batch 8
    runs = {
        "protocol": (protocol_main, [
            "--protocol", "A", "--epochs", str(epochs), "--batch_size", "8", "--mixed_precision",
            "--precise_bn", "2", "--train_images", str(corpus / "train_img"),
            "--train_masks", str(corpus / "train_mask"), "--val_images", str(corpus / "val_img"),
            "--val_masks", str(corpus / "val_mask"), "--model_dir", str(tmp / "seg_models"),
            "--log_dir", str(tmp / "seg_logs"), "--run_name", "protocol", "--seed", "7"]),
        "vanilla": (vanilla_main, [
            "--train_image_dir", str(corpus / "train_img"),
            "--train_mask_dir", str(corpus / "train_mask"),
            "--val_image_dir", str(corpus / "val_img"), "--val_mask_dir", str(corpus / "val_mask"),
            "--image_suffix", ".npy", "--mask_suffix", "_segmentation.npy",
            "--epochs", str(epochs), "--augment", "--model_dir", str(tmp / "seg_models"),
            "--log_dir", str(tmp / "seg_logs"), "--run_name", "vanilla"]),
    }
    # forwards per run: train steps, then per epoch precise-BN's refresh
    # batches and the one val batch, and the protocol CLI's final eval batch
    forwards = {"protocol": epochs * steps + epochs * 2 + epochs + 1,
                "vanilla": epochs * steps + epochs}
    out = {}
    for kind, (main_fn, args) in runs.items():
        _zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = main_fn(args)
        seconds = time.perf_counter() - t0
        counts = _counts()
        for line in buf.getvalue().splitlines():
            log(f"[{kind} cli] {line}")
        k1, k1b, k2 = SEG_PER_STEP[kind]
        want = (k1 * forwards[kind], k1b * epochs * steps, k2 * forwards[kind])
        if counts != want:
            raise AssertionError(f"{kind} CLI: expected {want} K1 / K1 backward / K2 launches, "
                                 f"got {counts}")
        run_dir = Path(result["run_dir"])
        cfg = json.loads((run_dir / "config.json").read_text())
        rows = (run_dir / "epoch_metrics.csv").read_text().strip().splitlines()
        keys = PROTOCOL_CONFIG_KEYS if kind == "protocol" else VANILLA_CONFIG_KEYS
        if list(cfg) != keys or len(rows) != epochs + 1 or cfg["epochs_ran"] != epochs:
            raise AssertionError(f"{kind} CLI wrote keys {list(cfg)} and {len(rows)} CSV lines")
        if kind == "protocol":
            ckpts = [CheckpointManager(Path(result["ckpt_dir"]))]
            if not (cfg["train_steps_per_epoch"] == steps and cfg["n_params"] == 31_390_721
                    and 0.0 <= cfg["metrics"]["dice"] <= 1.0):
                raise AssertionError(f"protocol CLI config: {cfg}")
        else:
            ckpts = [CheckpointManager(Path(cfg["checkpoint"])),
                     CheckpointManager(Path(cfg["final_checkpoint"]))]
            if not (cfg["n_params"] == 7_765_985 and cfg["best_val_dice"] is not None):
                raise AssertionError(f"vanilla CLI config: {cfg}")
        latest = [c.latest_step() for c in ckpts]
        if latest != [epochs] * len(ckpts):
            raise AssertionError(f"{kind} CLI checkpoints: latest steps {latest}")
        log(f"[{kind} cli] {epochs} epochs in {seconds:.1f} s; K1 {counts[0]}, K1 backward "
            f"{counts[1]}, K2 {counts[2]} launches; config.json keys and CSV as the reference's; "
            f"checkpoints at epoch {epochs}")
        out[kind] = {"launches": dict(zip(("K1", "K1_bwd", "K2"), counts)), "seconds": seconds,
                     "csv_header": rows[0].split(",")}
        if kind == "protocol":  # exported and served by the joint_cli phase
            out[kind]["ckpt_dir"] = str(result["ckpt_dir"])
        del result
        torch.cuda.empty_cache()
    return out


def device_idle(fn, runs: int) -> dict:
    """The device's idle share over ``runs`` calls of ``fn`` under
    ``torch.profiler``: 1 - (union of the device activity intervals) / (first
    start to last end), with the gaps of 1 ms or more counted. None where the
    profiler recorded no device activity ("not measured")."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # device activity: kernels and copies, not the user-annotation ranges (such as
    # Optimizer.step's) that the profiler also puts on the device timeline
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return {"idle_share": None, "gaps_1ms": None, "gap_ms_1ms": None, "window_ms": None}
    merged = [list(spans[0])]
    for start, end in spans[1:]:
        if start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    window = merged[-1][1] - merged[0][0]
    busy = sum(e - b for b, e in merged)
    gaps = [merged[i + 1][0] - merged[i][1] for i in range(len(merged) - 1)]
    big = [g for g in gaps if g >= 1000.0]
    return {"idle_share": 1.0 - busy / window, "gaps_1ms": len(big),
            "gap_ms_1ms": sum(big) / 1e3, "window_ms": window / 1e3}


def _timed_steps(step, n: int) -> float:
    """ms per call of ``step`` over ``n`` calls, host clock, ending in a
    device synchronise (a streamed step's time includes its wait for data)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _random_head(model, seed: int = 1) -> None:
    """A seeded random 1x1 head (std 0.01) in place of the zero one, so the
    first steps send gradient through the whole network."""
    with torch.no_grad():
        model.residual_rgb.weight.normal_(0.0, 0.01,
                                          generator=torch.Generator("cuda").manual_seed(seed))


def streamed_flagship(tmp: Path, ident: str) -> dict:
    """The streamed path: ``train_sr`` without ``--device_cache``
    (``--uint8_feed --cache_decoded``, bf16, batch 32 x 256 px) for 2 epochs,
    then the same model's streamed step and device-cache step timed in turns
    over the same corpus, and the streamed step's device idle share."""
    from adunet_torch.cli.train_sr import main as train_main
    from adunet_torch.data import device_feed, load_device_cache, make_training_patch_dataset
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import (create_train_state, make_optimizer,
                                    make_sr_device_cache_train_step, make_sr_train_step)

    corpus = tmp / "cli_corpus"  # 10 images of 512 px (train_entry_point)
    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = train_main([
            "--scale", "0.5", "--depth_override", "3", "--mixed_precision", "--uint8_feed",
            "--cache_decoded", "--batch_size", "32", "--patch_size", "256",
            "--patches_per_image", "8", "--epochs", "2", "--high_res_dir", str(corpus),
            "--image_suffix", ".npy", "--model_dir", str(tmp / "models_streamed"),
            "--log_dir", str(tmp / "logs"), "--run_name", "streamed", "--seed", "11"])
    seconds = time.perf_counter() - t0
    k1, k1b, k2 = _counts()
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"[streamed cli] {line}")
    cfg = json.loads((Path(result["run_dir"]) / "config.json").read_text())
    steps = 2 * cfg["steps_per_epoch"]
    forwards = steps + 2 + 2  # train, val (4 tiles) per epoch, eval
    if (cfg["low_res_mode"], cfg["uint8_feed"], cfg["device_cache"]) != \
            ("synthetic_patches", True, False) or printed.count("PSNR(Y)") != 2:
        raise AssertionError(f"streamed train_sr: config {cfg}")
    if (k1, k1b, k2) != (16 * forwards, 16 * steps, 4 * forwards):
        raise AssertionError(f"streamed train_sr: expected {16 * forwards} K1 / {16 * steps} K1 "
                             f"backward / {4 * forwards} K2 launches, got {k1} / {k1b} / {k2}")
    log(f"[streamed cli] 2 epochs in {seconds:.1f} s; K1 {k1}, K1 backward {k1b}, K2 {k2}")

    paths = sorted(str(p) for p in corpus.glob("*.npy"))
    model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=torch.bfloat16,
                                           device="cuda", seed=0)
    _random_head(model)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    ds, _ = make_training_patch_dataset(paths, patch_size=TRAIN_PATCH, patches_per_image=8,
                                        scale=0.5, batch_size=TRAIN_BATCH, seed=3,
                                        output_dtype="uint8", cache_decoded=True)
    feed = device_feed(ds, "cuda")
    streamed = make_sr_train_step(model, charbonnier_loss)
    cache = load_device_cache(paths, "cuda")
    cached = make_sr_device_cache_train_step(model, charbonnier_loss, cache,
                                             patch_size=TRAIN_PATCH, batch_size=TRAIN_BATCH)
    gen = torch.Generator("cuda").manual_seed(0)
    waited = [0.0]

    def run_streamed():
        t = time.perf_counter()
        batch = next(feed)  # the host's wait for the producer and the copy's start
        waited[0] += time.perf_counter() - t
        streamed(state, batch)

    run_cached = lambda: cached(state, None, gen)  # noqa: E731
    for _ in range(3):  # warm-up: the shuffle buffer fills, cuDNN picks its algorithms
        run_streamed()
        run_cached()
    _zero_counts()
    waited[0] = 0.0
    ms_streamed = [_timed_steps(run_streamed, STREAM_STEPS)]
    counts = _counts()
    ms_cached = [_timed_steps(run_cached, STREAM_STEPS)]
    ms_cached.append(_timed_steps(run_cached, STREAM_STEPS))
    ms_streamed.append(_timed_steps(run_streamed, STREAM_STEPS))
    feed_ms = waited[0] / (2 * STREAM_STEPS) * 1e3
    want = tuple(n * STREAM_STEPS for n in STREAM_PER_STEP)
    if counts != want:
        raise AssertionError(f"streamed step: expected {want} K1 / K1 backward / K2 launches over "
                             f"{STREAM_STEPS} steps, got {counts}")
    idle = device_idle(run_streamed, 16)
    idle_cached = device_idle(run_cached, 16)
    feed.close()
    ms, ms_c = float(np.mean(ms_streamed)), float(np.mean(ms_cached))
    # the feed paces the step where the streamed step is slower than the
    # device-cache one by more than 5 %; the host's wait on the feed and the
    # profiles' idle gaps say where such time goes
    paced = ms > 1.05 * ms_c

    def idle_str(d):
        if d["idle_share"] is None:
            return "not measured"
        return (f"{d['idle_share']:.2%} of {d['window_ms']:.1f} ms ({d['gaps_1ms']} gaps >= 1 ms, "
                f"{d['gap_ms_1ms']:.1f} ms)")

    log(f"[streamed] {ident}: flagship bf16 step, batch {TRAIN_BATCH} x {TRAIN_PATCH} px, uint8 "
        f"feed from host memory: {ms:.3f} ms/step ({TRAIN_BATCH * 1e3 / ms:.1f} img/s; runs "
        f"{ms_streamed[0]:.3f} / {ms_streamed[1]:.3f}); device-cache step in the same run "
        f"{ms_c:.3f} ms/step (runs {ms_cached[0]:.3f} / {ms_cached[1]:.3f}); host-feed share "
        f"{ms / ms_c - 1.0:+.2%}; the host waits {feed_ms:.3f} ms/step for the next batch; "
        f"launches per step {[c // STREAM_STEPS for c in counts]}; device idle under the "
        f"profiler over 16 steps: streamed {idle_str(idle)}, device cache {idle_str(idle_cached)}; "
        + ("the feed paces the step" if paced else "the feed does not pace the step"))
    del cache, state, model, feed
    torch.cuda.empty_cache()
    return {"launches": dict(zip(("K1", "K1_bwd", "K2"), counts)), "steps": STREAM_STEPS,
            "ms_per_step": ms, "ms_runs": ms_streamed, "img_per_s": TRAIN_BATCH * 1e3 / ms,
            "device_cache_ms_per_step": ms_c, "device_cache_ms_runs": ms_cached,
            "host_feed_share": ms / ms_c - 1.0, "feed_wait_ms_per_step": feed_ms,
            "idle": idle, "idle_device_cache": idle_cached,
            "feed_paces_step": paced, "cli_seconds": seconds, "cli_launches": [k1, k1b, k2],
            "ckpt_dir": result["ckpt_dir"]}


def _conv_flops(model, x: torch.Tensor) -> float:
    """Multiply-add FLOPs (2 per MAC) of every convolution in one forward of
    ``model`` on ``x``, from the shapes the Conv modules see."""
    from adunet_torch.nn import Conv

    total = [0.0]

    def hook(module, inputs, output):
        o, i, kh, kw = module.weight.shape
        total[0] += 2.0 * output.numel() * i * kh * kw

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def deep_config(tmp: Path, ident: str) -> dict:
    """The deep config in bf16 at batch 8 x 256 px from a device cache, with
    and without remat_levels=2: launches per step, ms/step, peak memory and
    the share of the bf16 peak that its convolutions' FLOPs reach. Then one
    float32 step at batch 2 with and without remat from the same weights:
    every gradient equal within 1e-5 relative L2."""
    from adunet_torch.data import load_device_cache
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import (create_train_state, make_optimizer,
                                    make_sr_device_cache_train_step, make_sr_train_step)

    cache = load_device_cache(sorted(str(p) for p in (tmp / "cache").glob("*.npy")), "cuda")
    out = {"levels_px": _DEEP_SIZES}
    for levels in (None, 2):
        model, info = build_super_resolution_unet(DEEP_SCALE, depth_override=DEEP_DEPTH,
                                                  dtype=torch.bfloat16, remat_levels=levels,
                                                  device="cuda", seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != DEEP_PARAMS:
            raise AssertionError(f"deep config has {n_params} params, expected {DEEP_PARAMS}")
        _random_head(model)
        probe = torch.rand(DEEP_BATCH, 256, 256, 3, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
        fwd_flops = _conv_flops(model, probe)
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        step = make_sr_device_cache_train_step(model, charbonnier_loss, cache, patch_size=256,
                                               batch_size=DEEP_BATCH)
        gen = torch.Generator("cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        losses = [step(state, None, gen)[1]["loss"] for _ in range(DEEP_STEPS)]
        torch.cuda.synchronize()
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = tuple(n * DEEP_STEPS for n in DEEP_PER_STEP[levels])
        if counts != want:
            raise AssertionError(f"deep config remat_levels={levels}: expected {want} K1 / K1 "
                                 f"backward / K2 launches over {DEEP_STEPS} steps, got {counts}")
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"deep config: non-finite losses {losses}")
        ms = cuda_ms(lambda: step(state, None, gen), DEEP_STEPS)
        # the step's useful work: forward, data gradient and weight gradient
        # of every convolution (the recompute of remat is not counted)
        share = 3.0 * fwd_flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
        key = f"remat_{levels or 0}"
        out[key] = {"launches": dict(zip(("K1", "K1_bwd", "K2"), counts)),
                    "per_step": list(DEEP_PER_STEP[levels]), "ms_per_step": ms,
                    "img_per_s": DEEP_BATCH * 1e3 / ms, "peak_gb": peak_gb,
                    "conv_tflop_per_step": 3.0 * fwd_flops / 1e12, "bf16_peak_share": share,
                    "losses": losses, "bottleneck_px": info["bottleneck_size"]}
        log(f"[deep] {ident}: scale {DEEP_SCALE}, depth {DEEP_DEPTH}, {n_params:,} params, bf16, "
            f"batch {DEEP_BATCH} x 256 px, remat_levels={levels}: {ms:.3f} ms/step "
            f"({DEEP_BATCH * 1e3 / ms:.1f} img/s); peak device memory {peak_gb:.2f} GB; launches "
            f"per step K1 {counts[0] // DEEP_STEPS}, K1 backward {counts[1] // DEEP_STEPS}, K2 "
            f"{counts[2] // DEEP_STEPS}; conv FLOPs {3.0 * fwd_flops / 1e12:.3f} TFLOP per step "
            f"(3 x forward), {share:.2%} of the bf16 peak; losses "
            + ", ".join(f"{v:.5f}" for v in losses))
        del state, model, step
        torch.cuda.empty_cache()
    del cache

    # float32 gradients with and without remat from the same perturbed weights
    img = np.stack([_synth()(np.random.default_rng(60 + i), 256) for i in range(2)])
    hr = np.round(img * 255).astype(np.uint8)
    grads = {}
    base_model = None
    for levels in (None, 2):
        model, _ = build_super_resolution_unet(DEEP_SCALE, depth_override=DEEP_DEPTH,
                                               remat_levels=levels, device="cuda", seed=7)
        if base_model is None:
            with torch.no_grad():
                pgen = torch.Generator("cuda").manual_seed(8)
                for p in model.parameters():
                    p.add_(0.02 * torch.randn(p.shape, generator=pgen, device="cuda"))
            base_model = {n: v.clone() for n, v in model.state_dict().items()}
        else:
            model.load_state_dict(base_model)
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        make_sr_train_step(model, charbonnier_loss)(state, hr)
        grads[levels] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del state, model
        torch.cuda.empty_cache()
    worst = max(float((grads[2][n] - g).norm() / g.norm().clamp_min(1e-30))
                for n, g in grads[None].items())
    zero = [n for n, g in grads[None].items() if not float(g.abs().max()) > 0]
    log(f"[deep f32 grads] batch 2 x 256 px: worst relative L2 between the gradients with and "
        f"without remat_levels=2 {worst:.2e} over {len(grads[None])} leaves")
    if not worst <= 1e-5 or zero:
        raise AssertionError(f"deep config: gradients with and without remat differ ({worst:.2e}) "
                             f"or are zero: {zero}")
    out["f32_remat_grad_rel_l2"] = worst
    return out


def _vanilla_setup(dtype: torch.dtype, device: str, seed: int = 0):
    """The vanilla SR U-Net at full width and its combined loss over the
    seeded VGG19 tower (no ImageNet weights are in the repository)."""
    from adunet_torch.losses import build_losses_and_metrics, make_perceptual_fn
    from adunet_torch.models import build_vanilla_sr_unet

    model = build_vanilla_sr_unet(dtype=dtype, device=device, seed=seed)
    loss_fn, _ = build_losses_and_metrics(
        "combined", perceptual_fn=make_perceptual_fn(None, 256, dtype=dtype, device=device))
    return model, loss_fn


def _vanilla_pairs(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` synthetic 256 px HR images and their LR side (degrade at 0.5)."""
    rng = np.random.default_rng(seed)
    hr = np.stack([np.round(_synth()(rng, 256) * 255) / 255.0 for _ in range(n)]).astype(np.float32)
    lr = degrade(torch.from_numpy(hr), 0.5).numpy()
    return lr, hr


def vanilla_sr(ident: str) -> dict:
    """``SEG_STEPS`` bf16 steps of the vanilla SR U-Net with the combined
    loss at batch 8 x 256 px, alternating two batches: launches, gradients,
    BatchNorm buffers and the loss are checked, then the step is timed."""
    from adunet_torch.train import create_train_state, make_optimizer, make_vanilla_sr_train_step

    lr, hr = _vanilla_pairs(2 * SEG_BATCH, seed=71)
    batches = [(torch.from_numpy(lr[i : i + SEG_BATCH]).cuda(),
                torch.from_numpy(hr[i : i + SEG_BATCH]).cuda()) for i in (0, SEG_BATCH)]
    model, loss_fn = _vanilla_setup(torch.bfloat16, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != VANILLA_SR_PARAMS:
        raise AssertionError(f"vanilla SR U-Net has {n_params} params, expected {VANILLA_SR_PARAMS}")
    state = create_train_state(model, make_optimizer(model.parameters(), SEG_LR))
    step = make_vanilla_sr_train_step(model, loss_fn)
    buffers0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses = []
    for i in range(SEG_STEPS):
        state, metrics = step(state, batches[i % 2])
        losses.append(metrics["loss"])
        if i == 0:
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())
                   or not bool(p.grad.abs().max() > 0)]
            if bad:
                raise AssertionError(f"vanilla SR: parameters without a finite nonzero gradient: "
                                     f"{bad}")
    torch.cuda.synchronize()
    counts = _counts()
    per = sum(K2_VANILLA_SR.values())
    if counts != (0, 0, per * SEG_STEPS):
        raise AssertionError(f"vanilla SR: expected (0, 0, {per * SEG_STEPS}) K1 / K1 backward / K2 "
                             f"launches over {SEG_STEPS} steps, got {counts}")
    still = [n for n, b in model.named_buffers() if torch.equal(b, buffers0[n])]
    if still:
        raise AssertionError(f"vanilla SR: BatchNorm buffers that did not move: {still}")
    losses = [float(v) for v in losses]
    log(f"[vanilla sr] bf16, {n_params:,} params, combined loss (seeded VGG19), {SEG_STEPS} steps "
        f"at batch {SEG_BATCH} x 256 px: losses {', '.join(f'{v:.4f}' for v in losses)}; finite "
        f"nonzero gradients after step 1; {len(buffers0)} BatchNorm buffers moved; K1 {counts[0]}, "
        f"K1 backward {counts[1]}, K2 {counts[2]} launches")
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"vanilla SR: the training loss did not fall: {losses}")
    ms = cuda_ms(lambda: step(state, batches[0]), TIMED_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[vanilla sr] {ident}: bf16 train step with the combined loss, batch {SEG_BATCH} x 256 px: "
        f"{ms:.3f} ms/step ({SEG_BATCH * 1e3 / ms:.1f} img/s); peak device memory {peak_gb:.2f} GB")
    del state, model, batches
    torch.cuda.empty_cache()
    return {"launches": dict(zip(("K1", "K1_bwd", "K2"), counts)), "steps": SEG_STEPS,
            "losses": losses, "ms_per_step": ms, "img_per_s": SEG_BATCH * 1e3 / ms,
            "peak_gb": peak_gb, "n_params": n_params}


def vanilla_card_vs_cpu_step() -> dict:
    """One float32 step of the vanilla SR U-Net (full width, training mode,
    combined loss over the same seeded VGG19 tower) at batch 2 on the card and
    on the CPU from the same weights and batch, at the segmentation phase's
    BatchNorm tolerances (``seg_card_vs_cpu_step``): loss 1e-5 relative,
    gradients 2e-2 in relative L2 norm, the biases of convs that feed a
    BatchNorm (true gradient 0) within 2e-4 of the largest gradient norm,
    running statistics rtol 1e-4 / atol 1e-5."""
    from adunet_torch.train import create_train_state, make_optimizer, make_vanilla_sr_train_step

    cpu_model, cpu_loss = _vanilla_setup(torch.float32, "cpu", seed=3)
    gpu_model, gpu_loss = _vanilla_setup(torch.float32, "cuda", seed=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    lr, hr = _vanilla_pairs(2, seed=81)
    out = {}
    for name, model, loss_fn in (("card", gpu_model, gpu_loss), ("cpu", cpu_model, cpu_loss)):
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        t0 = time.perf_counter()
        _, metrics = make_vanilla_sr_train_step(model, loss_fn)(state, (lr, hr))
        out[name] = {"loss": float(metrics["loss"]), "seconds": time.perf_counter() - t0,
                     "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()}}
    card, cpu = out["card"], out["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    top = max(float(g.norm()) for g in cpu["grads"].values())
    pre_bn = {n.replace("norm", "conv").replace("running_mean", "bias")
              for n in cpu["buffers"] if n.endswith(".running_mean")}
    grad_rel = max(float((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30))
                   for n, g in cpu["grads"].items() if n not in pre_bn)
    bias_abs = max(max(float(card["grads"][n].norm()), float(cpu["grads"][n].norm()))
                   for n in pre_bn) / top
    stats_ok = all(torch.allclose(card["buffers"][n], v, rtol=1e-4, atol=1e-5)
                   for n, v in cpu["buffers"].items())
    stats_err = max(float((card["buffers"][n] - v).abs().max()) for n, v in cpu["buffers"].items())
    log(f"[vanilla sr f32 step] batch 2 x 256 px, combined loss: loss card {card['loss']:.7f} / CPU "
        f"{cpu['loss']:.7f} (rel {loss_rel:.1e}); worst gradient rel L2 {grad_rel:.1e} "
        f"(pre-BatchNorm biases {bias_abs:.1e} of the largest gradient norm); running statistics "
        f"max |diff| {stats_err:.2e}; CPU step {cpu['seconds']:.1f} s")
    if not (loss_rel <= 1e-5 and grad_rel <= 2e-2 and bias_abs <= 2e-4 and stats_ok):
        raise AssertionError("the card's float32 vanilla SR step disagrees with the CPU's")
    return {"loss_rel": loss_rel, "grad_rel_l2": grad_rel, "pre_bn_bias_abs": bias_abs,
            "running_stats_max_diff": stats_err, "cpu_seconds": cpu["seconds"]}


def sr_entry_points(tmp: Path, ckpt_dir: str) -> dict:
    """``train_sr_vanilla`` (bf16, combined loss, 2 epochs), ``evaluate`` and
    ``restore`` on the streamed phase's checkpoint, and an
    ``--async_checkpoint`` run of ``train_sr`` whose best and latest states
    load bit-equal to a synchronous run's from the same seed (cuDNN held to
    its deterministic algorithms for the two runs)."""
    from adunet_torch.cli.evaluate import main as evaluate_main
    from adunet_torch.cli.restore import main as restore_main
    from adunet_torch.cli.train_sr import main as train_main
    from adunet_torch.cli.train_sr_vanilla import main as vanilla_main
    from adunet_torch.data import load_rgb_image_full
    from adunet_torch.train import CheckpointManager

    out = {}
    # train_sr_vanilla on paired HR / LR directories of 16 images
    lr, hr = _vanilla_pairs(16, seed=91)
    for sub, stack in (("vhr", hr), ("vlr", lr)):
        (tmp / sub).mkdir()
        for i, img in enumerate(stack):
            np.save(tmp / sub / f"v{i:02d}.npy", np.clip(img, 0.0, 1.0).astype(np.float32))
    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = vanilla_main(["--high_res_dir", str(tmp / "vhr"), "--low_res_dir", str(tmp / "vlr"),
                               "--batch_size", "8", "--epochs", "2", "--mixed_precision",
                               "--model_dir", str(tmp / "vmodels"), "--log_dir", str(tmp / "logs"),
                               "--run_name", "vanilla_sr"])
    seconds = time.perf_counter() - t0
    counts = _counts()
    for line in buf.getvalue().splitlines():
        log(f"[vanilla sr cli] {line}")
    cfg = json.loads((Path(result["run_dir"]) / "config.json").read_text())
    # 16 images: 13 train (1 step of 8), 2 val, 1 test; forwards: 2 train
    # steps, 2 val batches, then the val and test evaluation
    if list(cfg) != ["run_name", "loss", "epochs_ran", "best_epoch", "results", "created_at"] \
            or cfg["epochs_ran"] != 2 or counts != (0, 0, 2 * 6) \
            or CheckpointManager(result["ckpt_dir"]).latest_step() != 2:
        raise AssertionError(f"train_sr_vanilla: config {cfg}, launches {counts}")
    out["vanilla_cli"] = {"seconds": seconds, "launches": list(counts), "results": cfg["results"]}
    log(f"[vanilla sr cli] 2 epochs in {seconds:.1f} s; K2 {counts[2]} launches; results "
        f"{cfg['results']}")

    # evaluate: the reference's three report files
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = evaluate_main(["--model-path", ckpt_dir, "--scale", "0.5",
                            "--hr-dir", str(tmp / "cli_corpus"), "--image-suffix", ".npy",
                            "--batch-size", "8", "--output-dir", str(tmp / "evaluation"),
                            "--run-name", "streamed"])
    for line in buf.getvalue().splitlines():
        log(f"[evaluate] {line}")
    run_dir = Path(ev["run_dir"])
    files = sorted(p.name for p in run_dir.iterdir())
    rows = (run_dir / "per_image_metrics.csv").read_text().strip().splitlines()
    if files != ["config.json", "metrics.json", "per_image_metrics.csv"] \
            or rows[0] != "index,filename,psnr_y,ssim_y,msssim_y,mse_y" or len(rows) != 41 \
            or not np.isfinite(ev["summary"].psnr_mean):
        raise AssertionError(f"evaluate wrote {files}, {len(rows)} CSV lines")
    out["evaluate"] = {"samples": ev["summary"].samples, "psnr_mean": ev["summary"].psnr_mean}

    # restore: odd sizes, overlap 32
    odd = tmp / "odd"
    odd.mkdir()
    rng = np.random.default_rng(93)
    shapes = [(300, 420), (257, 300), (200, 333)]
    for i, (h, w) in enumerate(shapes):
        np.save(odd / f"odd{i}.npy", np.round(_synth()(rng, max(h, w))[:h, :w] * 255)
                .astype(np.uint8))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        written = restore_main(["--model-path", ckpt_dir, "--scale", "0.5", "--input-dir", str(odd),
                                "--output-dir", str(tmp / "restored"), "--image-suffix", ".npy",
                                "--overlap", "32"])
    for line in buf.getvalue().splitlines():
        log(f"[restore] {line}")
    for path, (h, w) in zip(written, shapes):
        arr = np.load(path) if path.suffix == ".npy" else load_rgb_image_full(path)
        if arr.shape != (h, w, 3) or not np.isfinite(arr).all():
            raise AssertionError(f"restore wrote {path.name} of shape {arr.shape}, want {(h, w, 3)}")
    out["restore"] = {"images": len(written), "shapes": shapes}

    # async checkpoints: bit-equal to a synchronous run's
    small = tmp / "async_corpus"
    small.mkdir()
    write_corpus(small, 6, 512, seed=95)  # 4 train / 1 val / 1 test
    args = ["--scale", "0.5", "--depth_override", "3", "--mixed_precision", "--batch_size", "8",
            "--patch_size", "256", "--patches_per_image", "2", "--epochs", "2",
            "--high_res_dir", str(small), "--image_suffix", ".npy", "--uint8_feed",
            "--cache_decoded", "--seed", "13"]
    loaded = {}
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for name, extra in (("sync", []), ("async", ["--async_checkpoint"])):
            with contextlib.redirect_stdout(io.StringIO()):
                res = train_main(args + extra + ["--model_dir", str(tmp / f"ckpt_{name}"),
                                                 "--log_dir", str(tmp / "logs"), "--run_name", name])
            mngr = CheckpointManager(res["ckpt_dir"])
            loaded[name] = {which: torch.load(Path(res["ckpt_dir"]) / str(step) / "state.pt",
                                              weights_only=True)
                            for which, step in (("best", mngr.best_step()),
                                                ("latest", mngr.latest_step()))}
            del res
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    for which in ("best", "latest"):
        a, b = loaded["sync"][which], loaded["async"][which]
        same = a["step"] == b["step"] and all(torch.equal(b["model"][n], v)
                                              for n, v in a["model"].items())
        if not same:
            raise AssertionError(f"async checkpoint ({which}) differs from the synchronous run's")
    log(f"[async ckpt] best (step {loaded['sync']['best']['step']}) and latest (step "
        f"{loaded['sync']['latest']['step']}) states of the --async_checkpoint run load bit-equal "
        f"to the synchronous run's; evaluate wrote {files}; restore wrote {len(written)} images "
        f"of shapes {shapes}")
    out["async_equal"] = True
    torch.cuda.empty_cache()
    return out


def _joint_batches(n_batches: int, batch: int, seed: int):
    """``n_batches`` batches of synthetic lesion pairs on the card: float32
    images (B, 256, 256, 3) in [0, 1] and binary masks (B, 256, 256, 1)."""
    images, masks = seg_pairs(n_batches * batch, JOINT_SIZE, seed=seed)
    return [(torch.from_numpy(images[i : i + batch]).cuda(),
             torch.from_numpy(masks[i : i + batch]).cuda())
            for i in range(0, n_batches * batch, batch)]


def _joint_losses():
    from adunet_torch.losses import charbonnier_loss, make_bce_dice_loss

    return charbonnier_loss, make_bce_dice_loss(0.5, 1.0)  # train_joint's, one class


def train_joint(ident: str) -> dict:
    """The joint SR + segmentation U-Net at train_joint's defaults (depth 4 from
    the policy, 50,273,348 params), bf16 compute, float32 params, Adam 1e-4, a
    seeded random ``residual_rgb`` in place of the zero one, alternating two
    batches of 8 synthetic lesion pairs at 256 px: launches per step (counts
    set to 0 just before), a finite nonzero gradient for every parameter in
    the first step, a falling loss, ms/step, img/s, peak memory and the
    device's idle share."""
    from adunet_torch.models import build_joint_unet
    from adunet_torch.train import create_train_state, make_joint_train_step, make_optimizer

    batches = _joint_batches(2, JOINT_BATCH, seed=61)
    model, info = build_joint_unet(0.5, dtype=torch.bfloat16, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    if (n_params, info["depth"]) != (JOINT_PARAMS, 4):
        raise AssertionError(f"joint model: {n_params} params at depth {info['depth']}, expected "
                             f"{JOINT_PARAMS} at depth 4")
    _random_head(model)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_joint_train_step(model, *_joint_losses(), data_scale=0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    metrics = []
    for i in range(JOINT_STEPS):
        state, m = step(state, batches[i % 2])
        metrics.append(m)
        if i == 0:
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())
                   or not bool(p.grad.abs().max() > 0)]
            if bad:
                raise AssertionError(f"joint: parameters without a finite nonzero gradient: {bad}")
    torch.cuda.synchronize()
    counts = _counts()
    want = tuple(n * JOINT_STEPS for n in JOINT_PER_STEP)
    if counts != want:
        raise AssertionError(f"joint: expected {want} K1 / K1 backward / K2 launches over "
                             f"{JOINT_STEPS} steps, got {counts}")
    losses = [float(m["loss"]) for m in metrics]
    log(f"[joint] {n_params:,} params, depth {info['depth']}, bottleneck "
        f"{info['bottleneck_size']} px, bf16, {JOINT_STEPS} steps at batch {JOINT_BATCH} x "
        f"{JOINT_SIZE} px: losses {', '.join(f'{v:.5f}' for v in losses)} (SR "
        f"{float(metrics[0]['sr_loss']):.5f} -> {float(metrics[-1]['sr_loss']):.5f}, seg "
        f"{float(metrics[0]['seg_loss']):.5f} -> {float(metrics[-1]['seg_loss']):.5f}); finite "
        f"nonzero gradients after step 1; K1 {counts[0]}, K1 backward {counts[1]}, K2 "
        f"{counts[2]} launches")
    # two alternating batches: compare the means of the first and last two steps
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"joint: the training loss did not fall: {losses}")
    ms = cuda_ms(lambda: step(state, batches[0]), TIMED_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    idle = device_idle(lambda: step(state, batches[0]), 3)
    idle_str = "not measured" if idle["idle_share"] is None else f"{idle['idle_share']:.2%}"
    log(f"[joint] {ident}: bf16 train step, batch {JOINT_BATCH} x {JOINT_SIZE} px: {ms:.3f} "
        f"ms/step ({JOINT_BATCH * 1e3 / ms:.1f} img/s); peak device memory {peak_gb:.2f} GB; "
        f"device idle {idle_str} over 3 steps under the profiler")
    del state, model, step, batches
    torch.cuda.empty_cache()
    return {"launches": dict(zip(("K1", "K1_bwd", "K2"), counts)), "steps": JOINT_STEPS,
            "per_step": list(JOINT_PER_STEP), "losses": losses, "ms_per_step": ms,
            "img_per_s": JOINT_BATCH * 1e3 / ms, "peak_gb": peak_gb, "n_params": n_params,
            "depth": info["depth"], "idle": idle}


def joint_card_vs_cpu_step() -> dict:
    """One float32 step of the joint model (full width, depth 4) at batch 1 x
    256 px on the card and on the CPU (plain versions) from the same perturbed
    params and lesion pair, with the flagship's tolerances
    (``card_vs_cpu_step``): loss 1e-5 relative; each gradient 1e-3 in
    relative L2 norm; updated params within 2 x lr with fewer than 0.1 % of
    elements apart by more than lr / 2."""
    from adunet_torch.models import build_joint_unet
    from adunet_torch.train import create_train_state, make_joint_train_step, make_optimizer

    lr = 1e-4
    cpu_model, _ = build_joint_unet(0.5, device="cpu", seed=3)
    with torch.no_grad():  # break the identity start
        pgen = torch.Generator().manual_seed(4)
        for p in cpu_model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=pgen))
    gpu_model, _ = build_joint_unet(0.5, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    images, masks = seg_pairs(1, JOINT_SIZE, seed=71)
    out = {}
    for name, model in (("card", gpu_model), ("cpu", cpu_model)):
        state = create_train_state(model, make_optimizer(model.parameters(), lr))
        t0 = time.perf_counter()
        _, metrics = make_joint_train_step(model, *_joint_losses())(state, (images, masks))
        out[name] = {"loss": float(metrics["loss"]), "seconds": time.perf_counter() - t0,
                     "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
    card, cpu = out["card"], out["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_rel = max(float((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30))
                   for n, g in cpu["grads"].items())
    diffs = torch.cat([(card["params"][n] - p).abs().flatten() for n, p in cpu["params"].items()])
    far = float((diffs > lr / 2).float().mean())
    log(f"[joint f32 step] batch 1 x {JOINT_SIZE} px: loss card {card['loss']:.7f} / CPU "
        f"{cpu['loss']:.7f} (rel {loss_rel:.1e}); worst gradient rel L2 {grad_rel:.1e}; updated "
        f"params max |diff| {float(diffs.max()):.2e}, share > lr/2 {far:.2e}; CPU step "
        f"{cpu['seconds']:.1f} s")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-3 and float(diffs.max()) <= 2 * lr + 1e-6
            and far < 1e-3):
        raise AssertionError("the card's float32 joint step disagrees with the CPU's")
    return {"loss_rel": loss_rel, "grad_rel_l2": grad_rel, "param_max_diff": float(diffs.max()),
            "param_far_share": far}


# config.json and result.json keys of the reference's train_joint
# (adunet/cli/train_joint.py:149-157, 200-210)
JOINT_CONFIG_KEYS = [
    "train_image_dir", "train_mask_dir", "val_image_dir", "val_mask_dir", "image_suffix",
    "mask_suffix", "image_size", "scale", "depth_override", "base_channels",
    "residual_head_channels", "num_classes", "sr_loss", "sr_weight", "seg_weight", "batch_size",
    "epochs", "learning_rate", "patience", "seed", "limit_train", "limit_val", "mixed_precision",
    "async_checkpoint", "remat", "model_dir", "log_dir", "run_name", "n_devices", "depth",
    "bottleneck_size", "n_params", "steps_per_epoch", "created_at"]
JOINT_FINAL_KEYS = ["epoch", "steps", "duration_s", "ms_per_step", "dice", "iou", "loss", "psnr",
                    "seg_loss", "sr_loss", "val_dice", "val_iou", "val_loss", "val_psnr",
                    "val_seg_loss", "val_sr_loss"]


def joint_entry_points(tmp: Path, seg_ckpt: str) -> dict:
    """``train_joint`` for 2 epochs at full width (bf16, batch 8, on the
    segmentation phase's 16 train / 8 val lesion pairs), ``export_model
    --workload joint --quantize int8`` and ``load_artifact`` on the card (one
    served forward); then the segmentation phase's protocol checkpoint
    exported (float32), served over HTTP, and its masks held to the
    checkpoint's live model on the card. The served joint outputs are held
    to the same checkpoint's model with its conv kernels quantized and
    dequantized in memory (the port's quantizer, bit-equal to the
    reference's on the CPU) on the card."""
    from adunet_torch.cli.export_model import load_joint_checkpoint, load_seg_checkpoint
    from adunet_torch.convert import flax_trees_from_state_dict, state_dict_from_flax
    from adunet_torch.export import quantize_params_int8
    from adunet_torch.cli.export_model import main as export_main
    from adunet_torch.cli.train_joint import main as joint_main

    corpus = tmp / "isic"
    epochs, steps = 2, 2  # 16 pairs at batch 8; 8 val pairs: one val batch an epoch
    args = ["--train_image_dir", str(corpus / "train_img"),
            "--train_mask_dir", str(corpus / "train_mask"),
            "--val_image_dir", str(corpus / "val_img"), "--val_mask_dir", str(corpus / "val_mask"),
            "--image_suffix", ".npy", "--mask_suffix", "_segmentation.npy", "--mixed_precision",
            "--epochs", str(epochs), "--model_dir", str(tmp / "joint_models"),
            "--log_dir", str(tmp / "joint_logs"), "--run_name", "joint", "--seed", "9"]
    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = joint_main(args)
    seconds = time.perf_counter() - t0
    counts = _counts()
    for line in buf.getvalue().splitlines():
        log(f"[joint cli] {line}")
    forwards = epochs * steps + epochs  # train steps and val batches
    want = (JOINT_PER_STEP[0] * forwards, JOINT_PER_STEP[1] * epochs * steps,
            JOINT_PER_STEP[2] * forwards)
    if counts != want:
        raise AssertionError(f"train_joint: expected {want} K1 / K1 backward / K2 launches, "
                             f"got {counts}")
    run_dir = Path(result["run_dir"])
    cfg = json.loads((run_dir / "config.json").read_text())
    res = json.loads((run_dir / "result.json").read_text())
    rows = (run_dir / "epoch_metrics.csv").read_text().strip().splitlines()
    if (list(cfg) != JOINT_CONFIG_KEYS or list(res["final_metrics"]) != JOINT_FINAL_KEYS
            or len(rows) != epochs + 1 or (cfg["depth"], cfg["n_params"], cfg["steps_per_epoch"])
            != (4, JOINT_PARAMS, steps)):
        raise AssertionError(f"train_joint wrote config keys {list(cfg)}, final metrics "
                             f"{list(res['final_metrics'])}, {len(rows)} CSV lines")
    if not all(np.isfinite(v) for v in res["final_metrics"].values()):
        raise AssertionError(f"train_joint: non-finite final metrics {res['final_metrics']}")
    events = sorted(p.name for p in run_dir.glob("events.out.tfevents.*"))
    log(f"[joint cli] {epochs} epochs in {seconds:.1f} s; K1 {counts[0]}, K1 backward "
        f"{counts[1]}, K2 {counts[2]} launches; config.json and result.json keys as the "
        f"reference's; TensorBoard event files: {len(events)} (none where tensorboardX is "
        "not installed)")
    out = {"launches": dict(zip(("K1", "K1_bwd", "K2"), counts)), "seconds": seconds,
           "final_metrics": res["final_metrics"], "tb_event_files": len(events)}
    del result
    torch.cuda.empty_cache()

    art = tmp / "joint_export"
    with contextlib.redirect_stdout(buf):
        export_main(["--workload", "joint", "--model-path", res["checkpoint"], "--output-dir",
                     str(art), "--quantize", "int8"])
    call, manifest = load_artifact(art, device="cuda")
    x = seg_pairs(JOINT_BATCH, JOINT_SIZE, seed=81)[0]
    _zero_counts()
    served = call(x)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != JOINT_PER_FORWARD:
        raise AssertionError(f"joint artifact: expected {JOINT_PER_FORWARD} K1 / K1 backward / "
                             f"K2 launches per forward, got {counts}")
    if not (served["sr"].shape == x.shape and served["mask"].shape == x.shape[:3] + (1,)
            and np.isfinite(served["mask"]).all() and 0 <= served["mask"].min()
            and served["mask"].max() <= 1 and 0 <= served["sr"].min() and served["sr"].max() <= 1):
        raise AssertionError("joint artifact: outputs of the wrong shape or range")
    del call
    torch.cuda.empty_cache()

    def dequantized(tree):
        if set(tree) == {"q", "scale"}:
            return tree["q"].astype(np.float32) * tree["scale"]
        return {k: dequantized(v) if isinstance(v, dict) else v for k, v in tree.items()}

    live, _ = load_joint_checkpoint(Path(res["checkpoint"]), device="cuda")
    params, stats = flax_trees_from_state_dict(live.state_dict())
    live.load_state_dict(state_dict_from_flax(dequantized(quantize_params_int8(params)), stats))
    with torch.inference_mode():
        sr, mask = live(torch.from_numpy(x).cuda())
        want = {"sr": sr.float().clamp(0.0, 1.0).cpu().numpy(), "mask": mask.float().cpu().numpy()}
    errs = {k: float(np.abs(served[k] - want[k]).max()) for k in ("sr", "mask")}
    log(f"[joint export] int8 artifact ({manifest['weights_leaves']} leaves, "
        f"{manifest['artifact_bytes'] / 1e6:.2f} MB) served one forward at batch "
        f"{JOINT_BATCH} x {JOINT_SIZE} px: K1 {counts[0]}, K1 backward {counts[1]}, K2 "
        f"{counts[2]} launches; max |served - checkpoint with dequantized weights| sr "
        f"{errs['sr']:.2e}, mask {errs['mask']:.2e}")
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"served joint outputs differ from the checkpoint's model with "
                             f"dequantized weights: {errs}")
    out["served_launches"] = dict(zip(("K1", "K1_bwd", "K2"), counts))
    out["served_max_abs_err"] = errs
    del live, sr, mask
    torch.cuda.empty_cache()

    # the protocol segmentation checkpoint: export (float32), serve, compare
    seg_art = tmp / "seg_export"
    with contextlib.redirect_stdout(buf):
        export_main(["--workload", "seg", "--model-path", seg_ckpt, "--output-dir",
                     str(seg_art)])
    live, _ = load_seg_checkpoint(Path(seg_ckpt), device="cuda")
    server = make_server(str(seg_art), port=0, batch_window_ms=200.0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    images = seg_pairs(3, JOINT_SIZE, seed=91)[0]
    try:
        got = _post_npy(f"http://127.0.0.1:{server.server_address[1]}/v1/predict", images)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    with torch.inference_mode():  # eval-mode BatchNorm: each mask depends on its image alone
        want = live(torch.from_numpy(images).cuda()).float().cpu().numpy()
    err = float(np.abs(got - want).max())
    log(f"[seg serve] protocol checkpoint exported ({server.manifest['batch_stats_leaves']} "
        f"BatchNorm statistics leaves) and served over HTTP: 3 masks {got.shape}, max |served - "
        f"live| {err:.2e}")
    if got.shape != (3, JOINT_SIZE, JOINT_SIZE, 1) or not err <= 1e-5 or thread.is_alive():
        raise AssertionError(f"served segmentation masks differ from the live model's ({err:.2e})")
    out["seg_served_max_abs_err"] = err
    del live
    torch.cuda.empty_cache()
    return out


def _trial_k2(trials, n_train: int, n_val: int, per_forward) -> int:
    """K2 launches of a study's trials: ``per_forward(params)`` per training
    step and per validation forward, for each epoch a trial reported."""
    total = 0
    for t in trials:
        b = int(t["params"]["batch_size"])
        forwards = math.ceil(n_train / b) + math.ceil(n_val / b)
        total += per_forward(t["params"]) * len(t["intermediate"]) * forwards
    return total


def _seg_k2_per_forward(params: dict, size: int) -> int:
    """K2 launches per forward of the adaptive seg U-Net: enc{l}.conv1 and
    dec{l}.conv1 at each level whose width is 64 and whose shape K2's gate
    accepts (base 64 at 256 px; base 32 at 128 px)."""
    base, depth = int(params["base_channels"]), int(params["depth"])
    return sum(2 for level in range(depth) if base << level == 64
               and conv64.supported((1, size >> level, size >> level, 64), (64, 64, 3, 3)))


def tune(tmp: Path, ident: str) -> dict:
    """The tuner at full width (vanilla SR, base 64, float32, 256 px) on 20
    synthetic HR images (``write_corpus``; LR degraded at 0.5 on the card):

    - ``adunet_torch.cli.tune.main`` runs a 3-trial, 2-epoch SR study with a
      1-epoch retrain, then the same study with ``--parallel-trials 3``
      (counts set to 0 just before each): the results' keys, the trials'
      states, the retrain's ``config.json`` and best checkpoint, and exactly
      2 K2 launches per lane per training step and per validation forward,
      no K1;
    - ``run_group`` of 3 fixed configs at batch 4 for 2 epochs (8 train / 2
      val synthetic pairs) against each config run as a group of one, with
      cuDNN's deterministic algorithms as the CLI runs them: every curve
      value within 1e-6 relative, launches as above; the group's wall-clock
      against the singles' sum;
    - the float32 lane step at batch 4, 8 and 16: CUDA-event time, peak
      memory and the device's idle share;
    - a 2-trial, 1-epoch seg study at 256 px on 16 / 8 lesion pairs with the
      search's own base channels: K2 launches as the drawn widths give them.
    """
    from adunet_torch.cli import tune as tune_cli
    from adunet_torch.train import CheckpointManager
    from adunet_torch.tune import BatchedVanillaSRTuner

    hr_dir = tmp / "tune_hr"
    hr_dir.mkdir()
    write_corpus(hr_dir, TUNE_IMAGES, 256, seed=91)
    common = ["--workload", "sr", "--n-trials", "3", "--epochs", "2", "--image-size", "256",
              "--sr-base-channels", "64", "--high-res-dir", str(hr_dir), "--image-suffix",
              ".npy", "--device", "cuda"]
    out: dict = {"studies": {}}
    for mode, extra in (("sequential", ["--retrain", "--final-epochs", "1"]),
                        ("laned", ["--parallel-trials", "3"])):
        results, models = tmp / f"tune_{mode}.json", tmp / f"tune_{mode}_models"
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tune_cli.main(common + extra + ["--results", str(results), "--model-dir", str(models)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        payload = json.loads(results.read_text())
        trials = payload["trials"]
        want_keys = TUNE_RESULT_KEYS | ({"retrain"} if mode == "sequential" else set())
        states = [t["state"] for t in trials]
        ok_states = {"COMPLETE"} if mode == "laned" else {"COMPLETE", "PRUNED"}
        values = [v for t in trials for v in t["intermediate"].values()]
        if (set(payload) != want_keys or payload["n_trials"] != 3 or not set(states) <= ok_states
                or not all(np.isfinite(values)) or payload["best_value"] is None):
            raise AssertionError(f"tune {mode}: results {payload}")
        k2 = _trial_k2(trials, TUNE_TRAIN, TUNE_VAL, lambda p: K2_TUNE_PER_FORWARD)
        if mode == "sequential":
            ckpt_dir = models / "unet_vanilla_tuned_best"
            config = json.loads((ckpt_dir / "config.json").read_text())
            best = CheckpointManager(ckpt_dir).best_step()
            if (set(config) != {"workload", "lr", "alpha", "beta", "gamma", "batch_size",
                                "final_epochs"} or best != 1
                    or not (ckpt_dir / str(best) / "state.pt").exists()
                    or payload["retrain"]["checkpoint"] != str(ckpt_dir)):
                raise AssertionError(f"tune retrain: config {config}, best step {best}")
            k2 += _trial_k2([{"params": config, "intermediate": [0]}], TUNE_TRAIN, TUNE_VAL,
                            lambda p: K2_TUNE_PER_FORWARD)
        if counts != (0, 0, k2):
            raise AssertionError(f"tune {mode}: expected (0, 0, {k2}) K1 / K1 backward / K2 "
                                 f"launches, got {counts}")
        log(f"[tune {mode}] 3 trials x 2 epochs{' + 1-epoch retrain' if mode == 'sequential' else ''}"
            f" in {seconds:.1f} s: states {states}, batch sizes "
            f"{[t['params']['batch_size'] for t in trials]}, best val loss "
            f"{payload['best_value']:.6f}; K1 {counts[0]}, K1 backward {counts[1]}, K2 {counts[2]} "
            f"launches (2 per lane per training step and validation forward)")
        out["studies"][mode] = {"seconds": seconds, "states": states,
                                "launches": dict(zip(("K1", "K1_bwd", "K2"), counts))}
    out["launches"] = out["studies"]["sequential"]["launches"]

    # lanes against single lanes, with cuDNN's deterministic algorithms as the
    # CLI runs them (its default ones do not repeat a run bit for bit), on 8
    # train / 2 val images: batch 4 is cuDNN's slowest (PERF.md)
    lr, hr = _vanilla_pairs(max(TUNE_BATCHES), seed=95)
    runner = BatchedVanillaSRTuner(lr, hr, np.arange(TUNE_LANE_SPLIT[0]),
                                   np.arange(TUNE_LANE_SPLIT[0], sum(TUNE_LANE_SPLIT)),
                                   device="cuda")
    with deterministic_cudnn():
        epochs, batch = 2, 4
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        curves = runner.run_group(TUNE_CONFIGS, batch, epochs)
        group_s = time.perf_counter() - t0
        counts = _counts()
        want = K2_TUNE_PER_FORWARD * len(TUNE_CONFIGS) * epochs * sum(
            math.ceil(n / batch) for n in TUNE_LANE_SPLIT)
        if counts != (0, 0, want):
            raise AssertionError(f"tune lanes: expected (0, 0, {want}) launches, got {counts}")
        singles, singles_s = [], []
        for cfg in TUNE_CONFIGS:
            t0 = time.perf_counter()
            singles.append(runner.run_group([cfg], batch, epochs)[0])
            singles_s.append(time.perf_counter() - t0)
    lanes_np, singles_np = np.asarray(curves), np.asarray(singles)
    worst = float(np.max(np.abs(lanes_np - singles_np) / np.abs(singles_np)))
    log(f"[tune lanes] {len(TUNE_CONFIGS)} lanes x {epochs} epochs at batch {batch}: curves "
        f"{np.round(lanes_np, 6).tolist()}; worst relative difference from single lanes "
        f"{worst:.3e}; K2 {counts[2]} launches; {ident}: group {group_s:.3f} s against "
        f"{sum(singles_s):.3f} s for the single lanes in turn ({sum(singles_s) / group_s:.3f}x)")
    if not worst <= 1e-6 or not np.all(np.isfinite(lanes_np)):
        raise AssertionError(f"tune lanes differ from single lanes: {worst:.3e}")
    out["lanes"] = {"curves": curves, "worst_rel_diff": worst, "group_s": group_s,
                    "singles_s": singles_s, "launches": dict(zip(("K1", "K1_bwd", "K2"), counts))}

    # the float32 lane step at the search space's batch sizes, as the CLI runs it
    out["step"] = {}
    for b in TUNE_BATCHES:
        lanes = runner.lanes(TUNE_CONFIGS[:1])
        data = (torch.from_numpy(lr[:b]).cuda(), torch.from_numpy(hr[:b]).cuda())
        with deterministic_cudnn():
            runner.train_step(lanes, data)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: runner.train_step(lanes, data), TIMED_STEPS)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            idle = device_idle(lambda: runner.train_step(lanes, data), 3)
        share = idle["idle_share"]
        log(f"[tune step] {ident}: float32 lane step, batch {b} x 256 px: {ms:.3f} ms/step "
            f"({b * 1e3 / ms:.1f} img/s); peak device memory {peak_gb:.2f} GB; device idle "
            f"{'not measured' if share is None else f'{100 * share:.1f} %'} over 3 steps")
        out["step"][b] = {"ms_per_step": ms, "img_per_s": b * 1e3 / ms, "peak_gb": peak_gb,
                          **idle}
        del lanes, data
        torch.cuda.empty_cache()
    del runner

    # a seg study with the search's own base channels
    isic = tmp / "tune_isic"
    write_isic_corpus(isic, 16, 8, 256, seed=93)
    results = tmp / "tune_seg.json"
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tune_cli.main(["--workload", "seg", "--n-trials", "2", "--epochs", "1", "--image-size",
                       "256", "--train-images", str(isic / "train_img"), "--train-masks",
                       str(isic / "train_mask"), "--val-images", str(isic / "val_img"),
                       "--val-masks", str(isic / "val_mask"), "--results", str(results),
                       "--model-dir", str(tmp / "tune_seg_models"), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    payload = json.loads(results.read_text())
    trials = payload["trials"]
    k2 = _trial_k2(trials, 16, 8, lambda p: _seg_k2_per_forward(p, 256))
    if (set(payload) != TUNE_RESULT_KEYS or any(t["state"] != "COMPLETE" for t in trials)
            or not 0.0 <= payload["best_value"] <= 1.0 or counts != (0, 0, k2)):
        raise AssertionError(f"tune seg: results {payload}, launches {counts} (K2 expected {k2})")
    log(f"[tune seg] 2 trials x 1 epoch in {seconds:.1f} s: params "
        f"{[t['params'] for t in trials]}, best val Dice {payload['best_value']:.4f}; K1 "
        f"{counts[0]}, K1 backward {counts[1]}, K2 {counts[2]} launches (expected {k2})")
    out["seg"] = {"seconds": seconds, "params": [t["params"] for t in trials],
                  "launches": dict(zip(("K1", "K1_bwd", "K2"), counts))}
    torch.cuda.empty_cache()
    return out


def kernels_line(details: list[dict], grads: list[dict], launches: dict, serve_launches: dict,
                 seg_launches: dict, sr_launches: dict, build_s: float) -> dict:
    """One entry per kernel. ``launches`` come from the training path (device-
    cache steps); ``ms``, ``device_ms``, ``plain_ms``, ``bound_ms``,
    ``library_ms`` and ``library_device_ms`` are summed over the kernel's
    launches in one bf16 training step (per-shape time x launches per step),
    ``ms`` from CUDA events and ``device_ms`` from the profiler (null where
    it recorded no full session at some shape); ``serve``
    holds the same sums at the float32 serving shapes (one forward; serving
    runs no backward, so K1_bwd's serving launches are 0); ``seg`` holds, for
    the bf16 protocol and vanilla segmentation phases, their launches, the
    shapes and the same sums over one step at batch 8 x 256 px (the protocol
    model's K2 shape is the serving one); ``narrow`` lists K1's other C = 16
    and 32 checks, per launch; ``streamed``, ``deep`` and ``vanilla_sr`` hold
    the launches of the streamed flagship steps, the deep config's steps
    without and with remat_levels=2, and the vanilla SR steps, with the same
    sums over one step of the deep config (no remat) and of the vanilla SR
    model at batch 8 x 256 px; ``joint`` the launches of the joint SR +
    segmentation model's bf16 steps with the same sums over one of its steps
    at batch 8 x 256 px, and ``joint_served`` the launches of one forward of
    its exported int8 artifact, with the same sums over that float32 forward
    at batch 8 x 256 px; ``wide`` lists K1's other C = 1024 and 2048 checks
    (float32, ragged row counts), per launch; ``tune`` the launches of the
    tuner's sequential SR study and, per launch, K2's float32 rows at the
    lane step's batch 4, 8 and 16 x 256 px."""
    meta = {
        "K1": ("layer_norm_relu", "adunet_torch/csrc/fused_norm.cu", "adunet/kernels/fused_norm.py:48"),
        "K1_bwd": ("layer_norm_relu_backward", "adunet_torch/csrc/fused_norm.cu",
                   "adunet/kernels/fused_norm.py:109"),
        "K2": ("conv3x3_same_c64", "adunet_torch/csrc/conv64.cu", "adunet/kernels/conv64.py:132"),
    }
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms")

    def summed(rows, key):  # None where the profiler measured no device time
        vals = [d[key] for d in rows]
        return None if None in vals else sum(v * d["per_call"] for v, d in zip(vals, rows))

    def summed_at(rows, key, per_step):  # the same, with another path's launches per step
        rows = [d for d in rows if tuple(d["shape"]) in per_step]
        vals = [d[key] for d in rows]
        return None if None in vals else sum(v * per_step[tuple(d["shape"])]
                                             for v, d in zip(vals, rows))

    # (rows' path, launches per step of each kernel) of the bf16 segmentation steps
    seg_paths = {"protocol": ("serve", {"K2": K2_PROTOCOL}),
                 "vanilla": ("vanilla", {"K1": K1_VANILLA, "K1_bwd": K1_VANILLA,
                                         "K2": K2_VANILLA})}
    # the same for the SR paths of this script's later phases
    sr_paths = {"deep": ("deep", "serve", {"K1": K1_DEEP, "K1_bwd": K1_DEEP, "K2": K2_DEEP}),
                "vanilla_sr": (None, "serve", {"K2": K2_VANILLA_SR}),
                "joint": ("joint", "serve", {"K1": K1_JOINT, "K1_bwd": K1_JOINT, "K2": K2_JOINT})}

    out = []
    for kid, (name, src, replaces) in meta.items():
        train = [d for d in details if d["kernel"] == kid and d["path"] == "train"]
        serve = [d for d in details if d["kernel"] == kid and d["path"] == "serve"
                 and d["dtype"] == "float32"]
        grad = [g for g in grads if g["kernel"] == kid and g["path"] == "train"]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kid],
            "max_abs_err": max(d["max_abs_err"] for d in details if d["kernel"] == kid),
            **{k: summed(train, k) for k in keys},
            "bound_by": max(train, key=lambda d: d["bound_ms"] * d["per_call"])["bound_by"],
            "per": "launches of one bf16 training step of the flagship (batch 32, 256 px)",
            "serve": {"launches": serve_launches[kid], **{k: summed(serve, k) for k in keys}},
            "seg": {},
        }
        for path, (rows_path, per) in seg_paths.items():
            rows = [d for d in details if d["kernel"] == kid and d["path"] == rows_path
                    and d["dtype"] == "bfloat16"]
            sums = {k: summed_at(rows, k, per[kid]) for k in keys} if kid in per else {}
            shapes = [d["shape"] for d in rows if tuple(d["shape"]) in per.get(kid, {})]
            entry["seg"][path] = {"launches": seg_launches[path][kid], "shapes": shapes, **sums}
        entry["streamed"] = {"launches": sr_launches["streamed"][kid]}
        # the served joint forward: float32 at the serving rows and K1_JOINT_SERVED's
        per = {"K1": K1_JOINT, "K2": K2_JOINT}.get(kid, {})
        rows = [d for d in details if d["kernel"] == kid and d["dtype"] == "float32"
                and d["path"] in ("serve", "joint_served") and tuple(d["shape"]) in per]
        entry["joint_served"] = {"launches": sr_launches["joint_served"][kid],
                                 "shapes": [d["shape"] for d in rows],
                                 **({k: summed_at(rows, k, per) for k in keys} if per else {})}
        for path, (k1_rows, k2_rows, per) in sr_paths.items():
            rows_path = k2_rows if kid == "K2" else k1_rows
            rows = [d for d in details if d["kernel"] == kid and d["path"] == rows_path
                    and d["dtype"] == "bfloat16"]
            sums = {k: summed_at(rows, k, per[kid]) for k in keys} if kid in per else {}
            shapes = [d["shape"] for d in rows if tuple(d["shape"]) in per.get(kid, {})]
            entry[path] = {"launches": sr_launches[path][kid], "shapes": shapes, **sums}
        # the tuner's float32 lane steps: per launch at batch 4 and 16 (path
        # "tune") and 8 (the float32 serving row), with forward + backward
        rows = [d for d in details if d["kernel"] == kid and d["dtype"] == "float32"
                and (d["path"] == "tune" or (d["path"] == "serve" and kid == "K2"))]
        fb = {tuple(g["shape"]): g["fwd_bwd_ms"] for g in grads
              if g["kernel"] == kid and g["dtype"] == "float32" and g["path"] in ("tune", "serve")}
        entry["tune"] = {"launches": sr_launches["tune"][kid],
                         "rows": [{**{k: d[k] for k in ("shape", "max_abs_err", "ms", "device_ms",
                                                        "plain_ms", "bound_ms", "bound_by",
                                                        "library_ms", "library_device_ms")},
                                   "fwd_bwd_ms": fb.get(tuple(d["shape"]))} for d in rows]}
        for extra in ("narrow", "wide"):  # K1's other checks beside the paths, per launch
            rows = [d for d in details if d["kernel"] == kid and d["path"] == extra]
            if rows:
                entry[extra] = [{k: d[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                                                   "device_ms", "bound_ms", "library_ms")}
                                for d in rows]
        if grad:  # the autograd Function's forward + backward
            per_step = K1_TRAIN if kid == "K1" else K2_TRAIN
            entry["fwd_bwd_ms"] = sum(g["fwd_bwd_ms"] * per_step[tuple(g["shape"])] for g in grad)
        out.append(entry)
    return {"kernels": out, "build_s": build_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available; this smoke run needs one.", file=sys.stderr)
        return 2
    setup_runtime()
    t_start = time.perf_counter()

    probes = [host_probe("build")]
    _build.library()
    build_s = float(_build.last_build.get("seconds", 0.0))
    if _build.last_build.get("log") == "(cached)":  # build anew for ptxas's report
        _build.library(rebuild=True)
    log(f"[build] kernels ready in {build_s:.1f} s: {_build.last_build.get('path')}")
    for line in _build.last_build.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log(f"[ptxas] {line.strip()}")
    spills = check_k1_bwd_spills(_build.last_build["log"])

    ident = gpu_identity().splitlines()[0]
    log(f"[gpu] {ident}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def phase(name, fn, *args):
        probes.append(host_probe(name))
        return fn(*args)

    gen = torch.Generator("cuda").manual_seed(0)
    details = phase("k1", check_k1, gen) + phase("k2", check_k2, gen)
    grads = phase("grads", check_backward, gen)
    details += phase("k1_bwd", check_k1_backward, gen)
    torch.cuda.empty_cache()

    call, _ = load_artifact(ARTIFACT, device="cuda")
    served = phase("serve", serve_flagship, call)
    scores = phase("golden", golden, call)
    speed = phase("speed", forward_speed, call, ident)
    del call
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trained = phase("train", train_flagship, Path(tmp), ident)
        step_check = phase("f32_step", card_vs_cpu_step)
        entry = phase("train_sr", train_entry_point, Path(tmp))
        seg = {f"{kind}_{_dname(dtype)}": phase(f"seg_{kind}_{_dname(dtype)}", train_seg, kind,
                                                dtype, ident)
               for kind, dtype in (("protocol", torch.bfloat16), ("protocol", torch.float32),
                                   ("vanilla", torch.bfloat16))}
        seg_step = phase("seg_f32_step", seg_card_vs_cpu_step)
        seg_cli = phase("seg_cli", seg_entry_points, Path(tmp))
        streamed = phase("streamed", streamed_flagship, Path(tmp), ident)
        deep = phase("deep", deep_config, Path(tmp), ident)
        vanilla = phase("vanilla_sr", vanilla_sr, ident)
        vanilla_step = phase("vanilla_sr_f32_step", vanilla_card_vs_cpu_step)
        sr_cli = phase("sr_cli", sr_entry_points, Path(tmp), streamed.pop("ckpt_dir"))
        joint = phase("joint", train_joint, ident)
        joint_step = phase("joint_f32_step", joint_card_vs_cpu_step)
        joint_cli = phase("joint_cli", joint_entry_points, Path(tmp),
                          seg_cli["protocol"].pop("ckpt_dir"))
        tuned = phase("tune", tune, Path(tmp), ident)

    seconds = time.perf_counter() - t_start
    summary = {"gpu": ident, "details": details, "grads": grads, "serve": served,
               "golden": scores, "speed": speed, "train": trained, "f32_step": step_check,
               "train_sr": entry, "seg_train": seg, "seg_f32_step": seg_step,
               "seg_cli": seg_cli, "streamed": streamed, "deep": deep, "vanilla_sr": vanilla,
               "vanilla_sr_f32_step": vanilla_step, "sr_cli": sr_cli, "joint": joint,
               "joint_f32_step": joint_step, "joint_cli": joint_cli, "tune": tuned,
               "seconds": seconds,
               "k1_bwd_ptxas": spills, "host_probes": probes}
    log("[detail] " + json.dumps(summary))
    log(f"[time] {ident}: every phase passed in {seconds:.1f} s of wall time (build included)")
    seg_launches = {k: seg[f"{k}_bfloat16"]["launches"] for k in ("protocol", "vanilla")}
    sr_launches = {"streamed": streamed["launches"], "vanilla_sr": vanilla["launches"],
                   "joint": joint["launches"], "joint_served": joint_cli["served_launches"],
                   "tune": tuned["launches"],
                   "deep": {kid: {k: deep[k]["launches"][kid] for k in ("remat_0", "remat_2")}
                            for kid in ("K1", "K1_bwd", "K2")}}
    print(json.dumps(kernels_line(details, grads, trained["launches"], served["launches"],
                                  seg_launches, sr_launches, build_s)))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
