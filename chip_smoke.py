#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adunet_torch``) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one NVIDIA Hopper card (the kernels are built for sm_90a) and
exits non-zero without one. Every phase raises on failure:

1. builds the CUDA kernels from ``adunet_torch/csrc`` with ``nvcc`` (again
   if the library came from the build cache) and fails if ptxas's report
   shows a byte of spill in any of the 32 instantiations of K1's backward
   row kernel (8 widths, 2 types, with and without a conv bias), in any
   kernel of K2's backward's dw + db (the two wgrad kernels and their sum)
   or in K3 (its 6 instantiations and its weight pack);
2. prints the card's name and power limit (``nvidia-smi``);
3. holds each kernel's forward against its plain PyTorch version on the
   card, at every shape the flagship's float32 serving forward (batch 8) and
   bf16 training step (batch 32) give it, and times the kernel (CUDA events,
   and the profiler's device time per launch, since at the small shapes the
   wrapper's host cost exceeds the kernel), the plain version and one
   PyTorch library call that computes the same function (a yardstick only:
   the port never calls it; events and device time) beside the least time
   the card could take; beside each row, the host's cost of one call of the
   wrapper (``host_us``: the median over 5 runs of the wall time a call of
   20 back-to-back calls from an idle device) and the device kernels one
   call launches (the profiler, every kernel name: the phase fails unless
   K1 launches 1, K1's backward 2 and K2 at most 2, its weight pack and the
   conv); then (``k3``) holds K3, the float32 3x3 conv at the 9 served
   shapes K2's gate refuses, to its plain version and to cuDNN (TF32 off),
   two calls bit-equal, 2 device kernels a call, and times it beside its
   bound, the plain version and cuDNN in its heuristic mode and with
   ``cudnn.benchmark`` (yardsticks only), summed over a forward's 14;
4. holds each autograd Function's gradients (K1: dx, dgamma, dbeta; K2: dx,
   dw, db) against autograd through the plain version on the same CUDA
   tensors, at the training shapes in bf16 and the serving shapes in
   float32, and times forward + backward of each; then holds K1's backward
   kernel alone against ``layer_norm_relu_backward`` at the same shapes
   (counting the ReLU mask elements on which the two disagree), checks that
   its dgamma / dbeta repeat bit for bit, and times it beside its bytes
   bound, the plain backward and the library's backward; then holds K2's
   backward kernels alone (``conv3x3_same_backward``: dx, dw, db, one C
   call of 4 device kernels) against ``conv3x3_same_backward_plain`` at
   every shape K2 runs with a gradient, both types and both modes, checks
   that two calls give the same bits, and times them beside their bound,
   the plain version and the route the port took before (cuDNN's
   ``convolution_backward``); then (``resize``) holds the banded resize
   (``resize_band``) against its plain version, the dense product
   (``resize_band_plain``), forward and backward on the same CUDA tensors
   at every resize of the flagship's and the deep config's bf16 training
   steps (the degradation's float32 resizes forward) and of the served
   float32 forward (``RESIZE_PATHS``): 1e-6 of the largest |value|, plus
   one bf16 ulp per element in bf16; one launch counted a forward and one a
   backward; each timed (CUDA events over replays of a CUDA graph of
   back-to-back calls) beside the dense path with its casts and the bound
   of one pass (its bytes, read once and written once), and summed over
   one step or forward;
5. serves the trained flagship artifact over HTTP (launch counts set to 0
   just before, read just after: 16 K1 + 4 K2 + 6 resizes + 14 K3 per
   device call, no K1 backward);
6. re-derives the flagship's pinned eval numbers on the 48-tile seed-777
   corpus; exports the flagship as an int8 serving program on the card
   (``program``: ``adunet_torch.export.program``, its graph holding 16 K1,
   4 K2 and 14 K3 ops and no plain decomposition), runs it in a fresh process
   that imports no model code (16 K1, 4 K2, 6 resize and 14 K3 launches a call, output held
   to the weights path at 1e-5), serves it over HTTP as in 5 and re-derives
   the pinned numbers from it, and times its forward beside the weights
   path's; then times the serving forward;
7. trains the flagship (scale 0.5, depth 3, base 64, bf16 compute, f32
   params, Adam 1e-4; a seeded random 1x1 head in place of the zero one)
   on a device cache of synthetic images for a few device-cache steps at
   batch 32 x 256 px (counts set to 0 just before: 16 K1 forward, 16 K1
   backward, 4 K2, 4 K2 backward and 14 resizes per step, no K3),
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
    step, 22 resizes in both) and times it beside its convolutions' share
    of the bf16 peak; then holds one float32 step's gradients with and without remat equal;
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
    and times the step beside its peak memory and device idle share; then
    captures one forward + backward of the same model (no optimizer step) in
    a CUDA graph and replays it 3 times under deterministic cuDNN, each
    replay's outputs and gradients bit-equal to an eager run's (``graph``;
    the counters count the capture: 28 / 28 / 5); then (``step_graph``)
    compiles each trainer's whole step (``adunet_torch.train.compiled``:
    forward, loss, backward and Adam in one CUDA graph) at full width, the
    bf16 flagship from a device cache at batch 32 and the joint, vanilla and
    protocol segmentation and vanilla SR models at batch 8: 6 compiled steps
    against 6 eager ones from the same seeded state, bit-equal (or within the
    ``graph`` phase's tolerances, each differing tensor named), launches a
    step as eager on both sides (resizes too: 14 a flagship step),
    each side's ms/step in turns, device idle
    share and peak memory. Every training phase runs compiled steps: a
    trainer's step captures from its third call on a CUDA model;
18. takes one float32 step of the joint model at batch 1 x 256 px on the
    card and on the CPU from the same params and compares them as phase 8
    does;
19. runs ``train_joint`` for 2 epochs at full width (its ``config.json`` and
    ``result.json`` keys as the reference's), ``export_model --workload joint
    --quantize int8`` and one forward of its program on the card (28 K1, no
    K1 backward, 5 K2), then exports phase 12's protocol checkpoint, serves
    its program over HTTP (2 K2 and no K1 a device call) and holds the masks
    to the checkpoint's live model;
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
21. runs ``torchrun --standalone --nproc-per-node 1`` of
    ``adunet_torch.cli.train_sr`` (NCCL, world 1, the model wrapped in DDP)
    on the bf16 flagship at batch 32 x 256 px from a device cache for 2 x 12
    steps, and the same command without torchrun; both hold K1 / K1
    backward / K2 at 16 / 16 / 4 launches a step, and their ms/step come
    from their ``epoch_metrics.csv`` (``ddp``);
22. starts 2 processes on the one card in a gloo group (CUDA tensors) and
    holds a float32 flagship step, a float32 protocol seg step (BatchNorm
    on the global batch; per-rank statistics shown to fail the check) and a
    ``--model_shards 2`` step to one process on the same global batch of 8
    (``ddp_ranks``);
23. runs ``adunet_torch.cli.run_experiment --experiment adaptive_depth
    --scales 0.5 --mode run --auto_eval`` at full width (the H100 table's
    batch 32, bf16, a device cache; counts set to 0 just before: 16 / 16 /
    4 a step, 16 / 0 / 4 a forward), the port's ``plot_experiment_metrics``
    on its evaluation (``summary_metrics.csv``; without matplotlib the CLI
    must fail on the figures after writing it) and ``inspect`` on its
    checkpoint (``inspect_example`` without matplotlib; 16 / 0 / 4 a
    forward) (``sweep``);
24. starts 2 processes on the card in a gloo group on a (1, 2) data x space
    mesh (``--space-worker``: each holds 128 of every image's 256 rows) and
    holds one Adam step of the float32 and bf16 flagship at batch 32 and
    the bf16 deep config at batch 8 to one process: loss, params, launches a
    rank (16 / 16 / 4 and 24 / 24 / 4 with K2 in its halo-row mode), peak
    memory a rank (``space_ranks``);
25. prints one JSON line with each kernel's launches, error and times (the
    resize's from the ``resize`` phase and the counting phases), the
    card's identity line, and last ``{"ok": true, "device": {...}}``.

Every phase that counts launches also counts K2's backward
(``conv64.conv3x3_same_backward.launches``; the halo-row mode's apart): one
for each K2 launch that runs with a gradient, so 4 a flagship, deep or
space-rank step, 5 a joint step and the graph's capture, 2 a vanilla SR or
protocol seg step, 2 per lane per tuner training step, and none on a
forward without a gradient.

At the start of each phase it prints a host probe (a fixed numpy and Python
timing, the load average, the live threads, torch's CPU threads).

Phases 3 and 4 also hold K1 at C = 16 and 32 (forward and backward kernels,
float32 and bf16, full and ragged row counts) and K2 at the vanilla model's
(8, 128, 128, 64), at every shape the segmentation steps give them, K2 in
float32 at the tuner's (4, 256, 256, 64) and (16, 256, 256, 64), and K1
at every (rows, C) of the deep config up to C = 1024 and 2048 (bf16; float32
and ragged row counts at the two widest), and K1 and its backward at every
(rows, C) of the joint model's bf16 step, 2,048 x 1024 among them. Phase 3
also holds K2's halo-row mode (``conv64.conv3x3_rows``: 128 + 2 rows in,
128 out) at the shapes the space mesh gives a rank, beside cuDNN's
``F.conv2d`` with padding (0, 1).
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import os
import re
import signal
import subprocess
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
from adunet_torch.kernels import (_build, conv3x3_f32, conv64, fused_norm, launch_snapshot,
                                  reset_launches, resize_band)
from adunet_torch.kernels.conv3x3_f32 import conv3x3_f32_plain
from adunet_torch.kernels.resize_band import band_tables, resize_band_plain, resize_matrix
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


def _biased(pairs: dict) -> dict:
    """The LN+ReLU pairs of an SR path whose conv goes to the library, so
    that K1 takes its bias: all but the four after K2's convs at level 0 (C
    = 64): 12 a flagship forward, 20 a deep one."""
    return {s: n - 4 if s[1] == 64 else n for s, n in pairs.items()}

# the device kernel K2 launches for each type (a substring of its name)
K2_KERNEL = {torch.float32: "conv3x3_c64_kernel", torch.bfloat16: "conv3x3_c64_wgmma_kernel"}
K1_BWD_KERNEL = "layer_norm_relu_bwd"  # its rows kernel and its column-sum kernel
# the device kernels of a K2 backward call, by a part of their names
K2_BWD_PARTS = {"pack": ("pack_conv3x3_weights_kernel",),
                "dx": ("conv3x3_c64_wgmma_kernel", "conv3x3_c64_kernel"),
                "wgrad": ("conv3x3_c64_wgrad_wgmma_kernel", "conv3x3_c64_wgrad_kernel"),
                "sum": ("conv3x3_c64_wgrad_reduce_kernel",)}
# the backward's row kernel is built for these (C, type, conv bias) triples
K1_BWD_INSTANCES = {(c, t, b) for c in fused_norm.SUPPORTED_CHANNELS for t in ("F32", "BF16")
                    for b in (False, True)}
# K2 bf16 against its plain version: the absolute term beside one bf16 ulp,
# a few times the largest this script has read (its K2 lines print the term
# each run needs; PERF.md, "K2, the bf16 tolerance"). K1's bf16 keeps 1e-6.
K2_BF16_ATOL = 1e-5
# the host's cost of a kernel call (host_us): runs of back-to-back calls
HOST_CALLS, HOST_RUNS = 20, 5
K2_PER_CALL = sum(K2_SERVE.values())  # 4
# K3, the float32 3x3 convs of the served flagship that K2's gate refuses
# (batch 8, depth 3, 256 px): (B, H, W, C_in, C_out) -> launches a forward:
# enc1, enc2 and the bottleneck's two convs, each decoder level's smooth conv
# and its ConvBlock's two (enc0.conv0, 3 -> 64, and the 1x1 head stay on
# cuDNN). Its rows are held to the plain version and to cuDNN's F.conv2d
# (TF32 off) within K3_ATOL: outputs of unit scale summed over 9 x C_in
# <= 4,608 float32 products in other orders differ by ~1e-5 at most
K3_SERVE = {(8, 128, 128, 64, 128): 1, (8, 128, 128, 128, 128): 2, (8, 64, 64, 128, 256): 1,
            (8, 64, 64, 256, 256): 2, (8, 32, 32, 256, 512): 1, (8, 32, 32, 512, 512): 1,
            (8, 64, 64, 512, 256): 2, (8, 128, 128, 256, 128): 2, (8, 256, 256, 128, 64): 2}
K3_PER_CALL = sum(K3_SERVE.values())  # 14
K3_ATOL = 1e-4
K3_KERNEL = "conv3x3_f32_igemm_kernel"
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
# launches per training step (K1, K1 backward, K2, K2 backward) without and
# with remat_levels=2: the recompute runs the forward of enc0/1 and dec0/1
# again, not their backward
DEEP_PER_STEP = {None: (24, 24, 4, 4), 2: (32, 24, 6, 4)}
# of those, the K1 forward and backward launches that take a conv's bias:
# the recompute adds enc0's and dec0's first pairs and enc1's and dec1's
DEEP_BIAS_PER_STEP = {None: (20, 20), 2: (26, 20)}
# The streamed flagship: (K1, K1 backward, K2, K2 backward) per step, and the
# steps timed
STREAM_PER_STEP, STREAM_STEPS = (16, 16, 4, 4), 20
# The vanilla SR U-Net (base 64, depth 4: 34,525,251 params) at batch 8 x 256
# px: no LayerNorm; enc0.conv1 and dec0.conv1 run K2
VANILLA_SR_PARAMS = 34_525_251
K2_VANILLA_SR = {(8, 256, 256, 64): 2}
# launches per step (K1, K1 backward, K2, K2 backward)
SEG_PER_STEP = {"protocol": (0, 0, sum(K2_PROTOCOL.values()), sum(K2_PROTOCOL.values())),
                "vanilla": (sum(K1_VANILLA.values()), sum(K1_VANILLA.values()),
                            sum(K2_VANILLA.values()), sum(K2_VANILLA.values()))}

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
# launches (K1, K1 backward, K2, K2 backward) per training step and per
# served forward
JOINT_PER_STEP = (sum(K1_JOINT.values()), sum(K1_JOINT.values()), sum(K2_JOINT.values()),
                  sum(K2_JOINT.values()))
JOINT_PER_FORWARD = (JOINT_PER_STEP[0], 0, JOINT_PER_STEP[2], 0)

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
# The ddp phase: train_sr on the flagship (bf16, batch 32 x 256 px, device
# cache of 8 training images) under torchrun and without it: 48 patches an
# image, 12 steps an epoch. The ddp_ranks phase: two processes on the card
# against one at a global batch of 8, float32, Adam at the trainers' rate.
DDP_EPOCHS, DDP_PPI = 2, 48
RANKS_BATCH, RANKS_LR = 8, 1e-4
# The data x space mesh: K2's halo-row mode at the rows a (1, 2) mesh gives
# each rank of a 256-px image (128 + a neighbour row above and below), at the
# flagship's batch in bf16 and float32 and the deep config's in bf16, 4
# launches a step each (enc0.conv1, dec0.conv1, head.conv0 / 1); the
# space_ranks phase's cases (scale, depth, batch, compute type); the sweep
# phase's patches per image (8 training images: 2 steps of 32)
K2_HALO_CASES = [((32, 130, 256, 64), 4, torch.bfloat16), ((32, 130, 256, 64), 4, torch.float32),
                 ((8, 130, 256, 64), 4, torch.bfloat16)]
SPACE_CASES = {"flagship_f32": (0.5, 3, 32, torch.float32),
               "flagship_bf16": (0.5, 3, 32, torch.bfloat16),
               "deep_bf16": (DEEP_SCALE, DEEP_DEPTH, DEEP_BATCH, torch.bfloat16)}
SWEEP_PPI = 8
# The banded resize (``kernels/resize_band.py``): path -> (batch, level
# sizes, type, gradient) of the resizes of the flagship's bf16 training step
# (batch 32), the deep config's (batch 8) and the served flagship's float32
# forward (batch 8). Level i holds 64 << i channels; an encoder level resizes
# its own down to the next size, a decoder level the next level's up; a
# training step also degrades its batch at 0.5 (area 256 -> 128, then cv2's
# cubic 128 -> 256, RGB, float32, no gradient). Launches: one a resize and
# one a resize's backward, so 14 a flagship step, 22 a deep step (with or
# without remat: the resizes sit outside the checkpointed blocks) and 6 a
# served forward
RESIZE_PATHS = {"train": (TRAIN_BATCH, [256, 128, 64, 32], torch.bfloat16, True),
                "deep": (DEEP_BATCH, _DEEP_SIZES, torch.bfloat16, True),
                "serve": (8, [256, 128, 64, 32], torch.float32, False)}
RESIZE_PER_STEP = {"train": 14, "deep": 22}
RESIZE_PER_FORWARD = 6
# back-to-back calls in one CUDA graph when a resize is timed
RESIZE_TIMED = 10

TUNE_RESULT_KEYS = {"direction", "sampler", "n_trials", "n_complete", "n_pruned", "best_value",
                    "best_params", "trials"}


def log(msg: str) -> None:
    print(msg, flush=True)


def _ptxas_functions(build_log: str) -> list[dict]:
    """Each kernel of ptxas's report in the build log (``-Xptxas -v``: a
    "Function properties for <name>" line, then the stack and spill line,
    then the registers line): its mangled name, stack frame, spill stores
    and loads, and registers."""
    found = []
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            found.append({"name": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if found and m:
            found[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if found and m and "registers" not in found[-1]:
            found[-1]["registers"] = int(m.group(1))
    return [f for f in found if "stack" in f]


def check_k1_bwd_spills(build_log: str) -> list[dict]:
    """Registers, stack frame and spills of each instantiation of K1's
    backward row kernel (C, type, with or without a conv bias), from ptxas's
    report in the build log. Raises if an instantiation is missing from the
    report or spills any bytes."""
    found = {}
    for f in _ptxas_functions(build_log):
        inst = re.search(r"layer_norm_relu_bwd_rows_kernelI\w*?_\d+(F32|BF16)ELi(\d+)ELb([01])E",
                         f["name"])
        if inst:
            key = (int(inst.group(2)), inst.group(1), inst.group(3) == "1")
            found[key] = dict(C=key[0], type=key[1], bias=key[2], stack=f["stack"],
                              spill_stores=f["spill_stores"], spill_loads=f["spill_loads"],
                              registers=f.get("registers"))
    rows = [found[k] for k in sorted(found)]
    for r in rows:
        log(f"[spill] K1 backward C={r['C']} {r['type']}{' conv bias' if r['bias'] else ''}: "
            f"{r.get('registers')} registers, stack {r['stack']} bytes, spill stores "
            f"{r['spill_stores']} bytes, spill loads {r['spill_loads']} bytes")
    if set(found) != K1_BWD_INSTANCES:
        raise AssertionError(f"ptxas reported K1 backward instantiations {sorted(found)}, "
                             f"expected {sorted(K1_BWD_INSTANCES)}")
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"K1 backward spills: {spilled}")
    return rows


# the kernels that must not spill (mangled-name parts). K2's backward: the
# bf16 tensor-core kernel of the forward and of the backward's dx, and the
# backward's dw + db kernels and their sum. K3: the conv, in each of its
# instantiations (tile channels 64 / 128 x tile width 32 / 64 / 128), and
# its weight pack.
K2_BWD_KERNELS = ("conv3x3_c64_wgmma_kernel", "conv3x3_c64_wgrad_wgmma_kernel",
                  "conv3x3_c64_wgrad_kernel", "conv3x3_c64_wgrad_reduce_kernel")
K3_KERNELS = (K3_KERNEL, "pack_w3x3_f32_kernel")
K3_INSTANCES = {(co, wt) for co in (64, 128) for wt in (32, 64, 128)}


def check_spills(build_log: str, label: str, kernels: tuple) -> list[dict]:
    """Registers and spills of every instantiation of ``kernels`` that the
    build compiled, from ptxas's report as ``check_k1_bwd_spills`` reads it
    (``label`` names them in the ``[spill]`` lines). Raises if one of them is
    missing from the report or any spills."""
    found = []
    for f in _ptxas_functions(build_log):
        # the mangled name's length prefix keeps one kernel's name from matching another's
        kernel = next((k for k in kernels if re.search(rf"\d{k}", f["name"])), None)
        if kernel:
            found.append(dict(kernel=kernel, **f))
    for r in found:
        log(f"[spill] {label} {r['kernel']} ({r['name']}): {r.get('registers')} registers, "
            f"stack {r['stack']} bytes, spill stores {r['spill_stores']} bytes, spill loads "
            f"{r['spill_loads']} bytes")
    missing = set(kernels) - {r["kernel"] for r in found}
    if missing:
        raise AssertionError(f"ptxas reported no {sorted(missing)}")
    spilled = [r for r in found if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"{label} spills: {spilled}")
    return found


def check_k2_bwd_spills(build_log: str) -> list[dict]:
    """``check_spills`` of K2's backward kernels (the bf16 conv kernel, which
    also runs the forward, in its forward and dx instantiations, the wgrad
    kernels and their sum's instantiations)."""
    return check_spills(build_log, "K2 backward", K2_BWD_KERNELS)


def check_k3_spills(build_log: str) -> list[dict]:
    """``check_spills`` of K3's kernels; raises unless ptxas reported each of
    the conv's ``K3_INSTANCES`` (its template arguments, CO and WT)."""
    found = check_spills(build_log, "K3", K3_KERNELS)
    inst = {tuple(int(v) for v in m.groups()) for r in found
            if (m := re.search(rf"{K3_KERNEL}ILi(\d+)ELi(\d+)E", r["name"]))}
    if inst != K3_INSTANCES:
        raise AssertionError(f"ptxas reported K3 instantiations {sorted(inst)}, expected "
                             f"{sorted(K3_INSTANCES)}")
    return found


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
                       per_run: int = 1, totals: dict | None = None) -> tuple[float | None, int]:
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
    stands in for it. ``totals``, where given, receives under
    ``"kernels_per_run"`` the count of every device kernel (no name filter)
    per run in the session the time comes from, and under ``"by_name"`` the
    device time per run of each kernel name there (None where none came)."""
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
            if totals is not None:
                every = [e for e in prof.key_averages()
                         if str(getattr(e, "device_type", "")).endswith("CUDA")]
                totals["kernels_per_run"] = sum(e.count for e in every) / iters
                totals["by_name"] = {e.key: _device_us(e) / iters / 1e3 for e in every}
            return sum(_device_us(e) for e in hits) / iters / 1e3, count
    log(f"[profiler] 3 sessions recorded {count} launches of {kernel_name or 'any kernel'} "
        f"(made {want if kernel_name else 'some'}): device time not measured")
    if totals is not None:
        totals["kernels_per_run"], totals["by_name"] = None, None
    return None, count


def host_us(fn) -> float:
    """The host's cost of one call of ``fn``: the median over HOST_RUNS runs of
    the wall time a call of HOST_CALLS back-to-back calls, each run started
    from an idle device and ended by one synchronize. Where the kernel takes
    longer on the card than its call on the host, this is the device's time."""
    fn()
    per_call = []
    for _ in range(HOST_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    return float(np.median(per_call))


def launch_cost(kid: str, fn, kernel_name: str | None, per_run: int = 1) -> dict:
    """The device time of ``kernel_name`` (None: of every kernel) per call of
    ``fn`` (profiler), the device kernels a call of every name, and the
    host's cost of a call (``host_us``). Raises where a call launches other
    than the kernels its wrapper should: K1 1, K1 backward 2 (rows and column
    sums), K2 (both modes) at most 2 (the weight pack and the conv), K2's
    backward (both modes) 4 (the weight pack, the dx conv, the dw + db
    partials and their sum). A session whose count
    is not a whole number a call dropped records and is repeated, up to 3
    in all. Where the profiler recorded no session, the count is not
    measured and the check fails."""
    totals: dict = {}
    for _ in range(3):  # a session that dropped a record counts a fraction a call
        dev_ms, dev_n = profiled_device_ms(fn, kernel_name, per_run=per_run, totals=totals)
        per_call = totals["kernels_per_run"]
        if per_call is not None and float(per_call).is_integer():
            break
    allowed = {"K1": (1, 1), "K1_bwd": (2, 2), "K2": (1, 2), "K2_halo": (1, 2),
               "K2_bwd": (4, 4), "K2_bwd_halo": (4, 4), "K3": (2, 2)}[kid]
    if per_call is None or not allowed[0] <= per_call <= allowed[1]:
        raise AssertionError(f"{kid}: {per_call} device kernels a call (profiler), expected "
                             f"{allowed[0]}..{allowed[1]}: {totals['by_name']}")
    others = {k: v for k, v in (totals["by_name"] or {}).items()
              if kernel_name is not None and kernel_name not in k}
    return {"device_ms": dev_ms, "device_launches_recorded": dev_n,
            "device_kernels_per_call": per_call, "other_kernels_device_ms": others,
            "by_name_device_ms": totals["by_name"], "host_us": host_us(fn)}


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


def grad_close(what: str, got: torch.Tensor, want: torch.Tensor, rel: float,
               rounded_to: torch.dtype | None = None) -> float:
    """Max |got - want| / max |want|; raises past ``rel`` or past one bf16 ulp
    relative per element plus ``rel * max|want|`` for bf16 tensors, or for
    float32 ones whose values were rounded to bf16 (``rounded_to``: K2's dw
    and db of float32 parameters with bf16 activations)."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    scale = w.abs().max().clamp_min(1e-30)
    err = (g - w).abs()
    ulp = (2.0**-7) * w.abs() if torch.bfloat16 in (got.dtype, rounded_to) else 0.0
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
    """x of ``dtype``; the weight and bias float32, as the model holds them
    (K2 rounds them to x's type itself)."""
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    wt = torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
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
            + [(s, n, torch.float32, "joint_served") for s, n in K1_JOINT_SERVED.items()]
            + _k1_bias_cases(serve=True))


def _k1_bias_cases(serve: bool) -> list:
    """K1 with a conv bias (a path named ``...+bias``): the flagship's
    training and the deep config's pairs that take one, and (``serve``) the
    served flagship's through the weights path (its program keeps the bias
    in the conv)."""
    return ([(s, n, torch.bfloat16, "train+bias") for s, n in _biased(K1_TRAIN).items()]
            + [(s, n, torch.float32, "serve+bias") for s, n in _biased(K1_SERVE).items()
               if serve]
            + [(s, n, torch.bfloat16, "deep+bias") for s, n in _biased(K1_DEEP).items()])


def _k1_bwd_cases():
    return ([(s, n, torch.bfloat16, "train") for s, n in K1_TRAIN.items()]
            + [(s, n, torch.float32, "serve") for s, n in K1_SERVE.items()]
            + [(s, n, torch.bfloat16, "vanilla") for s, n in K1_VANILLA.items()]
            + [(s, 0, dtype, "narrow") for s, dtype in K1_NARROW]
            + [(s, n, torch.bfloat16, "deep") for s, n in K1_DEEP.items()]
            + [(s, 0, dtype, "wide") for s, dtype in K1_WIDE]
            + [(s, n, torch.bfloat16, "joint") for s, n in K1_JOINT.items()]
            + _k1_bias_cases(serve=False))


def _k2_cases():
    return ([(s, n, torch.float32, "serve") for s, n in K2_SERVE.items()]
            + [(s, n, torch.bfloat16, "serve") for s, n in K2_SERVE.items()]
            + [(s, n, torch.bfloat16, "train") for s, n in K2_TRAIN.items()]
            + [(s, n, dtype, "vanilla") for s, n in K2_VANILLA.items()
               for dtype in (torch.bfloat16, torch.float32)]
            + [(s, n, torch.float32, "tune") for s, n in K2_TUNE.items()])


def _conv_bias(gen, path: str, c: int, dtype: torch.dtype) -> torch.Tensor | None:
    """A conv's bias for K1 on a ``...+bias`` path, in x's type as
    ``ConvBlock`` passes it, else None."""
    if not path.endswith("+bias"):
        return None
    return torch.randn(c, generator=gen, device="cuda").mul_(0.3).to(dtype)


def check_k1(gen: torch.Generator) -> list[dict]:
    """K1 against its plain version at every path's shapes. On a ``+bias``
    path K1 takes a conv's bias, and must equal PyTorch's add of the bias
    followed by K1 without one bit for bit; ``unfused_ms`` times that add and
    K1, the route the bias took before, in place of the plain and library
    yardsticks, which the rows without a bias at the same shapes carry."""
    rows_out = []
    for (rows, c), per_call, dtype, path in _k1_cases():
        x, g, b = _k1_inputs(gen, rows, c, dtype)
        cb = _conv_bias(gen, path, c, dtype)

        def k1():
            return fused_norm.layer_norm_relu(x, g, b, 1e-3, cb)

        got = k1()
        want = fused_norm.layer_norm_relu_plain(x, g, b, 1e-3, cb)
        extra = {}
        if cb is not None:
            def unfused():
                return fused_norm.layer_norm_relu(x + cb, g, b)

            if not torch.equal(got, unfused()):
                raise AssertionError(f"K1 {path} {rows}x{c} {dtype}: the conv bias inside K1 "
                                     "differs from its add before K1")
            extra["unfused_ms"] = cuda_ms(unfused, 50)
        torch.cuda.synchronize()
        err = close_enough(got, want, dtype, 1e-5)
        # elements within a rounding of 0 that one ReLU keeps and the other zeroes
        n_flip = int(((got > 0) != (want > 0)).sum())
        gl, bl = g.to(dtype), b.to(dtype)
        ms = cuda_ms(k1, 50)
        cost = launch_cost("K1", k1, "layer_norm_relu_kernel")
        dev_ms, dev_n = cost["device_ms"], cost["device_launches_recorded"]
        plain = lib = lib_dev = lib_n = None  # a +bias row's yardstick: the route before
        if cb is None:
            plain = cuda_ms(lambda: fused_norm.layer_norm_relu_plain(x, g, b), 10)
            lib = cuda_ms(lambda: F.relu(F.layer_norm(x, (c,), gl, bl, 1e-3)), 50)
            lib_dev, lib_n = profiled_device_ms(lambda: F.relu(F.layer_norm(x, (c,), gl, bl, 1e-3)))
        es = x.element_size()
        bnd, by = bound_ms(2 * rows * c * es + 2 * c * 4 + (0 if cb is None else c * es),
                           9 * rows * c, dtype)
        rows_out.append(dict(kernel="K1", path=path, shape=[rows, c], dtype=_dname(dtype),
                             per_call=per_call, max_abs_err=err, mask_disagreements=n_flip,
                             ms=ms, **cost, plain_ms=plain, library_ms=lib,
                             library_device_ms=lib_dev, library_kernels_recorded=lib_n,
                             bound_ms=bnd, bound_by=by, **extra))
        unfused_str = (f", add + K1 (the route before) {extra['unfused_ms']:.4f} ms"
                       if extra else "")
        log(f"[K1] {path} rows={rows} C={c} {dtype}: max|err|={err:.2e}, mask disagreements "
            f"{n_flip}; kernel {ms:.4f} ms "
            f"(events; profiler device time {_ms(dev_ms)} over {dev_n} launches; host "
            f"{cost['host_us']:.2f} us a call, {cost['device_kernels_per_call']:g} device "
            f"kernels a call), plain {_ms(plain)}, F.layer_norm+relu {_ms(lib)} (device time "
            f"{_ms(lib_dev)}){unfused_str}, bound {bnd:.4f} ms ({by})")
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
        cost = launch_cost("K2", lambda: conv64.conv3x3_same(x, wt, bias), K2_KERNEL[dtype])
        dev_ms, dev_n = cost["device_ms"], cost["device_launches_recorded"]
        plain = cuda_ms(lambda: conv64.conv3x3_same_plain(x, wt, bias), 5)
        # cuDNN takes the parameters in x's type: cast here, outside the timing
        xn, wl, bl = x.permute(0, 3, 1, 2), wt.to(dtype), bias.to(dtype)  # NCHW view
        lib = cuda_ms(lambda: F.conv2d(xn, wl, bl, padding=1), 20)
        lib_dev, lib_n = profiled_device_ms(lambda: F.conv2d(xn, wl, bl, padding=1))
        bnd, by = _k2_bound(shape, dtype)
        rows_out.append(dict(kernel="K2", path=path, shape=list(shape), dtype=_dname(dtype),
                             per_call=per_call, max_abs_err=err, **extra, ms=ms, **cost,
                             plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                             library_kernels_recorded=lib_n, bound_ms=bnd, bound_by=by))
        needed = (f" (absolute term needed {extra['abs_term_needed']:.3e}; {extra['past_1e-6']} "
                  f"of {extra['elements']} past 1e-6)" if extra else "")
        log(f"[K2] {path} x={'x'.join(map(str, shape))} {dtype}: max|err|={err:.2e}{needed} "
            f"kernel {ms:.4f} ms (events; profiler device time {_ms(dev_ms)} over {dev_n} "
            f"launches, other kernels {cost['other_kernels_device_ms']}; host "
            f"{cost['host_us']:.2f} us a call, {cost['device_kernels_per_call']:g} device "
            f"kernels a call), plain {plain:.4f} ms, F.conv2d (cuDNN, TF32 off) {lib:.4f} ms "
            f"(device time {_ms(lib_dev)}), bound {bnd:.4f} ms ({by})")
        del x, got, want
    return rows_out


def _k3_bound(shape) -> tuple[float, str]:
    bsz, h, w, ci, co = shape
    pixels = bsz * h * w
    return bound_ms(pixels * (ci + co) * 4 + 9 * ci * co * 4 + co * 4,
                    2 * pixels * 9 * ci * co + pixels * co, torch.float32)


def _library_ms(fn, benchmark: bool) -> tuple[float, float | None]:
    """Events ms and profiler device ms of ``fn`` (a cuDNN call) with
    ``torch.backends.cudnn.benchmark`` set to ``benchmark``: cuDNN's
    heuristic pick, or the pick its autotuner times at the first call (made
    here, outside the timing). The port never sets that mode; restored after."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = benchmark
    try:
        fn()
        return cuda_ms(fn, 10), profiled_device_ms(fn, iters=10)[0]
    finally:
        torch.backends.cudnn.benchmark = before


def check_k3(gen: torch.Generator) -> list[dict]:
    """K3 at every shape of the served flagship's float32 forward
    (``K3_SERVE``): held to its plain version and to cuDNN's ``F.conv2d``
    (TF32 off) within ``K3_ATOL``, two calls bit-equal, and timed (events;
    the profiler's device time of the conv and of its weight pack) beside its
    bound, the plain version, and cuDNN as a yardstick in its heuristic mode
    and with ``cudnn.benchmark``. The summary line gives the share of the
    bound over one forward's 14 launches."""
    rows_out = []
    for shape, per_call in K3_SERVE.items():
        bsz, h, w, ci, co = shape
        x = torch.randn(bsz, h, w, ci, generator=gen, device="cuda")
        wt = torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * (1.0 / (9 * ci)) ** 0.5
        bias = torch.randn(co, generator=gen, device="cuda") * 0.1
        xn = x.permute(0, 3, 1, 2)  # NCHW view, channels_last

        def k3():
            return conv3x3_f32(x, wt, bias)

        def lib():
            return F.conv2d(xn, wt, bias, padding=1)

        with torch.inference_mode():
            got, again = k3(), k3()
            err = close_enough(got, conv3x3_f32_plain(x, wt, bias), torch.float32, K3_ATOL)
            lib_err = close_enough(got, lib().permute(0, 2, 3, 1), torch.float32, K3_ATOL)
            if not torch.equal(got, again):
                raise AssertionError(f"K3 at {shape}: two calls differ")
            ms = cuda_ms(k3, 20)
            cost = launch_cost("K3", k3, K3_KERNEL)
            pack = [v for k, v in (cost["by_name_device_ms"] or {}).items() if "pack_w3x3" in k]
            plain = cuda_ms(lambda: conv3x3_f32_plain(x, wt, bias), 3)
            lib_ms, lib_dev = _library_ms(lib, False)
            bench_ms, bench_dev = _library_ms(lib, True)
        bnd, by = _k3_bound(shape)
        dev_ms = cost["device_ms"]
        share = None if dev_ms is None else 100.0 * bnd / dev_ms
        rows_out.append(dict(kernel="K3", path="serve", shape=list(shape), dtype="float32",
                             per_call=per_call, max_abs_err=err, max_abs_err_library=lib_err,
                             ms=ms, **cost, pack_device_ms=pack[0] if pack else None,
                             plain_ms=plain, library_ms=lib_ms, library_device_ms=lib_dev,
                             library_benchmark_ms=bench_ms,
                             library_benchmark_device_ms=bench_dev, bound_ms=bnd, bound_by=by,
                             bound_share=share))
        log(f"[K3] serve x={bsz}x{h}x{w}x{ci} -> {co} ({per_call} a forward): max|err| "
            f"{err:.2e} (plain), {lib_err:.2e} (cuDNN); kernel {ms:.4f} ms (events; device "
            f"{_ms(dev_ms)} conv, {_ms(pack[0] if pack else None)} pack; host "
            f"{cost['host_us']:.2f} us a call, {cost['device_kernels_per_call']:g} device kernels "
            f"a call), bound {bnd:.4f} ms ({by}), "
            f"{'not measured' if share is None else f'{share:.1f} %'} of it; plain "
            f"{plain:.4f} ms; cuDNN heuristic {lib_ms:.4f} ms (device {_ms(lib_dev)}), "
            f"cudnn.benchmark {bench_ms:.4f} ms (device {_ms(bench_dev)})")
        del x, got, again
    fwd = {k: (None if None in (vals := [r[k] for r in rows_out])
               else sum(v * r["per_call"] for v, r in zip(vals, rows_out)))
           for k in ("device_ms", "bound_ms", "library_device_ms", "library_benchmark_device_ms")}
    log(f"[K3] one served forward ({K3_PER_CALL} launches): conv device {_ms(fwd['device_ms'])} "
        f"against a bound of {fwd['bound_ms']:.4f} ms"
        + ("" if fwd["device_ms"] is None else f" ({100 * fwd['bound_ms'] / fwd['device_ms']:.1f} %)")
        + f"; cuDNN heuristic {_ms(fwd['library_device_ms'])}, cudnn.benchmark "
        f"{_ms(fwd['library_benchmark_device_ms'])}")
    torch.cuda.empty_cache()
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


def k1_params_close(what: str, got, want, flips: torch.Tensor, rerun) -> tuple[float, ...]:
    """K1's dgamma / dbeta (and a conv bias's dbias, in x's type: plus one
    bf16 ulp there) against the plain backward's at 1e-3 relative. An
    element on which the two ReLU masks disagree moves its column's sums by
    its cotangent, so where any does, they are computed
    again over the rows without one (``rerun(keep) -> (got, want)``, each a
    (dgamma, dbeta[, dbias]) tuple): the masks are row-local, so those rows
    agree."""
    if bool(flips.any()):
        keep = ~flips.reshape(-1, flips.shape[-1]).any(dim=1)
        got, want = rerun(keep)
    return tuple(grad_close(f"{what} {n}", g, w, 1e-3)
                 for n, g, w in zip(("dgamma", "dbeta", "dbias"), got, want))


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
    runs. On a ``+bias`` path the backward takes a conv's bias: dbias too,
    and dbias against dx summed over the rows in x's type (the conv's bias
    gradient before) at 1e-3 relative plus one ulp; ``unfused_ms`` times
    that route, the backward without the bias and that sum, in place of the
    yardsticks (as in ``check_k1``)."""
    rows_out = []
    for (rows, c), per_call, dtype, path in _k1_bwd_cases():
        x, a, b = _k1_inputs(gen, rows, c, dtype)
        gy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
        cb = _conv_bias(gen, path, c, dtype)
        xb = x if cb is None else x + cb

        def bwd():
            return fused_norm._launch_backward(x, a, b, gy, 1e-3, cb)

        got = bwd()
        want = fused_norm.layer_norm_relu_backward(x, a, b, gy, 1e-3, cb)
        flips = _k1_flips(xb, a, b)
        again = bwd()
        torch.cuda.synchronize()
        what = f"K1 backward {path} {rows}x{c} {dtype}"
        dx_rel, dx_abs, n_flip, n_out = k1_dx_close(
            what + " dx", got[0], want[0], flips, 1e-5 if dtype == torch.float32 else 1e-4)
        param_rel = k1_params_close(
            what, got[1:], want[1:], flips,
            lambda keep: (fused_norm._launch_backward(x[keep], a, b, gy[keep], 1e-3, cb)[1:],
                          fused_norm.layer_norm_relu_backward(x[keep], a, b, gy[keep], 1e-3,
                                                              cb)[1:]))
        rel_err = {"dx": dx_rel, **dict(zip(("dgamma", "dbeta", "dbias"), param_rel))}
        extra = {}
        if cb is not None:
            rel_err["dbias_vs_sum"] = grad_close(what + " dbias against the sum of dx",
                                                 got[3], got[0].sum(dim=0), 1e-3)

            def unfused():
                return fused_norm._launch_backward(xb, a, b, gy, 1e-3)[0].sum(dim=0)

            extra["unfused_ms"] = cuda_ms(unfused, 20)
        if not all(torch.equal(u, v) for u, v in zip(again[1:], got[1:])):
            raise AssertionError(f"{what}: the parameter sums differ between two runs")
        del got, want, again, flips
        ms = cuda_ms(bwd, 20)
        cost = launch_cost("K1_bwd", bwd, K1_BWD_KERNEL, per_run=2)
        dev_ms, dev_n = cost["device_ms"], cost["device_launches_recorded"]
        plain = lib = lib_dev = lib_n = None  # a +bias row's yardstick: the route before
        if cb is None:
            plain = cuda_ms(lambda: fused_norm.layer_norm_relu_backward(x, a, b, gy), 3)
            xl = x.detach().requires_grad_(True)
            al, bl = (t.to(dtype).requires_grad_(True) for t in (a, b))
            yl = F.relu(F.layer_norm(xl, (c,), al, bl, 1e-3))

            def lib_bwd():
                return torch.autograd.grad(yl, [xl, al, bl], gy, retain_graph=True)

            lib = cuda_ms(lib_bwd, 20)
            lib_dev, lib_n = profiled_device_ms(lib_bwd)
            del xl, yl
        # read x and g, write dx, plus the parameters and their gradients;
        # the arithmetic is float32 whatever the storage type
        es = x.element_size()
        bnd, by = bound_ms(3 * rows * c * es + 4 * c * 4 + (0 if cb is None else 2 * c * es),
                           20 * rows * c, torch.float32)
        rows_out.append(dict(kernel="K1_bwd", path=path, shape=[rows, c], dtype=_dname(dtype),
                             per_call=per_call, max_abs_err=dx_abs, rel_err=rel_err,
                             mask_disagreements=n_flip, rows_left_out=n_out, ms=ms, **cost,
                             plain_ms=plain,
                             library_ms=lib, library_device_ms=lib_dev,
                             library_kernels_recorded=lib_n, bound_ms=bnd, bound_by=by,
                             **extra))
        unfused_str = (f", K1 backward + the conv's bias sum (the route before) "
                       f"{extra['unfused_ms']:.4f} ms" if extra else "")
        log(f"[K1 bwd] {path} rows={rows} C={c} {dtype}: rel err dx {dx_rel:.1e} (max |err| "
            f"{dx_abs:.2e}), "
            + ", ".join(f"{n} {e:.1e}" for n, e in rel_err.items() if n != "dx")
            + f"; mask disagreements "
            f"{n_flip} ({n_out} rows left out); kernel {ms:.4f} ms (events; profiler device "
            f"time {_ms(dev_ms)} over {dev_n} launches; host "
            f"{cost['host_us']:.2f} us a call, {cost['device_kernels_per_call']:g} device "
            f"kernels a call), "
            f"plain {_ms(plain)}, library backward {_ms(lib)} (device time {_ms(lib_dev)})"
            f"{unfused_str}, bound {bnd:.4f} ms ({by})")
        del x, xb, gy
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
    K2's dx is held at 1e-4: its backward's dx runs K2's forward kernel on
    the cotangent, whose float32 sums (and tensor-core sums in bf16) run in
    another order than the plain matmuls'. K1's dx is
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
                return F.conv2d(x_.permute(0, 3, 1, 2), a_.to(x_.dtype), b_.to(x_.dtype),
                                padding=1).permute(0, 2, 3, 1)
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
            # dw, db: float32 parameters' gradients, rounded to x's type
            errs.update({n: grad_close(f"{kid} {path} {n}", g_, w_, r, rounded_to=dtype)
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


def _k2_bwd_cases():
    """(x's shape, launches a step of its path, dtype, path, halo) of K2's
    backward: every shape K2 runs with a gradient (``serve`` bf16 is the
    deep config's, the joint model's, the vanilla SR and protocol models'
    (8, 256, 256, 64)), and the space mesh's halo-row shapes."""
    return ([(s, n, torch.bfloat16, "train", 0) for s, n in K2_TRAIN.items()]
            + [(s, 0, torch.float32, "serve", 0) for s in K2_SERVE]
            + [(s, n, torch.bfloat16, "serve", 0) for s, n in K2_DEEP.items()]
            + [(s, n, dtype, "vanilla", 0) for s, n in K2_VANILLA.items()
               for dtype in (torch.bfloat16, torch.float32)]
            + [(s, n, torch.float32, "tune", 0) for s, n in K2_TUNE.items()]
            + [(s, n, dtype, "space", 1) for s, n, dtype in K2_HALO_CASES])


def k2_library_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, pad_h: int):
    """What the port ran for K2's backward before its kernels, a yardstick
    only: cuDNN's ``convolution_backward`` on the NCHW views (w cast to x's
    type) for dx and dw, and db summed in float32 from the cotangent."""
    dxn, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.to(x.dtype), None, [1, 1], [pad_h, 1],
        [1, 1], False, [0, 0], 1, [True, True, False])
    return dxn, dw, g.sum(dim=(0, 1, 2), dtype=torch.float32)


def _k2_bwd_bound(x_shape, dtype, halo: int) -> tuple[float, str]:
    """x, g and dx read or written once in x's type, the float32 weight and
    dw, db; dx's taps over every x pixel (the halo-row mode's x holds H + 2
    rows) and dw's over every g pixel."""
    bsz, hx, w, c = x_shape
    px_x, px_g = bsz * hx * w, bsz * (hx - 2 * halo) * w
    es = torch.empty((), dtype=dtype).element_size()
    return bound_ms((2 * px_x + px_g) * c * es + 2 * 9 * 64 * 64 * 4 + 64 * 4,
                    2 * 9 * 64 * 64 * (px_x + px_g) + px_g * 64, dtype)


def k2_bwd_parts(by_name: dict | None) -> dict | None:
    """A K2 backward call's device time per call split by its device
    kernels (``K2_BWD_PARTS``: the weight pack, the dx conv, the dw + db
    partials, their sum), from the profiler's times by kernel name; None
    where the profiler measured none. A kernel none of the parts names
    raises."""
    if by_name is None:
        return None
    parts = dict.fromkeys(K2_BWD_PARTS, 0.0)
    for name, ms in by_name.items():
        part = next((p for p, subs in K2_BWD_PARTS.items() if any(sub in name for sub in subs)),
                    None)
        if part is None:
            raise AssertionError(f"K2 backward: device kernel {name} is none of {K2_BWD_PARTS}")
        parts[part] += ms
    return parts


def check_k2_backward(gen: torch.Generator) -> list[dict]:
    """K2's backward kernels (``conv64.conv3x3_same_backward``, one C call of
    4 device kernels) against ``conv3x3_same_backward_plain`` on the same
    CUDA tensors at every shape K2 runs with a gradient, both types and both
    modes: dx at 1e-4 relative to max |dx| (plus one bf16 ulp per element in
    bf16), dw and db at 1e-3 (plus one bf16 ulp where rounded to bf16):
    ``check_backward``'s tolerances. dx, dw and db must be bit-equal over two
    calls. Timed beside the bound, the plain version and the route the port
    took before (``k2_library_backward``: cuDNN)."""
    rows_out = []
    for x_shape, per_call, dtype, path, halo in _k2_bwd_cases():
        kid = "K2_bwd_halo" if halo else "K2_bwd"
        x, wt, _ = _k2_inputs(gen, x_shape, dtype)
        g_shape = (x_shape[0], x_shape[1] - 2 * halo, *x_shape[2:])
        gy = torch.randn(*g_shape, generator=gen, device="cuda").to(dtype)
        pad_h = 1 - halo

        def bwd():
            return conv64.conv3x3_same_backward(x, wt, gy, bias_dtype=torch.float32, pad_h=pad_h)

        def plain_bwd():
            return conv64.conv3x3_same_backward_plain(x, wt, gy, bias_dtype=torch.float32,
                                                      pad_h=pad_h)

        got = bwd()
        want = plain_bwd()
        again = bwd()
        torch.cuda.synchronize()
        what = f"{kid} {path} {'x'.join(map(str, x_shape))} {dtype}"
        errs = {"dx": grad_close(what + " dx", got[0], want[0], 1e-4)}
        errs.update({n: grad_close(f"{what} {n}", a, b, 1e-3, rounded_to=dtype)
                     for n, a, b in (("dw", got[1], want[1]), ("db", got[2], want[2]))})
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: dx / dw / db differ between two calls")
        abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        del got, want, again
        ms = cuda_ms(bwd, 20)
        cost = launch_cost(kid, bwd, None)
        plain = cuda_ms(plain_bwd, 3)
        lib = cuda_ms(lambda: k2_library_backward(x, wt, gy, pad_h), 20)
        lib_dev, lib_n = profiled_device_ms(lambda: k2_library_backward(x, wt, gy, pad_h))
        bnd, by = _k2_bwd_bound(x_shape, dtype, halo)
        parts = k2_bwd_parts(cost["by_name_device_ms"])
        rows_out.append(dict(kernel=kid, path=path, shape=list(x_shape), dtype=_dname(dtype),
                             per_call=per_call, max_abs_err=abs_err, rel_err=errs, ms=ms, **cost,
                             plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                             library_kernels_recorded=lib_n, bound_ms=bnd, bound_by=by,
                             device_ms_by_part=parts))
        split = ("not measured" if parts is None
                 else ", ".join(f"{k} {_ms(v)}" for k, v in parts.items()))
        log(f"[K2 bwd] {path} x={'x'.join(map(str, x_shape))} {dtype}{' halo' if halo else ''}: "
            f"rel err " + ", ".join(f"{n} {e:.1e}" for n, e in errs.items())
            + f" (max |err| {abs_err:.2e}), dx / dw / db bit-equal over two calls; kernels "
            f"{ms:.4f} ms (events; profiler device time {_ms(cost['device_ms'])}, every kernel of "
            f"the call: {split}; host {cost['host_us']:.2f} us a call, "
            f"{cost['device_kernels_per_call']:g} device kernels a call), plain {plain:.4f} ms, "
            f"cuDNN convolution_backward + float32 sum {lib:.4f} ms (device time {_ms(lib_dev)}), "
            f"bound {bnd:.4f} ms ({by})")
        del x, gy
        torch.cuda.empty_cache()
    return rows_out


def graphed_ms(fn, calls: int = RESIZE_TIMED) -> float:
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA graph
    (no host time between them), replayed 5 times, timed by CUDA events.
    An input below the 50 MB L2 stays there between calls: its time reads
    warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (5 * calls)


def _resize_cases(path: str):
    """(name, x shape, out px, method, antialias, type, gradient) of each
    resize of ``RESIZE_PATHS[path]``, in the model's order."""
    batch, sizes, dtype, backward = RESIZE_PATHS[path]
    for lv in range(len(sizes) - 1):
        big, small = sizes[lv], sizes[lv + 1]
        yield f"enc{lv}", (batch, big, big, 64 << lv), small, "bilinear", True, dtype, backward
        yield (f"dec{lv}", (batch, small, small, 64 << (lv + 1)), big, "bilinear", True, dtype,
               backward)
    if backward:  # the step's degradation of its batch
        yield "degrade_area", (batch, 256, 256, 3), 128, "area", True, torch.float32, False
        yield ("degrade_cubic", (batch, 128, 128, 3), 256, "bicubic_cv2", False, torch.float32,
               False)


def resize_close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| / max |want|; raises past 1e-6 of max |want|, plus
    one bf16 ulp of the larger of the two per element for bf16 (an f32
    difference in the last bits can flip the rounding)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)}")
    g, w = got.to(torch.float32), want.to(torch.float32)
    scale = w.abs().max().clamp_min(1e-30)
    err = (g - w).abs()
    ulp = 2.0**-7 * torch.maximum(g.abs(), w.abs()) if got.dtype == torch.bfloat16 else 0.0
    if not bool(torch.all(err <= ulp + 1e-6 * scale)) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: the kernel disagrees with the dense product: max |err| / "
                             f"max |want| {(err.max() / scale).item():.3e}")
    return (err.max() / scale).item()


def _resize_bound(shape, oh: int, method: str, antialias: bool, dtype) -> tuple[float, str]:
    """One pass's bound: read x once and write y once (the backward reads the
    cotangent and writes dx, the same bytes), beside the float32 FLOPs of the
    H pass (K_h taps a row of each column) and the W pass (K_w a pixel)."""
    n, h, w, c = shape
    kh = band_tables(resize_matrix(h, oh, method, antialias))[1].shape[1]
    kw = band_tables(resize_matrix(w, oh, method, antialias))[1].shape[1]
    es = torch.tensor([], dtype=dtype).element_size()
    return bound_ms((n * h * w * c + n * oh * oh * c) * es,
                    2.0 * n * c * (oh * w * kh + oh * oh * kw), torch.float32)


def check_resize(gen: torch.Generator) -> list[dict]:
    """The banded resize (``resize_band``, ``csrc/resize_band.cu``) against
    its plain version, the dense product (``resize_band_plain``: two float32
    matmuls, TF32 off), on the same CUDA tensors at every resize of the
    flagship's and the deep config's bf16 training steps (forward and
    backward, the degradation's float32 resizes forward) and of the served
    flagship's float32 forward: ``resize_close``. The wrapper must count one
    launch a forward and one a backward. Then each is timed (``graphed_ms``)
    beside the dense path with its casts (its backward: autograd's forward +
    backward less the forward) and the bound of one pass; each path's sums
    over one step or forward follow its rows."""
    rows = []
    for path in RESIZE_PATHS:
        total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for name, shape, oh, method, antialias, dtype, backward in _resize_cases(path):
            out_hw = (oh, oh)
            x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn((shape[0], oh, oh, shape[3]), generator=gen, device="cuda").to(dtype)

            def kernel(t):
                return resize_band(t, out_hw, method, antialias, dtype)

            def dense(t):
                return resize_band_plain(t, out_hw, method, antialias).to(dtype)

            before = resize_band.launches
            errs = {"y": resize_close(f"resize {path} {name}", kernel(x), dense(x))}
            launches = 1
            if backward:
                dx = []
                for fn in (kernel, dense):
                    xg = x.clone().requires_grad_(True)
                    fn(xg).backward(g)
                    dx.append(xg.grad)
                errs["dx"] = resize_close(f"resize {path} {name} dx", *dx)
                launches += 2
            if resize_band.launches - before != launches:
                raise AssertionError(f"resize {path} {name}: {resize_band.launches - before} "
                                     f"launches counted, expected {launches}")
            ms = {"fwd": graphed_ms(lambda: kernel(x))}
            plain = {"fwd": graphed_ms(lambda: dense(x))}
            if backward:
                xg = x.clone().requires_grad_(True)
                for out, fn in ((ms, kernel), (plain, dense)):
                    both = graphed_ms(lambda: torch.autograd.grad(fn(xg), xg, g))
                    out["bwd"] = both - out["fwd"]
            bnd, by = _resize_bound(shape, oh, method, antialias, dtype)
            total["ms"] += sum(ms.values())
            total["plain_ms"] += sum(plain.values())
            total["bound_ms"] += bnd * len(ms)
            rows.append(dict(kernel="R", path=path, name=name, shape=list(shape), out_px=oh,
                             method=method, dtype=_dname(dtype), rel_err=errs, ms=ms,
                             plain_ms=plain, bound_ms=bnd, bound_by=by))
            log(f"[resize] {path} {name} {'x'.join(map(str, shape))} -> {oh} px {method} "
                f"{_dname(dtype)}: rel err " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                + "; kernel " + " / ".join(f"{k} {v:.4f}" for k, v in ms.items())
                + " ms; dense " + " / ".join(f"{k} {v:.4f}" for k, v in plain.items())
                + f" ms; bound {bnd:.4f} ms a pass ({by}); kernel at "
                + " / ".join(f"{100 * bnd / v:.1f} %" for v in ms.values()) + " of it")
            del x, g
            torch.cuda.empty_cache()
        per = "step" if path in RESIZE_PER_STEP else "forward"
        rows.append(dict(kernel="R", path=path, name="sum", **total))
        log(f"[resize] {path}: one {per}, {RESIZE_PER_STEP.get(path, RESIZE_PER_FORWARD)} "
            f"launches: kernel {total['ms']:.3f} ms, dense {total['plain_ms']:.3f} ms, bound "
            f"{total['bound_ms']:.3f} ms ({100 * total['bound_ms'] / total['ms']:.1f} % of the "
            f"kernel's)")
    return rows


def resize_entry(rows: list[dict], launches: dict) -> dict:
    """The resize's entry of the kernels line: ``ms`` (CUDA-graph replays),
    ``plain_ms`` (the dense product and its casts) and ``bound_ms`` summed
    over one bf16 flagship training step's launches, the same sums for the
    deep step and the served forward, and each path's launches (``launches``:
    path -> counted launches)."""
    sums = {r["path"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
            for r in rows if r["name"] == "sum"}
    return {"name": "resize_band", "route": "cuda", "source": "adunet_torch/csrc/resize_band.cu",
            "replaces": "none: the reference's resizes are XLA einsums (adunet/ops/resize.py:175)",
            "launches": launches["train"],
            "max_rel_err": max(v for r in rows if r["name"] != "sum"
                               for v in r["rel_err"].values()),
            **sums["train"], "bound_by": "bytes", "device_kernels_per_call": 1,
            "per": "launches of one bf16 training step of the flagship (batch 32, 256 px)",
            "deep": {"launches": launches["deep"], **sums["deep"]},
            "serve": {"launches": launches["serve"], **sums["serve"]},
            **{k: {"launches": v} for k, v in launches.items()
               if k not in ("train", "deep", "serve")},
            "rows": [r for r in rows if r["name"] != "sum"]}


def _post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))


# the kernels ``_counts`` counts, in its order
COUNTED = ("K1", "K1_bwd", "K2", "K2_bwd")


def _counts() -> tuple[int, int, int, int]:
    """Launches of K1's forward, K1's backward, K2 and K2's backward (SAME;
    the halo-row mode counts apart, ``conv64.conv3x3_rows.launches`` and
    ``conv64.conv3x3_same_backward.rows_launches``)."""
    k1, k1b, k2, _rows, k2b = launch_snapshot()[:5]
    return k1, k1b, k2, k2b


def serve_flagship(call, artifact: Path = ARTIFACT) -> dict:
    """The serving path: the HTTP server over the flagship artifact on the
    card (``artifact``: the committed weights file, or the program phase's);
    ``call`` is the same artifact loaded, for the direct answers."""
    reset_launches()
    server = make_server(str(artifact), port=0, batch_window_ms=200.0, device="cuda")
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
    k1, k1b, k2, k2b = _counts()
    resizes, k3 = resize_band.launches, conv3x3_f32.launches
    calls = stats["device_calls"]
    log(f"[serve] stats {stats}; K1 launches {k1}, K2 launches {k2}, K1 backward {k1b}, K2 "
        f"backward {k2b}, resize launches {resizes}, K3 launches {k3}")
    if (calls < 1 or k1 != K1_PER_CALL * calls or k2 != K2_PER_CALL * calls or k1b or k2b
            or resizes != RESIZE_PER_FORWARD * calls or k3 != K3_PER_CALL * calls):
        raise AssertionError(f"expected {K1_PER_CALL} K1, {K2_PER_CALL} K2, "
                             f"{RESIZE_PER_FORWARD} resize and {K3_PER_CALL} K3 launches per "
                             f"device call; got {k1}, {k2}, {resizes} and {k3} over {calls} "
                             f"calls")
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
    return {"launches": {"K1": k1, "K1_bwd": k1b, "K2": k2, "K2_bwd": k2b, "R": resizes,
                         "K3": k3},
            "device_calls": calls}


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


# the flagship program's graph: its kernels' ops, and the plain versions'
# operations that must not stand in it (K1's statistics, K2's zero padding)
PROGRAM_OPS = {"K1": "adunet_torch.layer_norm_relu.default", "K2": "adunet_torch.conv3x3_c64.default",
               "K3": "adunet_torch.conv3x3_f32.default"}
PLAIN_OPS = ("aten.rsqrt.default", "aten.mean.dim", "aten.var_mean.correction",
             "aten.constant_pad_nd.default", "aten.pad.default")
PROGRAM_TIMED = 20
# run in a fresh process: load the saved program with nothing of the port but
# adunet_torch.export.program (and the kernels it imports), run two forwards
_PROGRAM_CHILD = r"""
import json, sys
import numpy as np
import torch
from adunet_torch.export import program
from adunet_torch.kernels import conv3x3_f32, conv64, fused_norm, resize_band

def model_code():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "adunet")
                  or m.startswith(("adunet_torch.models", "adunet_torch.nn", "adunet_torch.ops")))

before = model_code()
prog = program.Program(sys.argv[1], "cuda")
x = np.load(sys.argv[2])
outs = [prog(x) for _ in range(2)]
torch.cuda.synchronize()
launches = [fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
            conv64.conv3x3_same.launches, conv64.conv3x3_same_backward.launches,
            resize_band.launches, conv3x3_f32.launches]
np.save(sys.argv[3], outs[1])
print(json.dumps({"model_code": before + model_code(), "launches": launches, "calls": 2,
                  "repeat_equal": bool(np.array_equal(outs[0], outs[1]))}))
"""


def _medians_in_turns(*fns) -> list[float]:
    """Median of ``PROGRAM_TIMED`` single runs of each of ``fns``, run in
    turns (CUDA events)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times: list[list[float]] = [[] for _ in fns]
    for _ in range(PROGRAM_TIMED):
        for fn, out in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return [float(np.median(t)) for t in times]


def flagship_program(call, ident: str) -> dict:
    """The flagship as a serving program (``adunet_torch.export.program``):
    exported from the committed int8 artifact's model on the card as an int8
    program (``save_artifact``), its graph's K1 / K2 ops counted (16 / 4, no
    plain decomposition); loaded in a fresh process that imports no model
    code, which runs 8 x 256 px tiles twice (16 / 0 / 4 / 0 launches a
    call) while this process serves, and whose output is held to the weights
    path's ``call`` (1e-5); served over HTTP (``serve_flagship``) and held to
    the pinned eval numbers (``golden``) from the program; its forward timed
    beside the weights path's (median of 20 each, in turns, CUDA events)."""
    from adunet_torch.export import program, save_artifact

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_program_") as tmp:
        art = Path(tmp) / "program_int8"
        t0 = time.perf_counter()
        save_artifact(call.model, art, image_size=256, batch_size=8, quantize="int8")
        export_s = time.perf_counter() - t0
        manifest = json.loads((art / "manifest.json").read_text())
        program_bytes = (art / program.PROGRAM_FILE).stat().st_size
        prog_call, _ = load_artifact(art, device="cuda")
        counts = program.node_counts(prog_call.exported_program)
        ops = {kid: counts.get(name, 0) for kid, name in PROGRAM_OPS.items()}
        plain = {name: counts[name] for name in PLAIN_OPS if name in counts}
        log(f"[program] int8 flagship exported on the card in {export_s:.1f} s "
            f"({program_bytes / 1e6:.2f} MB program, platforms "
            f"{manifest['platforms']}): graph {sum(counts.values())} nodes, "
            f"{ops['K1']} adunet_torch.layer_norm_relu, {ops['K2']} adunet_torch.conv3x3_c64, "
            f"{ops['K3']} adunet_torch.conv3x3_f32, plain decompositions {plain or 'none'}")
        if ops != {"K1": K1_PER_CALL, "K2": K2_PER_CALL, "K3": K3_PER_CALL} or plain:
            raise AssertionError(f"the flagship program holds {ops} kernel ops and {plain}")

        x = np.random.default_rng(5).random((8, 256, 256, 3), dtype=np.float32)
        np.save(Path(tmp) / "x.npy", x)
        t0 = time.perf_counter()
        # the fresh process starts now and runs while this one serves
        proc = subprocess.Popen(
            [sys.executable, "-c", _PROGRAM_CHILD, str(art / program.PROGRAM_FILE),
             str(Path(tmp) / "x.npy"), str(Path(tmp) / "y.npy")],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            served = serve_flagship(prog_call, art)
            scores = golden(prog_call)
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"the fresh process failed: {stderr[-3000:]}")
        child = json.loads(stdout.strip().splitlines()[-1])
        got = np.load(Path(tmp) / "y.npy")
        err = float(np.abs(got - call(x)).max())
        want_launches = [K1_PER_CALL * child["calls"], 0, K2_PER_CALL * child["calls"], 0,
                         RESIZE_PER_FORWARD * child["calls"], K3_PER_CALL * child["calls"]]
        log(f"[program] fresh process ({child_s:.1f} s, beside serve and golden): model code "
            f"imported {child['model_code'] or 'none'}; launches K1 / K1 bwd / K2 / K2 bwd / "
            f"resize / K3 "
            f"{child['launches']} over {child['calls']} calls; two calls equal "
            f"{child['repeat_equal']}; max |program - weights path| {err:.2e}")
        if (child["model_code"] or child["launches"] != want_launches
                or not child["repeat_equal"] or not err <= 1e-5 or got.shape != x.shape):
            raise AssertionError(f"the fresh process's program: {child}, max |delta| {err:.3e}")

        xd = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            weights_ms, program_ms = _medians_in_turns(lambda: call.model(xd),
                                                       lambda: prog_call.module(xd))
        log(f"[program] {ident}: flagship forward, batch 8 x 256 px, f32, median of "
            f"{PROGRAM_TIMED} (CUDA events, the two in turns): program {program_ms:.3f} ms, "
            f"weights path {weights_ms:.3f} ms")
        del prog_call, xd
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[program] phase took {seconds:.1f} s")
    return {"node_counts": ops, "export_s": export_s, "child": child, "child_s": child_s,
            "max_abs_err": err, "launches": served["launches"],
            "device_calls": served["device_calls"], "golden": scores,
            "program_ms": program_ms, "weights_ms": weights_ms, "seconds": seconds,
            "program_bytes": program_bytes}


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

    reset_launches()
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
    k1, k1b, k2, k2b = _counts()
    resizes = resize_band.launches
    biased, k3 = launch_snapshot()[7:9], conv3x3_f32.launches
    if (k1, k1b, k2, k2b, resizes) != (16 * TRAIN_STEPS, 16 * TRAIN_STEPS, 4 * TRAIN_STEPS,
                                       4 * TRAIN_STEPS, RESIZE_PER_STEP["train"] * TRAIN_STEPS) \
            or biased != (12 * TRAIN_STEPS, 12 * TRAIN_STEPS) or k3:
        raise AssertionError(f"expected {16 * TRAIN_STEPS} K1 ({12 * TRAIN_STEPS} with a conv "
                             f"bias), {16 * TRAIN_STEPS} K1 backward ({12 * TRAIN_STEPS}), "
                             f"{4 * TRAIN_STEPS} K2, {4 * TRAIN_STEPS} K2 backward and "
                             f"{RESIZE_PER_STEP['train'] * TRAIN_STEPS} resize launches and no "
                             f"K3 over {TRAIN_STEPS} steps; got {k1} ({biased[0]}), {k1b} "
                             f"({biased[1]}), {k2}, {k2b}, {resizes} and {k3}")
    losses = [float(v) for v in losses]
    log(f"[train] {TRAIN_STEPS} steps, losses {', '.join(f'{v:.5f}' for v in losses)}; "
        f"every parameter had a finite nonzero gradient after step 1; K1 {k1} ({biased[0]} "
        f"with a conv bias), K1 backward {k1b} ({biased[1]}), K2 {k2}, K2 backward {k2b}, "
        f"resize {resizes}, K3 {k3} launches")
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
    return {"launches": {"K1": k1, "K1_bwd": k1b, "K2": k2, "K2_bwd": k2b, "R": resizes,
                         "K1_bias": biased[0], "K1_bwd_bias": biased[1], "K3": k3},
            "steps": TRAIN_STEPS, "losses": losses,
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
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = train_main(args)
    seconds = time.perf_counter() - t0
    k1, k1b, k2, k2b = _counts()
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"[train_sr] {line}")
    run_dir = tmp / "logs" / "smoke"
    ckpt_dir = Path(result["ckpt_dir"])
    cfg = json.loads((run_dir / "config.json").read_text())
    rows = (run_dir / "epoch_metrics.csv").read_text().strip().splitlines()
    steps = epochs * cfg["steps_per_epoch"]
    forwards = steps + epochs * 1 + 2  # train, val (4 tiles), eval
    if (k1, k1b, k2, k2b) != (16 * forwards, 16 * steps, 4 * forwards, 4 * steps):
        raise AssertionError(f"train_sr: expected {16 * forwards} K1 / {16 * steps} K1 backward "
                             f"/ {4 * forwards} K2 / {4 * steps} K2 backward launches, got {k1} / "
                             f"{k1b} / {k2} / {k2b}")
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
    log(f"[train_sr] {epochs} epochs in {seconds:.1f} s; K1 {k1}, K1 backward {k1b}, K2 {k2}, "
        f"K2 backward {k2b} launches; best epoch "
        f"{best}, latest {latest}; restored best == live params, latest == live: {matches['latest']}")
    return {"launches": {"K1": k1, "K1_bwd": k1b, "K2": k2, "K2_bwd": k2b}, "seconds": seconds,
            "best": best,
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

    reset_launches()
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
    want = tuple(n * SEG_STEPS for n in SEG_PER_STEP[kind])
    if counts != want:
        raise AssertionError(f"{kind} {dtype}: expected {want} K1 / K1 backward / K2 / K2 "
                             f"backward launches over {SEG_STEPS} steps, got {counts}")
    still = [n for n, b in model.named_buffers() if torch.equal(b, buffers0[n])]
    if still or (kind == "protocol") != bool(buffers0):
        raise AssertionError(f"{kind}: BatchNorm buffers that did not move: {still}")
    losses = [float(v) for v in losses]
    log(f"[seg {kind}] {dtype}, {n_params:,} params, {SEG_STEPS} steps at batch {SEG_BATCH} x "
        f"{SEG_SIZE} px: losses {', '.join(f'{v:.4f}' for v in losses)}; finite nonzero gradients "
        f"after step 1; {len(buffers0)} BatchNorm buffers moved; K1 {counts[0]}, K1 backward "
        f"{counts[1]}, K2 {counts[2]}, K2 backward {counts[3]} launches")
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
    return {"launches": dict(zip(COUNTED, counts)), "steps": SEG_STEPS,
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
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = main_fn(args)
        seconds = time.perf_counter() - t0
        counts = _counts()
        for line in buf.getvalue().splitlines():
            log(f"[{kind} cli] {line}")
        k1, k1b, k2, k2b = SEG_PER_STEP[kind]
        want = (k1 * forwards[kind], k1b * epochs * steps, k2 * forwards[kind],
                k2b * epochs * steps)
        if counts != want:
            raise AssertionError(f"{kind} CLI: expected {want} K1 / K1 backward / K2 / K2 "
                                 f"backward launches, got {counts}")
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
            f"{counts[1]}, K2 {counts[2]}, K2 backward {counts[3]} launches; config.json keys and "
            f"CSV as the reference's; "
            f"checkpoints at epoch {epochs}")
        out[kind] = {"launches": dict(zip(COUNTED, counts)), "seconds": seconds,
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
    reset_launches()
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
    k1, k1b, k2, k2b = _counts()
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"[streamed cli] {line}")
    cfg = json.loads((Path(result["run_dir"]) / "config.json").read_text())
    steps = 2 * cfg["steps_per_epoch"]
    forwards = steps + 2 + 2  # train, val (4 tiles) per epoch, eval
    if (cfg["low_res_mode"], cfg["uint8_feed"], cfg["device_cache"]) != \
            ("synthetic_patches", True, False) or printed.count("PSNR(Y)") != 2:
        raise AssertionError(f"streamed train_sr: config {cfg}")
    if (k1, k1b, k2, k2b) != (16 * forwards, 16 * steps, 4 * forwards, 4 * steps):
        raise AssertionError(f"streamed train_sr: expected {16 * forwards} K1 / {16 * steps} K1 "
                             f"backward / {4 * forwards} K2 / {4 * steps} K2 backward launches, "
                             f"got {k1} / {k1b} / {k2} / {k2b}")
    log(f"[streamed cli] 2 epochs in {seconds:.1f} s; K1 {k1}, K1 backward {k1b}, K2 {k2}, K2 "
        f"backward {k2b}")

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
    reset_launches()
    waited[0] = 0.0
    ms_streamed = [_timed_steps(run_streamed, STREAM_STEPS)]
    counts = _counts()
    ms_cached = [_timed_steps(run_cached, STREAM_STEPS)]
    ms_cached.append(_timed_steps(run_cached, STREAM_STEPS))
    ms_streamed.append(_timed_steps(run_streamed, STREAM_STEPS))
    feed_ms = waited[0] / (2 * STREAM_STEPS) * 1e3
    want = tuple(n * STREAM_STEPS for n in STREAM_PER_STEP)
    if counts != want:
        raise AssertionError(f"streamed step: expected {want} K1 / K1 backward / K2 / K2 "
                             f"backward launches over {STREAM_STEPS} steps, got {counts}")
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
    return {"launches": dict(zip(COUNTED, counts)), "steps": STREAM_STEPS,
            "ms_per_step": ms, "ms_runs": ms_streamed, "img_per_s": TRAIN_BATCH * 1e3 / ms,
            "device_cache_ms_per_step": ms_c, "device_cache_ms_runs": ms_cached,
            "host_feed_share": ms / ms_c - 1.0, "feed_wait_ms_per_step": feed_ms,
            "idle": idle, "idle_device_cache": idle_cached,
            "feed_paces_step": paced, "cli_seconds": seconds,
            "cli_launches": [k1, k1b, k2, k2b],
            "ckpt_dir": result["ckpt_dir"]}


def _conv_flops(model, x: torch.Tensor) -> float:
    """Multiply-add FLOPs (2 per MAC) of every convolution in one forward of
    ``model`` on ``x``, from the shapes the Conv modules see."""
    from adunet_torch.nn import Conv

    total = [0.0]

    def hook(module, inputs, output):
        o, i, kh, kw = module.weight.shape
        y = output[0] if isinstance(output, tuple) else output  # (y, bias_left_out)
        total[0] += 2.0 * y.numel() * i * kh * kw

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
        reset_launches()
        losses = [step(state, None, gen)[1]["loss"] for _ in range(DEEP_STEPS)]
        torch.cuda.synchronize()
        counts = _counts()
        resizes = resize_band.launches
        biased = launch_snapshot()[7:9]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = tuple(n * DEEP_STEPS for n in DEEP_PER_STEP[levels])
        want_biased = tuple(n * DEEP_STEPS for n in DEEP_BIAS_PER_STEP[levels])
        if counts != want or resizes != RESIZE_PER_STEP["deep"] * DEEP_STEPS \
                or biased != want_biased:
            raise AssertionError(f"deep config remat_levels={levels}: expected {want} K1 / K1 "
                                 f"backward / K2 / K2 backward, {want_biased} K1 / K1 backward "
                                 f"with a conv bias and "
                                 f"{RESIZE_PER_STEP['deep'] * DEEP_STEPS} resize launches over "
                                 f"{DEEP_STEPS} steps, got {counts}, {biased} and {resizes}")
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"deep config: non-finite losses {losses}")
        ms = cuda_ms(lambda: step(state, None, gen), DEEP_STEPS)
        # the step's useful work: forward, data gradient and weight gradient
        # of every convolution (the recompute of remat is not counted)
        share = 3.0 * fwd_flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
        key = f"remat_{levels or 0}"
        out[key] = {"launches": {**dict(zip(COUNTED, counts)), "R": resizes,
                                 "K1_bias": biased[0], "K1_bwd_bias": biased[1]},
                    "per_step": list(DEEP_PER_STEP[levels]), "ms_per_step": ms,
                    "img_per_s": DEEP_BATCH * 1e3 / ms, "peak_gb": peak_gb,
                    "conv_tflop_per_step": 3.0 * fwd_flops / 1e12, "bf16_peak_share": share,
                    "losses": losses, "bottleneck_px": info["bottleneck_size"]}
        log(f"[deep] {ident}: scale {DEEP_SCALE}, depth {DEEP_DEPTH}, {n_params:,} params, bf16, "
            f"batch {DEEP_BATCH} x 256 px, remat_levels={levels}: {ms:.3f} ms/step "
            f"({DEEP_BATCH * 1e3 / ms:.1f} img/s); peak device memory {peak_gb:.2f} GB; launches "
            f"per step K1 {counts[0] // DEEP_STEPS} ({biased[0] // DEEP_STEPS} with a conv bias), "
            f"K1 backward {counts[1] // DEEP_STEPS} ({biased[1] // DEEP_STEPS}), K2 "
            f"{counts[2] // DEEP_STEPS}, K2 backward {counts[3] // DEEP_STEPS}, resize "
            f"{resizes // DEEP_STEPS}; conv FLOPs "
            f"{3.0 * fwd_flops / 1e12:.3f} TFLOP per step "
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
    reset_launches()
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
    if counts != (0, 0, per * SEG_STEPS, per * SEG_STEPS):
        raise AssertionError(f"vanilla SR: expected (0, 0, {per * SEG_STEPS}, {per * SEG_STEPS}) "
                             f"K1 / K1 backward / K2 / K2 backward launches over {SEG_STEPS} "
                             f"steps, got {counts}")
    still = [n for n, b in model.named_buffers() if torch.equal(b, buffers0[n])]
    if still:
        raise AssertionError(f"vanilla SR: BatchNorm buffers that did not move: {still}")
    losses = [float(v) for v in losses]
    log(f"[vanilla sr] bf16, {n_params:,} params, combined loss (seeded VGG19), {SEG_STEPS} steps "
        f"at batch {SEG_BATCH} x 256 px: losses {', '.join(f'{v:.4f}' for v in losses)}; finite "
        f"nonzero gradients after step 1; {len(buffers0)} BatchNorm buffers moved; K1 {counts[0]}, "
        f"K1 backward {counts[1]}, K2 {counts[2]}, K2 backward {counts[3]} launches")
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"vanilla SR: the training loss did not fall: {losses}")
    ms = cuda_ms(lambda: step(state, batches[0]), TIMED_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[vanilla sr] {ident}: bf16 train step with the combined loss, batch {SEG_BATCH} x 256 px: "
        f"{ms:.3f} ms/step ({SEG_BATCH * 1e3 / ms:.1f} img/s); peak device memory {peak_gb:.2f} GB")
    del state, model, batches
    torch.cuda.empty_cache()
    return {"launches": dict(zip(COUNTED, counts)), "steps": SEG_STEPS,
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
    reset_launches()
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
            or cfg["epochs_ran"] != 2 or counts != (0, 0, 2 * 6, 2 * 2) \
            or CheckpointManager(result["ckpt_dir"]).latest_step() != 2:
        raise AssertionError(f"train_sr_vanilla: config {cfg}, launches {counts}")
    out["vanilla_cli"] = {"seconds": seconds, "launches": list(counts), "results": cfg["results"]}
    log(f"[vanilla sr cli] 2 epochs in {seconds:.1f} s; K2 {counts[2]}, K2 backward {counts[3]} "
        f"launches; results "
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

    reset_launches()
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
        raise AssertionError(f"joint: expected {want} K1 / K1 backward / K2 / K2 backward "
                             f"launches over {JOINT_STEPS} steps, got {counts}")
    losses = [float(m["loss"]) for m in metrics]
    log(f"[joint] {n_params:,} params, depth {info['depth']}, bottleneck "
        f"{info['bottleneck_size']} px, bf16, {JOINT_STEPS} steps at batch {JOINT_BATCH} x "
        f"{JOINT_SIZE} px: losses {', '.join(f'{v:.5f}' for v in losses)} (SR "
        f"{float(metrics[0]['sr_loss']):.5f} -> {float(metrics[-1]['sr_loss']):.5f}, seg "
        f"{float(metrics[0]['seg_loss']):.5f} -> {float(metrics[-1]['seg_loss']):.5f}); finite "
        f"nonzero gradients after step 1; K1 {counts[0]}, K1 backward {counts[1]}, K2 "
        f"{counts[2]}, K2 backward {counts[3]} launches")
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
    return {"launches": dict(zip(COUNTED, counts)), "steps": JOINT_STEPS,
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


def graph_capture(ident: str) -> dict:
    """One bf16 forward + backward of the joint model (train_joint's defaults,
    as the joint phase builds it, with its loss; no optimizer step) at batch
    8 x 256 px, captured in a CUDA graph (``torch.cuda.graph``) after three
    eager runs on a side stream, and replayed 3 times, all under
    ``deterministic_cudnn()``. Each replay's loss, SR and mask outputs and
    every parameter's gradient must equal an eager run's on the same inputs
    bit for bit. Where one does not, cuDNN may have picked another algorithm
    under capture: it is then held to the card-vs-card tolerances this
    script uses for bf16 (1e-2 relative on the loss and outputs, as the space
    mesh's bf16 check; 2e-2 relative L2 on each gradient, as the BatchNorm
    gradients), and each tensor that differed is named. The launch counters
    count the capture (28 K1, 28 K1 backward, 5 K2, 5 K2 backward: the
    Python code runs once), not the replays, which launch the same kernels
    without it.
    Replay ms against eager ms (host clock, each ending in a synchronize)."""
    from adunet_torch.models import build_joint_unet
    from adunet_torch.train.joint import _batch_of

    images, masks = _joint_batches(1, JOINT_BATCH, seed=81)[0]
    model, _ = build_joint_unet(0.5, dtype=torch.bfloat16, device="cuda", seed=0)
    _random_head(model)
    sr_loss, seg_loss = _joint_losses()
    params = [(n, p) for n, p in model.named_parameters()]
    device = images.device

    def fwd_bwd():
        for _, p in params:
            p.grad = None
        lr, hr, m = _batch_of((images, masks), device, 0.5)
        sr, seg = model(lr)
        loss = sr_loss(hr, sr) + seg_loss(m, seg)
        loss.backward()
        return {"loss": loss.detach(), "sr": sr.detach(), "mask": seg.detach()}

    def snapshot(out):
        return {**{k: v.clone() for k, v in out.items()},
                **{f"grad {n}": p.grad.clone() for n, p in params}}

    with deterministic_cudnn():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fwd_bwd()
        torch.cuda.current_stream().wait_stream(side)
        eager = snapshot(fwd_bwd())
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        reset_launches()
        # thread_local: a thread of an earlier phase cannot void the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static = fwd_bwd()
        torch.cuda.synchronize()
        counts = _counts()
        if counts != JOINT_PER_STEP:
            raise AssertionError(f"graph: the capture counted {counts} K1 / K1 backward / K2 / "
                                 f"K2 backward launches, expected {JOINT_PER_STEP}")
        replays = []
        for i in range(3):
            graph.replay()
            torch.cuda.synchronize()
            got = {**static, **{f"grad {n}": p.grad for n, p in params}}
            differ = {k: _rel_l2({k: got[k]}, {k: v}) for k, v in eager.items()
                      if not torch.equal(got[k], v)}
            if differ:
                worst = {k: e for k, e in differ.items()
                         if e > (2e-2 if k.startswith("grad") else 1e-2)}
                log(f"[graph] replay {i}: {len(differ)} of {len(eager)} tensors not bit-equal to "
                    f"eager (cuDNN's algorithm under capture; relative L2): {differ}")
                if worst:
                    raise AssertionError(f"graph: replay {i} differs from eager past the bf16 "
                                         f"card-vs-card tolerances: {worst}")
            replays.append({"bit_equal": not differ, "differ": differ})
        eager_ms = _timed_steps(fwd_bwd, 5)
        replay_ms = _timed_steps(graph.replay, 5)
    log(f"[graph] {ident}: joint bf16 forward + backward at batch {JOINT_BATCH} x {JOINT_SIZE} "
        f"px captured ({counts[0]} K1, {counts[1]} K1 backward, {counts[2]} K2, {counts[3]} K2 "
        f"backward launches counted "
        f"once, at the capture: replays launch the same kernels uncounted); {len(replays)} "
        f"replays {'bit-equal to' if all(r['bit_equal'] for r in replays) else 'within tolerance of'}"
        f" eager over the loss, both outputs and {len(params)} gradients; replay {replay_ms:.3f} "
        f"ms against eager {eager_ms:.3f} ms")
    del graph, static, eager, model
    torch.cuda.empty_cache()
    return {"launches": dict(zip(COUNTED, counts)), "replays": replays,
            "replay_ms": replay_ms, "eager_ms": eager_ms, "tensors": len(params) + 3}


# The step_graph phase: steps compared eager against compiled, and steps
# timed a run (in turns: eager, compiled, compiled, eager)
GRAPH_STEPS, GRAPH_TIMED = 6, 8


def _graph_trainers(tmp: Path) -> dict:
    """name -> (setup(), batch(i), launches a step, batch size) of each
    trainer the step_graph phase compiles, at full width: ``setup()`` builds
    the seeded model and its state and returns ``(state, make_step(graph))``."""
    from adunet_torch.data import load_device_cache
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_joint_unet, build_super_resolution_unet
    from adunet_torch.train import (create_train_state, make_joint_train_step, make_optimizer,
                                    make_seg_train_step, make_sr_device_cache_train_step,
                                    make_vanilla_sr_train_step)

    bf16 = torch.bfloat16
    cache = load_device_cache(sorted(str(p) for p in (tmp / "cache").glob("*.npy")), "cuda")

    def flagship():
        model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=bf16, device="cuda",
                                               seed=0)
        _random_head(model)
        return (create_train_state(model, make_optimizer(model.parameters(), 1e-4)),
                lambda graph: make_sr_device_cache_train_step(
                    model, charbonnier_loss, cache, patch_size=TRAIN_PATCH,
                    batch_size=TRAIN_BATCH, graph=graph))

    def joint():
        model, _ = build_joint_unet(0.5, dtype=bf16, device="cuda", seed=0)
        _random_head(model)
        return (create_train_state(model, make_optimizer(model.parameters(), 1e-4)),
                lambda graph: make_joint_train_step(model, *_joint_losses(), data_scale=0.5,
                                                    graph=graph))

    def seg(kind):
        def setup():
            model, loss_fn, augment, extra = _seg_setup(kind, bf16, "cuda")
            return (create_train_state(model, make_optimizer(model.parameters(), SEG_LR)),
                    lambda graph: make_seg_train_step(model, loss_fn, augment=augment,
                                                      extra_metrics=extra, graph=graph))
        return setup

    def vanilla_sr():
        model, loss_fn = _vanilla_setup(bf16, "cuda")
        return (create_train_state(model, make_optimizer(model.parameters(), SEG_LR)),
                lambda graph: make_vanilla_sr_train_step(model, loss_fn, graph=graph))

    joint_batches = _joint_batches(2, JOINT_BATCH, seed=61)
    images, masks = seg_pairs(2 * SEG_BATCH, SEG_SIZE, seed=31)
    seg_batches = [(torch.from_numpy(images[i : i + SEG_BATCH]).cuda(),
                    torch.from_numpy(masks[i : i + SEG_BATCH]).cuda()) for i in (0, SEG_BATCH)]
    lr, hr = _vanilla_pairs(2 * SEG_BATCH, seed=71)
    sr_batches = [(torch.from_numpy(lr[i : i + SEG_BATCH]).cuda(),
                   torch.from_numpy(hr[i : i + SEG_BATCH]).cuda()) for i in (0, SEG_BATCH)]
    k2_vsr = sum(K2_VANILLA_SR.values())
    return {
        "flagship": (flagship, lambda i: None, (16, 16, 4, 4), TRAIN_BATCH),
        "joint": (joint, lambda i: joint_batches[i % 2], JOINT_PER_STEP, JOINT_BATCH),
        "vanilla_seg": (seg("vanilla"), lambda i: seg_batches[i % 2], SEG_PER_STEP["vanilla"],
                        SEG_BATCH),
        "protocol_seg": (seg("protocol"), lambda i: seg_batches[i % 2],
                         SEG_PER_STEP["protocol"], SEG_BATCH),
        "vanilla_sr": (vanilla_sr, lambda i: sr_batches[i % 2], (0, 0, k2_vsr, k2_vsr),
                       SEG_BATCH),
    }


def _step_tensors(state) -> dict:
    """Name -> tensor of what a step updates: parameters, buffers, Adam's
    moments and update counts."""
    out = {f"param {n}": p for n, p in state.model.named_parameters()}
    out.update({f"buffer {n}": b for n, b in state.model.named_buffers()})
    names = {p: n for n, p in state.model.named_parameters()}
    for p, slots in state.optimizer.state.items():
        out.update({f"{k} {names[p]}": v for k, v in slots.items()})
    return out


def step_graph(tmp: Path, ident: str) -> dict:
    """Each trainer's step captured whole in a CUDA graph (``CompiledStep``,
    ``graph=True``) against the same step run eagerly (``graph=False``), at
    full width: the bf16 flagship from a device cache (batch 32 x 256 px), the
    joint model, the vanilla and protocol segmentation models and the vanilla
    SR model with the combined loss (batch 8 x 256 px).

    Under ``deterministic_cudnn()``, ``GRAPH_STEPS`` steps of each side from
    the same seeded model and batches (the eager side first, then the
    compiled one: 2 eager calls, the capture and its replay, 3 replays): the
    metrics of every step and every parameter, buffer, Adam moment and
    update count after the last must be bit-equal. Where one is not (cuDNN
    may pick another algorithm under capture), it is held to the ``graph``
    phase's tolerances (1e-2 relative L2 on the metrics and the parameters,
    2e-2 on what comes from the gradients: Adam's moments) and named.
    Launches a step (counts set to 0 just before each side) must be the
    eager ones on both sides; peak device memory of each side above what was
    allocated before it was built.

    Then, in cuDNN's default mode, fresh steps of both sides on the same
    models (the compiled one captured anew; each side's peak memory over its
    first 3 calls above what its state holds at rest, without gradients) are
    timed in turns, eager,
    compiled, compiled, eager, ``GRAPH_TIMED`` steps a run (host clock, ending
    in a synchronize), and each side's device idle share over 3 steps under
    the profiler."""
    out = {}
    for name, (setup, batch, per_step, batch_size) in _graph_trainers(tmp).items():
        t0 = time.perf_counter()
        sides, resizes = {}, {}
        with deterministic_cudnn():
            for graph in (False, True):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                state, make_step = setup()
                step = make_step(graph)
                gen = torch.Generator("cuda").manual_seed(0)
                reset_launches()
                metrics = [step(state, batch(i), gen)[1] for i in range(GRAPH_STEPS)]
                torch.cuda.synchronize()
                counts = _counts()
                if counts != tuple(n * GRAPH_STEPS for n in per_step):
                    raise AssertionError(f"step_graph {name} ({'compiled' if graph else 'eager'}): "
                                         f"{counts} K1 / K1 backward / K2 / K2 backward launches "
                                         f"over {GRAPH_STEPS} steps, expected {per_step} a step")
                resizes[graph] = resize_band.launches
                if graph and step.captures_made != 1:
                    raise AssertionError(f"step_graph {name}: {step.captures_made} captures")
                sides[graph] = {"state": state, "make_step": make_step, "metrics": metrics,
                                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
                del step
        want_resizes = (RESIZE_PER_STEP["train"] * GRAPH_STEPS if name == "flagship"
                        else resizes[False])
        if resizes[False] != want_resizes or resizes[True] != want_resizes:
            raise AssertionError(f"step_graph {name}: resize launches eager / compiled "
                                 f"{resizes[False]} / {resizes[True]} over {GRAPH_STEPS} steps, "
                                 f"expected {want_resizes}")
        want, got = _step_tensors(sides[False]["state"]), _step_tensors(sides[True]["state"])
        for i, (em, cm) in enumerate(zip(sides[False]["metrics"], sides[True]["metrics"])):
            want.update({f"step {i} {k}": v for k, v in em.items()})
            got.update({f"step {i} {k}": v for k, v in cm.items()})
        if set(want) != set(got):
            raise AssertionError(f"step_graph {name}: eager and compiled steps hold other tensors")
        differ = {k: float((got[k].double() - v.double()).norm()
                           / v.double().norm().clamp_min(1e-30))
                  for k, v in want.items() if not torch.equal(got[k], v)}
        worst = {k: e for k, e in differ.items()
                 if not e <= (2e-2 if k.startswith("exp_avg") else 1e-2)}
        if differ:
            log(f"[step_graph] {name}: {len(differ)} of {len(want)} tensors not bit-equal to eager "
                f"(relative L2): {differ}")
        if worst:
            raise AssertionError(f"step_graph {name}: compiled steps differ from eager past the "
                                 f"graph phase's tolerances: {worst}")

        steps, gens, step_gb = {}, {}, {}
        for graph in (False, True):
            state = sides[graph]["state"]
            for p in state.model.parameters():
                p.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            steps[graph] = sides[graph]["make_step"](graph)
            gens[graph] = torch.Generator("cuda").manual_seed(1)
            for i in range(3):  # the compiled side captures at its third call
                steps[graph](state, batch(i), gens[graph])
            torch.cuda.synchronize()
            step_gb[graph] = (torch.cuda.max_memory_allocated() - base) / 1e9

        def run(graph):
            return lambda: steps[graph](sides[graph]["state"], batch(0), gens[graph])

        ms = {False: [], True: []}
        for graph in (False, True, True, False):
            ms[graph].append(_timed_steps(run(graph), GRAPH_TIMED))
        idle = {graph: device_idle(run(graph), 3) for graph in (False, True)}
        res = {"bit_equal": not differ, "differ": differ, "tensors": len(want),
               "launches_per_step": list(per_step),
               "resize_launches_per_step": resizes[False] / GRAPH_STEPS}
        for graph, side in (("eager", False), ("compiled", True)):
            res[graph] = {"ms_per_step": float(np.mean(ms[side])), "ms_runs": ms[side],
                          "img_per_s": batch_size * 1e3 / float(np.mean(ms[side])),
                          "idle": idle[side], "peak_gb": sides[side]["peak_gb"],
                          "step_gb_default_cudnn": step_gb[side]}

        def idle_str(d):
            return "not measured" if d["idle_share"] is None else f"{d['idle_share']:.2%}"

        e, c = res["eager"], res["compiled"]
        log(f"[step_graph] {ident}: {name} bf16 step, batch {batch_size} x 256 px: eager "
            f"{e['ms_per_step']:.3f} ms/step (runs {', '.join(f'{v:.3f}' for v in e['ms_runs'])}; "
            f"idle {idle_str(e['idle'])}; peak {e['peak_gb']:.2f} GB, above the state "
            f"{e['step_gb_default_cudnn']:.2f} GB in cuDNN's default mode), compiled "
            f"{c['ms_per_step']:.3f} ms/step (runs {', '.join(f'{v:.3f}' for v in c['ms_runs'])}; "
            f"idle {idle_str(c['idle'])}; peak {c['peak_gb']:.2f} GB, above the state "
            f"{c['step_gb_default_cudnn']:.2f} GB); K1 / K1 backward / K2 / K2 "
            f"backward {per_step} and {resizes[False] / GRAPH_STEPS:g} resizes a step on both; "
            + ("bit-equal" if not differ else f"{len(differ)} tensors within tolerance")
            + f" over {len(want)} tensors; {time.perf_counter() - t0:.1f} s")
        out[name] = res
        del sides, steps, gens
        torch.cuda.empty_cache()
    return out


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
    from adunet_torch.export.program import Program

    corpus = tmp / "isic"
    epochs, steps = 2, 2  # 16 pairs at batch 8; 8 val pairs: one val batch an epoch
    args = ["--train_image_dir", str(corpus / "train_img"),
            "--train_mask_dir", str(corpus / "train_mask"),
            "--val_image_dir", str(corpus / "val_img"), "--val_mask_dir", str(corpus / "val_mask"),
            "--image_suffix", ".npy", "--mask_suffix", "_segmentation.npy", "--mixed_precision",
            "--epochs", str(epochs), "--model_dir", str(tmp / "joint_models"),
            "--log_dir", str(tmp / "joint_logs"), "--run_name", "joint", "--seed", "9"]
    reset_launches()
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
            JOINT_PER_STEP[2] * forwards, JOINT_PER_STEP[3] * epochs * steps)
    if counts != want:
        raise AssertionError(f"train_joint: expected {want} K1 / K1 backward / K2 / K2 backward "
                             f"launches, got {counts}")
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
        f"{counts[1]}, K2 {counts[2]}, K2 backward {counts[3]} launches; config.json and "
        f"result.json keys as the "
        f"reference's; TensorBoard event files: {len(events)} (none where tensorboardX is "
        "not installed)")
    out = {"launches": dict(zip(COUNTED, counts)), "seconds": seconds,
           "final_metrics": res["final_metrics"], "tb_event_files": len(events)}
    del result
    torch.cuda.empty_cache()

    art = tmp / "joint_export"
    with contextlib.redirect_stdout(buf):
        export_main(["--workload", "joint", "--model-path", res["checkpoint"], "--output-dir",
                     str(art), "--quantize", "int8"])
    call, manifest = load_artifact(art, device="cuda")
    if not isinstance(call, Program) or manifest.get("platforms") != ["cuda"]:
        raise AssertionError(f"the joint artifact has no program exported on the card: "
                             f"{manifest.get('program_file')}, {manifest.get('platforms')}")
    x = seg_pairs(JOINT_BATCH, JOINT_SIZE, seed=81)[0]
    reset_launches()
    served = call(x)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != JOINT_PER_FORWARD:
        raise AssertionError(f"joint artifact: expected {JOINT_PER_FORWARD} K1 / K1 backward / "
                             f"K2 / K2 backward launches per forward, got {counts}")
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
        f"{manifest['artifact_bytes'] / 1e6:.2f} MB with its program) served one forward "
        f"of its program at batch "
        f"{JOINT_BATCH} x {JOINT_SIZE} px: K1 {counts[0]}, K1 backward {counts[1]}, K2 "
        f"{counts[2]} launches; max |served - checkpoint with dequantized weights| sr "
        f"{errs['sr']:.2e}, mask {errs['mask']:.2e}")
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"served joint outputs differ from the checkpoint's model with "
                             f"dequantized weights: {errs}")
    out["served_launches"] = dict(zip(COUNTED, counts))
    out["served_max_abs_err"] = errs
    del live, sr, mask
    torch.cuda.empty_cache()

    # the protocol segmentation checkpoint: export (float32), serve, compare
    seg_art = tmp / "seg_export"
    with contextlib.redirect_stdout(buf):
        export_main(["--workload", "seg", "--model-path", seg_ckpt, "--output-dir",
                     str(seg_art)])
    live, _ = load_seg_checkpoint(Path(seg_ckpt), device="cuda")
    reset_launches()
    server = make_server(str(seg_art), port=0, batch_window_ms=200.0, device="cuda")
    if server.manifest.get("program_file") != "model.pt2":
        raise AssertionError("the protocol seg artifact has no program to serve")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    images = seg_pairs(3, JOINT_SIZE, seed=91)[0]
    try:
        got = _post_npy(f"http://127.0.0.1:{server.server_address[1]}/v1/predict", images)
        calls = server.batcher.snapshot_stats()["device_calls"]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    seg_counts = _counts()
    want = (0, 0, sum(K2_PROTOCOL.values()) * calls, 0)
    log(f"[seg serve] the protocol seg program: K1 / K1 bwd / K2 / K2 bwd {seg_counts} over "
        f"{calls} device calls")
    if calls < 1 or seg_counts != want:
        raise AssertionError(f"the protocol seg program: expected {want} launches over {calls} "
                             f"device calls, got {seg_counts}")
    out["seg_served_launches"] = dict(zip(COUNTED, seg_counts))
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


def _trial_k2(trials, n_train: int, n_val: int, per_forward, backward: bool = False) -> int:
    """K2 launches of a study's trials: ``per_forward(params)`` per training
    step and per validation forward, for each epoch a trial reported (its
    backward's, ``backward``: per training step only)."""
    total = 0
    for t in trials:
        b = int(t["params"]["batch_size"])
        forwards = math.ceil(n_train / b) + (0 if backward else math.ceil(n_val / b))
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
        reset_launches()
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
        k2b = _trial_k2(trials, TUNE_TRAIN, TUNE_VAL, lambda p: K2_TUNE_PER_FORWARD, True)
        if mode == "sequential":
            ckpt_dir = models / "unet_vanilla_tuned_best"
            config = json.loads((ckpt_dir / "config.json").read_text())
            best = CheckpointManager(ckpt_dir).best_step()
            if (set(config) != {"workload", "lr", "alpha", "beta", "gamma", "batch_size",
                                "final_epochs"} or best != 1
                    or not (ckpt_dir / str(best) / "state.pt").exists()
                    or payload["retrain"]["checkpoint"] != str(ckpt_dir)):
                raise AssertionError(f"tune retrain: config {config}, best step {best}")
            retrain = [{"params": config, "intermediate": [0]}]
            k2 += _trial_k2(retrain, TUNE_TRAIN, TUNE_VAL, lambda p: K2_TUNE_PER_FORWARD)
            k2b += _trial_k2(retrain, TUNE_TRAIN, TUNE_VAL, lambda p: K2_TUNE_PER_FORWARD, True)
        if counts != (0, 0, k2, k2b):
            raise AssertionError(f"tune {mode}: expected (0, 0, {k2}, {k2b}) K1 / K1 backward / "
                                 f"K2 / K2 backward launches, got {counts}")
        log(f"[tune {mode}] 3 trials x 2 epochs{' + 1-epoch retrain' if mode == 'sequential' else ''}"
            f" in {seconds:.1f} s: states {states}, batch sizes "
            f"{[t['params']['batch_size'] for t in trials]}, best val loss "
            f"{payload['best_value']:.6f}; K1 {counts[0]}, K1 backward {counts[1]}, K2 {counts[2]} "
            f"launches (2 per lane per training step and validation forward), K2 backward "
            f"{counts[3]} (2 per lane per training step)")
        out["studies"][mode] = {"seconds": seconds, "states": states,
                                "launches": dict(zip(COUNTED, counts))}
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
        reset_launches()
        t0 = time.perf_counter()
        curves = runner.run_group(TUNE_CONFIGS, batch, epochs)
        group_s = time.perf_counter() - t0
        counts = _counts()
        want = K2_TUNE_PER_FORWARD * len(TUNE_CONFIGS) * epochs * sum(
            math.ceil(n / batch) for n in TUNE_LANE_SPLIT)
        want_bwd = K2_TUNE_PER_FORWARD * len(TUNE_CONFIGS) * epochs * math.ceil(
            TUNE_LANE_SPLIT[0] / batch)
        if counts != (0, 0, want, want_bwd):
            raise AssertionError(f"tune lanes: expected (0, 0, {want}, {want_bwd}) launches, got "
                                 f"{counts}")
        singles, singles_s = [], []
        for cfg in TUNE_CONFIGS:
            t0 = time.perf_counter()
            singles.append(runner.run_group([cfg], batch, epochs)[0])
            singles_s.append(time.perf_counter() - t0)
    lanes_np, singles_np = np.asarray(curves), np.asarray(singles)
    worst = float(np.max(np.abs(lanes_np - singles_np) / np.abs(singles_np)))
    log(f"[tune lanes] {len(TUNE_CONFIGS)} lanes x {epochs} epochs at batch {batch}: curves "
        f"{np.round(lanes_np, 6).tolist()}; worst relative difference from single lanes "
        f"{worst:.3e}; K2 {counts[2]}, K2 backward {counts[3]} launches; {ident}: group "
        f"{group_s:.3f} s against "
        f"{sum(singles_s):.3f} s for the single lanes in turn ({sum(singles_s) / group_s:.3f}x)")
    if not worst <= 1e-6 or not np.all(np.isfinite(lanes_np)):
        raise AssertionError(f"tune lanes differ from single lanes: {worst:.3e}")
    out["lanes"] = {"curves": curves, "worst_rel_diff": worst, "group_s": group_s,
                    "singles_s": singles_s, "launches": dict(zip(COUNTED, counts))}

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
    reset_launches()
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
    k2b = _trial_k2(trials, 16, 8, lambda p: _seg_k2_per_forward(p, 256), True)
    if (set(payload) != TUNE_RESULT_KEYS or any(t["state"] != "COMPLETE" for t in trials)
            or not 0.0 <= payload["best_value"] <= 1.0 or counts != (0, 0, k2, k2b)):
        raise AssertionError(f"tune seg: results {payload}, launches {counts} (K2 expected {k2}, "
                             f"K2 backward {k2b})")
    log(f"[tune seg] 2 trials x 1 epoch in {seconds:.1f} s: params "
        f"{[t['params'] for t in trials]}, best val Dice {payload['best_value']:.4f}; K1 "
        f"{counts[0]}, K1 backward {counts[1]}, K2 {counts[2]}, K2 backward {counts[3]} launches "
        f"(expected {k2}, {k2b})")
    out["seg"] = {"seconds": seconds, "params": [t["params"] for t in trials],
                  "launches": dict(zip(COUNTED, counts))}
    torch.cuda.empty_cache()
    return out


def _run_children(cmds: list[list[str]], timeout: float) -> list[str]:
    """Run ``cmds`` at once (each in its own process group) and return their
    output; raise if one fails, and kill every one still running then or
    at ``timeout``."""
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, start_new_session=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{' '.join(c[:8])} ... exited {p.returncode}:\n{out[-4000:]}")
    return outs


def ddp_worker(out: str, argv: list[str]) -> int:
    """``train_sr.main(argv)`` in this process, launched by torchrun or not:
    writes its kernel launches (counts set to 0 just before), whether it ran
    in a process group (backend, world) and what wrapped its model to
    ``out``."""
    import torch.distributed as dist
    from adunet_torch.cli.train_sr import main as train_main

    setup_runtime()
    reset_launches()
    result = train_main(argv)
    torch.cuda.synchronize()
    grouped = dist.is_initialized()
    info = {"launches": list(_counts()), "distributed": grouped,
            "backend": dist.get_backend() if grouped else None,
            "world": dist.get_world_size() if grouped else 1,
            "wrapped": type(result["state"].train_module).__name__,
            "updates": result["state"].step, "run_dir": result["run_dir"],
            "eval": {k: v["psnr_mean"] for k, v in result["eval"].items()}}
    if grouped:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(info))
    return 0


def ddp(tmp: Path, ident: str) -> dict:
    """The slice's path at full width: ``torchrun --standalone --nproc-per-node
    1 -m adunet_torch.cli.train_sr`` (through this script's ``--ddp-worker``,
    which reads the launches) on the bf16 flagship at batch 32 x 256 px from
    a device cache, and the same command without torchrun. NCCL must join at
    world 1 and DDP wrap the model; K1 / K1 backward / K2 / K2 backward launch
    16 / 16 / 4 / 4 a step in both runs; ms/step from each run's ``epoch_metrics.csv`` (its
    last epoch: the first includes cuDNN's and the allocator's warm-up)."""
    corpus = tmp / "ddp_corpus"
    corpus.mkdir()
    write_corpus(corpus, 10, 512, seed=13)  # 8 train / 1 val / 1 test images
    runs = {}
    for mode in ("torchrun", "plain"):
        root = tmp / "ddp" / mode
        args = ["--scale", "0.5", "--depth_override", "3", "--device_cache", "--mixed_precision",
                "--batch_size", str(TRAIN_BATCH), "--patch_size", str(TRAIN_PATCH),
                "--patches_per_image", str(DDP_PPI), "--epochs", str(DDP_EPOCHS),
                "--high_res_dir", str(corpus), "--image_suffix", ".npy", "--model_dir",
                str(root / "models"), "--log_dir", str(root / "logs"), "--run_name", "r",
                "--seed", "11"]
        out = tmp / "ddp" / f"{mode}.json"
        launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "1"] if mode == "torchrun" else [sys.executable])
        t0 = time.perf_counter()
        printed = _run_children([launcher + [str(ROOT / "chip_smoke.py"), "--ddp-worker",
                                             str(out), "--", *args]], timeout=400)[0]
        info = json.loads(out.read_text())
        info["seconds"] = time.perf_counter() - t0
        run_dir = Path(info["run_dir"])
        with open(run_dir / "epoch_metrics.csv") as f:
            rows = list(csv.DictReader(f))
        info["ms_per_step"] = [float(r["ms_per_step"]) for r in rows]
        info["loss"] = [float(r["loss"]) for r in rows]
        info["steps_per_epoch"] = json.loads((run_dir / "config.json").read_text())[
            "steps_per_epoch"]
        for line in printed.splitlines():
            if line.startswith(("Epoch", "Model:")) or "PSNR(Y)" in line:
                log(f"[ddp] {mode}: {line}")
        runs[mode] = info
    t, p = runs["torchrun"], runs["plain"]
    if (t["backend"], t["world"], t["wrapped"]) != ("nccl", 1, "DistributedDataParallel"):
        raise AssertionError(f"torchrun run: backend {t['backend']}, world {t['world']}, "
                             f"model {t['wrapped']}; expected nccl, 1, DistributedDataParallel")
    if p["distributed"] or p["wrapped"] != "AdaptiveSRUNet":
        raise AssertionError(f"the plain run joined a group or wrapped its model: {p}")
    per_step = {}
    for mode, info in runs.items():
        steps = DDP_EPOCHS * info["steps_per_epoch"]
        forwards = steps + DDP_EPOCHS + 2  # train, val (4 tiles, one batch), eval (val, test)
        want = [16 * forwards, 16 * steps, 4 * forwards, 4 * steps]
        if info["launches"] != want or info["updates"] != steps:
            raise AssertionError(f"{mode}: {info['launches']} launches (K1 / K1 backward / K2 / "
                                 f"K2 backward) and {info['updates']} updates; expected {want} "
                                 f"and {steps}")
        if not all(np.isfinite(info["loss"])):
            raise AssertionError(f"{mode}: non-finite training loss {info['loss']}")
        extra = forwards - steps  # forwards without a backward
        k1, k1b, k2, k2b = info["launches"]
        per_step[mode] = [(k1 - 16 * extra) / steps, k1b / steps, (k2 - 4 * extra) / steps,
                          k2b / steps]
    ms_t, ms_p = t["ms_per_step"][-1], p["ms_per_step"][-1]
    log(f"[ddp] {ident}: backend {t['backend']}, world {t['world']}, model wrapped in "
        f"{t['wrapped']}; flagship bf16 batch {TRAIN_BATCH} x {TRAIN_PATCH} px, device cache, "
        f"{DDP_EPOCHS} x {t['steps_per_epoch']} steps: {ms_t:.3f} ms/step under torchrun, "
        f"{ms_p:.3f} without ({100 * (ms_t / ms_p - 1):+.2f} %; last epoch, epoch_metrics.csv); "
        f"K1 / K1 backward / K2 / K2 backward per step "
        f"{'/'.join(f'{v:g}' for v in per_step['torchrun'])} "
        f"(without torchrun {'/'.join(f'{v:g}' for v in per_step['plain'])}); losses "
        f"{t['loss']} / {p['loss']}; {t['seconds']:.1f} / {p['seconds']:.1f} s a run")
    return {"launches": dict(zip(COUNTED, t["launches"])),
            "per_step": per_step["torchrun"], "backend": t["backend"], "world": t["world"],
            "ms_per_step": {"torchrun": t["ms_per_step"], "plain": p["ms_per_step"]},
            "loss": {"torchrun": t["loss"], "plain": p["loss"]},
            "seconds": {"torchrun": t["seconds"], "plain": p["seconds"]}}


def _full(t: torch.Tensor) -> torch.Tensor:
    """A parameter on the host, whole (a sharded one gathered)."""
    from adunet_torch.parallel.partition import full_tensor

    return full_tensor(t).detach().to("cpu", copy=True)


def _ranks_sr_step(data: dict, mesh=None) -> dict:
    """One float32 step of the flagship on the card from ``data``'s init and
    global batch, this process's rows of it on ``mesh``'s data axis."""
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.parallel import data_parallel, shard_batch
    from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step

    model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cuda")
    model.load_state_dict(data["sr_init"])
    state = create_train_state(model, make_optimizer(model.parameters(), RANKS_LR))
    if mesh is not None:
        state = data_parallel(state, mesh)
    hr = data["hr"] if mesh is None else shard_batch(data["hr"], mesh)
    _, metrics = make_sr_train_step(model, charbonnier_loss)(state, hr)
    from torch.distributed.tensor import DTensor

    return {"loss": float(metrics["loss"]),
            "params": {n: _full(p) for n, p in model.named_parameters()},
            "sharded": sorted(n for n, p in model.named_parameters() if isinstance(p, DTensor))}


def _ranks_seg_step(data: dict, mesh=None, global_bn: bool = True) -> dict:
    """One float32 step of the protocol seg U-Net on the card (BatchNorm;
    ``global_bn=False`` leaves each process its own batch statistics)."""
    from adunet_torch.nn.blocks import BatchNorm
    from adunet_torch.parallel import data_parallel, shard_batch
    from adunet_torch.train import create_train_state, make_optimizer, make_seg_train_step

    model, loss_fn, _, _ = _seg_setup("protocol", torch.float32, "cuda")
    model.load_state_dict(data["seg_init"])
    state = create_train_state(model, make_optimizer(model.parameters(), RANKS_LR))
    if mesh is not None:
        state = data_parallel(state, mesh)
        for m in model.modules():
            if isinstance(m, BatchNorm) and not global_bn:
                m.sync_group = None
    batch = data["seg"] if mesh is None else shard_batch(data["seg"], mesh)
    _, metrics = make_seg_train_step(model, loss_fn, augment="none")(state, batch)
    return {"loss": float(metrics["loss"]),
            "grads": {n: _full(p.grad) for n, p in model.named_parameters()},
            "state": {n: _full(v) for n, v in model.state_dict().items()}}


def ranks_worker(rank: int, world: int, rdv: str, inp: str, out: str) -> int:
    """One of ``world`` processes on this card in a gloo group (CUDA tensors;
    gloo is only the transport): the flagship step data-parallel, the
    protocol seg step with BatchNorm on the global batch and with per-rank
    statistics, and the flagship step with ``--model_shards 2``."""
    import faulthandler

    import torch.distributed as dist
    from adunet_torch.parallel import make_dp_model_mesh, make_mesh

    faulthandler.enable()
    setup_runtime()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world)
    data = torch.load(inp, weights_only=False)
    parts = {"sr": lambda m: _ranks_sr_step(data, m), "seg": lambda m: _ranks_seg_step(data, m),
             "seg_per_rank": lambda m: _ranks_seg_step(data, m, global_bn=False),
             "shards": lambda m: _ranks_sr_step(data, make_dp_model_mesh(world,
                                                                         device_type="cuda"))}
    res = {}
    with deterministic_cudnn():
        mesh = make_mesh(device_type="cuda")
        for name, part in parts.items():
            t0 = time.perf_counter()
            res[name] = part(mesh)
            torch.cuda.synchronize()
            print(f"[rank {rank}] {name} in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float((got[n] - w).double().square().sum()) for n, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (num / den) ** 0.5


def ddp_ranks(tmp: Path) -> dict:
    """Two processes on the one card in a gloo group (``--ranks-worker``),
    held to one process at the same global batch of 8 (4 a rank):

    (a) one float32 flagship step: loss 1e-5 relative; params after the
        Adam step 1e-5 in relative L2 over all of them;
    (b) one float32 step of the protocol seg U-Net at 256 px: loss and
        every running statistic 1e-5 (relative L2 per buffer); gradients 2e-2
        relative L2 (float32 keeps this BatchNorm model's gradients to ~5e-3,
        ``scripts/torch_seg_grad_precision.py``), the biases feeding a
        BatchNorm (true gradient 0) within 2e-4 of the largest gradient norm;
        the same step with per-rank batch statistics must miss the running
        statistics by more than 1e-3 (so the check would catch it);
    (c) ``--model_shards 2`` (world 2, data extent 1: both processes on the
        whole batch of 8) against (a)'s one process, as (a).

    Everything under deterministic cuDNN."""
    from adunet_torch.models import build_super_resolution_unet

    sr_model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cpu", seed=3)
    with torch.no_grad():  # off the identity start: every parameter gets a gradient
        pgen = torch.Generator().manual_seed(4)
        for p in sr_model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=pgen))
    seg_model, _, _, _ = _seg_setup("protocol", torch.float32, "cpu", seed=3)
    synth = _synth()
    rng = np.random.default_rng(22)
    hr = np.stack([np.round(synth(rng, TRAIN_PATCH) * 255).astype(np.uint8)
                   for _ in range(RANKS_BATCH)])
    data = {"sr_init": sr_model.state_dict(), "seg_init": seg_model.state_dict(), "hr": hr,
            "seg": seg_pairs(RANKS_BATCH, SEG_SIZE, seed=43)}
    inp = tmp / "ranks_in.pt"
    torch.save(data, inp)
    with deterministic_cudnn():
        one_sr, one_seg = _ranks_sr_step(data), _ranks_seg_step(data)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _run_children([[sys.executable, str(ROOT / "chip_smoke.py"), "--ranks-worker", str(r), "2",
                    str(tmp / "ranks_rdv"), str(inp), str(tmp)] for r in range(2)], timeout=400)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    r0 = ranks[0]
    out = {"seconds": seconds}
    # (a) and (c)
    for key in ("sr", "shards"):
        got = r0[key]
        out[key] = {"loss_rel": abs(got["loss"] - one_sr["loss"]) / abs(one_sr["loss"]),
                    "params_rel_l2": _rel_l2(got["params"], one_sr["params"]),
                    "ranks_equal_loss": ranks[1][key]["loss"] == got["loss"]}
        if not (out[key]["loss_rel"] <= 1e-5 and out[key]["params_rel_l2"] <= 1e-5
                and out[key]["ranks_equal_loss"]):
            raise AssertionError(f"ddp_ranks {key}: {out[key]}")
    shards = r0["shards"]["sharded"]
    if not {"bottleneck.conv1.weight", "enc2.norm0.weight"} <= set(shards) \
            or "enc0.conv1.weight" in shards:
        raise AssertionError(f"--model_shards 2 sharded {shards}")
    out["shards"]["sharded_leaves"] = len(shards)
    # (b)
    got, want = r0["seg"], one_seg
    top = max(float(g.norm()) for g in want["grads"].values())
    pre_bn = {n.replace("norm", "conv").replace("running_mean", "bias")
              for n in want["state"] if n.endswith(".running_mean")}
    stats = [n for n in want["state"] if "running" in n]
    seg = {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "stats_rel_l2": max(float((got["state"][n] - want["state"][n]).norm()
                                     / want["state"][n].norm()) for n in stats),
           "per_rank_stats_rel_l2": max(float((r0["seg_per_rank"]["state"][n] - want["state"][n])
                                              .norm() / want["state"][n].norm()) for n in stats),
           "grad_rel_l2": max(float((got["grads"][n] - g).norm() / g.norm().clamp_min(1e-30))
                              for n, g in want["grads"].items() if n not in pre_bn),
           "pre_bn_bias_abs": max(float((got["grads"][n] - want["grads"][n]).norm())
                                  for n in pre_bn) / top}
    out["seg"] = seg
    if not (seg["loss_rel"] <= 1e-5 and seg["stats_rel_l2"] <= 1e-5 and seg["grad_rel_l2"] <= 2e-2
            and seg["pre_bn_bias_abs"] <= 2e-4 and seg["per_rank_stats_rel_l2"] > 1e-3):
        raise AssertionError(f"ddp_ranks seg: {seg}")
    log(f"[ddp_ranks] 2 processes on one card, gloo over CUDA tensors, global batch "
        f"{RANKS_BATCH} (4 a rank), float32, deterministic cuDNN: flagship step loss rel "
        f"{out['sr']['loss_rel']:.1e}, params rel L2 {out['sr']['params_rel_l2']:.1e}; protocol "
        f"seg step loss rel {seg['loss_rel']:.1e}, running statistics rel L2 "
        f"{seg['stats_rel_l2']:.1e} (per-rank statistics {seg['per_rank_stats_rel_l2']:.1e}, "
        f"which the 1e-5 check catches), gradients rel L2 {seg['grad_rel_l2']:.1e}, pre-BN biases "
        f"{seg['pre_bn_bias_abs']:.1e}; --model_shards 2 ({len(shards)} leaves sharded, FSDP2 "
        f"over gloo) loss rel {out['shards']['loss_rel']:.1e}, params rel L2 "
        f"{out['shards']['params_rel_l2']:.1e}; {seconds:.1f} s for the 2 processes")
    return out


def check_k2_halo(gen: torch.Generator) -> list[dict]:
    """K2's halo-row mode (``conv64.conv3x3_rows``) at the shapes a (1, 2)
    space mesh gives each rank: 128 of 256 rows plus a neighbour row above
    and below, at the flagship's batch (bf16 and float32) and the deep
    config's (bf16). Held to its plain version; timed beside cuDNN's
    ``F.conv2d`` with padding (0, 1) and its bound (the H + 2 rows read
    once, the H rows written once)."""
    rows_out = []
    for shape, per_call, dtype in K2_HALO_CASES:
        x, wt, bias = _k2_inputs(gen, shape, dtype)
        got = conv64.conv3x3_rows(x, wt, bias)
        want = conv64.conv3x3_rows_plain(x, wt, bias)
        torch.cuda.synchronize()
        err = close_enough(got, want, dtype, 1e-4, atol_bf16=K2_BF16_ATOL)
        ms = cuda_ms(lambda: conv64.conv3x3_rows(x, wt, bias), 20)
        cost = launch_cost("K2_halo", lambda: conv64.conv3x3_rows(x, wt, bias), K2_KERNEL[dtype])
        dev_ms, dev_n = cost["device_ms"], cost["device_launches_recorded"]
        plain = cuda_ms(lambda: conv64.conv3x3_rows_plain(x, wt, bias), 5)
        xn, wl, bl = x.permute(0, 3, 1, 2), wt.to(dtype), bias.to(dtype)  # as check_k2's
        lib = cuda_ms(lambda: F.conv2d(xn, wl, bl, padding=(0, 1)), 20)
        lib_dev, lib_n = profiled_device_ms(lambda: F.conv2d(xn, wl, bl, padding=(0, 1)))
        bsz, h2, w, c = shape
        pixels = bsz * (h2 - 2) * w
        es = x.element_size()
        bnd, by = bound_ms((bsz * h2 * w + pixels) * c * es + 9 * 64 * 64 * 4 + 64 * 4,
                           2 * pixels * 64 * 64 * 9 + pixels * 64, dtype)
        rows_out.append(dict(kernel="K2_halo", path="space", shape=list(shape),
                             dtype=_dname(dtype), per_call=per_call, max_abs_err=err, ms=ms,
                             **cost, plain_ms=plain,
                             library_ms=lib, library_device_ms=lib_dev,
                             library_kernels_recorded=lib_n, bound_ms=bnd, bound_by=by))
        log(f"[K2 halo] x={'x'.join(map(str, shape))} {dtype}: max|err|={err:.2e} kernel "
            f"{ms:.4f} ms (events; profiler device time {_ms(dev_ms)} over {dev_n} launches; "
            f"host {cost['host_us']:.2f} us a call, {cost['device_kernels_per_call']:g} device "
            f"kernels a call), "
            f"plain {plain:.4f} ms, F.conv2d padding (0, 1) (cuDNN, TF32 off) {lib:.4f} ms "
            f"(device time {_ms(lib_dev)}), bound {bnd:.4f} ms ({by})")
        del x, got, want
    return rows_out


def sweep(tmp: Path, ident: str) -> dict:
    """The experiment tooling at full width: ``adunet_torch.cli.run_experiment
    --experiment adaptive_depth --scales 0.5 --mode run --auto_eval`` (the
    flagship, 256 px, the H100 table's batch, bf16, a device cache, 1 epoch
    of 2 steps, then ``evaluate`` on the corpus), with the counts set to 0
    just before: 16 K1 / 16 K1 backward / 4 K2 a step and 16 / 0 / 4 a
    forward. Then the port's ``plot_experiment_metrics`` over the run's
    evaluation (its ``summary_metrics.csv``; the figures need matplotlib,
    and without it the CLI must fail on them after writing the table), and
    ``inspect_example`` (or, where matplotlib imports, the ``inspect`` CLI)
    on the run's best checkpoint: 16 / 0 / 4 a forward."""
    import importlib.util

    from adunet_torch.cli import inspect as inspect_cli
    from adunet_torch.cli import plot_experiment_metrics
    from adunet_torch.cli.evaluate import load_checkpoint_state
    from adunet_torch.cli.run_experiment import main as sweep_main
    from adunet_torch.experiments import EXPERIMENT2_DEPTHS, H100_BATCH_SIZES

    corpus = tmp / "sweep_corpus"
    corpus.mkdir()
    write_corpus(corpus, 10, 512, seed=17)  # 8 train / 1 val / 1 test; 40 eval tiles
    root = tmp / "sweep"
    batch, depth = H100_BATCH_SIZES[0.5], EXPERIMENT2_DEPTHS[0.5]
    args = ["--experiment", "adaptive_depth", "--scales", "0.5", "--mode", "run", "--auto_eval",
            "--epochs", "1", "--high_res_dir", str(corpus), "--image_suffix", ".npy",
            "--model_dir", str(root / "models"), "--log_dir", str(root / "logs"),
            "--metadata_dir", str(root / "metadata"),
            "--extra_args", "--device_cache", "--patches_per_image", str(SWEEP_PPI),
            "--image_suffix", ".npy"]
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sweep_main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1, k1b, k2, k2b = _counts()
    for line in buf.getvalue().splitlines():
        if line.startswith(("===", "Epoch", "Model:", "  PSNR", "Scored")) or "PSNR(Y)" in line:
            log(f"[sweep] {line}")
    name = f"exp_adaptive_depth_scale0.50_depth{depth}"
    cfg = json.loads((root / "logs" / name / "config.json").read_text())
    steps = cfg["steps_per_epoch"]
    forwards = k1 // 16
    if (cfg["batch_size"], cfg["mixed_precision"], cfg["n_params"], steps) != (
            batch, True, 8_637_379, 2) or (k1, k1b, k2, k2b) != (16 * forwards, 16 * steps,
                                                                 4 * forwards, 4 * steps):
        raise AssertionError(f"sweep: batch {cfg['batch_size']}, bf16 {cfg['mixed_precision']}, "
                             f"{cfg['n_params']} params, {steps} steps; launches K1 / K1 backward"
                             f" / K2 / K2 backward {k1} / {k1b} / {k2} / {k2b} (expected 16 / 16 "
                             "/ 4 / 4 a step, 16 / 0 / 4 / 0 a forward)")
    report = root / "logs" / "evaluation" / f"{name}_eval"
    metrics = json.loads((report / "metrics.json").read_text())
    if metrics["samples"] != 40 or not np.isfinite(metrics["psnr_mean"]):
        raise AssertionError(f"sweep: the auto-eval report {metrics}")
    # the analysis CLI over the sweep's evaluation reports
    plots = root / "plots"
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    argv = sys.argv
    sys.argv = ["plot_experiment_metrics", "--experiment-dir", str(root / "logs"), "--output-dir",
                str(plots)]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            plot_experiment_metrics.main()
        figures = sorted(p.name for p in plots.glob("*.png"))
    except ImportError as e:  # the figures, after the table: only where matplotlib is missing
        if has_mpl or "matplotlib" not in str(e):
            raise
        figures = f"none: {e}"
    finally:
        sys.argv = argv
    with open(plots / "summary_metrics.csv") as f:
        summary = list(csv.DictReader(f))
    if len(summary) != 1 or float(summary[0]["scale"]) != 0.5 or \
            abs(float(summary[0]["psnr_mean"]) - metrics["psnr_mean"]) > 1e-9:
        raise AssertionError(f"summary_metrics.csv: {summary} against {metrics}")
    # inspect on the run's best checkpoint
    ckpt = root / "models" / f"unet_adaptive_scale0.50_depth{depth}"
    if has_mpl:
        reset_launches()
        grids = inspect_cli.main(["--model-path", str(ckpt), "--scale", "0.5", "--hr-dir",
                                  str(corpus), "--image-suffix", ".npy", "--n-examples", "2",
                                  "--output-dir", str(root / "inspection")])
        n_forwards, shown = len(grids), [p.name for p in grids]
    else:
        _, model, _ = load_checkpoint_state(ckpt, 0.5, 256, None, best=True, device="cuda")
        hr = np.load(sorted(corpus.glob("*.npy"))[0])[:256, :256].astype(np.float32) / 255.0
        reset_launches()
        example = inspect_cli.inspect_example(model, hr, 0.5, 256)
        n_forwards = 1
        shown = {"peak": example["peak"], "psnr": example["psnr"], "ssim": example["ssim"],
                 "panels": [name for name, _, _ in example["panels"]],
                 "crops": [list(c.shape) for c in example["crops"]]}
        if not (np.isfinite(example["psnr"]) and all(np.isfinite(img).all()
                                                    for _, img, _ in example["panels"])):
            raise AssertionError(f"inspect_example: {shown}")
    torch.cuda.synchronize()
    counts = _counts()
    if counts != (16 * n_forwards, 0, 4 * n_forwards, 0):
        raise AssertionError(f"inspect: launches {counts} for {n_forwards} forwards")
    log(f"[sweep] {ident}: run_experiment adaptive_depth scale 0.5 (depth {depth}, H100 table "
        f"batch {batch}, bf16, device cache): {steps} steps, {forwards} forwards with the "
        f"auto-eval, K1 / K1 backward / K2 / K2 backward {k1} / {k1b} / {k2} / {k2b} (16 / 16 / "
        f"4 / 4 a step), "
        f"{seconds:.1f} s; eval PSNR(Y) {metrics['psnr_mean']:.4f} dB over {metrics['samples']} "
        f"tiles; summary_metrics.csv {summary[0]}; figures {figures}; inspect "
        f"({'CLI' if has_mpl else 'inspect_example, no matplotlib'}) {shown}, launches {counts}")
    return {"launches": {"K1": k1, "K1_bwd": k1b, "K2": k2, "K2_bwd": k2b}, "steps": steps,
            "forwards": forwards, "seconds": seconds, "eval": metrics, "summary": summary[0],
            "figures": figures, "inspect": shown, "matplotlib": has_mpl}


def _space_model(case: str, device: str):
    """A space case's model from its seed, off the identity start (the same
    weights in every process: the draws come from seeded CPU generators)."""
    from adunet_torch.models import build_super_resolution_unet

    scale, depth, _, dtype = SPACE_CASES[case]
    model, _ = build_super_resolution_unet(scale, depth_override=depth, dtype=dtype,
                                           device=device, seed=3)
    with torch.no_grad():
        pgen = torch.Generator().manual_seed(4)
        for p in model.parameters():
            p.add_((0.02 * torch.randn(p.shape, generator=pgen)).to(p.device))
    return model


def _space_step(case: str, hr: np.ndarray, mesh=None) -> dict:
    """One Adam step of a space case on the card (this process's rows of the
    batch on ``mesh``), counts set to 0 just before it and read just after,
    its peak memory, then 3 more steps timed (CUDA events)."""
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.parallel import data_parallel, shard_batch
    from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step

    model = _space_model(case, "cuda")
    state = create_train_state(model, make_optimizer(model.parameters(), RANKS_LR))
    if mesh is not None:
        state = data_parallel(state, mesh)
    batch = hr if mesh is None else shard_batch(hr, mesh)
    step = make_sr_train_step(model, charbonnier_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, metrics = step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    out = {"loss": loss, "launches": [*_counts(), conv64.conv3x3_rows.launches,
                                      conv64.conv3x3_same_backward.rows_launches],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "rows": int(batch.shape[1]),
           "params": {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}}
    out["ms_per_step"] = cuda_ms(lambda: step(state, batch), 3)
    del state, model, step
    torch.cuda.empty_cache()
    return out


def space_worker(rank: int, world: int, rdv: str, inp: str, out: str) -> int:
    """One of 2 processes on this card in a gloo group on a (1, 2) space mesh
    (each holds 128 of the 256 rows of every image): every space case's
    step. Rank 0 writes its params; every rank its loss, launches, memory
    and a digest of its params."""
    import faulthandler

    import torch.distributed as dist
    from adunet_torch.parallel import make_dp_spatial_mesh

    faulthandler.enable()
    setup_runtime()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world)
    data = torch.load(inp, weights_only=False)
    res = {}
    with deterministic_cudnn():
        mesh = make_dp_spatial_mesh(2, device_type="cuda")
        for case in SPACE_CASES:
            t0 = time.perf_counter()
            r = _space_step(case, data[case], mesh)
            r["digest"] = sum(float(p.double().square().sum()) for p in r["params"].values())
            if rank != 0:
                del r["params"]
            res[case] = r
            print(f"[rank {rank}] {case} in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.save(res, f"{out}/space_rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def space_ranks(tmp: Path, ident: str) -> dict:
    """The data x space mesh on the card: 2 processes share it in a gloo group
    on a (1, 2) mesh (``--space-worker``), each on 128 of every image's 256
    rows, against one process on the whole batch, for the float32 and bf16
    flagship at batch 32 and the bf16 deep config (138,427,843 params) at
    batch 8, each one Adam step from the same seeded weights under
    deterministic cuDNN: float32 loss and params (relative L2 over all of
    them) within 1e-5; bf16 loss within 1e-2 and params within 1e-3 (the
    ranks' smaller convolutions take other cuDNN algorithms and the resizes
    other sums, so bf16 activations round elsewhere; one Adam step moves an
    element by at most the rate); both ranks the same loss and params; on
    each rank and step K1 / K1 backward / K2 / K2 backward (halo-row mode)
    16 / 16 / 4 / 4 on the flagship and 24 / 24 / 4 / 4 on the deep config,
    the SAME K2 and its backward never; peak memory per rank beside one
    process's."""
    synth = _synth()
    rng = np.random.default_rng(23)
    data = {}
    for case, (_, _, batch, _) in SPACE_CASES.items():
        data[case] = np.stack([np.round(synth(rng, TRAIN_PATCH) * 255).astype(np.uint8)
                               for _ in range(batch)])
    inp = tmp / "space_in.pt"
    torch.save(data, inp)
    one = {}
    with deterministic_cudnn():
        for case in SPACE_CASES:
            one[case] = _space_step(case, data[case])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _run_children([[sys.executable, str(ROOT / "chip_smoke.py"), "--space-worker", str(r), "2",
                    str(tmp / "space_rdv"), str(inp), str(tmp)] for r in range(2)], timeout=500)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"space_rank{r}.pt", weights_only=False) for r in range(2)]
    out = {"seconds": seconds}
    for case, (_, depth, batch, dtype) in SPACE_CASES.items():
        got, want = ranks[0][case], one[case]
        per_step = [24, 24, 0, 0, 4, 4] if depth == 5 else [16, 16, 0, 0, 4, 4]
        res = {"loss": got["loss"], "loss_one": want["loss"],
               "loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
               "params_rel_l2": _rel_l2(got["params"], want["params"]),
               "launches_per_rank": [r[case]["launches"] for r in ranks],
               "launches_one": want["launches"],
               "peak_gb_per_rank": [r[case]["peak_gb"] for r in ranks], "peak_gb_one": want["peak_gb"],
               "rows_per_rank": [r[case]["rows"] for r in ranks],
               "ms_per_step_per_rank": [r[case]["ms_per_step"] for r in ranks],
               "ms_per_step_one": want["ms_per_step"]}
        loss_tol, params_tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-3)
        if not (res["loss_rel"] <= loss_tol and res["params_rel_l2"] <= params_tol
                and ranks[1][case]["loss"] == got["loss"]
                and ranks[1][case]["digest"] == got["digest"]
                and all(lc == per_step for lc in res["launches_per_rank"])
                and res["rows_per_rank"] == [128, 128]):
            raise AssertionError(f"space_ranks {case}: {res}")
        out[case] = res
        log(f"[space_ranks] {ident}: {case} (batch {batch} x 256 px, {_dname(dtype)}) on a (1, 2) "
            f"space mesh, 2 processes sharing the card over gloo: loss {got['loss']:.6f} against "
            f"one process's {want['loss']:.6f} (rel {res['loss_rel']:.1e}), params rel L2 "
            f"{res['params_rel_l2']:.1e}; launches a rank K1 / K1 backward / K2 / K2 backward / "
            f"K2 halo / K2 halo backward {res['launches_per_rank']} (one process "
            f"{want['launches']}); peak memory a rank "
            + " / ".join(f"{v:.2f}" for v in res["peak_gb_per_rank"])
            + f" GB against {want['peak_gb']:.2f} GB in one process; ms/step of two processes "
            f"sharing one card (not a speed) "
            + " / ".join(f"{v:.1f}" for v in res["ms_per_step_per_rank"])
            + f", one process {want['ms_per_step']:.1f}")
    return out


def kernels_line(details: list[dict], grads: list[dict], launches: dict, serve_launches: dict,
                 seg_launches: dict, sr_launches: dict, build_s: float) -> dict:
    """One entry per kernel. ``launches`` come from the training path (device-
    cache steps); ``ms``, ``device_ms``, ``plain_ms``, ``bound_ms``,
    ``library_ms``, ``library_device_ms`` and ``host_us`` are summed over the
    kernel's launches in one bf16 training step (per-shape time x launches
    per step), ``ms`` from CUDA events, ``device_ms`` from the profiler (null
    where it recorded no full session at some shape) and ``host_us`` the
    wall time a call of back-to-back calls (``host_us``);
    ``device_kernels_per_call`` is the most device kernels one call of the
    wrapper launched at any shape (profiler, every kernel name); ``serve``
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
    lane step's batch 4, 8 and 16 x 256 px; ``ddp`` the launches of the
    ``train_sr`` run under torchrun (NCCL, world 1; its training steps,
    validation and evaluation forwards). K1's and K1_bwd's ``train_bias``
    holds the same sums over the launches of a flagship step that take a
    conv's bias, and ``unfused_ms`` the route before (the add + K1; K1's
    backward + the bias sum)."""
    meta = {
        "K1": ("layer_norm_relu", "adunet_torch/csrc/fused_norm.cu", "adunet/kernels/fused_norm.py:48"),
        "K1_bwd": ("layer_norm_relu_backward", "adunet_torch/csrc/fused_norm.cu",
                   "adunet/kernels/fused_norm.py:109"),
        "K2": ("conv3x3_same_c64", "adunet_torch/csrc/conv64.cu", "adunet/kernels/conv64.py:132"),
        "K2_bwd": ("conv3x3_same_c64_backward", "adunet_torch/csrc/conv64.cu",
                   "adunet/kernels/conv64.py:203"),
    }
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms",
            "host_us")

    def summed(rows, key):  # None where the profiler measured no device time
        vals = [d[key] for d in rows]
        return None if None in vals else sum(v * d["per_call"] for v, d in zip(vals, rows))

    def summed_at(rows, key, per_step):  # the same, with another path's launches per step
        rows = [d for d in rows if tuple(d["shape"]) in per_step]
        vals = [d[key] for d in rows]
        return None if None in vals else sum(v * per_step[tuple(d["shape"])]
                                             for v, d in zip(vals, rows))

    # (rows' path, launches per step of each kernel) of the bf16 segmentation steps
    seg_paths = {"protocol": ("serve", {"K2": K2_PROTOCOL, "K2_bwd": K2_PROTOCOL}),
                 "vanilla": ("vanilla", {"K1": K1_VANILLA, "K1_bwd": K1_VANILLA,
                                         "K2": K2_VANILLA, "K2_bwd": K2_VANILLA})}
    # the same for the SR paths of this script's later phases
    sr_paths = {"deep": ("deep", "serve", {"K1": K1_DEEP, "K1_bwd": K1_DEEP, "K2": K2_DEEP,
                                           "K2_bwd": K2_DEEP}),
                "vanilla_sr": (None, "serve", {"K2": K2_VANILLA_SR, "K2_bwd": K2_VANILLA_SR}),
                "joint": ("joint", "serve", {"K1": K1_JOINT, "K1_bwd": K1_JOINT, "K2": K2_JOINT,
                                             "K2_bwd": K2_JOINT})}

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
            "device_kernels_per_call": max(d["device_kernels_per_call"] for d in details
                                           if d["kernel"] == kid),
            "per": "launches of one bf16 training step of the flagship (batch 32, 256 px)",
            "serve": {"launches": serve_launches[kid], **{k: summed(serve, k) for k in keys}},
            "seg": {},
        }
        biased = [d for d in details if d["kernel"] == kid and d["path"] == "train+bias"]
        if biased:  # K1's launches of one flagship step that take a conv's bias
            entry["train_bias"] = {"launches": launches[f"{kid}_bias"],
                                   **{k: summed(biased, k) for k in keys + ("unfused_ms",)}}
        for path, (rows_path, per) in seg_paths.items():
            rows = [d for d in details if d["kernel"] == kid and d["path"] == rows_path
                    and d["dtype"] == "bfloat16"]
            sums = {k: summed_at(rows, k, per[kid]) for k in keys} if kid in per else {}
            shapes = [d["shape"] for d in rows if tuple(d["shape"]) in per.get(kid, {})]
            entry["seg"][path] = {"launches": seg_launches[path][kid], "shapes": shapes, **sums}
        entry["streamed"] = {"launches": sr_launches["streamed"][kid]}
        entry["program"] = {"launches": sr_launches["program"][kid],
                            "per": "the flagship int8 program served over HTTP"}
        entry["ddp"] = {"launches": sr_launches["ddp"][kid]}
        entry["sweep"] = {"launches": sr_launches["sweep"][kid]}
        entry["graph"] = {"launches": sr_launches["graph"][kid],
                          "per": "the capture of one joint bf16 forward + backward"}
        # the served joint forward: float32 at the serving rows and K1_JOINT_SERVED's
        per = {"K1": K1_JOINT, "K2": K2_JOINT}.get(kid, {})
        rows = [d for d in details if d["kernel"] == kid and d["dtype"] == "float32"
                and d["path"] in ("serve", "joint_served") and tuple(d["shape"]) in per]
        entry["joint_served"] = {"launches": sr_launches["joint_served"][kid],
                                 "shapes": [d["shape"] for d in rows],
                                 **({k: summed_at(rows, k, per) for k in keys} if per else {})}
        for path, (k1_rows, k2_rows, per) in sr_paths.items():
            rows_path = k2_rows if kid in ("K2", "K2_bwd") else k1_rows
            rows = [d for d in details if d["kernel"] == kid and d["path"] == rows_path
                    and d["dtype"] == "bfloat16"]
            sums = {k: summed_at(rows, k, per[kid]) for k in keys} if kid in per else {}
            shapes = [d["shape"] for d in rows if tuple(d["shape"]) in per.get(kid, {})]
            entry[path] = {"launches": sr_launches[path][kid], "shapes": shapes, **sums}
        # the tuner's float32 lane steps: per launch at batch 4 and 16 (path
        # "tune") and 8 (the float32 serving row), with forward + backward
        rows = [d for d in details if d["kernel"] == kid and d["dtype"] == "float32"
                and (d["path"] == "tune" or (d["path"] == "serve" and kid in ("K2", "K2_bwd")))]
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
    # K2's halo-row mode and its backward: the space_ranks phase's rank 0 over
    # its checked steps; the sums over one bf16 flagship step's launches on a
    # rank
    for kid, name, replaces, counted in (
            ("K2_halo", "conv3x3_rows_c64", "adunet/kernels/conv64.py:132", "space"),
            ("K2_bwd_halo", "conv3x3_rows_c64_backward", "adunet/kernels/conv64.py:203",
             "space_bwd")):
        halo = [d for d in details if d["kernel"] == kid]
        flagship = [d for d in halo if d["dtype"] == "bfloat16" and d["shape"][0] == TRAIN_BATCH]
        out.append({"name": name, "route": "cuda", "source": "adunet_torch/csrc/conv64.cu",
                    "replaces": replaces,
                    "launches": sum(sr_launches[counted].values()),
                    "max_abs_err": max(d["max_abs_err"] for d in halo),
                    **{k: summed(flagship, k) for k in keys}, "bound_by": flagship[0]["bound_by"],
                    "device_kernels_per_call": max(d["device_kernels_per_call"] for d in halo),
                    "per": "launches on one rank of one bf16 flagship step on a (1, 2) space "
                           "mesh (batch 32, 128 + 2 of 256 rows)",
                    "space": {"launches": sr_launches[counted]},
                    "rows": [{k: d[k] for k in ("shape", "dtype", "per_call", "max_abs_err", "ms",
                                                "device_ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "library_device_ms", "host_us",
                                                "device_kernels_per_call")} for d in halo]})
    # K3: the served forward's float32 convs outside K2's gate; no training
    # step runs it (``launches``: the train phase's, 0)
    k3 = [d for d in details if d["kernel"] == "K3"]
    lib_keys = ("library_benchmark_ms", "library_benchmark_device_ms", "pack_device_ms")
    out.append({"name": "conv3x3_f32", "route": "cuda", "source": "adunet_torch/csrc/conv3x3_f32.cu",
                "replaces": "none: the reference's convs run in XLA (adunet/nn/blocks.py:59)",
                "launches": launches["K3"],
                "max_abs_err": max(d["max_abs_err"] for d in k3),
                **{k: summed(k3, k) for k in keys + lib_keys}, "bound_by": "operations",
                "device_kernels_per_call": max(d["device_kernels_per_call"] for d in k3),
                "per": "launches of one float32 served flagship forward (batch 8, 256 px)",
                "serve": {"launches": serve_launches["K3"]},
                "program": {"launches": sr_launches["program"]["K3"],
                            "per": "the flagship int8 program served over HTTP"},
                "rows": [{k: d[k] for k in ("shape", "per_call", "max_abs_err",
                                            "max_abs_err_library", "ms", "device_ms",
                                            "pack_device_ms", "plain_ms", "bound_ms",
                                            "bound_share", "library_ms", "library_device_ms",
                                            "library_benchmark_ms", "library_benchmark_device_ms",
                                            "host_us")} for d in k3]})
    return {"kernels": out, "build_s": build_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available; this smoke run needs one.", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--ddp-worker"]:  # the ddp phase's child: OUT -- train_sr's args
        return ddp_worker(sys.argv[2], sys.argv[4:])
    if sys.argv[1:2] == ["--ranks-worker"]:  # the ddp_ranks phase's: RANK WORLD RDV IN OUT
        rank, world, rdv, inp, out = sys.argv[2:7]
        return ranks_worker(int(rank), int(world), rdv, inp, out)
    if sys.argv[1:2] == ["--space-worker"]:  # the space_ranks phase's: RANK WORLD RDV IN OUT
        rank, world, rdv, inp, out = sys.argv[2:7]
        return space_worker(int(rank), int(world), rdv, inp, out)
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
    k2_bwd_spills = check_k2_bwd_spills(_build.last_build["log"])
    k3_spills = check_k3_spills(_build.last_build["log"])

    ident = gpu_identity().splitlines()[0]
    log(f"[gpu] {ident}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def phase(name, fn, *args):
        probes.append(host_probe(name))
        return fn(*args)

    gen = torch.Generator("cuda").manual_seed(0)
    details = (phase("k1", check_k1, gen) + phase("k2", check_k2, gen)
               + phase("k3", check_k3, gen) + phase("k2_halo", check_k2_halo, gen))
    grads = phase("grads", check_backward, gen)
    details += phase("k1_bwd", check_k1_backward, gen)
    details += phase("k2_bwd", check_k2_backward, gen)
    resized = phase("resize", check_resize, gen)
    torch.cuda.empty_cache()

    call, _ = load_artifact(ARTIFACT, device="cuda")
    served = phase("serve", serve_flagship, call)
    scores = phase("golden", golden, call)
    programmed = phase("program", flagship_program, call, ident)
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
        captured = phase("graph", graph_capture, ident)
        step_graphs = phase("step_graph", step_graph, Path(tmp), ident)
        joint_step = phase("joint_f32_step", joint_card_vs_cpu_step)
        joint_cli = phase("joint_cli", joint_entry_points, Path(tmp),
                          seg_cli["protocol"].pop("ckpt_dir"))
        tuned = phase("tune", tune, Path(tmp), ident)
        torch.cuda.empty_cache()
        dp = phase("ddp", ddp, Path(tmp), ident)
        dp_ranks = phase("ddp_ranks", ddp_ranks, Path(tmp))
        swept = phase("sweep", sweep, Path(tmp), ident)
        space = phase("space_ranks", space_ranks, Path(tmp), ident)

    seconds = time.perf_counter() - t_start
    summary = {"gpu": ident, "details": details, "grads": grads, "resize": resized,
               "serve": served,
               "golden": scores, "program": programmed, "speed": speed, "train": trained, "f32_step": step_check,
               "train_sr": entry, "seg_train": seg, "seg_f32_step": seg_step,
               "seg_cli": seg_cli, "streamed": streamed, "deep": deep, "vanilla_sr": vanilla,
               "vanilla_sr_f32_step": vanilla_step, "sr_cli": sr_cli, "joint": joint,
               "graph": captured, "step_graph": step_graphs, "joint_f32_step": joint_step, "joint_cli": joint_cli,
               "tune": tuned,
               "ddp": dp, "ddp_ranks": dp_ranks, "sweep": swept, "space_ranks": space,
               "seconds": seconds,
               "k1_bwd_ptxas": spills, "k2_bwd_ptxas": k2_bwd_spills, "k3_ptxas": k3_spills,
               "host_probes": probes}
    log("[detail] " + json.dumps(summary))
    log(f"[time] {ident}: every phase passed in {seconds:.1f} s of wall time (build included)")
    seg_launches = {k: seg[f"{k}_bfloat16"]["launches"] for k in ("protocol", "vanilla")}
    sr_launches = {"streamed": streamed["launches"], "vanilla_sr": vanilla["launches"],
                   "program": programmed["launches"],
                   "joint": joint["launches"], "joint_served": joint_cli["served_launches"],
                   "tune": tuned["launches"], "ddp": dp["launches"], "sweep": swept["launches"],
                   "graph": captured["launches"],
                   "space": {case: v["launches_per_rank"][0][4] for case, v in space.items()
                             if case != "seconds"},
                   "space_bwd": {case: v["launches_per_rank"][0][5] for case, v in space.items()
                                 if case != "seconds"},
                   "deep": {kid: {k: deep[k]["launches"][kid] for k in ("remat_0", "remat_2")}
                            for kid in COUNTED}}
    line = kernels_line(details, grads, trained["launches"], served["launches"], seg_launches,
                        sr_launches, build_s)
    line["kernels"].append(resize_entry(resized, {
        "train": trained["launches"]["R"], "serve": served["launches"]["R"],
        "program": programmed["launches"]["R"],
        "deep": {k: deep[k]["launches"]["R"] for k in ("remat_0", "remat_2")},
        "step_graph": {k: v["resize_launches_per_step"] for k, v in step_graphs.items()}}))
    print(json.dumps(line))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
