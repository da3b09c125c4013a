#!/usr/bin/env python3
"""The bf16 flagship, deep-config, joint and vanilla-seg train steps of one
checkout, timed on a CUDA GPU with their device idle shares.

``--root`` names the checkout (default: the one this script lies in); its
``adunet_torch`` builds and runs the steps, its kernels built into its own
``build/``. The set-up, the seeded data and the timing come from this
script's own ``chip_smoke.py`` (as its phases do them), so two checkouts
are timed on the same inputs in the same way:

- the flagship (scale 0.5, depth 3) from a device cache at batch 32 x 256
  px, with the device time of every copy kernel in one profiled step (a
  float32 copy of K2's cotangent shows there as four launches) and the
  step's ``aten::convolution_backward`` calls (K2's four run the port's
  backward kernels where the checkout has them, cuDNN's otherwise);
- the deep config (scale 0.8, depth 5) at batch 8, without remat;
- the joint SR + segmentation U-Net at ``train_joint``'s defaults, batch 8;
- the vanilla segmentation U-Net (base 32, depth 4) with flips, batch 8.

Each step's launches a step (K1 / K1 backward / K2 / K2 backward, as
``PERF.md`` lists them; a checkout without K2's backward kernels counts
none of those) are checked, then it is timed in ROUNDS rounds of 5 steps (CUDA
events; the median and the least round are kept: a step the host paces
moves with the host's other load) and its idle share read under the
profiler over 3 steps. ``--cells`` picks some of the four. To compare two commits on
one card, run this for each in turns in one call, e.g. for a ``git
archive`` of the parent commit unpacked under ``build/parent``:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_step_ab.py --root $r --json build/ab/steps.json
    done

Each line printed names the card and its power limit; ``--json PATH``
appends the run's times to a JSON list there.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
STEPS, TIMED, ROUNDS, IDLE_STEPS = 3, 5, 7, 3
CELLS = ("flagship", "deep", "joint", "vanilla_seg")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose steps are timed")
    ap.add_argument("--json", default=None, help="append the times to a JSON list in this file")
    ap.add_argument("--cells", default=",".join(CELLS), help="comma-separated: " + ", ".join(CELLS))
    args = ap.parse_args(argv)
    chosen = args.cells.split(",")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # that checkout's adunet_torch, before any other
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from adunet_torch.data import load_device_cache
    from adunet_torch.kernels import conv64
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_joint_unet, build_super_resolution_unet
    from adunet_torch.train import (create_train_state, make_joint_train_step, make_optimizer,
                                    make_seg_train_step, make_sr_device_cache_train_step)

    if not Path(cs.fused_norm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {cs.fused_norm.__file__}, not {root}'s adunet_torch")
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_ab: needs a CUDA GPU")
    cs.setup_runtime()
    ident = cs.gpu_identity().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    # a checkout before K2's backward kernels: its backward is cuDNN's, uncounted
    k2_bwd_kernels = hasattr(conv64, "conv3x3_same_backward_plain")

    def sr_step(cache, scale, depth, batch):
        model, _ = build_super_resolution_unet(scale, depth_override=depth, dtype=torch.bfloat16,
                                               device="cuda", seed=0)
        cs._random_head(model)
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        step = make_sr_device_cache_train_step(model, charbonnier_loss, cache, patch_size=256,
                                               batch_size=batch)
        return lambda: step(state, None, gen)

    def joint_step():
        batches = cs._joint_batches(2, cs.JOINT_BATCH, seed=61)
        model, _ = build_joint_unet(0.5, dtype=torch.bfloat16, device="cuda", seed=0)
        cs._random_head(model)
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        step = make_joint_train_step(model, *cs._joint_losses(), data_scale=0.5)
        return lambda: step(state, batches[0])

    def seg_step():
        images, masks = cs.seg_pairs(cs.SEG_BATCH, cs.SEG_SIZE, seed=31)
        batch = (torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda())
        model, loss_fn, augment, extra = cs._seg_setup("vanilla", torch.bfloat16, "cuda")
        state = create_train_state(model, make_optimizer(model.parameters(), cs.SEG_LR))
        step = make_seg_train_step(model, loss_fn, augment=augment, extra_metrics=extra)
        return lambda: step(state, batch, gen)

    out = {"root": str(root)}
    with tempfile.TemporaryDirectory(prefix="step_ab_") as tmp:
        cache = load_device_cache(cs.write_corpus(Path(tmp), 16, 512, seed=5), "cuda")
        cells = {"flagship": (lambda: sr_step(cache, 0.5, 3, cs.TRAIN_BATCH), cs.STREAM_PER_STEP),
                 "deep": (lambda: sr_step(cache, cs.DEEP_SCALE, cs.DEEP_DEPTH, cs.DEEP_BATCH),
                          cs.DEEP_PER_STEP[None]),
                 "joint": (joint_step, cs.JOINT_PER_STEP),
                 "vanilla_seg": (seg_step, cs.SEG_PER_STEP["vanilla"])}
        for name, (make, per_step) in cells.items():
            if name not in chosen:
                continue
            step = make()
            cs._zero_counts()
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
            counts = cs._counts()
            if not k2_bwd_kernels:
                per_step = (*per_step[:3], 0)
            if counts != tuple(n * STEPS for n in per_step):
                raise AssertionError(f"{name}: {counts} K1 / K1 backward / K2 / K2 backward "
                                     f"launches over {STEPS} steps, expected {per_step} a step")
            rounds = sorted(cs.cuda_ms(step, TIMED) for _ in range(ROUNDS))
            ms = rounds[ROUNDS // 2]
            idle = cs.device_idle(step, IDLE_STEPS)
            cell = {"ms_per_step": ms, "least_round_ms": rounds[0], "rounds_ms": rounds,
                    "idle_share": idle["idle_share"], "per_step": list(per_step)}
            if name == "flagship":  # copy kernels of one step, by name: device ms
                totals = {}
                cs.profiled_device_ms(step, iters=1, totals=totals)
                cell["copy_kernels_ms"] = {k: v for k, v in (totals["by_name"] or {}).items()
                                           if "copy" in k.lower()}
                cell["copy_ms"] = sum(cell["copy_kernels_ms"].values())
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                    step()
                    torch.cuda.synchronize()
                cell["convolution_backward_calls"] = sum(
                    e.count for e in prof.key_averages() if e.key == "aten::convolution_backward")
            out[name] = cell
            idle_s = "not measured" if idle["idle_share"] is None else f"{idle['idle_share']:.2%}"
            cs.log(f"[step ab] {ident} {root.name}: {name} {ms:.3f} ms/step (median of {ROUNDS} "
                   f"rounds; least {rounds[0]:.3f}), device idle {idle_s}"
                   + (f", copy kernels {cell['copy_ms']:.3f} ms of device time, "
                      f"{cell['convolution_backward_calls']} aten::convolution_backward calls"
                      if "copy_ms" in cell else ""))
            del step
            torch.cuda.empty_cache()
    if args.json:
        path = Path(args.json)
        prior = json.loads(path.read_text()) if path.exists() else []
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(prior + [{"gpu": ident, **out}]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
