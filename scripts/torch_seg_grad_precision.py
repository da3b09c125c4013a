#!/usr/bin/env python3
"""How precise float32 gradients of the segmentation protocol model can be.

Runs one training-mode forward and backward of the port's protocol U-Net
(BatchNorm, base 64, depth 4; protocol A's hybrid loss) on the CPU in
float32 and in float64, from the same weights and synthetic lesion batch
(``scripts/make_synth_isic.py``), and prints, per parameter, the relative L2
norm of the float32 gradient's error against float64. This is the floor any
float32 comparison of two implementations of the step (the card against
the CPU in ``chip_smoke.py``) must allow for: BatchNorm's backward subtracts
per-channel means of the cotangent, and where they nearly cancel the
difference keeps the rounding of the sums. The biases of convs that feed a
BatchNorm have a true gradient of 0 and are listed apart, against the
largest gradient norm.

    python3 scripts/torch_seg_grad_precision.py [--size 128] [--batch 2] [--json PATH]

CPU only; at --size 256 it takes a few GB and tens of seconds.
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

from adunet_torch.losses import make_hybrid_ce_dice_loss  # noqa: E402
from adunet_torch.models import build_adaptive_depth_unet  # noqa: E402
from make_synth_isic import synth_pair  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--json", type=str, default=None)
    args = parser.parse_args()

    rng = np.random.default_rng(41)
    pairs = [synth_pair(rng, args.size) for _ in range(args.batch)]
    images = torch.from_numpy(np.stack([p[0] for p in pairs]))
    masks = torch.from_numpy(np.stack([p[1] for p in pairs])[..., None])
    loss_fn = make_hybrid_ce_dice_loss(0.4, 0.6)
    m32 = build_adaptive_depth_unet(args.size, 64, 4, device="cpu", seed=3)
    m64 = build_adaptive_depth_unet(args.size, 64, 4, device="cpu", seed=3,
                                    dtype=torch.float64).double()
    m64.load_state_dict({k: v.double() for k, v in m32.state_dict().items()})
    grads = {}
    for name, model, dtype in (("f32", m32, torch.float32), ("f64", m64, torch.float64)):
        model.train()
        loss_fn(masks.to(dtype), model(images.to(dtype))).backward()
        grads[name] = {n: p.grad.double() for n, p in model.named_parameters()}

    pre_bn = {n.replace("norm", "conv").replace("running_mean", "bias")
              for n, _ in m32.named_buffers() if n.endswith("running_mean")}
    top = max(float(g.norm()) for g in grads["f64"].values())
    rel = {n: float((grads["f32"][n] - g).norm() / g.norm().clamp_min(1e-300))
           for n, g in grads["f64"].items() if n not in pre_bn}
    bias = {n: float(grads["f32"][n].norm()) / top for n in pre_bn}
    worst = sorted(rel, key=rel.get, reverse=True)[:8]
    print(f"protocol model, batch {args.batch} x {args.size} px, CPU: float32 vs float64 gradients")
    for n in worst:
        print(f"  rel L2 {rel[n]:.2e}  {n}")
    print(f"  median rel L2 over {len(rel)} parameters {np.median(list(rel.values())):.2e}")
    print(f"  pre-BatchNorm conv biases (true gradient 0): largest float32 norm "
          f"{max(bias.values()):.2e} of the largest gradient norm")
    if args.json:
        Path(args.json).write_text(json.dumps({"size": args.size, "batch": args.batch,
                                               "rel_l2": rel, "pre_bn_bias_of_top": bias}))


if __name__ == "__main__":
    main()
