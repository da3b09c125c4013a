#!/usr/bin/env python3
"""Measure the sweeps' per-scale batch table on one CUDA GPU.

For every scale of the experiment sweeps (``adunet_torch.experiments``) this
times the bf16 SR training step the sweeps' plans run (``train_sr
--mixed_precision``, ``--remat`` at depth >= 4, 256-px patches, Charbonnier,
Adam 1e-4; the device-cache step on 16 synthetic 512-px images) at the JAX
package's v5e batch for that scale and at twice it, in every configuration
the two sweeps run at that scale: the fixed-depth sweep's depth 3 and the
adaptive sweep's depth from its design table. For each it reads the peak
device memory (``torch.cuda.max_memory_allocated``) and img/s (CUDA events
over 5 steps after 2 warm-up steps). A batch that does not fit is recorded as
out of memory. The larger batch is chosen for a scale only where it stays
under 64 GB and gains over 10 % img/s in every configuration of that scale.

    python3 scripts/torch_sweep_batches.py [--json chiprun_out/sweep_batches.json]

Prints one line per measurement, the chosen table, and the card's name and
power limit. Needs a CUDA GPU.
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

from adunet_torch.experiments import EXPERIMENT1_SCALES, EXPERIMENT2_DEPTHS  # noqa: E402
from adunet_torch.utils import gpu_identity, setup_runtime  # noqa: E402

# the JAX package's v5e table (adunet/experiments/sweeps.py:47-48): where each scale starts
V5E_BATCHES = {0.2: 64, 0.3: 64, 0.4: 32, 0.5: 32, 0.6: 16, 0.7: 8, 0.8: 8, 0.9: 32}
LIMIT_GB, MIN_GAIN = 64.0, 0.10
PATCH, WARMUP, TIMED = 256, 2, 5


def corpus(n: int = 16, size: int = 512, seed: int = 5) -> torch.Tensor:
    """(n, size, size, 3) uint8 synthetic images on the card."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_synth_corpus import synth_image

    rng = np.random.default_rng(seed)
    images = [np.round(synth_image(rng, size) * 255).astype(np.uint8) for _ in range(n)]
    return torch.from_numpy(np.stack(images)).to("cuda")


def measure(images: torch.Tensor, scale: float, depth: int, batch: int) -> dict:
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import create_train_state, make_optimizer, make_sr_device_cache_train_step

    remat = depth >= 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, _ = build_super_resolution_unet(scale, depth_override=depth, max_depth=depth,
                                           dtype=torch.bfloat16, remat=remat, device="cuda")
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_sr_device_cache_train_step(model, charbonnier_loss, images, patch_size=PATCH,
                                           batch_size=batch)
    gen = torch.Generator("cuda").manual_seed(0)
    out = {"scale": scale, "depth": depth, "remat": remat, "batch": batch,
           "params": sum(p.numel() for p in model.parameters())}
    try:
        for _ in range(WARMUP):
            step(state, None, gen)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED):
            _, metrics = step(state, None, gen)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / TIMED
        if not bool(torch.isfinite(metrics["loss"])):
            raise AssertionError(f"non-finite loss at {out}")
        out.update(ms_per_step=ms, img_per_s=batch * 1e3 / ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    except torch.cuda.OutOfMemoryError:
        out.update(ms_per_step=None, img_per_s=None, peak_gb=None, out_of_memory=True)
    del state, model, step
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None, help="write the measurements here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_batches: needs a CUDA GPU", file=sys.stderr)
        return 2
    setup_runtime()
    ident = gpu_identity().splitlines()[0]
    images = corpus()
    rows, table = [], {}
    for scale in EXPERIMENT1_SCALES:
        depths = sorted({3, EXPERIMENT2_DEPTHS.get(scale, 3)})
        base = V5E_BATCHES[scale]
        pairs = []
        for depth in depths:
            small, large = measure(images, scale, depth, base), measure(images, scale, depth,
                                                                          2 * base)
            for r in (small, large):
                rows.append(r)
                print(json.dumps(r), flush=True)
            pairs.append((small, large))
        take = all(
            s.get("img_per_s") and l.get("img_per_s") and l["peak_gb"] < LIMIT_GB
            and l["img_per_s"] > (1 + MIN_GAIN) * s["img_per_s"] for s, l in pairs)
        table[scale] = 2 * base if take else base
    print(f"[sweep batches] {ident}: H100_BATCH_SIZES = {json.dumps(table)}")
    print(ident)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"gpu": ident, "rows": rows, "table": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
