#!/usr/bin/env python3
"""Where the streamed flagship step waits for its host feed, on a CUDA GPU.

Writes a synthetic corpus (``scripts/make_synth_corpus.py::synth_image``,
ten 512-px uint8 ``.npy`` images, seed 8) and streams it as ``train_sr
--uint8_feed --cache_decoded`` does: ``TrainingPatchDataset`` (a producer
thread: random crops, a 1,024-patch shuffle buffer, batches of 32 x 256 px
uint8) through ``device_feed`` (a pinned copy one batch ahead on a side
stream) into the bf16 flagship's train step (scale 0.5, depth 3, base 64).
It measures, in turns on one card:

- the producer alone: batches per second pulled from the dataset with no
  step running;
- the streamed step: ms/step over ``--steps`` steps (host clock, ending in
  a synchronise) and the host's wait for the next batch per step;
- the device-cache step over the same corpus, the same way;
- the streamed step again with the interpreter's thread switch interval at
  0.5 ms instead of the default 5 ms (``sys.setswitchinterval``, restored
  after): a diagnostic of whether the producer thread waits for the
  interpreter lock that the main thread's eager dispatch holds;
- the streamed step once more after a float32 train step of the same model
  on the CPU (batch 1, as ``chip_smoke.py``'s card-vs-CPU phase runs one
  before its streamed phase): a diagnostic of whether CPU work earlier in
  the process slows the feed.

It prints each number beside the card's name and power limit, and with
``--json PATH`` writes them as JSON. Run from the repository root on a
machine with a GPU:

    python3 scripts/torch_profile_feed.py [--steps 30] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from make_synth_corpus import synth_image  # noqa: E402

from adunet_torch.data import device_feed, load_device_cache, make_training_patch_dataset  # noqa: E402
from adunet_torch.losses import charbonnier_loss  # noqa: E402
from adunet_torch.models import build_super_resolution_unet  # noqa: E402
from adunet_torch.train import (  # noqa: E402
    create_train_state,
    make_optimizer,
    make_sr_device_cache_train_step,
    make_sr_train_step,
)
from adunet_torch.utils import gpu_identity, setup_runtime  # noqa: E402

BATCH, PATCH = 32, 256


def _corpus(directory: Path) -> list[str]:
    rng = np.random.default_rng(8)
    paths = []
    for i in range(10):
        path = directory / f"synth{i:03d}.npy"
        np.save(path, np.round(synth_image(rng, 512) * 255).astype(np.uint8))
        paths.append(str(path))
    return paths


def _dataset(paths):
    ds, _ = make_training_patch_dataset(paths, patch_size=PATCH, patches_per_image=8, scale=0.5,
                                        batch_size=BATCH, seed=3, output_dtype="uint8",
                                        cache_decoded=True)
    return ds


def producer_rate(paths, n: int) -> float:
    """Batches per second from the dataset alone, after 5 to fill the buffer."""
    it = iter(_dataset(paths))
    for _ in range(5):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    rate = n / (time.perf_counter() - t0)
    it.close()
    return rate


def streamed(state, step, paths, n: int) -> dict:
    """ms/step and the host's wait for the next batch per step."""
    feed = device_feed(_dataset(paths), "cuda")
    waited = 0.0
    for i in range(n + 3):  # 3 warm-up steps
        if i == 3:
            torch.cuda.synchronize()
            t0, waited = time.perf_counter(), 0.0
        t = time.perf_counter()
        batch = next(feed)
        waited += time.perf_counter() - t
        step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    feed.close()
    return {"ms_per_step": ms, "wait_ms_per_step": waited / n * 1e3}


def cached(state, step, gen, n: int) -> float:
    for _ in range(3):
        step(state, None, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, None, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--json", type=str, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_feed: needs a CUDA GPU", file=sys.stderr)
        return 2
    setup_runtime()
    ident = gpu_identity().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="feed_") as tmp:
        paths = _corpus(Path(tmp))
        model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=torch.bfloat16,
                                               device="cuda", seed=0)
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        step = make_sr_train_step(model, charbonnier_loss)
        cache_step = make_sr_device_cache_train_step(
            model, charbonnier_loss, load_device_cache(paths, "cuda"), patch_size=PATCH,
            batch_size=BATCH)
        gen = torch.Generator("cuda").manual_seed(0)
        out = {"gpu": ident, "batch": BATCH, "patch": PATCH, "steps": args.steps,
               "producer_batches_per_s": producer_rate(paths, 3 * args.steps),
               "streamed": [streamed(state, step, paths, args.steps)],
               "device_cache_ms_per_step": [cached(state, cache_step, gen, args.steps)]}
        default = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        try:
            out["streamed_switch_0.5ms"] = streamed(state, step, paths, args.steps)
        finally:
            sys.setswitchinterval(default)
        out["device_cache_ms_per_step"].append(cached(state, cache_step, gen, args.steps))
        out["streamed"].append(streamed(state, step, paths, args.steps))
        cpu_model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cpu", seed=0)
        cpu_state = create_train_state(cpu_model, make_optimizer(cpu_model.parameters(), 1e-4))
        hr = np.round(synth_image(np.random.default_rng(21), 256)[None] * 255).astype(np.uint8)
        make_sr_train_step(cpu_model, charbonnier_loss)(cpu_state, hr)
        out["cpu_threads"] = torch.get_num_threads()
        out["streamed_after_cpu_step"] = streamed(state, step, paths, args.steps)
        out["device_cache_ms_per_step"].append(cached(state, cache_step, gen, args.steps))
    s, c = out["streamed"], out["device_cache_ms_per_step"]
    fast = out["streamed_switch_0.5ms"]
    print(f"[feed] {ident}: producer alone {out['producer_batches_per_s']:.1f} batches/s "
          f"({1e3 / out['producer_batches_per_s']:.2f} ms per batch of {BATCH} x {PATCH} px uint8)")
    print(f"[feed] {ident}: streamed step {s[0]['ms_per_step']:.3f} / {s[1]['ms_per_step']:.3f} "
          f"ms/step (host waits {s[0]['wait_ms_per_step']:.3f} / {s[1]['wait_ms_per_step']:.3f} "
          f"ms/step for the next batch); device-cache step {c[0]:.3f} / {c[1]:.3f} ms/step; "
          f"streamed with a 0.5 ms switch interval {fast['ms_per_step']:.3f} ms/step (waits "
          f"{fast['wait_ms_per_step']:.3f} ms/step)")
    after = out["streamed_after_cpu_step"]
    print(f"[feed] {ident}: after a float32 CPU train step ({out['cpu_threads']} CPU threads): "
          f"streamed {after['ms_per_step']:.3f} ms/step (waits {after['wait_ms_per_step']:.3f} "
          f"ms/step), device-cache {c[2]:.3f} ms/step")
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
