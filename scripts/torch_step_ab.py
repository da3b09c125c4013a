#!/usr/bin/env python3
"""The bf16 flagship and deep-config train steps of one checkout, timed on a
CUDA GPU by that checkout's own ``chip_smoke.py`` phases.

``--root`` names the checkout (default: the one this script lies in). Its
``chip_smoke.train_flagship`` runs the flagship's device-cache steps at batch
32 x 256 px (launches and a falling loss checked, CUDA events over 5 steps)
and its ``chip_smoke.deep_config`` the deep config (scale 0.8, depth 5,
batch 8) without and with ``remat_levels 2``; the kernels are built into the
checkout's own ``build/``. To compare two commits on one card, run this for
each in turns in one call, e.g. for a ``git archive`` of the parent commit
unpacked under ``build/parent``:

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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose steps are timed")
    ap.add_argument("--json", default=None, help="append the times to a JSON list in this file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # that checkout's adunet_torch, before any other
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not Path(cs.fused_norm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {cs.fused_norm.__file__}, not {root}'s adunet_torch")
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_ab: needs a CUDA GPU")
    cs.setup_runtime()
    ident = cs.gpu_identity().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="step_ab_") as tmp:
        flagship = cs.train_flagship(Path(tmp), ident)  # writes the corpus deep_config reads
        deep = cs.deep_config(Path(tmp), ident)
    times = {"root": str(root), "flagship_ms": flagship["ms_per_step"],
             "deep_ms": deep["remat_0"]["ms_per_step"],
             "deep_remat2_ms": deep["remat_2"]["ms_per_step"]}
    cs.log(f"[step ab] {ident} {root.name}: flagship {times['flagship_ms']:.3f} ms/step, deep "
           f"{times['deep_ms']:.3f}, deep remat_levels 2 {times['deep_remat2_ms']:.3f}")
    if args.json:
        path = Path(args.json)
        prior = json.loads(path.read_text()) if path.exists() else []
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(prior + [{"gpu": ident, **times}]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
