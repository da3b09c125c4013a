#!/usr/bin/env python3
"""K2's bf16 kernels of one checkout at the shapes its paths give them:
the profiler's device time of a forward call and of a backward call, each
split by device kernel (the weight pack, the conv, the dw + db partials,
their sum), on a CUDA GPU.

``ROOT`` (default: the checkout this script lies in) names the checkout
whose ``adunet_torch`` runs; its kernels are built into its own
``build/``. Inputs and timing come from this script's own
``chip_smoke.py``. To compare designs, run it once for each checkout (they
differ in ``adunet_torch/csrc/conv64.cu``), in turns, in one call on one
card:

    for r in build/a build/b build/b build/a; do python3 scripts/torch_k2_parts.py $r; done

Each line names the card and its power limit.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = [((32, 256, 256, 64), 0), ((8, 256, 256, 64), 0), ((8, 128, 128, 64), 0),
          ((32, 130, 256, 64), 1), ((8, 130, 256, 64), 1)]


def _short(by_name: dict | None) -> dict:
    """Kernel name (its function name, template argument kept) -> ms."""
    out = {}
    for name, ms in (by_name or {}).items():
        m = re.search(r"(\w+_kernel(<\w+>)?)", name)
        out[m.group(1) if m else name[:40]] = round(ms, 4)
    return out


def run(root: Path) -> None:
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adunet_torch.kernels import conv64

    if not Path(conv64.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {conv64.__file__}, not {root}'s adunet_torch")
    cs.setup_runtime()
    ident = cs.gpu_identity().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    for shape, halo in SHAPES:
        x, w, b = cs._k2_inputs(gen, shape, torch.bfloat16)
        g = torch.randn(shape[0], shape[1] - 2 * halo, *shape[2:], generator=gen,
                        device="cuda").to(torch.bfloat16)
        conv = conv64.conv3x3_rows if halo else conv64.conv3x3_same

        def fwd():
            return conv(x, w, b)

        def bwd():
            return conv64.conv3x3_same_backward(x, w, g, bias_dtype=torch.float32, pad_h=1 - halo)

        tf, tb = {}, {}
        f_ms, _ = cs.profiled_device_ms(fwd, None, totals=tf)
        b_ms, _ = cs.profiled_device_ms(bwd, None, totals=tb)
        print(f"[k2 parts] {ident} {root.name or root}: x={'x'.join(map(str, shape))} "
              f"halo={halo}: forward {cs._ms(f_ms)} {_short(tf['by_name'])}; backward "
              f"{cs._ms(b_ms)} {_short(tb['by_name'])}", flush=True)
        del x, g
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_k2_parts: needs a CUDA GPU", file=sys.stderr)
        return 2
    run(Path(argv[0] if argv else HERE).resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
