#!/usr/bin/env python3
"""K1, K1's backward, K2, K2's halo-row mode and K2's backward of one
checkout, called as its model calls them, on a CUDA GPU at every shape
``chip_smoke.py`` holds them: what a call costs the host and the card, and
fingerprints of what it computes, so that two checkouts can be compared on
one card.

``--root`` names the checkout whose ``adunet_torch`` runs (default: the one
this script lies in); its kernels are built into its own ``build/``. The
shapes and the seeded inputs come from this script's own ``chip_smoke.py``
(each row's inputs from a generator seeded by the row's index), and so does
the timing. K1 and K2 are called through the checkout's ``nn.blocks``
modules (``LayerNormReLU``; ``Conv`` with float32 parameters, the halo-row
mode through a stand-in space shard), so each checkout pays what its model
pays: a checkout whose ``Conv`` casts the parameters before the call pays
the casts. K1's backward is ``fused_norm._launch_backward``, K2's
``conv64.conv3x3_same_backward`` (dx, dw and db, float32 parameters, both
modes; a checkout without K2's backward kernels runs cuDNN there). For each
row:

- ``ms``: CUDA events over back-to-back calls with no gradient wanted (the
  serving path), and ``fwd_bwd_ms`` over forward + backward through the
  autograd Function (the training path; K1 rows and K2 rows);
- ``device_ms``: the profiler's device time of the kernel a call, and
  ``device_kernels_per_call`` (every kernel name);
- ``host_us``: the median over 5 runs of the wall time a call of 20
  back-to-back calls, each run from an idle device to one synchronize;
- ``library_ms`` / ``library_device_ms``: ``F.layer_norm`` + ``relu`` or
  cuDNN's ``F.conv2d`` (parameters cast beforehand, not timed), as in
  ``chip_smoke.py``;
- ``sha256``: of the output, and of each gradient of K1's Function path
  and K1's backward;
- ``grad_stats``: for K2's gradients (its Function path and its backward,
  whose sums two checkouts may take in other orders), each gradient's L2
  norm and a projection on seeded random signs, compared between the roots
  relative to the norm (bf16 1e-2, float32 1e-4).

To compare a ``git archive`` of the parent commit unpacked under
``build/parent`` with this checkout, in one call on one card:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_launch_ab.py --root $r --json build/ab/launch_ab.json
    done
    python3 scripts/torch_launch_ab.py --compare build/ab/launch_ab.json

``--compare`` prints each row's parent and change values (the mean of each
root's runs) and exits non-zero if an output or K1 gradient of one root
differs from the other's, or a K2 gradient's statistics past the tolerance.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sha(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def stats(t: torch.Tensor) -> list[float]:
    """A gradient's L2 norm and its projection on seeded random signs (a
    2^20-long sign vector, tiled), in float64."""
    v = t.detach().reshape(-1).double()
    n = 1 << 20
    signs = (torch.randint(0, 2, (n,), generator=torch.Generator(t.device).manual_seed(5),
                           device=t.device) * 2 - 1).double()
    pad = (-v.numel()) % n
    tiled = torch.nn.functional.pad(v, (0, pad)).view(-1, n) if v.numel() > n else v[None]
    proj = (tiled * signs[: tiled.shape[1]]).sum()
    return [float(v.norm()), float(proj)]


class _Halo:
    """A stand-in space shard: ``halo`` returns the input with its neighbour
    rows already in place."""

    def __init__(self, xp):
        self.xp = xp

    def halo(self, x, n):
        return self.xp


def run(root: Path, kinds: set[str] | None = None) -> list[dict]:
    sys.path.insert(0, str(root))  # that checkout's adunet_torch, before any other
    cs = _load_chip_smoke()

    import torch.nn.functional as F

    from adunet_torch.kernels import fused_norm
    from adunet_torch.nn import blocks

    if not Path(fused_norm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {fused_norm.__file__}, not {root}'s adunet_torch")
    if not torch.cuda.is_available():
        raise SystemExit("torch_launch_ab: needs a CUDA GPU")
    cs.setup_runtime()
    ident = cs.gpu_identity().splitlines()[0]
    rows_out = []

    def cost(fn, kernel_name, per_run=1):
        totals = {}
        dev_ms, _ = cs.profiled_device_ms(fn, kernel_name, per_run=per_run, totals=totals)
        return {"device_ms": dev_ms, "device_kernels_per_call": totals["kernels_per_run"],
                "host_us": cs.host_us(fn)}

    cases = ([("K1", c) for c in cs._k1_cases()] + [("K1_bwd", c) for c in cs._k1_bwd_cases()]
             + [("K2", c) for c in cs._k2_cases()]
             + [("K2_halo", (shape, n, dtype, "space")) for shape, n, dtype in cs.K2_HALO_CASES]
             + [("K2_bwd_halo" if halo else "K2_bwd", (shape, n, dtype, path))
                for shape, n, dtype, path, halo in cs._k2_bwd_cases()])
    for i, (kind, (shape, _, dtype, path)) in enumerate(cases):
        if kinds is not None and kind not in kinds:
            continue
        gen = torch.Generator("cuda").manual_seed(1000 + i)
        row = {"root": str(root), "kernel": kind, "path": path, "shape": list(shape),
               "dtype": cs._dname(dtype)}
        if kind in ("K1", "K1_bwd"):
            rows, c = shape
            x, a, b = cs._k1_inputs(gen, rows, c, dtype)
            gy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
            if kind == "K1":
                mod = blocks.LayerNormReLU(c, device="cuda")
                with torch.no_grad():
                    mod.weight.copy_(a)
                    mod.bias.copy_(b)

                def call():
                    with torch.no_grad():
                        return mod(x)

                row.update(sha256=sha(call()), ms=cs.cuda_ms(call, 50),
                           **cost(call, "layer_norm_relu_kernel"))
                xg = x.clone().requires_grad_(True)

                def fwd_bwd():
                    return torch.autograd.grad(mod(xg), [xg, mod.weight, mod.bias], gy)

                row["grad_sha256"] = [sha(t) for t in fwd_bwd()]
                row["fwd_bwd_ms"] = cs.cuda_ms(fwd_bwd, 20)
                gl, bl = a.to(dtype), b.to(dtype)
                lib = lambda: F.relu(F.layer_norm(x, (c,), gl, bl, 1e-3))  # noqa: E731
            else:
                def call():
                    return fused_norm._launch_backward(x, a, b, gy, 1e-3)

                row.update(grad_sha256=[sha(t) for t in call()], ms=cs.cuda_ms(call, 20),
                           **cost(call, cs.K1_BWD_KERNEL, per_run=2))
                xl = x.detach().requires_grad_(True)
                al, bl = (t.to(dtype).requires_grad_(True) for t in (a, b))
                yl = F.relu(F.layer_norm(xl, (c,), al, bl, 1e-3))
                lib = lambda: torch.autograd.grad(yl, [xl, al, bl], gy, retain_graph=True)  # noqa: E731
        elif kind in ("K2_bwd", "K2_bwd_halo"):
            from adunet_torch.kernels import conv64

            pad_h = 0 if kind == "K2_bwd_halo" else 1
            x, wt, _ = cs._k2_inputs(gen, shape, dtype)
            gy = torch.randn(shape[0], shape[1] - 2 + 2 * pad_h, *shape[2:], generator=gen,
                             device="cuda").to(dtype)

            def call():
                return conv64.conv3x3_same_backward(x, wt, gy, bias_dtype=torch.float32,
                                                    pad_h=pad_h)

            with cs.deterministic_cudnn():
                row.update(grad_stats=[stats(t) for t in call()], ms=cs.cuda_ms(call, 20),
                           **cost(call, None))
            lib = lambda: cs.k2_library_backward(x, wt, gy, pad_h)  # noqa: E731
        else:
            halo = kind == "K2_halo"
            x, wt, bias = cs._k2_inputs(gen, shape, dtype)
            bsz, h, wd, _ = shape
            out_shape = (bsz, h - 2 if halo else h, wd, 64)
            gy = torch.randn(*out_shape, generator=gen, device="cuda").to(dtype)
            mod = blocks.Conv(64, 64, 3, device="cuda")
            with torch.no_grad():
                mod.weight.copy_(wt)
                mod.bias.copy_(bias)

            def forward(inp):
                if halo:  # Conv reads the shard's own rows' shape; the halo comes from space
                    mod.space = _Halo(inp)
                    return mod(inp[:, 1:-1])
                return mod(inp)

            def call():
                with torch.no_grad():
                    return forward(x)

            name = cs.K2_KERNEL[dtype]
            row.update(sha256=sha(call()), ms=cs.cuda_ms(call, 20), **cost(call, name))
            xg = x.clone().requires_grad_(True)

            def fwd_bwd():
                return torch.autograd.grad(forward(xg), [xg, mod.weight, mod.bias], gy)

            with cs.deterministic_cudnn():
                row["grad_stats"] = [stats(t) for t in fwd_bwd()]
                row["fwd_bwd_ms"] = cs.cuda_ms(fwd_bwd, 10)
            # the float32 sum of the bf16 cotangent: read as it is, and through a float32 copy
            if dtype == torch.bfloat16:
                direct = gy.sum(dim=(0, 1, 2), dtype=torch.float32).double()
                copied = gy.to(torch.float32).sum(dim=(0, 1, 2)).double()
                row["db_f32_rel"] = float(((direct - copied).abs()
                                           / copied.abs().clamp_min(1e-30)).max())
            xn, wl, bl = x.permute(0, 3, 1, 2), wt.to(dtype), bias.to(dtype)
            pad = (0, 1) if halo else 1
            lib = lambda: F.conv2d(xn, wl, bl, padding=pad)  # noqa: E731
        row["library_ms"] = cs.cuda_ms(lib, 20)
        row["library_device_ms"] = cs.profiled_device_ms(lib)[0]
        rows_out.append(row)
        cs.log(f"[launch ab] {ident} {root.name}: {kind} {path} {shape} {dtype}: "
               f"{row['ms']:.4f} ms (events), device {cs._ms(row['device_ms'])}, "
               f"{row['device_kernels_per_call']} kernels a call, host {row['host_us']:.2f} us a "
               f"call; library {row['library_ms']:.4f} ms")
        del x, gy
        torch.cuda.empty_cache()
    for r in rows_out:
        r["gpu"] = ident
    return rows_out


def compare(path: Path) -> int:
    runs = json.loads(path.read_text())
    roots = sorted({r["root"] for run_ in runs for r in run_["rows"]},
                   key=lambda r: (Path(r).name != "parent", r))
    by = {}
    for run_ in runs:
        for r in run_["rows"]:
            key = (r["kernel"], r["path"], tuple(r["shape"]), r["dtype"])
            by.setdefault(key, {}).setdefault(r["root"], []).append(r)
    bad = 0
    fields = ("ms", "device_ms", "device_kernels_per_call", "host_us", "fwd_bwd_ms",
              "library_ms", "library_device_ms")
    summary = []
    for key, per_root in by.items():
        line = {"kernel": key[0], "path": key[1], "shape": list(key[2]), "dtype": key[3]}
        for root in roots:
            rs = per_root.get(root, [])
            line[Path(root).name or root] = {
                f: (statistics.mean(r[f] for r in rs) if rs and all(r.get(f) is not None
                                                                    for r in rs) else None)
                for f in fields}
        hashes = {(r.get("sha256"), tuple(r.get("grad_sha256", ()))) for rs in per_root.values()
                  for r in rs}
        line["bit_equal"] = len(hashes) == 1
        grads = [r["grad_stats"] for rs in per_root.values() for r in rs if "grad_stats" in r]
        if grads:  # each gradient's norm and projection against the first run's, by its norm
            t = torch.tensor(grads, dtype=torch.float64)  # (runs, gradients, 2)
            line["grad_rel"] = float(((t - t[0]).abs().amax(dim=2) / t[0, :, 0].clamp_min(1e-30))
                                     .max())
            bad += line["grad_rel"] > (1e-2 if key[3] == "bfloat16" else 1e-4)
        if any("db_f32_rel" in r for rs in per_root.values() for r in rs):
            line["db_f32_rel"] = max((r.get("db_f32_rel") or 0.0) for rs in per_root.values()
                                     for r in rs)
            bad += line["db_f32_rel"] > 1e-6
        bad += not line["bit_equal"]
        summary.append(line)
        print(json.dumps(line))
    out = path.with_name(path.stem + "_summary.json")
    out.write_text(json.dumps({"gpu": runs[0]["gpu"], "roots": roots, "rows": summary}, indent=1))
    print(f"[launch ab] {len(summary)} rows, {bad} differ between the roots; summary in {out}")
    return 1 if bad else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose kernels run")
    ap.add_argument("--json", default=None, help="append the rows to a JSON list in this file")
    ap.add_argument("--compare", default=None, help="compare the runs in this JSON file")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated rows to run (K1, K1_bwd, K2, K2_halo, K2_bwd, "
                         "K2_bwd_halo; default all); each row keeps its seed")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(Path(args.compare))
    kinds = set(args.kernels.split(",")) if args.kernels else None
    rows = run(Path(args.root).resolve(), kinds)
    if args.json:
        path = Path(args.json)
        prior = json.loads(path.read_text()) if path.exists() else []
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(prior + [{"gpu": rows[0]["gpu"], "rows": rows}]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
