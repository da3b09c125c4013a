#!/usr/bin/env python3
"""Design variants of K1's backward kernel, built side by side and timed in
turns on one CUDA GPU.

Each variant is ``adunet_torch/csrc/fused_norm.cu`` with named text
substitutions (each must match the source exactly once, so a variant that
no longer applies fails loudly), compiled by ``nvcc`` into its own library
under ``build/k1_bwd_variants/`` (all at once, one process each):

- ``shipped``: the source as it is;
- ``rows2_wide`` / ``rows1_wide``: two / one row slots a warp at C >= 1024
  (shipped: two at C = 1024 in bf16, one otherwise);
- ``rows4_narrow``: R = 4 / K row slots at C <= 512 (the rule before the
  redesign; shipped: two where K = 1, else one);
- ``shared_512``: the dgamma / dbeta partials in shared memory from C = 512
  (shipped: from C = 1024);
- ``grid_cap8``: 8 blocks a SM whatever fits (the grid before the
  redesign; shipped: the blocks that fit, at most 8);
- ``no_tail``: each block skips its barrier, its ordered sum over the warps
  and its partial's write (timing only: dgamma / dbeta are then wrong);
- with ``--parent DIR`` (a checkout, e.g. a ``git archive`` of the parent
  commit): ``parent``, that checkout's ``fused_norm.cu``, and
  ``parent_no_tail``, the same without its eight barriers and its partial's
  write.

It prints each variant's registers and spills (ptxas), checks every variant
but the ``no_tail`` ones against ``layer_norm_relu_backward`` at every C in
both types (dx; dgamma / dbeta outside rows whose masks disagree) and for
determinism, and times the backward (CUDA events, 30 launches) at the
flagship's and the deep config's shapes, each shape in two rounds with the
variants in turns; for ``shipped`` and ``parent`` also the profiler's device
time of the row kernel and of the column-sum kernel apart. Run from the
repository root on a machine with a GPU:

    python3 scripts/torch_k1_bwd_variants.py [--parent DIR] [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from adunet_torch.kernels import _build, fused_norm  # noqa: E402
from adunet_torch.utils import gpu_identity, setup_runtime  # noqa: E402

CSRC = ROOT / "adunet_torch" / "csrc"
OUT = ROOT / "build" / "k1_bwd_variants"

_R = "  static constexpr int R = (kShared ? K <= 4 : K == 1) ? 2 : 1;"
_TAIL_SHARED = "  if constexpr (kShared) {\n    __syncthreads();\n    for (int j"
_TAIL_REGS = "    __syncthreads();\n    const float* const all"
VARIANTS = {
    "shipped": [],
    "rows2_wide": [(_R, "  static constexpr int R = (kShared ? true : K == 1) ? 2 : 1;")],
    "rows1_wide": [(_R, "  static constexpr int R = (kShared ? false : K == 1) ? 2 : 1;")],
    "rows4_narrow": [(_R, "  static constexpr int R = kShared ? (K <= 4 ? 2 : 1)"
                          " : (K >= 4 ? 1 : 4 / K);")],
    "shared_512": [("static constexpr bool kShared = K * V >= 32;",
                    "static constexpr bool kShared = K * V >= 16;")],
    "grid_cap8": [("per_sm[dev] = n < 1 ? 1 : n < kBwdMaxBlocksPerSm ? n : kBwdMaxBlocksPerSm;",
                   "per_sm[dev] = kBwdMaxBlocksPerSm;")],
    "no_tail": [(_TAIL_SHARED, "  if constexpr (kShared) {\n    if (rows < 0) for (int j"),
                (_TAIL_REGS, "    if (rows >= 0) return;\n    const float* const all")],
}
PARENT_NO_TAIL = [("    __syncthreads();\n  }\n  float* out = partial",
                   "  }\n  if (rows >= 0) return;\n  float* out = partial")]
# not checked: the no_tail variants (wrong dgamma / dbeta by design) and the
# parent, whose forward (and so mask) differs from this checkout's
NO_CHECK = {"no_tail", "parent", "parent_no_tail"}

# (rows, C, dtype): the flagship's bf16 training shapes, the deep config's,
# and the float32 wide rows
SHAPES = ([(r, c, torch.bfloat16) for r, c in cs.K1_TRAIN]
          + [(r, c, torch.bfloat16) for r, c in cs.K1_DEEP]
          + [(r, c, torch.float32) for r, c in cs.K1_DEEP if c >= 1024])


def substituted(src: str, subs: list[tuple[str, str]], name: str) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(sources: dict[str, tuple[str, str]]) -> tuple[dict, dict]:
    """{name: (fused_norm.cu text, common.cuh text)} -> libraries, ptxas logs.
    A library's ``takes_device`` says whether its entry points take the
    device index (this checkout's do; a parent's from before they did not)."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (src, common) in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_norm.cu").write_text(src)
        (d / "common.cuh").write_text(common)
        cmd = [nvcc, *_build._ARCH, *_build._FLAGS, "-shared", str(d / "fused_norm.cu"),
               "-o", str(d / "lib.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p = ctypes.c_void_p
        lib.takes_device = "int dtype, int device, void* stream" in sources[name][0]
        dev = [ctypes.c_int] if lib.takes_device else []
        lib.adunet_layer_norm_relu.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int, *dev, p]
        lib.adunet_layer_norm_relu_backward.argtypes = [p] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, *dev, p]
        lib.adunet_layer_norm_relu_backward_partials.argtypes = [p]
        libs[name] = lib
    return libs, logs


def ptxas_rows(log: str) -> list[dict]:
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        inst = re.search(r"layer_norm_relu_bwd_rows_kernelI\w*?_\d+(F32|BF16)E(\w+)", name or "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if inst and m:
            # template arguments: <type, C>, or <type, V, K, L, R> before the redesign
            n = [int(v) for v in re.findall(r"Li(\d+)E", inst.group(2))]
            rows.append({"type": inst.group(1), "C": n[0] if len(n) == 1 else n[0] * n[1] * n[2],
                         "spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if inst and m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def launcher(lib, n_part: int, x, g, a, b):
    rows, c = x.shape
    dx = torch.empty_like(x)
    dp = torch.empty(2, c, device="cuda")
    part = torch.empty(n_part, 2, c, device="cuda")
    code = 1 if x.dtype == torch.bfloat16 else 0

    dev = [x.get_device()] if lib.takes_device else []

    def run():
        err = lib.adunet_layer_norm_relu_backward(
            x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(), dx.data_ptr(), dp.data_ptr(),
            part.data_ptr(), rows, c, 1e-3, code, *dev, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run, dx, dp


def inputs(rows: int, c: int, dtype, seed: int):
    gen = torch.Generator("cuda").manual_seed(seed)
    x, a, b = cs._k1_inputs(gen, rows, c, dtype)
    return x, torch.randn(rows, c, generator=gen, device="cuda").to(dtype), a, b


def check(libs: dict, n_part: dict) -> list[str]:
    """Every checked variant against the plain backward; the failures."""
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        for c in fused_norm.SUPPORTED_CHANNELS:
            for rows in (1, 777, 40_001 if c <= 256 else 5_003):
                x, g, a, b = inputs(rows, c, dtype, seed=c + rows)
                want = fused_norm.layer_norm_relu_backward(x, a, b, g)
                flips = cs._k1_flips(x, a, b).any(dim=1)
                keep = ~flips
                for name, lib in libs.items():
                    if name in NO_CHECK:
                        continue
                    run, dx, dp = launcher(lib, n_part[name], x, g, a, b)
                    run()
                    first = dp.clone()
                    run()
                    torch.cuda.synchronize()
                    err = ((dx.float() - want[0].float())[keep].abs().max()
                           / want[0].float()[keep].abs().max().clamp_min(1e-30)).item() \
                        if bool(keep.any()) else 0.0
                    p_err = max(((dp[i] - want[1 + i]).abs().max()
                                 / want[1 + i].abs().max().clamp_min(1e-30)).item() for i in (0, 1))
                    tol = 1e-5 if dtype == torch.float32 else 1e-2
                    if err > tol or (not flips.any() and p_err > 1e-3) or not torch.equal(first, dp):
                        bad.append(f"{name} {rows}x{c} {dtype}: dx {err:.2e}, params {p_err:.2e}")
    return bad


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout whose fused_norm.cu to add")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_bwd_variants: needs a CUDA GPU")
    setup_runtime()
    ident = gpu_identity().splitlines()[0]
    src, common = (CSRC / "fused_norm.cu").read_text(), (CSRC / "common.cuh").read_text()
    sources = {name: (substituted(src, subs, name), common) for name, subs in VARIANTS.items()}
    if args.parent:
        pdir = Path(args.parent) / "adunet_torch" / "csrc"
        psrc, pcommon = (pdir / "fused_norm.cu").read_text(), (pdir / "common.cuh").read_text()
        sources["parent"] = (psrc, pcommon)
        sources["parent_no_tail"] = (substituted(psrc, PARENT_NO_TAIL, "parent_no_tail"), pcommon)
    t0 = time.perf_counter()
    libs, logs = build(sources)
    result = {"gpu": ident, "build_s": time.perf_counter() - t0, "ptxas": {}, "times": {},
              "kernels_apart": {}}
    for name, log in logs.items():
        result["ptxas"][name] = ptxas_rows(log)
        cs.log(f"[variants] {name}: " + ", ".join(
            f"{r['type']} C={r['C']} {r.get('registers')} reg spill {r['spill_stores']}/"
            f"{r['spill_loads']}" for r in result["ptxas"][name]))
    n_part = {}
    for name, lib in libs.items():
        n = ctypes.c_int(0)
        if lib.adunet_layer_norm_relu_backward_partials(ctypes.addressof(n)):
            raise SystemExit(f"{name}: partials query failed")
        n_part[name] = n.value
    result["check_failures"] = check(libs, n_part)
    for line in result["check_failures"]:
        cs.log(f"[variants] CHECK FAILED {line}")
    for rnd in range(2):
        for rows, c, dtype in SHAPES:
            x, g, a, b = inputs(rows, c, dtype, seed=0)
            bound = (3 * rows * c * x.element_size() + 16 * c) / cs.HBM_BYTES_PER_S * 1e3
            key = f"{rows}x{c} {cs._dname(dtype)}"
            line = []
            for name, lib in libs.items():
                run, _, _ = launcher(lib, n_part[name], x, g, a, b)
                ms = cs.cuda_ms(run, 30)
                result["times"].setdefault(key, {"bound_ms": bound}).setdefault(name, []).append(ms)
                line.append(f"{name} {ms:.4f}")
                if rnd == 0 and name in ("shipped", "parent"):
                    apart = {kern: cs.profiled_device_ms(run, kern)[0]
                             for kern in ("layer_norm_relu_bwd_rows", "layer_norm_relu_bwd_cols")}
                    result["kernels_apart"].setdefault(key, {})[name] = apart
                    line.append(f"[{name} device: rows {cs._ms(apart['layer_norm_relu_bwd_rows'])},"
                                f" cols {cs._ms(apart['layer_norm_relu_bwd_cols'])}]")
            cs.log(f"[variants] {ident} round {rnd} {key} (bound {bound:.4f} ms): " + ", ".join(line))
            del x, g
            torch.cuda.empty_cache()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result))
    return 1 if result["check_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
