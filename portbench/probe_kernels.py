"""Check the per-layer metrics' kernel-name classes against the operators
that launch each kernel: one profiled eager step of each training
configuration and one profiled forward of the served flagship program, on
the card. For each device kernel it prints the operator that launched it
and the classes the metric files put it in, and fails where a class takes
a kernel of another operator (a convolution's kernel counted as a resize's,
say). Under a CUDA graph's replay the profiler sees the kernels' names
only; this is where the names are tied to the operators.

    python3 -m portbench.probe_kernels [--json probe_kernels.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from portbench import catalog, program
from portbench.lib import inputs

CONV_OPS = ("cudnn_convolution", "convolution_backward", "_convolution", "conv2d", "convolution")
MM_OPS = ("aten::mm", "aten::bmm", "aten::matmul", "aten::addmm", "aten::baddbmm")

OWN = ("layer_norm_relu", "conv3x3_c64", "pack_conv3x3_weights")
CONV = ("cudnn", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft", "conv")
GEMM = ("gemm", "gemv", "matmul")
HALF = ("bf16", "f16", "h16", "fp16", "s16816", "16816", "hmma", "e4m3")


def is_resize(name: str) -> bool:
    """A float32 GEMM kernel (cuBLAS or CUTLASS) that is no convolution's:
    the dense resizes' matrix products, which the training step ran before
    the banded resize kernel took their place (its convolutions run in
    bf16). A training step should launch none."""
    low = name.lower()
    return (not any(s in name for s in OWN) and not any(s in low for s in CONV)
            and any(s in low for s in GEMM) and not any(s in low for s in HALF))


def _classes() -> dict:
    """The metric files' own predicates, the f32 GEMMs', and K1's and K2's
    names."""
    return {"conv_lib": catalog.metric_module("conv_lib_ms.train").is_library_conv,
            "resize": is_resize,
            "k1": lambda n: "layer_norm_relu" in n,
            "k2": lambda n: "conv3x3_c64" in n or "pack_conv3x3_weights" in n}


def attribute(fn) -> list:
    """[(operator, kernel name, device us)] of one call of ``fn``: each
    kernel under the innermost operator that launched it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            continue
        for k in e.kernels:
            rows.append((e.name, k.name, float(k.duration)))
    return rows


def judge(rows: list, what: str) -> dict:
    classes = _classes()
    by_class: dict = {c: {} for c in classes}
    faults = []
    for op, kernel, us in rows:
        if kernel.startswith("Memset") or kernel.startswith("Memcpy"):
            continue
        hits = [c for c, f in classes.items() if f(kernel)]
        for c in hits:
            by_class[c].setdefault(op, 0.0)
            by_class[c][op] += us
        if len(hits) > 1:
            faults.append(f"{kernel} is in {hits}")
        if "conv_lib" in hits and not any(s in op for s in CONV_OPS):
            faults.append(f"conv_lib takes {kernel} of {op}")
        if "resize" in hits and not any(op.startswith(s) for s in MM_OPS):
            faults.append(f"resize takes {kernel} of {op}")
        if any(s in op for s in CONV_OPS) and not hits:
            faults.append(f"{kernel} of {op} is in no class")
        if any(op.startswith(s) for s in MM_OPS) and "resize" not in hits and what != "serve":
            faults.append(f"{kernel} of {op} is not a resize's")
    for c, ops in by_class.items():
        print(f"[probe] {what}: {c}: " + ", ".join(f"{o} {v / 1e3:.3f} ms" for o, v in ops.items()),
              file=sys.stderr)
    for f in faults:
        print(f"[probe] {what}: FAULT {f}", file=sys.stderr)
    return {"by_class_ms": {c: {o: v / 1e3 for o, v in ops.items()} for c, ops in by_class.items()},
            "kernels": sorted({(op, k) for op, k, _ in rows}), "faults": faults}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    out = {}
    for name in ("sr_flagship", "sr_deep"):
        cfg = catalog.config(name)
        model = catalog.model(cfg)
        corpus = inputs.corpus(1, 16, 512, 512, "cuda")
        net = model.build(cfg, inputs.weights(cfg, 1, "cuda"), cfg["train"]["dtype"], "cuda",
                          remat=bool(cfg["train"].get("remat")))
        state, step = model.train_step(cfg, net, corpus, graph=False)
        gen = torch.Generator("cuda").manual_seed(1)
        out[f"{name}.train"] = judge(attribute(lambda: step(state, None, gen)), "train")
        del state, step, net, corpus
        torch.cuda.empty_cache()
    cfg = catalog.config("sr_flagship")
    with tempfile.TemporaryDirectory() as tmp:
        model = catalog.model(cfg)
        net = model.build(cfg, inputs.weights(cfg, 1, "cuda"), "float32", "cuda")
        model.save_artifact(net, tmp, cfg)
        prog = program.served_program(tmp, "cuda")
        x = torch.rand(8, 256, 256, 3, device="cuda")
        with torch.inference_mode():
            out["sr_flagship.serve"] = judge(attribute(lambda: prog.module(x)), "serve")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    bad = sum(len(v["faults"]) for v in out.values())
    print(json.dumps({"faults": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
