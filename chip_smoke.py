#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adunet_torch``) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one NVIDIA Hopper card (the kernels are built for sm_90a) and
exits non-zero without one. Every phase raises on failure:

1. builds the CUDA kernels from ``adunet_torch/csrc`` with ``nvcc``;
2. prints the card's name and power limit (``nvidia-smi``);
3. holds each kernel against its plain PyTorch version on the card, at every
   shape the flagship serving forward gives it, in float32 and bf16, and
   times the kernel, the plain version and one PyTorch library call that
   computes the same function (a yardstick only: the port never calls it)
   beside the least time the card could take (``bound``);
4. serves the trained flagship artifact
   (``experiments/round3_flagship/export_int8``, scale 0.5, depth 3,
   batch 8 x 256 px) over HTTP through ``adunet_torch.cli.serve.make_server``
   with the kernel launch counts set to 0 just before: one image, a stack
   of 3 and 8 concurrent single-image requests, each answer equal to a
   direct call, and 16 K1 + 4 K2 launches per device call;
5. re-derives the flagship's pinned eval numbers
   (``experiments/round3_flagship/evaluation/metrics.json``) on the 48-tile
   seed-777 corpus: degrade on the card, restore, BT.601 luma, shave 4,
   PSNR / SSIM / MS-SSIM; and times the forward at batch 8;
6. prints one JSON line with each kernel's launches, error and times, the
   card's identity line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import sys
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
from adunet_torch.kernels import _build, conv64, fused_norm
from adunet_torch.metrics import msssim_power_factors_for, psnr, ssim, ssim_multiscale
from adunet_torch.ops import degrade, rgb_to_luma_bt601
from adunet_torch.utils import gpu_identity, setup_runtime

ROOT = Path(__file__).resolve().parent
ARTIFACT = ROOT / "experiments" / "round3_flagship" / "export_int8"
PINNED = ROOT / "experiments" / "round3_flagship" / "evaluation" / "metrics.json"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# (rows, C) -> LN+ReLU pairs per serving forward of the flagship (B=8, 256 px, depth 3)
K1_SHAPES = {(524_288, 64): 6, (131_072, 128): 4, (32_768, 256): 4, (8_192, 512): 2}
# x (B, H, W, C) -> 64->64 3x3 convs per forward (enc0.conv1, dec0.conv1, head.conv0/1)
K2_SHAPES = {(8, 256, 256, 64): 4}
K1_PER_CALL = sum(K1_SHAPES.values())  # 16
K2_PER_CALL = sum(K2_SHAPES.values())  # 4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def close_enough(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype, atol_f32: float) -> float:
    """Max |got - want|; raises past the tolerance. float32: ``atol_f32``
    (another summation / rsqrt order). bf16: one bf16 ulp relative (2^-7)
    plus 1e-6, since an f32 difference in the last bit can flip the
    rounding to bf16."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    err = (g - w).abs()
    limit = atol_f32 if dtype == torch.float32 else (2.0**-7) * w.abs() + 1e-6
    if not bool(torch.all(err <= limit)) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"kernel disagrees with its plain version: max |err| {err.max().item():.3e}")
    return err.max().item()


def bound_ms(bytes_moved: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(gen: torch.Generator) -> list[dict]:
    rows_out = []
    for (rows, c), per_call in K1_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, c, generator=gen, device="cuda").mul_(2.0).add_(0.3).to(dtype)
            g = torch.randn(c, generator=gen, device="cuda").mul_(0.1).add_(1.0)
            b = torch.randn(c, generator=gen, device="cuda").mul_(0.1)
            got = fused_norm.layer_norm_relu(x, g, b)
            want = fused_norm.layer_norm_relu_plain(x, g, b)
            torch.cuda.synchronize()
            err = close_enough(got, want, dtype, 1e-5)
            gl, bl = g.to(dtype), b.to(dtype)
            ms = cuda_ms(lambda: fused_norm.layer_norm_relu(x, g, b), 50)
            plain = cuda_ms(lambda: fused_norm.layer_norm_relu_plain(x, g, b), 10)
            lib = cuda_ms(lambda: F.relu(F.layer_norm(x, (c,), gl, bl, 1e-3)), 50)
            es = x.element_size()
            bnd, by = bound_ms(2 * rows * c * es + 2 * c * 4, 9 * rows * c, dtype)
            rows_out.append(dict(kernel="K1", shape=[rows, c], dtype=str(dtype).split(".")[1],
                                 per_call=per_call, max_abs_err=err, ms=ms, plain_ms=plain,
                                 library_ms=lib, bound_ms=bnd, bound_by=by))
            log(f"[K1] rows={rows} C={c} {dtype}: max|err|={err:.2e} kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, F.layer_norm+relu {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
    return rows_out


def check_k2(gen: torch.Generator) -> list[dict]:
    rows_out = []
    for (bsz, h, w, c), per_call in K2_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(bsz, h, w, c, generator=gen, device="cuda").to(dtype)
            wt = (torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05).to(dtype)
            bias = (torch.randn(64, generator=gen, device="cuda") * 0.1).to(dtype)
            got = conv64.conv3x3_same(x, wt, bias)
            want = conv64.conv3x3_same_plain(x, wt, bias)
            torch.cuda.synchronize()
            err = close_enough(got, want, dtype, 1e-4)
            ms = cuda_ms(lambda: conv64.conv3x3_same(x, wt, bias), 20)
            plain = cuda_ms(lambda: conv64.conv3x3_same_plain(x, wt, bias), 5)
            xn = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
            lib = cuda_ms(lambda: F.conv2d(xn, wt, bias, padding=1), 20)
            es = x.element_size()
            pixels = bsz * h * w
            bnd, by = bound_ms(2 * pixels * c * es + 9 * 64 * 64 * 4 + 64 * 4,
                               2 * pixels * 64 * 64 * 9 + pixels * 64, dtype)
            rows_out.append(dict(kernel="K2", shape=[bsz, h, w, c], dtype=str(dtype).split(".")[1],
                                 per_call=per_call, max_abs_err=err, ms=ms, plain_ms=plain,
                                 library_ms=lib, bound_ms=bnd, bound_by=by))
            log(f"[K2] x={bsz}x{h}x{w}x{c} {dtype}: max|err|={err:.2e} kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, F.conv2d (cuDNN, TF32 off) {lib:.4f} ms, "
                f"bound {bnd:.4f} ms ({by})")
    return rows_out


def _post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))


def serve_flagship(call) -> dict:
    """The main path: the HTTP server over the flagship artifact on the card."""
    fused_norm.layer_norm_relu.launches = 0
    conv64.conv3x3_same.launches = 0
    server = make_server(str(ARTIFACT), port=0, batch_window_ms=200.0, device="cuda")
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
    k1, k2 = fused_norm.layer_norm_relu.launches, conv64.conv3x3_same.launches
    calls = stats["device_calls"]
    log(f"[serve] stats {stats}; K1 launches {k1}, K2 launches {k2}")
    if calls < 1 or k1 != K1_PER_CALL * calls or k2 != K2_PER_CALL * calls:
        raise AssertionError(f"expected {K1_PER_CALL} K1 and {K2_PER_CALL} K2 launches per "
                             f"device call; got {k1} and {k2} over {calls} calls")
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
    return {"launches": {"K1": k1, "K2": k2}, "device_calls": calls}


def golden(call) -> dict:
    """The flagship's pinned eval numbers, re-derived on the card."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_synth_corpus import synth_image

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


def kernels_line(details: list[dict], launches: dict, build_s: float) -> dict:
    """One entry per kernel; times are summed over one float32 serving
    forward (per-shape time x launches per forward)."""
    meta = {
        "K1": ("layer_norm_relu", "adunet_torch/csrc/fused_norm.cu", "adunet/kernels/fused_norm.py:48"),
        "K2": ("conv3x3_same_c64", "adunet_torch/csrc/conv64.cu", "adunet/kernels/conv64.py:132"),
    }
    out = []
    for kid, (name, src, replaces) in meta.items():
        rows = [d for d in details if d["kernel"] == kid and d["dtype"] == "float32"]

        def per_forward(key: str) -> float:
            return sum(d[key] * d["per_call"] for d in rows)

        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kid],
            "max_abs_err": max(d["max_abs_err"] for d in details if d["kernel"] == kid),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": max(rows, key=lambda d: d["bound_ms"] * d["per_call"])["bound_by"],
            "library_ms": per_forward("library_ms"),
            "per": "one float32 serving forward of the flagship (batch 8, 256 px)",
        })
    return {"kernels": out, "build_s": build_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available; this smoke run needs one.", file=sys.stderr)
        return 2
    setup_runtime()
    t_start = time.perf_counter()

    _build.library()
    build_s = float(_build.last_build.get("seconds", 0.0))
    log(f"[build] kernels ready in {build_s:.1f} s: {_build.last_build.get('path')}")
    for line in _build.last_build.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log(f"[ptxas] {line.strip()}")

    ident = gpu_identity().splitlines()[0]
    log(f"[gpu] {ident}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    gen = torch.Generator("cuda").manual_seed(0)
    details = check_k1(gen) + check_k2(gen)
    torch.cuda.empty_cache()

    call, _ = load_artifact(ARTIFACT, device="cuda")
    served = serve_flagship(call)
    scores = golden(call)
    speed = forward_speed(call, ident)

    summary = {"gpu": ident, "details": details, "serve": served, "golden": scores,
               "speed": speed, "seconds": time.perf_counter() - t_start}
    log("[detail] " + json.dumps(summary))
    print(json.dumps(kernels_line(details, served["launches"], build_s)))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
