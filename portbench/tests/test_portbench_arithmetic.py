"""The metric arithmetic: operations and bytes counted from shapes, the
idle share's interval union, order statistics, and the readers' refusal to
read where the launches do not match the shapes."""

from __future__ import annotations

import math

import pytest

from portbench import catalog, check, probe_kernels
from portbench.lib import stats, trace, work
from portbench.reference import sr_unet


@pytest.mark.parametrize("name, params, norms", [("sr_flagship", 8_637_379, 16),
                                                 ("sr_deep", 138_427_843, 24)])
def test_layer_shapes(name, params, norms):
    cfg = catalog.config(name)
    assert sum(math.prod(s) for s in sr_unet.param_shapes(cfg).values()) == params == cfg["params"]
    convs = sr_unet.conv_layers(cfg, 8, 256)
    assert len(sr_unet.norm_layers(cfg, 8, 256)) == norms
    assert [c["name"] for c in work.k2_layers(convs)] == [
        "enc0.conv1", "dec0.conv1", "head.conv0", "head.conv1"]


def test_conv_flops_from_shapes():
    layer = dict(n=2, h=4, w=5, cin=3, cout=7, k=3, first=False)
    assert work.conv_flops(layer) == 2 * 2 * 4 * 5 * 3 * 7 * 9
    first = dict(layer, first=True)
    assert work.train_flops([layer, first]) == 5 * work.conv_flops(layer)
    cfg = catalog.config("sr_flagship")
    fwd = work.forward_flops(sr_unet.conv_layers(cfg, 32, 256))
    assert fwd == pytest.approx(3.48697657344e12)
    assert work.forward_flops(sr_unet.conv_layers(cfg, 1, 256)) * 32 == pytest.approx(fwd)


def test_bounds_from_shapes():
    # K1 at 2,097,152 x 64 bf16: read x, write y (bytes bound)
    rows, c = 2_097_152, 64
    assert work.k1_bound_ms(rows, c, "bfloat16") == pytest.approx(
        (2 * rows * c * 2 + 2 * c * 4) / 3.35e12 * 1e3)
    # K2 at 8 x 256 x 256 float32 is bound by operations at 67 TFLOP/s
    px = 8 * 256 * 256
    assert work.k2_bound_ms(8, 256, 256, "float32") == pytest.approx(
        (2 * px * 64 * 64 * 9 + px * 64) / 67e12 * 1e3)
    assert work.k2_bound_ms(8, 256, 256, "float32", backward=True) > work.k2_bound_ms(
        8, 256, 256, "float32")


def test_interval_union_and_idle_share():
    tr = trace.Trace(device=[("a", 10, 20), ("b", 15, 30), ("c", 40, 50), ("d", 95, 120)],
                     start_ns=0, end_ns=100)
    assert trace.union([(10, 20), (15, 30), (40, 50)]) == [(10, 30), (40, 50)]
    assert trace.busy_s(tr) == pytest.approx(35e-9)  # 20 + 10 + 5 (clipped at the end)
    assert trace.idle_share(tr) == pytest.approx(0.65)
    assert trace.device_seconds(tr, lambda n: n in ("a", "b")) == pytest.approx(25e-9)
    assert trace.idle_share(trace.Trace(start_ns=0, end_ns=10)) is None
    gaps = trace.top_idle_gaps(trace.Trace(device=[("k", 10, 20)], host=[("h", 0, 9)],
                                           start_ns=0, end_ns=100))
    assert gaps[0] == ["no host operation", 80e-9] and gaps[1] == ["h", 10e-9]


def test_percentiles():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([1.0] * 96 + [math.inf] * 4, 95) == 1.0
    assert stats.percentile([1.0] * 90 + [math.inf] * 10, 95) == math.inf


def test_roofline_readers_refuse_mismatched_launches():
    cfg = catalog.config("sr_flagship")
    model = catalog.model(cfg)
    tr = trace.Trace(device=[("layer_norm_relu_kernel", 0, 1_000_000),
                             ("conv3x3_c64_wgmma_kernel", 0, 1_000_000),
                             ("void adunet::resize_band_kernel<bf16>", 0, 2_000_000)],
                     start_ns=0, end_ns=2_000_000)
    ctx = {"trace": tr, "steps": 1, "convs": model.conv_layers(cfg, 32, 256),
           "norms": model.norm_layers(cfg, 32, 256), "resizes": model.resize_layers(cfg, 32, 256),
           "dtype": "bfloat16", "remat": False, "launches": (16, 16, 4, 4, 14)}
    k1, k2 = catalog.metric_reader("k1_roofline.train"), catalog.metric_reader("k2_roofline.train")
    rs = catalog.metric_reader("resize_band_roofline.train")
    assert k1(ctx) > 0 and k2(ctx) > 0
    assert k2(dict(ctx, launches=(16, 16, 3, 4, 14))) is None
    assert k1(dict(ctx, launches=(16, 15, 4, 4, 14))) is None
    assert k1(dict(ctx, remat=True)) is None and k2(dict(ctx, remat=True)) is None
    assert k1(dict(ctx, remat=True, launches=(32, 16, 8, 4, 14))) > 0
    # 2 ms of resize kernels a step against the 1.0705 ms bound of 14 launches
    assert rs(ctx) == pytest.approx(100.0 * 1.0704865 / 2.0)
    assert rs(dict(ctx, launches=(16, 16, 4, 4, 12))) is None
    assert rs(dict(ctx, launches=(16, 16, 4, 4, 0))) is None
    assert rs(dict(ctx, trace=trace.Trace(device=tr.device[:2], start_ns=0, end_ns=1))) is None
    band = catalog.metric_reader("resize_band_ms.train")
    assert band(ctx) == pytest.approx(2.0) and band(dict(ctx, launches=(16, 16, 4, 4, 0))) is None


@pytest.mark.parametrize("name, launches, bound_ms", [("sr_flagship", 14, 1.070),
                                                      ("sr_deep", 22, 1.742)])
def test_resize_bound_of_a_step(name, launches, bound_ms):
    """The resizes of a step, and their bound, as the port's smoke test lists
    and sums them (forward and backward; the degradation's forward only)."""
    cfg = catalog.config(name)
    layers = catalog.model(cfg).resize_layers(cfg, cfg["train"]["batch_size"], 256)
    passes = [2 if r["grad"] else 1 for r in layers]
    assert sum(passes) == launches
    total = sum(p * work.resize_bound_ms(r) for p, r in zip(passes, layers))
    assert total == pytest.approx(bound_ms, rel=0.01)
    # every pass is bound by its bytes: read x once, write y once
    for r in layers:
        es = 2 if r["dtype"] == "bfloat16" else 4
        moved = r["n"] * r["c"] * (r["h"] * r["w"] + r["oh"] * r["ow"]) * es
        assert work.resize_bound_ms(r) == pytest.approx(moved / 3.35e12 * 1e3)


def test_band_width():
    assert work.band_width(256, 128, "bilinear", True) == 4  # a 2x shrink: 4 taps
    assert work.band_width(128, 256, "bilinear", True) == 2
    assert work.band_width(128, 256, "bicubic_cv2", False) == 4
    assert work.band_width(256, 128, "area", True) == 2
    assert work.band_width(64, 64, "bilinear", True) == 1  # the identity


def test_kernel_classes():
    conv = catalog.metric_module("conv_lib_ms.train").is_library_conv
    resize = probe_kernels.is_resize
    fprop = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_kernel__5x_cudnn"
    sgemm = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_execute_kernel__5x_cublas"
    assert conv(fprop) and not resize(fprop)
    assert resize(sgemm) and not conv(sgemm)
    assert resize("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nt_align1>")
    assert conv("void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>")
    for own in ("layer_norm_relu_kernel", "conv3x3_c64_wgrad_wgmma_kernel",
                "pack_conv3x3_weights_kernel"):
        assert not conv(own) and not resize(own)


@pytest.mark.parametrize("statuses, admitted, expect", [
    ([200, 200, 503, check.RESET], 2, 0),  # two refusals, one read as a reset
    ([200, 200, 200, check.RESET], 4, 1),  # the reset was admitted: its answer never came
    ([200, 503, check.RESET, check.RESET], 2, 1),  # one refusal, two resets
    ([200, 200, 0], 3, 1),  # no reply at all
    ([200, 500, 503], 2, 0),  # a 500 is an answer
])
def test_missing_counts_resets_beyond_the_refusals(statuses, admitted, expect):
    assert check.missing(statuses, admitted) == expect
