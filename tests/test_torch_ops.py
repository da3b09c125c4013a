"""Parity of the port's image ops and depth policy with the JAX reference.

The same numpy inputs (from a seed) go through ``adunet`` (JAX, CPU) and
``adunet_torch`` (PyTorch, CPU). Tolerances: the sampling matrices are built
by the same numpy code, so they must be equal exactly; the resizes apply them
with float32 matmuls in a different summation order, hence atol 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adunet import ops as jops
from adunet.nn import depth_policy as jdp
from adunet_torch import nn as tnn
from adunet_torch import ops as tops
from adunet_torch.nn import depth_policy as tdp

torch.set_num_threads(2)

SCALES = (0.2, 0.3, 0.45, 0.5, 0.6, 0.7, 0.8, 0.9)
METHODS = ("area", "bilinear", "bicubic", "bicubic_cv2", "nearest", "lanczos3")


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("sizes", [(37, 16), (16, 37), (32, 32), (33, 13), (64, 20)])
def test_resize_matrix_equal(method, sizes):
    for antialias in (True, False):
        np.testing.assert_array_equal(
            tops.resize_matrix(*sizes, method, antialias),
            jops.resize_matrix(*sizes, method, antialias),
        )


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("size", [32, 33])
def test_resize_by_scale_and_to_match(scale, size):
    x = _img((2, size, size + 3, 5), seed=size)
    got = tops.resize_by_scale(torch.from_numpy(x), scale).numpy()
    want = np.asarray(jops.resize_by_scale(jnp.asarray(x), scale))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)

    ref = np.zeros((1, size, size + 3, 1), np.float32)
    back = tops.resize_to_match(torch.from_numpy(got), torch.from_numpy(ref)).numpy()
    back_j = np.asarray(jops.resize_to_match(jnp.asarray(want), jnp.asarray(ref)))
    np.testing.assert_allclose(back, back_j, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_resize_methods(method):
    x = _img((3, 23, 18, 2), seed=1)
    for out_hw in ((11, 9), (40, 31), (23, 18)):
        got = tops.resize(torch.from_numpy(x), out_hw, method).numpy()
        want = np.asarray(jops.resize(jnp.asarray(x), out_hw, method))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_resize_keeps_bf16_dtype():
    x = torch.rand(1, 16, 16, 4).to(torch.bfloat16)
    assert tops.resize_by_scale(x, 0.5).dtype == torch.bfloat16


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("size", [32, 45])
def test_degrade(scale, size):
    # values outside [0, 1] exercise the input clip; the output is not clipped
    x = _img((2, size, size, 3), seed=3) * 1.2 - 0.1
    got = tops.degrade(torch.from_numpy(x), scale).numpy()
    want = np.asarray(jops.degrade(jnp.asarray(x), scale))
    np.testing.assert_allclose(got, want, atol=1e-5)
    got_sq = tops.degrade(torch.from_numpy(x), scale, output_size=size - 4).numpy()
    want_sq = np.asarray(jops.degrade(jnp.asarray(x), scale, size - 4))
    np.testing.assert_allclose(got_sq, want_sq, atol=1e-5)


def test_degrade_rejects_bad_scale():
    with pytest.raises(ValueError):
        tops.degrade(torch.zeros(1, 8, 8, 3), 1.0)


def test_luma_and_clipped_residual_add():
    x = _img((2, 9, 7, 3), seed=4)
    r = (_img((2, 9, 7, 3), seed=5) - 0.5) * 0.8
    np.testing.assert_allclose(
        tops.rgb_to_luma_bt601(torch.from_numpy(x)).numpy(),
        np.asarray(jops.rgb_to_luma_bt601(jnp.asarray(x))), atol=1e-6,
    )
    np.testing.assert_allclose(
        tops.clipped_residual_add(torch.from_numpy(x), torch.from_numpy(r)).numpy(),
        np.asarray(jops.clipped_residual_add(jnp.asarray(x), jnp.asarray(r))), atol=1e-6,
    )


def test_depth_policy_grid():
    for scale in np.round(np.arange(0.06, 0.99, 0.01), 2):
        for base in (64, 128, 256, 512):
            for max_depth in (1, 3, 5, 7):
                assert tdp.custom_depth_from_scale(
                    scale, max_depth=max_depth, base_resolution=base
                ) == jdp.custom_depth_from_scale(scale, max_depth=max_depth, base_resolution=base)
        for depth in range(1, 6):
            assert tdp.encoder_sizes(256, scale, depth) == jdp.encoder_sizes(256, scale, depth)
            assert tdp.estimate_bottleneck_size(256, scale, depth) == \
                jdp.estimate_bottleneck_size(256, scale, depth)
    with pytest.raises(ValueError):
        tdp.custom_depth_from_scale(1.2)


_SCALES = [float(s) for s in np.round(np.arange(0.06, 0.99, 0.01), 2)] + [0.25, 0.45, 0.051, 0.999]


@pytest.mark.parametrize("min_depth, max_depth", [(1, 4), (1, 1), (2, 3), (3, 7), (0, 2), (5, 4)])
def test_infer_depth_from_scale_grid(min_depth, max_depth):
    """The design-table policy against ``adunet.nn.depth_policy`` at every
    scale of the grid (and the table's edges 0.25 / 0.45), for each pair of
    depth bounds, an inverted pair among them."""
    for scale in _SCALES:
        assert tdp.infer_depth_from_scale(scale, min_depth, max_depth) == \
            jdp.infer_depth_from_scale(scale, min_depth, max_depth), scale


@pytest.mark.parametrize("min_res, max_depth", [(21, 7), (21, 3), (1, 7), (64, 7), (256, 5),
                                                (300, 7), (21, 1), (0, 12)])
def test_depth_and_sizes_grid(min_res, max_depth):
    """``depth_and_sizes`` against the reference's at every scale of the grid
    and at 1.0 / 1.5 (which it takes: only ``infer_depth_from_scale`` and
    ``custom_depth_from_scale`` check the scale), for each bound."""
    for scale in _SCALES + [1.0, 1.5]:
        assert tdp.depth_and_sizes(scale, min_res, max_depth) == \
            jdp.depth_and_sizes(scale, min_res, max_depth), scale


@pytest.mark.parametrize("scale", [0.05, 0.0, -0.5, 1.0, 1.2])
def test_infer_depth_from_scale_raises_outside_the_open_interval(scale):
    """Both packages refuse a scale outside (0.05, 1) with the same message."""
    with pytest.raises(ValueError) as want:
        jdp.infer_depth_from_scale(scale)
    with pytest.raises(ValueError) as got:
        tdp.infer_depth_from_scale(scale)
    assert str(got.value) == str(want.value)
    # exported from adunet_torch.nn, as the reference's from adunet.nn
    assert (tnn.infer_depth_from_scale, tnn.depth_and_sizes) == \
        (tdp.infer_depth_from_scale, tdp.depth_and_sizes)


# ---------------------------------------------------------------- banded resize
# The CUDA kernel (adunet_torch/kernels/resize_band.py) reads each matrix from
# its band tables; these hold the tables, and the kernel's tiling, to the
# dense matrices here. The kernel itself runs only on the card
# (tests_gpu/test_torch_resize_gpu.py).

_band = importlib.import_module("adunet_torch.kernels.resize_band")

BAND_METHODS = ("area", "bilinear", "bicubic", "bicubic_cv2", "nearest", "lanczos3", "lanczos5")
# the flagship's ladder, the deep model's, the degradation's 256 <-> 128
# (area, then cv2's cubic: both among the methods) and two odd sizes
BAND_SIZES = [(256, 128), (128, 64), (64, 32), (32, 64), (64, 128), (128, 256),
              (256, 205), (205, 164), (164, 132), (132, 106), (106, 85),
              (85, 106), (106, 132), (132, 164), (164, 205), (205, 256),
              (37, 16), (23, 61)]


def _expand(start, weight, in_size):
    dense = np.zeros((len(start), in_size), np.float32)
    for i, (s, w) in enumerate(zip(start, weight)):
        dense[i, s:s + len(w)] = w
    return dense


def _matrices(sizes, method):
    for antialias in (True, False):
        m = tops.resize_matrix(*sizes, method, antialias)
        yield m
        yield m.T


@pytest.mark.parametrize("method", BAND_METHODS)
@pytest.mark.parametrize("sizes", BAND_SIZES)
def test_band_tables_expand_to_the_matrix(method, sizes):
    """The tables, expanded back to dense, are the matrix bit for bit (and the
    transposed matrix's, the backward's); starts never decrease and a band
    never passes the input's end."""
    for m in _matrices(sizes, method):
        start, weight = _band.band_tables(m)
        assert start.dtype == np.int32 and weight.dtype == np.float32
        assert np.all(np.diff(start) >= 0) and np.all(start >= 0)
        assert np.all(start + weight.shape[1] <= m.shape[1])
        np.testing.assert_array_equal(_expand(start, weight, m.shape[1]), m)


@pytest.mark.parametrize("method", BAND_METHODS)
@pytest.mark.parametrize("sizes", BAND_SIZES)
def test_band_gather_equals_the_dense_product(method, sizes):
    """A float32 gather by the tables, out[i] = sum_k weight[i, k] *
    x[start[i] + k], equals the dense float32 product to 1e-6."""
    rng = np.random.default_rng(sum(sizes))
    for m in _matrices(sizes, method):
        start, weight = _band.band_tables(m)
        x = rng.standard_normal((m.shape[1], 5)).astype(np.float32)
        cols = start[:, None] + np.arange(weight.shape[1])[None, :]
        got = np.einsum("ik,ikc->ic", weight, x[cols])
        np.testing.assert_allclose(got, m @ x, rtol=0, atol=1e-6)


def _tiled(x, p):
    """The kernel's tiling of ``plan`` p, in numpy: every block's footprint
    from its first and last output's band, each output row's band of it, the
    float32 intermediate and the W sums, with the bounds the kernel relies on
    asserted."""
    n, h, w, c, oh, ow, kh, kw, ti, tj, cg, fh_max, fw_max, vec, din, dout = list(p)
    transposed = bool(p._transposed)
    sizes_h, sizes_w = ((oh, h), (ow, w)) if transposed else ((h, oh), (w, ow))
    hs, hw = _band._tables(*sizes_h, p._method, p._antialias, transposed)
    ws, ww = _band._tables(*sizes_w, p._method, p._antialias, transposed)
    assert _band._smem(tj, cg, vec, fh_max, fw_max, kh, kw, 2 if din else 4) <= 96 * 1024 and ti == 4
    y = np.full((n, oh, ow, c), np.nan)
    for i0 in range(0, oh, ti):
        ni = min(ti, oh - i0)
        hbase = hs[i0]
        fh = hs[i0 + ni - 1] + kh - hbase
        assert fh <= fh_max and hbase + fh <= h
        for j0 in range(0, ow, tj):
            nj = min(tj, ow - j0)
            wbase = ws[j0]
            fw = ws[j0 + nj - 1] + kw - wbase
            assert fw <= fw_max and wbase + fw <= w
            foot = x[:, hbase:hbase + fh, wbase:wbase + fw]
            t = np.zeros((n, ni, fw, c))
            for q in range(ni):
                off = hs[i0 + q] - hbase
                assert 0 <= off and off + kh <= fh
                t[:, q] = np.einsum("k,nkwc->nwc", hw[i0 + q], foot[:, off:off + kh])
            for j in range(nj):
                off = ws[j0 + j] - wbase
                assert 0 <= off and off + kw <= fw
                y[:, i0:i0 + ni, j0 + j] = np.einsum("k,nikc->nic", ww[j0 + j], t[:, :, off:off + kw])
    return y


class _Plan(list):
    pass


def _plan(n, h, w, c, oh, ow, method, antialias, transposed, vec):
    p = _Plan(_band.plan(n, h, w, c, oh, ow, method, antialias, transposed, vec, 1, 1))
    p._method, p._antialias, p._transposed = method, antialias, transposed
    return p


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", [
    (64, 32, "bilinear", True, 72), (32, 64, "bilinear", True, 16), (64, 51, "bilinear", True, 8),
    (51, 41, "bilinear", True, 24), (32, 16, "area", True, 3), (16, 32, "bicubic_cv2", False, 3),
    (37, 16, "lanczos3", True, 5), (23, 61, "bicubic", True, 8), (40, 9, "lanczos5", True, 16),
    (20, 20, "bilinear", True, 8)])
def test_band_tiling_equals_the_dense_product(case, transposed):
    """The kernel's tiles, in numpy, give the dense product of the matrices
    (the transposed ones for the backward): every band inside its block's
    footprint, every footprint inside the plan's and the input."""
    a, b, method, antialias, c = case
    h, oh = (b, a) if transposed else (a, b)
    vec = 8 if c % 8 == 0 else 1
    x = np.random.default_rng(a * b + c).standard_normal((2, h, h - 3 if h > 20 else h, c))
    w = x.shape[2]
    ow = {True: a, False: b}[transposed] if w == h else _ow(w, a, b, transposed)
    p = _plan(2, h, w, c, oh, ow, method, antialias, transposed, vec)
    mh = tops.resize_matrix(*((oh, h) if transposed else (h, oh)), method, antialias)
    mw = tops.resize_matrix(*((ow, w) if transposed else (w, ow)), method, antialias)
    if transposed:
        mh, mw = mh.T, mw.T
    want = np.einsum("ih,jw,nhwc->nijc", mh.astype(np.float64), mw.astype(np.float64), x)
    np.testing.assert_allclose(_tiled(x, p), want, rtol=0, atol=1e-5)


def _ow(w, a, b, transposed):
    # a width 3 below the height keeps the ratio roughly: the W axis then has
    # its own tables, band widths and footprints
    return max(1, round(w * (a / b if transposed else b / a)))


@pytest.mark.parametrize("cell", ["flagship", "deep"])
def test_band_plans_of_the_cells_fit(cell):
    """Every resize of the benchmark's training cells, forward and backward,
    and of their degradation, gets a plan within 96 KiB of shared memory whose
    footprints hold every tile's."""
    if cell == "flagship":
        ladder, channels, batch = [256, 128, 64, 32], [64, 128, 256, 512], 32
    else:
        ladder, channels, batch = [256, 205, 164, 132, 106, 85], [64, 128, 256, 512, 1024, 2048], 8
    shapes = []
    for level in range(len(ladder) - 1):
        big, small = ladder[level], ladder[level + 1]
        shapes.append((big, small, channels[level], "bilinear", True))        # encoder
        shapes.append((small, big, channels[level + 1], "bilinear", True))    # decoder
    down = round(256 * (0.5 if cell == "flagship" else 0.8))
    shapes += [(256, down, 3, "area", True), (down, 256, 3, "bicubic_cv2", False)]
    for h, oh, c, method, antialias in shapes:
        for transposed in (False, True):
            hi, ho = (oh, h) if transposed else (h, oh)
            p = _plan(batch, hi, hi, c, ho, ho, method, antialias, transposed, 8 if c % 8 == 0 else 1)
            n_, h_, w_, c_, oh_, ow_, kh, kw, ti, tj, cg, fh, fw, vec = list(p)[:14]
            assert _band._smem(tj, cg, vec, fh, fw, kh, kw, 2) <= 96 * 1024 and ti == 4
            hs, _ = _band._tables(h, oh, method, antialias, transposed)  # the forward's sizes
            assert fh == _band._footprint(hs, kh, ti) and fw == _band._footprint(hs, kw, tj)
            assert kh <= 8, (h, oh, method, transposed, kh)


def test_cpu_resize_takes_the_dense_product():
    """On the CPU a resize is the dense product (the plain version), through
    the kernel's wrapper, and launches nothing."""
    x = torch.from_numpy(_img((2, 20, 18, 8), seed=6)).to(torch.bfloat16)
    before = _band.resize_band.launches
    got = tops.resize_by_scale(x, 0.5)
    want = _band.resize_band_plain(x, (10, 9)).to(torch.bfloat16)
    assert torch.equal(got, want) and _band.resize_band.launches == before
    assert torch.equal(_band.resize_band(x, (10, 9), dtype=torch.bfloat16), want)
    assert _band.resize_band.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("method, antialias", [("bilinear", True), ("area", True),
                                               ("bicubic_cv2", False)])
def test_cpu_resize_band_is_the_plain_version_cast(dtype, method, antialias):
    """``resize_band`` on a CPU tensor is ``resize_band_plain(...).to(dtype)``,
    and its gradient autograd's through that dense product, bit for bit."""
    x = torch.from_numpy(_img((2, 20, 18, 8), seed=8)).requires_grad_(True)
    got = _band.resize_band(x, (10, 27), method, antialias, dtype)
    want = _band.resize_band_plain(x, (10, 27), method, antialias).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(9)).to(dtype)
    assert torch.equal(torch.autograd.grad(got, x, g)[0], torch.autograd.grad(want, x, g)[0])


def test_exported_resize_is_the_op():
    """While ``torch.export`` traces, a resize that changes a size is the op
    ``adunet_torch::resize_band`` (the program then runs the kernel on the
    card); on the CPU the op runs the dense product."""

    class Net(torch.nn.Module):
        def forward(self, x):
            y = tops.resize_by_scale(x, 0.5)
            return tops.resize_to_match(y, x) + tops.resize(x, (x.shape[1], x.shape[2]))

    x = torch.from_numpy(_img((2, 16, 12, 8), seed=7))
    ep = torch.export.export(Net(), (x,))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count("adunet_torch.resize_band.default") == 2, ops
    assert not any("mm" in o for o in ops), ops
    torch.testing.assert_close(ep.module()(x), Net()(x), rtol=0, atol=0)
    for dtype in (torch.float32, torch.bfloat16):
        torch.library.opcheck(torch.ops.adunet_torch.resize_band.default,
                              (x.to(dtype), 8, 9, "bilinear", True, dtype))


@pytest.mark.parametrize("shape, cout", [((8, 32, 32, 256), 512), ((8, 256, 256, 128), 64),
                                         ((1, 17, 40, 8), 192)])
def test_k3_op_fake_kernel_gives_the_output_shape(shape, cout):
    """While a program is traced, K3's op (``adunet_torch::conv3x3_f32``)
    gives the output's shape and type from fake tensors, reading no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from adunet_torch.kernels import ops  # noqa: F401  (registers the op)

    with FakeTensorMode():
        x = torch.empty(shape)
        y = torch.ops.adunet_torch.conv3x3_f32(x, torch.empty(cout, shape[-1], 3, 3),
                                               torch.empty(cout))
        y_nobias = torch.ops.adunet_torch.conv3x3_f32(x, torch.empty(cout, shape[-1], 3, 3), None)
    assert tuple(y.shape) == tuple(y_nobias.shape) == (*shape[:3], cout)
    assert y.dtype == torch.float32
