"""The port's K1 / K2 autograd Functions against the reference's custom VJPs.

The same numpy inputs and output cotangent go through ``jax.vjp`` of
``adunet.kernels.fused_norm.layer_norm_relu`` (its Pallas forward
interpreted on the CPU) and ``adunet.kernels.conv64.conv3x3_same`` (Pallas
interpreted off the TPU, as ``tests/test_conv64_kernel.py`` runs it), and
through ``torch.autograd.grad`` of the port's Functions. On the CPU the
Functions run their kernels' plain versions forward and the same backward
formulas the card runs, so these tests hold the card's backward too.

Tolerances: K1 float32 1e-5 (another order of the float32 reductions); K1
bf16 one bf16 ulp near the largest dx (2^-7 relative) and 1e-2 relative on
the float32 parameter sums. K2 float32 2e-4 absolute on dx / dw (sums of
2,048-147,456 float32 products in another order), 1e-4 relative on db.
``gradcheck`` in float64 checks the backward formulas against finite
differences at its default tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.kernels import conv64 as jconv
from adunet.kernels import fused_norm as jnorm
from adunet_torch.kernels import conv64 as tconv
from adunet_torch.kernels import fused_norm as tnorm

torch.set_num_threads(2)


def _norm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.3).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.3 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.3).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, g


def _torch_grads(fn, args, g):
    leaves = [torch.tensor(a, requires_grad=True) if isinstance(a, np.ndarray) else a for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, [t for t in leaves if isinstance(t, torch.Tensor)], g)
    return out, grads


@pytest.mark.parametrize("shape", [(96, 64), (2, 3, 5, 128), (40, 256), (3, 8, 512),
                                   (72, 16), (2, 3, 7, 32)])
def test_layer_norm_relu_grads_match_jax_f32(monkeypatch, shape):
    monkeypatch.setenv("ADUNET_FORCE_PALLAS", "1")
    monkeypatch.setenv("ADUNET_PALLAS_INTERPRET", "1")
    x, gamma, beta, g = _norm_inputs(shape, seed=shape[-1])
    want_y, vjp = jax.vjp(lambda a, b, c: jnorm.layer_norm_relu(a, b, c, 1e-3),
                          jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(g))
    got_y, got = _torch_grads(tnorm.layer_norm_relu, (x, gamma, beta), torch.from_numpy(g))
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y), atol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.asarray(want[0])).max()) > 0.1  # a real gradient, not zeros


def test_layer_norm_relu_grads_match_jax_bf16(monkeypatch):
    _bf16_grads_match_jax(monkeypatch, 64)


@pytest.mark.parametrize("c", [16, 32])
def test_narrow_layer_norm_relu_grads_match_jax_bf16(monkeypatch, c):
    """C = 16 and 32, the vanilla segmentation U-Net's first level."""
    _bf16_grads_match_jax(monkeypatch, c)


def _bf16_grads_match_jax(monkeypatch, c):
    monkeypatch.setenv("ADUNET_FORCE_PALLAS", "1")
    monkeypatch.setenv("ADUNET_PALLAS_INTERPRET", "1")
    x, gamma, beta, g = _norm_inputs((4, 8, c), seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    # identical bf16 input values on both sides
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    gj = jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jnorm.layer_norm_relu(a, b, c, 1e-3),
                     xj, jnp.asarray(gamma), jnp.asarray(beta))
    want_dx, want_dg, want_db = (np.asarray(t, np.float32) for t in vjp(gj))
    xt = xb.clone().requires_grad_(True)
    gt = torch.tensor(gamma, requires_grad=True)
    bt = torch.tensor(beta, requires_grad=True)
    dx, dg, db = torch.autograd.grad(tnorm.layer_norm_relu(xt, gt, bt), [xt, gt, bt], gb)
    assert dx.dtype == torch.bfloat16 and dg.dtype == torch.float32
    ulp = 2.0**-7 * np.abs(want_dx).max()
    np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=ulp)
    np.testing.assert_allclose(dg.numpy(), want_dg, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(db.numpy(), want_db, rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def conv_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 128, 64)).astype(np.float32)
    w_hwio = (rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(1, 16, 128, 64)).astype(np.float32)
    return x, w_hwio, b, g


def test_conv3x3_grads_match_jax(conv_inputs):
    x, w_hwio, b, g = conv_inputs
    want_y, vjp = jax.vjp(jconv.conv3x3_same, jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b))
    want_dx, want_dw, want_db = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    w_oihw = np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))
    got_y, (dx, dw, db) = _torch_grads(tconv.conv3x3_same, (x, w_oihw, b), torch.from_numpy(g))
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y), atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=2e-4)
    np.testing.assert_allclose(dw.numpy(), want_dw.transpose(3, 2, 0, 1), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), want_db, rtol=1e-4)
    assert np.abs(want_dw).max() > 1.0


def test_conv3x3_without_bias_has_no_bias_grad(conv_inputs):
    x, w_hwio, _, g = conv_inputs
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)), requires_grad=True)
    y = tconv.conv3x3_same(xt, wt, None)
    dx, dw = torch.autograd.grad(y, [xt, wt], torch.from_numpy(g))
    want = torch.nn.functional.conv2d(xt.detach().permute(0, 3, 1, 2), wt.detach(), padding=1)
    np.testing.assert_allclose(y.detach().numpy(), want.permute(0, 2, 3, 1).numpy(), atol=1e-4)
    assert dx.shape == xt.shape and dw.shape == wt.shape


def _within_bf16_ulp(got: torch.Tensor, want: np.ndarray, atol: float = 1e-5) -> None:
    """|got - want| <= one bf16 ulp (2^-7 relative to |want|) + ``atol``."""
    err = np.abs(got.detach().float().numpy() - want)
    assert np.all(err <= 2.0**-7 * np.abs(want) + atol), (err - 2.0**-7 * np.abs(want)).max()


def _bf16_case(conv_inputs, halo):
    """bf16 x (H + 2 rows in the halo-row mode) and cotangent, float32 OIHW
    weight and bias, from the module's seeded inputs."""
    x, w_hwio, b, g = conv_inputs
    xb = torch.from_numpy(x).to(torch.bfloat16)
    if halo:
        xb = torch.nn.functional.pad(xb, (0, 0, 0, 0, 1, 1), value=0.5)
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    return xb, w, torch.from_numpy(b), torch.from_numpy(g).to(torch.bfloat16)


@pytest.mark.parametrize("halo", [0, 1])
def test_conv3x3_takes_float32_parameters_as_a_cast_would(conv_inputs, halo):
    """The model hands K2 its float32 weight and bias uncast with bf16
    activations. Output and gradients must be what they were through
    parameters cast to bf16 by the caller (autograd's cast rounding dw and db
    to bf16 and widening them back): tolerance 0, bit for bit, on the CPU
    path (the plain version forward, the Function's backward)."""
    fn = tconv.conv3x3_rows if halo else tconv.conv3x3_same
    xb, w, b, g = _bf16_case(conv_inputs, halo)
    leaves = [t.clone().requires_grad_(True) for t in (xb, w, b)]
    y = fn(*leaves)
    got = torch.autograd.grad(y, leaves, g)
    ref = [t.clone().requires_grad_(True) for t in (xb, w, b)]
    y_cast = fn(ref[0], ref[1].to(torch.bfloat16), ref[2].to(torch.bfloat16))
    want = torch.autograd.grad(y_cast, ref, g)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_cast)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    # dw and db hold bf16 values: rounded to the compute type, then widened
    assert torch.equal(got[1], got[1].to(torch.bfloat16).float())
    assert torch.equal(got[2], got[2].to(torch.bfloat16).float())


def test_conv3x3_float32_parameters_match_jax_bf16(conv_inputs):
    """The same route against the reference's custom VJP as flax calls it
    (kernel and bias cast to bf16; Pallas interpreted off the TPU): output,
    dx, dw and db within one bf16 ulp plus 1e-5 (float32 sums in another
    order, rounded to bf16; an output near 0 keeps their float32
    difference, as ``chip_smoke.K2_BF16_ATOL`` says)."""
    _, w_hwio, b, _ = conv_inputs
    xb, w, bt, gb = _bf16_case(conv_inputs, 0)
    leaves = [t.clone().requires_grad_(True) for t in (xb, w, bt)]
    y = tconv.conv3x3_same(*leaves)
    dx, dw, db = torch.autograd.grad(y, leaves, gb)
    bf = jnp.bfloat16
    want_y, vjp = jax.vjp(jconv.conv3x3_same, jnp.asarray(xb.float().numpy()).astype(bf),
                          jnp.asarray(w_hwio).astype(bf), jnp.asarray(b).astype(bf))
    jdx, jdw, jdb = (np.asarray(t, np.float32)
                     for t in vjp(jnp.asarray(gb.float().numpy()).astype(bf)))
    _within_bf16_ulp(y, np.asarray(want_y, np.float32))
    _within_bf16_ulp(dx, jdx)
    _within_bf16_ulp(dw, jdw.transpose(3, 2, 0, 1))
    _within_bf16_ulp(db, jdb)
    assert np.abs(jdw).max() > 1.0


def test_bias_gradient_sums_the_bf16_cotangent_in_float32(conv_inputs):
    """db reads the bf16 cotangent as it is and accumulates in float32
    (``sum(dtype=float32)``, no float32 copy): before its rounding to x's
    type it is within 1e-6 relative of a float64 sum of the same values;
    after it, that float32 sum rounded to bf16, in the bias's dtype."""
    xb, w, _, gb = _bf16_case(conv_inputs, 0)
    g = torch.cat([gb] * 4) * 3.0 + 0.25  # 4 images; a mean away from 0
    x = torch.cat([xb] * 4)
    want = g.double().sum(dim=(0, 1, 2))
    db32 = tconv._bias_grad_f32(g)
    assert db32.dtype == torch.float32
    assert float(((db32.double() - want).abs() / want.abs()).max()) <= 1e-6
    for bias_dtype in (torch.float32, torch.bfloat16):
        db = tconv.conv3x3_same_backward(x, w, g, False, False, True, bias_dtype)[2]
        assert db.dtype == bias_dtype
        assert torch.equal(db, db32.to(torch.bfloat16).to(bias_dtype))


@pytest.mark.parametrize("kernel", ["layer_norm_relu", "conv3x3_same", "conv3x3_rows"])
def test_no_grad_path_equals_the_function_path(conv_inputs, kernel):
    """Where no gradient is wanted (grad mode off, or no input requiring
    one) each wrapper runs its kernel, here its plain version, without the
    autograd Function: the same values, no graph node, no launch counted."""
    if kernel == "layer_norm_relu":
        x, gamma, beta, _ = _norm_inputs((2, 3, 5, 64), seed=5)
        args = [torch.from_numpy(t) for t in (x, gamma, beta)]
        fn = tnorm.layer_norm_relu
    else:
        xb, w, b, _ = _bf16_case(conv_inputs, kernel == "conv3x3_rows")
        args, fn = [xb, w, b], getattr(tconv, kernel)
    counters = lambda: (tnorm.layer_norm_relu.launches, tnorm.layer_norm_relu.backward_launches,  # noqa: E731
                        tconv.conv3x3_same.launches, tconv.conv3x3_rows.launches)
    before = counters()
    with torch.no_grad():
        off = fn(*[t.clone().requires_grad_(True) for t in args])
    plain = fn(*args)
    on = fn(args[0].clone().requires_grad_(True), *args[1:])
    assert off.grad_fn is None and plain.grad_fn is None and on.grad_fn is not None
    assert torch.equal(off, on.detach()) and torch.equal(plain, on.detach())
    assert counters() == before


def test_layer_norm_relu_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, 8, generator=gen, dtype=torch.float64) * 2 + 0.3).requires_grad_(True)
    gamma = (torch.randn(8, generator=gen, dtype=torch.float64) * 0.3 + 1).requires_grad_(True)
    beta = (torch.randn(8, generator=gen, dtype=torch.float64) * 0.3).requires_grad_(True)
    assert torch.autograd.gradcheck(tnorm.layer_norm_relu, (x, gamma, beta))


def test_layer_norm_relu_conv_bias_gradcheck_f64():
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(3, 5, 8, generator=gen, dtype=torch.float64) * 2 + 0.3).requires_grad_(True)
    gamma = (torch.randn(8, generator=gen, dtype=torch.float64) * 0.3 + 1).requires_grad_(True)
    beta = (torch.randn(8, generator=gen, dtype=torch.float64) * 0.3).requires_grad_(True)
    bias = (torch.randn(8, generator=gen, dtype=torch.float64) * 0.5).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x_, g_, b_, c_: tnorm.layer_norm_relu(x_, g_, b_, 1e-3, c_), (x, gamma, beta, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(96, 64), (2, 3, 5, 16), (3, 8, 512)])
def test_layer_norm_relu_conv_bias_grads_match_the_unfused_composition(dtype, shape):
    """(dx, dgamma, dbeta, dbias) of K1 with a conv's float32 bias against
    autograd through the composition it replaces: the bias cast to x's type
    and added, then K1 without one. The output, dx, dgamma and dbeta are
    the same operations, so equal bit for bit; dbias is dx summed in float32
    and rounded to x's type, as the add's and the cast's backward give it:
    within 1e-6 relative of its largest (float32), one bf16 ulp (bf16)."""
    x, gamma, beta, g = _norm_inputs(shape, seed=shape[-1] + 2)
    cb = np.random.default_rng(shape[-1]).normal(size=shape[-1]).astype(np.float32)

    def leaves():
        return (torch.from_numpy(x).to(dtype).requires_grad_(True),
                *(torch.tensor(t, requires_grad=True) for t in (gamma, beta, cb)))

    gt = torch.from_numpy(g).to(dtype)
    xa, ga, ba, ca = leaves()
    fused = tnorm.layer_norm_relu(xa, ga, ba, 1e-3, ca)
    got = torch.autograd.grad(fused, [xa, ga, ba, ca], gt)
    xb, gb, bb, cbb = leaves()
    unfused = tnorm.layer_norm_relu(xb + cbb.to(dtype), gb, bb)
    want = torch.autograd.grad(unfused, [xb, gb, bb, cbb], gt)
    assert torch.equal(fused, unfused)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[3].dtype == torch.float32 and float(got[3].abs().max()) > 0.1
    rel = 1e-6 if dtype == torch.float32 else 2.0**-7
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(),
                               atol=rel * float(want[3].abs().max()))


@pytest.mark.parametrize("cin, features, size", [(3, 16, 24), (32, 64, 128), (32, 128, 16)])
def test_conv_block_takes_the_library_conv_bias_into_k1(monkeypatch, cin, features, size):
    """A LayerNorm ``ConvBlock`` runs its library convs without their bias
    and hands it to K1 (K2, which takes the 64 -> 64 conv at 128 px, keeps
    its own): the same output as each conv with its bias and then K1, bit
    for bit in float32, and the same parameter gradients (the conv biases'
    within 1e-5 relative: sums in another order)."""
    from torch.nn import functional as F

    from adunet_torch.nn.blocks import ConvBlock, init_parameters

    blk = ConvBlock(cin, features)
    init_parameters(blk, 3)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(4)
        for p in blk.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn(2, size, size, cin, generator=torch.Generator().manual_seed(5))
    g = torch.randn(2, size, size, features, generator=torch.Generator().manual_seed(6))
    params = list(blk.parameters())

    biases, conv2d = [], F.conv2d

    def recording_conv2d(*args, **kwargs):
        biases.append(args[2] if len(args) > 2 else kwargs.get("bias"))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", recording_conv2d)
    got = blk(x)
    got_grads = torch.autograd.grad(got, params, g)
    assert biases and all(b is None for b in biases)
    library = len(biases)
    monkeypatch.setattr(F, "conv2d", conv2d)

    want = x
    for i in range(2):
        want = getattr(blk, f"norm{i}")(getattr(blk, f"conv{i}")(want))
    want_grads = torch.autograd.grad(want, params, g)
    assert library == (1 if (features, size) == (64, 128) else 2)
    assert torch.equal(got, want)
    for (name, _), a, b in zip(blk.named_parameters(), got_grads, want_grads):
        if name.endswith("conv0.bias") or name.endswith("conv1.bias"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()), err_msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("route", ["k2", "library", "export"])
def test_conv_block_hands_k1_the_bias_its_conv_left_out(monkeypatch, route):
    """``Conv`` decides the hand-off (``hand_off_bias``): at a K2 shape (C 64,
    H % 8 = 0, W % 128 = 0) the conv keeps its bias and K1 gets none; at a
    library shape the library conv runs without it and K1 gets it, cast to
    x's type; while exporting the conv keeps it, and the program's graph
    holds the biased convs and K1's op, as the served programs do."""
    from torch.nn import functional as F

    from adunet_torch.export.program import node_counts
    from adunet_torch.nn import blocks

    cin, shape = (64, (1, 16, 128, 64)) if route == "k2" else (3, (1, 8, 8, 3))
    blk = blocks.ConvBlock(cin, 64 if route == "k2" else 8)
    blocks.init_parameters(blk, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    handed, convs = [], []
    k1, k2, conv2d = blocks.layer_norm_relu, blocks.conv3x3_same, F.conv2d

    def recording_k1(x, gamma, beta, eps, conv_bias):
        handed.append(conv_bias)
        return k1(x, gamma, beta, eps, conv_bias)

    def recording_k2(x, w, bias):
        convs.append(("k2", bias))
        return k2(x, w, bias)

    def recording_conv2d(*args, **kwargs):
        convs.append(("library", args[2] if len(args) > 2 else kwargs.get("bias")))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(blocks, "layer_norm_relu", recording_k1)
    monkeypatch.setattr(blocks, "conv3x3_same", recording_k2)
    monkeypatch.setattr(F, "conv2d", recording_conv2d)
    if route == "export":
        counts = node_counts(torch.export.export(blk.eval(), (x,), strict=False))
        assert counts["adunet_torch.layer_norm_relu.default"] == 2, counts
        assert counts["aten.conv2d.default"] == 2, counts
    else:
        blk(x)
    assert len(handed) == len(convs) == 2
    kind = "k2" if route == "k2" else "library"
    for conv, bias, (ran, kept) in zip((blk.conv0, blk.conv1), handed, convs):
        assert ran == kind
        if route == "library":
            assert kept is None and bias.dtype == x.dtype and torch.equal(bias, conv.bias)
        else:
            assert bias is None and kept is not None


@pytest.mark.parametrize("cin, features", [(64, 128), (128, 64)])
def test_f32_conv_block_gradient_reaches_the_library_backward(monkeypatch, cin, features):
    """K3 runs only where no gradient is wanted: a float32 ``ConvBlock`` at
    channel counts K3 takes sends both convs to K3 under ``no_grad``, and
    with a gradient to ``F.conv2d``, whose backward node
    (``aten.convolution_backward``) the graph reaches; both outputs agree."""
    from adunet_torch.nn import blocks

    blk = blocks.ConvBlock(cin, features)
    blocks.init_parameters(blk, 3)
    x = torch.randn(2, 6, 10, cin, generator=torch.Generator().manual_seed(5))
    taken, k3 = [], blocks.conv3x3_f32
    monkeypatch.setattr(blocks, "conv3x3_f32", lambda *a: taken.append(1) or k3(*a))
    with torch.no_grad():
        want = blk(x)
    assert len(taken) == 2
    taken.clear()
    y = blk(x)
    assert not taken
    seen, stack = {}, [y.grad_fn]  # every node of the backward graph, by identity
    while stack:
        node = stack.pop()
        if node is not None and id(node) not in seen:
            seen[id(node)] = type(node).__name__
            stack.extend(n for n, _ in node.next_functions)
    assert list(seen.values()).count("ConvolutionBackward0") == 2, seen
    grads = torch.autograd.grad(y.sum(), list(blk.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), atol=1e-5)


def test_conv3x3_gradcheck_f64():
    """The Function's backward formula at a small shape (the gate is the
    public wrapper's; the Function itself takes any 3x3 conv on the CPU)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 5, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn(2, 3, 3, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    b = torch.randn(2, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(tconv._Conv3x3Same.apply, (x, w, b))


def test_backward_keeps_input_dtypes():
    x = torch.randn(1, 16, 128, 64, dtype=torch.bfloat16, requires_grad=True)
    w = (torch.randn(64, 64, 3, 3) * 0.05).to(torch.bfloat16).requires_grad_(True)
    b = torch.zeros(64, dtype=torch.bfloat16, requires_grad=True)
    dx, dw, db = torch.autograd.grad(tconv.conv3x3_same(x, w, b).float().sum(), [x, w, b])
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16,) * 3
    assert torch.allclose(db.float(), torch.full((64,), 16 * 128.0))


def test_clipped_residual_add_splits_ties_like_jax():
    """An input pixel at exactly 0 or 1 with a zero residual (an untrained
    model's output) passes half the gradient, as ``jnp.clip`` does."""
    from adunet.ops import clipped_residual_add as jax_clip_add
    from adunet_torch.ops import clipped_residual_add

    x = np.array([0.0, 1.0, 0.5], np.float32)
    want = jax.grad(lambda r: jnp.sum(jax_clip_add(jnp.asarray(x), r)))(jnp.zeros(3, jnp.float32))
    r = torch.zeros(3, requires_grad=True)
    clipped_residual_add(torch.from_numpy(x), r).sum().backward()
    np.testing.assert_array_equal(r.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(r.grad.numpy(), [0.5, 0.5, 1.0])
    # forward values are a plain clamp's
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))
    assert torch.equal(clipped_residual_add(v, v * 0.5), torch.clamp(v + v * 0.5, 0.0, 1.0))


# K2's backward on the CPU is its plain version (the kernels' arithmetic with
# explicit taps). Tolerances: against the reference's custom VJP, float32
# 2e-4 absolute on dx / dw and 1e-4 relative on db (as above); against the
# route the port took before its kernels (aten.convolution_backward) and
# between the two modes, float64 at 1e-10 (the same sums in another order).

def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("with_bias", [True, False])
def test_conv3x3_backward_plain_matches_jax_vjp(conv_inputs, with_bias):
    x, w_hwio, b, g = conv_inputs
    bias = jnp.asarray(b if with_bias else np.zeros_like(b))
    _, vjp = jax.vjp(jconv.conv3x3_same, jnp.asarray(x), jnp.asarray(w_hwio), bias)
    want_dx, want_dw, want_db = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dx, dw, db = tconv.conv3x3_same_backward_plain(
        torch.from_numpy(x), _oihw(w_hwio), torch.from_numpy(g), need_db=with_bias,
        bias_dtype=torch.float32 if with_bias else None)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=2e-4)
    np.testing.assert_allclose(dw.numpy(), want_dw.transpose(3, 2, 0, 1), atol=2e-4)
    if with_bias:
        np.testing.assert_allclose(db.numpy(), want_db, rtol=1e-4)
    else:
        assert db is None


def _f64_case(seed, halo):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, 16 + 2 * halo, 128, 64)))
    w = torch.from_numpy(rng.normal(size=(64, 64, 3, 3)) * 0.05)
    g = torch.from_numpy(rng.normal(size=(2, 16, 128, 64)))
    return x, w, g


@pytest.mark.parametrize("halo", [0, 1])
def test_conv3x3_backward_plain_matches_the_library_route_f64(halo):
    """In float64 the plain backward equals cuDNN's formulation, which the
    port ran before its kernels (here on the CPU: aten.convolution_backward
    on the NCHW views, padding (1 - halo, 1))."""
    x, w, g = _f64_case(11 + halo, halo)
    dx, dw, db = tconv.conv3x3_same_backward_plain(x, w, g, pad_h=1 - halo)
    ldx, ldw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1], [1 - halo, 1], [1, 1],
        False, [0, 0], 1, [True, True, False])
    assert dx.shape == x.shape and dw.shape == w.shape and db.dtype == torch.float64
    torch.testing.assert_close(dx, ldx.permute(0, 2, 3, 1), atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(dw, ldw, atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(db, g.sum(dim=(0, 1, 2)), atol=1e-10, rtol=1e-10)


def test_conv3x3_rows_backward_is_the_same_backward_of_the_whole_rows():
    """The halo-row conv of x's H + 2 rows is rows 1..H of the SAME conv of
    those rows, so its backward is the SAME backward with the cotangent
    zero-padded by a row above and below: dx on all H + 2 rows, dw, db."""
    x, w, g = _f64_case(13, 1)
    halo = tconv.conv3x3_same_backward_plain(x, w, g, pad_h=0)
    same = tconv.conv3x3_same_backward_plain(x, w, torch.nn.functional.pad(g, (0, 0, 0, 0, 1, 1)))
    for a, b in zip(halo, same):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("need", [(True, False, False), (False, True, False), (False, False, True),
                                  (True, True, False), (False, True, True), (True, False, True)])
def test_conv3x3_backward_computes_only_what_is_asked(conv_inputs, need):
    """autograd asks for dx without dw and dw without dx: each entry not
    asked for is None, each asked for is what the full backward returns."""
    xb, w, _, gb = _bf16_case(conv_inputs, 0)
    full = tconv.conv3x3_same_backward(xb, w, gb)
    got = tconv.conv3x3_same_backward(xb, w, gb, *need)
    for asked, a, f in zip(need, got, full):
        assert (a is not None) == asked
        if asked:
            assert torch.equal(a, f)


def test_conv3x3_rows_gradcheck_f64():
    """The halo-row Function's backward formula (dx on all H + 2 rows)
    against finite differences at a small shape."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 6, 5, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn(2, 3, 3, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    b = torch.randn(2, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(tconv._Conv3x3Rows.apply, (x, w, b))
