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


def test_layer_norm_relu_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, 8, generator=gen, dtype=torch.float64) * 2 + 0.3).requires_grad_(True)
    gamma = (torch.randn(8, generator=gen, dtype=torch.float64) * 0.3 + 1).requires_grad_(True)
    beta = (torch.randn(8, generator=gen, dtype=torch.float64) * 0.3).requires_grad_(True)
    assert torch.autograd.gradcheck(tnorm.layer_norm_relu, (x, gamma, beta))


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
