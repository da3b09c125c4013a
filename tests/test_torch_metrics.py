"""Parity of the port's quality metrics, SR losses and eval shave with the
JAX reference, on random and on identical images.

Same numpy inputs on both sides; float32. Tolerances: PSNR 1e-4 dB, SSIM /
MS-SSIM / losses 1e-5 (sums over the image in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adunet.evaluate import infer_eval_shave as j_shave
from adunet.losses import sr as jl
from adunet.metrics import psnr_ssim as jm
from adunet_torch.evaluate import infer_eval_shave as t_shave
from adunet_torch.losses import sr as tl
from adunet_torch.metrics import psnr_ssim as tm

torch.set_num_threads(2)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=shape).astype(np.float32), 0, 1)
    return a, b


@pytest.mark.parametrize("shape", [(2, 48, 48, 1), (3, 45, 37, 3), (1, 180, 181, 1)])
def test_psnr_ssim_msssim(shape):
    a, b = _pair(shape, seed=shape[1])
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(tm.psnr(ta, tb).numpy(), np.asarray(jm.psnr(ja, jb)), atol=1e-4)
    np.testing.assert_allclose(tm.ssim(ta, tb).numpy(), np.asarray(jm.ssim(ja, jb)), atol=1e-5)
    pf = jm.msssim_power_factors_for(min(shape[1:3]))
    assert tm.msssim_power_factors_for(min(shape[1:3])) == pf
    np.testing.assert_allclose(tm.ssim_multiscale(ta, tb, power_factors=pf).numpy(),
                               np.asarray(jm.ssim_multiscale(ja, jb, power_factors=pf)), atol=1e-5)


def test_identical_images():
    a, _ = _pair((2, 40, 40, 1), seed=0)
    t = torch.from_numpy(a)
    assert torch.isinf(tm.psnr(t, t)).all() and (tm.psnr(t, t) > 0).all()
    np.testing.assert_allclose(tm.ssim(t, t).numpy(), 1.0, atol=1e-6)
    pf = tm.msssim_power_factors_for(40)
    np.testing.assert_allclose(tm.ssim_multiscale(t, t, power_factors=pf).numpy(), 1.0, atol=1e-6)


def test_downsample_pads_like_numpy_symmetric():
    x = np.random.default_rng(1).random((1, 7, 5, 2), dtype=np.float32)
    np.testing.assert_allclose(tm._downsample_2x(torch.from_numpy(x)).numpy(),
                               np.asarray(jm._downsample_2x(jnp.asarray(x))), atol=1e-7)


@pytest.mark.parametrize("name", ["charbonnier_loss", "l1_loss", "mse_loss", "ssim_loss", "psnr_metric"])
def test_sr_losses(name):
    a, b = _pair((2, 32, 32, 3), seed=5)
    b = b * 1.1 - 0.05  # out-of-range predictions exercise psnr_metric's clip
    got = getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b)).item()
    want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_combined_loss_and_registry():
    a, b = _pair((2, 32, 32, 3), seed=6)
    feats_t = lambda x: x.mean(dim=-1)  # noqa: E731 — any feature map; same on both sides
    feats_j = lambda x: x.mean(axis=-1)  # noqa: E731
    t_loss, t_metrics = tl.build_losses_and_metrics("combined", feats_t)
    j_loss, _ = jl.build_losses_and_metrics("combined", feats_j)
    np.testing.assert_allclose(t_loss(torch.from_numpy(a), torch.from_numpy(b)).item(),
                               float(j_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    assert set(t_metrics) == {"psnr"}
    assert tl.build_losses_and_metrics("Charbonnier")[0] is tl.charbonnier_loss
    with pytest.raises(ValueError):
        tl.build_losses_and_metrics("combined")
    with pytest.raises(ValueError):
        tl.build_losses_and_metrics("huber")


def test_eval_shave():
    for scale in (0.2, 0.3, 0.45, 0.5, 0.9, 0.0, -1.0):
        assert t_shave(scale) == j_shave(scale)
    assert t_shave(0.5, explicit=7) == 7 and t_shave(0.5, explicit=-3) == 0
