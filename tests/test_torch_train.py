"""The port's SR train step, optimizer and device cache against the reference.

Parity: the same perturbed params (``perturb_params``: a fresh SR model is
the identity and its upstream gradients are exactly zero) and the same HR
batches go through K Adam steps of ``adunet.train.make_sr_train_step`` and
of the port's. Tolerance rtol 5e-3 / atol 5e-4 on the losses, PSNRs and
parameters, as ``tests/test_model_parity_tf.py:336`` sets it for float32
training on two frameworks: the float32 gradients differ in the last bits
(other summation orders), and Adam's first updates are ~lr * sign(grad).
Port-only identities (``grad_accum``, per-sample validation) hold to
rtol 1e-5 / atol 5e-6 (float32 summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adunet.losses import build_losses_and_metrics as jax_losses
from adunet.models import build_super_resolution_unet as build_jax
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet.train import make_sr_train_step as jax_train_step
from adunet.train.schedules import cosine_decay_schedule as jax_cosine
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.data import sample_patch_batch
from adunet_torch.kernels import conv64
from adunet_torch.losses import build_losses_and_metrics
from adunet_torch.models import build_super_resolution_unet as build_torch
from adunet_torch.train import (
    create_train_state,
    make_optimizer,
    make_sr_device_cache_train_step,
    make_sr_train_step,
    make_sr_val_step,
)

torch.set_num_threads(4)


def _hr_batches(k, n, size, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.random((k, n, size // 4, size // 4, 3), dtype=np.float32)
    smooth = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3)
    return np.clip(smooth + 0.05 * rng.normal(size=smooth.shape), 0, 1).astype(np.float32)


def _pair(depth, base, size, perturb_params, lr):
    jmodel, _ = build_jax(0.5, base_channels=base, residual_head_channels=base,
                          depth_override=depth, input_size=size)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, size, size, 3)), jax_optimizer(lr))
    jstate = jstate.replace(params=perturb_params(jstate.params))
    tmodel, _ = build_torch(0.5, base_channels=base, residual_head_channels=base,
                            depth_override=depth, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(jstate.params)))
    tstate = create_train_state(tmodel, make_optimizer(tmodel.parameters(), lr))
    return jmodel, jstate, tmodel, tstate


@pytest.mark.parametrize("depth, base, size, batch, k2_per_step", [
    (1, 8, 32, 4, 0),
    (1, 64, 128, 2, 8),  # K2's gate fires: enc0.conv1, dec0.conv1, head.conv0/1, fwd + bwd
])
def test_adam_steps_match_jax(depth, base, size, batch, k2_per_step, perturb_params, monkeypatch):
    steps, lr = 3, 1e-4
    jmodel, jstate, tmodel, tstate = _pair(depth, base, size, perturb_params, lr)
    jloss, _ = jax_losses("charbonnier")
    tloss, _ = build_losses_and_metrics("charbonnier")
    jstep = jax_train_step(jmodel, jloss, donate=False)
    tstep = make_sr_train_step(tmodel, tloss)

    plain_calls = []
    monkeypatch.setattr(conv64, "conv3x3_same_plain",
                        lambda *a, f=conv64.conv3x3_same_plain: plain_calls.append(1) or f(*a))
    hr = _hr_batches(steps, batch, size)
    jm, tm = [], []
    for i in range(steps):
        jstate, m = jstep(jstate, jnp.asarray(hr[i]), None)
        jm.append([float(m["loss"]), float(m["psnr"])])
        tstate, m = tstep(tstate, hr[i])
        tm.append([float(m["loss"]), float(m["psnr"])])
    assert len(plain_calls) == steps * k2_per_step // 2  # forward launches only
    np.testing.assert_allclose(tm, jm, rtol=5e-3, atol=5e-4)
    assert tm[-1][0] < tm[0][0]  # it trains
    want = state_dict_from_flax(jax.device_get(jstate.params))
    got = tmodel.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=5e-3, atol=5e-4,
                                   err_msg=name)
    assert tstate.step == steps


def _tiny(seed=0):
    model, _ = build_torch(0.5, base_channels=8, residual_head_channels=8, depth_override=1,
                           device="cpu", seed=seed)
    with torch.no_grad():  # break the identity start
        gen = torch.Generator().manual_seed(5)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def _params_close(a, b):
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=5e-5, atol=5e-6, err_msg=name)


def test_grad_accum_matches_full_batch_step():
    loss_fn, _ = build_losses_and_metrics("charbonnier")
    hr = _hr_batches(1, 8, 32)[0]
    states = []
    for k in (1, 4):
        model = _tiny()
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
        state, m = make_sr_train_step(model, loss_fn, grad_accum=k)(state, hr)
        states.append((state, {n: float(v) for n, v in m.items()}))
    (s1, m1), (s4, m4) = states
    for key in ("loss", "psnr"):
        np.testing.assert_allclose(m4[key], m1[key], rtol=1e-5)
    _params_close(s4.model, s1.model)
    with pytest.raises(ValueError, match="divisible"):
        make_sr_train_step(s1.model, loss_fn, grad_accum=3)(s1, hr)


def test_device_cache_grad_accum_matches_full_batch_step():
    loss_fn, _ = build_losses_and_metrics("charbonnier")
    corpus = torch.from_numpy((np.random.default_rng(3).random((5, 40, 40, 3)) * 255).astype(np.uint8))
    results = []
    for k in (1, 4):
        model = _tiny()
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
        step = make_sr_device_cache_train_step(model, loss_fn, corpus, patch_size=32,
                                               batch_size=8, grad_accum=k)
        state, m = step(state, None, torch.Generator().manual_seed(11))
        results.append((state, float(m["loss"])))
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-5)
    _params_close(results[1][0].model, results[0][0].model)
    with pytest.raises(ValueError, match="divisible"):
        make_sr_device_cache_train_step(results[0][0].model, loss_fn, corpus, patch_size=32,
                                        batch_size=8, grad_accum=3)


def test_per_sample_val_means_equal_batch_values():
    loss_fn, _ = build_losses_and_metrics("charbonnier")
    model = _tiny()
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
    hr = _hr_batches(1, 6, 32, seed=4)[0]
    per = make_sr_val_step(model, loss_fn, per_sample=True)(state, hr)
    batch = make_sr_val_step(model, loss_fn)(state, hr)
    assert per["loss"].shape == (6,) and per["psnr"].shape == (6,)
    np.testing.assert_allclose(float(per["loss"].mean()), float(batch["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(per["psnr"].mean()), float(batch["psnr"]), rtol=1e-5)


def test_uint8_batches_train_like_their_float_values():
    loss_fn, _ = build_losses_and_metrics("charbonnier")
    hr_u8 = (_hr_batches(1, 4, 32)[0] * 255).round().astype(np.uint8)
    out = []
    for batch in (hr_u8, hr_u8.astype(np.float32) / 255.0):
        model = _tiny()
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
        out.append(float(make_sr_train_step(model, loss_fn)(state, batch)[1]["loss"]))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-6)


def test_cosine_schedule_matches_optax():
    """The port's Adam with a cosine schedule takes optax's updates, the k-th
    (from 0) at schedule(k), flat past the end."""
    lr, steps = 1e-2, 7
    g = np.random.default_rng(0).normal(size=(steps, 5)).astype(np.float32)
    p0 = np.linspace(-1, 1, 5).astype(np.float32)

    tx = optax.adam(jax_cosine(lr, decay_steps=4, alpha=0.1), b1=0.9, b2=0.999, eps=1e-7)
    jp, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(jp)
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    state = create_train_state(module, make_optimizer(module.parameters(), lr,
                                                      cosine_decay_steps=4, cosine_alpha=0.1))
    lrs = []
    for i in range(steps):
        updates, opt_state = tx.update(jnp.asarray(g[i]), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        module.w.grad = torch.from_numpy(g[i].copy())
        state.apply_gradients()
        lrs.append(state.optimizer.param_groups[0]["lr"])
        np.testing.assert_allclose(module.w.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lrs, [float(jax_cosine(lr, 4, 0.1)(i)) for i in range(steps)],
                               rtol=1e-6)
    assert lrs[-1] == pytest.approx(0.1 * lr)


def test_optimizer_refuses_schedule_with_injected_lr():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_optimizer(p, 1e-3, cosine_decay_steps=10, inject_lr=True)
    assert make_optimizer(p, 1e-3).defaults["eps"] == 1e-7


def test_sample_patch_batch_shape_range_and_determinism():
    corpus = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 40, 48, 3), dtype=np.uint8))
    a = sample_patch_batch(corpus, torch.Generator().manual_seed(7), 5, 32)
    b = sample_patch_batch(corpus, torch.Generator().manual_seed(7), 5, 32)
    c = sample_patch_batch(corpus, torch.Generator().manual_seed(8), 5, 32)
    assert a.shape == (5, 32, 32, 3) and a.dtype == torch.float32
    assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0
    assert torch.equal(a, b) and not torch.equal(a, c)
    # every patch is a crop of some cached image
    images = corpus.numpy().astype(np.float32) * np.float32(1.0 / 255.0)
    for patch in a.numpy():
        assert any(np.array_equal(patch, img[y:y + 32, x:x + 32])
                   for img in images for y in range(9) for x in range(17))
    with pytest.raises(ValueError, match="does not fit"):
        sample_patch_batch(corpus, torch.Generator(), 1, 41)


def test_training_after_inference_mode_reuses_cached_resize_matrices():
    """A process that serves (inference mode) and then trains reuses the
    cached resize matrices; they must be ordinary tensors."""
    loss_fn, _ = build_losses_and_metrics("charbonnier")
    model = _tiny()
    hr = _hr_batches(1, 2, 44, seed=6)[0]  # a size no other test caches first
    with torch.inference_mode():
        model(torch.from_numpy(hr))
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
    _, metrics = make_sr_train_step(model, loss_fn)(state, hr)
    assert np.isfinite(float(metrics["loss"]))
