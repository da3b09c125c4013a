"""The port's ``combined`` SR loss and the vanilla SR train / val steps
against the JAX reference on the CPU.

Both perceptual terms read the same VGG19 weights from an ``.npz`` (without
one the two packages draw different random weights). Tolerances: the loss
1e-5 relative; its gradient with respect to the prediction 1e-4 of the
largest |gradient| (float32 convolutions summed in another order), a
prediction holding pixels exactly at 0 and 1, where the clip passes half the
gradient; three Adam steps of the vanilla model rtol 5e-3 / atol 5e-4 on
the losses, PSNRs, parameters and running statistics, as for the adaptive
model's steps (``tests/test_torch_train.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.losses import build_losses_and_metrics as jax_losses
from adunet.losses import make_perceptual_fn as jax_perceptual
from adunet.losses.perceptual import VGG19Features as JaxVGG19Features
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet.train import make_vanilla_sr_train_step as jax_vanilla_step
from adunet.train import make_vanilla_sr_val_step as jax_vanilla_val
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.losses import build_losses_and_metrics, make_perceptual_fn
from adunet_torch.train import (
    create_train_state,
    make_optimizer,
    make_vanilla_sr_train_step,
    make_vanilla_sr_val_step,
)
from tests.test_torch_sr_models import vanilla_pair

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    params = jax.device_get(JaxVGG19Features().init(jax.random.key(8),
                                                    jnp.zeros((1, 32, 32, 3)))["params"])
    path = tmp_path_factory.mktemp("vgg") / "vgg19.npz"
    np.savez(path, **{f"{name}/{leaf}": np.asarray(v) for name, layer in params.items()
                      for leaf, v in layer.items()})
    return path


def _losses(vgg_npz):
    jloss, _ = jax_losses("combined", perceptual_fn=jax_perceptual(vgg_npz, input_size=32))
    tloss, _ = build_losses_and_metrics("combined",
                                        perceptual_fn=make_perceptual_fn(vgg_npz, device="cpu"))
    return jloss, tloss


def test_combined_loss_value_and_gradient_match_jax(vgg_npz):
    rng = np.random.default_rng(0)
    y_true = rng.random((2, 32, 32, 3), dtype=np.float32)
    y_pred = np.clip(y_true + 0.1 * rng.normal(size=y_true.shape), -0.2, 1.2).astype(np.float32)
    y_pred[0, :4, :4] = 0.0  # ties of the clip: half the gradient passes
    y_pred[1, -4:, -4:] = 1.0
    jloss, tloss = _losses(vgg_npz)
    want, want_g = jax.value_and_grad(lambda p: jloss(jnp.asarray(y_true), p))(jnp.asarray(y_pred))
    pred = torch.from_numpy(y_pred).requires_grad_(True)
    got = tloss(torch.from_numpy(y_true), pred)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    want_g = np.asarray(want_g)
    scale = float(np.abs(want_g).max())
    np.testing.assert_allclose(pred.grad.numpy(), want_g, atol=1e-4 * scale)

    # the tolerance sees the ties: torch.clamp's full gradient there would fail it
    from adunet_torch.losses.sr import mse_loss, ssim_loss

    fn = make_perceptual_fn(vgg_npz, device="cpu")
    clamp_pred = torch.from_numpy(y_pred).requires_grad_(True)
    clamped = (mse_loss(torch.from_numpy(y_true), clamp_pred)
               + 0.1 * ssim_loss(torch.from_numpy(y_true), clamp_pred)
               + 0.01 * torch.mean(torch.square(fn(torch.from_numpy(y_true))
                                                - fn(torch.clamp(clamp_pred, 0.0, 1.0)))))
    clamped.backward()
    assert float(np.abs(clamp_pred.grad.numpy() - want_g).max()) > 1e-3 * scale


@pytest.mark.parametrize("loss_name", ["charbonnier", "combined"])
def test_vanilla_adam_steps_match_jax(loss_name, vgg_npz, perturb_params):
    steps, lr = 3, 1e-4
    jmodel, params, stats, tmodel = vanilla_pair(perturb_params, seed=1)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, 32, 32, 3)), jax_optimizer(lr))
    jstate = jstate.replace(params=params, batch_stats=stats)
    tstate = create_train_state(tmodel, make_optimizer(tmodel.parameters(), lr))
    if loss_name == "combined":
        jloss, tloss = _losses(vgg_npz)
    else:
        jloss, _ = jax_losses(loss_name)
        tloss, _ = build_losses_and_metrics(loss_name)
    jstep = jax_vanilla_step(jmodel, jloss, donate=False)
    tstep = make_vanilla_sr_train_step(tmodel, tloss)
    rng = np.random.default_rng(3)
    hr = rng.random((steps, 2, 32, 32, 3), dtype=np.float32)
    lr_imgs = np.clip(hr + 0.05 * rng.normal(size=hr.shape), 0, 1).astype(np.float32)
    jm, tm = [], []
    for i in range(steps):
        jstate, m = jstep(jstate, (jnp.asarray(lr_imgs[i]), jnp.asarray(hr[i])), None)
        jm.append([float(m["loss"]), float(m["psnr"])])
        tstate, m = tstep(tstate, (lr_imgs[i], hr[i]))
        tm.append([float(m["loss"]), float(m["psnr"])])
    np.testing.assert_allclose(tm, jm, rtol=5e-3, atol=5e-4)
    want = state_dict_from_flax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    got = tmodel.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=5e-3, atol=5e-4,
                                   err_msg=name)
    assert tstate.step == steps

    # validation with the running statistics, per sample and as batch means
    batch = (lr_imgs[0], hr[0])
    jval = jax_vanilla_val(jmodel, jloss, per_sample=True)(jstate, tuple(map(jnp.asarray, batch)))
    tval = make_vanilla_sr_val_step(tmodel, tloss, per_sample=True)(tstate, batch)
    assert not tmodel.training
    for key in ("loss", "psnr"):
        np.testing.assert_allclose(tval[key].numpy(), np.asarray(jval[key]), rtol=5e-3, atol=5e-4)
    mean = make_vanilla_sr_val_step(tmodel, tloss)(tstate, batch)
    np.testing.assert_allclose(float(mean["psnr"]), float(tval["psnr"].mean()), rtol=1e-6)
