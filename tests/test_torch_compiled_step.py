"""The compiled train step (``adunet_torch.train.compiled``) on the CPU.

On the CPU every builder's step runs its body eagerly (a CUDA graph needs a
CUDA model), so these tests hold what surrounds the capture: where the
``graph`` argument resolves, the fit loop's sums over a step that reuses its
output tensors (as a replay does), the schedule and the plateau writing into
a device-tensor rate as into a float one, and 3 steps of the joint trainer
and of the device-cache SR trainer, with a cosine schedule, against the
reference's jitted steps (loss and parameters at 1e-5). The capture itself
is held on the card: ``tests_gpu/test_torch_compiled_step_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.losses import charbonnier_loss as jax_charbonnier
from adunet.losses import make_bce_dice_loss as jax_bce_dice
from adunet.models import build_joint_unet as build_jax_joint
from adunet.models import build_super_resolution_unet as build_jax_sr
from adunet.train import create_train_state as jax_state
from adunet.train import make_joint_train_step as jax_joint_step
from adunet.train import make_optimizer as jax_optimizer
from adunet.train import make_sr_device_cache_train_step as jax_cache_step
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.losses import charbonnier_loss, make_bce_dice_loss
from adunet_torch.models import build_joint_unet, build_super_resolution_unet
from adunet_torch.train import (
    CompiledStep,
    create_train_state,
    fit,
    make_joint_train_step,
    make_optimizer,
    make_seg_train_step,
    make_sr_device_cache_train_step,
    make_sr_train_step,
    make_vanilla_sr_train_step,
)
from adunet_torch.train.loop import _scale_lr
from adunet_torch.train.schedules import cosine_decay_schedule

torch.set_num_threads(4)

_BUILDERS = {
    "sr": lambda model, **kw: make_sr_train_step(model, charbonnier_loss, **kw),
    "sr_device_cache": lambda model, **kw: make_sr_device_cache_train_step(
        model, charbonnier_loss, torch.zeros((1, 8, 8, 3), dtype=torch.uint8), 8, 2, **kw),
    "vanilla_sr": lambda model, **kw: make_vanilla_sr_train_step(model, charbonnier_loss, **kw),
    "seg": lambda model, **kw: make_seg_train_step(model, charbonnier_loss, **kw),
    "joint": lambda model, **kw: make_joint_train_step(model, charbonnier_loss,
                                                       charbonnier_loss, **kw),
}


def _linear_state():
    model = torch.nn.Linear(2, 2)
    return create_train_state(model, make_optimizer(model.parameters(), 1e-3))


@pytest.mark.parametrize("builder", sorted(_BUILDERS))
def test_graph_argument_resolves_to_eager_on_the_cpu(builder):
    state = _linear_state()
    build = _BUILDERS[builder]
    assert build(state.model).captures(state) is False  # None: eager on the CPU
    assert build(state.model, graph=False).captures(state) is False
    with pytest.raises(ValueError, match="graph=True: a CUDA graph needs a model on a CUDA"):
        build(state.model, graph=True)(state, None)
    assert state.step == 0
    state.parallel = object()  # under torchrun or the space mesh
    assert build(state.model).captures(state) is False
    with pytest.raises(ValueError, match="graph=True: across processes"):
        build(state.model, graph=True).captures(state)


def test_fit_sums_a_step_that_reuses_its_output_tensors():
    """A replay writes its metrics into the same tensors every call; the
    epoch's sums must not alias the first step's."""
    out = torch.zeros(())

    def step(state, batch, rng):
        out.fill_(float(batch))
        return state, {"loss": out}

    result = fit(_linear_state(), iter([1.0, 2.0, 3.0, 10.0, 20.0, 30.0]), step,
                 steps_per_epoch=3, epochs=2, samples_per_step=1, verbose=0,
                 restore_best_weights=False)
    assert [h.metrics["loss"] for h in result.history] == [2.0, 20.0]


def test_fit_logs_the_step_mode_once(capsys):
    state = _linear_state()
    step = CompiledStep(lambda s, inputs, rng: {"loss": inputs[0].sum()}, graph=None)
    fit(state, iter([np.ones(2, np.float32)] * 4), step, steps_per_epoch=2, epochs=2)
    printed = capsys.readouterr().out
    assert printed.count("[fit] train step: eager") == 1 and state.step == 4


@pytest.mark.parametrize("form", ["tensor", "float"])
def test_schedule_and_plateau_write_the_rate_in_place(form):
    module = torch.nn.Linear(2, 2)
    lr = 1e-2
    scheduled = make_optimizer(module.parameters(), lr, cosine_decay_steps=4, cosine_alpha=0.1)
    plateau = create_train_state(module, make_optimizer(module.parameters(), lr, inject_lr=True))
    rates = []
    for opt in (scheduled, plateau.optimizer):
        if form == "tensor":  # the form a CUDA model's optimizer has
            for group in opt.param_groups:
                group["lr"] = torch.tensor(lr)
        rates.append(opt.param_groups[0]["lr"])
    schedule = cosine_decay_schedule(lr, 4, 0.1)
    for k in (0, 2, 3, 9):
        scheduled.set_update_count(k)
        got = scheduled.param_groups[0]["lr"]
        want = float(np.float32(schedule(k))) if form == "tensor" else schedule(k)
        assert float(got) == want
        assert (got is rates[0]) == (form == "tensor")
    for want in (5e-3, 2.5e-3):
        assert _scale_lr(plateau, 0.5, 1e-6) == pytest.approx(want, rel=1e-6)
        got = plateau.optimizer.param_groups[0]["lr"]
        assert float(got) == pytest.approx(want, rel=1e-6)
        assert (got is rates[1]) == (form == "tensor")
    assert _scale_lr(plateau, 1e-6, 1e-6) == 1e-6  # the floor


def test_adam_load_keeps_its_rate_form():
    """A checkpoint's rate goes into this optimizer's rate as this optimizer
    holds it: into the same tensor (what a captured update reads), or as a
    float; so the parent's float-rate checkpoints load into a tensor rate."""
    src = torch.nn.Linear(2, 2)
    saved = make_optimizer(src.parameters(), 3e-3)
    src.weight.grad = torch.ones(2, 2)
    src.bias.grad = torch.ones(2)
    saved.step()
    float_sd = saved.state_dict()  # a float rate, as the parent wrote it
    saved.param_groups[0]["lr"] = torch.tensor(4e-3)
    tensor_sd = saved.state_dict()
    for sd, want in ((float_sd, 3e-3), (tensor_sd, 4e-3)):
        for form in ("tensor", "float"):
            dst = make_optimizer(torch.nn.Linear(2, 2).parameters(), 1e-3)
            rate = torch.tensor(1e-3)
            if form == "tensor":
                dst.param_groups[0]["lr"] = rate
            dst.load_state_dict(sd)
            got = dst.param_groups[0]["lr"]
            assert (got is rate) if form == "tensor" else isinstance(got, float)
            assert float(got) == pytest.approx(want, rel=1e-6)
            assert dst.param_groups[0]["capturable"] is False


def _assert_params_close(model, jax_params, flips_within=None):
    """Every parameter at 1e-5. With ``flips_within`` (a bound on Adam's
    total move), up to 0.1 % of the model's elements may differ by more,
    each by less than the bound: Adam's update is ~lr * sign(grad) whatever
    the gradient's size, so a near-zero gradient that the packages' float32
    sums take to the other sign costs up to 2 lr a step (``chip_smoke.py``'s
    card-vs-CPU rule)."""
    want = state_dict_from_flax(jax.device_get(jax_params))
    apart, total = 0, 0
    for name, value in model.state_dict().items():
        got, ref = value.numpy(), want[name].numpy()
        if flips_within is None:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=name)
            continue
        apart += int((np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).sum())
        total += got.size
        assert np.abs(got - ref).max() < flips_within, name
    assert apart <= 1e-3 * total, (apart, total)


_COSINE = dict(cosine_decay_steps=2, cosine_alpha=0.1)


def test_joint_steps_with_a_cosine_schedule_match_jax(perturb_params):
    steps, lr, size = 3, 1e-4, 32  # train_joint's default rate
    jmodel, _ = build_jax_joint(0.5, base_channels=8, residual_head_channels=8,
                                depth_override=2, input_size=size)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, size, size, 3)),
                       jax_optimizer(lr, **_COSINE))
    jstate = jstate.replace(params=perturb_params(jstate.params))
    model, _ = build_joint_unet(0.5, base_channels=8, residual_head_channels=8,
                                depth_override=2, input_size=size, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.device_get(jstate.params)))
    tstate = create_train_state(model, make_optimizer(model.parameters(), lr, **_COSINE))
    jstep = jax_joint_step(jmodel, jax_charbonnier, jax_bce_dice(0.5, 1.0), seg_weight=0.5,
                           donate=False)
    tstep = make_joint_train_step(model, charbonnier_loss, make_bce_dice_loss(0.5, 1.0),
                                  seg_weight=0.5)
    rng = np.random.default_rng(0)
    images = np.repeat(np.repeat(rng.random((steps, 2, size // 4, size // 4, 3), np.float32),
                                 4, axis=2), 4, axis=3)
    masks = (images.mean(-1, keepdims=True) > 0.5).astype(np.float32)
    for i in range(steps):
        jstate, jm = jstep(jstate, (jnp.asarray(images[i]), jnp.asarray(masks[i])), None)
        tstate, tm = tstep(tstate, (images[i], masks[i]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert tstate.step == steps
    # 25 weights of the SR decoder's smooth and conv0 layers end up to 6.6e-5 apart
    _assert_params_close(model, jstate.params, flips_within=2 * lr * steps)


def test_device_cache_steps_with_a_cosine_schedule_match_jax(perturb_params):
    """A one-image corpus the size of a patch: every draw crops the same
    pixels in both packages (their generators cannot agree)."""
    steps, lr, size = 3, 1e-3, 32
    jmodel, _ = build_jax_sr(0.5, base_channels=8, residual_head_channels=8, depth_override=1,
                             input_size=size)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, size, size, 3)),
                       jax_optimizer(lr, **_COSINE))
    jstate = jstate.replace(params=perturb_params(jstate.params))
    model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                           depth_override=1, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.device_get(jstate.params)))
    tstate = create_train_state(model, make_optimizer(model.parameters(), lr, **_COSINE))
    corpus = (np.random.default_rng(1).random((1, size, size, 3)) * 255).astype(np.uint8)
    jstep = jax_cache_step(jmodel, jax_charbonnier, jnp.asarray(corpus), size, 2, donate=False)
    tstep = make_sr_device_cache_train_step(model, charbonnier_loss, torch.from_numpy(corpus),
                                            size, 2)
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        jstate, jm = jstep(jstate, None, jax.random.key(i))
        tstate, tm = tstep(tstate, None, gen)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert tstate.step == steps
    _assert_params_close(model, jstate.params)
