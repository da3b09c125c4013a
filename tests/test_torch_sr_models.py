"""The port's deep-config remat, vanilla SR U-Net and VGG19 tower against the
JAX reference on the CPU.

Params are perturbed first (``perturb_params``; the BatchNorm statistics by
hand) and converted with ``state_dict_from_flax``. Tolerances: forwards
atol 1e-5 (float32 in two frameworks, other summation orders); BatchNorm
running statistics after one training forward rtol 1e-5 / atol 1e-6; the
VGG19 features 1e-4 of their largest magnitude (caffe inputs reach ±150,
and 16 float32 convolutions sum in another order); the port's gradients
with and without remat 1e-6 of each gradient's largest magnitude (the
recompute runs the same float32 operations).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.losses.perceptual import VGG19Features as JaxVGG19Features
from adunet.losses.perceptual import load_vgg19_params as jax_load_vgg19_params
from adunet.models import VanillaSRUNet as JaxVanillaSRUNet
from adunet.models import build_super_resolution_unet as build_jax
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.kernels import fused_norm
from adunet_torch.losses import VGG19Features, load_vgg19_params, make_perceptual_fn
from adunet_torch.models import build_super_resolution_unet, build_vanilla_sr_unet

torch.set_num_threads(4)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def _adaptive(perturb_params, depth, **remat):
    jmodel, _ = build_jax(0.5, base_channels=8, residual_head_channels=8, depth_override=depth,
                          input_size=32, **remat)
    params = perturb_params(jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])
    tmodel, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                            depth_override=depth, device="cpu", **remat)
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("remat", [dict(remat=True), dict(remat_levels=1), dict(remat_levels=0)])
def test_remat_forward_matches_the_references_remat_model(remat, perturb_params):
    jmodel, params, tmodel = _adaptive(perturb_params, 2, **remat)
    x = _images(2, 32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    got = tmodel(torch.from_numpy(x))  # with grad enabled: the checkpointed path
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def _grads(model, x):
    model.zero_grad(set_to_none=True)
    out = model(x)
    (out.square().mean() + out.mean()).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", [dict(remat=True), dict(remat_levels=1), dict(remat_levels=2)])
def test_remat_gradients_equal_the_stored_gradients(remat, perturb_params):
    _, params, plain = _adaptive(perturb_params, 2)
    _, _, rematted = _adaptive(perturb_params, 2, **remat)
    x = torch.from_numpy(_images(2, 32, seed=1))
    want, got = _grads(plain, x), _grads(rematted, x)
    for name, g in want.items():
        scale = float(g.abs().max())
        assert scale > 0, name
        assert float((got[name] - g).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("depth, levels", [(3, 2), (2, None)])
def test_remat_recomputes_the_checkpointed_levels_k1(depth, levels, perturb_params, monkeypatch):
    """K1's forward runs again in the backward for each LN+ReLU pair of the
    checkpointed blocks (2 per block; enc and dec of each level below
    ``remat_levels``, every block with ``remat=True``); its backward runs
    once per pair. The card's launch counts follow the same path."""
    remat = dict(remat_levels=levels) if levels is not None else dict(remat=True)
    _, _, model = _adaptive(perturb_params, depth, **remat)
    calls = {"fwd": 0, "bwd": 0}
    plain, backward = fused_norm.layer_norm_relu_plain, fused_norm.layer_norm_relu_backward
    monkeypatch.setattr(fused_norm, "layer_norm_relu_plain",
                        lambda *a: calls.__setitem__("fwd", calls["fwd"] + 1) or plain(*a))
    monkeypatch.setattr(fused_norm, "layer_norm_relu_backward",
                        lambda *a: calls.__setitem__("bwd", calls["bwd"] + 1) or backward(*a))
    _grads(model, torch.from_numpy(_images(1, 32)))
    pairs = 2 * (2 * depth + 2)
    recomputed_blocks = 2 * levels if levels is not None else 2 * depth + 2
    assert calls == {"fwd": pairs + 2 * recomputed_blocks, "bwd": pairs}


def _perturb_stats(stats, seed=11):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(stats)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    out = []
    for (path, leaf), k in zip(leaves, keys):
        noise = jax.random.normal(k, leaf.shape, leaf.dtype)
        out.append(leaf * jnp.exp(0.3 * noise) if path[-1].key == "var" else leaf + 0.2 * noise)
    return jax.tree_util.tree_unflatten(treedef, out)


def test_vanilla_param_count_and_names_match_jax_at_full_width():
    shapes = jax.eval_shape(JaxVanillaSRUNet().init, jax.random.key(0), jnp.zeros((1, 256, 256, 3)))
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    port = build_vanilla_sr_unet(device="meta")
    assert sum(p.numel() for p in port.parameters()) == want == 34_525_251
    fake = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert set(state_dict_from_flax(fake["params"], fake["batch_stats"])) == set(port.state_dict())


def vanilla_pair(perturb_params, base=8, depth=2, size=32, seed=0):
    jmodel = JaxVanillaSRUNet(base_channels=base, depth=depth)
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, size, size, 3)))
    params = perturb_params(variables["params"])
    stats = _perturb_stats(variables["batch_stats"])
    tmodel = build_vanilla_sr_unet(base_channels=base, depth=depth, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(params), jax.device_get(stats)))
    return jmodel, params, stats, tmodel


def test_vanilla_forward_and_running_update_match_jax(perturb_params):
    jmodel, params, stats, tmodel = vanilla_pair(perturb_params)
    x = _images(3, 32, seed=2)
    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))
    want_eval = apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    tmodel.eval()
    with torch.no_grad():
        got_eval = tmodel(torch.from_numpy(x))
    assert got_eval.dtype == torch.float32 and got_eval.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=1e-5)
    want_train, mutated = apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=True, mutable=("batch_stats",))
    tmodel.train()
    with torch.no_grad():
        got_train = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=1e-5)
    assert float(np.abs(np.asarray(want_train) - np.asarray(want_eval)).max()) > 1e-3
    want_sd = state_dict_from_flax(jax.device_get(params), jax.device_get(mutated["batch_stats"]))
    moved = 0
    for name, value in want_sd.items():
        if "running" in name:
            np.testing.assert_allclose(tmodel.state_dict()[name].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            moved += 1
    assert moved == 4 * (2 * 2 + 1)


def _vgg_params(seed=3):
    variables = JaxVGG19Features().init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))
    return jax.device_get(variables["params"])


def test_vgg19_features_match_jax_on_converted_params():
    params = _vgg_params()
    x = _images(2, 32, seed=4)
    want = np.asarray(JaxVGG19Features().apply({"params": params}, jnp.asarray(x)))
    tower = VGG19Features()
    tower.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 512) and float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()))


def test_load_vgg19_params_reads_the_npz_layout(tmp_path):
    params = _vgg_params(seed=5)
    flat = {f"{name}/{leaf}": np.asarray(v) for name, layer in params.items()
            for leaf, v in layer.items()}
    np.savez(tmp_path / "vgg.npz", **flat)
    want_vars = jax_load_vgg19_params(tmp_path / "vgg.npz")
    sd = load_vgg19_params(tmp_path / "vgg.npz")
    assert set(sd) == set(VGG19Features().state_dict())
    assert sd["block1_conv1.weight"].shape == (64, 3, 3, 3)
    fn = make_perceptual_fn(tmp_path / "vgg.npz", device="cpu")
    assert not any(p.requires_grad for p in fn.module.parameters())
    x = _images(1, 32, seed=6)
    want = np.asarray(JaxVGG19Features().apply(want_vars, jnp.asarray(x)))
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                               atol=1e-4 * float(np.abs(want).max()))


def test_seeded_vgg_init_is_flax_shaped_and_repeatable():
    a = make_perceptual_fn(None, device="cpu").module
    b = make_perceptual_fn(None, device="cpu").module
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.block3_conv1.weight
    std = (1.0 / (w.shape[1] * 9)) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2.0 * std / 0.8796256 + 1e-6
    assert float(a.block3_conv1.bias.abs().max()) == 0.0
