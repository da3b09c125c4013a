"""The port's segmentation U-Nets against the JAX reference on the CPU.

The JAX models' params and ``batch_stats`` are perturbed first
(``perturb_params`` for the params; the statistics by hand, so that the
running mean and variance differ from a fresh init) and converted with
``state_dict_from_flax``; the same numpy batch then runs through both.
Tolerances: forward atol 1e-5 (float32 throughout, convolutions, pools and
the resize summed in another order); BatchNorm running statistics after one
training forward atol 1e-6 / rtol 1e-5 (float32 means over N, H, W in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from adunet.models import build_adaptive_depth_unet as jax_adaptive
from adunet.models import build_unet as jax_vanilla
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.models import build_adaptive_depth_unet, build_unet
from adunet_torch.nn import BatchNorm, ConvTranspose

torch.set_num_threads(4)


def _perturb_stats(stats, seed=11):
    """Running statistics away from init: mean + 0.2 N(0, 1), var x exp(0.3 N(0, 1))."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(stats)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    out = []
    for (path, leaf), k in zip(leaves, keys):
        noise = jax.random.normal(k, leaf.shape, leaf.dtype)
        out.append(leaf * jnp.exp(0.3 * noise) if path[-1].key == "var" else leaf + 0.2 * noise)
    return jax.tree_util.tree_unflatten(treedef, out)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


@pytest.mark.parametrize("build_jax, build_port, kwargs, n_params", [
    (jax_adaptive, build_adaptive_depth_unet, dict(base_channels=64, depth=4), 31_390_721),
    (jax_vanilla, build_unet, dict(base_channels=32, depth=4), 7_765_985),
    (jax_vanilla, build_unet, dict(base_channels=32, depth=4, num_classes=3), 7_766_051),
])
def test_param_counts_match_jax_at_full_width(build_jax, build_port, kwargs, n_params):
    model = build_jax(input_size=256, **kwargs)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 256, 256, 3)))
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    port = build_port(input_size=256, device="meta", **kwargs)
    got = sum(p.numel() for p in port.parameters())
    assert got == want == n_params
    # every flax variable has its state_dict entry, under the converter's name
    if "batch_stats" in shapes:
        fake = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        names = set(state_dict_from_flax(fake["params"], fake["batch_stats"]))
        assert names == set(port.state_dict())


def test_conv_transpose_one_hot_matches_flax():
    """flax's ConvTranspose correlates the dilated input with the kernel
    unflipped: a one-hot input through [[1, 2], [3, 4]] gives [[4, 3], [2, 1]];
    the converted (flipped) weight reproduces it."""
    kernel = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32).reshape(2, 2, 1, 1)
    x = np.zeros((1, 3, 3, 1), np.float32)
    x[0, 1, 1, 0] = 1.0
    layer = fnn.ConvTranspose(1, (2, 2), strides=(2, 2), padding="SAME")
    params = {"kernel": jnp.asarray(kernel), "bias": jnp.zeros((1,))}
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_array_equal(want[0, 2:4, 2:4, 0], [[4.0, 3.0], [2.0, 1.0]])
    assert float(np.abs(want).sum()) == 10.0
    sd = state_dict_from_flax({"dec0_up": params})
    port = ConvTranspose(1, 1)
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, want)


def test_conv_transpose_matches_flax_at_width(perturb_params):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2), padding="SAME")
    params = perturb_params(layer.init(jax.random.key(1), jnp.asarray(x))["params"], scale=0.3)
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    port = ConvTranspose(6, 4)
    port.load_state_dict({k.split(".", 1)[1]: v
                          for k, v in state_dict_from_flax({"dec0_up": params}).items()})
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), want, atol=1e-5)


def _adaptive_pair(depth, base, size, perturb_params):
    jmodel = jax_adaptive(input_size=size, base_channels=base, depth=depth)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, size, size, 3)))
    params = perturb_params(variables["params"])
    stats = _perturb_stats(variables["batch_stats"])
    tmodel = build_adaptive_depth_unet(size, base, depth, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(params), jax.device_get(stats)))
    return jmodel, params, stats, tmodel


@pytest.mark.parametrize("depth, base, size", [(2, 8, 64), (3, 4, 48)])
def test_adaptive_forward_and_running_update_match_jax(depth, base, size, perturb_params):
    jmodel, params, stats, tmodel = _adaptive_pair(depth, base, size, perturb_params)
    x = _images(3, size)
    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))
    # eval mode: the (perturbed) running statistics
    want_eval = apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    tmodel.eval()
    with torch.no_grad():
        got_eval = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=1e-5)
    # train mode: batch statistics, and the running update flax mutates
    want_train, mutated = apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=True, mutable=("batch_stats",))
    tmodel.train()
    with torch.no_grad():
        got_train = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=1e-5)
    assert float(np.abs(np.asarray(want_train) - np.asarray(want_eval)).max()) > 1e-3
    want_sd = state_dict_from_flax(jax.device_get(params), jax.device_get(mutated["batch_stats"]))
    got_sd = tmodel.state_dict()
    moved = 0
    for name, value in want_sd.items():
        if "running" in name:
            np.testing.assert_allclose(got_sd[name].numpy(), value.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            moved += 1
    assert moved == 4 * (2 * depth + 1)


def test_batch_norm_uses_biased_fast_variance_and_flax_momentum():
    """One training forward moves the buffers by 0.01 of the batch's biased
    variance max(0, E[x^2] - E[x]^2), not torch's unbiased one."""
    bn = BatchNorm(2)
    bn.reset_parameters()
    x = torch.tensor([[[[1.0, 0.0]], [[3.0, 0.0]]]])  # (1, 2, 1, 2): channel 0 holds 1, 3
    bn.train()
    y = bn(x)
    assert torch.allclose(bn.running_mean, torch.tensor([0.99 * 0 + 0.01 * 2.0, 0.0]))
    assert torch.allclose(bn.running_var, torch.tensor([0.99 + 0.01 * 1.0, 0.99]))
    assert torch.allclose(y[..., 0].flatten(), torch.tensor([-1.0, 1.0]) / np.sqrt(1.0 + 1e-3))
    assert y.dtype == torch.float32


@pytest.mark.parametrize("num_classes", [1, 3])
def test_vanilla_forward_matches_jax(num_classes, perturb_params):
    size, depth, base = 64, 2, 8
    jmodel = jax_vanilla(size, num_classes=num_classes, base_channels=base, depth=depth)
    params = perturb_params(jmodel.init(jax.random.key(2), jnp.zeros((1, size, size, 3)))["params"])
    tmodel = build_unet(size, num_classes=num_classes, base_channels=base, depth=depth,
                        device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    x = _images(2, size, seed=1)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (2, size, size, num_classes)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if num_classes > 1:
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_models_reach_the_kernels_at_their_gated_shapes():
    """On the CPU the wrappers run their plain versions; the path is the
    same: the protocol model at 256 px sends enc0.conv1 and dec0.conv1 to
    K2 and no LayerNorm to K1; the vanilla model at base 32 sends 18 LN+ReLU
    pairs to K1 and enc1.conv1, dec1.conv1 (64 channels at 128 px) to K2."""
    calls = {"k1": 0, "k2": 0}
    orig = (fused_norm.layer_norm_relu_plain, conv64.conv3x3_same_plain)

    def k1(*a, **k):
        calls["k1"] += 1
        return orig[0](*a, **k)

    def k2(*a, **k):
        calls["k2"] += 1
        return orig[1](*a, **k)

    x = torch.from_numpy(_images(1, 256))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(fused_norm, "layer_norm_relu_plain", k1)
        mp.setattr(conv64, "conv3x3_same_plain", k2)
        build_adaptive_depth_unet(256, 64, 4, device="cpu")(x)
        assert calls == {"k1": 0, "k2": 2}
        build_unet(256, device="cpu")(x)
        assert calls == {"k1": 18, "k2": 4}


def test_build_refuses_a_depth_that_collapses_the_input():
    with pytest.raises(ValueError, match="collapses"):
        build_adaptive_depth_unet(16, 8, 5, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            build_adaptive_depth_unet(32, 8, 2)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            build_unet(32)
