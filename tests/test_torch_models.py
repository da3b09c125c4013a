"""The port's SR U-Net against the JAX reference.

Weights made by the JAX model (perturbed first: the fresh model is the
identity, which would make a forward comparison vacuous) go through
``state_dict_from_flax`` into the port's model; the same numpy input then
runs through both. atol 1e-5: float32 throughout, convs and resizes summed
in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.export.aot import quantize_params_int8
from adunet.models import build_super_resolution_unet as build_jax
from adunet_torch.convert import flax_leaf_paths, state_dict_from_flax
from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.models import build_super_resolution_unet as build_torch
from adunet_torch.nn.blocks import ConvBlock

torch.set_num_threads(2)

GOLDEN_PARAMS = {1: 520_003, 2: 2_144_451, 3: 8_637_379, 4: 34_599_363, 5: 138_427_843}


@pytest.mark.parametrize("depth", sorted(GOLDEN_PARAMS))
def test_golden_param_counts(depth):
    model, info = build_torch(0.5, depth_override=depth, device="meta")
    assert info["depth"] == depth
    assert sum(p.numel() for p in model.parameters()) == GOLDEN_PARAMS[depth]


def test_identity_at_init():
    model, _ = build_torch(0.5, base_channels=8, residual_head_channels=8,
                           depth_override=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32))
    with torch.no_grad():
        y = model(x)
    assert torch.equal(y, x)


def test_init_is_seeded_and_glorot():
    a, _ = build_torch(0.5, base_channels=8, depth_override=1, device="cpu", seed=3)
    b, _ = build_torch(0.5, base_channels=8, depth_override=1, device="cpu", seed=3)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.state_dict()["enc0.conv1.weight"]  # (8, 8, 3, 3): glorot limit sqrt(6/144)
    assert 0 < w.abs().max() <= np.sqrt(6.0 / 144.0)
    assert torch.count_nonzero(a.state_dict()["residual_rgb.weight"]) == 0


def test_entry_points_refuse_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_torch(0.5, depth_override=1)


def test_untrainable_options_raise():
    """Only a misspelt norm still raises. remat is ported: ``remat=True``
    checkpoints every block, ``remat_levels=N`` (which overrides it) the
    encoder / decoder blocks below level N and never the bottleneck or head,
    as ``adunet/models/sr_adaptive.py:62-66`` selects them."""
    everything, _ = build_torch(0.5, depth_override=3, remat=True, device="meta")
    selective, _ = build_torch(0.5, depth_override=3, remat=True, remat_levels=2, device="meta")
    levels = [0, 1, 2, None]
    assert [everything._uses_remat(level) for level in levels] == [True] * 4
    assert [selective._uses_remat(level) for level in levels] == [True, True, False, False]
    # norm="batch" is trainable since the segmentation models were ported
    assert type(ConvBlock(3, 8, norm="batch").norm0).__name__ == "BatchNorm"
    with pytest.raises(ValueError, match="unknown norm"):
        ConvBlock(3, 8, norm="Layer")


def _jax_params(depth, base, size, perturb_params, seed=0):
    model, _ = build_jax(0.5, base_channels=base, residual_head_channels=base,
                         depth_override=depth, input_size=size)
    params = model.init(jax.random.key(seed), jnp.zeros((1, size, size, 3)))["params"]
    return model, perturb_params(params)


@pytest.mark.parametrize("depth, base, hw, k2_calls", [(2, 8, (32, 32), 0), (1, 64, (16, 128), 4)])
def test_forward_parity(depth, base, hw, k2_calls, perturb_params, monkeypatch):
    jmodel, params = _jax_params(depth, base, hw[0], perturb_params)
    tmodel, _ = build_torch(0.5, base_channels=base, residual_head_channels=base,
                            depth_override=depth, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(params)), strict=True)

    calls = {"k1": 0, "k2": 0}

    def counted(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fused_norm, "layer_norm_relu_plain",
                        counted("k1", fused_norm.layer_norm_relu_plain))
    monkeypatch.setattr(conv64, "conv3x3_same_plain", counted("k2", conv64.conv3x3_same_plain))

    x = np.random.default_rng(1).random((2, *hw, 3), dtype=np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    # every ConvBlock's two LN+ReLU pairs go through K1's wrapper; the 64->64
    # convs at a gated shape (enc0.conv1, dec0.conv1, head.conv0/1) through K2's
    assert calls == {"k1": 2 * (2 * depth + 2), "k2": k2_calls}
    assert np.abs(want - np.clip(x, 0, 1)).max() > 1e-2  # the network is load-bearing
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_state_dict_from_flax_layout(perturb_params):
    _, params = _jax_params(1, 8, 16, perturb_params)
    sd = state_dict_from_flax(jax.device_get(params))
    tmodel, _ = build_torch(0.5, base_channels=8, residual_head_channels=8,
                            depth_override=1, device="meta")
    assert set(sd) == set(tmodel.state_dict())
    k = np.asarray(params["enc0"]["conv1"]["kernel"])  # HWIO
    np.testing.assert_array_equal(sd["enc0.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["enc0.norm0.weight"].numpy(),
                                  np.asarray(params["enc0"]["norm0"]["scale"]))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("quantized", [False, True])
def test_flax_leaf_paths_match_tree_flatten(depth, quantized, perturb_params):
    _, params = _jax_params(depth, 8, 32, perturb_params)
    tree = quantize_params_int8(params) if quantized else params
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [tuple(k.key for k in path) for path, _ in flat]
    assert flax_leaf_paths(depth, quantized=quantized) == want
