"""Parity of the port's image ops and depth policy with the JAX reference.

The same numpy inputs (from a seed) go through ``adunet`` (JAX, CPU) and
``adunet_torch`` (PyTorch, CPU). Tolerances: the sampling matrices are built
by the same numpy code, so they must be equal exactly; the resizes apply them
with float32 matmuls in a different summation order, hence atol 1e-5.
"""

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
