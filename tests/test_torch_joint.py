"""The port's joint SR + segmentation U-Net, its steps and ``train_joint``
against the JAX reference.

Weights made by the JAX model are perturbed first (``perturb_params``: a
fresh joint model's SR head is the identity, so its upstream gradients
would be zero) and converted with ``state_dict_from_flax``; the same numpy
batches then go through both packages. Tolerances: the forward atol 1e-5
(float32, convs and resizes summed in another order); three Adam steps
rtol 5e-3 / atol 5e-4 on the losses, metrics and parameters, as
``tests/test_torch_train.py`` holds the SR step (float32 gradients differ
in the last bits, Adam's first updates are ~lr * sign(grad)); the
per-sample eval rtol 1e-4 / atol 1e-5 (no update in between).
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.losses import charbonnier_loss as jax_charbonnier
from adunet.losses import make_bce_dice_loss as jax_bce_dice
from adunet.losses import make_weighted_ce_loss as jax_weighted_ce
from adunet.models import build_joint_unet as build_jax
from adunet.train import create_train_state as jax_state
from adunet.train import make_joint_eval_step as jax_eval_step
from adunet.train import make_joint_train_step as jax_train_step
from adunet.train import make_optimizer as jax_optimizer
from adunet_torch.convert import model_leaf_paths, state_dict_from_flax
from adunet_torch.losses import charbonnier_loss, make_bce_dice_loss, make_weighted_ce_loss
from adunet_torch.models import build_joint_unet as build_torch
from adunet_torch.train import (
    create_train_state,
    make_joint_eval_step,
    make_joint_train_step,
    make_optimizer,
)

torch.set_num_threads(4)

SIZE, BASE, DEPTH = 32, 8, 2


@functools.lru_cache(maxsize=None)
def _fresh_jax_state(num_classes, lr=1e-4):
    model, info = build_jax(0.5, base_channels=BASE, residual_head_channels=BASE,
                            num_classes=num_classes, depth_override=DEPTH, input_size=SIZE)
    state = jax_state(model, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), jax_optimizer(lr))
    return model, info, state


def _jax_state(num_classes, perturb_params):
    model, info, state = _fresh_jax_state(num_classes)
    return model, info, state.replace(params=perturb_params(state.params))


def _torch_model(num_classes, params):
    model, info = build_torch(0.5, base_channels=BASE, residual_head_channels=BASE,
                              num_classes=num_classes, depth_override=DEPTH, input_size=SIZE,
                              device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    return model, info


def _batches(k, n, num_classes, seed=0):
    """k batches of n smooth images in [0, 1] and their masks (binary, or
    one-hot over ``num_classes``)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((k, n, SIZE // 4, SIZE // 4, 3), dtype=np.float32)
    images = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3)
    images = np.clip(images + 0.05 * rng.normal(size=images.shape), 0, 1).astype(np.float32)
    labels = (images.mean(-1) * num_classes * 0.999).astype(np.int64) if num_classes > 1 \
        else (images.mean(-1) > 0.5).astype(np.int64)
    masks = (np.eye(num_classes, dtype=np.float32)[labels] if num_classes > 1
             else labels[..., None].astype(np.float32))
    return images, masks


def _losses(num_classes):
    if num_classes > 1:
        return ((jax_charbonnier, jax_weighted_ce([1.0] * num_classes)),
                (charbonnier_loss, make_weighted_ce_loss([1.0] * num_classes)))
    return (jax_charbonnier, jax_bce_dice(0.5, 1.0)), (charbonnier_loss, make_bce_dice_loss(0.5, 1.0))


@pytest.mark.parametrize("num_classes", [1, 3])
def test_params_names_and_leaf_order_match_jax(num_classes, perturb_params):
    _, jinfo, jstate = _jax_state(num_classes, perturb_params)
    model, info = _torch_model(num_classes, jstate.params)
    assert info == jinfo
    want = state_dict_from_flax(jax.device_get(jstate.params))
    assert set(model.state_dict()) == set(want)
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jstate.params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate.params)
    assert model_leaf_paths(model) == [tuple(k.key for k in path) for path, _ in flat]


def test_full_width_depth_and_params_match_jax():
    """``train_joint``'s defaults (scale 0.5, 256 px, base 64): depth 4 by the
    depth policy and 50,273,348 parameters, in both packages."""
    jmodel, jinfo = build_jax(0.5)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 256, 256, 3)))
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    model, info = build_torch(0.5, device="meta")
    assert (info["depth"], info["bottleneck_size"]) == (jinfo["depth"], jinfo["bottleneck_size"]) \
        == (4, 16)
    assert sum(p.numel() for p in model.parameters()) == n_jax == 50_273_348


@pytest.mark.parametrize("num_classes", [1, 3])
def test_forward_matches_jax(num_classes, perturb_params):
    jmodel, _, jstate = _jax_state(num_classes, perturb_params)
    model, _ = _torch_model(num_classes, jstate.params)
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 3), dtype=np.float32)
    jsr, jseg = jmodel.apply({"params": jstate.params}, jnp.asarray(x))
    with torch.no_grad():
        sr, seg = model(torch.from_numpy(x))
    assert sr.dtype == seg.dtype == torch.float32
    assert seg.shape == (2, SIZE, SIZE, num_classes)
    assert np.abs(np.asarray(jsr) - x).max() > 1e-2  # not the identity
    np.testing.assert_allclose(sr.numpy(), np.asarray(jsr), atol=1e-5)
    np.testing.assert_allclose(seg.numpy(), np.asarray(jseg), atol=1e-5)
    if num_classes > 1:
        np.testing.assert_allclose(seg.sum(-1).numpy(), 1.0, atol=1e-5)


def test_identity_start_and_bf16_dtype_flow():
    model, _ = build_torch(0.5, base_channels=BASE, residual_head_channels=BASE,
                           depth_override=DEPTH, dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).random((2, SIZE, SIZE, 3), dtype=np.float32))
    with torch.no_grad():
        sr, seg = model(x)
    assert sr.dtype == seg.dtype == torch.float32  # residual add and logits in float32
    assert torch.equal(sr, x)  # zero-init residual head
    assert 0.0 <= float(seg.min()) and float(seg.max()) <= 1.0


@pytest.mark.parametrize("num_classes", [1, 3])
def test_adam_steps_match_jax(num_classes, perturb_params):
    steps, lr = 3, 1e-4
    jmodel, _, jstate = _jax_state(num_classes, perturb_params)
    model, _ = _torch_model(num_classes, jstate.params)
    tstate = create_train_state(model, make_optimizer(model.parameters(), lr))
    (jsr, jseg), (tsr, tseg) = _losses(num_classes)
    jstep = jax_train_step(jmodel, jsr, jseg, sr_weight=1.0, seg_weight=0.5, donate=False)
    tstep = make_joint_train_step(model, tsr, tseg, sr_weight=1.0, seg_weight=0.5)
    (images,), (masks,) = _batches(1, 4, num_classes)  # one batch: the loss must fall
    names = ("loss", "sr_loss", "seg_loss", "psnr", "dice", "iou")
    jm, tm = [], []
    for _ in range(steps):
        jstate, m = jstep(jstate, (jnp.asarray(images), jnp.asarray(masks)), None)
        jm.append([float(m[n]) for n in names])
        tstate, m = tstep(tstate, (images, masks))
        assert set(m) == set(names)
        tm.append([float(m[n]) for n in names])
    np.testing.assert_allclose(tm, jm, rtol=5e-3, atol=5e-4)
    assert tm[-1][0] < tm[0][0]  # it trains
    want = state_dict_from_flax(jax.device_get(jstate.params))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=5e-3, atol=5e-4,
                                   err_msg=name)
    assert tstate.step == steps


def test_per_sample_eval_matches_jax(perturb_params):
    jmodel, _, jstate = _jax_state(1, perturb_params)
    model, _ = _torch_model(1, jstate.params)
    (jsr, jseg), (tsr, tseg) = _losses(1)
    images, masks = _batches(1, 3, 1, seed=4)
    images = (images[0] * 255).round().astype(np.uint8)  # the uint8 wire format
    want = jax_eval_step(jmodel, jsr, jseg, per_sample=True)(jstate, (images, masks[0]))
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    got = make_joint_eval_step(model, tsr, tseg, per_sample=True)(state, (images, masks[0]))
    batch = make_joint_eval_step(model, tsr, tseg)(state, (images, masks[0]))
    assert set(got) == set(want) == set(batch)
    for name, value in want.items():
        assert got[name].shape == (3,), name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # the batch metrics of the same forward: losses and soft scores are means
    for name in ("loss", "sr_loss", "seg_loss"):
        np.testing.assert_allclose(float(batch[name]), float(got[name].mean()), rtol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 train / 4 val image-mask pairs of 32 px (``.npy``), as the
    reference's ``tests/test_multiclass_joint.py`` corpus."""
    root = tmp_path_factory.mktemp("joint_corpus")
    rng = np.random.default_rng(5)
    for split, n in (("train", 8), ("val", 4)):
        (root / f"{split}_img").mkdir()
        (root / f"{split}_mask").mkdir()
        for i in range(n):
            mask = np.zeros((SIZE, SIZE), np.int64)
            mask[8:24, 8:24] = 1
            np.save(root / f"{split}_img" / f"im_{split}{i:04d}.npy",
                    rng.random((SIZE, SIZE, 3), dtype=np.float32))
            np.save(root / f"{split}_mask" / f"im_{split}{i:04d}_mask.npy", mask)
    return root


def _cli_args(corpus, out):
    return ["--train_image_dir", str(corpus / "train_img"),
            "--train_mask_dir", str(corpus / "train_mask"),
            "--val_image_dir", str(corpus / "val_img"), "--val_mask_dir", str(corpus / "val_mask"),
            "--image_suffix", ".npy", "--mask_suffix", "_mask.npy", "--image_size", str(SIZE),
            "--depth_override", str(DEPTH), "--base_channels", str(BASE),
            "--residual_head_channels", str(BASE), "--batch_size", "4", "--epochs", "2",
            "--model_dir", str(out / "models"), "--log_dir", str(out / "logs"),
            "--run_name", "joint", "--seed", "4"]


def test_train_joint_cli_matches_reference_artifacts(corpus, tmp_path):
    """The port's ``train_joint`` on ``--device cpu`` writes ``config.json``
    with the reference CLI's keys, ``result.json`` with its
    ``final_metrics`` keys, ``epoch_metrics.csv``, TensorBoard events of the
    epoch scalars and the best checkpoint; the reference CLI runs on the same
    arguments for the comparison."""
    from adunet.cli.train_joint import main as jax_main
    from adunet_torch.cli.train_joint import main
    from adunet_torch.train import CheckpointManager

    jax_main(_cli_args(corpus, tmp_path / "jax"))
    out = main(_cli_args(corpus, tmp_path / "torch") + ["--device", "cpu"])
    (jrun,) = (tmp_path / "jax" / "logs").glob("joint_*")
    trun = Path(out["run_dir"])
    jcfg = json.loads((jrun / "config.json").read_text())
    tcfg = json.loads((trun / "config.json").read_text())
    assert list(tcfg) == list(jcfg)
    for key in ("depth", "bottleneck_size", "n_params", "steps_per_epoch", "image_size", "scale"):
        assert tcfg[key] == jcfg[key], key
    jres = json.loads((jrun / "result.json").read_text())
    tres = json.loads((trun / "result.json").read_text())
    assert list(tres) == list(jres)
    assert list(tres["final_metrics"]) == list(jres["final_metrics"])
    assert tres["epochs_ran"] == 2
    assert all(np.isfinite(v) for v in tres["final_metrics"].values())
    header = (trun / "epoch_metrics.csv").read_text().splitlines()[0].split(",")
    assert header == list(jres["final_metrics"])
    blob = b"".join(f.read_bytes() for f in trun.glob("events.out.tfevents.*"))
    for tag in (b"train/loss", b"train/dice", b"val/psnr", b"perf/ms_per_step",
                b"perf/images_per_sec"):
        assert tag in blob, tag
    ckpt = Path(tres["checkpoint"])
    assert ckpt.name == "joint_best" and (ckpt / "config.json").exists()
    assert CheckpointManager(ckpt).latest_step() == 2


def test_train_joint_refuses_what_is_not_ported(corpus, tmp_path):
    from adunet_torch.cli.train_joint import main

    # one process drives one device: the error names the torchrun launch
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m "
                                         "adunet_torch.cli.train_joint "):
        main(_cli_args(corpus, tmp_path) + ["--device", "cpu", "--n_devices", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(_cli_args(corpus, tmp_path))
