"""The port's segmentation training against the JAX reference on the CPU.

Parity: the same perturbed params and running statistics and the same
batches go through 3 Adam steps of ``adunet.train.make_seg_train_step`` and
of the port's (augmentation off: its draws cannot be shared, see
``test_torch_seg_data.py``). Tolerance rtol 5e-3 / atol 5e-4 on the metrics
and parameters, as the SR steps (``test_torch_train.py``): float32 gradients
in another summation order, and Adam's first updates are ~lr * sign(grad).
The running statistics are means over N, H, W of activations that differ in
the last bits: rtol 1e-4 / atol 1e-5.

Precise-BN: the reference recovers each batch's statistics by inverting the
EMA update new = 0.99 old + 0.01 b, which multiplies the float32 rounding of
``new`` (2^-24 relative to max(|old|, |b|) ~ 1) by 100; the port takes them
from the forward. The two agree to atol 5e-5 / rtol 1e-4 (~100 x 2^-24 x 4).
"""

import csv
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet import losses as jl
from adunet import metrics as jm
from adunet.models import build_adaptive_depth_unet as jax_adaptive
from adunet.models import build_unet as jax_vanilla
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet.train import seg as jseg
from adunet_torch import losses as tl
from adunet_torch import metrics as tm
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.kernels import conv64
from adunet_torch.models import build_adaptive_depth_unet, build_unet
from adunet_torch.train import CheckpointManager, create_train_state, fit, make_optimizer
from adunet_torch.train import seg as tseg

torch.set_num_threads(4)


def _batches(k, n, size, seed=0, c=1):
    rng = np.random.default_rng(seed)
    coarse = rng.random((k, n, size // 4, size // 4, 3), dtype=np.float32)
    images = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3).astype(np.float32)
    if c == 1:  # the mask follows the image, so the net has something to learn
        masks = (images.mean(-1, keepdims=True) > 0.5).astype(np.float32)
    else:
        masks = np.eye(c, dtype=np.float32)[np.minimum((images[..., 0] * c).astype(int), c - 1)]
    return images, masks


def _perturb_stats(stats, seed=11):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(stats)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    out = [leaf * jnp.exp(0.3 * jax.random.normal(k, leaf.shape)) if path[-1].key == "var"
           else leaf + 0.2 * jax.random.normal(k, leaf.shape)
           for (path, leaf), k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, out)


def _pair(kind, size, perturb_params, lr, cosine_steps=None, **kw):
    """The JAX state and the port's, from the same perturbed variables."""
    if kind == "protocol":
        jmodel = jax_adaptive(input_size=size, **kw)
        tmodel = build_adaptive_depth_unet(size, device="cpu", **kw)
    else:
        jmodel = jax_vanilla(size, **kw)
        tmodel = build_unet(size, device="cpu", **kw)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, size, size, 3)),
                       jax_optimizer(lr, cosine_decay_steps=cosine_steps))
    jstate = jstate.replace(params=perturb_params(jstate.params))
    if jstate.batch_stats is not None:
        jstate = jstate.replace(batch_stats=_perturb_stats(jstate.batch_stats))
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(jstate.params),
                                                jax.device_get(jstate.batch_stats)))
    tstate = create_train_state(tmodel, make_optimizer(tmodel.parameters(), lr,
                                                       cosine_decay_steps=cosine_steps))
    return jmodel, jstate, tmodel, tstate


def _as_np(metrics):
    return {k: np.asarray(v, dtype=np.float64) for k, v in metrics.items()}


def _assert_states_close(jstate, tmodel):
    want = state_dict_from_flax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for name, value in want.items():
        tol = dict(rtol=1e-4, atol=1e-5) if "running" in name else dict(rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("loss, size, kw, cosine, k2_per_step", [
    ("A", 32, dict(base_channels=8, depth=2), 3, 0),
    ("B", 32, dict(base_channels=4, depth=2), None, 0),
    ("A", 128, dict(base_channels=64, depth=1), None, 2),  # enc0.conv1, dec0.conv1 through K2
])
def test_protocol_adam_steps_match_jax(loss, size, kw, cosine, k2_per_step, perturb_params,
                                       monkeypatch):
    steps, lr = 3, 1e-4
    jmodel, jstate, tmodel, tstate = _pair("protocol", size, perturb_params, lr, cosine, **kw)
    jloss, tloss = ((jl.make_hybrid_ce_dice_loss(0.4, 0.6), tl.make_hybrid_ce_dice_loss(0.4, 0.6))
                    if loss == "A" else (jl.make_bce_dice_loss(0.5, 1.0), tl.make_bce_dice_loss(0.5, 1.0)))
    jstep = jseg.make_seg_train_step(jmodel, jloss, augment=False, donate=False)
    tstep = tseg.make_seg_train_step(tmodel, tloss, augment=False)
    plain_calls = []
    monkeypatch.setattr(conv64, "conv3x3_same_plain",
                        lambda *a, f=conv64.conv3x3_same_plain: plain_calls.append(1) or f(*a))
    images, masks = _batches(1, 2, size)
    losses = []
    for _ in range(steps):  # one batch: the loss must fall over the steps
        jstate, jmet = jstep(jstate, (jnp.asarray(images[0]), jnp.asarray(masks[0])), None)
        tstate, tmet = tstep(tstate, (images[0], masks[0]), None)
        want, got = _as_np(jmet), _as_np(tmet)
        assert set(got) == set(want) == {"loss", "dice", "iou"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=5e-4, err_msg=k)
        losses.append(float(got["loss"]))
    assert len(plain_calls) == steps * k2_per_step
    assert losses[-1] < losses[0]
    _assert_states_close(jstate, tmodel)
    assert tstate.step == steps
    if cosine:  # the cosine schedule's last update ran at schedule(2)
        assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(lr * 0.25)


def _vanilla_extra(lib, num_classes):
    if num_classes > 1:
        return {"mean_iou": lib.pooled_mean_iou(num_classes),
                "dice_coefficient": lib.pooled_global_dice()}
    return {"accuracy": lib.binary_accuracy, "precision": lib.pooled_precision(),
            "recall": lib.pooled_recall(), "dice_coefficient": lib.pooled_global_dice()}


@pytest.mark.parametrize("num_classes", [1, 3])
def test_vanilla_adam_steps_match_jax(num_classes, perturb_params):
    steps, lr, size = 3, 1e-4, 32
    jmodel, jstate, tmodel, tstate = _pair("vanilla", size, perturb_params, lr,
                                           num_classes=num_classes, base_channels=8, depth=2)
    if num_classes > 1:
        jloss, tloss = jl.make_weighted_ce_loss([0.5, 2.0, 1.0]), tl.make_weighted_ce_loss([0.5, 2.0, 1.0])
    else:
        jloss, tloss = jl.binary_crossentropy, tl.binary_crossentropy
    jstep = jseg.make_seg_train_step(jmodel, jloss, augment=False, donate=False,
                                     extra_metrics=_vanilla_extra(jm, num_classes))
    tstep = tseg.make_seg_train_step(tmodel, tloss, augment="none",
                                     extra_metrics=_vanilla_extra(tm, num_classes))
    images, masks = _batches(steps, 2, size, seed=1, c=num_classes)
    for i in range(steps):
        jstate, jmet = jstep(jstate, (jnp.asarray(images[i]), jnp.asarray(masks[i])), None)
        tstate, tmet = tstep(tstate, (images[i], masks[i]), None)
        want, got = _as_np(jmet), _as_np(tmet)
        assert set(got) == set(want) and any("#" in k for k in got)
        for k in want:  # pooled components are pixel counts: 5e-3 of a count
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=5e-4, err_msg=k)
    want = state_dict_from_flax(jax.device_get(jstate.params))
    for name, value in want.items():
        np.testing.assert_allclose(tmodel.state_dict()[name].numpy(), value.numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("per_sample", [True, False])
def test_eval_step_matches_jax(per_sample, perturb_params):
    size = 32
    jmodel, jstate, tmodel, tstate = _pair("protocol", size, perturb_params, 1e-4,
                                           base_channels=8, depth=2)
    extra_j, extra_t = _vanilla_extra(jm, 1), _vanilla_extra(tm, 1)
    jeval = jseg.make_seg_eval_step(jmodel, jl.binary_crossentropy, extra_j, per_sample)
    teval = tseg.make_seg_eval_step(tmodel, tl.binary_crossentropy, extra_t, per_sample)
    images, masks = _batches(1, 3, size, seed=2)
    want = _as_np(jeval(jstate, (jnp.asarray(images[0]), jnp.asarray(masks[0]))))
    got = _as_np(teval(tstate, (images[0], masks[0])))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert not tmodel.training  # running statistics


def test_precise_bn_matches_jax(perturb_params):
    size = 32
    jmodel, jstate, tmodel, tstate = _pair("protocol", size, perturb_params, 1e-4,
                                           base_channels=8, depth=2)
    images, _ = _batches(3, 4, size, seed=3)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    want = jseg.precise_batch_stats(jstate, [jnp.asarray(b) for b in images],
                                    jseg.make_bn_refresh_step())
    tseg.precise_batch_stats(tstate, list(images), tseg.make_bn_refresh_step())
    want_sd = state_dict_from_flax(jax.device_get(want.params), jax.device_get(want.batch_stats))
    got_sd = tmodel.state_dict()
    for name, value in want_sd.items():
        if "running" in name:
            np.testing.assert_allclose(got_sd[name].numpy(), value.numpy(), rtol=1e-4, atol=5e-5,
                                       err_msg=name)
            assert not torch.equal(got_sd[name], before[name])
        else:  # parameters untouched
            assert torch.equal(got_sd[name], before[name])
    # no batches: unchanged
    tseg.precise_batch_stats(tstate, [], tseg.make_bn_refresh_step())
    assert all(torch.equal(v, tmodel.state_dict()[k]) for k, v in got_sd.items())


def test_precise_bn_program_matches_per_batch_variant():
    model = build_adaptive_depth_unet(16, 4, 1, device="cpu")
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
    batches = np.random.default_rng(3).random((3, 4, 16, 16, 3), dtype=np.float32)
    fused = tseg.make_precise_bn_program()(state, torch.from_numpy(batches))
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in
               build_adaptive_depth_unet(16, 4, 1, device="cpu").state_dict().items())
    tseg.precise_batch_stats(state, list(batches), tseg.make_bn_refresh_step())
    assert set(fused) == {k for k in model.state_dict() if "running" in k}
    for k, v in fused.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)


def test_snapshot_refresh_batches_do_not_advance_the_shuffle(tmp_path):
    from adunet_torch.data import SegPairDataset

    pairs = []
    for i in range(5):
        np.save(tmp_path / f"i{i}.npy", np.full((8, 8, 3), i / 10, np.float32))
        np.save(tmp_path / f"m{i}.npy", np.zeros((8, 8), np.float32))
        pairs.append((str(tmp_path / f"i{i}.npy"), str(tmp_path / f"m{i}.npy")))
    ds = SegPairDataset(pairs, batch_size=2, image_size=8, augment=False, shuffle=True, seed=1)
    got = tseg.snapshot_refresh_batches(ds, 3)
    assert ds._epoch == 0 and len(got) == 3
    np.testing.assert_allclose([b[:, 0, 0, 0] for b in got], [[0, .1], [.2, .3], [.4, 0]], atol=1e-6)


def test_fit_pools_metrics_over_the_set_and_keeps_running_stats(tmp_path):
    """The fit loop finalizes pooled metrics over every validation sample,
    runs the pre-validation hook, reuses device-cached validation batches,
    and the best-weights snapshot and the checkpoints carry the BatchNorm
    running statistics."""
    model = build_adaptive_depth_unet(16, 4, 1, device="cpu", seed=1)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-2))
    extra = {"precision": tm.pooled_precision(), "dice_coefficient": tm.pooled_global_dice()}
    step = tseg.make_seg_train_step(model, tl.binary_crossentropy, augment="none",
                                    extra_metrics=extra)
    val_step = tseg.make_seg_eval_step(model, tl.binary_crossentropy, extra, per_sample=True)
    images, masks = _batches(1, 7, 16, seed=4)
    val = [(images[0][:4], masks[0][:4]), (images[0][4:], masks[0][4:])]  # ragged

    class CountingVal(list):  # counts passes over the host batches
        passes = 0

        def __iter__(self):
            CountingVal.passes += 1
            return super().__iter__()

    train = [(images[0][:4], masks[0][:4])] * 100
    snapshots = []
    scores = iter([0.9, 0.1, 0.2])  # epoch 1 scores best
    current = {}

    def pre_val(s):
        current["score"] = next(scores)
        snapshots.append({k: v.clone() for k, v in s.model.state_dict().items() if "running" in k})
        return s

    def val_and_score(s, b):
        return {**val_step(s, b), "score": torch.full((b[0].shape[0],), current["score"])}

    ckpt = CheckpointManager(tmp_path / "ckpt", monitor="val_score", mode="max")
    result = fit(state, iter(train), step, steps_per_epoch=2, epochs=3,
                 val_data=CountingVal(val), val_step=val_and_score, monitor="val_score",
                 monitor_mode="max", ckpt=ckpt, log_dir=tmp_path / "logs", pre_val_hook=pre_val,
                 metric_finalizers=tseg.metric_finalizers_of(extra), cache_val_on_device=True)
    assert len(snapshots) == 3 and CountingVal.passes == 1 and result.best_epoch == 1
    first = result.history[0]
    assert "precision#tp" not in first.val_metrics and "precision" in first.metrics
    # restored best weights and the best checkpoint carry epoch 1's running statistics
    for k, v in snapshots[0].items():
        assert torch.equal(model.state_dict()[k], v), k
    assert not all(torch.equal(snapshots[0][k], snapshots[-1][k]) for k in snapshots[0])
    saved = torch.load(tmp_path / "ckpt" / "1" / "state.pt", weights_only=True)["model"]
    for k, v in snapshots[0].items():
        assert torch.equal(saved[k], v), k
    # epoch 1's val precision is pooled over all 7 samples of the two batches:
    # the restored (epoch 1) model's precision over the whole set at once
    model.eval()
    with torch.no_grad():
        pred = model(torch.from_numpy(images[0]))
    whole = float(tm.precision(torch.from_numpy(masks[0]), pred))
    assert first.val_metrics["precision"] == pytest.approx(whole, rel=1e-6)
    header = (tmp_path / "logs" / "epoch_metrics.csv").read_text().splitlines()[0].split(",")
    assert header[4:9] == ["dice", "iou", "loss", "precision", "dice_coefficient"]
    assert not any("#" in h for h in header)


# ---------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def tiny_isic(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_isic")
    rng = np.random.default_rng(2)
    for d in ("train_img", "train_mask", "val_img", "val_mask"):
        (root / d).mkdir()
    for split, n in (("train", 10), ("val", 5)):
        for i in range(n):
            np.save(root / f"{split}_img" / f"ISIC_{split}{i:03d}.npy",
                    rng.random((40, 40, 3), dtype=np.float32))
            m = np.zeros((40, 40), np.float32)
            m[8 + i : 24, 10:30 - i] = 1.0
            np.save(root / f"{split}_mask" / f"ISIC_{split}{i:03d}_segmentation.npy", m)
    return root


def _protocol_args(root, out, name, epochs):
    return ["--protocol", "A", "--epochs", str(epochs), "--batch_size", "8",
            "--base_channels", "8", "--depth", "2", "--image_size", "32",
            "--train_images", str(root / "train_img"), "--train_masks", str(root / "train_mask"),
            "--val_images", str(root / "val_img"), "--val_masks", str(root / "val_mask"),
            "--model_dir", str(out / "models"), "--log_dir", str(out / "logs"), "--run_name", name]


def _vanilla_args(root, out, epochs):
    return ["--train_image_dir", str(root / "train_img"), "--train_mask_dir", str(root / "train_mask"),
            "--val_image_dir", str(root / "val_img"), "--val_mask_dir", str(root / "val_mask"),
            "--image_suffix", ".npy", "--mask_suffix", "_segmentation.npy", "--image_size", "32",
            "--batch_size", "8", "--epochs", str(epochs), "--base_channels", "4", "--depth", "2",
            "--augment", "--model_dir", str(out / "models"), "--log_dir", str(out / "logs"),
            "--run_name", "vanilla"]


def _csv_header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_train_seg_cli_writes_the_reference_schema(tiny_isic, tmp_path):
    from adunet.cli.train_seg import main as jax_main
    from adunet_torch.cli.train_seg import main as port_main

    jax_main(_protocol_args(tiny_isic, tmp_path / "jax", "ref", 1))
    result = port_main(_protocol_args(tiny_isic, tmp_path / "port", "port", 2)
                       + ["--device", "cpu", "--precise_bn", "2"])
    want_dir, got_dir = tmp_path / "jax" / "logs" / "ref", tmp_path / "port" / "logs" / "port"
    want, got = (json.loads((d / "config.json").read_text()) for d in (want_dir, got_dir))
    assert list(got) == list(want)
    assert list(got["metrics"]) == list(want["metrics"]) == ["dice", "iou", "loss"]
    assert got["n_params"] == want["n_params"] and got["train_steps_per_epoch"] == 2
    assert got["epochs_ran"] == 2 and 0 <= got["metrics"]["dice"] <= 1
    assert _csv_header(got_dir / "epoch_metrics.csv") == _csv_header(want_dir / "epoch_metrics.csv")
    assert len((got_dir / "epoch_metrics.csv").read_text().splitlines()) == 3
    ckpt_dir = tmp_path / "port" / "models" / "port"
    assert (ckpt_dir / "config.json").exists() and CheckpointManager(ckpt_dir).latest_step() == 2
    assert (got_dir / "model_summary.txt").read_text().startswith("AdaptiveSegUNet(")
    # TensorBoard: the reference's per-epoch tags, in both run directories
    for run_dir in (want_dir, got_dir):
        blob = b"".join(f.read_bytes() for f in run_dir.glob("events.out.tfevents.*"))
        for tag in (b"train/loss", b"train/dice", b"val/dice", b"val/iou", b"perf/ms_per_step",
                    b"perf/images_per_sec"):
            assert tag in blob, (run_dir.name, tag)
    # precise-BN: the final running statistics are population statistics,
    # not the EMA a 2-epoch run leaves near the init (mean 0, var 1)
    assert not torch.allclose(result["state"].model.enc0.norm0.running_var, torch.ones(8),
                              atol=0.05)


def test_train_seg_vanilla_cli_writes_the_reference_schema(tiny_isic, tmp_path):
    from adunet.cli.train_seg_vanilla import main as jax_main
    from adunet_torch.cli.train_seg_vanilla import main as port_main

    jax_main(_vanilla_args(tiny_isic, tmp_path / "jax", 1))
    result = port_main(_vanilla_args(tiny_isic, tmp_path / "port", 2) + ["--device", "cpu"])
    (want_dir,) = (tmp_path / "jax" / "logs").glob("vanilla_*")
    got_dir = tmp_path / "port" / "logs" / next((tmp_path / "port" / "logs").iterdir()).name
    want, got = (json.loads((d / "config.json").read_text()) for d in (want_dir, got_dir))
    assert list(got) == list(want)
    assert got["n_params"] == want["n_params"] and got["monitor"] == "val_dice_coefficient"
    header = _csv_header(got_dir / "epoch_metrics.csv")
    assert header == _csv_header(want_dir / "epoch_metrics.csv")
    for col in ("accuracy", "precision", "recall", "dice_coefficient", "val_dice_coefficient"):
        assert col in header
    assert got["best_val_dice"] is not None and got["epochs_ran"] == 2
    assert CheckpointManager(tmp_path / "port" / "models" / "vanilla_final").latest_step() == 2
    assert result["state"].optimizer.inject_lr


def test_seg_clis_refuse_what_is_not_ported(tiny_isic, tmp_path):
    from adunet_torch.cli.train_seg import main as protocol_main
    from adunet_torch.cli.train_seg_vanilla import main as vanilla_main

    base = _protocol_args(tiny_isic, tmp_path, "x", 1)
    # one process drives one device: the error names the torchrun launch
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m "
                                         "adunet_torch.cli.train_seg "):
        protocol_main(base + ["--device", "cpu", "--n_devices", "2"])
    # --async_checkpoint is ported: it writes the best checkpoint on a thread
    out = vanilla_main(_vanilla_args(tiny_isic, tmp_path, 1) + ["--device", "cpu",
                                                                "--async_checkpoint"])
    assert CheckpointManager(out["checkpoint"]).latest_step() == 1
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            protocol_main(base)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            vanilla_main(_vanilla_args(tiny_isic, tmp_path, 1))
