"""The port's fit loop, checkpoints and ``train_sr`` CLI on the CPU.

Toy steps with scripted metrics drive early stopping with
``restore_best_weights``, ReduceLROnPlateau and ``stop_on_nan`` exactly; the
plateau rule is held against the reference's ``plateau_update`` on random
sequences, and ``epoch_metrics.csv`` against the header the reference's
``fit`` writes. The CLI runs end to end on tiny ``.npy`` images, modelled on
``tests/test_cli_e2e.py``.
"""

import csv
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.losses import build_losses_and_metrics as jax_losses
from adunet.models import build_super_resolution_unet as build_jax
from adunet.train import create_train_state as jax_state
from adunet.train import fit as jax_fit
from adunet.train import make_optimizer as jax_optimizer
from adunet.train import make_sr_train_step as jax_train_step
from adunet.train import make_sr_val_step as jax_val_step
from adunet.train.loop import make_plateau_state as jax_plateau_state
from adunet.train.loop import plateau_update as jax_plateau_update
from adunet_torch.losses import build_losses_and_metrics
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.train import (
    CheckpointManager,
    create_train_state,
    fit,
    make_optimizer,
    make_plateau_state,
    make_sr_train_step,
    make_sr_val_step,
    plateau_update,
)

torch.set_num_threads(4)


class _Counter(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3))


def _toy(val_losses, train_losses=None, inject_lr=False):
    """A state whose every step adds 1 to the parameter, and val / train
    steps that report the scripted losses epoch by epoch."""
    model = _Counter()
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3, inject_lr=inject_lr))
    epoch = {"val": 0, "train": 0}

    def train_step(st, batch, rng):
        with torch.no_grad():
            st.model.w.add_(1.0)
        st.step += 1
        loss = 1.0 if train_losses is None else train_losses[epoch["train"]]
        return st, {"loss": torch.tensor(loss), "psnr": torch.tensor(20.0)}

    def val_step(st, batch):
        loss = val_losses[epoch["val"]]
        epoch["val"] += 1
        epoch["train"] += 1
        return {"loss": torch.full((2,), loss), "psnr": torch.full((2,), 30.0)}

    return state, train_step, val_step


def _feed():
    while True:
        yield torch.zeros(2, 1)


def test_early_stop_restores_best_weights_and_backfills_its_checkpoint(tmp_path):
    state, step, val = _toy([1.0, 0.5, 0.7, 0.8, 0.9, 0.1])
    ckpt = CheckpointManager(tmp_path / "ckpt", monitor="val_loss", mode="min")
    result = fit(state, _feed(), step, steps_per_epoch=2, epochs=6, val_data=[torch.zeros(2, 1)],
                 val_step=val, patience=2, ckpt=ckpt, ckpt_every=3, log_dir=tmp_path,
                 verbose=0)
    assert result.stopped_early and len(result.history) == 4
    assert (result.best_epoch, result.best_metric) == (2, 0.5)
    assert torch.equal(state.model.w.detach(), torch.full((3,), 4.0))  # epoch 2's weights
    # epoch 3 (cadence), 4 (the stop epoch) and the backfilled best epoch 2
    assert ckpt.best_step() == 2 and ckpt.latest_step() == 4
    fresh, _, _ = _toy([0.0])
    ckpt.restore_best(fresh)
    assert torch.equal(fresh.model.w.detach(), torch.full((3,), 4.0))
    rows = list(csv.DictReader(open(tmp_path / "epoch_metrics.csv")))
    np.testing.assert_allclose([float(r["val_loss"]) for r in rows], [1.0, 0.5, 0.7, 0.8], rtol=1e-6)


def test_reduce_lr_on_plateau_scales_an_injected_lr():
    state, step, val = _toy([1.0] * 6, inject_lr=True)
    fit(state, _feed(), step, steps_per_epoch=1, epochs=6, val_data=[torch.zeros(2, 1)],
        val_step=val, reduce_lr_on_plateau={"patience": 2, "factor": 0.5, "min_lr": 3e-4},
        verbose=0)
    # reductions after epochs 3 and 5 (wait resets), floored at min_lr
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(3e-4)
    state, step, val = _toy([1.0] * 3)
    with pytest.raises(ValueError, match="inject_lr"):
        fit(state, _feed(), step, steps_per_epoch=1, epochs=3, val_data=[torch.zeros(2, 1)],
            val_step=val, reduce_lr_on_plateau={"patience": 1}, verbose=0)


def test_stop_on_nan_stops_before_validating():
    state, step, val = _toy([1.0, 0.5], train_losses=[1.0, float("nan")])
    result = fit(state, _feed(), step, steps_per_epoch=1, epochs=4, val_data=[torch.zeros(2, 1)],
                 val_step=val, verbose=0)
    assert result.stopped_early and len(result.history) == 1


def test_plateau_update_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(20):
        spec = {"mode": ["min", "max"][trial % 2], "patience": 1 + trial % 3,
                "cooldown": trial % 2, "min_delta": [0.0, 1e-4, 0.05][trial % 3]}
        ours, ref = make_plateau_state(spec), jax_plateau_state(spec)
        values = np.cumsum(rng.normal(scale=0.05, size=30)) + 1.0
        assert [plateau_update(ours, float(v)) for v in values] == \
               [jax_plateau_update(ref, float(v)) for v in values]


def test_checkpoint_best_and_latest_round_trip(tmp_path):
    model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                           depth_override=1, device="cpu", seed=1)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
    loss_fn, _ = build_losses_and_metrics("charbonnier")
    step = make_sr_train_step(model, loss_fn)
    hr = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    ckpt = CheckpointManager(tmp_path, monitor="val_loss", mode="min", max_to_keep=1)
    saved = {}
    for epoch, val_loss in enumerate([0.3, 0.1, 0.2, float("inf")], start=1):
        state, _ = step(state, hr)
        ckpt.save(epoch, state, metrics={"val_loss": val_loss, "val_psnr": float("inf")})
        saved[epoch] = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt.save(2, state, metrics={"val_loss": 0.0})  # at or below the latest: dropped
    assert sorted(int(p.name) for p in tmp_path.iterdir() if p.is_dir()) == [2, 4]
    assert (ckpt.best_step(), ckpt.latest_step()) == (2, 4)
    with pytest.raises(FileExistsError):
        ckpt.save(2, state, force=True)
    for restore, epoch in ((ckpt.restore_latest, 4), (ckpt.restore_best, 2)):
        fresh_model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                                     depth_override=1, device="cpu", seed=9)
        fresh = create_train_state(fresh_model, make_optimizer(fresh_model.parameters(), 1e-3))
        restore(fresh)
        assert fresh.step == epoch
        for name, value in saved[epoch].items():
            assert torch.equal(fresh_model.state_dict()[name], value), name
        moments = fresh.optimizer.state_dict()["state"]
        assert len(moments) == len(list(fresh_model.parameters()))
        assert int(moments[0]["step"]) == epoch
    ckpt.write_config({"scale": 0.5})
    assert json.loads((tmp_path / "config.json").read_text()) == {"scale": 0.5}


def test_epoch_metrics_csv_has_the_reference_columns(tmp_path):
    hr = np.random.default_rng(1).random((4, 32, 32, 3), dtype=np.float32)

    def feed():
        while True:
            yield hr

    jmodel, _ = build_jax(0.5, base_channels=8, residual_head_channels=8, depth_override=1,
                          input_size=32)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, 32, 32, 3)), jax_optimizer(1e-3))
    jloss, _ = jax_losses("charbonnier")
    jax_fit(jstate, feed(), jax_train_step(jmodel, jloss, donate=False), steps_per_epoch=1,
            epochs=1, val_data=[hr], val_step=jax_val_step(jmodel, jloss, per_sample=True),
            log_dir=tmp_path / "jax", verbose=0)

    model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                           depth_override=1, device="cpu")
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
    loss_fn, _ = build_losses_and_metrics("charbonnier")
    fit(state, feed(), make_sr_train_step(model, loss_fn), steps_per_epoch=1, epochs=1,
        val_data=[hr], val_step=make_sr_val_step(model, loss_fn, per_sample=True),
        log_dir=tmp_path / "torch", verbose=0)
    header = [(tmp_path / d / "epoch_metrics.csv").read_text().splitlines()[0] for d in ("jax", "torch")]
    assert header[0] == header[1] == "epoch,steps,duration_s,ms_per_step,loss,psnr,val_loss,val_psnr"


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("hr_tiny")
    rng = np.random.default_rng(0)
    for i in range(8):
        coarse = rng.random((12, 12, 3), dtype=np.float32)
        np.save(root / f"img{i}.npy", np.repeat(np.repeat(coarse, 4, 0), 4, 1))  # 48x48 smooth
    return root


def _cli_args(corpus, tmp_path, *extra):
    return ["--scale", "0.5", "--depth_override", "1", "--base_channels", "8",
            "--residual_head_channels", "8", "--patch_size", "32", "--patches_per_image", "2",
            "--batch_size", "8", "--epochs", "2", "--patience", "5",
            "--high_res_dir", str(corpus), "--image_suffix", ".npy",
            "--model_dir", str(tmp_path / "models"), "--log_dir", str(tmp_path / "logs"),
            "--run_name", "e2e", "--seed", "7", *extra]


def test_train_sr_cli_on_cpu(tiny_corpus, tmp_path, capsys):
    from adunet_torch.cli.train_sr import main

    out = main(_cli_args(tiny_corpus, tmp_path, "--device", "cpu", "--device_cache",
                         "--grad_accum", "2"))
    run_dir = tmp_path / "logs" / "e2e"
    cfg = json.loads((run_dir / "config.json").read_text())
    assert (cfg["depth"], cfg["steps_per_epoch"], cfg["device"]) == (1, 2, "cpu")
    assert (run_dir / "model_summary.txt").exists()
    rows = list(csv.DictReader(open(run_dir / "epoch_metrics.csv")))
    assert len(rows) == 2 and all(np.isfinite(float(r["val_loss"])) for r in rows)
    ckpt_dir = tmp_path / "models" / "unet_adaptive_scale0.50_depth1"
    assert (ckpt_dir / "config.json").exists()
    ckpt = CheckpointManager(ckpt_dir)
    assert ckpt.latest_step() == 2 and ckpt.best_step() in (1, 2)
    printed = capsys.readouterr().out
    assert "Validation patches evaluated: 1" in printed and "Test patches evaluated: 1" in printed
    assert printed.count("PSNR(Y)") == 2
    assert np.isfinite(out["eval"]["test"]["psnr_mean"])
    # the live weights are the best epoch's, as the best checkpoint holds them
    fresh_model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                                 depth_override=1, device="cpu", seed=3)
    fresh = create_train_state(fresh_model, make_optimizer(fresh_model.parameters(), 1e-4))
    ckpt.restore_best(fresh)
    for name, value in out["state"].model.state_dict().items():
        assert torch.equal(fresh_model.state_dict()[name], value), name


def test_train_sr_cli_refusals(tiny_corpus, tmp_path):
    """Several devices need one process each: in a plain process
    ``--n_devices`` / ``--model_shards`` above 1 raise with the ``torchrun``
    line to use (multi-process runs: ``tests/test_torch_parallel_cli.py``);
    the streamed pipeline, remat and the combined loss run
    (``tests/test_torch_sr_cli.py``). The default device needs a GPU."""
    from adunet_torch.cli.train_sr import main

    for flags in (("--n_devices", "2"), ("--model_shards", "2")):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m "
                                             "adunet_torch.cli.train_sr "):
            main(_cli_args(tiny_corpus, tmp_path, "--device", "cpu", *flags))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(_cli_args(tiny_corpus, tmp_path, "--device_cache"))
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(_cli_args(tiny_corpus, tmp_path, "--remat_levels", "1"))


def test_eval_feed_and_evaluate_sr_match_reference(tmp_path, perturb_params):
    """The CLI's validation / evaluation feed and its Y-channel tail: the same
    images give the reference's file order, split, grid batches and labels
    (ragged last batch included), and the same perturbed weights give its
    per-patch metrics. Tolerance: PSNR / SSIM / MS-SSIM rtol 1e-4, MSE atol
    1e-7 (float32 forwards in two frameworks)."""
    from adunet.data.discovery import find_images as jax_find
    from adunet.data.sr_pipeline import make_eval_patch_dataset as jax_eval_ds
    from adunet.evaluate.evaluator import evaluate_sr as jax_evaluate
    from adunet.utils.misc import split_indices as jax_split
    from adunet_torch.convert import state_dict_from_flax
    from adunet_torch.data import find_images, make_eval_patch_dataset
    from adunet_torch.evaluate import evaluate_sr
    from adunet_torch.utils.misc import split_indices

    rng = np.random.default_rng(9)
    for i, (h, w) in enumerate([(40, 56), (48, 48), (32, 72), (64, 40), (36, 36)]):
        np.save(tmp_path / f"img{i + 8}.npy", (rng.random((h, w, 3)) * 255).astype(np.uint8))
    paths = find_images(tmp_path, ".npy")
    assert paths == jax_find(tmp_path, ".npy")
    for got, want in zip(split_indices(len(paths), 0.6, 0.2, 0.2, 3),
                         jax_split(len(paths), 0.6, 0.2, 0.2, 3)):
        np.testing.assert_array_equal(got, want)

    ds, count, labels = make_eval_patch_dataset(paths, patch_size=32, scale=0.5, batch_size=4,
                                                stride=16)
    jds, jcount, jlabels = jax_eval_ds(paths, patch_size=32, scale=0.5, batch_size=4, stride=16)
    assert (count, labels) == (jcount, jlabels)
    batches, jbatches = list(ds), list(jds)
    assert [b.shape[0] for b in batches] == [b.shape[0] for b in jbatches] and count % 4
    for got, want in zip(batches, jbatches):
        np.testing.assert_array_equal(got, want)

    jmodel, _ = build_jax(0.5, base_channels=8, residual_head_channels=8, depth_override=1,
                          input_size=32)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, 32, 32, 3)), jax_optimizer(1e-4))
    jstate = jstate.replace(params=perturb_params(jstate.params))
    tmodel, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                            depth_override=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(jstate.params)))
    tstate = create_train_state(tmodel, make_optimizer(tmodel.parameters(), 1e-4))
    summary, rows = evaluate_sr(tstate, ds, eval_scale=0.5, eval_shave=4)
    jsummary, jrows = jax_evaluate(jstate, jds, eval_scale=0.5, eval_shave=4)
    assert summary.samples == jsummary.samples == count == len(rows) == len(jrows)
    for key in ("psnr_y", "ssim_y", "msssim_y"):
        np.testing.assert_allclose([r[key] for r in rows], [r[key] for r in jrows], rtol=1e-4)
    np.testing.assert_allclose([r["mse_y"] for r in rows], [r["mse_y"] for r in jrows], atol=1e-7)
    np.testing.assert_allclose(summary.psnr_mean, jsummary.psnr_mean, rtol=1e-4)
