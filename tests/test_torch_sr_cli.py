"""The port's SR report writer, tiled restoration, async checkpoints and the
remaining SR entry points on the CPU.

- ``write_outputs``: on the same converted weights and patches, the port's
  ``config.json``, ``metrics.json`` and ``per_image_metrics.csv`` hold the
  reference's keys, columns and labels, and its numbers within 1e-5
  relative (float32 forwards in two frameworks), a std within 1e-5 of its
  metric's mean (it carries the metric's absolute error);
- ``_tile_starts``, ``_blend_weights`` and ``restore_image`` give the
  reference's offsets, weights and stitched output (to 1e-6);
- an async checkpoint writes the bytes a synchronous one writes, snapshots
  the state before a later step changes it, and hands a write error to the
  caller;
- tiny runs of ``train_sr`` (streamed float32 / uint8 feed, ``--low_res_dir``;
  the TensorBoard events hold the reference's tags),
  ``train_sr_depth3`` (``--remat_levels``, ``--loss combined``, async
  checkpoints bit-equal to a synchronous run), ``train_sr_vanilla``,
  ``evaluate`` and ``restore`` on ``--device cpu``.
"""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.cli import restore as jax_restore
from adunet.data import make_eval_patch_dataset as jax_eval_ds
from adunet.evaluate import attach_filenames as jax_attach
from adunet.evaluate import evaluate_sr as jax_evaluate
from adunet.evaluate import write_outputs as jax_write_outputs
from adunet.models import build_super_resolution_unet as build_jax
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet_torch.cli import restore
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.data import find_images, load_rgb_image_full, make_eval_patch_dataset
from adunet_torch.evaluate import attach_filenames, evaluate_sr, write_outputs
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

torch.set_num_threads(4)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten smooth 48x48 uint8 HR images and their LR counterparts (same names)."""
    root = tmp_path_factory.mktemp("sr_cli")
    rng = np.random.default_rng(0)
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    for i in range(10):
        coarse = rng.random((12, 12, 3), dtype=np.float32)
        img = np.repeat(np.repeat(coarse, 4, 0), 4, 1)
        np.save(root / "hr" / f"img{i}.npy", np.round(img * 255).astype(np.uint8))
        np.save(root / "lr" / f"img{i}.npy",
                np.round(np.clip(img + 0.05 * rng.normal(size=img.shape), 0, 1) * 255)
                .astype(np.uint8))
    return root


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_write_outputs_matches_the_references_reports(corpus, tmp_path, perturb_params):
    paths = find_images(corpus / "hr", ".npy")[:3]
    jmodel, _ = build_jax(0.5, base_channels=8, residual_head_channels=8, depth_override=1,
                          input_size=32)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, 32, 32, 3)), jax_optimizer(1e-4))
    jstate = jstate.replace(params=perturb_params(jstate.params))
    tmodel, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                            depth_override=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(jstate.params)))
    tstate = create_train_state(tmodel, make_optimizer(tmodel.parameters(), 1e-4))
    config = {"scale": 0.5, "patch_size": 32, "images": 3}
    for name, evaluate, attach, write, make_ds, state in (
            ("jax", jax_evaluate, jax_attach, jax_write_outputs, jax_eval_ds, jstate),
            ("torch", evaluate_sr, attach_filenames, write_outputs, make_eval_patch_dataset,
             tstate)):
        ds, _, labels = make_ds(paths, patch_size=32, scale=0.5, batch_size=3, stride=16)
        summary, rows = evaluate(state, ds, eval_scale=0.5, eval_shave=4)
        attach(rows, labels)
        write(tmp_path / name, summary, rows, config)
    for fname in ("config.json", "metrics.json"):
        want = json.loads((tmp_path / "jax" / fname).read_text())
        got = json.loads((tmp_path / "torch" / fname).read_text())
        assert list(got) == list(want), fname
        for key, value in want.items():
            if key.endswith("_std"):  # a std carries its metric's absolute error
                scale = abs(want[key.replace("_std", "_mean")])
                np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-5 * scale,
                                           err_msg=key)
            elif isinstance(value, float):
                np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)
            else:
                assert got[key] == value, key
    want_rows = _read_csv(tmp_path / "jax" / "per_image_metrics.csv")
    got_rows = _read_csv(tmp_path / "torch" / "per_image_metrics.csv")
    assert len(got_rows) == len(want_rows) == 12
    assert list(got_rows[0]) == list(want_rows[0]) == ["index", "filename", "psnr_y", "ssim_y",
                                                       "msssim_y", "mse_y"]
    for g, w in zip(got_rows, want_rows):
        assert (g["index"], g["filename"]) == (w["index"], w["filename"])
        for key in ("psnr_y", "ssim_y", "msssim_y", "mse_y"):
            np.testing.assert_allclose(float(g[key]), float(w[key]), rtol=1e-5, err_msg=key)
    write_outputs(tmp_path / "bare", evaluate_sr(tstate, make_eval_patch_dataset(
        paths, patch_size=32, scale=0.5, batch_size=3)[0], 0.5, 4)[0], [], config,
        write_per_image=False)
    assert sorted(p.name for p in (tmp_path / "bare").iterdir()) == ["config.json", "metrics.json"]
    with pytest.raises(ValueError, match="metric rows"):
        attach_filenames([{}], ["a", "b"])


@pytest.mark.parametrize("extent, patch, overlap", [(300, 256, 32), (256, 256, 32), (100, 256, 8),
                                                    (1000, 256, 200), (513, 64, 0)])
def test_tile_starts_and_blend_weights_match_the_reference(extent, patch, overlap):
    assert restore._tile_starts(extent, patch, overlap) == jax_restore._tile_starts(extent, patch,
                                                                                    overlap)
    np.testing.assert_array_equal(restore._blend_weights(patch, overlap),
                                  jax_restore._blend_weights(patch, overlap))


@pytest.mark.parametrize("h, w", [(75, 105), (20, 40), (64, 64)])
def test_restore_image_matches_the_reference(h, w):
    image = np.random.default_rng(h).random((h, w, 3), dtype=np.float32)

    def fn(t):  # depends on the whole tile, so a misplaced tile shows
        t = np.asarray(t, np.float32)
        return 0.8 * t ** 2 + 0.2 * t.mean(axis=(1, 2), keepdims=True)

    got = restore.restore_image(image, fn, 32, 8, 3)
    want = jax_restore.restore_image(image, lambda t: jnp.asarray(fn(t)), 32, 8, 3)
    assert got.shape == image.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def _tiny_state(seed=1):
    model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                           depth_override=1, device="cpu", seed=seed)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3))
    for p in model.parameters():  # give Adam moments to snapshot
        p.grad = torch.full_like(p, 0.1)
    state.apply_gradients()
    return state


def test_async_save_writes_the_sync_bytes_and_snapshots_first(tmp_path, monkeypatch):
    state = _tiny_state()
    sync = CheckpointManager(tmp_path / "sync")
    sync.save(1, state, metrics={"val_loss": 0.5})
    want = {n: v.clone() for n, v in state.model.state_dict().items()}
    async_mngr = CheckpointManager(tmp_path / "async", async_save=True)
    async_mngr.save(1, state, metrics={"val_loss": 0.5})
    with torch.no_grad():  # the next step, before the write is done
        for p in state.model.parameters():
            p.add_(1.0)
    async_mngr.wait()
    for fname in ("state.pt", "metrics.json"):
        assert (tmp_path / "async" / "1" / fname).read_bytes() == \
               (tmp_path / "sync" / "1" / fname).read_bytes()
    fresh = _tiny_state(seed=5)
    async_mngr.restore_latest(fresh)
    for name, value in want.items():
        assert torch.equal(fresh.model.state_dict()[name], value), name

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    async_mngr.save(2, state, metrics={"val_loss": 0.4})
    with pytest.raises(OSError, match="disk full"):
        async_mngr.close()
    async_mngr.close()  # the error is raised once


def _train_args(corpus, tmp_path, *extra, name="t"):
    return ["--scale", "0.5", "--depth_override", "1", "--base_channels", "8",
            "--residual_head_channels", "8", "--patch_size", "32", "--patches_per_image", "2",
            "--batch_size", "4", "--epochs", "2", "--patience", "5", "--shuffle_buffer", "8",
            "--high_res_dir", str(corpus / "hr"), "--image_suffix", ".npy",
            "--model_dir", str(tmp_path / f"models_{name}"), "--log_dir", str(tmp_path / "logs"),
            "--run_name", name, "--seed", "7", "--device", "cpu", *extra]


@pytest.mark.parametrize("extra, mode, steps", [
    ((), "synthetic_patches", 4),                          # 8 train images x 2 / 4
    (("--uint8_feed", "--cache_decoded"), "synthetic_patches", 4),
    (("--low_res_dir", "LR"), "paired_directory", 2),      # 8 whole images / 4
])
def test_train_sr_cli_data_paths(corpus, tmp_path, capsys, extra, mode, steps):
    from adunet_torch.cli.train_sr import main

    extra = tuple(str(corpus / "lr") if e == "LR" else e for e in extra)
    out = main(_train_args(corpus, tmp_path, *extra))
    cfg = json.loads((Path(out["run_dir"]) / "config.json").read_text())
    assert (cfg["low_res_mode"], cfg["steps_per_epoch"], out["history_epochs"]) == (mode, steps, 2)
    rows = _read_csv(Path(out["run_dir"]) / "epoch_metrics.csv")
    assert len(rows) == 2 and all(np.isfinite(float(r["val_loss"])) for r in rows)
    assert CheckpointManager(out["ckpt_dir"]).latest_step() == 2
    printed = capsys.readouterr().out
    assert printed.count("PSNR(Y)") == 2 and np.isfinite(out["eval"]["test"]["psnr_mean"])
    # the reference's TensorBoard tags (tests/test_cli_e2e.py:58-67), fit's
    # epoch scalars and the post-training eval scalars
    blob = b"".join(f.read_bytes() for f in Path(out["run_dir"]).glob("events.out.tfevents.*"))
    for tag in (b"config/hyperparameters", b"model/summary", b"dataset/images/train",
                b"dataset/patches_per_epoch/train", b"samples/hr_train", b"samples/lr_train",
                b"hist/hr_train", b"hist/lr_train", b"train/loss", b"val/psnr",
                b"perf/ms_per_step", b"perf/images_per_sec", b"eval/test_psnr_y"):
        assert tag in blob, f"missing TensorBoard tag {tag!r}"


def test_train_sr_depth3_remat_combined_async_equals_sync(corpus, tmp_path):
    """``train_sr_depth3`` pins depth 3 whatever ``--depth_override`` says;
    with ``--async_checkpoint`` its best and latest states load bit-equal to
    a synchronous run's from the same seed."""
    from adunet_torch.cli.train_sr_depth3 import main

    states = {}
    for name, extra in (("sync", ()), ("async", ("--async_checkpoint",))):
        out = main(_train_args(corpus, tmp_path, "--remat_levels", "1", "--loss", "combined",
                               *extra, name=name))
        assert Path(out["ckpt_dir"]).name == "unet_adaptive_scale0.50_depth3"
        ckpt = CheckpointManager(out["ckpt_dir"])
        states[name] = {}
        for which, step in (("best", ckpt.best_step()), ("latest", ckpt.latest_step())):
            states[name][which] = torch.load(Path(out["ckpt_dir"]) / str(step) / "state.pt",
                                             weights_only=True)
    for which in ("best", "latest"):
        a, b = states["sync"][which], states["async"][which]
        assert a["step"] == b["step"]
        for name, value in a["model"].items():
            assert torch.equal(b["model"][name], value), (which, name)


def test_train_sr_vanilla_cli(corpus, tmp_path, capsys):
    from adunet_torch.cli.train_sr_vanilla import main

    out = main(["--high_res_dir", str(corpus / "hr"), "--low_res_dir", str(corpus / "lr"),
                "--hr_size", "32", "--batch_size", "4", "--epochs", "2", "--base_channels", "4",
                "--async_checkpoint", "--model_dir", str(tmp_path / "models"),
                "--log_dir", str(tmp_path / "logs"), "--run_name", "v", "--device", "cpu"])
    cfg = json.loads((Path(out["run_dir"]) / "config.json").read_text())
    assert list(cfg) == ["run_name", "loss", "epochs_ran", "best_epoch", "results", "created_at"]
    assert (cfg["loss"], cfg["epochs_ran"]) == ("combined", 2)
    assert set(cfg["results"]) == {"validation", "test"}
    assert set(cfg["results"]["test"]) == {"psnr", "ssim", "ms_ssim"}
    assert all(np.isfinite(m) for m, _ in cfg["results"]["test"].values())
    assert CheckpointManager(out["ckpt_dir"]).latest_step() == 2
    assert "test: psnr=" in capsys.readouterr().out
    moved = [n for n, b in out["state"].model.named_buffers() if "running_mean" in n
             and float(b.abs().max()) > 0]
    assert moved


def test_evaluate_and_restore_clis(corpus, tmp_path):
    from adunet_torch.cli.evaluate import main as evaluate_main
    from adunet_torch.cli.train_sr import main as train_main

    out = train_main(_train_args(corpus, tmp_path, name="e"))
    result = evaluate_main(["--model-path", out["ckpt_dir"], "--scale", "0.5",
                            "--hr-dir", str(corpus / "hr"), "--image-suffix", ".npy",
                            "--patch-size", "32", "--batch-size", "3", "--limit", "2",
                            "--output-dir", str(tmp_path / "eval"), "--run-name", "r",
                            "--device", "cpu"])
    run_dir = tmp_path / "eval" / "r"
    assert sorted(p.name for p in run_dir.iterdir()) == ["config.json", "metrics.json",
                                                         "per_image_metrics.csv"]
    metrics = json.loads((run_dir / "metrics.json").read_text())
    assert metrics["samples"] == 2 and np.isfinite(metrics["psnr_mean"])
    assert json.loads((run_dir / "config.json").read_text())["depth"] == 1
    assert _read_csv(run_dir / "per_image_metrics.csv")[1]["filename"] == "img1.npy#patch0000"
    assert result["summary"].samples == 2

    odd = tmp_path / "odd"
    odd.mkdir()
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate([(45, 70), (30, 50)]):
        np.save(odd / f"o{i}.npy", rng.random((h, w, 3), dtype=np.float32))
    written = restore.main(["--model-path", out["ckpt_dir"], "--scale", "0.5",
                            "--input-dir", str(odd), "--output-dir", str(tmp_path / "restored"),
                            "--image-suffix", ".npy", "--patch-size", "32", "--overlap", "8",
                            "--batch-size", "4", "--device", "cpu"])
    assert len(written) == 2
    for path, shape in zip(written, [(45, 70, 3), (30, 50, 3)]):
        arr = load_rgb_image_full(path)  # a PNG where cv2 is importable, else .npy
        assert arr.shape == shape and np.isfinite(arr).all()
        assert 0.0 <= arr.min() and arr.max() <= 1.0


def test_restore_from_an_exported_artifact(tmp_path):
    big = tmp_path / "in"
    big.mkdir()
    np.save(big / "x.npy", np.random.default_rng(4).random((260, 300, 3), dtype=np.float32))
    written = restore.main(["--from-export", str(ROOT / "experiments" / "round4_sweep"
                                                 / "export_scale0.2_int8"),
                            "--scale", "0.2", "--input-dir", str(big),
                            "--output-dir", str(tmp_path / "out"), "--image-suffix", ".npy",
                            "--device", "cpu"])
    arr = load_rgb_image_full(written[0])
    assert arr.shape == (260, 300, 3) and np.isfinite(arr).all()
    # an artifact with its weights baked into StableHLO: the server's error
    baked = tmp_path / "baked"
    baked.mkdir()
    (baked / "manifest.json").write_text(json.dumps({"format": "jax.export.stablehlo",
                                                     "input_shape": [8, 256, 256, 3]}))
    with pytest.raises(ValueError, match="baked into the StableHLO"):
        restore.main(["--from-export", str(baked), "--scale", "0.2", "--input-dir", str(big),
                      "--output-dir", str(tmp_path / "out2"), "--image-suffix", ".npy",
                      "--device", "cpu"])
    with pytest.raises(SystemExit):
        restore.parse_args(["--from-export", str(baked), "--model-path", "m", "--scale", "0.5",
                            "--input-dir", "i", "--output-dir", "o"])
    with pytest.raises(SystemExit):
        restore.parse_args(["--model-path", "m", "--input-dir", "i", "--output-dir", "o"])
