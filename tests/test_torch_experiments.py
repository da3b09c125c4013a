"""The port's sweep driver against the JAX package's (``adunet.experiments``,
``adunet.cli.run_experiment``).

Under ``--reference_batches`` (the 2080 Ti tables) the port plans every run
the reference plans, argument for argument, for the five experiments: the
only difference allowed is the module path (``adunet_torch.cli`` for
``adunet.cli``). The metadata files carry the same keys and values (but the
creation time), the ``paths`` environment overrides agree, and a tiny
``--mode run --auto_eval --device cpu`` trains one scale and writes the
evaluator's report.
"""

import contextlib
import importlib
import io
from pathlib import Path

import numpy as np
import pytest

from adunet.cli import run_experiment as jax_cli
from adunet.configs import paths as jax_paths
from adunet.experiments import sweep_runs as jax_sweep_runs
from adunet_torch.cli import run_experiment as torch_cli
from adunet_torch.configs import paths as torch_paths
from adunet_torch.experiments import (
    EXPERIMENT1_SCALES,
    EXPERIMENT2_DEPTHS,
    H100_BATCH_SIZES,
    sweep_runs,
    write_metadata,
)

_SEG_DIRS = {k: f"/data/{k}" for k in ("train_images", "train_masks", "val_images", "val_masks")}
_SEG_ARGS = ["--train_images", "/d/ti", "--train_masks", "/d/tm", "--val_images", "/d/vi",
             "--val_masks", "/d/vm"]
_EXPERIMENTS = {
    "fixed_depth": ["--high_res_dir", "/data/hr"],
    "adaptive_depth": ["--high_res_dir", "/data/hr"],
    "seg_protocols": _SEG_ARGS,
    "tune_sr": ["--high_res_dir", "/data/hr", "--n_trials", "7"],
    "tune_seg": _SEG_ARGS,
}


def _plans(fn, experiment, **kw):
    return [(p.name, p.argv, p.metadata) for p in fn(experiment, **kw)]


@pytest.mark.parametrize("kw", [
    {"experiment": "fixed_depth", "high_res_dir": "/data/hr"},
    {"experiment": "adaptive_depth", "high_res_dir": "/data/hr", "epochs": 7, "seed": 3,
     "mixed_precision": False, "extra_args": ["--patience", "5"]},
    {"experiment": "adaptive_depth", "high_res_dir": "/data/hr", "scales": [0.5, 0.8]},
    {"experiment": "seg_protocols", "seg_dirs": _SEG_DIRS, "protocols": ("A", "B"),
     "seeds": (1, 2)},
    {"experiment": "seg_protocols", "seg_dirs": _SEG_DIRS, "epochs": 3},
])
def test_sweep_runs_equal_the_reference_plans(kw):
    kw = dict(kw)
    experiment = kw.pop("experiment")
    assert _plans(sweep_runs, experiment, h100_batches=False, **kw) == _plans(
        jax_sweep_runs, experiment, tpu_batches=False, **kw)


def test_h100_table_covers_every_scale():
    """Every scale of both sweeps has an H100 batch, and the SR plans take it."""
    assert set(EXPERIMENT1_SCALES) | set(EXPERIMENT2_DEPTHS) <= set(H100_BATCH_SIZES)
    for plan in sweep_runs("adaptive_depth", high_res_dir="/data/hr"):
        assert plan.metadata["batch_size"] == H100_BATCH_SIZES[plan.metadata["scale"]]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _metadata(path: Path) -> dict:
    rows = dict(line.split(": ", 1) for line in path.read_text().splitlines())
    assert "created_at" in rows
    rows.pop("created_at")
    return rows


@pytest.mark.parametrize("experiment", sorted(_EXPERIMENTS))
def test_print_mode_and_metadata_equal_the_reference(tmp_path, experiment):
    outs = {}
    for name, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        outs[name] = _run(main, ["--experiment", experiment, "--mode", "print",
                                 "--reference_batches", "--scales", "0.5", "0.7",
                                 "--metadata_dir", str(tmp_path / name / "meta"),
                                 "--log_dir", "runs/logs", *_EXPERIMENTS[experiment]])
    assert "adunet_torch.cli." in outs["torch"] and "adunet.cli." not in outs["torch"]
    assert outs["torch"].replace("adunet_torch.cli.", "adunet.cli.") == outs["jax"]
    jax_meta = sorted((tmp_path / "jax" / "meta").glob("*.txt"))
    torch_meta = sorted((tmp_path / "torch" / "meta").glob("*.txt"))
    assert [p.name for p in torch_meta] == [p.name for p in jax_meta] and jax_meta
    for t, j in zip(torch_meta, jax_meta):
        assert _metadata(t) == _metadata(j)


@pytest.mark.parametrize("experiment", sorted(_EXPERIMENTS))
def test_sbatch_mode_equals_the_reference(tmp_path, experiment):
    for name, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        _run(main, ["--experiment", experiment, "--mode", "sbatch", "--reference_batches",
                    "--scales", "0.5", "--metadata_dir", str(tmp_path / name / "meta"),
                    "--sbatch_dir", str(tmp_path / name / "sbatch"), "--log_dir", "runs/logs",
                    *_EXPERIMENTS[experiment]])
    jax_scripts = sorted((tmp_path / "jax" / "sbatch").glob("*.sbatch"))
    torch_scripts = sorted((tmp_path / "torch" / "sbatch").glob("*.sbatch"))
    assert [p.name for p in torch_scripts] == [p.name for p in jax_scripts] and jax_scripts
    for t, j in zip(torch_scripts, jax_scripts):
        text = t.read_text()
        assert "python -m adunet_torch.cli." in text
        assert text.replace("adunet_torch.cli.", "adunet.cli.") == j.read_text()


def test_device_flag_reaches_the_printed_commands(tmp_path):
    """--device cpu is named on each planned command; the default is not."""
    argv = ["--experiment", "fixed_depth", "--mode", "print", "--scales", "0.5",
            "--high_res_dir", "/data/hr", "--metadata_dir", str(tmp_path)]
    assert "--device" not in _run(torch_cli.main, argv)
    assert _run(torch_cli.main, argv + ["--device", "cpu"]).rstrip().endswith("--device cpu")


def test_metadata_keys_match(tmp_path):
    plan = sweep_runs("fixed_depth", high_res_dir="/data/hr", scales=[0.5], h100_batches=False)[0]
    jplan = jax_sweep_runs("fixed_depth", high_res_dir="/data/hr", scales=[0.5],
                           tpu_batches=False)[0]
    path = write_metadata(plan, tmp_path / "t")
    from adunet.experiments import write_metadata as jax_write_metadata

    assert _metadata(path) == _metadata(jax_write_metadata(jplan, tmp_path / "j"))


def test_paths_env_overrides_agree(monkeypatch):
    names = jax_paths.__all__
    assert torch_paths.__all__ == names
    defaults = {n: getattr(torch_paths, n) for n in names}
    assert defaults == {n: getattr(jax_paths, n) for n in names}
    env = {"ADUNET_HR_TRAIN_DIR": "/x/hr", "ADUNET_ISIC_TEST_MASKS": "~/isic/tm",
           "ADUNET_MODEL_ROOT": "/m", "ADUNET_LOG_ROOT": "rel/logs"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        got = importlib.reload(torch_paths)
        want = importlib.reload(jax_paths)
        assert {n: getattr(got, n) for n in names} == {n: getattr(want, n) for n in names}
        assert got.HR_TRAIN_DIR == Path("/x/hr") and got.MODEL_ROOT == Path("/m")
        assert got.TEST_MASK_DIR == Path("~/isic/tm").expanduser()
    finally:
        for k in env:
            monkeypatch.delenv(k)
        importlib.reload(torch_paths)
        importlib.reload(jax_paths)


def test_run_mode_with_auto_eval_on_the_cpu(tmp_path):
    """Sweep 'run' mode end to end with the port on the CPU: one scale trains,
    the evaluator scores its checkpoint, the reports land in the reference's
    layout."""
    hr = tmp_path / "hr"
    hr.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        coarse = rng.random((12, 12, 3), dtype=np.float32)
        np.save(hr / f"im{i}.npy", np.repeat(np.repeat(coarse, 4, 0), 4, 1))
    torch_cli.main([
        "--experiment", "fixed_depth", "--mode", "run", "--auto_eval", "--device", "cpu",
        "--scales", "0.5", "--epochs", "1", "--high_res_dir", str(hr), "--image_suffix", ".npy",
        "--model_dir", str(tmp_path / "models"), "--log_dir", str(tmp_path / "logs"),
        "--metadata_dir", str(tmp_path / "metadata"), "--reference_batches",
        "--no_mixed_precision", "--eval_patch_size", "32",
        "--extra_args", "--image_suffix", ".npy", "--patch_size", "32", "--patches_per_image",
        "1", "--batch_size", "4", "--base_channels", "8", "--residual_head_channels", "8",
    ])
    assert (tmp_path / "metadata" / "exp_fixed_depth_scale0.50_depth3.txt").exists()
    assert (tmp_path / "models" / "unet_adaptive_scale0.50_depth3" / "config.json").exists()
    report = tmp_path / "logs" / "evaluation" / "exp_fixed_depth_scale0.50_depth3_eval"
    assert (report / "metrics.json").exists() and (report / "per_image_metrics.csv").exists()
