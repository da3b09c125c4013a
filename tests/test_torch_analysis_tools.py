"""The port's copies of the analysis CLIs against ``adunet.cli``'s.

``export_log_metrics``, ``analyse_experiment_metrics`` and
``plot_experiment_metrics`` import no JAX, and the port keeps its own copies
(it imports nothing of ``adunet``). Here both packages' versions read the
same run directory, written by the port's ``train_sr`` (its stdout
transcript and ``epoch_metrics.csv``) and ``evaluate`` (``metrics.json``,
``per_image_metrics.csv``), and must write byte-identical CSVs.
"""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest

from adunet.cli import analyse_experiment_metrics as jax_analyse
from adunet.cli import export_log_metrics as jax_export
from adunet.cli import plot_experiment_metrics as jax_plot
from adunet_torch.cli import analyse_experiment_metrics as torch_analyse
from adunet_torch.cli import export_log_metrics as torch_export
from adunet_torch.cli import plot_experiment_metrics as torch_plot


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Two tiny port runs at scales 0.5 and 0.6 (stdout kept as a
    transcript), each evaluated by the port's evaluator."""
    from adunet_torch.cli.evaluate import main as eval_main
    from adunet_torch.cli.train_sr import main as train_main

    root = tmp_path_factory.mktemp("analysis")
    hr = root / "hr"
    hr.mkdir()
    rng = np.random.default_rng(1)
    for i in range(6):
        coarse = rng.random((12, 12, 3), dtype=np.float32)
        np.save(hr / f"im{i}.npy", np.repeat(np.repeat(coarse, 4, 0), 4, 1))
    for scale in (0.5, 0.6):
        name = f"run_scale{scale:.2f}"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_main(["--device", "cpu", "--scale", str(scale), "--depth_override", "1",
                        "--base_channels", "4", "--residual_head_channels", "4",
                        "--patch_size", "32", "--patches_per_image", "2", "--batch_size", "4",
                        "--epochs", "2", "--high_res_dir", str(hr), "--image_suffix", ".npy",
                        "--model_dir", str(root / "models"), "--log_dir", str(root / "logs"),
                        "--run_name", name, "--device_cache", "--seed", "3"])
            eval_main(["--device", "cpu", "--model-path",
                       str(root / "models" / f"unet_adaptive_scale{scale:.2f}_depth1"),
                       "--scale", str(scale), "--hr-dir", str(hr), "--image-suffix", ".npy",
                       "--patch-size", "32", "--output-dir", str(root / "evaluation"),
                       "--run-name", f"{name}_eval"])
        transcripts = root / "transcripts" / name
        transcripts.mkdir(parents=True)
        (transcripts / "run-simple-1.log").write_text(out.getvalue())
    return root


def _main(mod, argv, monkeypatch):
    """A CLI's ``main()`` on ``argv`` (the reference's reads ``sys.argv``)."""
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()


def _files(root: Path, pattern: str) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.glob(pattern))}


def test_export_log_metrics_writes_identical_csvs(run_dir, tmp_path):
    for name, mod in (("jax", jax_export), ("torch", torch_export)):
        results = mod.process_logs(run_dir / "transcripts", tmp_path / name)
        assert [r for r, _ in results] == ["run_scale0.50", "run_scale0.60"]
    got, want = _files(tmp_path / "torch", "*/epoch_metrics.csv"), _files(tmp_path / "jax",
                                                                        "*/epoch_metrics.csv")
    assert got == want and len(want) == 2
    rows = want["run_scale0.50/epoch_metrics.csv"].decode().splitlines()
    assert len(rows) == 3 and rows[0].startswith("epoch,steps_completed")
    assert all(r.split(",")[5] for r in rows[1:])  # the transcripts' losses were read


def test_analyse_experiment_metrics_writes_identical_summaries(run_dir, tmp_path, monkeypatch):
    """Both read the trainers' own ``epoch_metrics.csv`` files."""
    for name, mod in (("jax", jax_analyse), ("torch", torch_analyse)):
        _main(mod, ["--csv-root", str(run_dir / "logs"), "--output-dir", str(tmp_path / name)],
              monkeypatch)
        assert (tmp_path / name / "trend_quality_vs_scale.png").exists()
    got, want = (tmp_path / "torch" / "run_summaries.csv").read_bytes(), (
        tmp_path / "jax" / "run_summaries.csv").read_bytes()
    assert got == want
    assert want.decode().splitlines()[1].startswith("run_scale0.50,0.5,")


def test_plot_experiment_metrics_writes_identical_tables(run_dir, tmp_path, monkeypatch):
    for name, mod in (("jax", jax_plot), ("torch", torch_plot)):
        _main(mod, ["--experiment-dir", str(run_dir), "--output-dir", str(tmp_path / name)],
              monkeypatch)
        assert (tmp_path / name / "boxplot_psnr_y.png").exists()
    got, want = (tmp_path / "torch" / "summary_metrics.csv").read_bytes(), (
        tmp_path / "jax" / "summary_metrics.csv").read_bytes()
    assert got == want
    rows = want.decode().splitlines()
    assert rows[0].startswith("scale,psnr_mean") and [r.split(",")[0] for r in rows[1:]] == [
        "0.5", "0.6"]
