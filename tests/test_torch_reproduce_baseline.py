"""The port's BASELINE runbook, ``scripts/reproduce_baseline_torch.sh``.

The counterpart of ``tests/test_reproduce_baseline.py``: with the synthetic
stand-in corpora and ``--quick``, print mode plans every table's runs with
the port's CLIs (and writes their metadata), and run mode on the CPU
(``--device cpu``) trains, auto-evaluates and tabulates through
``adunet_torch.cli.run_experiment`` and the port's
``plot_experiment_metrics``.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "reproduce_baseline_torch.sh"


def _run(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(CUDA_VISIBLE_DEVICES="-1", OMP_NUM_THREADS="4")
    return subprocess.run(["bash", str(SCRIPT), *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=900)


def test_runbook_print_mode_plans_all_tables(tmp_path):
    out = tmp_path / "repro"
    proc = _run(["--synthetic", "--quick", "--mode", "print", "--out", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "adunet_torch.cli.train_sr" in proc.stdout and "adunet.cli." not in proc.stdout
    assert "exp_fixed_depth_scale0.50_depth3" in proc.stdout
    assert "exp_adaptive_depth_scale0.50_depth3" in proc.stdout
    assert "adunet_torch.cli.train_seg" in proc.stdout
    assert str(out / "synth" / "train_hr") in proc.stdout
    assert "--device" not in proc.stdout  # the default, cuda, is not named
    assert list((out / "fixed_depth" / "metadata").glob("*.txt"))


def test_runbook_quick_run_on_the_cpu_produces_the_tables(tmp_path):
    out = tmp_path / "repro"
    proc = _run(["--synthetic", "--quick", "--mode", "run", "--device", "cpu", "--out", str(out)],
                tmp_path)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    for exp in ("fixed_depth", "adaptive_depth"):
        summary = out / exp / "plots" / "summary_metrics.csv"
        assert summary.read_text().splitlines()[0].startswith("scale,psnr_mean")
        assert list((out / exp / "logs" / "evaluation").glob("*/metrics.json"))
    assert list((out / "seg_protocols" / "logs").glob("**/config.json"))
