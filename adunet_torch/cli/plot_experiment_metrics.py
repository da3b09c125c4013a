"""Aggregate evaluation reports into summary CSV + figures.

Port of ``adunet/cli/plot_experiment_metrics.py``, the same code (it imports no JAX): the
port imports nothing of ``adunet``. It reads the run directories the port's
trainers and ``evaluate`` write.

Capability parity with the reference's evaluation plotter
(/root/reference/Super_resolution/code/plot_experiment_metrics.py): walks
``evaluation/*/metrics.json`` + ``per_image_metrics.csv``, writes
``summary_metrics.csv`` in the exact reference schema (the BASELINE.md tables
come from this file), and renders PSNR/SSIM-vs-scale errorbars and per-scale
boxplots. Independent implementation — report directories are discovered by
globbing for ``metrics.json`` and the scale token is parsed with a regex.
"""

from __future__ import annotations

import argparse
import csv
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["extract_scale_from_dir", "load_summary_metrics", "write_summary_csv"]

_SCALE_IN_NAME = re.compile(r"scale(\d+(?:\.\d*)?|\.\d+)")

SUMMARY_FIELDS = [
    "scale",
    "psnr_mean",
    "psnr_std",
    "ssim_mean",
    "ssim_std",
    "msssim_mean",
    "msssim_std",
    "mse_mean",
    "mse_std",
    "samples",
]


def extract_scale_from_dir(name: str) -> float:
    """Parse the scale factor embedded in a report folder name.

    ``exp1_depth3_scale0.50_eval`` -> 0.5. Raises ValueError when the name
    carries no parseable ``scaleN.NN`` token.
    """
    hit = _SCALE_IN_NAME.search(name)
    if hit is None:
        raise ValueError(f"No scale token in report folder name: {name!r}")
    return float(hit.group(1))


def load_summary_metrics(eval_dir: Path) -> List[Dict[str, float]]:
    """Collect every report's metrics.json, keyed by its folder's scale."""
    eval_dir = Path(eval_dir)
    if not eval_dir.is_dir():
        raise FileNotFoundError(f"Evaluation directory does not exist: {eval_dir}")
    rows: List[Dict[str, float]] = []
    for metrics_path in sorted(eval_dir.glob("*/metrics.json")):
        record = dict(json.loads(metrics_path.read_text()))
        record["scale"] = extract_scale_from_dir(metrics_path.parent.name)
        rows.append(record)
    if not rows:
        raise RuntimeError(f"Nothing to aggregate: no */metrics.json under {eval_dir}")
    return sorted(rows, key=lambda record: record["scale"])


def load_per_image_metrics(eval_dir: Path, metric_key: str) -> Tuple[List[List[float]], List[str]]:
    groups: List[List[float]] = []
    labels: List[str] = []
    for folder in sorted(eval_dir.iterdir()):
        csv_path = folder / "per_image_metrics.csv"
        if not csv_path.exists():
            continue
        with csv_path.open() as handle:
            values = [float(row[metric_key]) for row in csv.DictReader(handle) if row.get(metric_key)]
        if values:
            groups.append(values)
            labels.append(f"{extract_scale_from_dir(folder.name):.2f}")
    return groups, labels


def write_summary_csv(rows: List[Dict[str, float]], output_dir: Path) -> Path:
    path = output_dir / "summary_metrics.csv"
    with path.open("w", newline="") as handle:
        writer = csv.DictWriter(handle, fieldnames=SUMMARY_FIELDS)
        writer.writeheader()
        for row in rows:
            writer.writerow({key: row.get(key, "") for key in SUMMARY_FIELDS})
    return path


def plot_summary_lines(rows: List[Dict[str, float]], output_dir: Path, dpi: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scales = [r["scale"] for r in rows]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.errorbar(scales, [r["psnr_mean"] for r in rows], yerr=[r["psnr_std"] for r in rows], fmt="o-")
    ax1.set_xlabel("scale")
    ax1.set_ylabel("PSNR(Y) dB")
    ax2.errorbar(scales, [r["ssim_mean"] for r in rows], yerr=[r["ssim_std"] for r in rows], fmt="s-")
    ax2.set_xlabel("scale")
    ax2.set_ylabel("SSIM(Y)")
    fig.suptitle("Evaluation quality vs scale")
    fig.tight_layout()
    fig.savefig(output_dir / "summary_quality_vs_scale.png", dpi=dpi)
    plt.close(fig)


def plot_boxplot(eval_dir: Path, metric_key: str, output_dir: Path, dpi: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups, labels = load_per_image_metrics(eval_dir, metric_key)
    if not groups:
        return
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.boxplot(groups, tick_labels=labels, showfliers=False)
    ax.set_xlabel("scale")
    ax.set_ylabel(metric_key)
    fig.tight_layout()
    fig.savefig(output_dir / f"boxplot_{metric_key}.png", dpi=dpi)
    plt.close(fig)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Aggregate evaluation reports into summary plots.")
    parser.add_argument("--experiment-dir", type=Path, required=True,
                        help="Directory containing evaluation/ subfolders.")
    parser.add_argument("--output-dir", type=Path, default=None)
    parser.add_argument("--dpi", type=int, default=140)
    args = parser.parse_args(argv)

    experiment_dir = args.experiment_dir.expanduser().resolve()
    eval_dir = experiment_dir / "evaluation"
    if not eval_dir.exists():
        eval_dir = experiment_dir  # allow pointing straight at the eval root
    output_dir = (args.output_dir or experiment_dir / "plots").expanduser().resolve()
    output_dir.mkdir(parents=True, exist_ok=True)

    rows = load_summary_metrics(eval_dir)
    path = write_summary_csv(rows, output_dir)
    plot_summary_lines(rows, output_dir, args.dpi)
    for key in ("psnr_y", "ssim_y"):
        plot_boxplot(eval_dir, key, output_dir, args.dpi)
    print(f"Wrote {path} and figures to {output_dir}")


if __name__ == "__main__":
    main()
