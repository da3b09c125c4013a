"""Generate analysis figures from per-epoch CSV exports.

Port of ``adunet/cli/analyse_experiment_metrics.py``, the same code (it imports no JAX): the
port imports nothing of ``adunet``. It reads the run directories the port's
trainers and ``evaluate`` write.

Capability parity with the reference's trend analyser
(/root/reference/Super_resolution/code/analyse_experiment_metrics.py): per-run
best-validation summaries, quality-vs-scale trend, convergence speed, and
training-load figures. Independent implementation: CSVs are parsed into
columns (not row dicts) and the best epoch is selected by a NaN-aware argmin
over the ``val_loss`` column. Accepts both this framework's epoch CSVs
(``steps`` column) and the reference schema (``steps_total``).
"""

from __future__ import annotations

import argparse
import csv
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["RunSummary", "summarize_run", "load_summaries"]

_SCALE_TOKEN = re.compile(r"scale[_=]?(\d*\.?\d+)", re.IGNORECASE)


@dataclass
class RunSummary:
    label: str
    scale: float
    best_epoch: int
    best_val_loss: float
    best_val_psnr: float
    steps_per_epoch: int
    epoch_time_s: float
    ms_per_step: float


def parse_scale(run_name: str) -> float:
    """Pull the shrink factor out of a run directory name like ``run_scale0.50``."""
    hit = _SCALE_TOKEN.search(run_name)
    if hit is None:
        raise ValueError(f"Run name {run_name!r} carries no scale token")
    return float(hit.group(1))


def _read_columns(csv_path: Path) -> Dict[str, List[float]]:
    """Parse an epoch CSV into float columns (NaN where a cell is blank)."""
    with Path(csv_path).open("r", encoding="utf-8", newline="") as fh:
        reader = csv.reader(fh)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"Epoch CSV {csv_path} has no header") from None
        columns: Dict[str, List[float]] = {name: [] for name in header}
        for record in reader:
            # pad short records (e.g. a truncated final line) so every column
            # stays row-aligned for the argmin below
            record = list(record) + [""] * (len(header) - len(record))
            for name, cell in zip(header, record):
                try:
                    columns[name].append(float(cell))
                except ValueError:
                    columns[name].append(math.nan)
    if not any(columns.values()):
        raise ValueError(f"Epoch CSV {csv_path} has no data rows")
    return columns


def _argmin_ignoring_nan(values: Sequence[float]) -> int:
    """Index of the smallest finite-or-inf value; -1 if every entry is NaN."""
    best_idx, best = -1, math.inf
    for idx, value in enumerate(values):
        if not math.isnan(value) and value < best:
            best_idx, best = idx, value
    return best_idx


def summarize_run(csv_path: Path) -> RunSummary:
    """Best-val-loss summary of one run's epoch CSV."""
    csv_path = Path(csv_path)
    cols = _read_columns(csv_path)
    n_rows = max(len(col) for col in cols.values())

    def col(name: str) -> List[float]:
        return cols.get(name) or [math.nan] * n_rows

    idx = _argmin_ignoring_nan(col("val_loss"))
    if idx < 0:
        idx = n_rows - 1  # no validation metrics: fall back to the final epoch

    def at(name: str) -> float:
        series = col(name)
        return series[idx] if idx < len(series) else math.nan

    steps = at("steps_total")
    if math.isnan(steps):
        steps = at("steps")

    def as_int(value: float) -> int:
        return int(value) if math.isfinite(value) else 0

    return RunSummary(
        label=csv_path.parent.name,
        scale=parse_scale(csv_path.parent.name),
        best_epoch=as_int(at("epoch")),
        best_val_loss=at("val_loss"),
        best_val_psnr=at("val_psnr"),
        steps_per_epoch=as_int(steps),
        epoch_time_s=at("duration_s"),
        ms_per_step=at("ms_per_step"),
    )


# Back-compat alias for older callers/tests.
read_run_summary = summarize_run


def load_summaries(csv_root: Path) -> List[RunSummary]:
    paths = sorted(Path(csv_root).glob("*/epoch_metrics.csv"))
    if not paths:
        raise SystemExit(f"No epoch_metrics.csv found under {csv_root}")
    return sorted((summarize_run(p) for p in paths), key=lambda s: s.scale)


def plot_trend(summaries: Sequence[RunSummary], output_dir: Path, dpi: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scales = [s.scale for s in summaries]
    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(scales, [s.best_val_loss for s in summaries], "o-", color="tab:red", label="best val loss")
    ax1.set_xlabel("scale")
    ax1.set_ylabel("best val loss", color="tab:red")
    ax2 = ax1.twinx()
    ax2.plot(scales, [s.best_val_psnr for s in summaries], "s-", color="tab:blue", label="best val PSNR")
    ax2.set_ylabel("best val PSNR (dB)", color="tab:blue")
    fig.suptitle("Quality vs scale")
    fig.tight_layout()
    fig.savefig(output_dir / "trend_quality_vs_scale.png", dpi=dpi)
    plt.close(fig)


def plot_training_speed(summaries: Sequence[RunSummary], output_dir: Path, dpi: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scales = [s.scale for s in summaries]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(scales, [s.ms_per_step for s in summaries], "o-")
    ax.set_xlabel("scale")
    ax.set_ylabel("ms / step")
    ax.set_title("Training speed vs scale")
    fig.tight_layout()
    fig.savefig(output_dir / "training_speed.png", dpi=dpi)
    plt.close(fig)


def plot_training_load(summaries: Sequence[RunSummary], output_dir: Path, dpi: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scales = [s.scale for s in summaries]
    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.bar([str(s) for s in scales], [s.steps_per_epoch for s in summaries], color="tab:gray")
    ax1.set_xlabel("scale")
    ax1.set_ylabel("steps / epoch")
    ax2 = ax1.twinx()
    ax2.plot([str(s) for s in scales], [s.epoch_time_s for s in summaries], "o-", color="tab:orange")
    ax2.set_ylabel("epoch time (s)", color="tab:orange")
    fig.suptitle("Training load vs scale")
    fig.tight_layout()
    fig.savefig(output_dir / "training_load.png", dpi=dpi)
    plt.close(fig)


def write_summary_csv(summaries: Sequence[RunSummary], output_dir: Path) -> None:
    fields = ["label", "scale", "best_epoch", "best_val_loss", "best_val_psnr",
              "steps_per_epoch", "epoch_time_s", "ms_per_step"]
    with (Path(output_dir) / "run_summaries.csv").open("w", newline="") as fh:
        writer = csv.writer(fh)  # quotes labels containing commas
        writer.writerow(fields)
        writer.writerows([getattr(s, f) for f in fields] for s in summaries)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Analyse per-epoch training CSVs.")
    parser.add_argument("--csv-root", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=None)
    parser.add_argument("--dpi", type=int, default=140)
    args = parser.parse_args(argv)

    csv_root = args.csv_root.expanduser().resolve()
    output_dir = (args.output_dir or csv_root.parent / "analysis").expanduser().resolve()
    output_dir.mkdir(parents=True, exist_ok=True)

    summaries = load_summaries(csv_root)
    write_summary_csv(summaries, output_dir)
    plot_trend(summaries, output_dir, args.dpi)
    plot_training_speed(summaries, output_dir, args.dpi)
    plot_training_load(summaries, output_dir, args.dpi)
    print(f"Wrote analysis to {output_dir}")


if __name__ == "__main__":
    main()
