"""Convert training stdout transcripts into per-epoch CSV files.

Port of ``adunet/cli/export_log_metrics.py``, the same code (it imports no JAX): the
port imports nothing of ``adunet``. It reads the run directories the port's
trainers and ``evaluate`` write.

Capability parity with the reference's log->CSV exporter
(/root/reference/Super_resolution/code/export_log_metrics.py) and the same
output schema (epoch, steps_completed, steps_total, duration_s, ms_per_step,
loss, psnr, val_loss, val_psnr), but an independent implementation: instead of
splitting each line on ``" - "`` and walking the fragments positionally, every
line is scanned with a single pass of token regexes, so both log dialects fall
out of one grammar:

* this framework's single-line epoch summaries::

      Epoch 3/100 - 12.4s - 96ms/step - 41.3 img/s - loss: 0.0312 - ...

* Keras verbose-2 transcripts (``Epoch N/M`` header line, then
  ``540/540 - 540s - 500ms/step - loss: ...``).
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = ["scan_line", "extract_epoch_rows", "process_logs", "write_csv"]

# One token grammar for everything that can appear on a summary line.
_TOKENS = re.compile(
    r"""
    (?P<epoch_hdr>\bEpoch\s+(?P<ep>\d+)(?:/(?P<ep_total>\d+))?)
  | (?P<progress>\b(?P<done>\d+)/(?P<total>\d+)\s+-)
  | (?P<msstep>\b(?P<ms>\d+(?:\.\d+)?)\s*ms/step\b)
  | (?P<imgsec>\b(?P<ips>\d+(?:\.\d+)?)\s*img/s\b)
  | (?P<seconds>\b(?P<secs>\d+(?:\.\d+)?)s\b)
  | (?P<metric>\b(?P<key>[A-Za-z][A-Za-z0-9_]*):\s*(?P<val>[-+]?(?:\d+(?:\.\d+)?(?:[eE][-+]?\d+)?|inf|nan)))
    """,
    re.VERBOSE,
)

SCHEMA = (
    "epoch",
    "steps_completed",
    "steps_total",
    "duration_s",
    "ms_per_step",
    "loss",
    "psnr",
    "val_loss",
    "val_psnr",
)


def scan_line(line: str) -> Dict[str, float]:
    """Tokenize one log line into whatever fields it carries.

    Returns a (possibly empty) dict; an epoch-summary line is recognised by
    the caller via the presence of both ``loss`` and ``ms_per_step``.
    """
    fields: Dict[str, float] = {}
    for tok in _TOKENS.finditer(line):
        if tok.group("epoch_hdr"):
            fields["epoch"] = float(tok.group("ep"))
        elif tok.group("progress"):
            fields["steps_completed"] = float(tok.group("done"))
            fields["steps_total"] = float(tok.group("total"))
        elif tok.group("msstep"):
            fields["ms_per_step"] = float(tok.group("ms"))
        elif tok.group("imgsec"):
            fields["img_per_sec"] = float(tok.group("ips"))
        elif tok.group("seconds"):
            # first bare "<float>s" token is the epoch duration
            fields.setdefault("duration_s", float(tok.group("secs")))
        elif tok.group("metric"):
            fields[tok.group("key").lower()] = float(tok.group("val"))
    return fields


def _iter_epoch_records(lines: Iterable[str]) -> Iterator[Dict[str, float]]:
    """Yield one record per completed epoch, merging header + summary lines."""
    pending_epoch: Optional[float] = None
    for line in lines:
        fields = scan_line(line)
        if not fields:
            continue
        is_summary = "loss" in fields and "ms_per_step" in fields
        if not is_summary:
            # Bare "Epoch N/M" header (Keras verbose-2): remember it.
            if "epoch" in fields and len(fields) == 1:
                pending_epoch = fields["epoch"]
            continue
        if "epoch" not in fields:
            if pending_epoch is None:
                continue
            fields["epoch"] = pending_epoch
        pending_epoch = None
        yield fields


def extract_epoch_rows(log_path: Path) -> List[Dict[str, float]]:
    """Collect per-epoch metric records from a single transcript file."""
    with Path(log_path).open("r", encoding="utf-8") as fh:
        return list(_iter_epoch_records(fh))


def write_csv(rows: Iterable[Dict[str, float]], output_path: Path) -> None:
    """Serialise records under the reference CSV schema (blank = absent)."""
    import csv

    rows = list(rows)
    if not rows:
        return
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with output_path.open("w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh)
        writer.writerow(SCHEMA)
        writer.writerows([row.get(col, "") for col in SCHEMA] for row in rows)


def process_logs(
    logs_root: Path, output_root: Path, pattern: str = "*.log"
) -> List[Tuple[str, Path]]:
    """Export one ``epoch_metrics.csv`` per run found under *logs_root*.

    Two layouts are mined (the reference exporter handles only the first —
    per-run directories holding ``run-simple-*.log``; sweep drivers here also
    emit flat ``<run>.log`` files directly in the transcripts dir):

    * one subdirectory per run: the newest (by name sort) matching transcript
      in each directory wins — resumed runs append a fresh log per attempt;
    * flat log files directly under *logs_root*: each file is its own run,
      named by the log's stem.
    """
    results: List[Tuple[str, Path]] = []
    logs_root = Path(logs_root)
    run_dirs = sorted(child for child in logs_root.iterdir() if child.is_dir())
    for run_dir in run_dirs:
        candidates = sorted(run_dir.glob(pattern))
        if not candidates:
            continue
        rows = extract_epoch_rows(candidates[-1])
        if not rows:
            continue
        target = Path(output_root) / run_dir.name / "epoch_metrics.csv"
        write_csv(rows, target)
        results.append((run_dir.name, target))
    for log_file in sorted(logs_root.glob(pattern)):
        if not log_file.is_file():
            continue
        rows = extract_epoch_rows(log_file)
        if not rows:
            continue
        target = Path(output_root) / log_file.stem / "epoch_metrics.csv"
        write_csv(rows, target)
        results.append((log_file.stem, target))
    return results


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Export per-epoch metric CSVs from training transcripts."
    )
    parser.add_argument("--logs-root", type=Path, required=True)
    parser.add_argument("--output-root", type=Path, required=True)
    parser.add_argument("--pattern", type=str, default="*.log")
    args = parser.parse_args(argv)

    logs_root = args.logs_root.expanduser().resolve()
    if not logs_root.is_dir():
        raise SystemExit(f"log root missing on disk: {logs_root}")
    results = process_logs(logs_root, args.output_root.expanduser().resolve(), args.pattern)
    if not results:
        print("No epoch metrics found in any transcript.")
        return
    print(f"Wrote {len(results)} epoch-metric table(s):")
    for run_name, csv_path in results:
        print(f"  {run_name}: {csv_path}")


if __name__ == "__main__":
    main()
