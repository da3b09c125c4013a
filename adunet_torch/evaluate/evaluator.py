"""SR evaluation over a grid-tiled patch stream.

Port of ``adunet/evaluate/evaluator.py``: ``infer_eval_shave`` (:56),
``EvalResults``, ``evaluate_sr`` (:67: degrade at the eval scale, restore,
clip, BT.601 luma, shave, PSNR / SSIM / MS-SSIM / MSE per patch, float64
pooled mean and std with ±inf passed through). Batches run as they come:
eager PyTorch needs no padding of a ragged last batch. With a ``mesh``
(:90) each batch is sharded over the processes of its data axis
(``pad_and_shard_ragged``: padded to a multiple of the extent, the padded
rows masked), each process scores its rows, and the per-patch vectors are
gathered back in the batch's order, so every process holds the numbers one
process computes. ``attach_filenames``
and ``write_outputs`` (:140-169) label the per-patch rows and write the
reference's three report files (``config.json``, ``metrics.json``,
``per_image_metrics.csv`` with the columns ``index, filename, psnr_y,
ssim_y, msssim_y, mse_y``), which the analysis and plot tools read.
"""

from __future__ import annotations

import csv
import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from adunet_torch.parallel.mesh import data_extent, data_group, pad_and_shard_ragged
from adunet_torch.train.sr import make_sr_eval_step

__all__ = ["EvalResults", "evaluate_sr", "infer_eval_shave", "attach_filenames", "write_outputs"]


@dataclass
class EvalResults:
    mse_mean: float
    mse_std: float
    psnr_mean: float
    psnr_std: float
    ssim_mean: float
    ssim_std: float
    msssim_mean: float
    msssim_std: float
    samples: int


_METRIC_KEYS = ("psnr_y", "ssim_y", "msssim_y", "mse_y")


def infer_eval_shave(scale: float, explicit: Optional[int] = None) -> int:
    """Border shave in pixels: an explicit request wins (floored at 0),
    otherwise the reference default ``2 * round(1/scale)``, 0 for scale <= 0."""
    if explicit is not None:
        return max(0, int(explicit))
    if scale <= 0:
        return 0
    return 2 * int(round(1.0 / scale))


def _gathered(out: Dict[str, torch.Tensor], n_valid: int, mesh) -> Dict[str, np.ndarray]:
    """Every process's per-patch vectors of one sharded batch, in the
    batch's order, the padded rows dropped."""
    local = torch.stack([out[k].to(torch.float32) for k in _METRIC_KEYS])
    parts = [torch.empty_like(local) for _ in range(data_extent(mesh))]
    dist.all_gather(parts, local, group=data_group(mesh))
    whole = torch.cat(parts, dim=1).cpu().numpy()[:, :n_valid]
    return dict(zip(_METRIC_KEYS, whole))


def evaluate_sr(state, dataset, eval_scale: float, eval_shave: int, mesh=None
                ) -> Tuple[EvalResults, List[Dict[str, float]]]:
    """Score ``state.model`` over ``dataset`` (HR batches or (lr, hr) pairs);
    with ``mesh``, sharded over its data axis."""
    step = make_sr_eval_step(None, eval_scale=eval_scale, eval_shave=eval_shave)
    rows: List[Dict[str, float]] = []
    series: Dict[str, List[np.ndarray]] = {key: [] for key in _METRIC_KEYS}
    for batch in dataset:
        if mesh is not None:
            local, _mask, n_valid = pad_and_shard_ragged(batch, mesh)
            out = _gathered(step(state, local), n_valid, mesh)
        else:
            out = {k: v.cpu().numpy() for k, v in step(state, batch).items()}
        n = len(out[_METRIC_KEYS[0]])
        base = len(rows)
        rows.extend({"index": base + i, **{k: float(out[k][i]) for k in _METRIC_KEYS}}
                    for i in range(n))
        for key in _METRIC_KEYS:
            series[key].append(out[key])
    if not rows:
        raise RuntimeError("evaluation stream produced zero patches.")
    fields: Dict[str, float] = {}
    for key in _METRIC_KEYS:
        pooled = np.concatenate(series[key], axis=0).astype(np.float64)
        stem = key[: -len("_y")]
        fields[f"{stem}_mean"] = float(pooled.mean())
        fields[f"{stem}_std"] = float(pooled.std())
    return EvalResults(samples=len(rows), **fields), rows


def attach_filenames(per_image: List[Dict[str, float]], filenames: Sequence[str]) -> None:
    """Label each metric row with its grid-patch name, in place."""
    if len(per_image) != len(filenames):
        raise ValueError(f"have {len(per_image)} metric rows but {len(filenames)} patch labels")
    for row, label in zip(per_image, filenames):
        row["filename"] = label


def write_outputs(run_dir: str | Path, summary: EvalResults, per_image: List[Dict[str, float]],
                  config: Dict[str, object], write_per_image: bool = True) -> None:
    """Write ``config.json``, ``metrics.json`` and (unless told not to)
    ``per_image_metrics.csv`` into ``run_dir``."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    for name, payload in (("config.json", config), ("metrics.json", asdict(summary))):
        (run_dir / name).write_text(json.dumps(payload, indent=2, default=str))
    if not write_per_image:
        return
    with (run_dir / "per_image_metrics.csv").open("w", newline="") as sink:
        writer = csv.DictWriter(sink, fieldnames=["index", "filename", *_METRIC_KEYS])
        writer.writeheader()
        writer.writerows(per_image)
