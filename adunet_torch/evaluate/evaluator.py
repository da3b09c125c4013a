"""SR evaluation over a grid-tiled patch stream.

Port of ``adunet/evaluate/evaluator.py``: ``infer_eval_shave`` (:56),
``EvalResults``, ``evaluate_sr`` (:67: degrade at the eval scale, restore,
clip, BT.601 luma, shave, PSNR / SSIM / MS-SSIM / MSE per patch, float64
pooled mean and std with ±inf passed through). Batches run as they come:
eager PyTorch needs no padding of a ragged last batch. ``write_outputs`` and
the report files wait for the evaluate CLI (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from adunet_torch.train.sr import make_sr_eval_step

__all__ = ["EvalResults", "evaluate_sr", "infer_eval_shave"]


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


def evaluate_sr(state, dataset, eval_scale: float, eval_shave: int
                ) -> Tuple[EvalResults, List[Dict[str, float]]]:
    """Score ``state.model`` over ``dataset`` (HR batches or (lr, hr) pairs)."""
    step = make_sr_eval_step(None, eval_scale=eval_scale, eval_shave=eval_shave)
    rows: List[Dict[str, float]] = []
    series: Dict[str, List[np.ndarray]] = {key: [] for key in _METRIC_KEYS}
    for batch in dataset:
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

