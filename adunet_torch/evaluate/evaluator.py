"""Evaluation helpers. Port of ``adunet/evaluate/evaluator.py``: so far only
``infer_eval_shave`` (:56); the grid evaluator is a later slice."""

from __future__ import annotations

from typing import Optional

__all__ = ["infer_eval_shave"]


def infer_eval_shave(scale: float, explicit: Optional[int] = None) -> int:
    """Border shave in pixels: an explicit request wins (floored at 0),
    otherwise the reference default ``2 * round(1/scale)``, 0 for scale <= 0."""
    if explicit is not None:
        return max(0, int(explicit))
    if scale <= 0:
        return 0
    return 2 * int(round(1.0 / scale))
