"""Checkpoints: best-by-monitor and latest retention, on ``torch.save``.

Port of ``adunet/train/checkpoint.py`` with ``torch.save`` in place of Orbax.
A checkpoint is a directory ``<root>/<step>/`` holding ``state.pt`` (update
count, model ``state_dict``, optimizer ``state_dict``) and ``metrics.json``.
The manager keeps the ``max_to_keep`` best checkpoints by the monitored
metric AND the latest one (:65-78): a crash resume must not rewind to the
best epoch. The architecture is rebuilt from ``config.json``; nothing is
pickled but tensors and plain values (restores use ``weights_only=True``).
A save at a step at or below the latest is dropped unless ``force``ed, as
Orbax's ``should_save`` does; a forced save never overwrites a step.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from adunet_torch.train.state import TrainState

__all__ = ["CheckpointManager"]

_STATE_FILE = "state.pt"
_METRICS_FILE = "metrics.json"
_FLOAT_MAX = 1.7976931348623157e308


def _encode(v: float) -> float:
    """±inf (a legitimate val PSNR) as ±float max: JSON has no infinity, and
    the order under the monitor is unchanged."""
    v = float(v)
    if math.isinf(v):
        return _FLOAT_MAX if v > 0 else -_FLOAT_MAX
    return v


class CheckpointManager:
    """Best + latest checkpoint retention with metric-driven selection."""

    def __init__(self, directory: str | Path, monitor: str = "val_loss", mode: str = "min",
                 max_to_keep: int = 2):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = max_to_keep

    def _steps(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit() and (p / _STATE_FILE).exists())

    def _score(self, step: int) -> Optional[float]:
        """The monitored metric, signed so that larger is better; None if the
        checkpoint did not record it."""
        metrics = json.loads((self.directory / str(step) / _METRICS_FILE).read_text())
        if self.monitor not in metrics:
            return None
        return metrics[self.monitor] if self.mode == "max" else -metrics[self.monitor]

    def save(self, step: int, state: TrainState, metrics: Optional[Dict[str, float]] = None,
             force: bool = False) -> None:
        latest = self.latest_step()
        if not force and latest is not None and step <= latest:
            return
        target = self.directory / str(step)
        if target.exists():
            raise FileExistsError(f"checkpoint step {step} already exists in {self.directory}")
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        tmp.mkdir()
        payload = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        }
        torch.save(payload, tmp / _STATE_FILE)
        clean = {k: _encode(v) for k, v in (metrics or {}).items() if not math.isnan(float(v))}
        (tmp / _METRICS_FILE).write_text(json.dumps(clean))
        os.replace(tmp, target)
        self._retain()

    def _retain(self) -> None:
        steps = self._steps()
        if not steps:
            return
        keep = {steps[-1]}
        scored = [(s, self._score(s)) for s in steps]
        ranked = sorted((sc, s) for s, sc in scored if sc is not None)
        keep.update(s for _, s in ranked[-self.max_to_keep:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))

    def _load(self, step: int, state: TrainState) -> Dict[str, Any]:
        device = next(state.model.parameters()).device
        return torch.load(self.directory / str(step) / _STATE_FILE, map_location=device,
                          weights_only=True)

    def _restore(self, step: int, state: TrainState) -> TrainState:
        payload = self._load(step, state)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def best_step(self) -> Optional[int]:
        scored = [(sc, s) for s in self._steps() if (sc := self._score(s)) is not None]
        return max(scored)[1] if scored else None

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        step = self.latest_step()
        return None if step is None else self._restore(step, state)

    def restore_best(self, state: TrainState) -> Optional[TrainState]:
        step = self.best_step()
        step = self.latest_step() if step is None else step
        return None if step is None else self._restore(step, state)

    def write_config(self, config: Dict[str, Any]) -> None:
        (self.directory / "config.json").write_text(json.dumps(config, indent=2, default=str))
