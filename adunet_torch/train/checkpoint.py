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

A save first copies the state to host memory on the caller's thread (every
tensor cloned to the CPU), so a later step cannot change what is written,
and writes that copy. With ``async_save=True`` (:46-130) the write runs on a
background thread, overlapping the next epoch; saves are serialised, every
read of the directory (``latest_step``, ``best_step``, the restores) waits
for the pending write first, and ``wait()`` / ``close()`` join it and raise
its error, if any. Both modes write the same bytes.

Across processes every process calls the same methods in the same order.
Process 0 alone writes (and prunes), from the whole state: leaves sharded
over processes (DTensors, ``adunet_torch.parallel.partition``) are gathered
first, by every process. Whether a save is due is process 0's reading of
the directory, broadcast; a save is followed by a barrier (for an async
write, at the next ``wait``), so every process then reads the new
directory. Every process restores, each into its own shard of a sharded
leaf. A checkpoint has the one format whatever wrote it, and loads in a
single process.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from adunet_torch.parallel.distributed import (
    barrier,
    broadcast_from_main,
    is_distributed,
    is_main_process,
)
from adunet_torch.parallel.partition import full_tensor, is_sharded
from adunet_torch.train.state import TrainState

__all__ = ["CheckpointManager", "load_model_state"]

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


def _to_host(tree: Any) -> Any:
    """A copy of a (nested) state_dict with every tensor cloned to the CPU; a
    sharded leaf is gathered whole first (a collective)."""
    if isinstance(tree, torch.Tensor):
        return full_tensor(tree).detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _placed_like(template: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A whole tensor from a checkpoint as ``template`` holds it: for a
    sharded leaf, this process's shard (cut locally, no collective)."""
    if is_sharded(template):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(value.to(template.to_local().device, template.dtype),
                                 template.device_mesh, template.placements, src_data_rank=None)
    return value


def load_model_state(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict`` of a whole state dict, into sharded leaves
    too."""
    current = model.state_dict()
    model.load_state_dict({k: _placed_like(current[k], v) if k in current else v
                           for k, v in state.items()})


def _load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    optimizer.load_state_dict(state)
    for group in optimizer.param_groups:
        for p in group["params"]:
            if is_sharded(p):
                slots = optimizer.state.get(p, {})
                for key, value in slots.items():
                    if key != "step" and isinstance(value, torch.Tensor) \
                            and not is_sharded(value):
                        slots[key] = _placed_like(p, value)


class CheckpointManager:
    """Best + latest checkpoint retention with metric-driven selection."""

    def __init__(self, directory: str | Path, monitor: str = "val_loss", mode: str = "min",
                 max_to_keep: int = 2, async_save: bool = False):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._unsynced = False  # a save the other processes have not waited for

    def wait(self) -> None:
        """Join the pending background write (and, across processes, wait
        for every process); raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._unsynced:
            self._unsynced = False
            barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()

    def _steps(self) -> List[int]:
        self.wait()
        return self._listed_steps()

    def _listed_steps(self) -> List[int]:
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
        # process 0 reads the directory for everyone: another process could
        # read it after process 0 has written this step
        latest = broadcast_from_main(self.latest_step())  # waits for the pending write
        if not force and latest is not None and step <= latest:
            return
        main = is_main_process()
        if main and (self.directory / str(step)).exists():
            raise FileExistsError(f"checkpoint step {step} already exists in {self.directory}")
        self._unsynced = is_distributed()
        model_state = state.model.state_dict()
        if not main and not any(is_sharded(v) for v in model_state.values()):
            if not self.async_save:
                self.wait()
            return
        payload = {
            "step": int(state.step),
            "model": _to_host(model_state),
            "optimizer": _to_host(state.optimizer.state_dict()),
        }
        if not main:  # took part in the gathers; process 0 writes
            if not self.async_save:
                self.wait()
            return
        clean = {k: _encode(v) for k, v in (metrics or {}).items() if not math.isnan(float(v))}
        if not self.async_save:
            try:
                self._write(step, payload, clean)
            finally:
                self.wait()
            return

        def write() -> None:
            try:
                self._write(step, payload, clean)
            except Exception as exc:  # raised on the caller's thread by wait()
                self._error = exc

        self._writer = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=True)
        self._writer.start()

    def _write(self, step: int, payload: Dict[str, Any], metrics: Dict[str, float]) -> None:
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        tmp.mkdir()
        torch.save(payload, tmp / _STATE_FILE)
        (tmp / _METRICS_FILE).write_text(json.dumps(metrics))
        os.replace(tmp, self.directory / str(step))
        self._retain()

    def _retain(self) -> None:  # runs on the writer's thread in async mode
        steps = self._listed_steps()
        if not steps:
            return
        keep = {steps[-1]}
        scored = [(s, self._score(s)) for s in steps]
        ranked = sorted((sc, s) for s, sc in scored if sc is not None)
        keep.update(s for _, s in ranked[-self.max_to_keep:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))

    def _load(self, step: int, model: torch.nn.Module) -> Dict[str, Any]:
        self.wait()
        device = next(model.parameters()).device
        return torch.load(self.directory / str(step) / _STATE_FILE, map_location=device,
                          weights_only=True)

    def _restore(self, step: int, state: TrainState) -> TrainState:
        payload = self._load(step, state.model)
        load_model_state(state.model, payload["model"])
        _load_optimizer_state(state.optimizer, payload["optimizer"])
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

    def restore_weights(self, model: torch.nn.Module, best: bool = True) -> Optional[int]:
        """Load the best (or, with ``best=False`` or no scored checkpoint, the
        latest) checkpoint's model weights into ``model``, without the
        optimizer, as the reference's ``restore_*_weights`` do for a serving
        export; returns the step, or None if there is no checkpoint."""
        step = self.best_step() if best else None
        step = self.latest_step() if step is None else step
        if step is not None:
            load_model_state(model, self._load(step, model)["model"])
        return step

    def write_config(self, config: Dict[str, Any]) -> None:
        """Write ``config.json`` (process 0 only)."""
        if is_main_process():
            (self.directory / "config.json").write_text(json.dumps(config, indent=2, default=str))
