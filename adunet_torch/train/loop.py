"""The fit loop: epochs of train steps, validation, early stopping,
ReduceLROnPlateau, checkpoints and ``epoch_metrics.csv``.

Port of ``adunet/train/loop.py`` for one process on one device: no mesh, so
per-sample validation needs no padding masks, and batches go to the device
inside the steps. The metrics of a train or val step stay on the device and
are summed there; the host reads them once per epoch. ``epoch_metrics.csv``
has the reference's columns (``epoch, steps, duration_s, ms_per_step``, the
train metrics, then ``val_``-prefixed ones), so the analysis tools read a
run of either package. The segmentation trainers' hooks are here too: a
``pre_val_hook`` run before each validation (precise-BN), pooled metrics
finalized from their component sums over the whole epoch
(``metric_finalizers``), and validation batches kept on the device after
their first pass (``cache_val_on_device``). With a ``tb_writer`` (``open_tb_writer``: a
``tensorboardX`` writer, or None where the package does not import, the
reference's guard) each epoch also writes the TensorBoard scalars
``train/*``, ``val/*``, ``perf/ms_per_step`` and ``perf/images_per_sec``
(``adunet/train/loop.py:476-482``).

Across processes (a state with ``parallel``, ``adunet_torch.parallel``)
each process feeds its own training batches, and the steps return the
global batch's metrics. Validation is sharded as the reference's is on a
mesh (:318-329): each batch (every process holds the whole validation set)
is padded to a multiple of the data extent, each process scores its rows
with a per-sample ``val_step``, the padded rows are masked out, and the
sums (pooled metrics' components too) are all-reduced before they are
finalized. Every process therefore sees the same numbers and takes the same
early-stopping and ReduceLROnPlateau decisions; process 0 alone prints,
writes the CSV, the TensorBoard scalars and the profile.
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from adunet_torch.parallel.distributed import is_main_process
from adunet_torch.parallel.mesh import pad_and_shard_ragged
from adunet_torch.train.checkpoint import CheckpointManager
from adunet_torch.train.sr import _to_device
from adunet_torch.train.state import TrainState

__all__ = ["fit", "FitResult", "EpochLog", "make_plateau_state", "plateau_update", "repeat",
           "open_tb_writer"]


@dataclass
class EpochLog:
    epoch: int
    steps: int
    duration_s: float
    ms_per_step: float
    metrics: Dict[str, float]
    val_metrics: Dict[str, float] = field(default_factory=dict)

    def row(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "epoch": self.epoch,
            "steps": self.steps,
            "duration_s": round(self.duration_s, 3),
            "ms_per_step": round(self.ms_per_step, 3),
        }
        row.update(self.metrics)
        row.update({f"val_{k}": v for k, v in self.val_metrics.items()})
        return row


@dataclass
class FitResult:
    state: TrainState
    history: List[EpochLog]
    best_metric: Optional[float]
    best_epoch: Optional[int]
    stopped_early: bool


def _improved(current: float, best: Optional[float], mode: str) -> bool:
    # a NaN best is replaceable; an infinite best (val PSNR of identical
    # shaved patches) is a real record
    if np.isnan(current):
        return False
    if best is None or np.isnan(best):
        return True
    return current < best if mode == "min" else current > best


def _scale_lr(state: TrainState, factor: float, min_lr: float) -> float:
    """Rescale the optimizer's learning rate (an ``inject_lr`` optimizer)."""
    if not getattr(state.optimizer, "inject_lr", False):
        raise ValueError("reduce_lr_on_plateau requires make_optimizer(..., inject_lr=True).")
    for group in state.optimizer.param_groups:
        group["lr"] = max(group["lr"] * factor, min_lr)
    return state.optimizer.param_groups[0]["lr"]


def make_plateau_state(spec: Dict[str, Any]) -> Dict[str, Any]:
    """ReduceLROnPlateau callback state with Keras's defaults and semantics
    (min_delta 1e-4, cooldown)."""
    return {
        "monitor": spec.get("monitor", "val_loss"),
        "mode": spec.get("mode", "min"),
        "factor": spec.get("factor", 0.5),
        "patience": spec.get("patience", 5),
        "min_lr": spec.get("min_lr", 1e-6),
        "min_delta": spec.get("min_delta", 1e-4),
        "cooldown": spec.get("cooldown", 0),
        "best": None,
        "wait": 0,
        "cooldown_counter": 0,
    }


def plateau_update(rlp: Dict[str, Any], current: float) -> bool:
    """One epoch of ReduceLROnPlateau; True = reduce the LR now. Keras's
    order: cooldown first, best updates on a min_delta improvement (even in
    cooldown), the wait counter advances only outside cooldown."""
    if rlp["cooldown_counter"] > 0:
        rlp["cooldown_counter"] -= 1
        rlp["wait"] = 0
    in_cooldown = rlp["cooldown_counter"] > 0

    best = rlp["best"]
    if best is None or np.isnan(best):
        best = np.inf if rlp["mode"] == "min" else -np.inf
    if rlp["mode"] == "min":
        improved = current < best - rlp["min_delta"]
    else:
        improved = current > best + rlp["min_delta"]

    if improved:
        rlp["best"] = current
        rlp["wait"] = 0
        return False
    if in_cooldown:
        return False
    rlp["wait"] += 1
    if rlp["wait"] >= rlp["patience"]:
        rlp["wait"] = 0
        rlp["cooldown_counter"] = rlp["cooldown"]
        return True
    return False


def repeat(dataset):
    """Endlessly re-iterate a finite dataset (``fit`` takes an infinite one)."""
    while True:
        yield from dataset


def open_tb_writer(log_dir: str | Path):
    """A ``tensorboardX`` writer on ``log_dir``, or None where the package
    does not import (the reference's ``try`` / ``except Exception``)."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(str(log_dir))
    except Exception:
        return None


def _batch_size_of(batch) -> int:
    leaf = batch[0] if isinstance(batch, (tuple, list)) else batch
    return int(leaf.shape[0])


def _read(sums: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Device sums to the host in one transfer: 0-d sums as floats, pooled
    metrics' component vectors as float64 arrays."""
    keys = list(sums)
    flat = torch.cat([sums[k].to(torch.float64).reshape(-1) for k in keys]).cpu().numpy()
    out: Dict[str, Any] = {}
    at = 0
    for k in keys:
        n = sums[k].numel()
        out[k] = float(flat[at]) if sums[k].dim() == 0 else flat[at : at + n]
        at += n
    return out


def _finalize(raw: Dict[str, Any], count: float,
              metric_finalizers: Optional[Dict[str, Callable]]) -> Dict[str, float]:
    """Epoch metrics from epoch sums: plain metrics divided by ``count`` (in
    sorted order, as the reference's metric pytrees come), then each pooled
    metric finalized from its ``name#component`` sums."""
    out = {k: float(raw[k]) / count for k in sorted(raw) if "#" not in k}
    for name, fin in (metric_finalizers or {}).items():
        comps = {k.split("#", 1)[1]: v for k, v in raw.items() if k.startswith(name + "#")}
        if comps:
            out[name] = float(fin(comps))
    return out


def _to_device_tree(batch, device: torch.device):
    """A host batch (array, tensor or tuple of them) moved to ``device``."""
    if isinstance(batch, (tuple, list)):
        return tuple(_to_device_tree(b, device) for b in batch)
    return _to_device(batch, device)


def fit(
    state: TrainState,
    train_iter: Iterable,
    train_step: Callable,
    steps_per_epoch: int,
    epochs: int,
    *,
    initial_epoch: int = 0,
    rng: Optional[torch.Generator] = None,
    val_data: Optional[Iterable] = None,
    val_step: Optional[Callable] = None,
    monitor: str = "val_loss",
    monitor_mode: str = "min",
    patience: Optional[int] = None,
    restore_best_weights: bool = True,
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 1,
    log_dir: Optional[str | Path] = None,
    samples_per_step: Optional[int] = None,
    reduce_lr_on_plateau: Optional[Dict[str, Any]] = None,
    profile_dir: Optional[str | Path] = None,
    verbose: int = 1,
    stop_on_nan: bool = True,
    pre_val_hook: Optional[Callable[[TrainState], TrainState]] = None,
    metric_finalizers: Optional[Dict[str, Callable]] = None,
    cache_val_on_device: bool = False,
    tb_writer=None,
) -> FitResult:
    """Run the training loop.

    - ``train_iter``: infinite iterator of host batches (or ``None`` items
      for a device-cache step); ``train_step(state, batch, rng)``.
    - ``rng``: the ``torch.Generator`` handed to every train step (it
      advances itself); a device-cache step samples its patches from it.
    - ``val_data``: re-iterable of batches; ``val_step(state, batch)``
      returns batch means (0-d) or per-sample (B,) vectors; both pool to
      the mean over every validation sample.
    - ``ckpt`` / ``ckpt_every``: checkpoint cadence in epochs; the last and
      the early-stop epoch always save, and a best epoch that fell between
      saves is saved after the loop.
    - ``profile_dir``: ``torch.profiler`` trace of the first epoch, written
      there as ``trace.json``.
    - ``pre_val_hook(state) -> state``: run before each validation (e.g.
      precise-BN); the state it returns is validated and kept.
    - ``metric_finalizers``: for each pooled metric, a function of its
      ``{component: epoch sum}``; steps emit the components under
      ``"name#component"`` keys (summed over the epoch's train steps, or over
      every validation sample), and ``metrics[name]`` is the finalizer's
      value. Component keys are not logged.
    - ``cache_val_on_device``: keep the validation batches on the model's
      device after their first pass, so later epochs neither decode nor copy
      them again.
    - ``tb_writer``: a TensorBoard writer (``add_scalar``) for the epoch
      scalars; the caller closes it.
    """
    history: List[EpochLog] = []
    best_metric: Optional[float] = None
    best_epoch: Optional[int] = None
    best_params: Optional[Dict[str, torch.Tensor]] = None
    best_pool: Dict[str, float] = {}
    best_on_disk = True
    wait = 0
    stopped_early = False
    rlp = make_plateau_state(reduce_lr_on_plateau) if reduce_lr_on_plateau is not None else None

    csv_writer = None
    csv_file = None
    main = is_main_process()
    verbose = verbose if main else 0
    if not main:
        log_dir = tb_writer = profile_dir = None
    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
    train_it = iter(train_iter)
    val_cache: Optional[List[Any]] = [] if cache_val_on_device and val_data is not None else None

    try:
        for epoch in range(initial_epoch, epochs):
            profiler = None
            if profile_dir is not None and epoch == initial_epoch:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                profiler.start()
            t0 = time.perf_counter()
            images_seen = 0
            acc: Dict[str, torch.Tensor] = {}
            for _ in range(steps_per_epoch):
                batch = next(train_it)
                images_seen += samples_per_step or _batch_size_of(batch)
                state, metrics = train_step(state, batch, rng)
                for k, v in metrics.items():
                    acc[k] = v if k not in acc else acc[k] + v
            raw_train = _read(acc)  # waits for the epoch's last step
            duration = time.perf_counter() - t0
            if profiler is not None:
                profiler.stop()
                Path(profile_dir).mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
            train_metrics = _finalize(raw_train, steps_per_epoch, metric_finalizers)

            if stop_on_nan and not np.isfinite(train_metrics.get("loss", 0.0)):
                print(f"[fit] non-finite training loss at epoch {epoch + 1}; "
                      "stopping (set stop_on_nan=False to disable).", flush=True)
                stopped_early = True
                break

            tail_t = {"val": 0.0, "ckpt": 0.0, "best": 0.0}
            val_metrics: Dict[str, float] = {}
            if val_data is not None and val_step is not None:
                tv0 = time.perf_counter()
                if pre_val_hook is not None:
                    state = pre_val_hook(state)
                vacc: Dict[str, torch.Tensor] = {}
                vcount = 0
                cached = bool(val_cache)
                par = state.parallel
                for vbatch in (val_cache if cached else val_data):
                    if not cached:
                        mask = None
                        n = _batch_size_of(vbatch)
                        if par is not None:  # this process's rows; padding masked
                            vbatch, mask, n = pad_and_shard_ragged(vbatch, par.mesh)
                        if val_cache is not None:
                            dev = next(state.model.parameters()).device
                            vbatch = _to_device_tree(vbatch, dev)
                            mask = None if mask is None else mask.to(dev)
                            val_cache.append((vbatch, mask, n))
                    else:
                        vbatch, mask, n = vbatch
                    out = val_step(state, vbatch)
                    for k, v in out.items():
                        # per-sample vectors sum over the samples; batch means
                        # weigh by the batch size
                        if mask is not None:
                            if not v.dim():
                                raise ValueError(f"validation across processes needs per-sample "
                                                 f"val steps; {k!r} is a batch mean")
                            m = mask.to(v.device).reshape((-1,) + (1,) * (v.dim() - 1))
                            # select, not multiply: a padded row's inf PSNR times 0 is NaN
                            s = torch.where(m > 0, v, torch.zeros_like(v)).sum(dim=0)
                        else:
                            s = v.sum(dim=0) if v.dim() else v * float(n)
                        vacc[k] = s if k not in vacc else vacc[k] + s
                    vcount += n
                if vacc:
                    if par is not None:
                        vacc = par.sum_metrics(vacc)
                    val_metrics = _finalize(_read(vacc), vcount, metric_finalizers)
                tail_t["val"] = time.perf_counter() - tv0

            log = EpochLog(
                epoch=epoch + 1,
                steps=steps_per_epoch,
                duration_s=duration,
                ms_per_step=1000.0 * duration / max(steps_per_epoch, 1),
                metrics=train_metrics,
                val_metrics=val_metrics,
            )
            history.append(log)

            if verbose:
                parts = [f"{k}: {v:.4f}" for k, v in train_metrics.items()]
                parts += [f"val_{k}: {v:.4f}" for k, v in val_metrics.items()]
                ips = images_seen / duration
                print(f"Epoch {epoch + 1}/{epochs} - {duration:.1f}s - "
                      f"{log.ms_per_step:.0f}ms/step - {ips:.1f} img/s - " + " - ".join(parts),
                      flush=True)

            if log_dir is not None:
                row = log.row()
                if csv_writer is None:
                    csv_file = open(log_dir / "epoch_metrics.csv", "a", newline="")
                    csv_writer = csv.DictWriter(csv_file, fieldnames=list(row.keys()))
                    if csv_file.tell() == 0:
                        csv_writer.writeheader()
                csv_writer.writerow(row)
                csv_file.flush()
            if tb_writer is not None:
                for k, v in train_metrics.items():
                    tb_writer.add_scalar(f"train/{k}", v, epoch + 1)
                for k, v in val_metrics.items():
                    tb_writer.add_scalar(f"val/{k}", v, epoch + 1)
                tb_writer.add_scalar("perf/ms_per_step", log.ms_per_step, epoch + 1)
                tb_writer.add_scalar("perf/images_per_sec", images_seen / duration, epoch + 1)

            monitored_pool = {**train_metrics, **{f"val_{k}": v for k, v in val_metrics.items()}}
            current = monitored_pool.get(monitor)

            if rlp is not None:
                rlp_current = monitored_pool.get(rlp["monitor"])
                if rlp_current is not None and plateau_update(rlp, rlp_current):
                    new_lr = _scale_lr(state, rlp["factor"], rlp["min_lr"])
                    if verbose:
                        print(f"ReduceLROnPlateau: lr -> {new_lr:.2e}", flush=True)

            saved_this_epoch = False
            if ckpt is not None and ((epoch + 1) % max(1, ckpt_every) == 0 or (epoch + 1) == epochs):
                tc0 = time.perf_counter()
                ckpt.save(epoch + 1, state, metrics=monitored_pool)
                tail_t["ckpt"] = time.perf_counter() - tc0
                saved_this_epoch = True

            if current is not None:
                if _improved(current, best_metric, monitor_mode):
                    best_metric = current
                    best_epoch = epoch + 1
                    best_pool = dict(monitored_pool)
                    best_on_disk = saved_this_epoch
                    wait = 0
                    if restore_best_weights:
                        tb0 = time.perf_counter()
                        best_params = {k: v.detach().clone()
                                       for k, v in state.model.state_dict().items()}
                        tail_t["best"] = time.perf_counter() - tb0
                else:
                    wait += 1
                    if patience is not None and patience > 0 and wait >= patience:
                        stopped_early = True
                        if ckpt is not None and not saved_this_epoch:
                            ckpt.save(epoch + 1, state, metrics=monitored_pool)
                        if verbose:
                            best_str = f"{best_metric:.4f}" if best_metric is not None else "n/a"
                            print(f"Early stopping at epoch {epoch + 1} "
                                  f"(best {monitor}={best_str} @ epoch {best_epoch}).", flush=True)
                        break
            if verbose and max(tail_t.values()) >= 0.5:
                print(f"  [epoch tail: val {tail_t['val']:.1f}s ckpt {tail_t['ckpt']:.1f}s "
                      f"best-copy {tail_t['best']:.1f}s]", flush=True)

        if restore_best_weights and best_params is not None:
            state.model.load_state_dict(best_params)
            if ckpt is not None and not best_on_disk and best_epoch is not None:
                # the best epoch fell between saves: persist it once, keyed
                # by its epoch (the optimizer moments are the last epoch's)
                ckpt.save(best_epoch, state, metrics=best_pool, force=True)
    finally:
        if csv_file is not None:
            csv_file.close()

    return FitResult(state=state, history=history, best_metric=best_metric,
                     best_epoch=best_epoch, stopped_early=stopped_early)
