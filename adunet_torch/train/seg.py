"""Segmentation train / eval steps, pooled-metric finalizers and precise-BN.

Port of ``adunet/train/seg.py``. A train step moves its host batch to the
model's device and runs there: augmentation (``"full"``: rot90, flips and
scale-jitter crop; ``"flips"``; ``"none"``) drawn from the step's
``torch.Generator``, the forward in training mode (BatchNorm on batch
statistics, its running buffers updated as flax's mutable ``batch_stats``),
the loss, the backward and one Adam update of the parameters (never of the
BatchNorm buffers). Metrics stay on the device: ``loss`` / ``dice`` /
``iou``, plain extra metrics, and for a ``PooledMetric`` its component sums
under ``"{name}#{component}"``, which the fit loop pools over the epoch with
``metric_finalizers_of``.

Precise-BN (``make_bn_refresh_step``, ``precise_batch_stats``) replaces the
running statistics with population statistics of the current weights over N
batches: mean = E_b[mean_b], var = E_b[var_b + mean_b^2] - mean^2 (floored at
1e-12). The reference recovers each batch's (mean_b, var_b) by inverting the
EMA update new = 0.99 old + 0.01 b, which multiplies the float32 rounding of
``new`` by 100; here the BatchNorm layers report them directly
(``BatchNorm.stats_sink``), so the result is the same population statistics
without that amplification. ``make_precise_bn_program`` is the same
computation over a stacked (N, B, H, W, C) array.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from adunet_torch.data.augment import augment_pair_batch, flip_pair_batch
from adunet_torch.metrics.seg import PooledMetric, dice_coefficient, iou_score
from adunet_torch.nn.blocks import BatchNorm
from adunet_torch.train.sr import _device_of, _to_device, lift_per_sample
from adunet_torch.train.state import TrainState

__all__ = [
    "make_seg_train_step",
    "make_seg_eval_step",
    "metric_finalizers_of",
    "make_bn_refresh_step",
    "precise_batch_stats",
    "snapshot_refresh_batches",
    "make_precise_bn_program",
]

_MODES = {True: "full", False: "none", "full": "full", "flips": "flips", "none": "none"}


def _pair(batch, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    images, masks = batch
    return _to_device(images, device), _to_device(masks, device)


def make_seg_train_step(model, loss_fn: Callable, augment: bool | str = True,
                        extra_metrics: Dict[str, Callable] | None = None):
    """``(state, (images, masks), rng) -> (state, metrics)``; ``rng`` is a
    ``torch.Generator`` on the model's device (unused with ``augment`` off).

    ``augment``: True / ``"full"`` = rot90 + flips + scale jitter (the
    protocol trainer); ``"flips"`` = LR / UD flips (the vanilla trainer);
    False / ``"none"`` = off."""
    if augment not in _MODES:
        raise ValueError(f"unknown augment {augment!r} (expected full|flips|none)")
    mode = _MODES[augment]

    def step(state: TrainState, batch, rng: torch.Generator | None = None):
        images, masks = _pair(batch, _device_of(state.model))
        if mode != "none":
            if rng is None:
                raise ValueError("augmentation draws from a torch.Generator on the model's device")
            augment_fn = augment_pair_batch if mode == "full" else flip_pair_batch
            images, masks = augment_fn(images, masks, rng)
        state.train_module.train()
        state.optimizer.zero_grad(set_to_none=True)
        pred = state.train_module(images)
        loss = loss_fn(masks, pred)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            pred = pred.detach()
            metrics = {"loss": loss.detach(), "dice": dice_coefficient(masks, pred),
                       "iou": iou_score(masks, pred)}
            for name, fn in (extra_metrics or {}).items():
                if isinstance(fn, PooledMetric):
                    for comp, v in fn.stats(masks, pred).items():
                        metrics[f"{name}#{comp}"] = v
                else:
                    metrics[name] = fn(masks, pred)
        return state, state.reduce_metrics(metrics)

    return step


def make_seg_eval_step(model, loss_fn: Callable, extra_metrics: Dict[str, Callable] | None = None,
                       per_sample: bool = False):
    """``(state, (images, masks)) -> metrics``: no augmentation, running
    BatchNorm statistics. ``per_sample=True`` gives every plain metric as a
    (B,) vector (each sample as its own batch) and a ``PooledMetric``'s
    components per sample under ``"{name}#{component}"``; otherwise batch
    values, a pooled metric's its ``batch_fn``."""
    fns: Dict[str, Callable] = {"loss": loss_fn, "dice": dice_coefficient, "iou": iou_score,
                                **(extra_metrics or {})}
    plain = {k: f for k, f in fns.items() if not isinstance(f, PooledMetric)}
    pooled = {k: f for k, f in fns.items() if isinstance(f, PooledMetric)}

    @torch.no_grad()
    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        images, masks = _pair(batch, _device_of(state.model))
        state.model.eval()
        pred = state.model(images)
        if per_sample:
            out = {name: lift_per_sample(fn)(masks, pred) for name, fn in plain.items()}
            for name, pm in pooled.items():
                per = [pm.stats(masks[i : i + 1], pred[i : i + 1]) for i in range(pred.shape[0])]
                out.update({f"{name}#{c}": torch.stack([p[c] for p in per]) for c in per[0]})
            return out
        out = {name: fn(masks, pred) for name, fn in plain.items()}
        out.update({name: pm.batch_fn(masks, pred) for name, pm in pooled.items()})
        return out

    return step


def metric_finalizers_of(extra_metrics: Dict[str, Callable] | None) -> Dict[str, Callable]:
    """The fit loop's ``metric_finalizers`` of an extra-metrics dict."""
    return {name: fn.finalize for name, fn in (extra_metrics or {}).items()
            if isinstance(fn, PooledMetric)}


Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _bn_layers(model: torch.nn.Module):
    return [(name, m) for name, m in model.named_modules() if isinstance(m, BatchNorm)]


def _bn_batch_second_moments(state: TrainState, images) -> Stats:
    """One training-mode forward (no gradient, running buffers untouched) ->
    each BatchNorm layer's (mean_b, var_b + mean_b^2) on this batch."""
    model = state.model
    layers = _bn_layers(model)
    was_training = model.training
    for _, m in layers:
        m.stats_sink = []
    try:
        model.train()
        with torch.no_grad():
            model(_to_device(images, _device_of(model)))
        stats = {name: m.stats_sink[0] for name, m in layers}
    finally:
        for _, m in layers:
            m.stats_sink = None
        model.train(was_training)
    return {name: (mean, var + mean.square()) for name, (mean, var) in stats.items()}


def make_bn_refresh_step():
    """``(state, images, acc) -> acc`` with this batch's (mean_b, var_b +
    mean_b^2) added to each layer's running sums."""

    def step(state: TrainState, images, acc: Stats) -> Stats:
        contrib = _bn_batch_second_moments(state, images)
        return {name: (acc[name][0] + m, acc[name][1] + v) for name, (m, v) in contrib.items()}

    return step


def _zero_acc(model: torch.nn.Module) -> Stats:
    return {name: (torch.zeros_like(m.running_mean), torch.zeros_like(m.running_var))
            for name, m in _bn_layers(model)}


def _finalize_precise_stats(acc: Stats, n: int) -> Dict[str, torch.Tensor]:
    """Summed (Σ mean_b, Σ (var_b + mean_b^2)) over n batches -> population
    statistics as the BatchNorm buffers' state_dict entries."""
    out = {}
    for name, (m, v) in acc.items():
        mean = m / n
        out[f"{name}.running_mean"] = mean
        out[f"{name}.running_var"] = torch.clamp(v / n - mean.square(), min=1e-12)
    return out


def _load_stats(model: torch.nn.Module, stats: Dict[str, torch.Tensor]) -> None:
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for key, value in stats.items():
            buffers[key].copy_(value)


def precise_batch_stats(state: TrainState, image_batches: Iterable, refresh_step, put=None
                        ) -> TrainState:
    """Replace the BatchNorm running statistics with population statistics
    over ``image_batches`` (images only; ``put`` an optional placement of
    each batch). The state is returned unchanged for no batches."""
    acc = _zero_acc(state.model)
    n = 0
    for images in image_batches:
        acc = refresh_step(state, put(images) if put is not None else images, acc)
        n += 1
    if n:
        _load_stats(state.model, _finalize_precise_stats(acc, n))
    return state


def snapshot_refresh_batches(dataset, n_batches: int, put=None):
    """``n_batches`` un-augmented image batches for precise-BN, taken in the
    dataset's pair order (wrapping around a small corpus) from its whole
    pair list, without advancing its shuffle epoch: the training batch order
    is the same with and without precise-BN."""
    pairs = getattr(dataset, "global_pairs", dataset.pairs)
    bs = dataset.batch_size
    batches = []
    for b in range(n_batches):
        sel = [pairs[(b * bs + j) % len(pairs)] for j in range(bs)]
        images = np.stack([dataset._load_pair(*p)[0] for p in sel])
        batches.append(put(images) if put is not None else images)
    return batches


def make_precise_bn_program():
    """``run(state, stack) -> {buffer name: tensor}``: the population
    statistics over the N batches of a stacked (N, B, H, W, C) array, the
    state left unchanged. The same computation as ``precise_batch_stats``;
    PyTorch runs eagerly, so one program and a loop over batches cost the
    same here."""
    refresh = make_bn_refresh_step()

    def run(state: TrainState, stack) -> Dict[str, torch.Tensor]:
        acc = _zero_acc(state.model)
        for images in stack:
            acc = refresh(state, images, acc)
        return _finalize_precise_stats(acc, len(stack))

    return run
