"""SR train / val / eval steps.

Port of ``adunet/train/sr.py``. Each ``make_*`` returns a function of ``(state, batch[, rng])`` that runs eagerly
on the model's device: degradation (the LR batch is made on the device from
the HR batch, as in the reference), forward, loss, backward and one Adam
update. Host batches may be numpy or tensors; uint8 batches are scaled to
[0, 1] float32 on the device (``_as_f01``). Metrics come back as 0-d (or, per
sample, 1-d) tensors on the device, and nothing in a step waits for the
device: the fit loop reads the metrics once per epoch.

Across processes (``TrainState.parallel``) a train step runs its forward
through the data-parallel module, reduces the gradients in the last
micro-batch's backward only, and returns the metrics averaged over the
processes: the global batch's.

On a space mesh (``TrainState.space``, ``adunet_torch.parallel.spatial``)
the train step takes each process's rows of every image (``shard_batch``):
it learns the images' global height from the shards, degrades with
row-sharded resizes, runs the model on the rows, and scales the loss to
``local mean x local rows x space shards / global height``. DDP averages
the gradients over all W = data x space processes, and the average of those
losses over W is the global batch's mean loss, whatever rows each process
holds: so the averaged gradient is the global loss's, and the reported loss
(averaged over W) is the global batch's. The
PSNR sums each image's squared error over its rows' processes. Only
elementwise-mean losses (charbonnier, l1, mse) split so; the val, eval and
device-cache steps take whole images.

Training degrades at ``DATA_LR_SHRINK = 0.5`` whatever the model's scale
(the reference's constant); the evaluator degrades at the scale it is given.

The vanilla baseline's steps (``make_vanilla_sr_train_step`` /
``make_vanilla_sr_val_step``, :242-300) take paired ``(lr, hr)`` batches and
set the model's mode: a training forward normalises with the batch's
statistics and moves the BatchNorm running buffers as flax's mutable
``batch_stats`` do; validation uses the running statistics.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from adunet_torch.data.device_cache import sample_patch_batch
from adunet_torch.losses.sr import charbonnier_loss, l1_loss, mse_loss
from adunet_torch.metrics.psnr_ssim import (
    mse_per_image,
    msssim_power_factors_for,
    psnr,
    ssim,
    ssim_multiscale,
)
from adunet_torch.ops import degrade, rgb_to_luma_bt601
from adunet_torch.train.state import TrainState

__all__ = [
    "DATA_LR_SHRINK",
    "sr_loss_and_metrics",
    "lift_per_sample",
    "make_sr_train_step",
    "make_sr_val_step",
    "make_sr_eval_step",
    "make_sr_device_cache_train_step",
    "make_vanilla_sr_train_step",
    "make_vanilla_sr_val_step",
]

DATA_LR_SHRINK = 0.5
# losses that are a mean over elements: a row shard's share is its rows' mean
_ROW_LOSSES = (charbonnier_loss, l1_loss, mse_loss)

Batch = torch.Tensor | np.ndarray | Tuple


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


def _as_f01(x: torch.Tensor) -> torch.Tensor:
    """uint8 wire format -> [0, 1] float32; anything else passes through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * (1.0 / 255.0)
    return x


def _lr_hr_of(batch: Batch, data_scale: float, device: torch.device, space=None,
              height: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bare array is an HR batch whose LR side is degraded on the device; an
    ``(lr, hr)`` pair carries real LR pixels. With ``space``, the batch holds
    that shard's rows of images of ``height`` rows."""
    if isinstance(batch, (tuple, list)):
        lr_batch, hr_batch = batch
        return _as_f01(_to_device(lr_batch, device)), _as_f01(_to_device(hr_batch, device))
    hr_batch = _as_f01(_to_device(batch, device))
    return degrade(hr_batch, data_scale, space=space, height=height), hr_batch


def sr_loss_and_metrics(loss_fn, hr: torch.Tensor, pred: torch.Tensor, space=None,
                        height: int | None = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"psnr": batch-mean PSNR of the prediction clipped to [0, 1]}).
    With ``space``, hr and pred hold that shard's rows of images of
    ``height`` rows: the loss is the shard's share (module docstring) and the
    PSNR the whole images'."""
    loss = loss_fn(hr, pred)
    if space is not None:
        if loss_fn not in _ROW_LOSSES:
            raise NotImplementedError("on a space mesh the SR step takes an elementwise-mean "
                                      "loss (charbonnier, l1 or mse)")
        loss = loss * (hr.shape[1] * space.shards / height)
    with torch.no_grad():
        clipped = torch.clamp(pred.to(torch.float32), 0.0, 1.0)
        if space is None:
            metrics = {"psnr": torch.mean(psnr(hr.to(torch.float32), clipped))}
        else:
            sq = space.sum(torch.square(hr.to(torch.float32) - clipped).sum(dim=(1, 2, 3)))
            mse = sq / (height * hr.shape[2] * hr.shape[3])
            metrics = {"psnr": torch.mean(10.0 * (torch.log(1.0 / mse) / math.log(10.0)))}
    return loss, metrics


def _split(batch: Batch, k: int) -> Sequence[Batch]:
    """k equal micro-batches along the leading axis (each leaf of a pair)."""
    if isinstance(batch, (tuple, list)):
        parts = [_split(leaf, k) for leaf in batch]
        return [tuple(p[i] for p in parts) for i in range(k)]
    if batch.shape[0] % k:
        raise ValueError(f"batch size {batch.shape[0]} is not divisible by grad_accum={k}.")
    m = batch.shape[0] // k
    return [batch[i * m : (i + 1) * m] for i in range(k)]


def _update(state: TrainState, loss_fn, pairs, k: int, height: int | None = None
            ) -> Dict[str, torch.Tensor]:
    """Forward + backward over the k (lr, hr) micro-batches produced by
    ``pairs``, then ONE update on the mean of their gradients (each
    micro-loss is scaled by 1/k, so the accumulated ``.grad`` is the mean).
    Returns the metrics averaged over the micro-batches. On a space mesh
    ``height`` is the images' global height."""
    space = state.space
    state.optimizer.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    for i, (lr_b, hr_b) in enumerate(pairs):
        # across processes, only the last micro-batch's backward reduces
        with state.no_sync() if i < k - 1 else contextlib.nullcontext():
            pred = (state.train_module(lr_b) if space is None
                    else state.train_module(lr_b, height=height))
            loss, metrics = sr_loss_and_metrics(loss_fn, hr_b, pred, space, height)
            (loss / k if k > 1 else loss).backward()
        for name, value in {"loss": loss.detach(), **metrics}.items():
            value = value.to(torch.float32)
            sums[name] = value if name not in sums else sums[name] + value
    state.apply_gradients()
    return state.reduce_metrics({name: v / k for name, v in sums.items()} if k > 1 else sums)


def make_sr_train_step(model, loss_fn: Callable, data_scale: float = DATA_LR_SHRINK,
                       grad_accum: int = 1):
    """``(state, batch, rng=None) -> (state, metrics)``.

    ``batch``: (B, P, P, 3) HR patches (float in [0, 1] or uint8), whose LR
    side is degraded on the device, or an ``(lr, hr)`` pair.
    ``grad_accum=k`` runs k sequential micro-batches of B/k and one update on
    the mean gradient: the full-batch update up to float summation order.
    The last gradients stay in the parameters' ``.grad`` until the next step."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}.")

    def step(state: TrainState, batch: Batch, rng=None):
        del rng  # SR training is deterministic given the batch
        dev = _device_of(state.model)
        micro = _split(batch, grad_accum) if grad_accum > 1 else [batch]
        space = state.space
        height = None
        if space is not None:  # the rows' global height, from every shard's count
            hr_leaf = batch[1] if isinstance(batch, (tuple, list)) else batch
            height = space.global_height(hr_leaf.shape[1], dev)
        pairs = (_lr_hr_of(mb, data_scale, dev, space, height) for mb in micro)
        return state, _update(state, loss_fn, pairs, grad_accum, height)

    return step


def lift_per_sample(fn: Callable) -> Callable:
    """Lift a batch-mean ``fn(y_true, y_pred) -> scalar`` to a (B,) vector,
    each sample evaluated as its own batch of one; a ``fn`` that returns a
    dict of scalars gives a dict of (B,) vectors."""

    def per_sample(t: torch.Tensor, p: torch.Tensor):
        rows = [fn(t[i : i + 1], p[i : i + 1]) for i in range(t.shape[0])]
        if isinstance(rows[0], dict):
            return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return torch.stack(rows)

    return per_sample


def make_sr_val_step(model, loss_fn: Callable, data_scale: float = DATA_LR_SHRINK,
                     per_sample: bool = False):
    """``(state, batch) -> metrics``: loss and PSNR on HR patches (or pairs),
    as batch means or, with ``per_sample``, as (B,) vectors."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        lr_batch, hr_batch = _lr_hr_of(batch, data_scale, _device_of(state.model))
        pred = state.model(lr_batch)
        if per_sample:
            clipped = torch.clamp(pred.to(torch.float32), 0.0, 1.0)
            return {
                "loss": lift_per_sample(loss_fn)(hr_batch, pred),
                "psnr": psnr(hr_batch.to(torch.float32), clipped),
            }
        loss, metrics = sr_loss_and_metrics(loss_fn, hr_batch, pred)
        return {"loss": loss, **metrics}

    return step


def make_sr_eval_step(model, eval_scale: float, eval_shave: int):
    """``(state, batch) -> per-patch metric vectors``: degrade at
    ``eval_scale``, predict, clip, BT.601 luma, shave ``eval_shave`` pixels,
    then PSNR / SSIM / MS-SSIM / MSE per patch."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        lr_batch, hr_batch = _lr_hr_of(batch, eval_scale, _device_of(state.model))
        pred = torch.clamp(state.model(lr_batch).to(torch.float32), 0.0, 1.0)
        pred_y = rgb_to_luma_bt601(pred)
        hr_y = rgb_to_luma_bt601(hr_batch.to(torch.float32))
        if eval_shave > 0:
            pred_y = pred_y[:, eval_shave:-eval_shave, eval_shave:-eval_shave, :]
            hr_y = hr_y[:, eval_shave:-eval_shave, eval_shave:-eval_shave, :]
        factors = msssim_power_factors_for(min(pred_y.shape[-3], pred_y.shape[-2]))
        return {
            "psnr_y": psnr(hr_y, pred_y),
            "ssim_y": ssim(hr_y, pred_y),
            "msssim_y": ssim_multiscale(hr_y, pred_y, power_factors=factors),
            "mse_y": mse_per_image(hr_y, pred_y),
        }

    return step


def make_sr_device_cache_train_step(model, loss_fn: Callable, images_u8: torch.Tensor,
                                    patch_size: int, batch_size: int,
                                    data_scale: float = DATA_LR_SHRINK, grad_accum: int = 1):
    """``(state, batch, rng) -> (state, metrics)`` sampling its own batch from
    the device-resident uint8 corpus ``images_u8``; ``batch`` is ignored and
    ``rng`` is a ``torch.Generator`` on the corpus's device. With
    ``grad_accum=k`` the full batch is sampled once and split into k
    micro-batches, so the data equal the k=1 step's for the same generator."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}.")
    if batch_size % grad_accum:
        raise ValueError(f"batch_size={batch_size} is not divisible by grad_accum={grad_accum}.")

    def step(state: TrainState, batch, rng: torch.Generator):
        del batch  # the corpus lives on the device; rng is the data source
        if state.space is not None:
            raise NotImplementedError("the device-cache step samples whole patches; on a space "
                                      "mesh feed make_sr_train_step each process's rows "
                                      "(shard_batch)")
        if rng is None:
            raise ValueError("the device-cache step needs a torch.Generator on the corpus's device")
        hr = sample_patch_batch(images_u8, rng, batch_size, patch_size)
        micro = _split(hr, grad_accum) if grad_accum > 1 else [hr]
        pairs = ((degrade(hr_mb, data_scale, patch_size), hr_mb) for hr_mb in micro)
        return state, _update(state, loss_fn, pairs, grad_accum)

    return step


def _pair_of(batch: Batch, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    lr_batch, hr_batch = batch
    return _as_f01(_to_device(lr_batch, device)), _as_f01(_to_device(hr_batch, device))


def make_vanilla_sr_train_step(model, loss_fn: Callable):
    """``(state, (lr, hr), rng=None) -> (state, metrics)`` for a BatchNorm SR
    model: a training-mode forward (running statistics updated), the loss,
    the backward and one Adam update; PSNR of the float32 prediction clipped
    to [0, 1]."""

    def step(state: TrainState, batch: Batch, rng=None):
        del rng
        lr_batch, hr_batch = _pair_of(batch, _device_of(state.model))
        state.train_module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = sr_loss_and_metrics(loss_fn, hr_batch, state.train_module(lr_batch))
        loss.backward()
        state.apply_gradients()
        return state, state.reduce_metrics({"loss": loss.detach(), **metrics})

    return step


def make_vanilla_sr_val_step(model, loss_fn: Callable, per_sample: bool = False):
    """``(state, (lr, hr)) -> metrics`` with the running statistics: loss and
    PSNR as batch means or, with ``per_sample``, as (B,) vectors."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        lr_batch, hr_batch = _pair_of(batch, _device_of(state.model))
        state.model.eval()
        pred = state.model(lr_batch)
        clipped = torch.clamp(pred.to(torch.float32), 0.0, 1.0)
        psnr_v = psnr(hr_batch.to(torch.float32), clipped)
        if per_sample:
            return {"loss": lift_per_sample(loss_fn)(hr_batch, pred), "psnr": psnr_v}
        return {"loss": loss_fn(hr_batch, pred), "psnr": torch.mean(psnr_v)}

    return step
