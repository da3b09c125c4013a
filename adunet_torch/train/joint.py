"""Joint SR + segmentation train / eval steps.

Port of ``adunet/train/joint.py``. A batch is ``(images, masks)``; the SR
target is the clean image itself (SR as restoration). Each step moves the
batch to the model's device (the train step, a ``CompiledStep`` of
``adunet_torch.train.compiled``, stages it for a CUDA graph that holds the
rest on a CUDA model in one process), takes uint8 images to [0, 1] float32
(``_as_f01``), degrades them there at ``data_scale``, runs both heads and
computes ``sr_weight * sr_loss + seg_weight * seg_loss``. Metrics (0-d
tensors on the device, or (B,) vectors per sample): ``loss``, ``sr_loss``,
``seg_loss``, ``psnr`` of the SR output clipped to [0, 1], ``dice`` and
``iou`` of the mask.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from adunet_torch.metrics.psnr_ssim import psnr
from adunet_torch.metrics.seg import dice_coefficient, iou_score
from adunet_torch.ops import degrade
from adunet_torch.train.compiled import CompiledStep
from adunet_torch.train.sr import _as_f01, _device_of, _to_device, lift_per_sample
from adunet_torch.train.state import TrainState

__all__ = ["make_joint_train_step", "make_joint_eval_step"]


def _joint_loss_and_metrics(sr_loss_fn: Callable, seg_loss_fn: Callable, sr_weight: float,
                            seg_weight: float, hr: torch.Tensor, masks: torch.Tensor,
                            sr_pred: torch.Tensor, seg_pred: torch.Tensor
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    sr_l = sr_loss_fn(hr, sr_pred)
    seg_l = seg_loss_fn(masks, seg_pred)
    loss = sr_weight * sr_l + seg_weight * seg_l
    with torch.no_grad():
        clipped = torch.clamp(sr_pred.detach().to(torch.float32), 0.0, 1.0)
        seg_d = seg_pred.detach()
        metrics = {
            "sr_loss": sr_l.detach(),
            "seg_loss": seg_l.detach(),
            "psnr": torch.mean(psnr(hr.to(torch.float32), clipped)),
            "dice": dice_coefficient(masks, seg_d),
            "iou": iou_score(masks, seg_d),
        }
    return loss, metrics


def _batch_of(batch, device: torch.device, data_scale: float):
    """(lr, hr, masks) on ``device``: the LR side degraded there."""
    images, masks = batch
    hr = _as_f01(_to_device(images, device))
    return degrade(hr, data_scale), hr, _to_device(masks, device)


def make_joint_train_step(model, sr_loss_fn: Callable, seg_loss_fn: Callable,
                          sr_weight: float = 1.0, seg_weight: float = 1.0,
                          data_scale: float = 0.5, graph: bool | None = None):
    """``(state, (images, masks), rng=None) -> (state, metrics)``: forward,
    the weighted multi-task loss, backward and one Adam update.
    ``graph``: ``CompiledStep``'s."""

    def body(state: TrainState, inputs, rng=None):
        del rng  # the joint step is deterministic given the batch
        lr_batch, hr, masks = _batch_of(inputs, _device_of(state.model), data_scale)
        state.optimizer.zero_grad(set_to_none=True)
        sr_pred, seg_pred = state.train_module(lr_batch)
        loss, metrics = _joint_loss_and_metrics(sr_loss_fn, seg_loss_fn, sr_weight, seg_weight,
                                                hr, masks, sr_pred, seg_pred)
        loss.backward()
        state.update()
        return state.reduce_metrics({"loss": loss.detach(), **metrics})

    return CompiledStep(body, graph)


def make_joint_eval_step(model, sr_loss_fn: Callable, seg_loss_fn: Callable,
                         sr_weight: float = 1.0, seg_weight: float = 1.0,
                         data_scale: float = 0.5, per_sample: bool = False):
    """``(state, (images, masks)) -> metrics`` as batch values or, with
    ``per_sample``, as (B,) vectors (each sample's loss and metric tail as a
    batch of one)."""

    def tail(hr, masks, sr_pred, seg_pred) -> Dict[str, torch.Tensor]:
        loss, metrics = _joint_loss_and_metrics(sr_loss_fn, seg_loss_fn, sr_weight, seg_weight,
                                                hr, masks, sr_pred, seg_pred)
        return {"loss": loss, **metrics}

    @torch.no_grad()
    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        lr_batch, hr, masks = _batch_of(batch, _device_of(state.model), data_scale)
        sr_pred, seg_pred = state.model(lr_batch)
        if not per_sample:
            return tail(hr, masks, sr_pred, seg_pred)
        # one (B, H, W, 3 + C) target and prediction, split again per sample
        per = lift_per_sample(lambda t, p: tail(t[..., :3], t[..., 3:], p[..., :3], p[..., 3:]))
        f32 = torch.float32
        return per(torch.cat([hr.to(f32), masks.to(f32)], dim=-1),
                   torch.cat([sr_pred.to(f32), seg_pred.to(f32)], dim=-1))

    return step
