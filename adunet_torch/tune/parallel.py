"""Trial lanes for the hyperparameter tuner: a group of vanilla-SR trials
trained together on one card.

Port of ``adunet/tune/parallel.py``. The reference stacks K trials that
share a batch size on a leading trial axis and advances them with one
``jax.vmap``-ed program, shard_mapped over the device mesh: XLA compiles one
program per shape, so the lanes must be one program. The port cannot vmap
this model: the kernels' ``autograd.Function``s (``adunet_torch/kernels``)
define no vmap rule, and the written-out BatchNorm updates its running
buffers in place. PyTorch runs eagerly, so it needs no shared program
either. Here the lanes are copies of one model, stepped in turn:

- **shared start**: the model is built once from the seed (or loaded from
  ``init_state``) and copied per lane, so every lane, and every sequential
  trial, starts from the same weights, as ``_stacked_state`` broadcasts one
  init in the reference;
- **per-lane state**: each lane has its own model copy (its own BatchNorm
  buffers), its own Adam at its learning rate (eps 1e-7; the reference
  injects a per-lane rate with ``optax.inject_hyperparams``) and its own
  loss weights alpha / beta / gamma;
- **same loss**: alpha MSE + beta (1 - SSIM) + gamma mean((f(HR) -
  f(clip(pred)))^2), the reference's ``lane_loss``
  (``adunet_torch.losses.sr.combined_loss``, with ``jnp.clip``'s tie split);
- **HR features once**: the VGG19 tower runs on the HR batch once per batch
  and every lane reads the result, as ``batched_train`` hoists it;
- **same data stream**: one ``ArrayDataset`` per group with the reference's
  seed and shuffle, so every lane trains on the same batches in the same
  order, moved to the card once per batch.

Lane ``i`` of a group therefore computes what a one-lane group of its config
computes, operation for operation: bit for bit where cuDNN runs
deterministic algorithms (``adunet_torch.utils.deterministic_cudnn``, as the
tuner's CLI runs), and within cuDNN's run-to-run noise otherwise. On one
card K lanes take about K times one trial, less K - 1 HR tower forwards per
batch.

With a ``mesh`` (a one-dim ``DeviceMesh`` over the processes of a
``torchrun`` launch; the reference shard_maps its trial axis over a mesh,
:206-228) the lanes spread over the processes: lane ``i`` trains on the
process at coordinate ``i mod n``, each process steps its own lanes on its
own GPU with no collective inside a trial, and each epoch's validation
losses reach every process by ``all_gather_object``. Every process then
holds every curve and takes the same early-stop decision, so a study driven
by them stays the same on every process.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from adunet_torch.data import ArrayDataset
from adunet_torch.losses import make_perceptual_fn
from adunet_torch.losses.sr import combined_loss, perceptual_target
from adunet_torch.models import build_vanilla_sr_unet
from adunet_torch.train import TrainState, create_train_state, make_optimizer, repeat
from adunet_torch.utils.runtime import resolve_device

__all__ = ["BatchedVanillaSRTuner", "Lane", "group_trials_by"]


def group_trials_by(trials: Sequence, key: str) -> Dict[object, List]:
    """Group asked trials by a shape-affecting parameter (insertion-ordered)."""
    groups: Dict[object, List] = {}
    for t in trials:
        groups.setdefault(t.params[key], []).append(t)
    return groups


@dataclass
class Lane:
    """One trial of a group: its model copy and Adam, and its loss weights."""

    state: TrainState
    alpha: float
    beta: float
    gamma: float


class BatchedVanillaSRTuner:
    """Trains groups of same-batch-size vanilla-SR trials as lanes.

    Mirrors the sequential ``run_config`` of ``adunet_torch.cli.tune`` (the
    rebuild of u_net_vanilla_optuna.py:111-196): the same data split,
    per-trial init, combined loss and best-val-loss objective, so lane ``i``
    reproduces sequential trial ``i``.

    ``lane_width`` is accepted for the reference's signature and steps no
    padded lane: the reference pads a group up to a fixed width only so that
    every group shares one compiled program, and discards the padded lanes'
    results. In eager PyTorch a padded lane would be a whole trial of wasted
    work. ``mesh`` spreads the lanes over the processes of a one-dim
    ``DeviceMesh`` (see the module docstring). ``init_state`` (a state_dict)
    replaces the seeded init of every lane; ``device`` is ``cuda`` by
    default (raises without a GPU) or ``cpu``.
    """

    def __init__(
        self,
        lr_images: np.ndarray,
        hr_images: np.ndarray,
        train_idx: Sequence[int],
        val_idx: Sequence[int],
        *,
        base_channels: int = 64,
        seed: int = 42,
        perceptual_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        mesh=None,
        lane_width: Optional[int] = None,
        device: str | torch.device = "cuda",
        init_state: Optional[Dict[str, torch.Tensor]] = None,
    ):
        if mesh is not None and (not isinstance(mesh, DeviceMesh) or mesh.ndim != 1):
            raise ValueError(f"mesh must be a one-dim DeviceMesh over the processes, got {mesh!r}")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.lr_images, self.hr_images = lr_images, hr_images
        self.train_idx = np.asarray(train_idx)
        self.val_idx = np.asarray(val_idx)
        self.seed = seed
        self.lane_width = lane_width
        self.image_size = int(hr_images.shape[1])
        self.model = build_vanilla_sr_unet(base_channels=base_channels, device=self.device,
                                           seed=seed)
        if init_state is not None:
            self.model.load_state_dict(init_state)
        self.perceptual_fn = perceptual_fn or make_perceptual_fn(input_size=self.image_size,
                                                                 device=self.device)

    def lanes(self, configs: Sequence[Dict[str, float]]) -> List[Lane]:
        """One lane per config (``lr``, ``alpha``, ``beta``, ``gamma``), each a
        copy of the shared init with its own Adam."""
        out = []
        for c in configs:
            model = copy.deepcopy(self.model)
            state = create_train_state(model, make_optimizer(model.parameters(), float(c["lr"])))
            out.append(Lane(state, float(c["alpha"]), float(c["beta"]), float(c["gamma"])))
        return out

    def _to_device(self, batch):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)
                     for a in batch)

    def _loss(self, lane: Lane, lr_b, hr_b, hr_feats) -> torch.Tensor:
        return combined_loss(hr_b, lane.state.model(lr_b), hr_feats, self.perceptual_fn,
                             lane.alpha, lane.beta, lane.gamma)

    def train_step(self, lanes: Sequence[Lane], batch) -> None:
        """One Adam update of every lane on ``batch`` = (lr, hr) numpy arrays
        or tensors: the HR features once, then each lane's training-mode
        forward (its running statistics move), loss and backward in turn."""
        lr_b, hr_b = self._to_device(batch) if isinstance(batch[0], np.ndarray) else batch
        hr_feats = perceptual_target(self.perceptual_fn, hr_b)
        for lane in lanes:
            state = lane.state
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            self._loss(lane, lr_b, hr_b, hr_feats).backward()
            state.apply_gradients()

    @torch.no_grad()
    def val_losses(self, lanes: Sequence[Lane], batch) -> torch.Tensor:
        """Each lane's batch-mean loss on ``batch`` with its running
        statistics, as a (lanes,) tensor on the device."""
        lr_b, hr_b = self._to_device(batch) if isinstance(batch[0], np.ndarray) else batch
        hr_feats = perceptual_target(self.perceptual_fn, hr_b)
        losses = []
        for lane in lanes:
            lane.state.model.eval()
            losses.append(self._loss(lane, lr_b, hr_b, hr_feats))
        return torch.stack(losses)

    def run_group(
        self,
        configs: Sequence[Dict[str, float]],
        batch_size: int,
        epochs: int,
        on_epoch=None,
    ) -> List[List[float]]:
        """Train one group of same-batch-size trials in lockstep.

        ``configs``: per-trial dicts with lr / alpha / beta / gamma. Returns
        the per-trial validation-loss curve (one value per epoch: the mean
        over the validation batches weighted by their sizes), from which the
        caller reports and tells (the sequential objective's value is the
        curve's minimum).

        ``on_epoch(epoch, last_vals)``: optional callback with the epoch's
        per-trial validation losses; returning truthy stops the whole group
        early (the curves end at that epoch). The sequential study drives a
        one-lane group through it for live median pruning."""
        n, me = (1, 0) if self.mesh is None else (self.mesh.size(0), self.mesh.get_local_rank(0))
        mine = [i for i in range(len(configs)) if i % n == me]  # this process's lanes
        lanes = self.lanes([configs[i] for i in mine])
        train_ds = ArrayDataset(
            self.lr_images[self.train_idx], self.hr_images[self.train_idx],
            batch_size=batch_size, shuffle=True, seed=self.seed,
        )
        val_ds = ArrayDataset(
            self.lr_images[self.val_idx], self.hr_images[self.val_idx],
            batch_size=batch_size, shuffle=False, seed=self.seed,
        )
        curves: List[List[float]] = [[] for _ in configs]
        it = repeat(train_ds)
        for epoch in range(epochs):
            epoch_val: Dict[int, float] = {}
            if lanes:
                for _ in range(train_ds.steps_per_epoch):
                    self.train_step(lanes, next(it))
                vals, weights = [], []
                for batch in val_ds:
                    vals.append(self.val_losses(lanes, batch))
                    weights.append(batch[0].shape[0])
                per_batch = torch.stack(vals).cpu().numpy()  # (batches, lanes)
                epoch_val = dict(zip(mine, np.average(per_batch, axis=0, weights=weights)))
            if self.mesh is not None:  # every process gets every lane's value
                parts: List[Dict[int, float]] = [{} for _ in range(n)]
                dist.all_gather_object(parts, epoch_val, group=self.mesh.get_group(0))
                epoch_val = {i: v for part in parts for i, v in part.items()}
            for i, lane_curve in enumerate(curves):
                lane_curve.append(float(epoch_val[i]))
            if on_epoch is not None and on_epoch(epoch, [c[-1] for c in curves]):
                break
        return curves
