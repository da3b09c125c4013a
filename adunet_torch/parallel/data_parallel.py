"""Data-parallel training of a ``TrainState`` across the processes of a mesh.

The counterpart of the reference's replicated (``replicate``) or
channel-sharded (``shard_state``) train state on a mesh, where XLA inserts
the gradient all-reduce. ``data_parallel(state, mesh)`` returns the state
set up so that the port's train steps compute on the global batch:

- on a ``("data",)`` mesh the model is wrapped in
  ``DistributedDataParallel`` over the data axis with
  ``broadcast_buffers=False`` (BatchNorm's buffers are already the same on
  every process: see below), and DDP averages the gradients in backward;
- on a ``("data", "model")`` mesh the wide leaves are sharded over
  ``"model"`` (``shard_params``: FSDP2, replicated over ``"data"``), the
  optimizer is built anew over the sharded parameters (its moments follow
  their sharding), and the gradients of the replicated leaves are averaged
  over the data axis before each update (``sync_grads``);
- on a ``("data", "space")`` mesh (``make_dp_spatial_mesh``) each process
  holds its rows of every image: the model gets the mesh's ``SpaceShard``
  (``adunet_torch.parallel.spatial.attach``; only the adaptive SR U-Net is
  covered, any other model raises ``NotImplementedError``), the parameters
  stay replicated over both axes, and DDP averages the gradients over the
  whole world W = data x space. The SR step scales each process's loss to
  its rows' share (``adunet_torch.train.sr``), so that average is the global
  batch's gradient;
- every ``BatchNorm`` takes its training statistics over the global batch
  (``BatchNorm.sync_group``), as flax's does under GSPMD.

``DataParallel`` is what the steps see through ``TrainState``: the module to
run the training forward through, ``no_sync`` for every micro-batch of an
accumulated step but the last, and ``mean_metrics``, which averages a step's
metrics over the data axis (over the whole world on a space mesh; a pooled
metric's ``name#component`` sums are summed), so the logs show the global
batch's numbers; ``space`` is the ``SpaceShard`` or None. ``state.model`` stays
the unwrapped module, whose names checkpoints and ``convert`` read.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from adunet_torch.nn.blocks import BatchNorm
from adunet_torch.parallel.distributed import is_distributed, maybe_initialize_distributed
from adunet_torch.parallel.mesh import data_extent, data_group, make_mesh, mesh_shape_for
from adunet_torch.parallel.partition import is_sharded, make_dp_model_mesh, shard_params
from adunet_torch.parallel.spatial import SpaceShard, attach
from adunet_torch.train.schedules import Adam
from adunet_torch.train.state import TrainState

__all__ = ["DataParallel", "data_parallel", "launch_mesh"]


class DataParallel:
    """The processes' share of a train state: see the module docstring."""

    def __init__(self, model: nn.Module, mesh: DeviceMesh, module: nn.Module,
                 sharded: List[nn.Module], space: Optional[SpaceShard] = None):
        self.mesh = mesh
        self.space = space
        # the processes a step's gradients and metrics are averaged over
        self.group = dist.group.WORLD if space is not None else data_group(mesh)
        self.extent = dist.get_world_size() if space is not None else data_extent(mesh)
        self.module = module  # the training forward: DDP, or the sharded model itself
        self._sharded = sharded
        self._replicated = ([p for p in model.parameters() if not is_sharded(p)]
                            if sharded else [])

    @contextlib.contextmanager
    def no_sync(self) -> Iterator[None]:
        """Accumulate gradients locally: no reduction in this backward."""
        if isinstance(self.module, nn.parallel.DistributedDataParallel):
            with self.module.no_sync():
                yield
            return
        for m in self._sharded:
            m.set_requires_gradient_sync(False, recurse=False)
        try:
            yield
        finally:
            for m in self._sharded:
                m.set_requires_gradient_sync(True, recurse=False)

    def sync_grads(self) -> None:
        """Average the replicated leaves' gradients over the data axis (the
        sharded layout; DDP reduced its own in backward)."""
        grads = [p.grad for p in self._replicated if p.grad is not None]
        if not grads or self.extent == 1:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.extent
        at = 0
        for g in grads:
            g.copy_(flat[at : at + g.numel()].view_as(g))
            at += g.numel()

    def sum_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each tensor summed over the data axis, in float32 (one all-reduce)."""
        if self.extent == 1:
            return metrics
        keys = list(metrics)
        vals = [metrics[k].detach().to(torch.float32) for k in keys]
        flat = torch.cat([v.reshape(-1) for v in vals])
        dist.all_reduce(flat, group=self.group)
        out, at = {}, 0
        for k, v in zip(keys, vals):
            out[k] = flat[at : at + v.numel()].view_as(v)
            at += v.numel()
        return out

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric averaged over the data axis; a ``name#component`` sum
        summed. One all-reduce."""
        if self.extent == 1:
            return metrics
        return {k: v if "#" in k else v / self.extent for k, v in self.sum_metrics(metrics).items()}


def data_parallel(state: TrainState, mesh: DeviceMesh, min_channels: int = 256) -> TrainState:
    """Set ``state`` up to train on ``mesh`` (see the module docstring);
    returns it. Call it before restoring a checkpoint into the state and
    before its first step."""
    model = state.model
    names = mesh.mesh_dim_names or ()
    if "space" in names:
        dim = names.index("space")
        space = SpaceShard(mesh.get_group("space"), mesh.size(dim), mesh.get_local_rank("space"))
        attach(model, space)
        ddp = nn.parallel.DistributedDataParallel(model, broadcast_buffers=False)
        state.parallel = DataParallel(model, mesh, ddp, [], space)
        return state
    group = data_group(mesh)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = group
    if "model" in names and mesh.size(names.index("model")) > 1:
        if any(len(s) for s in state.optimizer.state.values()):
            raise ValueError("shard the state before its first step or restore")
        sharded_names = shard_params(model, mesh, min_channels)
        modules = dict(model.named_modules())
        old = state.optimizer
        # one group, as a single process has, so the checkpoint's optimizer
        # state loads there; foreach off: the group mixes DTensors and tensors
        state.optimizer = Adam(model.parameters(), old.param_groups[0]["lr"],
                               schedule=old.schedule, inject_lr=old.inject_lr, foreach=False)
        state.parallel = DataParallel(model, mesh, model, [modules[n] for n in sharded_names])
        return state
    ddp = nn.parallel.DistributedDataParallel(model, process_group=group, broadcast_buffers=False)
    state.parallel = DataParallel(model, mesh, ddp, [])
    return state


def launch_mesh(device: str | torch.device, *, n_devices: Optional[int] = None,
                model_shards: int = 1, batch_size: Optional[int] = None, grad_accum: int = 1,
                command: Optional[Tuple[str, Sequence[str]]] = None) -> Optional[DeviceMesh]:
    """A trainer's launch: join the process group ``torchrun`` describes
    (``maybe_initialize_distributed``), hold ``--n_devices`` /
    ``--model_shards`` to the launch (``mesh_shape_for``; ``command`` names
    the entry point and its arguments for the hint) and build the run's
    mesh: ``("data",)``, or ``("data", "model")`` with model shards. Returns
    None for a plain single-process run. ``--batch_size`` is per process
    and must split into ``grad_accum`` micro-batches."""
    maybe_initialize_distributed(device)
    data, model = mesh_shape_for(n_devices, model_shards, command=command)
    if batch_size is not None and grad_accum > 1 and batch_size % grad_accum:
        raise ValueError(f"batch_size={batch_size} must be divisible by grad_accum={grad_accum}.")
    if not is_distributed():
        return None
    return make_dp_model_mesh(model) if model > 1 else make_mesh(data)
