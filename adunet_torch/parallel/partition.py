"""Channel sharding of the wide U-Net levels over a ``("data", "model")`` mesh.

Port of ``adunet/parallel/partition.py``. The shape rule is the
reference's in the port's layout: a conv weight ``(co, ci, kh, kw)`` whose
output channels (dim 0) number at least ``min_channels`` and divide by the
model extent is sharded on dim 0, and so is a 1-D leaf (bias, norm scale or
offset) of such a width; every other leaf is replicated. The rule is judged
on the shape alone, so a ``ConvTranspose`` weight ``(ci, co, kh, kw)`` is
judged by its input channels.

Where the reference shards the channels by tensor parallelism (GSPMD splits
the convolutions), the port applies ``torch.distributed.fsdp.fully_shard``
over the mesh to every module that owns a leaf the rule shards: the wide
weights and their Adam moments keep 1/M of their memory on each process,
and each forward and backward gathers the whole weight for the compute (K1
needs whole rows of C). The math is data parallelism's, as the reference's
is (ROADMAP: pinned divergence). Leaves the rule replicates stay plain
tensors, and their gradients are averaged over the data axis by
``adunet_torch.parallel.data_parallel``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from adunet_torch.parallel.mesh import make_dp_axis_mesh

__all__ = ["make_dp_model_mesh", "channel_partition_spec", "shard_params", "is_sharded",
           "full_tensor"]


def make_dp_model_mesh(model_shards: int, n_devices: Optional[int] = None,
                       device_type: Optional[str] = None) -> DeviceMesh:
    """A 2-D mesh ``("data", "model")`` of ``world / model_shards`` x
    ``model_shards`` processes."""
    return make_dp_axis_mesh("model", model_shards, n_devices, device_type)


def channel_partition_spec(shape: Sequence[int], model_size: int,
                           min_channels: int = 256) -> Optional[int]:
    """The dim that a leaf of ``shape`` is sharded on over ``"model"`` (0),
    or None for a replicated leaf."""
    if len(shape) in (1, 4) and shape[0] >= min_channels and shape[0] % model_size == 0:
        return 0
    return None


def shard_params(model: nn.Module, mesh: DeviceMesh, min_channels: int = 256) -> List[str]:
    """Shard ``model``'s wide leaves in place over ``mesh``'s ``"model"``
    axis (replicated over ``"data"``) with ``fully_shard``; returns the names
    of the modules sharded. Leaves the rule replicates stay plain. Build the
    optimizer after this call: the sharded leaves are new parameters."""
    from torch.distributed.fsdp import fully_shard

    if "model" not in (mesh.mesh_dim_names or ()):
        raise ValueError("mesh must carry a 'model' axis (make_dp_model_mesh).")
    model_size = mesh.size(mesh.mesh_dim_names.index("model"))

    def rule(p: nn.Parameter) -> Optional[int]:
        return channel_partition_spec(tuple(p.shape), model_size, min_channels)

    sharded = []
    # children before parents, so each module owns only the leaves left to it
    for name, module in reversed(list(model.named_modules())):
        if any(rule(p) is not None for p in module.parameters(recurse=False)):
            keep = {p for p in module.parameters() if rule(p) is None}
            fully_shard(module, mesh=mesh, ignored_params=keep or None)
            sharded.append(name)
    return sharded[::-1]


def is_sharded(t) -> bool:
    """True for a leaf that ``shard_params`` sharded (a DTensor)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a leaf that ``shard_params`` sharded (a DTensor),
    on every process; a plain tensor is returned as it is. Every process of
    the leaf's mesh must call it. The shards are gathered with c10d's
    ``all_gather``: ``DTensor.full_tensor``'s functional collectives crash
    on CUDA tensors under gloo (torch 2.11), and the rule's shards are equal
    in size."""
    if not is_sharded(t):
        return t
    local = t.to_local()
    mesh = t.device_mesh
    for dim, placement in enumerate(t.placements):
        if placement.is_shard():
            parts = [torch.empty_like(local) for _ in range(mesh.size(dim))]
            dist.all_gather(parts, local.contiguous(), group=mesh.get_group(dim))
            local = torch.cat(parts, dim=placement.dim)
    if tuple(local.shape) != tuple(t.shape):
        raise ValueError(f"gathered {tuple(local.shape)} for a leaf of {tuple(t.shape)}")
    return local
