"""Device meshes over the processes of a run, and batch shards.

Port of ``adunet/parallel/mesh.py``. A process drives one GPU, so a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the run's processes
with the dim names ``("data",)``, ``("data", "model")`` or ``("data",
"space")`` (``make_dp_spatial_mesh``: each image's height split over the
``"space"`` processes, ``adunet_torch.parallel.spatial``). Where the
reference puts a host batch on the mesh sharded on its leading dim
(``shard_batch``), here each process takes its own rows of the global batch
(``shard_batch``), and on a mesh with ``"space"`` its rows of every image's
height (``height_split``, as the reference's ``batch_sharding`` shards the
height over ``"space"``); ragged validation and evaluation batches are padded to a
multiple of the data extent by repeating their last row and come with a
mask of the real rows (``pad_and_shard_ragged``). ``replicate`` broadcasts a
module's parameters and buffers from process 0.

``mesh_shape_for`` holds the launch contract of the trainers' ``--n_devices``
and ``--model_shards``: ``--n_devices`` is the mesh's global device count,
which under ``torchrun`` must equal ``WORLD_SIZE``; in a plain single process
a count above 1 raises with the ``torchrun`` line to use.
"""

from __future__ import annotations

import shlex
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from adunet_torch.parallel.distributed import is_distributed, process_count
from adunet_torch.parallel.spatial import height_split

__all__ = [
    "auto_data_parallel_size",
    "mesh_shape_for",
    "make_mesh",
    "make_dp_axis_mesh",
    "make_dp_spatial_mesh",
    "data_extent",
    "data_index",
    "data_group",
    "shard_batch",
    "pad_and_shard_ragged",
    "replicate",
]


def auto_data_parallel_size(batch_size: int, n_available: Optional[int] = None,
                            micro_factor: int = 1) -> int:
    """Largest data-axis extent that evenly splits the (micro-)batch.

    The reference's policy for a batch smaller than the mesh (its sweep
    tables go down to batch 1-2): cap the data axis at the largest divisor
    of ``batch_size / micro_factor`` that fits ``n_available`` devices
    (default: the process count, one GPU a process; 1 in a plain process).
    ``micro_factor`` is the gradient-accumulation factor."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}.")
    micro_factor = max(1, micro_factor)
    if batch_size % micro_factor != 0:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by grad_accum={micro_factor}.")
    if n_available is None:
        n_available = process_count()
    micro = batch_size // micro_factor
    for d in range(min(micro, n_available), 0, -1):
        if micro % d == 0:
            return d
    return 1


def mesh_shape_for(n_devices: Optional[int] = None, model_shards: int = 1, *,
                   command: Optional[Tuple[str, Sequence[str]]] = None) -> Tuple[int, int]:
    """``(data, model)`` extents of a run's mesh.

    Under a process group ``n_devices`` must be None or the world size and
    ``model_shards`` must divide it; the data extent is ``world /
    model_shards``. In a plain single process (one GPU) anything above 1
    raises; ``command = (module, argv)`` puts the ``torchrun`` line that
    runs the request into the message."""
    if model_shards < 1:
        raise ValueError(f"--model_shards must be >= 1, got {model_shards}.")
    if not is_distributed():
        want = max(n_devices or 1, model_shards)
        if want > 1:
            module, argv = command or ("adunet_torch.cli.<trainer>", ["..."])
            line = (f"torchrun --nproc-per-node {want} -m {module} "
                    + " ".join(shlex.quote(a) for a in argv))
            raise ValueError(
                f"--n_devices {n_devices} / --model_shards {model_shards} asks for {want} "
                f"GPUs, but one process drives one GPU. Launch one process per GPU:\n  {line}")
        return 1, 1
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"--n_devices {n_devices} must equal the launch's WORLD_SIZE {world} "
                         "(or be omitted): one process drives one GPU.")
    if world % model_shards != 0:
        raise ValueError(f"{world} devices not divisible by model shards={model_shards}.")
    return world // model_shards, model_shards


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              mesh_shape: Optional[Tuple[int, ...]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over the run's processes (default: all of them), rank ``r`` at
    the row-major position ``r``. ``device_type`` defaults to ``cuda`` under
    NCCL and ``cpu`` under gloo. Needs a process group
    (``maybe_initialize_distributed``)."""
    if not is_distributed():
        raise RuntimeError("make_mesh needs a process group: launch with torchrun "
                           "(maybe_initialize_distributed joins it).")
    world = process_count()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"Requested {n} devices but the run has {world} processes "
                         "(one device each).")
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} does not hold {n} devices")
    return init_device_mesh(_device_type(device_type), tuple(mesh_shape),
                            mesh_dim_names=tuple(axis_names))


def make_dp_axis_mesh(axis_name: str, shards: int, n_devices: Optional[int] = None,
                      device_type: Optional[str] = None) -> DeviceMesh:
    """2-D mesh ``("data", axis_name)`` of ``world / shards`` x ``shards``
    processes: data parallel x a second sharding axis. ``n_devices``
    (default: every process) above the run's process count raises, as does
    a count that ``shards`` does not divide."""
    world = process_count()
    total = world if n_devices is None else int(n_devices)
    if total > world:  # the reference's loud guard: no silent run at a fraction of the request
        raise ValueError(f"Requested {total} devices but only {world} available.")
    if total % shards != 0:
        raise ValueError(f"{total} devices not divisible by {axis_name} shards={shards}.")
    return make_mesh(total, axis_names=("data", axis_name), mesh_shape=(total // shards, shards),
                     device_type=device_type)


def make_dp_spatial_mesh(spatial_shards: int, n_devices: Optional[int] = None,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """2-D mesh ``("data", "space")``: data parallel x the image height split
    over ``spatial_shards`` processes, which divides each process's
    activation memory for the 256-px deep configs (``data_parallel`` on it
    runs the adaptive SR U-Net on row shards)."""
    return make_dp_axis_mesh("space", spatial_shards, n_devices, device_type)


def data_extent(mesh: Optional[DeviceMesh], axis: str = "data") -> int:
    """The number of data-parallel shards (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def data_index(mesh: Optional[DeviceMesh], axis: str = "data") -> int:
    """This process's coordinate on the data axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def data_group(mesh: DeviceMesh, axis: str = "data"):
    """The process group of this process's data axis."""
    return mesh.get_group(axis)


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return tuple(_map(fn, b) for b in batch)
    return fn(batch)


def _lead(batch) -> int:
    leaf = batch[0] if isinstance(batch, (tuple, list)) else batch
    return int(leaf.shape[0])


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data"):
    """This process's rows of a global batch (an array, a tensor or a tuple
    of them) whose leading dim the data extent divides; on a mesh with a
    ``"space"`` axis, also its rows of each image's height (dim 1, NHWC) by
    ``height_split``."""
    n, i = data_extent(mesh, axis), data_index(mesh, axis)
    total = _lead(batch)
    if total % n:
        raise ValueError(f"global batch {total} does not split over {n} data shards")
    per = total // n
    local = _map(lambda x: x[i * per : (i + 1) * per], batch)
    if "space" not in (mesh.mesh_dim_names or ()):
        return local
    shards, j = data_extent(mesh, "space"), data_index(mesh, "space")
    return _map(lambda x: x[:, slice(*height_split(x.shape[1], shards, j))], local)


def _pad_leading_to(x, n: int):
    """Pad the leading dim to ``n`` rows by repeating the last row."""
    if x.shape[0] >= n:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])], dim=0)
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], n - x.shape[0], axis=0)], axis=0)


def pad_and_shard_ragged(batch, mesh: DeviceMesh, axis: str = "data"):
    """Shard a batch of any leading size over the data axis.

    The leading dim is padded to the next multiple of the data extent by
    repeating the last row, and this process takes its rows. Returns
    ``(local_batch, local_mask, n_valid)``: ``local_mask`` is a float32
    (rows,) tensor with 1.0 on real rows, ``n_valid`` the global batch's
    real row count."""
    n, i = data_extent(mesh, axis), data_index(mesh, axis)
    n_valid = _lead(batch)
    padded = -(-n_valid // n) * n
    per = padded // n
    local = _map(lambda x: _pad_leading_to(x, padded)[i * per : (i + 1) * per], batch)
    mask = (torch.arange(i * per, (i + 1) * per) < n_valid).to(torch.float32)
    return local, mask, n_valid


def replicate(module: torch.nn.Module, mesh: Optional[DeviceMesh] = None,
              axis: str = "data") -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the first process
    of ``mesh``'s data axis (default: from rank 0 of the whole run); returns
    the module."""
    if not is_distributed():
        return module
    group = data_group(mesh, axis) if mesh is not None else None
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module
