"""Multi-process launch: ``torchrun``'s environment, process 0's artifacts and
equal-length data shards.

Port of ``adunet/parallel/distributed.py``. A multi-GPU run is launched with
``torchrun --nproc-per-node N -m adunet_torch.cli.<trainer> ...``: one
process per GPU. ``maybe_initialize_distributed`` reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; the reference reads ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), binds ``cuda:LOCAL_RANK`` and
joins an NCCL group, or a gloo group for ``device="cpu"``. A half-set
environment raises, a plain single-process run is a no-op, and a repeat call
returns the group that is already there.

``process_shard`` gives every process an equal-length slice of a global
list (unequal step counts would leave a process waiting in a collective at
the first epoch boundary), ``process_seed`` decorrelates the processes'
random streams, and ``is_main_process`` gates the artifacts that one process
writes for the run (config, summary, CSV, TensorBoard, checkpoints).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "maybe_initialize_distributed",
    "is_distributed",
    "is_main_process",
    "process_index",
    "process_count",
    "process_shard",
    "process_seed",
    "barrier",
    "broadcast_from_main",
]

_LAUNCH_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    """The number of processes in the run (1 without a process group)."""
    return dist.get_world_size() if is_distributed() else 1


def is_main_process() -> bool:
    """True on the process that writes the run's host-side artifacts: on a
    shared filesystem every process sees the same run directory, and two
    writers would clobber each other."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (a no-op without a process group)."""
    if is_distributed():
        dist.barrier()


def broadcast_from_main(obj):
    """Process 0's ``obj`` on every process (a picklable value such as a run
    name's timestamp); ``obj`` itself without a process group."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def process_shard(seq: Sequence, *, seed: Optional[int] = None, index: Optional[int] = None,
                  count: Optional[int] = None) -> List:
    """This process's stride-slice of a global sequence (file or pair lists).

    Every shard has ``ceil(len / n)`` items, wrapping around the sequence
    when ``n`` does not divide it: the steps per epoch derive from the shard
    length and must be equal on every process. With ``seed`` (the run's
    seed, the same on every process) and a length that ``n`` does not
    divide, one shared permutation is applied first, so the wrapped
    duplicates are a seeded random subset rather than always the first
    items. ``index`` / ``count`` name the shard and the number of shards
    (default: this process and the process count; a run with model shards
    passes its data-parallel coordinates). One shard returns ``seq``
    unchanged."""
    n = process_count() if count is None else int(count)
    if n <= 1 or not len(seq):
        return seq
    if seed is not None and len(seq) % n:
        import numpy as np

        order = np.random.default_rng(int(seed)).permutation(len(seq))
        seq = [seq[int(i)] for i in order]
    pid = process_index() if index is None else int(index)
    per = math.ceil(len(seq) / n)
    return [seq[i % len(seq)] for i in range(pid, pid + n * per, n)]


def process_seed(seed: int, *, index: Optional[int] = None) -> int:
    """Decorrelate the processes' random streams (patch sampling,
    augmentation): ``seed + index * 1_000_003``, ``index`` this process's
    rank unless given."""
    return int(seed) + (process_index() if index is None else int(index)) * 1_000_003


def _env_int(name: str) -> int:
    value = os.environ[name]
    try:
        return int(value)
    except ValueError:
        raise RuntimeError(f"{name}={value!r} is not an integer") from None


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Join the process group that ``torchrun`` describes, if any.

    Returns True when this process is in a group (also when one exists
    already), False for a plain single-process run, where none of
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` is set. A launch that sets some of them but not the
    ones a group needs raises: proceeding would run N independent trainings
    over the same run directory. On ``device="cuda"`` the process binds
    ``cuda:LOCAL_RANK`` (which must exist) and uses NCCL; on ``"cpu"`` it
    uses gloo."""
    if is_distributed():
        return True
    present = [k for k in _LAUNCH_KEYS if k in os.environ]
    if not present:
        return False
    missing = [k for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"a distributed launch was half configured: {', '.join(present)} set but "
            f"{', '.join(missing)} missing. Launch with "
            "`torchrun --nproc-per-node N -m adunet_torch.cli.<trainer> ...`, or unset "
            f"{', '.join(present)} for a single-process run.")
    world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if world < 1 or not 0 <= rank < world:
        raise RuntimeError(f"RANK={rank} is not a rank of WORLD_SIZE={world}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if "LOCAL_RANK" not in os.environ:
            raise RuntimeError("LOCAL_RANK is not set: a CUDA process cannot tell which GPU "
                               "is its own (torchrun sets it).")
        local = _env_int("LOCAL_RANK")
        count = torch.cuda.device_count()
        if not 0 <= local < count:
            raise RuntimeError(f"LOCAL_RANK={local} names no GPU of this host "
                               f"({count} visible); launch at most {count} processes a host.")
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=torch.device("cuda", local))
    elif dev.type == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world)
    else:
        raise ValueError(f"unsupported device {str(device)!r} for a process group")
    return True
