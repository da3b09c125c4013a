"""Multi-process training: launch, meshes, batch shards, channel sharding.

Port of ``adunet/parallel``: one process per GPU under ``torchrun``,
``torch.distributed`` collectives in place of the ones XLA inserts, and the
exchanges of height-sharded activations on a ``("data", "space")`` mesh
(``spatial``) in place of the halos GSPMD inserts.
"""

from adunet_torch.parallel.data_parallel import DataParallel, data_parallel, launch_mesh
from adunet_torch.parallel.distributed import (
    barrier,
    broadcast_from_main,
    is_distributed,
    is_main_process,
    maybe_initialize_distributed,
    process_count,
    process_index,
    process_seed,
    process_shard,
)
from adunet_torch.parallel.mesh import (
    auto_data_parallel_size,
    data_extent,
    data_group,
    data_index,
    make_dp_axis_mesh,
    make_dp_spatial_mesh,
    make_mesh,
    mesh_shape_for,
    pad_and_shard_ragged,
    replicate,
    shard_batch,
)
from adunet_torch.parallel.partition import (
    channel_partition_spec,
    full_tensor,
    make_dp_model_mesh,
    shard_params,
)
from adunet_torch.parallel.spatial import SpaceShard, height_split

__all__ = [
    "maybe_initialize_distributed",
    "make_mesh",
    "auto_data_parallel_size",
    "make_dp_model_mesh",
    "make_dp_axis_mesh",
    "make_dp_spatial_mesh",
    "SpaceShard",
    "height_split",
    "channel_partition_spec",
    "shard_params",
    "full_tensor",
    "shard_batch",
    "pad_and_shard_ragged",
    "replicate",
    "data_parallel",
    "DataParallel",
    "launch_mesh",
    "mesh_shape_for",
    "data_extent",
    "data_index",
    "data_group",
    "is_distributed",
    "is_main_process",
    "process_index",
    "process_count",
    "process_shard",
    "process_seed",
    "barrier",
    "broadcast_from_main",
]
