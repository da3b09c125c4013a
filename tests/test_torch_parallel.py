"""The port's launch contract, data shards and sharding rules against the
reference's (``adunet/parallel``), in one process.

``process_shard`` / ``process_seed`` are held to the reference's functions
with ``jax.process_count`` / ``jax.process_index`` monkeypatched to each
rank of 2, 3 and 4 processes; ``auto_data_parallel_size`` to the
reference's table (``tests/test_mesh_autocap.py``); ``channel_partition_spec``
to the reference's rules on the same leaves in both layouts;
``pad_and_shard_ragged`` / ``shard_batch`` to the reference's sharded arrays
on the 8-device CPU mesh (every rank's rows together). The multi-process
runs are in ``tests/test_torch_parallel_{steps,cli}.py``.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

import adunet.parallel.distributed as jdist
from adunet.parallel import auto_data_parallel_size as jax_auto
from adunet.parallel import channel_partition_spec as jax_spec
from adunet.parallel import make_mesh as jax_make_mesh
from adunet.parallel.mesh import pad_and_shard_ragged as jax_pad_and_shard
from adunet.parallel.mesh import shard_batch as jax_shard_batch
from adunet_torch.parallel import (
    auto_data_parallel_size,
    channel_partition_spec,
    maybe_initialize_distributed,
    mesh_shape_for,
    pad_and_shard_ragged,
    process_seed,
    process_shard,
    shard_batch,
)

_LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launch_env(monkeypatch):
    for key in _LAUNCH:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("length", [0, 1, 5, 8, 12, 13])
@pytest.mark.parametrize("seed", [None, 11])
def test_process_shard_and_seed_match_reference(monkeypatch, n, length, seed):
    seq = [f"img{i:03d}.png" for i in range(length)]
    monkeypatch.setattr(jax, "process_count", lambda: n)
    shards = []
    for pid in range(n):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        want = jdist.process_shard(seq, seed=seed)
        got = process_shard(seq, seed=seed, index=pid, count=n)
        assert got == want
        assert process_seed(1234, index=pid) == jdist.process_seed(1234)
        shards.append(got)
    if length:  # equal lengths, and every item in some shard
        assert len({len(s) for s in shards}) == 1
        assert set(seq) <= {x for s in shards for x in s}


def test_process_shard_and_seed_in_one_process():
    seq = list(range(7))
    assert process_shard(seq, seed=3) is seq
    assert process_seed(42) == 42


@pytest.mark.parametrize("batch, avail", [(1, 8), (2, 8), (3, 8), (4, 8), (6, 8), (8, 8),
                                          (12, 8), (16, 8), (5, 8), (7, 8), (9, 8), (11, 8),
                                          (32, 1), (32, 2), (6, 4)])
def test_auto_data_parallel_size_matches_reference(batch, avail):
    assert auto_data_parallel_size(batch, avail) == jax_auto(batch, avail)


def test_auto_data_parallel_size_policy():
    # the reference's grad-accum cases; one process drives one GPU: 1 here
    for batch, accum in ((8, 2), (16, 2), (4, 4)):
        assert auto_data_parallel_size(batch, 8, accum) == jax_auto(batch, 8, micro_factor=accum)
    assert auto_data_parallel_size(32) == 1
    for bad in ((6, 8, 4), (0, 8, 1)):
        with pytest.raises(ValueError):
            auto_data_parallel_size(*bad)


@pytest.mark.parametrize("flax_shape, model, min_c", [
    ((3, 3, 128, 256), 2, 256), ((3, 3, 64, 64), 2, 256), ((3, 3, 128, 255), 2, 128),
    ((3, 3, 256, 512), 4, 256), ((1, 1, 64, 3), 2, 256), ((256,), 2, 256), ((64,), 2, 256),
    ((), 2, 256), ((3, 3, 512, 1024), 3, 256),
])
def test_channel_partition_spec_matches_reference(flax_shape, model, min_c):
    """The same leaf in both layouts: flax (kh, kw, ci, co) shards dim -1, the
    port's (co, ci, kh, kw) dim 0; a 1-D leaf dim 0 in both."""
    want = jax_spec(flax_shape, model, min_c)
    if len(flax_shape) == 4:
        kh, kw, ci, co = flax_shape
        shape = (co, ci, kh, kw)
    else:
        shape = flax_shape
    got = channel_partition_spec(shape, model, min_c)
    assert (got == 0) == (want != P()), (flax_shape, got, want)
    assert got in (0, None)


def test_plain_process_is_not_distributed(no_launch_env):
    assert maybe_initialize_distributed("cpu") is False
    assert mesh_shape_for(None, 1) == (1, 1)
    assert mesh_shape_for(1, 1) == (1, 1)


@pytest.mark.parametrize("env, match", [
    ({"MASTER_ADDR": "localhost"}, "half configured"),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}, "RANK"),
    ({"RANK": "0", "WORLD_SIZE": "2"}, "MASTER_ADDR"),
    ({"RANK": "2", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"},
     "not a rank"),
    ({"RANK": "x", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"},
     "not an integer"),
])
def test_misconfigured_launch_raises(no_launch_env, env, match):
    for k, v in env.items():
        no_launch_env.setenv(k, v)
    with pytest.raises(RuntimeError, match=match):
        maybe_initialize_distributed("cpu")


@pytest.mark.parametrize("env", [{}, {"LOCAL_RANK": "3"}])
def test_cuda_launch_needs_its_gpu(no_launch_env, env):
    """A CUDA rank binds cuda:LOCAL_RANK; no such GPU (none here) raises."""
    base = {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}
    for k, v in {**base, **env}.items():
        no_launch_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        maybe_initialize_distributed("cuda")


@pytest.mark.parametrize("n_devices, shards, want", [(2, 1, 2), (4, 1, 4), (None, 2, 2),
                                                     (4, 2, 4)])
def test_single_process_multi_device_request_names_torchrun(n_devices, shards, want):
    argv = ["--scale", "0.5", "--n_devices", str(n_devices)]
    with pytest.raises(ValueError) as err:
        mesh_shape_for(n_devices, shards, command=("adunet_torch.cli.train_sr", argv))
    line = f"torchrun --nproc-per-node {want} -m adunet_torch.cli.train_sr " + " ".join(argv)
    assert line in str(err.value)


@pytest.mark.parametrize("module", ["train_sr", "train_sr_vanilla", "train_seg",
                                    "train_seg_vanilla", "train_joint"])
def test_trainers_refuse_n_devices_in_one_process(module, tmp_path, no_launch_env):
    """Every trainer holds --n_devices to the launch before it reads data."""
    import importlib

    flags = {
        "train_sr": ["--scale", "0.5", "--high_res_dir", str(tmp_path)],
        "train_sr_vanilla": ["--high_res_dir", str(tmp_path), "--low_res_dir", str(tmp_path)],
        "train_seg": ["--protocol", "A", "--train_images", str(tmp_path), "--train_masks",
                      str(tmp_path), "--val_images", str(tmp_path), "--val_masks", str(tmp_path)],
        "train_seg_vanilla": ["--train_image_dir", str(tmp_path), "--train_mask_dir",
                              str(tmp_path), "--val_image_dir", str(tmp_path), "--val_mask_dir",
                              str(tmp_path)],
        "train_joint": ["--train_image_dir", str(tmp_path), "--train_mask_dir", str(tmp_path)],
    }[module]
    argv = flags + ["--device", "cpu", "--n_devices", "2"]
    main = importlib.import_module(f"adunet_torch.cli.{module}").main
    with pytest.raises(ValueError, match=f"torchrun --nproc-per-node 2 -m adunet_torch.cli.{module} "):
        main(argv)


class _Mesh:
    """A one-dim stand-in for a DeviceMesh: this process at ``index`` of ``n``."""

    mesh_dim_names = ("data",)

    def __init__(self, n, index):
        self.n, self.index = n, index

    def size(self, dim=0):
        return self.n

    def get_local_rank(self, axis):
        return self.index


@pytest.mark.parametrize("rows, n", [(5, 2), (7, 4), (8, 4), (1, 2), (3, 8)])
def test_pad_and_shard_ragged_matches_reference(rows, n):
    rng = np.random.default_rng(rows)
    batch = (rng.random((rows, 4, 4, 3), dtype=np.float32),
             rng.random((rows, 4, 4, 1), dtype=np.float32))
    want, want_mask, want_n = jax_pad_and_shard(batch, jax_make_mesh(n))
    parts = [pad_and_shard_ragged(batch, _Mesh(n, i)) for i in range(n)]
    assert all(p[2] == want_n == rows for p in parts)
    for leaf in range(2):
        np.testing.assert_array_equal(np.concatenate([p[0][leaf] for p in parts]),
                                      np.asarray(want[leaf]))
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts]).numpy(),
                                  np.asarray(want_mask))
    as_tensor = pad_and_shard_ragged(torch.from_numpy(batch[0]), _Mesh(n, n - 1))
    np.testing.assert_array_equal(as_tensor[0].numpy(), parts[-1][0][0])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_batch_matches_reference(n):
    batch = np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3)
    want = np.asarray(jax_shard_batch(batch, jax_make_mesh(n)))
    got = np.concatenate([shard_batch(batch, _Mesh(n, i)) for i in range(n)])
    np.testing.assert_array_equal(got, want)
    if n > 1:  # a global batch must split evenly (pad_and_shard_ragged pads)
        with pytest.raises(ValueError, match="does not split"):
            shard_batch(batch[:7], _Mesh(n, 0))
