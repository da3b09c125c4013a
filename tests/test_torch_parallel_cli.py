"""Every trainer, the evaluator and ``--model_shards`` under a 2-rank launch.

One ``torchrun --standalone --nproc-per-node 2`` launch runs ``train_sr``
on the CPU through the real launch contract (``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` from torchrun, gloo). One more 2-rank
launch (gloo, ``file://`` rendezvous in ``tmp_path``) runs, in turn,
``train_sr --model_shards 2``, ``evaluate`` on its checkpoint,
``train_sr_vanilla``, ``train_seg`` (precise-BN), ``train_seg_vanilla`` and
``train_joint``; rank 1 records every file it opens for writing under the
run and model directories, and must have opened none (process 0 writes the
artifacts). Both ranks run the same number of epochs and updates and report
the same numbers; the checkpoints load in one process; the sharded
evaluation equals one process's (rtol 1e-5, float32 forwards on other
batch splits).
"""

import csv
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
_LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

_WORKER = r'''
import builtins, importlib, io, json, sys
import torch
import torch.distributed as dist

rank, world, rdv, spec, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(2)
jobs = json.loads(open(spec).read())
writes = []
real_open = builtins.open
if rank != 0:  # record what this rank opens for writing under the outputs
    roots = tuple(r for job in jobs for r in job["roots"])

    def watched(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and str(file).startswith(roots):
            writes.append(str(file))
        return real_open(file, mode, *args, **kwargs)

    builtins.open = io.open = watched
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
results = {}
for job in jobs:
    got = importlib.import_module(job["module"]).main(job["argv"])
    keep = {}
    for k, v in got.items():
        if k == "state":
            keep["updates"] = v.step
        elif k == "summary":
            keep["summary"] = v.__dict__
        elif k != "per_patch":
            try:
                keep[k] = json.loads(json.dumps(v))
            except TypeError:
                pass
    results[job["name"]] = keep
dist.destroy_process_group()
builtins.open = io.open = real_open
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump({"results": results, "writes": writes}, f)
'''


def _env():
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="-1",
               OMP_NUM_THREADS="2")
    return env


def _communicate(procs, timeout):
    """Wait for every process; kill every process group if one is late."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()


def run_ranks(tmp: Path, world: int, args, timeout: float = 400):
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                               str(tmp / "rendezvous"), *map(str, args)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for r in range(world)]
    outs = _communicate(procs, timeout)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    return outs


def _write_sr(root: Path, n: int, size: int, seed: int) -> None:
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        coarse = rng.random((size // 4, size // 4, 3), dtype=np.float32)
        np.save(root / f"im{i:03d}.npy", np.repeat(np.repeat(coarse, 4, 0), 4, 1))


def _write_seg(root: Path, mask_suffix: str) -> None:
    rng = np.random.default_rng(2)
    for split, n in (("train", 8), ("val", 5)):
        (root / f"{split}_img").mkdir(parents=True)
        (root / f"{split}_mask").mkdir(parents=True)
        for i in range(n):
            np.save(root / f"{split}_img" / f"ISIC_{split}{i:03d}.npy",
                    rng.random((32, 32, 3), dtype=np.float32))
            m = np.zeros((32, 32), np.float32)
            m[6 + i : 22, 8:26 - i] = 1.0
            np.save(root / f"{split}_mask" / f"ISIC_{split}{i:03d}{mask_suffix}", m)


def _sr_args(hr: Path, out: Path, *extra):
    return ["--device", "cpu", "--scale", "0.5", "--patch_size", "32", "--patches_per_image", "2",
            "--batch_size", "4", "--epochs", "2", "--shuffle_buffer", "8", "--high_res_dir",
            str(hr), "--image_suffix", ".npy", "--model_dir", str(out / "models"), "--log_dir",
            str(out / "logs"), "--run_name", "r", "--seed", "5", *extra]


def _untimed(tree):
    """A result without its wall-clock entries (each rank times itself)."""
    if isinstance(tree, dict):
        return {k: _untimed(v) for k, v in tree.items() if k not in ("duration_s", "ms_per_step")}
    return tree


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The file:// 2-rank launch of every entry point."""
    tmp = tmp_path_factory.mktemp("parallel_cli")
    _write_sr(tmp / "hr", 12, 32, seed=1)
    _write_sr(tmp / "lr", 12, 32, seed=1)  # same names, so the vanilla pairs line up
    _write_seg(tmp / "isic", "_segmentation.npy")
    isic = tmp / "isic"
    seg_dirs = [str(isic / d) for d in ("train_img", "train_mask", "val_img", "val_mask")]
    o = {k: tmp / k for k in ("shards", "eval", "vsr", "seg", "vseg", "joint")}
    jobs = [
        ("shards", "adunet_torch.cli.train_sr",
         _sr_args(tmp / "hr", o["shards"], "--base_channels", "64", "--residual_head_channels",
                  "8", "--depth_override", "2", "--model_shards", "2", "--n_devices", "2")),
        ("eval", "adunet_torch.cli.evaluate",
         ["--device", "cpu", "--model-path",
          str(o["shards"] / "models" / "unet_adaptive_scale0.50_depth2"), "--scale", "0.5",
          "--hr-dir", str(tmp / "hr"), "--image-suffix", ".npy", "--patch-size", "32",
          "--batch-size", "5", "--output-dir", str(o["eval"]), "--run-name", "e"]),
        ("vsr", "adunet_torch.cli.train_sr_vanilla",
         ["--device", "cpu", "--high_res_dir", str(tmp / "hr"), "--low_res_dir", str(tmp / "lr"),
          "--hr_size", "32", "--batch_size", "2", "--epochs", "2", "--base_channels", "4",
          "--loss", "charbonnier", "--model_dir", str(o["vsr"] / "models"), "--log_dir",
          str(o["vsr"] / "logs"), "--run_name", "v"]),
        ("seg", "adunet_torch.cli.train_seg",
         ["--device", "cpu", "--protocol", "A", "--epochs", "2", "--batch_size", "2",
          "--base_channels", "8", "--depth", "2", "--image_size", "32", "--precise_bn", "1",
          "--train_images", seg_dirs[0], "--train_masks", seg_dirs[1], "--val_images",
          seg_dirs[2], "--val_masks", seg_dirs[3], "--model_dir", str(o["seg"] / "models"),
          "--log_dir", str(o["seg"] / "logs"), "--run_name", "p"]),
        ("vseg", "adunet_torch.cli.train_seg_vanilla",
         ["--device", "cpu", "--train_image_dir", seg_dirs[0], "--train_mask_dir", seg_dirs[1],
          "--val_image_dir", seg_dirs[2], "--val_mask_dir", seg_dirs[3], "--image_suffix",
          ".npy", "--mask_suffix", "_segmentation.npy", "--image_size", "32", "--batch_size",
          "2", "--epochs", "2", "--base_channels", "4", "--depth", "2", "--augment",
          "--model_dir", str(o["vseg"] / "models"), "--log_dir", str(o["vseg"] / "logs"),
          "--run_name", "vs"]),
        ("joint", "adunet_torch.cli.train_joint",
         ["--device", "cpu", "--train_image_dir", seg_dirs[0], "--train_mask_dir", seg_dirs[1],
          "--val_image_dir", seg_dirs[2], "--val_mask_dir", seg_dirs[3], "--image_suffix",
          ".npy", "--mask_suffix", "_segmentation.npy", "--image_size", "32",
          "--depth_override", "2", "--base_channels", "8", "--residual_head_channels", "8",
          "--batch_size", "2", "--epochs", "2", "--model_dir", str(o["joint"] / "models"),
          "--log_dir", str(o["joint"] / "logs"), "--run_name", "j"]),
    ]
    spec = [{"name": n, "module": m, "argv": a, "roots": [str(o[n])]} for n, m, a in jobs]
    (tmp / "spec.json").write_text(json.dumps(spec))
    outs = run_ranks(tmp, 2, [tmp / "spec.json", tmp])
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return {"tmp": tmp, "out": o, "ranks": ranks, "logs": outs}


def test_rank_one_writes_no_artifact(launched):
    assert launched["ranks"][1]["writes"] == []


@pytest.mark.parametrize("job", ["shards", "vsr", "seg", "vseg", "joint"])
def test_trainers_run_in_lockstep_on_two_ranks(launched, job):
    """Both ranks train the same epochs and updates and end on the same
    numbers (the metrics are the global batch's)."""
    r0, r1 = (_untimed(r["results"][job]) for r in launched["ranks"])
    assert r0 == r1
    assert r0["updates"] > 0
    epochs = r0.get("history_epochs", r0.get("epochs_ran"))
    assert epochs == 2


def test_model_shards_run_writes_a_loadable_checkpoint(launched):
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

    run = launched["out"]["shards"]
    cfg = json.loads((run / "logs" / "r" / "config.json").read_text())
    assert (cfg["n_devices"], cfg["model_shards"]) == (2, 2)
    rows = (run / "logs" / "r" / "epoch_metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 3  # header + 2 epochs, written once
    model, _ = build_super_resolution_unet(0.5, base_channels=64, residual_head_channels=8,
                                           depth_override=2, device="cpu", seed=0)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    ckpt = CheckpointManager(run / "models" / "unet_adaptive_scale0.50_depth2")
    assert ckpt.restore_latest(state) is not None
    assert state.step == launched["ranks"][0]["results"]["shards"]["updates"]
    assert all(len(s) == 3 for s in state.optimizer.state.values())
    with torch.no_grad():
        assert bool(torch.isfinite(model(torch.rand(1, 32, 32, 3))).all())


def test_sharded_evaluate_matches_one_process(launched, tmp_path):
    from adunet_torch.cli.evaluate import main

    out = launched["out"]["eval"]
    want = main(["--device", "cpu", "--model-path",
                 str(launched["out"]["shards"] / "models" / "unet_adaptive_scale0.50_depth2"),
                 "--scale", "0.5", "--hr-dir", str(launched["tmp"] / "hr"), "--image-suffix",
                 ".npy", "--patch-size", "32", "--batch-size", "5", "--output-dir",
                 str(tmp_path), "--run-name", "one"])
    got = json.loads((out / "e" / "metrics.json").read_text())
    assert got["samples"] == want["summary"].samples == 12  # batches of 5, 5, 2
    for k, v in want["summary"].__dict__.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    with open(out / "e" / "per_image_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["filename"] for r in rows] == [r["filename"] for r in want["per_patch"]]
    np.testing.assert_allclose([float(r["psnr_y"]) for r in rows],
                               [r["psnr_y"] for r in want["per_patch"]], rtol=1e-5)


def test_seg_trainers_write_their_artifacts_once(launched):
    o = launched["out"]
    cfg = json.loads((o["seg"] / "logs" / "p" / "config.json").read_text())
    assert cfg["n_devices"] == 2 and cfg["train_steps_per_epoch"] == 2  # 4 pairs a rank, batch 2
    assert len(list((o["vseg"] / "logs").glob("vs_*"))) == 1
    joint = json.loads(next((o["joint"] / "logs").glob("j_*/config.json")).read_text())
    assert joint["n_devices"] == 2
    assert (o["vsr"] / "logs" / "v" / "config.json").exists()


def test_torchrun_launch_of_train_sr(tmp_path):
    """The real launcher: torchrun sets the environment, each rank joins
    gloo, trains its own shard from the device cache and validates its share;
    process 0 writes the run, and the checkpoint loads in one process."""
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

    _write_sr(tmp_path / "hr", 10, 48, seed=3)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "adunet_torch.cli.train_sr",
           *_sr_args(tmp_path / "hr", tmp_path, "--depth_override", "1", "--base_channels", "8",
                     "--residual_head_channels", "8", "--device_cache", "--n_devices", "2")]
    proc = subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    out = _communicate([proc], 300)[0]
    assert proc.returncode == 0, out[-6000:]
    assert out.count("processes=2") == 2  # both ranks joined one group of 2
    cfg = json.loads((tmp_path / "logs" / "r" / "config.json").read_text())
    # 8 training images: 4 a rank x 2 patches at batch 4 -> 2 steps an epoch
    assert (cfg["n_devices"], cfg["train_images"], cfg["steps_per_epoch"]) == (2, 4, 2)
    rows = (tmp_path / "logs" / "r" / "epoch_metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 3
    model, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                           depth_override=1, device="cpu", seed=0)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    CheckpointManager(tmp_path / "models" / "unet_adaptive_scale0.50_depth1").restore_latest(state)
    assert state.step == 4
