"""Tuner lanes spread over 2 ranks against the one-process laned study.

``tune --workload sr --parallel-trials 3`` runs once in a plain process and
once on 2 gloo ranks (``file://`` rendezvous in ``tmp_path``): lanes 0 and 2
train on rank 0, lane 1 on rank 1, each epoch's values are gathered to
every rank, and every rank drives the same study. Both processes run 2 CPU
threads, so every lane computes what the one-process lane computes: the
trial values, curves and best parameters are equal. Rank 0 alone writes the
results; the retrain runs on both ranks alike and rank 0 writes its
checkpoint.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
_LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

_WORKER = r'''
import json, sys
import torch
import torch.distributed as dist

rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from adunet_torch.cli.tune import main

payload = main(json.loads(sys.argv[5]) + ["--results", f"{out}/results_rank{rank}.json"])
with open(f"{out}/payload_rank{rank}.json", "w") as f:
    json.dump(payload, f, default=str)
dist.destroy_process_group()
'''


def _env():
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="-1",
               OMP_NUM_THREADS="2")
    return env


def _run(cmds, timeout=300):
    procs = [subprocess.Popen(c, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, start_new_session=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]


def test_lanes_over_two_ranks_equal_one_process_study(tmp_path):
    hr = tmp_path / "hr"
    hr.mkdir()
    rng = np.random.default_rng(4)
    for i in range(10):
        coarse = rng.random((8, 8, 3), dtype=np.float32)
        np.save(hr / f"im{i:02d}.npy", np.repeat(np.repeat(coarse, 4, 0), 4, 1))
    args = ["--device", "cpu", "--workload", "sr", "--n-trials", "3", "--parallel-trials", "3",
            "--epochs", "2", "--image-size", "32", "--sr-base-channels", "4", "--high-res-dir",
            str(hr), "--image-suffix", ".npy", "--seed", "3"]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    retrain = ["--retrain", "--final-epochs", "1", "--model-dir", str(tmp_path / "models")]
    _run([[sys.executable, "-m", "adunet_torch.cli.tune", *args, "--results",
           str(tmp_path / "one.json")]]
         + [[sys.executable, str(script), str(r), "2", str(tmp_path / "rdv"), str(tmp_path),
             json.dumps(args + retrain)] for r in range(2)])
    one = json.loads((tmp_path / "one.json").read_text())
    two = json.loads((tmp_path / "results_rank0.json").read_text())
    assert not (tmp_path / "results_rank1.json").exists()  # rank 0 writes the study
    assert len(one["trials"]) == len(two["trials"]) == 3
    for a, b in zip(one["trials"], two["trials"]):
        assert a["params"] == b["params"]
        assert a["value"] == b["value"]
        assert a["intermediate"] == b["intermediate"]
    assert one["best_params"] == two["best_params"]
    # every rank holds the same study, and the retrain ran on both alike
    p0, p1 = (json.loads((tmp_path / f"payload_rank{r}.json").read_text()) for r in range(2))
    assert p0 == p1 and p0["retrain"]["final_val_loss"] > 0
    ckpt = Path(p0["retrain"]["checkpoint"])
    assert (ckpt / "config.json").exists() and (ckpt / "1" / "state.pt").exists()
