"""``adunet_torch.cli.tune`` on the CPU (``--device cpu``) at a tiny size,
against the reference CLI ``adunet.cli.tune``.

- SR sequential with ``--retrain``, SR with ``--parallel-trials 2`` and seg
  sequential with ``--retrain`` run through the port's ``main``. Their
  results JSON (top level, each trial, the retrain entry) and the retrain's
  ``config.json`` have the reference CLI's keys, and their trials the
  reference's parameters: the first trials of a TPE study are its random
  start-up draws, which depend on the seed and the trial's number only. One
  reference SR run (laned, with ``--retrain``) stands for both SR modes: its
  payload is ``results_payload()`` either way, and a sequential study's
  first asks draw what a batched ask draws.
- Seg with ``--parallel-trials 2`` raises the reference's ``ValueError``.
- The seg trainer (``run_config``) without augmentation, from the flax init
  converted, gives the reference's per-epoch validation Dice within rtol
  5e-3 / atol 5e-4 (the seg Adam-step tests' tolerance: float32 BatchNorm
  training in another summation order).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.cli import tune as ref_cli
from adunet.models import build_adaptive_depth_unet as jax_seg_unet
from adunet_torch.cli import tune as port_cli
from adunet_torch.convert import state_dict_from_flax

torch.set_num_threads(4)

SEED = 42


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tune_data")
    rng = np.random.default_rng(0)
    (root / "hr").mkdir()
    for i in range(4):
        np.save(root / "hr" / f"x{i}.npy", rng.random((48, 48, 3)).astype(np.float32))
    for sub in ("ti", "tm", "vi", "vm"):
        (root / sub).mkdir()
    for i in range(4):
        img = rng.random((32, 32, 3), dtype=np.float32)
        mask = (rng.random((32, 32)) > 0.5).astype(np.float32)
        np.save(root / "ti" / f"a{i}.npy", img)
        np.save(root / "tm" / f"a{i}_segmentation.npy", mask)
        np.save(root / "vi" / f"b{i}.npy", img)
        np.save(root / "vm" / f"b{i}_segmentation.npy", mask)
    return root


def _sr_args(data, out, *extra):
    return ["--workload", "sr", "--n-trials", "2", "--epochs", "1", "--image-size", "32",
            "--sr-base-channels", "4", "--high-res-dir", str(data / "hr"), "--image-suffix",
            ".npy", "--results", str(out / "results.json"), "--model-dir", str(out / "models"),
            "--seed", str(SEED), *extra]


def _seg_args(data, out, *extra):
    return ["--workload", "seg", "--n-trials", "2", "--epochs", "1", "--image-size", "32",
            "--base-channels", "4", "--train-images", str(data / "ti"), "--train-masks",
            str(data / "tm"), "--val-images", str(data / "vi"), "--val-masks", str(data / "vm"),
            "--results", str(out / "results.json"), "--model-dir", str(out / "models"),
            "--seed", str(SEED), *extra]


def _run(main, argv, out):
    main(argv)
    return json.loads((out / "results.json").read_text())


def _keys(payload):
    """The payload's key sets: top level, each trial, the retrain entry."""
    return (sorted(payload), [sorted(t) for t in payload["trials"]],
            sorted(payload.get("retrain", {})))


@pytest.fixture(scope="module")
def ref_sr(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_sr")
    return out, _run(ref_cli.main, _sr_args(data, out, "--parallel-trials", "2", "--retrain",
                                            "--final-epochs", "1"), out)


@pytest.mark.parametrize("mode", ["sequential", "laned"])
def test_sr_cli_matches_the_reference(mode, data, ref_sr, tmp_path):
    ref_out, want = ref_sr
    extra = (["--retrain", "--final-epochs", "1"] if mode == "sequential"
             else ["--parallel-trials", "2"])
    got = _run(port_cli.main, _sr_args(data, tmp_path, *extra, "--device", "cpu"), tmp_path)
    got_keys, want_keys = _keys(got), _keys(want)
    assert got_keys[0] == [k for k in want_keys[0] if mode == "sequential" or k != "retrain"]
    assert got_keys[1] == want_keys[1]
    assert [t["params"] for t in got["trials"]] == [t["params"] for t in want["trials"]]
    assert [t["state"] for t in got["trials"]] == ["COMPLETE"] * 2
    assert all(len(t["intermediate"]) == 1 for t in got["trials"])
    assert got["best_value"] == min(t["value"] for t in got["trials"])
    if mode == "sequential":
        assert got_keys[2] == want_keys[2] == ["checkpoint", "final_val_loss"]
        ckpt = tmp_path / "models" / "unet_vanilla_tuned_best"
        config = json.loads((ckpt / "config.json").read_text())
        ref_config = json.loads((ref_out / "models" / "unet_vanilla_tuned_best" /
                                 "config.json").read_text())
        assert sorted(config) == sorted(ref_config)
        assert config["workload"] == "sr" and config["final_epochs"] == 1
        assert (ckpt / "1" / "state.pt").exists()


def test_seg_cli_matches_the_reference(data, tmp_path_factory):
    outs = {name: tmp_path_factory.mktemp(f"{name}_seg") for name in ("ref", "port")}
    want = _run(ref_cli.main, _seg_args(data, outs["ref"], "--retrain", "--final-epochs", "1"),
                outs["ref"])
    got = _run(port_cli.main, _seg_args(data, outs["port"], "--retrain", "--final-epochs", "1",
                                        "--device", "cpu"), outs["port"])
    assert _keys(got) == _keys(want)
    assert [t["params"] for t in got["trials"]] == [t["params"] for t in want["trials"]]
    configs = [json.loads((outs[n] / "models" / "unet_seg_tuned_best" / "config.json")
                          .read_text()) for n in ("ref", "port")]
    assert sorted(configs[1]) == sorted(configs[0])
    assert configs[1]["workload"] == "seg"
    assert got["retrain"]["final_val_dice"] >= 0.0


def test_seg_parallel_trials_raise(data, tmp_path):
    with pytest.raises(ValueError, match="parallel-trials"):
        port_cli.main(_seg_args(data, tmp_path, "--parallel-trials", "2", "--device", "cpu"))


class _FixedTrial:
    """Suggests fixed values and records the reported curve."""

    def __init__(self, lr, depth, batch_size):
        self.values = {"depth": depth, "batch_size": batch_size, "augment": False}
        self.lr, self.curve = lr, []

    def suggest_float(self, name, low, high, log=False):
        return self.lr

    def suggest_int(self, name, low, high, step=1):
        return self.values[name]

    def suggest_categorical(self, name, choices):
        return self.values[name]

    def report(self, value, step):
        self.curve.append(value)

    def should_prune(self):
        return False


def test_seg_run_config_matches_the_reference_dice_curve(data, tmp_path):
    # the seg CLI study's first trial (seed 42), whose programs the reference
    # has compiled by now when the tests run in order
    lr, depth, batch, epochs = 0.0014212411569893833, 5, 16, 2
    argv = _seg_args(data, tmp_path, "--epochs", str(epochs))
    ref_trial = _FixedTrial(lr, depth, batch)
    ref_cli._seg_objective_factory(ref_cli.parse_args(argv))[0](ref_trial)

    variables = jax_seg_unet(32, 4, depth).init(jax.random.key(SEED), jnp.zeros((1, 32, 32, 3)),
                                                train=False)
    init = state_dict_from_flax(jax.device_get(variables["params"]),
                                jax.device_get(variables["batch_stats"]))
    args = port_cli.parse_args(argv + ["--device", "cpu"])
    workload = port_cli._seg_workload(args, torch.device("cpu"))
    trial = _FixedTrial(lr, depth, batch)
    best = workload.run_config(lr, 4, depth, batch, False, epochs, trial=trial, init_state=init)
    assert len(trial.curve) == len(ref_trial.curve) == epochs
    np.testing.assert_allclose(trial.curve, ref_trial.curve, rtol=5e-3, atol=5e-4)
    assert best == max(trial.curve)
