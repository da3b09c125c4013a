"""Trial lanes (``adunet_torch.tune.BatchedVanillaSRTuner``) on the CPU at a
tiny size: 32 px, base 4.

- Lanes against the port's own sequential trainer (``run_config`` of
  ``adunet_torch.cli.tune``): each lane is that trial, operation for
  operation, held to rtol 2e-4 (the reference's tolerance for its lanes).
- Lanes against the reference's vmapped lanes (``adunet.tune.
  BatchedVanillaSRTuner.run_group``) from the same converted flax init and
  the same VGG19 ``.npz``, 3 configs for 2 epochs: every curve value within
  rtol 1e-3 / atol 1e-6. The per-lane learning rate is the reference's
  ``optax.inject_hyperparams`` state there and each lane's own Adam here.
- A ``lane_width`` above the group's size gives the same curves and steps
  only the real lanes; ``on_epoch`` truncates the curves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.losses import make_perceptual_fn as jax_perceptual
from adunet.losses.perceptual import VGG19Features as JaxVGG19Features
from adunet.models import VanillaSRUNet as JaxVanillaSRUNet
from adunet.tune import BatchedVanillaSRTuner as JaxTuner
from adunet_torch.cli.tune import _sr_workload, parse_args
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.losses import make_perceptual_fn
from adunet_torch.models import VanillaSRUNet
from adunet_torch.tune import BatchedVanillaSRTuner

torch.set_num_threads(4)

SEED, IMG, N_IMAGES, BASE_CH = 42, 32, 8, 4
CONFIGS = [
    {"lr": 3e-3, "alpha": 1.0, "beta": 0.1, "gamma": 0.01},
    {"lr": 5e-4, "alpha": 1.7, "beta": 0.02, "gamma": 0.001},
    {"lr": 1e-3, "alpha": 0.6, "beta": 0.3, "gamma": 0.05},
]


@pytest.fixture(scope="module")
def sr_corpus():
    rng = np.random.default_rng(SEED)
    hr = rng.random((N_IMAGES, IMG, IMG, 3), dtype=np.float32)
    lr = np.clip(hr + rng.normal(0, 0.05, hr.shape).astype(np.float32), 0, 1)
    return lr, hr, np.arange(6), np.arange(6, 8)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    params = jax.device_get(JaxVGG19Features().init(jax.random.key(8),
                                                    jnp.zeros((1, IMG, IMG, 3)))["params"])
    path = tmp_path_factory.mktemp("vgg") / "vgg19.npz"
    np.savez(path, **{f"{name}/{leaf}": np.asarray(v) for name, layer in params.items()
                      for leaf, v in layer.items()})
    return path


class _Recorder:
    """A trial that records what a trainer reports and never prunes."""

    def __init__(self):
        self.curve = []

    def report(self, value, step):
        assert step == len(self.curve)
        self.curve.append(value)

    def should_prune(self):
        return False


def _count_forwards():
    """(counts, handle): the number of VanillaSRUNet forwards from now on."""
    counts = [0]

    def hook(module, args, output):
        if isinstance(module, VanillaSRUNet):
            counts[0] += 1

    return counts, torch.nn.modules.module.register_module_forward_hook(hook)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The CLI's SR workload over 8 HR images (LR degraded at 0.5), the
    runner of a ``--parallel-trials 5`` study (lane width 5)."""
    hr_dir = tmp_path_factory.mktemp("hr")
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        np.save(hr_dir / f"x{i}.npy", rng.random((IMG, IMG, 3)).astype(np.float32))
    args = parse_args(["--workload", "sr", "--image-size", str(IMG), "--sr-base-channels",
                       str(BASE_CH), "--high-res-dir", str(hr_dir), "--image-suffix", ".npy",
                       "--parallel-trials", "5", "--device", "cpu"])
    return _sr_workload(args, torch.device("cpu"))


def test_lanes_match_sequential_trials_and_step_only_real_lanes(workload):
    """Every lane of one group == its trial run alone by ``run_config``;
    the lane width (5) above the group (3) steps no padded lane."""
    runner = workload.parallel[1]()
    assert runner.lane_width == 5
    counts, handle = _count_forwards()
    try:
        curves = runner.run_group(CONFIGS, batch_size=4, epochs=2)
    finally:
        handle.remove()
    # 6 train images at batch 4: 2 steps an epoch; 2 val images: 1 batch
    assert counts[0] == len(CONFIGS) * 2 * (2 + 1)
    assert len(curves) == len(CONFIGS)
    for cfg, lane_curve in zip(CONFIGS, curves):
        trial = _Recorder()
        best = workload.run_config(cfg["lr"], cfg["alpha"], cfg["beta"], cfg["gamma"], 4, 2,
                                   trial=trial)
        np.testing.assert_allclose(lane_curve, trial.curve, rtol=2e-4, atol=1e-6)
        assert best == min(trial.curve)
    assert abs(curves[0][-1] - curves[1][-1]) > 1e-6  # the configs train differently


def test_lane_width_changes_nothing_and_on_epoch_truncates(sr_corpus):
    lr, hr, tr_idx, va_idx = sr_corpus
    kw = dict(base_channels=BASE_CH, seed=SEED, device="cpu")
    plain = BatchedVanillaSRTuner(lr, hr, tr_idx, va_idx, **kw)
    wide = BatchedVanillaSRTuner(lr, hr, tr_idx, va_idx, lane_width=4,
                                 perceptual_fn=plain.perceptual_fn, **kw)
    full = plain.run_group(CONFIGS[:2], batch_size=4, epochs=2)
    assert wide.run_group(CONFIGS[:2], batch_size=4, epochs=2) == full  # bit-equal

    seen = []
    stopped = plain.run_group(
        CONFIGS[:1], batch_size=4, epochs=3,
        on_epoch=lambda epoch, vals: (seen.append((epoch, list(vals))) or epoch >= 1))[0]
    assert [e for e, _ in seen] == [0, 1] and all(len(v) == 1 for _, v in seen)
    assert stopped == full[0]


def test_mesh_is_refused(sr_corpus):
    """Only a one-dim DeviceMesh spreads lanes over processes (run across
    processes in ``tests/test_torch_parallel_tune.py``); anything else is
    refused."""
    lr, hr, tr_idx, va_idx = sr_corpus
    with pytest.raises(ValueError, match="one-dim DeviceMesh"):
        BatchedVanillaSRTuner(lr, hr, tr_idx, va_idx, base_channels=BASE_CH, device="cpu",
                              mesh=object())


def test_lanes_match_the_reference_lanes(sr_corpus, vgg_npz):
    """The port's lanes against the reference's vmapped lanes, from the same
    flax init and VGG19 weights, 3 configs x 2 epochs."""
    lr, hr, tr_idx, va_idx = sr_corpus
    jax_tuner = JaxTuner(lr, hr, tr_idx, va_idx, base_channels=BASE_CH, seed=SEED,
                         perceptual_fn=jax_perceptual(vgg_npz, input_size=IMG))
    want = jax_tuner.run_group(CONFIGS, batch_size=4, epochs=2)
    # the reference's init: create_train_state's model.init at key(seed)
    variables = JaxVanillaSRUNet(base_channels=BASE_CH).init(
        jax.random.key(SEED), jnp.zeros((1, IMG, IMG, 3)), train=False)
    init = state_dict_from_flax(jax.device_get(variables["params"]),
                                jax.device_get(variables["batch_stats"]))
    tuner = BatchedVanillaSRTuner(lr, hr, tr_idx, va_idx, base_channels=BASE_CH, seed=SEED,
                                  perceptual_fn=make_perceptual_fn(vgg_npz, device="cpu"),
                                  device="cpu", init_state=init)
    got = tuner.run_group(CONFIGS, batch_size=4, epochs=2)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    worst = float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / np.abs(want)))
    print(f"worst relative difference of a curve value: {worst:.3e}")
