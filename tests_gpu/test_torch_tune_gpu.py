"""The tuner's lanes on the card.

The vanilla SR U-Net at full width (base 64, depth 4, float32) and 256 px
runs K2 at ``enc0.conv1`` and ``dec0.conv1``: two launches per forward.
These tests train three configs for one epoch as one group of lanes and
each config as a group of one, from the same seeded init and batches:

- every lane's validation curve equals its single-lane run's (relative
  difference at most 1e-6; the lanes are the same operations on the same
  card, under cuDNN's deterministic algorithms as the tuner's CLI runs
  them: its default ones do not repeat a run bit for bit);
- the group launches K2 exactly twice per lane per training step and per
  validation forward, and K1 never.

Every test needs a CUDA GPU and skips without one; a kernel that does not
build fails it:

    python -m pytest tests_gpu -q
"""

import numpy as np
import pytest
import torch

from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.ops import degrade
from adunet_torch.tune import BatchedVanillaSRTuner
from adunet_torch.utils import deterministic_cudnn

pytestmark = pytest.mark.gpu

CONFIGS = [
    {"lr": 3e-3, "alpha": 1.0, "beta": 0.1, "gamma": 0.01},
    {"lr": 5e-4, "alpha": 1.7, "beta": 0.02, "gamma": 0.001},
    {"lr": 1e-3, "alpha": 0.6, "beta": 0.3, "gamma": 0.05},
]


@pytest.fixture
def runner():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(5)
    hr = rng.random((10, 256, 256, 3), dtype=np.float32)
    lr = degrade(torch.from_numpy(hr), 0.5).numpy()
    return BatchedVanillaSRTuner(lr, hr, np.arange(8), np.arange(8, 10), device="cuda")


def test_lanes_equal_single_lanes_on_the_card(runner):
    fused_norm.layer_norm_relu.launches = 0
    fused_norm.layer_norm_relu.backward_launches = 0
    conv64.conv3x3_same.launches = 0
    with deterministic_cudnn():
        curves = runner.run_group(CONFIGS, batch_size=4, epochs=1)
        torch.cuda.synchronize()
        # 8 train images at batch 4: 2 steps; 2 val images: 1 forward; per lane
        assert conv64.conv3x3_same.launches == 2 * len(CONFIGS) * (2 + 1)
        assert (fused_norm.layer_norm_relu.launches
                == fused_norm.layer_norm_relu.backward_launches == 0)
        for cfg, lane_curve in zip(CONFIGS, curves):
            single = runner.run_group([cfg], batch_size=4, epochs=1)[0]
            np.testing.assert_allclose(lane_curve, single, rtol=1e-6, atol=0)
    assert all(np.isfinite(c).all() for c in curves)
    assert len({c[0] for c in curves}) == len(CONFIGS)  # the configs train differently
