"""Data-parallel training on the card.

- An NCCL group of one process (``FileStore`` rendezvous): one bf16 step of
  the flagship (scale 0.5, depth 3, batch 32 x 256 px) through
  ``DistributedDataParallel`` equals the unwrapped step bit for bit (at
  world 1 the bucketed all-reduce averages over one process), under cuDNN's
  deterministic algorithms, and launches K1 / K1 backward / K2 16 / 16 / 4
  times, as the unwrapped step does.
- Two processes on the one card in a gloo group: ``chip_smoke.ddp_ranks``
  holds a float32 flagship step, a float32 protocol seg step (BatchNorm on
  the global batch) and a ``--model_shards 2`` step to one process on the
  same global batch (its docstring gives the tolerances).

Every test needs a CUDA GPU and skips without one:

    python -m pytest tests_gpu -q
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytestmark = pytest.mark.gpu


@pytest.fixture
def nccl_world_of_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _flagship(seed_head: int):
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import create_train_state, make_optimizer

    model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=torch.bfloat16,
                                           device="cuda", seed=0)
    with torch.no_grad():  # off the identity start: every parameter gets a gradient
        model.residual_rgb.weight.normal_(
            0.0, 0.01, generator=torch.Generator("cuda").manual_seed(seed_head))
    return model, create_train_state(model, make_optimizer(model.parameters(), 1e-4))


def test_ddp_world_one_step_equals_the_unwrapped_step(nccl_world_of_one):
    from adunet_torch.kernels import conv64, fused_norm
    from adunet_torch.losses import charbonnier_loss
    from adunet_torch.parallel import data_parallel, make_mesh
    from adunet_torch.train import make_sr_train_step
    from adunet_torch.utils import deterministic_cudnn, setup_runtime

    setup_runtime()
    hr = np.random.default_rng(5).integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    out = {}
    with deterministic_cudnn():
        for name in ("plain", "ddp"):
            model, state = _flagship(seed_head=1)
            if name == "ddp":
                state = data_parallel(state, make_mesh())
                assert isinstance(state.train_module, torch.nn.parallel.DistributedDataParallel)
            fused_norm.layer_norm_relu.launches = fused_norm.layer_norm_relu.backward_launches = 0
            conv64.conv3x3_same.launches = 0
            _, metrics = make_sr_train_step(model, charbonnier_loss)(state, hr)
            torch.cuda.synchronize()
            out[name] = {"loss": float(metrics["loss"]),
                         "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                         "launches": (fused_norm.layer_norm_relu.launches,
                                      fused_norm.layer_norm_relu.backward_launches,
                                      conv64.conv3x3_same.launches)}
    assert out["ddp"]["launches"] == out["plain"]["launches"] == (16, 16, 4)
    assert out["ddp"]["loss"] == out["plain"]["loss"]
    for n, p in out["plain"]["params"].items():
        assert torch.equal(out["ddp"]["params"][n], p), n


def test_two_ranks_on_one_card_match_one_process(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import chip_smoke
    from adunet_torch.utils import setup_runtime

    setup_runtime()
    out = chip_smoke.ddp_ranks(tmp_path)  # raises past its tolerances
    assert out["sr"]["params_rel_l2"] <= 1e-5 and out["shards"]["params_rel_l2"] <= 1e-5
    assert out["seg"]["per_rank_stats_rel_l2"] > 1e-3
