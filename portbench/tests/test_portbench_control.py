"""The controls: the reference in the next lower precision than the
configuration states, put in the program's place, must fail the cell's
limits. Training (bf16): every conv's input and weight rounded to float8
e4m3; serving (float32, TF32 off): TF32. The CPU test holds the training
control at the toy size; the card's tests (marker ``gpu``, skipped without
a card) hold both at the flagship's widths."""

from __future__ import annotations

import pytest
import torch

from portbench import catalog, check, train_cell
from portbench.lib import inputs, tiles
from portbench.tests.toy import toy_config

SEEDS = (2_147_483_801, 2_147_483_802, 2_147_483_803)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _train_control(cfg: dict, seed: int, device, corpus=(8, 64, 64)) -> bool:
    images = inputs.corpus(seed, *corpus, device)
    steps = catalog.traffic("train_cache")["checked_steps"]
    ref = train_cell.reference_readings(cfg, seed, images, steps, device)
    control = train_cell.reference_readings(cfg, seed, images, steps, device,
                                            quant=catalog.model(cfg).control_quant)
    limits = catalog.limits("sr_flagship.train")["numbers"]
    correct, _ = check.verdict(check.train_numbers(control, ref), limits)
    return correct


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_control_fails_the_train_limits_cpu(seed):
    assert not _train_control(toy_config(), seed, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_control_fails_the_train_limits(cuda, seed):
    cfg = catalog.config("sr_flagship")
    cfg["train"]["batch_size"] = 8
    assert not _train_control(cfg, seed, cuda, corpus=(16, 512, 512))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_fails_the_serve_limits(cuda, seed):
    cfg = catalog.config("sr_flagship")
    model = catalog.model(cfg)
    x = tiles.pool(seed, 8, int(cfg["patch_size"]))
    ref = model.reference_tiles(cfg, seed, x, cuda)
    tf32 = model.reference_tiles(cfg, seed, x, cuda, tf32=True)
    numbers = {"tile_gap": float(abs(tf32 - ref).max()), "missing": 0}
    for workload in ("sr_flagship.serve_bulk", "sr_flagship.serve_open"):
        correct, _ = check.verdict(numbers, catalog.limits(workload)["numbers"])
        assert not correct
