"""A toy cell for the CPU tests: the flagship's code at a size a test run
holds (depth 1, base 8, 32-px patches, training in float32), with the
cell's own traffic and limits otherwise. Nothing here is a measurement."""

from __future__ import annotations

import copy
import math

from portbench import catalog
from portbench.reference import sr_unet


def toy_config() -> dict:
    cfg = copy.deepcopy(catalog.config("sr_flagship"))
    cfg.update(name="toy", depth=1, base_channels=8, residual_head_channels=8, patch_size=32)
    cfg["train"]["batch_size"] = 8
    cfg["train"]["dtype"] = "float32"  # the CPU's bf16 convolutions differ from the card's
    cfg["serve"]["batch_size"] = 4
    cfg["params"] = sum(math.prod(s) for s in sr_unet.param_shapes(cfg).values())
    return cfg


def toy_cell(workload: str) -> dict:
    """``workload``'s cell from BENCHMARK.json at the toy size."""
    cell = catalog.cell(workload)
    cell["config"] = toy_config()
    t = cell["traffic"]
    if t["driver"] == "train":
        t.update(corpus={"images": 8, "height": 64, "width": 64}, warm_replays=1)
    else:
        t.update(clients=4, pool_tiles=8, check_every=2, check_max=8, warm_requests_per_client=1)
        if t["loop"] == "open":
            t.update(rate_per_s=8, senders=8)
    return cell
