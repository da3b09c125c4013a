"""The model module of the adaptive SR U-Net (``models/adaptive_sr_unet.py``)
gives what the drivers took before from the reference directly: the same
parameter shapes in the same order, bit-identical seeded weights, the same
conv and LayerNorm lists."""

from __future__ import annotations

import hashlib
import math

import pytest

from portbench import catalog
from portbench.lib import inputs
from portbench.reference import sr_unet
from portbench.tests.toy import toy_config

SEED = 2_147_483_713
# sha256 over (name, float32 bytes) of every leaf of ``inputs.weights(cfg,
# SEED, "cpu")``, as the harness drew them from ``sr_unet.param_shapes``
WEIGHTS_SHA256 = {
    "sr_flagship": "24661866d3c1eb750b1e70cd74f08bfb0c0f1fc5041dcbb18425df578de810de",
    "toy": "ed57d052c271638dafa103a1c0b92024662bf600492e36d110ce4187b7f39422",
}


def _digest(weights) -> str:
    h = hashlib.sha256()
    for name, leaf in weights.items():
        h.update(name.encode())
        h.update(leaf.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, params, leaves", [("sr_flagship", 8_637_379, 72),
                                                  ("sr_deep", 138_427_843, 108)])
def test_sr_module_gives_the_reference_shapes(name, params, leaves):
    cfg = catalog.config(name)
    model = catalog.model(cfg)
    assert cfg["model"] == "adaptive_sr_unet" and model.__name__.endswith(".adaptive_sr_unet")
    shapes = model.param_shapes(cfg)
    assert list(shapes.items()) == list(sr_unet.param_shapes(cfg).items())
    assert len(shapes) == leaves and sum(math.prod(s) for s in shapes.values()) == params
    for batch in (1, 8, cfg["train"]["batch_size"]):
        assert model.conv_layers(cfg, batch, 256) == sr_unet.conv_layers(cfg, batch, 256)
        assert model.norm_layers(cfg, batch, 256) == sr_unet.norm_layers(cfg, batch, 256)


@pytest.mark.parametrize("cfg", [catalog.config("sr_flagship"), toy_config()],
                         ids=["sr_flagship", "toy"])
def test_seeded_weights_are_bit_identical(cfg):
    assert _digest(inputs.weights(cfg, SEED, "cpu")) == WEIGHTS_SHA256[cfg["name"]]
