"""The trained flagship, served by the port, against the JAX reference.

``experiments/round3_flagship/export_int8`` holds the trained flagship SR
U-Net (scale 0.5, depth 3, 8,637,379 params) as an int8 weight-only
artifact. The first 8 tiles of the seed-777 eval corpus
(``scripts/make_synth_corpus.py``, regenerated as
``tests/test_golden_eval.py:140-150`` does) are degraded once and the same
LR goes through JAX's ``load_artifact`` call (the StableHLO program) and the
port's ``load_artifact(..., device="cpu")`` (the port's own model on the
dequantized weights). Tolerances: restored tiles atol 2e-4 (float32 through
~30 layers of trained weights, summed in another order); per-tile PSNR(Y)
within 0.02 dB.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "experiments" / "round3_flagship" / "export_int8"
DEPTH1 = ROOT / "experiments" / "round4_sweep" / "export_scale0.2_int8"


@pytest.fixture(scope="module")
def tiles():
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_synth_corpus import synth_image

    rng = np.random.default_rng(777)
    out = []
    for _ in range(2):  # 2 images x 4 tiles = the corpus's first 8 tiles
        img = synth_image(rng, 512)
        img = np.round(img * 255).astype(np.uint8).astype(np.float32) / 255.0
        for ty in range(0, 512, 256):
            for tx in range(0, 512, 256):
                out.append(img[ty : ty + 256, tx : tx + 256])
    return np.stack(out)


def _both(art_dir, lr):
    from adunet.export import load_artifact as load_jax
    from adunet_torch.export import load_artifact as load_torch

    jcall, jmanifest = load_jax(art_dir)
    tcall, tmanifest = load_torch(art_dir, device="cpu")
    assert tmanifest == jmanifest
    return np.asarray(jcall(lr)), tcall(lr), tcall


def test_flagship_restores_like_jax(tiles):
    from adunet import metrics as jm
    from adunet import ops as jops
    from adunet_torch import metrics as tm
    from adunet_torch import ops as tops

    lr = np.array(jops.degrade(jnp.asarray(tiles), 0.5, 256))  # writable copy
    np.testing.assert_allclose(tops.degrade(torch.from_numpy(tiles), 0.5, 256).numpy(),
                               lr, atol=1e-5)
    want, got, tcall = _both(FLAGSHIP, lr)
    assert sum(p.numel() for p in tcall.model.parameters()) == 8_637_379
    np.testing.assert_allclose(got, want, atol=2e-4)

    shave = 4
    hr_y = jops.rgb_to_luma_bt601(jnp.asarray(tiles))[:, shave:-shave, shave:-shave]
    psnr_j = np.asarray(jm.psnr(hr_y, jops.rgb_to_luma_bt601(jnp.asarray(want))[:, shave:-shave, shave:-shave]))
    hr_yt = tops.rgb_to_luma_bt601(torch.from_numpy(tiles))[:, shave:-shave, shave:-shave]
    psnr_t = tm.psnr(hr_yt, tops.rgb_to_luma_bt601(torch.from_numpy(got))[:, shave:-shave, shave:-shave]).numpy()
    np.testing.assert_allclose(psnr_t, psnr_j, atol=0.02)
    # trained: well above the identity (bicubic) restoration of the same LR
    psnr_id = tm.psnr(hr_yt, tops.rgb_to_luma_bt601(torch.from_numpy(lr).clamp(0, 1))[:, shave:-shave, shave:-shave])
    assert psnr_t.mean() > float(psnr_id.mean()) + 1.0


def test_depth1_artifact_leaf_order(tiles):
    """The scale-0.2, depth-1 artifact (46 leaves) loads through the same
    leaf order and restores like JAX's program."""
    from adunet import ops as jops

    lr = np.array(jops.degrade(jnp.asarray(tiles), 0.2, 256))
    want, got, tcall = _both(DEPTH1, lr)
    assert tcall.model.depth == 1
    assert sum(p.numel() for p in tcall.model.parameters()) == 520_003
    np.testing.assert_allclose(got, want, atol=2e-4)
