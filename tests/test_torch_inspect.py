"""The port's ``inspect`` against the reference's (``adunet/cli/inspect.py``).

One flax init, perturbed off the identity start and converted with the
port's converter, restores one seeded HR patch in both packages; the port's
``inspect_example`` must give the reference's panels (HR, degraded LR,
prediction, |error|, Sobel edge difference), their crops around the peak
error, the peak itself and the PSNR / SSIM, at atol 1e-5 (PSNR / SSIM rtol
1e-5). The CLI writes its PNG grids from a checkpoint where matplotlib
imports, and without matplotlib it raises ImportError naming it before it
loads anything.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.cli import inspect as jax_inspect
from adunet.metrics import psnr as jax_psnr
from adunet.metrics import ssim as jax_ssim
from adunet.models import build_super_resolution_unet as build_jax
from adunet.ops import degrade as jax_degrade
from adunet_torch.cli import inspect as torch_inspect
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.models import build_super_resolution_unet

SCALE, SIZE, HALF = 0.5, 64, 16


def _models(perturb_params):
    jmodel, _ = build_jax(SCALE, base_channels=8, residual_head_channels=8, depth_override=2,
                          input_size=SIZE)
    params = perturb_params(jmodel.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    model, _ = build_super_resolution_unet(SCALE, base_channels=8, residual_head_channels=8,
                                           depth_override=2, input_size=SIZE, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    return jmodel, params, model.eval()


def test_inspect_example_matches_the_reference(perturb_params):
    jmodel, params, model = _models(perturb_params)
    hr = np.random.default_rng(3).random((SIZE, SIZE, 3), dtype=np.float32)
    got = torch_inspect.inspect_example(model, hr, SCALE, SIZE, zoom_half=HALF)

    # the reference CLI's loop body and visualize_example's arrays
    lr = np.asarray(jax_degrade(jnp.asarray(hr)[None], SCALE, SIZE)[0])
    pred = np.clip(np.asarray(jmodel.apply({"params": params}, jnp.asarray(lr)[None])[0]), 0, 1)
    err = np.abs(hr - pred).mean(axis=-1)
    edge = np.abs(jax_inspect._sobel_mag(hr.mean(axis=-1)) - jax_inspect._sobel_mag(pred.mean(-1)))
    cy, cx = np.unravel_index(np.argmax(err), err.shape)
    want = [hr, lr, pred, err, edge]

    assert [n for n, _, _ in got["panels"]] == ["HR", "LR (degraded)", "Prediction", "|error|",
                                                "edge diff"]
    assert got["peak"] == (cy, cx)
    for (_, img, _), crop, w in zip(got["panels"], got["crops"], want):
        np.testing.assert_allclose(img, w, rtol=0, atol=1e-5)
        np.testing.assert_allclose(crop, jax_inspect.crop_around(w, cy, cx, HALF), rtol=0,
                                   atol=1e-5)
        assert crop.shape[:2] == (2 * HALF, 2 * HALF)
    np.testing.assert_allclose(got["psnr"], float(jax_psnr(hr[None], pred[None])[0]), rtol=1e-5)
    np.testing.assert_allclose(got["ssim"], float(jax_ssim(jnp.asarray(hr)[None],
                                                           jnp.asarray(pred)[None])[0]), rtol=1e-5)


def test_sobel_and_crop_match_the_reference():
    gray = np.random.default_rng(4).random((20, 31), dtype=np.float32)
    np.testing.assert_array_equal(torch_inspect._sobel_mag(gray), jax_inspect._sobel_mag(gray))
    for cy, cx in ((0, 0), (19, 30), (10, 3)):
        np.testing.assert_array_equal(torch_inspect.crop_around(gray, cy, cx, 4),
                                      jax_inspect.crop_around(gray, cy, cx, 4))


def _checkpoint(tmp_path, perturb_params):
    """A train_sr-style checkpoint directory of the perturbed model."""
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

    _, _, model = _models(perturb_params)
    ckpt = tmp_path / "models" / "unet_adaptive_scale0.50_depth2"
    ckpt.mkdir(parents=True)
    (ckpt / "config.json").write_text(json.dumps({"base_channels": 8, "residual_head_channels": 8,
                                                  "max_depth": 7, "depth": 2}))
    mngr = CheckpointManager(ckpt, monitor="val_loss", mode="min")
    mngr.save(1, create_train_state(model, make_optimizer(model.parameters(), 1e-4)),
              metrics={"val_loss": 0.1})
    mngr.close()
    hr = tmp_path / "hr"
    hr.mkdir()
    rng = np.random.default_rng(5)
    for i in range(3):
        np.save(hr / f"im{i}.npy", rng.random((80, 72, 3), dtype=np.float32))
    return ckpt, hr


def test_cli_writes_the_grids(tmp_path, perturb_params):
    pytest.importorskip("matplotlib")
    ckpt, hr = _checkpoint(tmp_path, perturb_params)
    written = torch_inspect.main(["--device", "cpu", "--model-path", str(ckpt), "--scale", "0.5",
                                  "--hr-dir", str(hr), "--image-suffix", ".npy", "--patch-size",
                                  str(SIZE), "--n-examples", "2", "--output-dir",
                                  str(tmp_path / "out")])
    assert len(written) == 2
    for path in written:
        assert path.name.endswith("_scale0.50.png") and path.read_bytes()[:4] == b"\x89PNG"


def test_cli_without_matplotlib_raises_before_loading(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib -> ImportError
    with pytest.raises(ImportError, match="matplotlib"):
        torch_inspect.main(["--device", "cpu", "--model-path", str(tmp_path / "missing"),
                            "--scale", "0.5", "--hr-dir", str(tmp_path / "missing")])
    # the computation needs no matplotlib
    model = build_super_resolution_unet(SCALE, base_channels=4, residual_head_channels=4,
                                        depth_override=1, input_size=32, device="cpu")[0]
    hr = np.random.default_rng(6).random((32, 32, 3), dtype=np.float32)
    assert torch_inspect.inspect_example(model, hr, SCALE, 32, zoom_half=8)["crops"][0].shape == (
        16, 16, 3)
