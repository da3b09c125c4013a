"""The port's export half against the JAX reference, on the CPU.

- ``quantize_params_int8``: bit-equal ``q`` and equal ``scale`` to
  ``adunet.export.quantize_params_int8`` on the same params, halves rounded
  to even as numpy does; re-quantizing the committed flagship's dequantized
  weights gives back its ``q`` leaves.
- A JAX int8 joint artifact (``export_joint_forward`` + ``save_artifact``,
  its manifest without the scale, as ``export_model`` writes it) loads in
  the port and matches the JAX call, both heads to atol 1e-5 (the same
  dequantized weights, float32, another summation order).
- ``save_artifact`` / ``load_artifact`` round-trip every model; a
  segmentation artifact carries its BatchNorm running statistics and
  matches the live eval-mode forward; a JAX segmentation artifact, whose
  statistics live only in its program, is refused.
- ``export_model --workload sr|seg|joint`` on the port's checkpoints (each
  artifact with its program, exported on the CPU: ``platforms`` ["cpu"]), and
  ``serve`` answering a segmentation artifact and refusing a joint one.
"""

import io
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.export import export_joint_forward, export_seg_forward
from adunet.export import load_artifact as jax_load_artifact
from adunet.export.aot import quantize_params_int8 as jax_quantize
from adunet.export import save_artifact as jax_save_artifact
from adunet.models import build_adaptive_depth_unet as build_jax_seg
from adunet.models import build_joint_unet as build_jax_joint
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet_torch.convert import flax_leaf_paths, flax_trees_from_state_dict, state_dict_from_flax
from adunet_torch.export import load_artifact, quantize_params_int8, save_artifact
from adunet_torch.models import (
    build_adaptive_depth_unet,
    build_joint_unet,
    build_super_resolution_unet,
)

torch.set_num_threads(4)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "experiments" / "round3_flagship" / "export_int8"
SIZE, BATCH = 32, 2


def _jax_joint_state(perturb_params, num_classes=1):
    model, info = build_jax_joint(0.5, base_channels=8, residual_head_channels=8,
                                  num_classes=num_classes, depth_override=2, input_size=SIZE)
    state = jax_state(model, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), jax_optimizer(1e-4))
    return model, info, state.replace(params=perturb_params(state.params, scale=0.05))


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


def test_quantizer_bit_equal_to_jax(perturb_params):
    _, _, state = _jax_joint_state(perturb_params)
    params = jax.device_get(state.params)
    # exact halves after scaling (max |w| = 127 gives scale 1): numpy rounds them to even
    params["mask_logits"]["kernel"] = np.array([0.5, 1.5, 2.5, -0.5, -3.5, 127.0],
                                               np.float32).reshape(1, 1, 6, 1)
    want = dict(_flat(jax.device_get(jax_quantize(params))))
    got = dict(_flat(quantize_params_int8(params)))
    assert list(got) == list(want)
    for path, value in want.items():
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))
    np.testing.assert_array_equal(got[("mask_logits", "kernel", "q")].ravel(),
                                  [0, 2, 2, 0, -4, 127])


def _dequantized(tree):
    if set(tree) == {"q", "scale"}:
        return tree["q"].astype(np.float32) * tree["scale"]
    return {k: _dequantized(v) if isinstance(v, dict) else v for k, v in tree.items()}


def test_requantized_flagship_gives_back_its_q_leaves():
    tree = {}
    with np.load(FLAGSHIP / "weights.npz") as z:
        for i, path in enumerate(flax_leaf_paths(3, quantized=True)):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = z[f"w{i}"]
    again = dict(_flat(quantize_params_int8(_dequantized(tree))))
    q_leaves = [(path, value) for path, value in _flat(tree) if path[-1] == "q"]
    assert len(q_leaves) == 20  # the depth-3 flagship's convs
    for path, value in q_leaves:
        np.testing.assert_array_equal(again[path], value, err_msg="/".join(path))


def test_jax_int8_joint_artifact_matches_jax_call(tmp_path, perturb_params):
    """The manifest as ``export_model --workload joint`` writes it: no scale,
    the checkpoint named, whose ``config.json`` has it."""
    _, info, state = _jax_joint_state(perturb_params, num_classes=3)
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / "config.json").write_text(json.dumps({"scale": 0.5}))
    exported = export_joint_forward(state, image_size=SIZE, batch_size=BATCH, platforms=("cpu",),
                                    quantize="int8")
    art = jax_save_artifact(exported, tmp_path / "artifact", meta={
        "model": "joint_sr_seg_unet", "depth": info["depth"], "image_size": SIZE,
        "quantization": "int8-weight-only", "checkpoint": str(tmp_path / "ckpt")})
    jax_call, _ = jax_load_artifact(art)
    call, manifest = load_artifact(art, device="cpu")
    assert "scale" not in manifest and call.model.num_classes == 3
    x = np.random.default_rng(0).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    want = {k: np.asarray(v) for k, v in jax_call(x).items()}
    got = call(x)
    assert set(got) == {"sr", "mask"} and got["mask"].shape == (BATCH, SIZE, SIZE, 3)
    assert np.abs(want["sr"] - x).max() > 1e-2  # not the identity
    np.testing.assert_allclose(got["sr"], want["sr"], atol=1e-5)
    np.testing.assert_allclose(got["mask"], want["mask"], atol=1e-5)


def _seg_model_with_stats(seed=0):
    """A small protocol seg U-Net whose BatchNorm running statistics have
    moved off their init (two training-mode forwards)."""
    model = build_adaptive_depth_unet(SIZE, base_channels=8, depth=2, device="cpu", seed=seed)
    x = torch.from_numpy(np.random.default_rng(seed).random((4, SIZE, SIZE, 3), dtype=np.float32))
    with torch.no_grad():
        for _ in range(2):
            model.train()(x)
    return model.eval()


def _perturbed(model, seed=3):
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _models():
    sr, _ = build_super_resolution_unet(0.5, base_channels=8, residual_head_channels=8,
                                        depth_override=2, device="cpu")
    joint, _ = build_joint_unet(0.5, base_channels=8, residual_head_channels=8, num_classes=2,
                                depth_override=2, device="cpu")
    return {"sr": _perturbed(sr), "seg": _seg_model_with_stats(), "joint": _perturbed(joint)}


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kind", ["sr", "seg", "joint"])
def test_save_and_load_artifact_round_trip(kind, quantize, tmp_path):
    """Float32 artifacts serve the live model's eval forward exactly; int8
    ones the model with the port's quantized-and-dequantized weights."""
    model = _models()[kind].eval()
    art = save_artifact(model, tmp_path / "art", image_size=SIZE, batch_size=BATCH,
                        quantize=quantize)
    manifest = json.loads((art / "manifest.json").read_text())
    assert manifest["format"] == "adunet_torch.weights" and "adunet_torch" in manifest["loads_in"]
    assert not (art / "model.stablehlo").exists()
    n_stats = 2 * 2 * (2 * 2 + 1) if kind == "seg" else 0  # mean / var of 10 BatchNorms
    assert manifest["batch_stats_leaves"] == n_stats
    with np.load(art / "weights.npz") as z:
        assert sum(k.startswith("s") for k in z.files) == n_stats
    call, manifest = load_artifact(art, device="cpu")
    if quantize:
        params, stats = flax_trees_from_state_dict(model.state_dict())
        model.load_state_dict(state_dict_from_flax(_dequantized(quantize_params_int8(params)),
                                                   stats))
    for name, value in model.state_dict().items():
        assert torch.equal(call.model.state_dict()[name], value), name
    x = np.random.default_rng(1).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    with torch.no_grad():
        live = model(torch.from_numpy(x))
    got = call(x)
    if kind == "joint":
        np.testing.assert_array_equal(got["sr"], torch.clamp(live[0], 0, 1).numpy())
        np.testing.assert_array_equal(got["mask"], live[1].numpy())
    else:
        want = torch.clamp(live, 0, 1) if kind == "sr" else live
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("kind, key, match", [
    ("sr", "scale", "names no 'scale'"), ("joint", "scale", "names no 'scale'"),
    ("sr", "depth", "names no 'depth'"), ("seg", "depth", "names no 'depth'")])
def test_artifact_without_scale_or_depth_is_refused(kind, key, match, tmp_path):
    """Neither the encoder's shrink nor the depth is guessed: a wrong one
    would serve wrong outputs without an error."""
    art = save_artifact(_models()[kind], tmp_path / "art", image_size=SIZE, batch_size=BATCH)
    manifest = json.loads((art / "manifest.json").read_text())
    del manifest[key]
    (art / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match=match):
        load_artifact(art, device="cpu")


def test_jax_seg_artifact_is_refused(tmp_path):
    model = build_jax_seg(SIZE, base_channels=8, depth=2)
    state = jax_state(model, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), jax_optimizer(1e-3))
    exported = export_seg_forward(state, image_size=SIZE, batch_size=BATCH, platforms=("cpu",),
                                  quantize="int8")
    art = jax_save_artifact(exported, tmp_path / "seg", meta={
        "model": "adaptive_seg_unet", "depth": 2, "image_size": SIZE,
        "quantization": "int8-weight-only"})
    with pytest.raises(ValueError, match="BatchNorm running statistics"):
        load_artifact(art, device="cpu")


def _checkpoint(kind, model, root):
    """A checkpoint directory as the port's trainer of ``kind`` writes it."""
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

    config = {
        "sr": {"scale": 0.5, "depth": 2, "base_channels": 8, "residual_head_channels": 8},
        "seg": {"image_size": SIZE, "depth": 2, "base_channels": 8},
        "joint": {"scale": 0.5, "depth": 2, "base_channels": 8, "residual_head_channels": 8,
                  "num_classes": 2, "image_size": SIZE, "val_image_dir": "v"},
    }[kind]
    monitor = {"sr": "val_loss", "seg": "val_dice", "joint": "val_loss"}[kind]
    mngr = CheckpointManager(root, monitor=monitor)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    mngr.save(1, state, metrics={monitor: 0.5})
    mngr.write_config(config)
    return root


@pytest.mark.parametrize("kind, quantize", [("sr", "int8"), ("seg", None), ("joint", "int8")])
def test_export_model_cli_round_trips(kind, quantize, tmp_path):
    from adunet_torch.cli.export_model import main

    model = _models()[kind].eval()
    ckpt = _checkpoint(kind, model, tmp_path / "ckpt")
    args = ["--workload", kind, "--model-path", str(ckpt), "--output-dir", str(tmp_path / "out"),
            "--batch-size", str(BATCH), "--patch-size", str(SIZE), "--device", "cpu"]
    args += ["--scale", "0.5"] if kind == "sr" else []
    args += ["--quantize", quantize] if quantize else []
    args += ["--platforms", "cuda,cpu"] if kind == "joint" else []
    out = main(args)
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["input_shape"] == [BATCH, SIZE, SIZE, 3]
    assert manifest["checkpoint"] == str(ckpt) and manifest["platforms"] == ["cpu"]
    assert manifest.get("platforms_requested") == (["cuda", "cpu"] if kind == "joint" else None)
    assert ("quantization" in manifest) == bool(quantize)
    call, _ = load_artifact(out, device="cpu")
    assert manifest["program_file"] == "model.pt2" and call.input_shape == (BATCH, SIZE, SIZE, 3)
    x = np.random.default_rng(2).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    with torch.no_grad():
        live = model(torch.from_numpy(x))
    got = call(x)
    if quantize:  # int8 weights: near the live model, and the dequantized model's exactly
        params, stats = flax_trees_from_state_dict(model.state_dict())
        model.load_state_dict(state_dict_from_flax(_dequantized(quantize_params_int8(params)),
                                                   stats))
        with torch.no_grad():
            deq = model(torch.from_numpy(x))
    if kind == "joint":
        assert np.abs(got["mask"] - live[1].numpy()).max() < 5e-2
        np.testing.assert_array_equal(got["sr"], torch.clamp(deq[0], 0, 1).numpy())
        np.testing.assert_array_equal(got["mask"], deq[1].numpy())
    elif kind == "seg":
        np.testing.assert_array_equal(got, live.numpy())
    else:
        assert np.abs(got - torch.clamp(live, 0, 1).numpy()).max() < 5e-2
        np.testing.assert_array_equal(got, torch.clamp(deq, 0, 1).numpy())


def test_export_model_refuses_cuda_without_gpu(tmp_path):
    from adunet_torch.cli.export_model import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    ckpt = _checkpoint("seg", _models()["seg"], tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["--workload", "seg", "--model-path", str(ckpt), "--output-dir", str(tmp_path / "o")])


def _post_npy(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


def test_serve_answers_seg_and_refuses_joint(tmp_path):
    from adunet_torch.cli.serve import make_server

    model = _seg_model_with_stats(seed=5)
    art = save_artifact(model, tmp_path / "seg", image_size=SIZE, batch_size=BATCH,
                        quantize="int8")
    call, _ = load_artifact(art, device="cpu")
    server = make_server(str(art), port=0, batch_window_ms=50.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        x = np.random.default_rng(6).random((3, SIZE, SIZE, 3), dtype=np.float32)
        out = _post_npy(f"http://127.0.0.1:{server.server_address[1]}/v1/predict", x)
        assert out.shape == (3, SIZE, SIZE, 1)
        padded = np.zeros((4, SIZE, SIZE, 3), np.float32)
        padded[:3] = x
        want = np.concatenate([call(padded[:2]), call(padded[2:])])[:3]
        np.testing.assert_allclose(out, want, atol=1e-6)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    with pytest.raises(ValueError, match="joint SR \\+ segmentation"):
        make_server(str(save_artifact(_models()["joint"], tmp_path / "joint", image_size=SIZE,
                                      batch_size=BATCH)), port=0, device="cpu")
