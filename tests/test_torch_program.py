"""The port's serving programs (``adunet_torch.export.program``) against the
JAX reference's exported programs, on the CPU.

- The two ops (``adunet_torch::layer_norm_relu``, ``adunet_torch::conv3x3_c64``)
  pass ``torch.library.opcheck``; the eager model never calls them (ops
  replaced by ones that raise: the eager forward is unchanged, an export
  raises); no backward goes through a program.
- An export leaves the eager model as it was: the resize matrices it caches
  while tracing are real tensors.
- SR (scale 0.5, depth 2, base 64, 1 x 128^2, so K2's gate passes at the
  first level), float32 and int8: the saved program, loaded, matches
  ``adunet.export.export_sr_forward(...).call`` on the same perturbed params
  at atol 1e-5 (the same weights, float32, another summation order), and its
  graph holds 12 K1 and 4 K2 ops and none of K1's plain decomposition.
- Seg (BatchNorm statistics moved off their init) and joint, both modes:
  the same against ``export_seg_forward`` / ``export_joint_forward``.
- A fresh process loads ``model.pt2`` importing neither JAX nor the port's
  model code and gives the in-process program's output bit for bit.
- ``export_model`` / ``serve`` / ``restore --from-export`` through a program.
- Image decoding from 16 threads at once in a process that has not imported
  cv2 yet.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.export import export_joint_forward as jax_export_joint
from adunet.export import export_seg_forward as jax_export_seg
from adunet.export import export_sr_forward as jax_export_sr
from adunet.models import build_adaptive_depth_unet as build_jax_seg
from adunet.models import build_joint_unet as build_jax_joint
from adunet.models import build_super_resolution_unet as build_jax_sr
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.export import load_artifact, save_artifact
from adunet_torch.export import program
from adunet_torch.kernels import ops
from adunet_torch.models import (
    build_adaptive_depth_unet,
    build_joint_unet,
    build_super_resolution_unet,
)

torch.set_num_threads(4)

ROOT = Path(__file__).resolve().parents[1]
K1 = "adunet_torch.layer_norm_relu.default"
K2 = "adunet_torch.conv3x3_c64.default"
SR_SIZE = 128  # the first level's convs pass K2's gate (W % 128 == 0)
SMALL = 32  # seg and joint: base 8, where K2's gate never passes

_states = {}


def _jax_state(kind, perturb_params):
    """A perturbed JAX state of ``kind`` and the port's model with its params
    (and BatchNorm statistics, moved off their init), made once a module."""
    if kind not in _states:
        if kind == "sr":
            model, _ = build_jax_sr(0.5, depth_override=2, input_size=SR_SIZE)
            size = SR_SIZE
        elif kind == "seg":
            model, size = build_jax_seg(SMALL, base_channels=8, depth=2), SMALL
        else:
            model, _ = build_jax_joint(0.5, base_channels=8, residual_head_channels=8,
                                       num_classes=2, depth_override=2, input_size=SMALL)
            size = SMALL
        state = jax_state(model, jax.random.key(0), jnp.zeros((1, size, size, 3)),
                          jax_optimizer(1e-4))
        state = state.replace(params=perturb_params(state.params, scale=0.05))
        stats = None
        if state.batch_stats is not None:
            moved = perturb_params(state.batch_stats, scale=0.2, seed=11)
            stats = jax.tree_util.tree_map_with_path(
                lambda path, v: jnp.abs(v) + 0.5 if path[-1].key == "var" else v, moved)
            state = state.replace(batch_stats=stats)
        torch_model = {
            "sr": lambda: build_super_resolution_unet(0.5, depth_override=2, input_size=SR_SIZE,
                                                      device="cpu")[0],
            "seg": lambda: build_adaptive_depth_unet(SMALL, base_channels=8, depth=2,
                                                     device="cpu"),
            "joint": lambda: build_joint_unet(0.5, base_channels=8, residual_head_channels=8,
                                              num_classes=2, depth_override=2, input_size=SMALL,
                                              device="cpu")[0],
        }[kind]()
        torch_model.load_state_dict(state_dict_from_flax(
            jax.device_get(state.params),
            None if stats is None else jax.device_get(stats)), strict=True)
        _states[kind] = (state, torch_model.eval(), size)
    return _states[kind]


def _norms(model):
    """The model's K1 calls a forward: one per LayerNorm + ReLU module."""
    return sum(type(m).__name__ == "LayerNormReLU" for m in model.modules())


def _tiles(size, n=1, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def test_ops_pass_opcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=gen)
    gamma, beta = torch.randn(64, generator=gen), torch.randn(64, generator=gen)
    torch.library.opcheck(ops.layer_norm_relu, (x, gamma, beta, 1e-3))
    x = torch.randn(1, 16, 128, 64, generator=gen)
    w, b = 0.05 * torch.randn(64, 64, 3, 3, generator=gen), torch.randn(64, generator=gen)
    torch.library.opcheck(ops.conv3x3_c64, (x, w, b))
    torch.library.opcheck(ops.conv3x3_c64, (x, w, None))
    with pytest.raises(ValueError, match="unsupported shapes"):
        ops.conv3x3_c64(x[:, :8], w, b)


@pytest.mark.parametrize("shape, cout", [((1, 6, 10, 64), 128), ((2, 5, 3, 256), 64),
                                         ((1, 1, 1, 8), 192)])
def test_k3_op_passes_opcheck(shape, cout):
    """K3's op (``adunet_torch::conv3x3_f32``): its plain CPU kernel and its
    fake kernel (the output's shape, read from no data) agree under
    ``opcheck``, with a bias and without; a shape K3 refuses raises."""
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(*shape, generator=gen)
    w = torch.randn(cout, shape[-1], 3, 3, generator=gen) * 0.05
    b = torch.randn(cout, generator=gen)
    torch.library.opcheck(ops.conv3x3_f32, (x, w, b))
    torch.library.opcheck(ops.conv3x3_f32, (x, w, None))
    with pytest.raises(ValueError, match="unsupported shapes"):
        ops.conv3x3_f32(x, w[:, :4], b)


def test_eager_path_calls_no_op_and_export_does(monkeypatch, perturb_params):
    _, model, size = _jax_state("sr", perturb_params)
    x = torch.from_numpy(_tiles(size))
    with torch.no_grad():
        want = model(x)

    def refuse(*args, **kwargs):
        raise AssertionError("the eager path called a program's op")

    monkeypatch.setattr(torch.ops.adunet_torch, "layer_norm_relu", refuse)
    monkeypatch.setattr(torch.ops.adunet_torch, "conv3x3_c64", refuse)
    monkeypatch.setattr(torch.ops.adunet_torch, "conv3x3_f32", refuse)
    with torch.no_grad():
        assert torch.equal(model(x), want)
    x.requires_grad_(True)
    model(x).sum().backward()  # the autograd Functions, not the ops
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with pytest.raises(AssertionError, match="program's op"):
        program.export_sr_forward(model, size, 1)


def test_eager_model_is_unchanged_after_an_export(perturb_params):
    """Export traces with fake tensors; the resize matrices it asks for first
    are cached for the eager model too, and must be real."""
    _, model, size = _jax_state("sr", perturb_params)
    x = torch.from_numpy(_tiles(size, seed=1))
    with torch.no_grad():
        want = model(x)
    importlib.import_module("adunet_torch.kernels.resize_band")._device_matrix.cache_clear()
    program.export_sr_forward(model, size, 1)
    with torch.no_grad():
        got = model(x)
    assert type(got) is torch.Tensor and torch.equal(got, want)


def _saved(ep, tmp_path):
    path = tmp_path / program.PROGRAM_FILE
    torch.export.save(ep, str(path))
    return program.Program(path, "cpu")


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_sr_program_matches_jax(quantize, tmp_path, perturb_params):
    state, model, size = _jax_state("sr", perturb_params)
    ep = program.export_sr_forward(model, size, 1, quantize=quantize)
    counts = program.node_counts(ep)
    assert counts.get(K1) == _norms(model) == 12 and counts.get(K2) == 4, counts
    assert not any(k in counts for k in ("aten.rsqrt.default", "aten.mean.dim",
                                         "aten.constant_pad_nd.default")), counts
    if quantize:
        int8 = [v for v in ep.state_dict.values() if v.dtype == torch.int8]
        assert len(int8) == sum(p.dim() == 4 for p in model.parameters())  # every conv kernel
        assert not any(v.dim() == 4 and v.dtype == torch.float32 for v in ep.state_dict.values())
    x = _tiles(size, seed=2)
    want = np.asarray(jax_export_sr(state, size, 1, platforms=("cpu",), quantize=quantize).call(x))
    got = _saved(ep, tmp_path)(x)
    assert np.abs(want - x).max() > 1e-2  # not the identity
    np.testing.assert_allclose(got, want, atol=1e-5)


# the ops of the served flagship's program (scale 0.5, depth 3, batch 8 x 256
# px), by node: a library conv keeps its bias in the conv there (K1's op
# takes none). K3's op holds the 14 float32 3x3 convs K2 refuses, with their
# weights and biases as they are, so only enc0.conv0 (3 -> 64) and the 1x1
# head are library convs: two ``aten.conv2d`` with a permute on either side
# and a cast of their weight and bias each
FLAGSHIP_OPS = {
    "adunet_torch.conv3x3_c64.default": 4, "adunet_torch.conv3x3_f32.default": 14,
    "adunet_torch.layer_norm_relu.default": 16,
    "adunet_torch.resize_band.default": 6, "aten._assert_tensor_metadata.default": 11,
    "aten.add.Tensor": 1, "aten.cat.default": 3, "aten.clamp.default": 1,
    "aten.conv2d.default": 2, "aten.maximum.default": 1, "aten.minimum.default": 1,
    "aten.ones.default": 1, "aten.permute.default": 4, "aten.relu.default": 3,
    "aten.to.dtype": 11, "aten.zeros.default": 1,
}
FLAGSHIP_INT8_OPS = {**FLAGSHIP_OPS,
                     "aten._assert_tensor_metadata.default": 31, "aten.mul.Tensor": 20,
                     "aten.to.dtype": 31, "aten.view.default": 20}


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_exported_flagship_program_keeps_its_ops(quantize):
    model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cpu", seed=0)
    ep = program.export_sr_forward(model.eval(), 256, 8, quantize=quantize)
    assert program.node_counts(ep) == (FLAGSHIP_INT8_OPS if quantize else FLAGSHIP_OPS)
    k1 = [n for n in ep.graph.nodes if n.op == "call_function" and str(n.target) == K1]
    assert len(k1) == 16 and all(len(n.args) == 4 for n in k1)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kind", ["seg", "joint"])
def test_seg_and_joint_programs_match_jax(kind, quantize, tmp_path, perturb_params):
    state, model, size = _jax_state(kind, perturb_params)
    export = {"seg": program.export_seg_forward, "joint": program.export_joint_forward}[kind]
    jax_export = {"seg": jax_export_seg, "joint": jax_export_joint}[kind]
    ep = export(model, size, 2, quantize=quantize)
    counts = program.node_counts(ep)
    assert counts.get(K1, 0) == _norms(model) == (0 if kind == "seg" else 16), counts
    x = _tiles(size, n=2, seed=3)
    want = jax.device_get(jax_export(state, size, 2, platforms=("cpu",), quantize=quantize).call(x))
    got = _saved(ep, tmp_path)(x)
    if kind == "seg":
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    else:
        assert set(got) == {"sr", "mask"} and got["mask"].shape == (2, size, size, 2)
        for key in ("sr", "mask"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-5)


def test_program_cuts_and_pads_a_batch(tmp_path, perturb_params):
    _, model, size = _jax_state("seg", perturb_params)
    prog = _saved(program.export_seg_forward(model, size, 2), tmp_path)
    x = _tiles(size, n=3, seed=4)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    got = prog(x)
    assert got.shape == want.shape and prog.input_shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError, match="tiles"):
        prog(x[:, :16])


def test_backward_through_a_program_raises(tmp_path, perturb_params):
    _, model, size = _jax_state("sr", perturb_params)
    prog = _saved(program.export_sr_forward(model, size, 1), tmp_path)
    x = torch.from_numpy(_tiles(size)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd formula"):
        prog.module(x).sum().backward()


_FRESH = r"""
import json, sys
import numpy as np
from adunet_torch.export import program
from adunet_torch.kernels import conv64, fused_norm
prog = program.Program(sys.argv[1], "cpu")
np.save(sys.argv[3], prog(np.load(sys.argv[2])))
print(json.dumps({"modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "adunet")
                                    or m.startswith(("adunet_torch.models", "adunet_torch.nn",
                                                     "adunet_torch.ops"))),
                  "launches": [fused_norm.layer_norm_relu.launches, conv64.conv3x3_same.launches]}))
"""


def test_fresh_process_runs_a_program_without_model_code(tmp_path, perturb_params):
    _, model, size = _jax_state("sr", perturb_params)
    prog = _saved(program.export_sr_forward(model, size, 1, quantize="int8"), tmp_path)
    x = _tiles(size, seed=5)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _FRESH, str(tmp_path / program.PROGRAM_FILE),
                           str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"modules": [], "launches": [0, 0]}  # the CPU runs the plain versions
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), prog(x))


def _post_npy(url, arr):
    import io
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


def test_export_serve_and_restore_run_the_program(tmp_path, perturb_params):
    """``export_model`` writes the program, ``serve`` answers from it and
    ``restore --from-export`` restores with it; a program artifact's joint
    model is still refused by ``serve``."""
    from adunet_torch.cli import restore
    from adunet_torch.cli.export_model import main as export_main
    from adunet_torch.cli.serve import make_server
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

    _, model, size = _jax_state("sr", perturb_params)
    ckpt = tmp_path / "ckpt"
    mngr = CheckpointManager(ckpt, monitor="val_loss")
    mngr.save(1, create_train_state(model, make_optimizer(model.parameters(), 1e-4)),
              metrics={"val_loss": 0.5})
    mngr.write_config({"scale": 0.5, "depth": 2, "base_channels": 64,
                       "residual_head_channels": 64})
    out = export_main(["--workload", "sr", "--model-path", str(ckpt), "--scale", "0.5",
                       "--output-dir", str(tmp_path / "art"), "--batch-size", "2",
                       "--patch-size", str(size), "--quantize", "int8", "--device", "cpu"])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["program_file"] == "model.pt2" and (out / "model.pt2").exists()
    call, _ = load_artifact(out, device="cpu")
    assert isinstance(call, program.Program)

    server = make_server(str(out), port=0, batch_window_ms=50.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        x = _tiles(size, n=3, seed=6)
        got = _post_npy(f"http://127.0.0.1:{server.server_address[1]}/v1/predict", x)
        np.testing.assert_allclose(got, call(x), atol=1e-6)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

    images = tmp_path / "in"
    images.mkdir()
    np.save(images / "a.npy", _tiles(size + 40, seed=7)[0])
    written = restore.main(["--from-export", str(out), "--scale", "0.5", "--input-dir",
                            str(images), "--output-dir", str(tmp_path / "restored"),
                            "--image-suffix", ".npy", "--overlap", "16", "--device", "cpu"])
    assert len(written) == 1

    joint = _jax_state("joint", perturb_params)[1]
    art = save_artifact(joint, tmp_path / "joint", image_size=SMALL, batch_size=2)
    assert (art / "model.pt2").exists()
    with pytest.raises(ValueError, match="joint SR \\+ segmentation"):
        make_server(str(art), port=0, device="cpu")


_DECODE = r"""
import sys, threading
assert "cv2" not in sys.modules
from adunet_torch.data import io
paths = sys.argv[1:]
barrier, errors, shapes = threading.Barrier(16), [], []

def decode(chunk):
    barrier.wait()
    for p in chunk:
        try:
            shapes.append(io.load_rgb_image_full(p).shape)
        except Exception as exc:
            errors.append(repr(exc))

threads = [threading.Thread(target=decode, args=(paths[i::16],)) for i in range(16)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=60)
assert not any(t.is_alive() for t in threads)
assert not errors, errors
assert shapes == [(12, 20, 3)] * len(paths), shapes
print("ok")
"""


def test_decoding_from_many_threads_in_a_fresh_process(tmp_path):
    """A per-decode probe for cv2 raised ``ValueError: cv2.__spec__ is None``
    in one thread while another was still importing it."""
    from PIL import Image

    rng = np.random.default_rng(8)
    paths = []
    for i in range(32):
        paths.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)).save(paths[-1])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _DECODE, *paths], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
