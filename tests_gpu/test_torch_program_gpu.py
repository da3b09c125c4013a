"""Serving programs (``adunet_torch.export.program``) on the card.

- An SR, seg and joint program exported on the card (float32 and int8),
  saved and loaded, launches K1 and K2 through the ops its graph names, one
  launch per op node and call, no backward, and matches the model it was
  exported from (the int8 one: with its conv kernels quantized and
  dequantized) on the same tiles at 1e-5.
- A program exported on the CPU and moved to the card runs the kernels
  there, not their plain versions.
- An int8 SR program launches the banded resize kernel through the op
  ``adunet_torch::resize_band``, once per op node and call.

Sizes put every model's first level at 128 px so K2's gate accepts its
64 -> 64 convs. Every test needs a CUDA GPU and skips without one; a kernel
that does not build fails it:

    python -m pytest tests_gpu/test_torch_program_gpu.py -q
"""

import numpy as np
import pytest
import torch

from adunet_torch.export import program
from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.models import (
    build_adaptive_depth_unet,
    build_joint_unet,
    build_super_resolution_unet,
)

pytestmark = pytest.mark.gpu

SIZE, BATCH = 128, 2
K1, K2 = "adunet_torch.layer_norm_relu.default", "adunet_torch.conv3x3_c64.default"
RESIZE = "adunet_torch.resize_band.default"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _model(kind, device):
    if kind == "sr":
        model = build_super_resolution_unet(0.5, depth_override=2, input_size=SIZE,
                                            device=device)[0]
    elif kind == "seg":
        model = build_adaptive_depth_unet(SIZE, base_channels=64, depth=2, device=device)
    else:
        model = build_joint_unet(0.5, depth_override=2, input_size=SIZE, device=device)[0]
    with torch.no_grad():  # off the identity start of the SR heads
        gen = torch.Generator().manual_seed(4)
        for p in model.parameters():
            p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(device))
    return model.eval()


def _export(kind, model, quantize=None):
    return {"sr": program.export_sr_forward, "seg": program.export_seg_forward,
            "joint": program.export_joint_forward}[kind](model, SIZE, BATCH, quantize=quantize)


def _served(kind, out):
    """The eager model's output as a program returns it, in numpy."""
    if kind == "joint":
        return {"sr": out[0].float().clamp(0, 1).cpu().numpy(), "mask": out[1].float().cpu().numpy()}
    out = out.float()
    return (out.clamp(0, 1) if kind == "sr" else out).cpu().numpy()


def _dequantized_(model):
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 4:
                q, scale = program.quantize_int8(p.detach().cpu().numpy(), out_axis=0)
                p.copy_(torch.from_numpy(q.astype(np.float32) * scale[:, None, None, None]))
    return model


def _launches():
    return (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
            conv64.conv3x3_same.launches, conv64.conv3x3_same_backward.launches)


def _run_counted(prog, x):
    before = _launches()
    out = prog(x)
    torch.cuda.synchronize()
    return out, tuple(b - a for a, b in zip(before, _launches()))


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kind", ["sr", "seg", "joint"])
def test_program_exported_on_the_card_launches_the_kernels(cuda, kind, quantize, tmp_path):
    model = _model(kind, "cuda")
    ep = _export(kind, model, quantize)
    counts = program.node_counts(ep)
    n1, n2 = counts.get(K1, 0), counts.get(K2, 0)
    assert n2 > 0 and (n1 > 0) == (kind != "seg"), counts
    torch.export.save(ep, str(tmp_path / program.PROGRAM_FILE))
    prog = program.Program(tmp_path / program.PROGRAM_FILE, "cuda")
    x = np.random.default_rng(1).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    got, launched = _run_counted(prog, x)
    assert launched == (n1, 0, n2, 0)
    if quantize:
        _dequantized_(model)
    with torch.inference_mode():
        want = _served(kind, model(torch.from_numpy(x).cuda()))
    _close(got, want)


def test_program_exported_on_the_cpu_runs_the_kernels_on_the_card(cuda, tmp_path):
    model = _model("sr", "cpu")
    ep = _export("sr", model)
    counts = program.node_counts(ep)
    torch.export.save(ep, str(tmp_path / program.PROGRAM_FILE))
    on_cpu = program.Program(tmp_path / program.PROGRAM_FILE, "cpu")
    prog = program.Program(tmp_path / program.PROGRAM_FILE, "cuda")
    assert all(t.is_cuda for t in prog.exported_program.state_dict.values())
    x = np.random.default_rng(2).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    got, launched = _run_counted(prog, x)
    assert launched == (counts[K1], 0, counts[K2], 0) and counts[K2] == 4
    _, launched_cpu = _run_counted(on_cpu, x)
    assert launched_cpu == (0, 0, 0, 0)  # the CPU runs the plain versions
    with torch.inference_mode():  # the kernels on the card, as the eager model runs them
        want = _served("sr", model.cuda()(torch.from_numpy(x).cuda()))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_int8_program_launches_the_resize_op(cuda, tmp_path):
    from adunet_torch.kernels import all_launch_counts

    model = _model("sr", "cuda")
    ep = _export("sr", model, "int8")
    counts = program.node_counts(ep)
    assert counts.get(RESIZE) == 4, counts  # depth 2: two resizes down, two up
    torch.export.save(ep, str(tmp_path / program.PROGRAM_FILE))
    prog = program.Program(tmp_path / program.PROGRAM_FILE, "cuda")
    x = np.random.default_rng(3).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    before = all_launch_counts()[-1]
    got = prog(x)
    torch.cuda.synchronize()
    assert all_launch_counts()[-1] - before == counts[RESIZE]
    _dequantized_(model)
    with torch.inference_mode():
        want = _served("sr", model(torch.from_numpy(x).cuda()))
    _close(got, want)
