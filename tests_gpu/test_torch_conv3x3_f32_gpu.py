"""K3, the float32 3x3 SAME conv at the channel counts K2 refuses, on the card.

- The kernel against cuDNN's ``F.conv2d`` (float32, TF32 off) and against
  its plain version, at the 9 shapes of the served flagship's forward
  (batch 8) and at ragged ones (batch 1, H = 17 and W = 40, W = 300, W below
  one 8-pixel group, C_out = 192, no bias): outputs of unit scale, summed
  over 9 x C_in <= 4,608 float32 products in other orders, so within 1e-4;
  two calls give the same bits.
- The flagship's int8 program (depth 3, 256 px, batch 8) makes 14 K3 and 4
  K2 launches a forward, and its tiles match the eager weights path and the
  cuDNN route (K3's gate closed) within 1e-5.
- A compiled training step launches no K3, in bf16 or float32.

Every test needs a CUDA GPU and skips without one:

    python -m pytest tests_gpu/test_torch_conv3x3_f32_gpu.py -q
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adunet_torch.export import program
from adunet_torch.kernels import conv3x3_f32, launch_snapshot, launches_since
from adunet_torch.losses import charbonnier_loss
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.nn import blocks
from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step

pytestmark = pytest.mark.gpu

k3 = importlib.import_module("adunet_torch.kernels.conv3x3_f32")

# (B, H, W, C_in, C_out): the served flagship's 9 shapes, then ragged ones
SERVED = [(8, 128, 128, 64, 128), (8, 128, 128, 128, 128), (8, 64, 64, 128, 256),
          (8, 64, 64, 256, 256), (8, 32, 32, 256, 512), (8, 32, 32, 512, 512),
          (8, 64, 64, 512, 256), (8, 128, 128, 256, 128), (8, 256, 256, 128, 64)]
RAGGED = [(1, 128, 128, 64, 128), (2, 17, 40, 128, 256), (1, 9, 300, 64, 64),
          (3, 5, 5, 8, 128), (1, 33, 65, 24, 192), (1, 1, 1, 8, 64)]
ATOL = 1e-4
K3, K2 = 9, 2  # their places in kernels.launch_snapshot()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _inputs(gen, shape, bias=True):
    bsz, h, w, ci, co = shape
    x = torch.randn(bsz, h, w, ci, generator=gen, device="cuda")
    wt = torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * (1.0 / (9 * ci)) ** 0.5
    b = torch.randn(co, generator=gen, device="cuda") * 0.1 if bias else None
    return x, wt, b


@pytest.mark.parametrize("shape", SERVED + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_k3_matches_cudnn_and_its_plain_version(cuda, shape):
    x, wt, b = _inputs(cuda, shape, bias=shape != RAGGED[-2])
    assert k3.supported(x.shape, wt.shape)
    before = launch_snapshot()
    with torch.inference_mode():
        got = conv3x3_f32(x, wt, b)
        again = conv3x3_f32(x, wt, b)
        lib = F.conv2d(x.permute(0, 3, 1, 2), wt, b, padding=1).permute(0, 2, 3, 1)
        plain = k3.conv3x3_f32_plain(x, wt, b)
    torch.cuda.synchronize()
    assert launches_since(before) == (0,) * K3 + (2,)
    assert got.shape == lib.shape and torch.equal(got, again)
    assert (got - lib).abs().max().item() <= ATOL
    assert (got - plain).abs().max().item() <= ATOL


def test_k3_refuses_a_call_that_wants_a_gradient(cuda):
    x, wt, b = _inputs(cuda, SERVED[0])
    wt.requires_grad_(True)
    assert not k3.takes(x, wt, b)
    with pytest.raises(ValueError, match="no gradient"):
        conv3x3_f32(x, wt, b)


def _flagship():
    model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cuda", seed=0)
    with torch.no_grad():  # off the identity start of the zero head
        gen = torch.Generator().manual_seed(4)
        for p in model.parameters():
            p.add_((0.02 * torch.randn(p.shape, generator=gen)).to("cuda"))
    return model.eval()


def test_flagship_int8_program_runs_k3_and_matches_the_cudnn_route(cuda, tmp_path, monkeypatch):
    model = _flagship()
    ep = program.export_sr_forward(model, 256, 8, quantize="int8")
    counts = program.node_counts(ep)
    assert counts["adunet_torch.conv3x3_f32.default"] == 14 and counts["aten.conv2d.default"] == 2
    torch.export.save(ep, str(tmp_path / program.PROGRAM_FILE))
    prog = program.Program(tmp_path / program.PROGRAM_FILE, "cuda")
    x = np.random.default_rng(1).random((8, 256, 256, 3), dtype=np.float32)
    before = launch_snapshot()
    got = prog(x)
    torch.cuda.synchronize()
    launched = launches_since(before)
    assert (launched[K3], launched[K2]) == (14, 4), launched
    with torch.no_grad():  # the program's weights: each conv kernel quantized and dequantized
        for p in model.parameters():
            if p.dim() == 4:
                q, scale = program.quantize_int8(p.detach().cpu().numpy(), out_axis=0)
                p.copy_(torch.from_numpy(q.astype(np.float32) * scale[:, None, None, None]))
    xd = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        eager = model(xd).clamp(0, 1).cpu().numpy()
        monkeypatch.setattr(blocks, "conv3x3_f32_takes", lambda *args: False)
        before = launch_snapshot()
        library = model(xd).clamp(0, 1).cpu().numpy()
        assert launches_since(before)[K3] == 0
    assert np.abs(library - x).max() > 1e-2  # not the identity
    np.testing.assert_allclose(got, eager, atol=1e-5)
    np.testing.assert_allclose(got, library, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_compiled_train_step_launches_no_k3(cuda, dtype):
    """4 calls of the compiled step: 2 eager, the capture, a replay."""
    model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=dtype, device="cuda",
                                           seed=0)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_sr_train_step(model, charbonnier_loss)
    hr = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(1))
    before = launch_snapshot()
    for _ in range(4):
        state, _ = step(state, hr)
    torch.cuda.synchronize()
    launched = launches_since(before)
    assert launched[K3] == 0 and launched[K2] == 4 * 4, launched
