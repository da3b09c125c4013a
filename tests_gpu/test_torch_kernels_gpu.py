"""The port's CUDA kernels on the card, at shapes beyond the flagship's path.

``chip_smoke.py`` holds each kernel against its plain version at the shapes
the serving forward gives it; these tests add the edges: row counts that do
not fill a block, every channel count K1 takes, several K2 tiles per image
and batch, bf16, and the refusals of a CUDA tensor the kernels do not take.
Every test needs a CUDA GPU and skips without one. Run on a GPU machine from
the repository root:

    python -m pytest tests_gpu -q

Tolerances: float32 atol 1e-5 (K1) / 1e-4 (K2) — another summation and rsqrt
order; bf16 one bf16 ulp relative (2^-7), where a last-bit float32
difference flips the rounding, plus 1e-6 (K1) / 1e-5 (K2) absolute: K2's
bf16 kernel adds its 576 float32 products on the tensor cores, in another
order than the plain version's matmuls, and an output near 0 keeps that
float32 difference (``chip_smoke.K2_BF16_ATOL``, from the readings in
PERF.md).
"""

import pytest
import torch

from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.models import build_super_resolution_unet

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _close(got, want, dtype, atol, atol_bf16=1e-6):
    g, w = got.float(), want.float()
    limit = atol if dtype == torch.float32 else 2.0**-7 * w.abs() + atol_bf16
    assert got.dtype == want.dtype
    assert bool(((g - w).abs() <= limit).all()), (g - w).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, c", [(1, 64), (37, 128), (1001, 256), (5, 512), (77, 1024), (9, 2048)])
def test_layer_norm_relu_matches_plain(cuda, dtype, rows, c):
    x = (torch.randn(rows, c, generator=cuda, device="cuda") * 3 + 1).to(dtype)
    g = torch.randn(c, generator=cuda, device="cuda") * 0.2 + 1
    b = torch.randn(c, generator=cuda, device="cuda") * 0.2
    _close(fused_norm.layer_norm_relu(x, g, b), fused_norm.layer_norm_relu_plain(x, g, b), dtype, 1e-5)


def test_layer_norm_relu_nd_input(cuda):
    x = torch.randn(2, 3, 5, 64, generator=cuda, device="cuda")
    g, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    _close(fused_norm.layer_norm_relu(x, g, b), fused_norm.layer_norm_relu_plain(x, g, b),
           torch.float32, 1e-5)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 128, 64), (3, 24, 384, 64), (2, 64, 256, 64),
                                   (5, 64, 256, 64)])
def test_conv3x3_matches_plain(cuda, dtype, shape, bias):
    """At the smallest gated shape, at W = 384 (three 128-column blocks of the
    gate) and over several tiles per image, with and without bias; the last
    has 320 tiles of 4 x 64 pixels, more than one a consumer of a grid of one
    block per SM, not a multiple of it; one launch per call."""
    x = torch.randn(*shape, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.05).to(dtype)
    b = (torch.randn(64, generator=cuda, device="cuda") * 0.1).to(dtype) if bias else None
    before = conv64.conv3x3_same.launches
    got = conv64.conv3x3_same(x, w, b)
    assert conv64.conv3x3_same.launches == before + 1
    _close(got, conv64.conv3x3_same_plain(x, w, b), dtype, 1e-4, atol_bf16=1e-5)


def test_conv3x3_bf16_zero_fill_at_edges(cuda):
    """One-hot inputs at each corner, at the middle of each edge and at a tile
    corner inside the image: every output is then a single product, exact in
    float32, so the kernel must equal the plain version bit for bit. A halo
    that TMA did not fill with zeros, or a tap that reads the wrong pixel,
    shows as a wrong or stray value."""
    h, wd = 16, 256
    spots = [(0, 0), (0, wd - 1), (h - 1, 0), (h - 1, wd - 1),
             (0, wd // 2), (h - 1, wd // 2), (h // 2, 0), (h // 2, wd - 1), (4, 64), (3, 63)]
    x = torch.zeros(len(spots), h, wd, 64, device="cuda", dtype=torch.bfloat16)
    for i, (yy, xx) in enumerate(spots):
        x[i, yy, xx, i * 5 % 64] = 1.0
    w = (torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
    got = conv64.conv3x3_same(x, w, None)
    want = conv64.conv3x3_same_plain(x, w, None)
    assert torch.equal(got, want)
    assert int((got != 0).sum()) == int((want != 0).sum()) > 0


def test_conv3x3_rows_bf16_zero_fill_at_edges(cuda):
    """The halo-row mode's one-hot check: an input 1 in each halo row (the
    neighbours' rows) and at the image's corners reaches exactly the output
    rows a VALID conv in H gives it, bit for bit as the plain version."""
    h, wd = 16, 128
    spots = [(0, 0), (0, wd - 1), (h + 1, 0), (h + 1, wd - 1), (1, 64), (h, 63)]
    x = torch.zeros(len(spots), h + 2, wd, 64, device="cuda", dtype=torch.bfloat16)
    for i, (yy, xx) in enumerate(spots):
        x[i, yy, xx, i * 7 % 64] = 1.0
    w = (torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.05).to(torch.bfloat16)
    got = conv64.conv3x3_rows(x, w, None)
    want = conv64.conv3x3_rows_plain(x, w, None)
    assert torch.equal(got, want)
    assert int((got != 0).sum()) == int((want != 0).sum()) > 0


def test_cuda_tensors_the_kernels_do_not_take_raise(cuda):
    g, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(TypeError):
        fused_norm.layer_norm_relu(torch.zeros(4, 64, device="cuda", dtype=torch.float16), g, b)
    with pytest.raises(ValueError):
        fused_norm.layer_norm_relu(torch.zeros(4, 96, device="cuda"), torch.ones(96, device="cuda"),
                                   torch.zeros(96, device="cuda"))
    with pytest.raises(ValueError):
        fused_norm.layer_norm_relu(torch.zeros(64, 4, device="cuda").t(), g, b)
    w = torch.zeros(64, 64, 3, 3, device="cuda")
    with pytest.raises(TypeError):
        conv64.conv3x3_same(torch.zeros(1, 16, 128, 64, device="cuda", dtype=torch.float16),
                            w.half(), None)
    with pytest.raises(ValueError):
        conv64.conv3x3_same(torch.zeros(1, 64, 16, 128, device="cuda").permute(0, 2, 3, 1), w, None)


def test_model_forward_matches_cpu(cuda):
    """A random base-64 depth-1 model on the card equals the same model on the
    CPU (plain versions), at a tile that reaches both kernels."""
    cpu_model, _ = build_super_resolution_unet(0.5, depth_override=1, device="cpu", seed=3)
    with torch.no_grad():  # break the identity start
        for p in cpu_model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.02)
    gpu_model, _ = build_super_resolution_unet(0.5, depth_override=1, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.rand(2, 16, 128, 3, generator=torch.Generator().manual_seed(1))
    before = (fused_norm.layer_norm_relu.launches, conv64.conv3x3_same.launches)
    with torch.inference_mode():
        want = cpu_model(x)
        got = gpu_model(x.cuda()).cpu()
    assert (fused_norm.layer_norm_relu.launches - before[0],
            conv64.conv3x3_same.launches - before[1]) == (8, 4)
    assert (want - x).abs().max() > 1e-2
    assert torch.allclose(got, want, atol=1e-4), (got - want).abs().max().item()
