"""K1 with a library conv's bias on the card: the ``conv_bias`` argument of
``layer_norm_relu`` (the forward and backward kernels' ``kBias``
instantiations) and the launches a training step makes through it.

- Forward: K1 with the bias (in x's type, as ``ConvBlock`` passes it)
  equals PyTorch's own add of it (what the library conv did after cuDNN)
  followed by K1 without one, bit for bit, at every C of
  ``SUPPORTED_CHANNELS``, float32 and bf16.
- Backward: its ReLU mask is the biased forward kernel's, bit for bit, at
  every C; dx within 1e-5 (float32) / 1e-4 plus one bf16 ulp of the
  unbiased backward kernel's on that sum (at C = 512 the two take different
  paths, so their float32 sums round otherwise), dgamma / dbeta within 1e-3
  relative of it (the grids differ, so their sums run in another order),
  and within 1e-3 of the plain version's outside the rows whose ReLU masks
  differ from the plain version's; dbias within 1e-3 relative plus one bf16
  ulp of the plain version's and of dx summed as the conv's backward sums
  its bias gradient (a sum over the rows in x's type).
- Steps: a compiled flagship step (depth 3) takes 12 of its 16 K1 forward
  and backward launches with a bias (the 4 others follow K2's convs); a deep
  step (depth 5, full remat) 40 of 48 forward and 20 of 24 backward. The
  counts hold over eager calls, the capture and replays.

Every test needs a CUDA GPU and skips without one:

    python -m pytest tests_gpu -q
"""

import pytest
import torch

from adunet_torch.kernels import fused_norm, launch_snapshot, launches_since
from adunet_torch.losses import charbonnier_loss
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _inputs(gen, rows, c, dtype):
    x = (torch.randn(rows, c, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.3 + 1
    beta = torch.randn(c, generator=gen, device="cuda") * 0.3
    bias = (torch.randn(c, generator=gen, device="cuda") * 0.7).to(dtype)
    gy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
    return x, gamma, beta, bias, gy


def _close(got, want, rel):
    g, w = got.float(), want.float()
    ulp = 2.0**-7 * w.abs() if got.dtype == torch.bfloat16 else 0.0
    assert bool(((g - w).abs() <= ulp + rel * w.abs().max()).all()), \
        ((g - w).abs().max() / w.abs().max()).item()


def _rows(rows, c):
    return (1 << 24) // c + 5 if rows == "waves" else rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", fused_norm.SUPPORTED_CHANNELS)
@pytest.mark.parametrize("rows", [1, 8 * 4 * 3 + 5, "waves"])
def test_biased_forward_is_the_add_then_k1(cuda, dtype, c, rows):
    x, gamma, beta, bias, _ = _inputs(cuda, _rows(rows, c), c, dtype)
    before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.bias_launches)
    got = fused_norm.layer_norm_relu(x, gamma, beta, 1e-3, bias)
    assert (fused_norm.layer_norm_relu.launches,
            fused_norm.layer_norm_relu.bias_launches) == (before[0] + 1, before[1] + 1)
    want = fused_norm.layer_norm_relu(x + bias, gamma, beta)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", fused_norm.SUPPORTED_CHANNELS)
@pytest.mark.parametrize("rows", [1, 8 * 4 * 3 + 5, "waves"])
def test_biased_backward_matches_the_unbiased_kernel_and_plain(cuda, dtype, c, rows):
    x, gamma, beta, bias, gy = _inputs(cuda, _rows(rows, c), c, dtype)
    xb = x + bias
    before = (fused_norm.layer_norm_relu.backward_launches,
              fused_norm.layer_norm_relu.bias_backward_launches)
    dx, dg, db, dbias = fused_norm._launch_backward(x, gamma, beta, gy, 1e-3, bias)
    assert (fused_norm.layer_norm_relu.backward_launches,
            fused_norm.layer_norm_relu.bias_backward_launches) == (before[0] + 1, before[1] + 1)
    assert (dx.dtype, dg.dtype, db.dtype, dbias.dtype) == (dtype, torch.float32, torch.float32,
                                                           dtype)
    ref_dx, ref_dg, ref_db = fused_norm._launch_backward(xb, gamma, beta, gy, 1e-3)
    _close(dx, ref_dx, 1e-5 if dtype == torch.float32 else 1e-4)
    # the rows where the kernels' ReLU mask differs from the plain version's
    with torch.no_grad():
        flips = ((fused_norm.layer_norm_relu(xb, gamma, beta) > 0)
                 != (fused_norm.layer_norm_relu_plain(xb, gamma, beta) > 0))
    assert int(flips.sum()) <= 1e-5 * flips.numel() + 1
    keep = ~flips.any(dim=1)
    _close(dg, ref_dg, 1e-3)
    _close(db, ref_db, 1e-3)
    plain = fused_norm.layer_norm_relu_backward(x[keep], gamma, beta, gy[keep], 1e-3, bias)
    kept = fused_norm._launch_backward(x[keep], gamma, beta, gy[keep], 1e-3, bias)
    for a, b in zip(kept[1:], plain[1:]):
        _close(a, b, 1e-3)
    # the conv's backward: the bias gradient as a sum of the cotangent over
    # the rows in x's type
    _close(dbias, dx.sum(dim=0), 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", fused_norm.SUPPORTED_CHANNELS)
def test_biased_backward_mask_is_the_forward_kernels(cuda, dtype, c):
    """As ``test_layer_norm_relu_backward_mask_is_the_forward_kernels`` with
    a conv bias: pre-activations within a rounding of 0 at every other
    column of x plus the bias; with one row and a cotangent of 1, dbeta is
    exactly the backward's mask, which must be the forward kernel's."""
    for seed in range(4):
        gen = torch.Generator("cuda").manual_seed(seed)
        x = (torch.randn(1, c, generator=gen, device="cuda") * 3 + 1).to(dtype)
        bias = (torch.randn(c, generator=gen, device="cuda") * 0.7).to(dtype)
        gamma = torch.randn(c, generator=gen, device="cuda") * 0.2 + 1
        beta = torch.randn(c, generator=gen, device="cuda") * 0.2
        xf = (x + bias)[0].float()
        dev = xf - xf.mean()
        xhat = dev * torch.rsqrt(dev.square().mean() + 1e-3)
        beta[::2] = -(xhat * gamma)[::2]
        dbeta = fused_norm._launch_backward(x, gamma, beta, torch.ones_like(x), 1e-3, bias)[2]
        y = fused_norm.layer_norm_relu(x, gamma, beta, 1e-3, bias)[0]
        assert bool((y[::2].float() <= 1e-4).all())  # the edge is what is tested
        assert torch.equal(dbeta, (y > 0).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_biased_backward_sums_are_deterministic(cuda, dtype):
    x, gamma, beta, bias, gy = _inputs(cuda, 300_001, 64, dtype)
    first = fused_norm._launch_backward(x, gamma, beta, gy, 1e-3, bias)
    second = fused_norm._launch_backward(x, gamma, beta, gy, 1e-3, bias)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("kind, per_step", [("flagship", (12, 12)), ("deep", (40, 20))])
def test_train_step_counts_its_biased_launches(cuda, kind, per_step):
    """4 calls of the compiled step: 2 eager, the capture, a replay."""
    scale, depth, remat = {"flagship": (0.5, 3, False), "deep": (0.8, 5, True)}[kind]
    model, _ = build_super_resolution_unet(scale, depth_override=depth, dtype=torch.bfloat16,
                                           remat=remat, device="cuda", seed=0)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_sr_train_step(model, charbonnier_loss)
    hr = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(1))
    before = launch_snapshot()
    for _ in range(4):
        state, metrics = step(state, hr)
    torch.cuda.synchronize()
    assert launches_since(before)[7:9] == tuple(4 * n for n in per_step)
    assert torch.isfinite(metrics["loss"]).all()
