"""The port's autograd Functions and a train step on the card.

``chip_smoke.py`` holds each Function's gradients against autograd through
its plain version at the flagship's shapes; these tests add the edges: row
counts that do not fill a K1 block, several K2 tiles per image and batch,
bf16, a conv without bias, and the whole model's gradients and one Adam step
on the card against the same model on the CPU. Every test needs a CUDA GPU
and skips without one:

    python -m pytest tests_gpu -q

Tolerances, relative to the largest |value| of each tensor: K1 dx 1e-5
(float32) and one bf16 ulp per element plus 1e-4 (bf16); K2 dx 1e-4 (cuDNN's
float32 algorithms, TF32 off); parameter gradients 1e-3 (float32 sums in
another order, plus one bf16 ulp for bf16 dw / db); model gradients 1e-3 in
relative L2 norm. K1's backward kernel shares the forward kernel's ReLU mask,
whose float32 warp sums round otherwise than the plain version's ``mean``: an
element within a rounding of 0 can be in one mask and not in the other, and
it moves its whole row's dx. Such rows (at most 1e-5 of the elements may
disagree) are left out of the dx comparison, and, where the backward kernel
alone runs at the larger row counts, out of the dgamma / dbeta comparison.
"""

import pytest
import torch

from adunet_torch.kernels import conv64, fused_norm
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


def _close(got, want, rel):
    g, w = got.float(), want.float()
    ulp = 2.0**-7 * w.abs() if got.dtype == torch.bfloat16 else 0.0
    assert got.dtype == want.dtype
    assert bool(((g - w).abs() <= ulp + rel * w.abs().max()).all()), \
        ((g - w).abs().max() / w.abs().max()).item()


def _k1_dx_close(x, g, b, got, want, rel):
    """``_close`` on K1's dx outside the rows where the kernel's and the plain
    forward's ReLU masks disagree."""
    c = x.shape[-1]
    with torch.no_grad():
        flips = ((fused_norm.layer_norm_relu(x, g, b) > 0)
                 != (fused_norm.layer_norm_relu_plain(x, g, b) > 0)).reshape(-1, c)
    assert int(flips.sum()) <= 1e-5 * flips.numel() + 1
    keep = ~flips.any(dim=1)
    _close(got.reshape(-1, c)[keep], want.reshape(-1, c)[keep], rel)


def _k1_params_close(x, g, b, gy, dg, db):
    """dgamma / dbeta against the plain backward's, over the rows where the
    kernel's and the plain forward's ReLU masks agree (the masks are
    row-local, so the kernel on those rows alone has the plain mask). One
    element whose masks disagree moves its column's sums by its cotangent:
    among 16 M elements, enough to pass 1e-3."""
    c = x.shape[-1]
    with torch.no_grad():
        flips = ((fused_norm.layer_norm_relu(x, g, b) > 0)
                 != (fused_norm.layer_norm_relu_plain(x, g, b) > 0)).reshape(-1, c)
    if bool(flips.any()):
        keep = ~flips.any(dim=1)
        x, gy = x[keep], gy[keep]
        dg, db = fused_norm._launch_backward(x, g, b, gy, 1e-3)[1:]
    want = fused_norm.layer_norm_relu_backward(x, g, b, gy)
    _close(dg, want[1], 1e-3)
    _close(db, want[2], 1e-3)


def _grads(fn, inputs, gy):
    return torch.autograd.grad(fn(*inputs), inputs, gy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (37, 128), (3, 7, 11, 256), (5, 512), (77, 1024)])
def test_layer_norm_relu_grads_match_plain(cuda, dtype, shape):
    c = shape[-1]
    x = (torch.randn(*shape, generator=cuda, device="cuda") * 3 + 1).to(dtype).requires_grad_(True)
    g = (torch.randn(c, generator=cuda, device="cuda") * 0.2 + 1).requires_grad_(True)
    b = (torch.randn(c, generator=cuda, device="cuda") * 0.2).requires_grad_(True)
    gy = torch.randn(*shape, generator=cuda, device="cuda").to(dtype)
    before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches)
    got = _grads(fused_norm.layer_norm_relu, [x, g, b], gy)
    assert (fused_norm.layer_norm_relu.launches,
            fused_norm.layer_norm_relu.backward_launches) == (before[0] + 1, before[1] + 1)
    want = _grads(fused_norm.layer_norm_relu_plain, [x, g, b], gy)
    _k1_dx_close(x, g, b, got[0], want[0], 1e-5 if dtype == torch.float32 else 1e-4)
    for a, w in zip(got[1:], want[1:]):
        _close(a, w, 1e-3)


def _k1_bwd_inputs(gen, rows, c, dtype):
    x = (torch.randn(rows, c, generator=gen, device="cuda") * 3 + 1).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.2 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.2
    gy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
    return x, g, b, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", fused_norm.SUPPORTED_CHANNELS)
@pytest.mark.parametrize("rows", [1, 8 * 4 * 3 + 5, "waves"])
def test_layer_norm_relu_backward_kernel_matches_plain(cuda, dtype, c, rows):
    """The backward kernel alone against ``layer_norm_relu_backward``, at
    every C, at one row, at a row count that fills no block evenly, and at
    2^24 / C + 5 rows ("waves"), which the grid-stride loop of a grid sized
    to the card walks in several turns at every C (about 8 at C = 2048, 15
    at C = 64 in bf16 on an H100), each block's partial in the scratch
    covering many rows."""
    if rows == "waves":
        rows = (1 << 24) // c + 5
    x, g, b, gy = _k1_bwd_inputs(cuda, rows, c, dtype)
    before = fused_norm.layer_norm_relu.backward_launches
    dx, dg, db = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert fused_norm.layer_norm_relu.backward_launches == before + 1
    want = fused_norm.layer_norm_relu_backward(x, g, b, gy)
    assert (dx.dtype, dg.dtype, db.dtype) == (dtype, torch.float32, torch.float32)
    _k1_dx_close(x, g, b, dx, want[0], 1e-5 if dtype == torch.float32 else 1e-4)
    _k1_params_close(x, g, b, gy, dg, db)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_relu_backward_dead_row_is_zero(cuda, dtype):
    """A constant row normalises to 0, so with beta < 0 its pre-activation
    is negative everywhere: no gradient passes the ReLU and dx is exactly 0
    there, while the other rows match the plain version."""
    x, g, b, gy = _k1_bwd_inputs(cuda, 37, 64, dtype)
    b = -b.abs() - 0.1
    x[5] = 0.75
    dx, dg, db = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert bool((dx[5] == 0).all())
    want = fused_norm.layer_norm_relu_backward(x, g, b, gy)
    _k1_dx_close(x, g, b, dx, want[0], 1e-5 if dtype == torch.float32 else 1e-4)
    _close(dg, want[1], 1e-3)
    _close(db, want[2], 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_relu_backward_parameter_sums_are_deterministic(cuda, dtype):
    """dgamma / dbeta come from a two-level sum in a fixed order, no atomics:
    two runs on the same inputs agree bit for bit."""
    x, g, b, gy = _k1_bwd_inputs(cuda, 300_001, 64, dtype)
    first = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    second = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", fused_norm.SUPPORTED_CHANNELS)
def test_layer_norm_relu_backward_mask_is_the_forward_kernels(cuda, dtype, c):
    """The backward kernel's ReLU mask is the forward kernel's output > 0,
    bit for bit, where pre-activations lie within a rounding of 0: beta is
    -xhat * gamma at every other column, xhat from the plain float32
    statistics (the kernels' warp sums round otherwise, so the kernels'
    pre-activations there are a rounding either side of 0, or 0). With one
    row and a cotangent of 1, dbeta is exactly the backward's mask."""
    for seed in range(4):
        gen = torch.Generator("cuda").manual_seed(seed)
        x = (torch.randn(1, c, generator=gen, device="cuda") * 3 + 1).to(dtype)
        gamma = torch.randn(c, generator=gen, device="cuda") * 0.2 + 1
        beta = torch.randn(c, generator=gen, device="cuda") * 0.2
        xf = x[0].float()
        dev = xf - xf.mean()
        xhat = dev * torch.rsqrt(dev.square().mean() + 1e-3)
        beta[::2] = -(xhat * gamma)[::2]
        _, _, dbeta = fused_norm._launch_backward(x, gamma, beta, torch.ones_like(x), 1e-3)
        y = fused_norm.layer_norm_relu(x, gamma, beta)[0]
        assert bool((y[::2].float() <= 1e-4).all())  # the edge is what is tested
        assert torch.equal(dbeta, (y > 0).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, bias", [((1, 16, 128, 64), True), ((3, 24, 384, 64), True),
                                         ((2, 64, 256, 64), False)])
def test_conv3x3_grads_match_plain(cuda, dtype, shape, bias):
    x = torch.randn(*shape, generator=cuda, device="cuda").to(dtype).requires_grad_(True)
    w = (torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.05).to(dtype).requires_grad_(True)
    b = (torch.randn(64, generator=cuda, device="cuda") * 0.1).to(dtype).requires_grad_(True) if bias else None
    inputs = [t for t in (x, w, b) if t is not None]
    gy = torch.randn(*shape, generator=cuda, device="cuda").to(dtype)
    before = conv64.conv3x3_same.launches
    got = torch.autograd.grad(conv64.conv3x3_same(x, w, b), inputs, gy)
    assert conv64.conv3x3_same.launches == before + 1
    want = torch.autograd.grad(conv64.conv3x3_same_plain(x, w, b), inputs, gy)
    for a, ref, rel in zip(got, want, (1e-4, 1e-3, 1e-3)):
        _close(a, ref, rel)


def test_model_train_step_matches_cpu(cuda):
    """A perturbed base-64 depth-1 model: one float32 Adam step on the card
    (both kernels, forward and backward) against the same step on the CPU."""
    cpu_model, _ = build_super_resolution_unet(0.5, depth_override=1, device="cpu", seed=3)
    with torch.no_grad():  # break the identity start
        for p in cpu_model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.02)
    gpu_model, _ = build_super_resolution_unet(0.5, depth_override=1, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    hr = torch.rand(2, 16, 128, 3, generator=torch.Generator().manual_seed(1))
    losses = []
    before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
              conv64.conv3x3_same.launches)
    for model in (gpu_model, cpu_model):
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        losses.append(float(make_sr_train_step(model, charbonnier_loss)(state, hr)[1]["loss"]))
    assert (fused_norm.layer_norm_relu.launches - before[0],
            fused_norm.layer_norm_relu.backward_launches - before[1],
            conv64.conv3x3_same.launches - before[2]) == (8, 8, 4)
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for (name, pg), pc in zip(gpu_model.named_parameters(), cpu_model.parameters()):
        rel = ((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()).item()
        assert rel <= 1e-3, (name, rel)
        assert (pg.detach().cpu() - pc.detach()).abs().max() <= 2e-4 + 1e-6, name


def _k1_forward_close(x, g, b, dtype):
    """K1's forward against its plain version: float32 1e-5, bf16 one bf16
    ulp plus 1e-6 (as ``test_torch_kernels_gpu``)."""
    got = fused_norm.layer_norm_relu(x, g, b)
    want = fused_norm.layer_norm_relu_plain(x, g, b)
    limit = 1e-5 if dtype == torch.float32 else 2.0**-7 * want.float().abs() + 1e-6
    assert got.dtype == want.dtype
    assert bool(((got.float() - want.float()).abs() <= limit).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("rows", [1, 5, 8 * 16 + 3, 524_288])
def test_narrow_rows_forward_and_backward_match_plain(cuda, dtype, c, rows):
    """C = 16 and 32, where several rows share a warp: one row, a warp that
    is partly past the last row, a block that is, and the vanilla
    segmentation U-Net's first level at batch 8 (524,288 rows)."""
    x, g, b, gy = _k1_bwd_inputs(cuda, rows, c, dtype)
    before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches)
    _k1_forward_close(x, g, b, dtype)
    dx, dg, db = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert (fused_norm.layer_norm_relu.launches,
            fused_norm.layer_norm_relu.backward_launches) == (before[0] + 1, before[1] + 1)
    want = fused_norm.layer_norm_relu_backward(x, g, b, gy)
    _k1_dx_close(x, g, b, dx, want[0], 1e-5 if dtype == torch.float32 else 1e-4)
    _close(dg, want[1], 1e-3)
    _close(db, want[2], 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 32])
def test_narrow_rows_dead_row_is_zero(cuda, dtype, c):
    """A dead row (constant, beta < 0) in the middle of a warp and as the last
    row of a part-filled warp: its dx is exactly 0, the other rows match."""
    x, g, b, gy = _k1_bwd_inputs(cuda, 37, c, dtype)
    b = -b.abs() - 0.1
    x[5] = 0.75
    x[36] = -0.5
    dx, dg, db = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert bool((dx[5] == 0).all()) and bool((dx[36] == 0).all())
    assert bool((fused_norm.layer_norm_relu(x, g, b)[[5, 36]] == 0).all())
    want = fused_norm.layer_norm_relu_backward(x, g, b, gy)
    _k1_dx_close(x, g, b, dx, want[0], 1e-5 if dtype == torch.float32 else 1e-4)
    _close(dg, want[1], 1e-3)
    _close(db, want[2], 1e-3)


@pytest.mark.parametrize("c", [16, 32])
def test_narrow_rows_parameter_sums_are_deterministic(cuda, c):
    """The row groups of a warp add their dgamma / dbeta partials in a fixed
    order: two runs agree bit for bit."""
    x, g, b, gy = _k1_bwd_inputs(cuda, 300_001, c, torch.bfloat16)
    first = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    second = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("kind", ["protocol", "vanilla"])
def test_seg_train_step_matches_cpu(cuda, kind):
    """One float32 step of each segmentation model on the card (BatchNorm or
    K1 at C = 32, ConvTranspose, K2 at its gated shapes) against the CPU.
    Gradients 1e-3 in relative L2 norm for the vanilla model and 2e-2 for
    the BatchNorm model, whose float32 gradients hold only ~5e-3 against
    float64 (``scripts/torch_seg_grad_precision.py``). The biases of convs
    that feed a BatchNorm have a true gradient of 0 (the norm removes any
    per-channel shift), so they are held in absolute terms, within 2e-4 of
    the largest gradient norm."""
    from adunet_torch.losses import binary_crossentropy
    from adunet_torch.models import build_adaptive_depth_unet, build_unet
    from adunet_torch.train import make_seg_train_step

    def build(device):
        if kind == "protocol":
            return build_adaptive_depth_unet(128, 64, 2, device=device, seed=5)
        return build_unet(256, base_channels=32, depth=2, device=device, seed=5)

    cpu_model, gpu_model = build("cpu"), build("cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    size = 128 if kind == "protocol" else 256
    gen = torch.Generator().manual_seed(2)
    images = torch.rand(2, size, size, 3, generator=gen)
    masks = (images.mean(-1, keepdim=True) > 0.5).float()
    before = (fused_norm.layer_norm_relu.launches, conv64.conv3x3_same.launches)
    losses = []
    for model in (gpu_model, cpu_model):
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        losses.append(float(make_seg_train_step(model, binary_crossentropy, augment="none")(
            state, (images, masks))[1]["loss"]))
    assert (fused_norm.layer_norm_relu.launches - before[0],
            conv64.conv3x3_same.launches - before[1]) == ((0, 2) if kind == "protocol" else (10, 2))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    pre_bn = {n.replace("norm", "conv").replace("running_mean", "bias")
              for n, _ in cpu_model.named_buffers() if n.endswith("running_mean")}
    top = max(p.grad.norm() for p in cpu_model.parameters())
    for (name, pg), pc in zip(gpu_model.named_parameters(), cpu_model.parameters()):
        err = (pg.grad.cpu() - pc.grad).norm()
        rel = 2e-2 if kind == "protocol" else 1e-3
        assert err <= (2e-4 * top if name in pre_bn else rel * pc.grad.norm()), name
    for (name, bg), bc in zip(gpu_model.named_buffers(), cpu_model.buffers()):
        assert torch.allclose(bg.cpu(), bc, rtol=1e-4, atol=1e-5), name
