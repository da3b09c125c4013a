"""K1 at the deep config's widths and the deep / vanilla SR steps on the card.

The deep config (scale 0.8, depth 5) runs K1 at C = 1024 (its level 4) and
C = 2048 (its bottleneck), where a lane holds 32 and 64 values of a row and
the backward kernel keeps its per-lane partial sums in shared memory. These
tests hold both kernels there: one row, row counts that leave a block
part-filled, the deep config's own row counts at batch 8, a dead row, and
dgamma / dbeta bit for bit over two runs in float32 and bf16. Then a float32
step of a depth-5 model with and without ``remat_levels`` (gradients within
1e-5 relative L2), and a float32 step of the vanilla SR U-Net against the
CPU at the BatchNorm tolerances.
Every test needs a CUDA GPU and skips without one:

    python -m pytest tests_gpu -q

Tolerances as ``test_torch_autograd_gpu.py``'s (relative to the largest
|value| of each tensor): K1 forward float32 1e-5, bf16 one bf16 ulp plus
1e-6; dx 1e-5 (float32) / one bf16 ulp plus 1e-4 (bf16) outside the rows
whose ReLU masks disagree; dgamma / dbeta 1e-3, computed again over the rows
without a disagreement where there is one (a disagreeing element moves its
column's sums by its cotangent; at 57,800 x 2048 one in 118 M elements is
enough to pass 1e-3).
"""

import numpy as np
import pytest
import torch

from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.losses import charbonnier_loss
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step

from test_torch_autograd_gpu import (_close, _k1_bwd_inputs, _k1_dx_close, _k1_forward_close,
                                     _k1_params_close)

pytestmark = pytest.mark.gpu


# the deep config's rows at batch 8 x 256 px: level 4 (106 px) and the
# bottleneck (85 px)
DEEP_ROWS = {1024: 8 * 106 * 106, 2048: 8 * 85 * 85}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 2048])
@pytest.mark.parametrize("rows", ["one", "ragged", "deep", "deep_ragged"])
def test_wide_rows_forward_and_backward_match_plain(cuda, dtype, c, rows):
    n = {"one": 1, "ragged": 8 * 3 + 5, "deep": DEEP_ROWS[c], "deep_ragged": DEEP_ROWS[c] - 3}[rows]
    x, g, b, gy = _k1_bwd_inputs(cuda, n, c, dtype)
    before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches)
    _k1_forward_close(x, g, b, dtype)
    dx, dg, db = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert (fused_norm.layer_norm_relu.launches,
            fused_norm.layer_norm_relu.backward_launches) == (before[0] + 1, before[1] + 1)
    want = fused_norm.layer_norm_relu_backward(x, g, b, gy)
    _k1_dx_close(x, g, b, dx, want[0], 1e-5 if dtype == torch.float32 else 1e-4)
    _k1_params_close(x, g, b, gy, dg, db)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 2048])
def test_wide_rows_dead_row_is_zero(cuda, dtype, c):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 2048])
def test_wide_rows_parameter_sums_are_deterministic(cuda, c, dtype):
    x, g, b, gy = _k1_bwd_inputs(cuda, DEEP_ROWS[c], c, dtype)
    first = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    second = fused_norm._launch_backward(x, g, b, gy, 1e-3)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_deep_step_gradients_equal_with_and_without_remat(cuda):
    """A perturbed scale-0.8 depth-5 model (base 16, 128 px, float32): the
    gradients of one step with ``remat_levels=2`` equal those without within
    1e-5 relative L2 per leaf; the recompute launches K1 again for the
    checkpointed blocks' 8 LN+ReLU pairs."""
    hr = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    grads, counts, base = {}, {}, None
    for levels in (None, 2):
        model, _ = build_super_resolution_unet(0.8, base_channels=16, residual_head_channels=16,
                                               depth_override=5, remat_levels=levels,
                                               device="cuda", seed=2)
        if base is None:
            with torch.no_grad():
                gen = torch.Generator("cuda").manual_seed(3)
                for p in model.parameters():
                    p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
            base = {n: v.clone() for n, v in model.state_dict().items()}
        else:
            model.load_state_dict(base)
        before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches)
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        make_sr_train_step(model, charbonnier_loss)(state, hr)
        counts[levels] = (fused_norm.layer_norm_relu.launches - before[0],
                          fused_norm.layer_norm_relu.backward_launches - before[1])
        grads[levels] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    assert counts == {None: (24, 24), 2: (32, 24)}
    for name, g in grads[None].items():
        rel = float((grads[2][name] - g).norm() / g.norm())
        assert rel <= 1e-5, (name, rel)


def test_vanilla_sr_step_matches_cpu(cuda):
    """The vanilla SR U-Net (base 64, depth 2, 128 px: K2 at enc0.conv1 and
    dec0.conv1) with the combined loss over the seeded VGG19 tower: one
    float32 step on the card against the CPU. Gradients 2e-2 in relative L2
    norm (float32 keeps a BatchNorm model's gradients to ~5e-3); the biases
    of convs that feed a BatchNorm (true gradient 0) within 2e-4 of the
    largest gradient norm."""
    from adunet_torch.losses import build_losses_and_metrics, make_perceptual_fn
    from adunet_torch.models import build_vanilla_sr_unet
    from adunet_torch.train import make_vanilla_sr_train_step

    def setup(device):
        model = build_vanilla_sr_unet(base_channels=64, depth=2, device=device, seed=5)
        loss, _ = build_losses_and_metrics(
            "combined", perceptual_fn=make_perceptual_fn(None, 128, device=device))
        return model, loss

    (cpu_model, cpu_loss), (gpu_model, gpu_loss) = setup("cpu"), setup("cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(4)
    hr = rng.random((2, 128, 128, 3), dtype=np.float32)
    lr = np.clip(hr + 0.05 * rng.normal(size=hr.shape), 0, 1).astype(np.float32)
    before = conv64.conv3x3_same.launches
    losses = []
    for model, loss in ((gpu_model, gpu_loss), (cpu_model, cpu_loss)):
        state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
        losses.append(float(make_vanilla_sr_train_step(model, loss)(state, (lr, hr))[1]["loss"]))
    assert conv64.conv3x3_same.launches - before == 2
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    pre_bn = {n.replace("norm", "conv").replace("running_mean", "bias")
              for n, _ in cpu_model.named_buffers() if n.endswith("running_mean")}
    top = max(p.grad.norm() for p in cpu_model.parameters())
    for (name, pg), pc in zip(gpu_model.named_parameters(), cpu_model.parameters()):
        err = (pg.grad.cpu() - pc.grad).norm()
        assert err <= (2e-4 * top if name in pre_bn else 2e-2 * pc.grad.norm()), name
    for (name, bg), bc in zip(gpu_model.named_buffers(), cpu_model.buffers()):
        assert torch.allclose(bg.cpu(), bc, rtol=1e-4, atol=1e-5), name
