"""The joint SR + segmentation U-Net on the card.

The joint model at full width (base 64, depth 4, 50,273,348 params) runs K1
and K1's backward at every LN+ReLU pair of its shared encoder, both
decoders and the SR head, and K2 at its 64->64 3x3 convs where the gate
accepts the shape. These tests:

- hold its bf16 forward (both heads) and the gradients of the joint loss at
  64-px tiles against the same model with the plain versions swapped in,
  on the card. Both are compared with the float32 plain model: the
  kernels' bf16 must be as close to float32 as the plain versions' bf16
  (relative L2 error at most twice theirs, plus 1e-3), since a bf16 result
  is the float32 one rounded at every layer and no fixed tolerance in ulps
  survives 30 layers;
- count the launches of one training step at 16 x 128 px tiles, a shape
  K2's gate accepts at level 0: 28 K1, 28 K1 backward and 5 K2.

Every test needs a CUDA GPU and skips without one; a kernel that does not
build fails it:

    python -m pytest tests_gpu -q
"""

import pytest
import torch

from adunet_torch.kernels import conv64, fused_norm
from adunet_torch.losses import charbonnier_loss, make_bce_dice_loss
from adunet_torch.models import build_joint_unet
from adunet_torch.nn import blocks
from adunet_torch.train import create_train_state, make_joint_train_step, make_optimizer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _batch(gen, n, h, w):
    images = torch.rand(n, h, w, 3, generator=gen, device="cuda")
    masks = (images.mean(-1, keepdim=True) > 0.5).float()
    return images, masks


def _model(dtype, state=None):
    model, info = build_joint_unet(0.5, depth_override=4, dtype=dtype, device="cuda", seed=3)
    if state is None:
        with torch.no_grad():  # break the identity start of the SR head
            gen = torch.Generator("cuda").manual_seed(4)
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    else:
        model.load_state_dict(state)
    return model


def _forward_backward(model, images, masks):
    sr, mask = model(images)
    loss = charbonnier_loss(images, sr) + make_bce_dice_loss(0.5, 1.0)(masks, mask)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return sr.detach(), mask.detach(), grads


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def test_bf16_forward_and_backward_match_plain(cuda, monkeypatch):
    images, masks = _batch(cuda, 2, 64, 64)
    base = _model(torch.float32)
    state = {k: v.clone() for k, v in base.state_dict().items()}
    before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches)
    kernel = _forward_backward(_model(torch.bfloat16, state), images, masks)
    assert (fused_norm.layer_norm_relu.launches - before[0],
            fused_norm.layer_norm_relu.backward_launches - before[1]) == (28, 28)
    monkeypatch.setattr(blocks, "layer_norm_relu", fused_norm.layer_norm_relu_plain)
    monkeypatch.setattr(blocks, "conv3x3_same", conv64.conv3x3_same_plain)
    plain = _forward_backward(_model(torch.bfloat16, state), images, masks)
    ref = _forward_backward(_model(torch.float32, state), images, masks)
    assert all(bool(torch.isfinite(t).all()) for t in (*kernel[:2], *kernel[2]))
    for what, k, p, r in (("sr", kernel[0], plain[0], ref[0]), ("mask", kernel[1], plain[1], ref[1])):
        assert _rel(k, r) <= 2 * _rel(p, r) + 1e-3, what
    names = [n for n, _ in base.named_parameters()]
    for name, k, p, r in zip(names, kernel[2], plain[2], ref[2]):
        assert _rel(k, r) <= 2 * _rel(p, r) + 1e-3, name


def test_train_step_launch_counts(cuda):
    """One bf16 training step at 16 x 128 px tiles: K2's gate accepts level
    0's 64->64 convs (enc0.conv1, sr_dec0.conv1, seg_dec0.conv1, both sr_head
    convs); the decoders' conv0 take the 128-channel concat and go to cuDNN."""
    model = _model(torch.bfloat16)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    step = make_joint_train_step(model, charbonnier_loss, make_bce_dice_loss(0.5, 1.0))
    batch = _batch(cuda, 2, 16, 128)
    before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
              conv64.conv3x3_same.launches)
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    after = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
             conv64.conv3x3_same.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (28, 28, 5)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
