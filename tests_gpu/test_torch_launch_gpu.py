"""K1's and K2's launch paths on the card: the weight pack on the card, the
parameters as the model holds them, the no-grad path, the bias gradient
without a float32 copy, and a CUDA graph that captures both kernels.

- K2's C call packs the OIHW weight and the bias into scratch before the
  conv (``pack_conv3x3_weights_kernel``): read back, that scratch must equal
  ``pack_weights`` / ``pack_weights_bf16`` of the weight rounded to x's type,
  bit for bit, and the bias rounded to x's type then widened to float32.
- float32 parameters handed uncast must give what parameters cast by the
  caller gave: the output and dx / dw bit for bit (deterministic cuDNN), db
  to one bf16 ulp (its float32 sum is taken in another order than a sum
  over a float32 copy of the cotangent).
- A model's forward + backward captured in ``torch.cuda.graph`` replays
  bit-equal to an eager run.

Every test needs a CUDA GPU and skips without one; a kernel that does not
build fails it:

    python -m pytest tests_gpu -q
"""

import pytest
import torch

from adunet_torch.kernels import _build, conv64, fused_norm
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.utils import deterministic_cudnn

pytestmark = pytest.mark.gpu

_CODES = {torch.float32: 0, torch.bfloat16: 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_on_the_card_is_the_plain_layout(cuda, dtype, w_dtype, bias_dtype):
    x = torch.randn(1, 16, 128, 64, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.05).to(w_dtype)
    b = None if bias_dtype is None else \
        (torch.randn(64, generator=cuda, device="cuda") * 0.1).to(bias_dtype)
    y = torch.empty_like(x)
    scratch = torch.full((conv64._SCRATCH_BYTES[dtype],), 0xAB, dtype=torch.uint8, device="cuda")
    code = _build.library().adunet_conv3x3_c64(
        x.data_ptr(), w.data_ptr(), _CODES[w_dtype], None if b is None else b.data_ptr(),
        -1 if b is None else _CODES[bias_dtype], scratch.data_ptr(), y.data_ptr(), 1, 16, 128,
        0, _CODES[dtype], 0, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "conv3x3_same")
    torch.cuda.synchronize()
    n = 9 * 64 * 64 * x.element_size()
    wx = w.to(dtype)  # rounded to x's type (nearest even), as a cast rounds
    want_w = conv64.pack_weights_bf16(wx) if dtype == torch.bfloat16 else conv64.pack_weights(wx)
    assert torch.equal(scratch[:n], want_w.contiguous().view(torch.uint8).reshape(-1))
    want_b = torch.zeros(64, device="cuda") if b is None else b.to(dtype).float()
    assert torch.equal(scratch[n:].view(torch.float32), want_b)
    assert torch.equal(y, conv64.conv3x3_same(x, wx, None if b is None else b.to(dtype)))


@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float32_parameters_give_what_cast_parameters_gave(cuda, dtype, halo):
    fn = conv64.conv3x3_rows if halo else conv64.conv3x3_same
    x = torch.randn(4, 32 + 2 * halo, 256, 64, generator=cuda, device="cuda").to(dtype)
    w = torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.05
    b = torch.randn(64, generator=cuda, device="cuda") * 0.1
    gy = torch.randn(4, 32, 256, 64, generator=cuda, device="cuda").to(dtype)
    with deterministic_cudnn():
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*leaves)
        got = torch.autograd.grad(y, leaves, gy)
        ref = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y_cast = fn(ref[0], ref[1].to(dtype), ref[2].to(dtype))
        want = torch.autograd.grad(y_cast, ref, gy)
    assert torch.equal(y, y_cast)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].dtype == want[2].dtype == torch.float32
    ulp = 2.0**-7 * want[2].abs() if dtype == torch.bfloat16 else 1e-6 * want[2].abs().max()
    assert bool(((got[2] - want[2]).abs() <= ulp).all())


def test_bias_gradient_reads_the_bf16_cotangent_without_a_float32_copy(cuda):
    """The bias gradient's sum runs as one reduction kernel on the bf16
    cotangent (no float32 copy of it first; seen on an H100 with torch
    2.11: a memset, then ``reduce_kernel<..., ReduceOp<c10::BFloat16, ...>>``)
    and stays within 1e-6 relative of a float64 sum of the same values."""
    g = torch.randn(8, 64, 256, 64, generator=cuda, device="cuda").to(torch.bfloat16) + 0.25
    conv64._bias_grad_f32(g)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        db = conv64._bias_grad_f32(g)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and "Memset" not in e.key]
    # one reduction that reads bf16 and accumulates in float32 (its memset of
    # the cross-block semaphores aside), no copy
    assert len(kernels) == 1 and "reduce_kernel" in kernels[0] and "BFloat16" in kernels[0], kernels
    want = g.double().sum(dim=(0, 1, 2))
    assert db.dtype == torch.float32
    assert float(((db.double() - want).abs() / want.abs()).max()) <= 1e-6


@pytest.mark.parametrize("kernel", ["layer_norm_relu", "conv3x3_same", "conv3x3_rows"])
def test_no_grad_path_launches_as_the_function_does(cuda, kernel):
    if kernel == "layer_norm_relu":
        args = [torch.randn(4096, 128, generator=cuda, device="cuda").to(torch.bfloat16),
                torch.randn(128, generator=cuda, device="cuda") * 0.2 + 1,
                torch.randn(128, generator=cuda, device="cuda") * 0.2]
        fn = fused_norm.layer_norm_relu

        def count():
            return fused_norm.layer_norm_relu.launches
    else:
        args = [torch.randn(2, 16 + 2 * (kernel == "conv3x3_rows"), 128, 64, generator=cuda,
                            device="cuda").to(torch.bfloat16),
                torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.05,
                torch.randn(64, generator=cuda, device="cuda") * 0.1]
        fn = getattr(conv64, kernel)

        def count():
            return fn.launches
    before = count()
    with torch.no_grad():
        off = fn(*[t.clone().requires_grad_(True) for t in args])
    on = fn(args[0].clone().requires_grad_(True), *args[1:])
    assert off.grad_fn is None and on.grad_fn is not None
    assert torch.equal(off, on.detach()) and count() == before + 2


def test_graph_replay_equals_eager(cuda):
    """A bf16 SR model (base 64, depth 1) at 2 x 16 x 128 px tiles, where
    K1, its backward and K2 all run: one forward + backward captured after
    three eager runs on a side stream, replayed twice, bit-equal to eager."""
    model, _ = build_super_resolution_unet(0.5, depth_override=1, dtype=torch.bfloat16,
                                           device="cuda", seed=3)
    with torch.no_grad():  # break the identity start
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=cuda, device="cuda") * 0.02)
    x = torch.rand(2, 16, 128, 3, generator=cuda, device="cuda")
    params = list(model.parameters())

    def fwd_bwd():
        for p in params:
            p.grad = None
        y = model(x)
        loss = (y.float() - x).square().mean()
        loss.backward()
        return y.detach(), loss.detach()

    with deterministic_cudnn():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fwd_bwd()
        torch.cuda.current_stream().wait_stream(side)
        y_e, loss_e = (t.clone() for t in fwd_bwd())
        grads_e = [p.grad.clone() for p in params]
        graph = torch.cuda.CUDAGraph()
        before = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
                  conv64.conv3x3_same.launches)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            y_s, loss_s = fwd_bwd()
        after = (fused_norm.layer_norm_relu.launches, fused_norm.layer_norm_relu.backward_launches,
                 conv64.conv3x3_same.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (8, 8, 4)  # the capture's
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y_s, y_e) and torch.equal(loss_s, loss_e)
            for p, want in zip(params, grads_e):
                assert torch.equal(p.grad, want)
