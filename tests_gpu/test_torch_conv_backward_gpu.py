"""K2's backward kernels on the card (``conv64.conv3x3_same_backward``).

Each call of the backward on CUDA tensors is one C call of the weight pack
and the forward kernel on the cotangent (dx; bf16 reads the forward's pack
transposed, float32 a flipped pack), the dw + db partials (bf16: one row a
cluster of blocks) and their fixed-order sum. These tests hold it against ``conv3x3_same_backward_plain``
on the same tensors: both types, the SAME and the halo-row mode (whose dx
has H + 2 rows, a ragged last tile for the bf16 kernel), every ``need_*``
subset, float32 and bf16 parameters, two calls bit for bit, a CUDA graph of
forward + backward replayed against eager, and a profiled flagship step in
which no 64 -> 64 3x3 convolution's backward reaches the library. Every test
needs a CUDA GPU and skips without one. Run on a GPU machine from the
repository root:

    python -m pytest tests_gpu/test_torch_conv_backward_gpu.py -q

Tolerances (``chip_smoke.check_backward``'s), relative to the largest |value|
of the tensor: dx 1e-4, plus one bf16 ulp per element where x is bf16 (the
tensor cores and the plain matmuls add the 576 products in other orders and
round each to bf16); dw and db 1e-3 (float32 sums over up to 2,097,152
pixels in another order), plus one bf16 ulp where they were rounded to bf16.
"""

import pytest
import torch

from adunet_torch.kernels import conv64

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _close(what, got, want, rel, x_dtype):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.float(), want.float()
    ulp = 2.0**-7 * w.abs() if x_dtype == torch.bfloat16 else 0.0
    err = (g - w).abs()
    limit = ulp + rel * w.abs().max()
    assert bool(torch.isfinite(g).all()), what
    assert bool((err <= limit).all()), f"{what}: max |err| / max |want| {(err.max() / w.abs().max()).item():.3e}"


def _inputs(gen, shape, dtype, halo, w_dtype=torch.float32):
    b, h, wd, c = shape
    x = torch.randn(b, h + 2 * halo, wd, c, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05).to(w_dtype)
    g = torch.randn(b, h, wd, c, generator=gen, device="cuda").to(dtype)
    return x, w, g


# the last two: more tiles than a grid (320 of 4 x 64 pixels: not a multiple
# of one block per SM, nor of the bf16 wgrad's clusters' blocks), and fewer
# tiles than SMs (108; the halo dx's 126, its last tile row ragged)
CASES = [((2, 16, 128, 64), 0), ((3, 24, 256, 64), 0), ((2, 16, 128, 64), 1), ((1, 32, 256, 64), 1),
         ((5, 64, 256, 64), 0), ((3, 24, 384, 64), 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, halo", CASES)
def test_backward_matches_plain(cuda, dtype, shape, halo):
    x, w, g = _inputs(cuda, shape, dtype, halo)
    got = conv64.conv3x3_same_backward(x, w, g, pad_h=1 - halo)
    want = conv64.conv3x3_same_backward_plain(x, w, g, pad_h=1 - halo)
    torch.cuda.synchronize()
    assert got[0].shape == x.shape
    for name, a, b, rel in zip(("dx", "dw", "db"), got, want, (1e-4, 1e-3, 1e-3)):
        _close(f"{name} {shape} halo={halo} {dtype}", a, b, rel, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_hot_cotangent_at_every_corner(cuda, dtype):
    """A single 1 in the cotangent at each corner and edge of the image
    (zero fill of the shifted reads and of the ragged halo dx): dx is the
    flipped kernel placed there, dw the x pixels its taps read."""
    for halo in (0, 1):
        b, h, wd = 1, 16, 128
        x, w, _ = _inputs(cuda, (b, h, wd, 64), dtype, halo)
        for yy, xx in [(0, 0), (0, wd - 1), (h - 1, 0), (h - 1, wd - 1), (h // 2, 63), (3, 64)]:
            g = torch.zeros(b, h, wd, 64, device="cuda", dtype=dtype)
            g[0, yy, xx, 5] = 1
            got = conv64.conv3x3_same_backward(x, w, g, pad_h=1 - halo)
            want = conv64.conv3x3_same_backward_plain(x, w, g, pad_h=1 - halo)
            for name, a, c in zip(("dx", "dw", "db"), got, want):
                _close(f"{name} one-hot ({yy}, {xx}) halo={halo}", a, c, 1e-5, dtype)


@pytest.mark.parametrize("need", [(True, False, False), (False, True, False), (False, False, True),
                                  (True, True, False), (False, True, True), (True, False, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_need_subsets(cuda, dtype, need):
    x, w, g = _inputs(cuda, (2, 16, 128, 64), dtype, 0)
    got = conv64.conv3x3_same_backward(x, w, g, *need)
    full = conv64.conv3x3_same_backward(x, w, g)
    for asked, a, f in zip(need, got, full):
        assert (a is not None) == asked
        if asked:
            assert torch.equal(a, f)


@pytest.mark.parametrize("w_dtype, b_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16),
                                              (torch.bfloat16, torch.float32)])
def test_parameter_dtypes(cuda, w_dtype, b_dtype):
    x, w, g = _inputs(cuda, (2, 16, 128, 64), torch.bfloat16, 0, w_dtype)
    got = conv64.conv3x3_same_backward(x, w, g, bias_dtype=b_dtype)
    want = conv64.conv3x3_same_backward_plain(x, w, g, bias_dtype=b_dtype)
    assert (got[1].dtype, got[2].dtype) == (w_dtype, b_dtype)
    for name, a, b, rel in zip(("dx", "dw", "db"), got, want, (1e-4, 1e-3, 1e-3)):
        _close(name, a, b, rel, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", [0, 1])
def test_two_calls_give_the_same_bits(cuda, dtype, halo):
    x, w, g = _inputs(cuda, (8, 64, 256, 64), dtype, halo)
    a = conv64.conv3x3_same_backward(x, w, g, pad_h=1 - halo)
    b = conv64.conv3x3_same_backward(x, w, g, pad_h=1 - halo)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_counters_and_refusals(cuda):
    x, w, g = _inputs(cuda, (2, 16, 128, 64), torch.bfloat16, 0)
    before = (conv64.conv3x3_same_backward.launches, conv64.conv3x3_same_backward.rows_launches)
    conv64.conv3x3_same_backward(x, w, g)
    xh, wh, gh = _inputs(cuda, (2, 16, 128, 64), torch.bfloat16, 1)
    conv64.conv3x3_same_backward(xh, wh, gh, pad_h=0)
    assert (conv64.conv3x3_same_backward.launches,
            conv64.conv3x3_same_backward.rows_launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):
        conv64.conv3x3_same_backward(x.half(), w, g.half())
    with pytest.raises(ValueError):
        conv64.conv3x3_same_backward(x[:, :, :100].contiguous(), w, g[:, :, :100].contiguous())
    with pytest.raises(ValueError):
        conv64.conv3x3_same_backward(x[..., ::2], w, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_capture_replays_eager(cuda, dtype):
    """Forward + backward of the Function captured in a CUDA graph: each
    replay's output and gradients are the eager run's, bit for bit."""
    x, w, g = _inputs(cuda, (4, 32, 256, 64), dtype, 0)
    bias = torch.randn(64, generator=cuda, device="cuda")

    def run():  # fresh leaves on the running stream, no graph kept alive after
        leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
        y = conv64.conv3x3_same(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, g))

    eager = [t.clone() for t in run()]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_capture_replays_eager_in_the_halo_row_mode(cuda, dtype):
    """As above through ``conv3x3_rows``: the halo dx's ragged last tile and,
    in bf16, the wgrad's cluster launch captured in a CUDA graph."""
    x, w, g = _inputs(cuda, (2, 64, 256, 64), dtype, 1)
    bias = torch.randn(64, generator=cuda, device="cuda")

    def run():
        leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
        y = conv64.conv3x3_rows(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, g))

    eager = [t.clone() for t in run()]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


def test_flagship_step_runs_no_library_backward_at_k2(cuda):
    """A bf16 flagship training step (batch 2, 256 px) under the profiler:
    no aten::convolution_backward of a 64 -> 64 3x3 weight (K2's four convs
    take the port's backward), and the backward counter moves by 4."""
    from adunet_torch.models import build_super_resolution_unet

    model, _ = build_super_resolution_unet(0.5, depth_override=3, dtype=torch.bfloat16,
                                           device="cuda")
    x = torch.rand(2, 256, 256, 3, generator=cuda, device="cuda")
    before = conv64.conv3x3_same_backward.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        loss = model(x).float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
    at_k2 = [e for e in prof.events() if e.name == "aten::convolution_backward"
             and any(list(s) == [64, 64, 3, 3] for s in e.input_shapes)]
    assert at_k2 == []
    assert conv64.conv3x3_same_backward.launches == before + 4
