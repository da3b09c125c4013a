"""The banded resize kernel (``adunet_torch/kernels/resize_band.py``) on the card.

- Forward and backward against the dense path (``resize_band_plain``, two
  float32 matmuls with TF32 off, and the casts around them), at every
  resize of the flagship's and the deep model's training steps (encoder and
  decoder, the channels of each level), of their degradation (area, then
  cv2's cubic, RGB) and of the served flagship (float32): float32 to 1e-6
  of the largest |value|, bf16 to one bf16 ulp of each element (plus 1e-6
  of the largest |value|, for sums near 0).
- Two calls, and a CUDA graph's replays, give the same bits; the source
  holds no atomic.
- ``resize_band.launches`` counts one launch a forward and one a backward.

The batch is 2 (the kernel tiles each image alike). Every test needs a CUDA
GPU and skips without one; a kernel that does not build fails it:

    python -m pytest tests_gpu/test_torch_resize_gpu.py -q
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

from adunet_torch.kernels import resize_band
from adunet_torch.kernels.resize_band import resize_band_plain
from adunet_torch.ops import resize, resize_by_scale, resize_to_match

pytestmark = pytest.mark.gpu

_band = importlib.import_module("adunet_torch.kernels.resize_band")

BATCH = 2
# (in px, out px, channels, method, antialias): the flagship (scale 0.5,
# depth 3, base 64), the deep model (scale 0.8, depth 5), the degradation of
# both (at 0.5: area 256 -> 128, cubic 128 -> 256)
FLAGSHIP = [(256, 128, 64), (128, 64, 128), (64, 32, 256),
            (32, 64, 512), (64, 128, 256), (128, 256, 128)]
DEEP = [(256, 205, 64), (205, 164, 128), (164, 132, 256), (132, 106, 512), (106, 85, 1024),
        (85, 106, 2048), (106, 132, 1024), (132, 164, 512), (164, 205, 256), (205, 256, 128)]
DEGRADE = [(256, 128, 3, "area", True), (128, 256, 3, "bicubic_cv2", False)]
SHAPES = ([(*s, "bilinear", True) for s in FLAGSHIP + DEEP] + DEGRADE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    ulp = 2.0**-7 * torch.maximum(g.abs(), w.abs()) if got.dtype == torch.bfloat16 else 0.0
    bad = (g - w).abs() > ulp + 1e-6 * w.abs().max()
    assert not bool(bad.any()), ((g - w).abs().max() / w.abs().max()).item()


def _kernel(x, out_hw, method, antialias, dtype, ref):
    """x resized on the card as the port asks for it: ``resize`` for a
    float32 result, ``resize_to_match`` (``ref``'s size) for x's own type,
    the wrapper itself for float32 in and bf16 out."""
    if dtype == torch.float32:
        return resize(x, out_hw, method, antialias)
    if dtype == x.dtype:
        return resize_to_match(x, ref, method, antialias)
    return resize_band(x, out_hw, method, antialias, dtype)


def _both(x, out_hw, method, antialias, dtype, g):
    """(y, dx) of the kernel and of the dense path for the cotangent g."""
    out = []
    for dense in (False, True):
        xi = x.detach().clone().requires_grad_(True)
        y = (resize_band_plain(xi, out_hw, method, antialias).to(dtype) if dense
             else _kernel(xi, out_hw, method, antialias, dtype, g))
        y.backward(g)
        out.append((y.detach(), xi.grad))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}-{s[1]}x{s[2]}-{s[3]}")
def test_kernel_matches_the_dense_path(cuda, shape, dtype):
    h, oh, c, method, antialias = shape
    gen = torch.Generator("cuda").manual_seed(h * 7 + oh + c)
    x = torch.rand((BATCH, h, h, c), device="cuda", generator=gen).to(dtype)
    g = torch.randn((BATCH, oh, oh, c), device="cuda", generator=gen).to(dtype)
    before = resize_band.launches
    (y, dx), (y_ref, dx_ref) = _both(x, (oh, oh), method, antialias, dtype, g)
    assert resize_band.launches - before == 2  # forward and backward
    _close(y, y_ref)
    _close(dx, dx_ref)


@pytest.mark.parametrize("shape", [(256, 128, 64), (64, 128, 256)])
def test_served_float32_shapes_and_cross_types(cuda, shape):
    """The served program's float32 resizes (batch 8), and the mixed cases:
    bf16 in, float32 out (``resize``'s contract), and float32 in, bf16 out."""
    h, oh, c = shape
    x = torch.rand((8, h, h, c), device="cuda")
    with torch.inference_mode():
        _close(resize_by_scale(x, oh / h), resize_band_plain(x, (oh, oh)))
    for din, dout in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        xi = x[:BATCH].to(din)
        g = torch.randn((BATCH, oh, oh, c), device="cuda").to(dout)
        (y, dx), (y_ref, dx_ref) = _both(xi, (oh, oh), "bilinear", True, dout, g)
        _close(y, y_ref)
        _close(dx, dx_ref)


def test_unchanged_sizes_and_odd_shapes(cuda):
    """An axis whose size is unchanged is the identity; odd sizes, C not a
    multiple of 8, a misaligned view (the scalar path) and lead dims."""
    x = torch.rand((3, 37, 23, 5), device="cuda")
    assert resize_to_match(x, x) is x
    for out_hw in ((37, 11), (16, 23), (61, 40)):
        _close(resize(x, out_hw, "lanczos3", True), resize_band_plain(x, out_hw, "lanczos3", True))
    base = torch.rand((1, 1 + 20 * 18 * 16), device="cuda")
    view = base[0, 1:].view(1, 20, 18, 16)  # 4 bytes past an aligned start
    assert view.data_ptr() % 16 != 0
    _close(resize(view, (10, 9)), resize_band_plain(view, (10, 9)))
    lead = torch.rand((2, 3, 20, 18, 8), device="cuda")
    _close(resize(lead, (10, 9), "area"), resize_band_plain(lead, (10, 9), "area"))


def test_bits_repeat_over_calls_and_graph_replays(cuda):
    """Forward and backward (the transposed tables: a gather) give the same
    bits twice eagerly and in every replay of a captured graph."""
    h, oh, c = 64, 128, 256
    x = torch.rand((BATCH, h, h, c), device="cuda").to(torch.bfloat16).requires_grad_(True)
    g = torch.randn((BATCH, oh, oh, c), device="cuda").to(torch.bfloat16)

    def step():
        x.grad = None
        y = resize_to_match(x, g)
        y.backward(g)
        return y.detach(), x.grad

    first, second = step(), step()  # the eager calls make the tables and plans
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    x.grad = None
    before = resize_band.launches
    with torch.cuda.graph(graph, stream=stream):
        y = resize_to_match(x, g)
        y.backward(g)
    assert resize_band.launches - before == 2
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y.view(torch.int16), first[0].view(torch.int16))
        assert torch.equal(x.grad.view(torch.int16), first[1].view(torch.int16))


def test_source_holds_no_atomic():
    src = Path(_band.__file__).resolve().parents[1] / "csrc" / "resize_band.cu"
    code = re.sub(r"//[^\n]*", "", src.read_text())  # the comments say "no atomics"
    assert not re.search(r"\batomic|\batom\.|\bred\.", code)  # CUDA's atomics, PTX's atom / red


def test_counter_is_the_last_of_the_wrappers(cuda):
    """The resize's counter follows K1's and K2's six in the registry (K1's
    two bias counters and K3's after it), so ``all_launch_counts`` ends with
    it, and a resize counts there alone."""
    from adunet_torch import kernels

    assert kernels._COUNTERS[6] == (_band.resize_band, "launches")
    assert len(kernels.launch_snapshot()) == 10 and len(kernels.all_launch_counts()) == 7
    before = kernels.launch_snapshot()
    with torch.no_grad():
        resize_by_scale(torch.rand((1, 32, 32, 8), device="cuda"), 0.5)
    assert kernels.launches_since(before) == (0,) * 6 + (1,) + (0,) * 3
