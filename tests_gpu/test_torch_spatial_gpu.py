"""K2's halo-row mode on the card, and the row exchange on CUDA tensors.

Under a space mesh (``adunet_torch.parallel.spatial``) a process holds H
rows of each image and K2 takes them with one neighbour row above and below:
an input of H + 2 rows, SAME in W, VALID in H (``conv64.conv3x3_rows``). These
tests hold the kernel to its plain version at the shapes a 256-px image split
in two gives it (32 and 8 x (128 + 2) x 256 x 64, the flagship's and the deep
config's batches), in float32 also to cuDNN's ``F.conv2d`` with padding (0,
1), and its
Function's gradients against autograd through the plain version. Run on a
GPU machine from the repository root:

    python -m pytest tests_gpu -q

Tolerances as ``test_torch_kernels_gpu.py``'s for K2: float32 atol 1e-4,
bf16 one bf16 ulp relative plus 1e-5 absolute; gradients as
``test_torch_autograd_gpu.py``'s, relative to each tensor's largest |value|:
dx 1e-4 (cuDNN's float32 algorithms against autograd through the plain
version's matmuls, TF32 off), dw and db 1e-3 (float32 sums over 262,144
pixels in another order).
"""

import pytest
import torch
import torch.nn.functional as F

from adunet_torch.kernels import conv64

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _close(got, want, dtype, atol=1e-4, atol_bf16=1e-5):
    g, w = got.float(), want.float()
    limit = atol if dtype == torch.float32 else 2.0**-7 * w.abs() + atol_bf16
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(((g - w).abs() <= limit).all()), (g - w).abs().max().item()


def _inputs(gen, shape, dtype):
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05
    b = torch.randn(64, generator=gen, device="cuda") * 0.1
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [32, 8])
def test_halo_rows_match_plain(cuda, dtype, batch):
    x, w, b = _inputs(cuda, (batch, 128 + 2, 256, 64), dtype)
    before = (conv64.conv3x3_rows.launches, conv64.conv3x3_same.launches)
    got = conv64.conv3x3_rows(x, w.to(dtype), b.to(dtype))
    assert (conv64.conv3x3_rows.launches, conv64.conv3x3_same.launches) == (before[0] + 1,
                                                                            before[1])
    _close(got, conv64.conv3x3_rows_plain(x, w.to(dtype), b.to(dtype)), dtype)
    if dtype == torch.float32:  # cuDNN's bf16 conv rounds otherwise: the plain version holds it
        lib = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=(0, 1))
        _close(got, lib.permute(0, 2, 3, 1).contiguous(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_rows_read_every_edge_row(cuda, dtype):
    """A one-hot input in the first and last of the H + 2 rows and at the
    first and last columns: the kernel reads the halo rows (the SAME kernel
    would treat them as image rows with zeros beyond) and zero-fills W."""
    x = torch.zeros(2, 16 + 2, 128, 64, device="cuda", dtype=dtype)
    for r, c in ((0, 0), (0, 127), (17, 0), (17, 127), (1, 64), (16, 5)):
        x[:, r, c, (r + c) % 64] = 1.0
    w = (torch.randn(64, 64, 3, 3, generator=cuda, device="cuda") * 0.1).to(dtype)
    _close(conv64.conv3x3_rows(x, w, None), conv64.conv3x3_rows_plain(x, w, None), dtype)


def test_halo_rows_gradients_match_plain(cuda):
    x, w, b = _inputs(cuda, (8, 128 + 2, 256, 64), torch.float32)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    g = torch.randn(8, 128, 256, 64, generator=cuda, device="cuda")
    got = torch.autograd.grad(conv64.conv3x3_rows(x, w, b), (x, w, b), g)
    want = torch.autograd.grad(conv64.conv3x3_rows_plain(x, w, b), (x, w, b), g)
    assert got[0].shape == x.shape
    for a, e, rel in zip(got, want, (1e-4, 1e-3, 1e-3)):
        assert float((a - e).abs().max() / e.abs().max()) <= rel


def test_halo_rows_gate_applies_to_the_output(cuda):
    w = torch.zeros(64, 64, 3, 3, device="cuda")
    with pytest.raises(ValueError):  # 12 output rows: under the gate's 16
        conv64.conv3x3_rows(torch.zeros(1, 14, 128, 64, device="cuda"), w, None)
    assert conv64.conv3x3_rows(torch.zeros(1, 18, 128, 64, device="cuda"), w, None).shape[1] == 16
