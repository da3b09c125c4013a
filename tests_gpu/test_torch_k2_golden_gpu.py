"""K2's bf16 kernels on the card against fingerprints of the commit before
their redesign for Hopper.

The redesign keeps each output's float32 accumulation order (taps 0..8,
then K-steps 0..3, into one accumulator; the bias added in float32), so
the forward, in both modes, must give the same bits as before, and so must
the backward's dx. ``fingerprints`` makes seeded inputs on the CPU (the
same on every machine), runs ``conv64`` on the card and returns the sha256
of each output; ``PRIOR_SHA256`` holds what it returned for the checkout
before the redesign, on an NVIDIA H100 80GB HBM3 (torch 2.11.0, CUDA 12.8).
To read them for another checkout, from the repository root on a GPU
machine:

    python3 -c "import sys; sys.path.insert(0, 'CHECKOUT'); sys.path.insert(1, 'tests_gpu'); \
import test_torch_k2_golden_gpu as t; print(t.fingerprints())"

Run the test on a GPU machine from the repository root:

    python -m pytest tests_gpu/test_torch_k2_golden_gpu.py -q
"""

import hashlib

import pytest
import torch

from adunet_torch.kernels import conv64

pytestmark = pytest.mark.gpu

# (name, x's shape, halo): the flagship's training shape, the vanilla
# segmentation model's, and a space-mesh rank's halo rows at batch 8
CASES = [("flagship", (32, 256, 256, 64), 0), ("vanilla", (8, 128, 128, 64), 0),
         ("halo", (8, 130, 256, 64), 1)]

PRIOR_SHA256 = {
    "flagship y": "5a38b69435b915ee5d1f622807a9783faab3da3b66e912865c4474d7c297b512",
    "flagship dx": "33f30c2c9f309eb55e3914e126cad5edd2c45e82e6fa20155701040b1deb7adc",
    "vanilla y": "fa2c460c4772871ebfa36a9d69392ec07ea143299657b16359cc9b3e1a316576",
    "vanilla dx": "ec7704c3b891757dde34296f807f041a91a4537ecc75d57cb6857e02e21996c1",
    "halo y": "02efb2c24c748f471146765c63e54a9c7439efbd1ac4b66b0ba980086c15683c",
    "halo dx": "c9c55335a282bb6289ebf70087cd79afadb90e7bdbcc00cbcd9519c6ab3b79e7",
}


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()


def fingerprints() -> dict[str, str]:
    """sha256 of K2's bf16 forward (y) and of its backward's dx at each of
    ``CASES``, inputs from a CPU generator seeded by the case's index."""
    out = {}
    for i, (name, shape, halo) in enumerate(CASES):
        gen = torch.Generator().manual_seed(1300 + i)
        x = torch.randn(*shape, generator=gen).to(torch.bfloat16).cuda()
        w = (torch.randn(64, 64, 3, 3, generator=gen) * 0.05).cuda()
        bias = (torch.randn(64, generator=gen) * 0.1).cuda()
        g_shape = (shape[0], shape[1] - 2 * halo, *shape[2:])
        g = torch.randn(*g_shape, generator=gen).to(torch.bfloat16).cuda()
        with torch.no_grad():
            y = (conv64.conv3x3_rows if halo else conv64.conv3x3_same)(x, w, bias)
        dx, _, _ = conv64.conv3x3_same_backward(x, w, g, need_dw=False, need_db=False,
                                                pad_h=1 - halo)
        out[f"{name} y"] = _sha(y)
        out[f"{name} dx"] = _sha(dx)
        del x, g, y, dx
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def test_bf16_forward_and_dx_are_bit_equal_to_before_the_redesign(cuda):
    assert fingerprints() == PRIOR_SHA256
