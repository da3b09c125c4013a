"""adunet_torch — the PyTorch / CUDA (Hopper) port of ``adunet``.

A second package beside the JAX reference ``adunet``. It imports ``torch``
and numpy only (never ``jax``, ``flax`` or ``adunet``), keeps the reference's
NHWC layout at every public function, and runs the two Pallas TPU kernels of
the reference as hand-written CUDA C++ kernels for ``sm_90a``
(``adunet_torch/csrc``), built with ``nvcc`` at first use.

Every entry point takes a ``device`` and defaults to CUDA; without a GPU it
raises unless the caller passes ``device="cpu"``. On CPU tensors the kernel
wrappers run their plain PyTorch versions; on CUDA tensors they launch the
kernel or raise.

Subpackages
-----------
- ``ops``      — fractional resize (banded kernel / matmul), LR degradation, luma, residual add
- ``nn``       — depth policies and building blocks (ConvBlock)
- ``kernels``  — CUDA kernels as autograd Functions: fused LayerNorm+ReLU (K1),
  64->64 3x3 conv (K2), the banded resize; their forwards as ``torch.library``
  ops for programs
- ``models``   — adaptive SR U-Net
- ``losses``   — SR losses (charbonnier, l1, mse, SSIM) and the PSNR metric
- ``data``     — image IO, grid eval patches, the device-resident corpus
- ``train``    — Adam and schedules, SR train/val/eval steps, checkpoints, fit
- ``configs``  — the SR trainer's config
- ``export``   — serving programs (``torch.export``) and artifacts
- ``metrics``  — PSNR / SSIM / MS-SSIM
- ``evaluate`` — the Y-channel SR evaluator
- ``utils``    — device resolution, runtime switches, splits
- ``cli``      — SR trainer and HTTP model server
"""

__version__ = "0.1.0"
