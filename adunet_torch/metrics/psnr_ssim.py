"""PSNR / SSIM / MS-SSIM with tf.image semantics, in torch.

Port of ``adunet/metrics/psnr_ssim.py`` (``msssim_power_factors_for`` :28,
``psnr`` :50, ``ssim`` :118, ``_downsample_2x`` :134, ``ssim_multiscale``
:151): an 11x11 sigma-1.5 Gaussian applied separably in VALID mode as a sum
of shifted slices (the reference's order of operations, so rounding agrees),
and MS-SSIM's 2x2 average-pool downsampling after padding odd dims by one
pixel. For that one-pixel pad numpy's ``symmetric`` mode repeats the edge
pixel, i.e. torch's ``replicate``, not ``reflect``. Inputs are (N, H, W, C).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["psnr", "mse_per_image", "ssim", "ssim_multiscale", "msssim_power_factors_for"]

# Wang et al. (2003) MS-SSIM power factors — the tf.image constants.
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def msssim_power_factors_for(min_dim: int, filter_size: int = 11) -> Tuple[float, ...]:
    """The Wang weights truncated to the scales that fit ``min_dim``."""
    scales = 1
    while min_dim // (2**scales) >= filter_size and scales < len(_MSSSIM_WEIGHTS):
        scales += 1
    return _MSSSIM_WEIGHTS[:scales]


def mse_per_image(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over (H, W, C); inputs (N, H, W, C)."""
    return torch.mean(torch.square(a.to(torch.float32) - b.to(torch.float32)), dim=(-3, -2, -1))


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR in dB; identical images give +inf."""
    mse = mse_per_image(a, b)
    return 10.0 * (torch.log(max_val**2 / mse) / math.log(10.0))


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(size: int, sigma: float) -> Tuple[float, ...]:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (coords / sigma) ** 2)
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _filter2d_valid(x: torch.Tensor, kernel: Sequence[float]) -> torch.Tensor:
    k = len(kernel)
    h = x.shape[-3]
    y = sum(x[..., i : h - (k - 1) + i, :, :] * kernel[i] for i in range(k))
    w = y.shape[-2]
    return sum(y[..., :, i : w - (k - 1) + i, :] * kernel[i] for i in range(k))


def _ssim_per_channel(a, b, max_val, filter_size, filter_sigma, k1, k2):
    """(ssim, cs), each (N, C) — tf.image's _ssim_per_channel."""
    kernel = _gaussian_kernel_1d(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _filter2d_valid(a, kernel)
    mu_b = _filter2d_valid(b, kernel)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = _filter2d_valid(a * a, kernel) - mu_aa
    sigma_bb = _filter2d_valid(b * b, kernel) - mu_bb
    sigma_ab = _filter2d_valid(a * b, kernel) - mu_ab
    luminance = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    cs = (2.0 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return torch.mean(luminance * cs, dim=(-3, -2)), torch.mean(cs, dim=(-3, -2))


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM, (N,) — tf.image.ssim (mean over channels)."""
    s, _ = _ssim_per_channel(a.to(torch.float32), b.to(torch.float32), max_val,
                             filter_size, filter_sigma, k1, k2)
    return torch.mean(s, dim=-1)


def _downsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Pad odd H / W by repeating the last row / column, then 2x2 stride-2
    average pool — tf.image.ssim_multiscale's downsampling."""
    if x.shape[-3] % 2:
        x = torch.cat([x, x[..., -1:, :, :]], dim=-3)
    if x.shape[-2] % 2:
        x = torch.cat([x, x[..., :, -1:, :]], dim=-2)
    h, w = x.shape[-3], x.shape[-2]
    x = x.reshape(*x.shape[:-3], h // 2, 2, w // 2, 2, x.shape[-1])
    return torch.mean(x, dim=(-4, -2))


def ssim_multiscale(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
                    power_factors: Sequence[float] = _MSSSIM_WEIGHTS, filter_size: int = 11,
                    filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image MS-SSIM, (N,) — tf.image.ssim_multiscale."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    mcs = []
    ssim_last = None
    for scale in range(len(power_factors)):
        if scale > 0:
            a = _downsample_2x(a)
            b = _downsample_2x(b)
        s, cs = _ssim_per_channel(a, b, max_val, filter_size, filter_sigma, k1, k2)
        mcs.append(torch.relu(cs))
        ssim_last = s
    powers = torch.tensor(power_factors, dtype=torch.float32, device=a.device)
    stacked = torch.stack(mcs[:-1] + [torch.relu(ssim_last)], dim=0)  # (S, N, C)
    value = torch.prod(stacked ** powers[:, None, None], dim=0)
    return torch.mean(value, dim=-1)
