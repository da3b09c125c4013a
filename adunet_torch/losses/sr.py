"""Super-resolution losses and the training PSNR metric.

Port of ``adunet/losses/sr.py``: charbonnier (eps 1e-3, the default loss),
l1, mse, ``1 - mean SSIM``, the batch-mean PSNR with predictions clipped to
[0, 1], and the ``combined`` cocktail (1.0 MSE + 0.1 SSIM loss + 0.01
perceptual MSE over a caller-supplied feature map, ``adunet_torch.losses.
perceptual``, of both images clipped to [0, 1]). Every function computes in
float32 whatever the input dtype.

The perceptual term's clip is ``minimum(maximum(x, 0), 1)``, as
``jnp.clip`` computes it, so a pixel exactly at a bound passes half the
gradient (both frameworks split a tie of ``maximum`` / ``minimum`` evenly;
``torch.clamp`` would pass all of it). An untrained adaptive model is the
identity, so every input pixel at exactly 0 or 1 is such a tie in the first
step. The target's features take no gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from adunet_torch.metrics.psnr_ssim import psnr, ssim

__all__ = [
    "charbonnier_loss",
    "l1_loss",
    "mse_loss",
    "ssim_loss",
    "psnr_metric",
    "build_losses_and_metrics",
]

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _diff(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return y_true.to(torch.float32) - y_pred.to(torch.float32)


def charbonnier_loss(y_true: torch.Tensor, y_pred: torch.Tensor, epsilon: float = 1e-3) -> torch.Tensor:
    return torch.mean(torch.sqrt(torch.square(_diff(y_true, y_pred)) + epsilon**2))


def l1_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_diff(y_true, y_pred)))


def mse_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(_diff(y_true, y_pred)))


def ssim_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.mean(ssim(y_true.to(torch.float32), y_pred.to(torch.float32)))


def psnr_metric(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    y_pred = torch.clamp(y_pred.to(torch.float32), 0.0, 1.0)
    return torch.mean(psnr(y_true.to(torch.float32), y_pred))


def _clip01(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), one)


def build_losses_and_metrics(
    loss_name: str,
    perceptual_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    alpha: float = 1.0,
    beta: float = 0.1,
    gamma: float = 0.01,
) -> Tuple[LossFn, Dict[str, LossFn]]:
    """(loss_fn, metrics) for 'charbonnier' | 'l1' | 'combined'; 'combined'
    needs ``perceptual_fn`` (clipped [0,1] RGB -> feature map)."""
    loss_key = loss_name.lower()
    metrics = {"psnr": psnr_metric}
    if loss_key == "charbonnier":
        return charbonnier_loss, metrics
    if loss_key == "l1":
        return l1_loss, metrics
    if loss_key == "combined":
        if perceptual_fn is None:
            raise ValueError("combined loss requires a perceptual_fn (a feature extractor)")

        def combined(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                ft = perceptual_fn(_clip01(y_true))
            fp = perceptual_fn(_clip01(y_pred))
            return (alpha * mse_loss(y_true, y_pred) + beta * ssim_loss(y_true, y_pred)
                    + gamma * torch.mean(torch.square(ft - fp)))

        return combined, metrics
    raise ValueError(f"loss '{loss_name}' is not registered; choose charbonnier, l1, or combined.")
