"""The SR training step in plain PyTorch: patch sampling from a uint8
corpus, degradation, the Charbonnier loss, the backward by autograd, and
Adam as Keras and optax define it (b1 0.9, b2 0.999, eps 1e-7 added to the
bias-corrected root of the second moment).

Sampling draws, per step and from one generator, the image indices, then
the rows, then the columns of the crops (``torch.randint`` in that order).
Degradation (the training data's LR side, at shrink 0.5): an area-filter
shrink to round(size * 0.5) and an OpenCV-cubic enlargement back, not
clipped, in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import sr_unet
from portbench.reference.resize import resize_nchw

LR_SHRINK = 0.5
CHARBONNIER_EPS = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7


def sample_patches(images_u8: torch.Tensor, generator: torch.Generator, batch: int,
                   patch: int) -> torch.Tensor:
    """(B, P, P, 3) float32 crops in [0, 1] of an (N, H, W, 3) uint8 corpus."""
    n, h, w, _ = images_u8.shape
    dev = images_u8.device
    idx = torch.randint(0, n, (batch,), generator=generator, device=dev).tolist()
    ys = torch.randint(0, h - patch + 1, (batch,), generator=generator, device=dev).tolist()
    xs = torch.randint(0, w - patch + 1, (batch,), generator=generator, device=dev).tolist()
    crops = [images_u8[i, y:y + patch, x:x + patch] for i, y, x in zip(idx, ys, xs)]
    return torch.stack(crops).to(torch.float32) / 255.0


def degrade(hr: torch.Tensor, shrink: float = LR_SHRINK) -> torch.Tensor:
    """NHWC float32 HR patches -> their LR side at the same size."""
    x = hr.to(torch.float32).clamp(0.0, 1.0).permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    down = resize_nchw(x, max(1, int(round(h * shrink))), max(1, int(round(w * shrink))), "area")
    up = resize_nchw(down, h, w, "bicubic_cv2", antialias=False)
    return up.permute(0, 2, 3, 1)


def charbonnier(hr: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    d = hr.to(torch.float32) - pred.to(torch.float32)
    return torch.mean(torch.sqrt(d * d + CHARBONNIER_EPS ** 2))


class Adam:
    """Adam over a dict of float32 tensors, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr = float(lr)
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - ADAM_B1 ** self.t, 1.0 - ADAM_B2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                self.v[k].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + ADAM_EPS))


def follow(params: Dict[str, torch.Tensor], images_u8: torch.Tensor, sample_seed: int,
           cfg: dict, steps: int, dtype: torch.dtype, quant=None, loss_rows: Optional[int] = None
           ) -> dict:
    """``steps`` training steps from ``params`` (updated in place), the
    patches drawn from a generator seeded with ``sample_seed`` on the
    corpus's device. Returns each step's loss, the first step's gradient
    per parameter, and ``params`` after the last step. ``loss_rows`` takes
    the loss over the batch's first rows only (a planted fault)."""
    train = cfg["train"]
    gen = torch.Generator(images_u8.device).manual_seed(int(sample_seed))
    adam = Adam(params, train["learning_rate"])
    losses: List[float] = []
    first_grad: Dict[str, torch.Tensor] = {}
    for step in range(steps):
        hr = sample_patches(images_u8, gen, int(train["batch_size"]), int(cfg["patch_size"]))
        lr_img = degrade(hr)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred = sr_unet.forward(leaves, lr_img, cfg, dtype, quant)
        rows = loss_rows or hr.shape[0]
        loss = charbonnier(hr[:rows], pred[:rows])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves.keys(), grads))
        losses.append(float(loss.detach()))
        if step == 0:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        del pred, loss, leaves
        adam.step(params, grads)
    return {"losses": losses, "first_grad": first_grad, "params": params}
