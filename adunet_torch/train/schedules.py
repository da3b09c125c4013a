"""Learning-rate schedule and optimizer.

Port of ``adunet/train/schedules.py``: Adam with the Keras defaults (b1 0.9,
b2 0.999, **eps 1e-7**, where ``torch.optim.Adam`` defaults to 1e-8) and an
optional Keras ``CosineDecay``. Adam's update is optax's: torch divides the
bias-corrected first moment by ``sqrt(v) / sqrt(1 - b2^t) + eps``, which is
optax's ``m_hat / (sqrt(v_hat) + eps)``.

A schedule is counted as optax counts it: the k-th update (from 0) runs at
``schedule(k)``; ``TrainState.apply_gradients`` sets the rate from its step
before each update. The learning rate of a ``torch.optim`` optimizer is
always mutable; ``inject_lr=True`` marks the optimizer whose rate the fit
loop may rescale (ReduceLROnPlateau), as ``optax.inject_hyperparams`` does in
the reference, and it refuses a schedule for the same reason (:39-49).

On a CUDA model (parameters that are plain CUDA tensors) the optimizer is
built so that a CUDA graph can hold its update (``train/compiled.py``):
``capturable=True`` (the update count and the bias corrections live on the
device) and the learning rate a 0-dim float32 device tensor, into which the
schedule and the plateau rescale write; they never replace it. Elsewhere
(the CPU, sharded parameters) the rate is a Python float and the update the
non-capturable one, whose bias corrections are Python doubles: the two round
differently in the last bits.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

__all__ = ["Adam", "cosine_decay_schedule", "get_lr", "make_optimizer", "set_lr"]


def cosine_decay_schedule(initial_lr: float, decay_steps: int, alpha: float = 0.0
                          ) -> Callable[[int], float]:
    """Keras CosineDecay(initial_lr, decay_steps, alpha), flat past the end."""

    def schedule(step: int) -> float:
        frac = min(step / max(decay_steps, 1), 1.0)
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return initial_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _capturable(params) -> bool:
    """True when every parameter is a plain CUDA tensor (not a DTensor: the
    capturable update mixes its device tensors with the parameters')."""
    if not params or not all(p.is_cuda for p in params):
        return False
    from torch.distributed.tensor import DTensor

    return not any(isinstance(p, DTensor) for p in params)


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` with the reference's hyperparameters, an optional
    schedule over the update count and the ``inject_lr`` mark; capturable,
    with a device-tensor rate, on CUDA (module docstring)."""

    def __init__(self, params: Iterable, learning_rate: float,
                 schedule: Optional[Callable[[int], float]] = None, inject_lr: bool = False,
                 foreach: Optional[bool] = None):
        params = list(params)
        lr = schedule(0) if schedule is not None else float(learning_rate)
        capturable = _capturable(params)
        if capturable:
            lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-7, foreach=foreach,
                         capturable=capturable)
        self.schedule = schedule
        self.inject_lr = inject_lr

    def set_update_count(self, count: int) -> None:
        """Set the rate of the next update from the schedule, if any."""
        if self.schedule is not None:
            set_lr(self, self.schedule(count))

    def load_state_dict(self, state_dict) -> None:
        """Load moments, counts and rates, keeping this optimizer's form: a
        device-tensor rate is written into (the tensor a captured update
        reads stays the same), a float rate stays a float, and the update
        counts move to the device when this optimizer is capturable (a
        checkpoint of a non-capturable Adam keeps them on the host)."""
        kept = [(g["lr"], g["capturable"]) for g in self.param_groups]
        super().load_state_dict(state_dict)
        for group, (lr, capturable) in zip(self.param_groups, kept):
            loaded, group["capturable"] = group["lr"], capturable
            if isinstance(lr, torch.Tensor):
                lr.copy_(torch.as_tensor(loaded))
                group["lr"] = lr
            else:
                group["lr"] = float(loaded)
            if capturable:
                for p in group["params"]:
                    slots = self.state.get(p)
                    if slots and "step" in slots:
                        slots["step"] = slots["step"].to(device=p.device, dtype=torch.float32)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's rate to ``lr``: in place for a device-tensor rate."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    """The first group's rate as a float (waits for the device)."""
    return float(optimizer.param_groups[0]["lr"])


def make_optimizer(
    params: Iterable,
    learning_rate: float,
    *,
    cosine_decay_steps: int | None = None,
    cosine_alpha: float = 0.0,
    inject_lr: bool = False,
) -> Adam:
    """Adam (eps 1e-7) over ``params``; optional cosine schedule."""
    schedule = None
    if cosine_decay_steps is not None:
        if inject_lr:
            raise ValueError(
                "cosine_decay_steps and inject_lr are mutually exclusive: the "
                "schedule would overwrite any runtime learning-rate edit on "
                "the next optimizer update."
            )
        schedule = cosine_decay_schedule(learning_rate, cosine_decay_steps, cosine_alpha)
    return Adam(params, learning_rate, schedule=schedule, inject_lr=inject_lr)
