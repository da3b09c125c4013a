"""Train state: the model (its parameters), the optimizer and the update count.

Port of ``adunet/train/state.py``. Where flax's ``TrainState`` is an
immutable pytree that every step replaces, here the model's parameters and
the optimizer's moments are updated in place and the step functions return
the same object. A state trained across processes carries its
``adunet_torch.parallel.DataParallel`` in ``parallel``: the steps run the
training forward through ``train_module``, accumulate under ``no_sync`` and
report ``reduce_metrics``; ``model`` stays the unwrapped module.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from adunet_torch.train.schedules import Adam

__all__ = ["TrainState", "create_train_state"]


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Adam
    step: int = 0
    parallel: Optional[Any] = None  # adunet_torch.parallel.DataParallel

    @property
    def train_module(self) -> nn.Module:
        """The module to run the training forward through (the model, or its
        data-parallel wrapper)."""
        return self.model if self.parallel is None else self.parallel.module

    @property
    def space(self):
        """The ``SpaceShard`` of a space mesh's row-sharded training, or None."""
        return None if self.parallel is None else self.parallel.space

    def no_sync(self):
        """Context of a backward whose gradients are not reduced across
        processes yet (every micro-batch of an accumulated step but the
        last)."""
        return contextlib.nullcontext() if self.parallel is None else self.parallel.no_sync()

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A step's metrics over the global batch (unchanged in one process)."""
        return metrics if self.parallel is None else self.parallel.mean_metrics(metrics)

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients in the parameters' ``.grad``
        (the rate from the schedule at this update's count, if any)."""
        if self.parallel is not None:
            self.parallel.sync_grads()
        self.optimizer.set_update_count(self.step)
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(model: nn.Module, optimizer: Adam) -> TrainState:
    """Wrap a model and an optimizer over its parameters at step 0."""
    return TrainState(model=model, optimizer=optimizer, step=0)
