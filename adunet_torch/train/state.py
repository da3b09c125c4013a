"""Train state: the model (its parameters), the optimizer and the update count.

Port of ``adunet/train/state.py``. Where flax's ``TrainState`` is an
immutable pytree that every step replaces, here the model's parameters and
the optimizer's moments are updated in place and the step functions return
the same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from torch import nn

from adunet_torch.train.schedules import Adam

__all__ = ["TrainState", "create_train_state"]


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Adam
    step: int = 0

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients in the parameters' ``.grad``
        (the rate from the schedule at this update's count, if any)."""
        self.optimizer.set_update_count(self.step)
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(model: nn.Module, optimizer: Adam) -> TrainState:
    """Wrap a model and an optimizer over its parameters at step 0."""
    return TrainState(model=model, optimizer=optimizer, step=0)
