"""Train state: the model (its parameters and buffers, such as BatchNorm's
running statistics), the optimizer and the step."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

import torch


class Recipe(Protocol):
    """An optimizer recipe (`train/optim.py`): the optax
    GradientTransformation's counterpart."""

    def init(self, model: torch.nn.Module) -> torch.optim.Optimizer: ...

    def update(self, optimizer: torch.optim.Optimizer, params,
               count: int) -> None: ...


@dataclass
class TrainState:
    """The counterpart of the JAX TrainState.  PyTorch state is mutable, so
    `apply_gradients` updates the parameters in place (no second copy of
    them is held) and returns the same object with the step advanced."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    tx: Recipe

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients in `.grad`, at the
        recipe's value for the current step (optax's pre-increment
        count)."""
        self.tx.update(self.optimizer, list(self.model.parameters()),
                       self.step)
        self.step += 1
        return self


def create_train_state(model: torch.nn.Module, tx: Recipe,
                       seed: Optional[int] = 0,
                       device: Optional[torch.device] = None) -> TrainState:
    """Initialise the model's parameters from `seed` (drawn on the CPU, so
    the same seed gives the same weights on every device; None keeps the
    parameters it has), move it to `device`, and build the optimizer."""
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    if device is not None:
        model.to(device)
    return TrainState(step=0, model=model, optimizer=tx.init(model), tx=tx)
