"""Train state: the model (its parameters and buffers, such as BatchNorm's
running statistics), the optimizer and the step; over a mesh, the layout
the parameters are laid out in (`parallel/shard.Sharding`) and the ZeRO
plan.

`full_state` and `load_full_state` carry the state as whole tensors in the
port's layout (the one-process model's `state_dict`, and each parameter's
optimizer moments under its name), whatever mesh holds it: a checkpoint
written under one mesh restores under another, as orbax re-shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

import torch


class Recipe(Protocol):
    """An optimizer recipe (`train/optim.py`): the optax
    GradientTransformation's counterpart."""

    def init(self, model: torch.nn.Module,
             named=None) -> torch.optim.Optimizer: ...

    def update(self, optimizer: torch.optim.Optimizer, params,
               count: int, shard_groups=None) -> None: ...


@dataclass
class TrainState:
    """The counterpart of the JAX TrainState.  PyTorch state is mutable, so
    `apply_gradients` updates the parameters in place (no second copy of
    them is held) and returns the same object with the step advanced."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    tx: Recipe
    sharding: Optional[object] = None  # parallel.shard.Sharding
    zero_plan: Optional[object] = None  # train.zero.ZeroShardingPlan

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients in `.grad`, at the
        recipe's value for the current step (optax's pre-increment
        count)."""
        if self.sharding is None:
            self.tx.update(self.optimizer, list(self.model.parameters()),
                           self.step)
        else:
            self.tx.update(self.optimizer,
                           [t for _, t in self.sharding.opt_named()],
                           self.step,
                           shard_groups=self.sharding.shard_groups())
            self.sharding.after_update()
        self.step += 1
        return self


def create_train_state(model: torch.nn.Module, tx: Recipe,
                       seed: Optional[int] = 0,
                       device: Optional[torch.device] = None,
                       mesh=None, zero_plan=None) -> TrainState:
    """Initialise the model's parameters from `seed` (drawn on the CPU, so
    the same seed gives the same weights on every device; None keeps the
    parameters it has), move it to `device`, lay it out on `mesh` (over
    the process group; its tp and fsdp axes, and with `zero_plan` ZeRO
    over dp) and build the optimizer."""
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    if device is not None:
        model.to(device)
    sharding = None
    if mesh is not None:
        from ..parallel.shard import Sharding

        sharding = Sharding(model, mesh, zero_plan)
    optimizer = (tx.init(model) if sharding is None
                 else tx.init(model, sharding.opt_named()))
    return TrainState(step=0, model=model, optimizer=optimizer, tx=tx,
                      sharding=sharding, zero_plan=zero_plan)


def _opt_tensors(state: TrainState):
    """(name, tensor) the optimizer updates."""
    if state.sharding is None:
        return list(state.model.named_parameters())
    return state.sharding.opt_named()


def full_state(state: TrainState) -> dict:
    """{"model": whole state_dict, "optimizer": {name: {key: whole moment
    or scalar}}, "step"} on this rank's device.  Every rank of a sharded
    state must call it (it gathers)."""
    sh = state.sharding
    model = dict(state.model.state_dict())
    for name, p in state.model.named_parameters():
        model[name] = p.detach() if sh is None else sh.gather(name, p)
    moments = {}
    for name, t in _opt_tensors(state):
        entry = state.optimizer.state.get(t, {})
        moments[name] = {
            key: (v if not torch.is_tensor(v) or v.ndim == 0 or sh is None
                  else sh.gather(name, v, zero=sh.is_zero(name)))
            for key, v in entry.items()}
    return {"model": model, "optimizer": moments, "step": state.step}


def load_full_state(state: TrainState, payload: dict) -> TrainState:
    """Load `full_state`'s payload (from any mesh) into this state, each
    tensor cut to this rank's piece."""
    sh = state.sharding
    params = dict(state.model.named_parameters())
    with torch.no_grad():
        for name, buf in state.model.named_buffers():
            buf.copy_(payload["model"][name])
        for name, p in params.items():
            full = payload["model"][name]
            piece = full if sh is None else sh.cut(name, full)
            target = p.to_local() if hasattr(p, "to_local") else p
            target.copy_(piece)
        if sh is not None:
            sh.after_load()
    for name, t in _opt_tensors(state):
        saved = payload["optimizer"].get(name, {})
        if not saved:
            continue
        entry = {}
        for key, v in saved.items():
            if torch.is_tensor(v) and v.ndim > 0:
                v = v if sh is None else sh.cut(name, v, zero=sh.is_zero(name))
                v = v.to(device=_device(t), copy=True)
                if hasattr(t, "device_mesh"):
                    from torch.distributed.tensor import DTensor

                    v = DTensor.from_local(v, t.device_mesh, t.placements,
                                           run_check=False, shape=t.shape,
                                           stride=t.stride())
            elif torch.is_tensor(v):
                v = v.clone()
            entry[key] = v
        state.optimizer.state[t] = entry
    state.step = int(payload["step"])
    return state


def _device(t):
    return t.to_local().device if hasattr(t, "to_local") else t.device
