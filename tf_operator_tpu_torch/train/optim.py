"""Optimizer recipes: the LM's AdamW (linear warmup + cosine decay,
global-norm gradient clipping, weight decay on matrices only), the
classification workloads' `optax.sgd` with momentum and unmasked
`optax.adamw`, and MNIST's `optax.adam`.

A recipe is the optax GradientTransformation's counterpart: `init(model)`
builds the torch optimizer over the model's parameters (or over `named`
tensors in their place: under ZeRO, slices of them), and
`update(optimizer, params, count)` applies one step from the gradients in
`.grad` (`train/state.TrainState` takes any recipe).  Over a sharded
layout the clip's global norm is the full gradient's: each tensor's sum of
squares is summed over the groups its elements are split over
(`shard_groups`), and a replicated tensor counts once.

The LM recipe is the counterpart of `tf_operator_tpu/train/optim.py` (an
optax chain), kept to optax's arithmetic where PyTorch's defaults differ:
  * clipping scales by max_norm / norm with no epsilon, and only when
    norm >= max_norm (`torch.nn.utils.clip_grad_norm_` adds 1e-6);
  * the schedule is evaluated at the update count before it is incremented,
    so the first update uses lr(0).
The moments and the decoupled decay are torch.optim.AdamW's, which computes
optax's adamw update up to rounding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


def decay_mask(model) -> dict:
    """{name: True} for parameters weight decay applies to: rank >= 2
    (matmul kernels, embeddings); biases / norm scales are excluded.  The
    rank is the whole parameter's: slicing and sharding keep it."""
    return {name: p.ndim >= 2 for name, p in model.named_parameters()}


def lr_schedule(peak_lr: float, *, schedule: str = "constant",
                warmup_steps: int = 0, total_steps: Optional[int] = None,
                end_fraction: float = 0.1) -> Callable[[int], float]:
    """A learning-rate schedule count -> lr: linear warmup from 0 over
    `warmup_steps`, then constant, or cosine decay to
    `end_fraction * peak_lr` by `total_steps` (required for cosine).  The
    same values as optax's warmup_cosine_decay_schedule / join_schedules."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"schedule must be 'constant'|'cosine', got {schedule!r}")
    if schedule == "cosine" and not total_steps:
        raise ValueError("cosine schedule needs total_steps")

    def warmup(count: int) -> float:
        return peak_lr * min(max(count, 0), warmup_steps) / warmup_steps

    if schedule == "cosine":
        decay_steps = total_steps - warmup_steps
        if decay_steps <= 0:
            raise ValueError(
                "cosine schedule needs total_steps > warmup_steps")
        alpha = end_fraction if peak_lr else 0.0

        def after(count: int) -> float:
            count = min(count, decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
            return peak_lr * ((1 - alpha) * cosine + alpha)
    else:
        def after(count: int) -> float:
            return peak_lr

    def sched(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        return after(count - warmup_steps)

    return sched


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def clip_by_global_norm_(params, max_norm: float,
                         shard_groups=None) -> torch.Tensor:
    """Scale the gradients in place by max_norm / norm when their global
    norm is >= max_norm, exactly as optax.clip_by_global_norm (no epsilon).
    Returns the norm.  With `shard_groups` (for each of `params`, the
    process groups its elements are split over) the gradients are this
    rank's pieces and the norm is the whole gradient's."""
    params = list(params)
    if shard_groups is None or not any(shard_groups):
        # nothing split over more than one rank: the one-process arithmetic
        grads = [_local(p.grad) for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float())
                         for g in grads]))
    else:
        import torch.distributed as dist

        # sum the squares per set of groups, then over each set's groups
        sums = {}
        for p, groups in zip(params, shard_groups):
            if p.grad is not None:
                sq = _local(p.grad).float().pow(2).sum()
                sums[groups] = sums.get(groups, 0) + sq
        total = 0
        for groups, sq in sums.items():
            for group in groups:
                dist.all_reduce(sq, group=group)
            total = total + sq
        norm = torch.sqrt(total)
        grads = [_local(p.grad) for p in params if p.grad is not None]
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor)
    return norm


@dataclass(frozen=True)
class AdamW:
    """AdamW at lr(count), after a global-norm clip when `grad_clip` > 0;
    weight decay only where `decay_mask` says when `masked`, else on every
    parameter."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    masked: bool = True

    def init(self, model, named=None) -> torch.optim.AdamW:
        named = list(model.named_parameters()) if named is None else named
        if not self.masked:
            return torch.optim.AdamW(
                [t for _, t in named], lr=self.schedule(0),
                betas=(self.b1, self.b2), eps=self.eps,
                weight_decay=self.weight_decay)
        mask = decay_mask(model)
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": self.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0},
        ]
        return torch.optim.AdamW(groups, lr=self.schedule(0),
                                 betas=(self.b1, self.b2), eps=self.eps)

    def update(self, optimizer: torch.optim.Optimizer, params,
               count: int, shard_groups=None) -> None:
        if self.grad_clip:
            clip_by_global_norm_(params, self.grad_clip, shard_groups)
        lr = self.schedule(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


def lm_optimizer(peak_lr: float, *, schedule: str = "constant",
                 warmup_steps: int = 0, total_steps: Optional[int] = None,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.95) -> AdamW:
    """AdamW + clipping + masked decay under the configured schedule."""
    sched = lr_schedule(peak_lr, schedule=schedule,
                        warmup_steps=warmup_steps, total_steps=total_steps)
    return AdamW(sched, b1=b1, b2=b2, weight_decay=weight_decay,
                 grad_clip=grad_clip)


def adam(lr: float) -> AdamW:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 (outside the square
    root), a constant rate, no weight decay and no clip (the MNIST
    workload's recipe)."""
    return AdamW(lambda count: lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, grad_clip=0.0, masked=False)


def adamw(lr: float) -> AdamW:
    """`optax.adamw(lr)` with optax's defaults: b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4 on every parameter (mask=None), a constant rate and
    no clip (the ViT and BERT workloads' recipe)."""
    return AdamW(lambda count: lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4, grad_clip=0.0, masked=False)


@dataclass(frozen=True)
class SGD:
    """`optax.sgd(lr, momentum)`: the trace t = g + momentum * t (zero at
    first) and the step -lr * t, which is torch's SGD with dampening 0; no
    weight decay, no clip (the ResNet workload's recipe)."""

    lr: float
    momentum: float = 0.9

    def init(self, model, named=None) -> torch.optim.SGD:
        tensors = (model.parameters() if named is None
                   else [t for _, t in named])
        return torch.optim.SGD(tensors, lr=self.lr, momentum=self.momentum,
                               dampening=0.0)

    def update(self, optimizer: torch.optim.Optimizer, params,
               count: int, shard_groups=None) -> None:
        optimizer.step()


def sgd(lr: float, momentum: float = 0.9) -> SGD:
    return SGD(lr, momentum)
