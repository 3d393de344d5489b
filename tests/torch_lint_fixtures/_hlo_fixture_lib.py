"""Shared capture helpers for the port's bad_hlo_* fixtures.

Each bad_hlo_*.py fixture is one deliberately broken (or deliberately
constrained) train step of the tiny LM (`analysis/hlo.build_workload`)
whose recording fires exactly one of the four rules
(`tf_operator_tpu_torch/analysis/hlo.py`).  `good_capture` here is the
CORRECT step, the port's own ZeRO machinery at the JAX package's capture
shapes, and each fixture derives its one defect from it, so a fixture can
only fire the rule its twist introduces.

Loaded by the fixtures through a sys.path insert (this directory is not a
package); every rank of the capture's process group runs them.
"""
from __future__ import annotations

import torch


def good_capture(num_devices, *, overlap=False, budget_bytes=0,
                 opt_replicated=False, workload="hlo-fixture"):
    """Capture the correct tiny ZeRO train step of the LM over
    {"dp": num_devices}.

    overlap=True marks every sharded plan entry overlappable (arms
    hlo-sync-collective: the port gathers with async_op=False);
    budget_bytes declares a per-rank memory budget (arms
    hlo-memory-infeasible when the step cannot fit); opt_replicated=True
    swaps in an optimizer that keeps each parameter's whole momentum while
    the declared plan, which the expectation is always computed from, says
    sharded (arms hlo-replicated-optstate)."""
    from tf_operator_tpu_torch.analysis import hlo
    from tf_operator_tpu_torch.train.optim import sgd

    built = hlo.build_workload("lm", overlap=overlap)
    if opt_replicated:
        state = built.state
        state.tx = sgd(0.1)
        state.optimizer = WholeMomentSGD(
            [t for _, t in state.sharding.opt_named()],
            [p.shape for p in state.sharding.params.values()])
        built.moments_per_param = 1
    return hlo.capture_built(workload, built, zero=True,
                             device_memory_budget_bytes=budget_bytes)


class WholeMomentSGD(torch.optim.Optimizer):
    """SGD with momentum over this rank's ZeRO slices whose momentum
    buffers are the whole parameters' (the defect): every rank keeps every
    element's moment, though it updates only its slice."""

    def __init__(self, slices, wholes, lr=0.1, momentum=0.9):
        super().__init__(slices, dict(lr=lr, momentum=momentum))
        self.wholes = {id(s): tuple(w) for s, w in zip(slices, wholes)}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for s in group["params"]:
                if s.grad is None:
                    continue
                state = self.state[s]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros(
                        self.wholes[id(s)], dtype=s.dtype, device=s.device)
                mine = state["momentum_buffer"].view(-1)[:s.numel()]
                mine = mine.view_as(s)
                mine.mul_(group["momentum"]).add_(s.grad)
                s.add_(mine, alpha=-group["lr"])


def drift_capture(num_devices, workload="hlo-fixture"):
    """The plan-drift step: a declared ZeRO plan, but the step neither
    reduces the gradients nor gathers the updated slices back: each rank
    cuts its slice of its own gradient, the moments advance slice-locally
    and the parameters never see the update.  The step therefore issues
    no collective at all, while the plan demands one weight-update
    all-gather per sharded entry and a gradient reduction.  The moments
    sit at the plan's shard shapes, so only hlo-plan-drift fires."""
    from tf_operator_tpu_torch.analysis import hlo
    from tf_operator_tpu_torch.train.zero import slice_along

    built = hlo.build_workload("lm")
    sh = built.state.sharding
    group = sh.mesh.group("dp")
    loss_fn = built.loss

    def step(state, batch):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(batch)
        loss.backward()
        for name, piece in sh.slices.items():
            p = sh.params[name]
            # the defect: this rank's own gradient, never summed over dp
            piece.grad = slice_along(sh._zero_view(name, p.grad),
                                     sh.zero_dims[name], group).clone()
            p.grad = None
        state.tx.update(state.optimizer, [t for _, t in sh.opt_named()],
                        state.step)
        state.step += 1
        return state, {"loss": loss.detach()}

    built.step = step
    return hlo.capture_built(workload, built, zero=True)


def unreduced_capture(num_devices, workload="hlo-fixture"):
    """The unreduced-gradient step: the real ZeRO step (its weight-update
    all-gathers, the loss's all-reduce, the clip norm's) except that each
    ZeRO slice takes this rank's own gradient instead of the
    reduce-scatter's sum over dp, so each rank trains on its own shard of
    the batch.  A reduction is still issued (the loss's), but it sums a
    few bytes where the plan owes every sharded entry's gradient, so only
    hlo-plan-drift fires."""
    from tf_operator_tpu_torch.analysis import hlo
    from tf_operator_tpu_torch.parallel.shard import local
    from tf_operator_tpu_torch.train.zero import slice_along

    built = hlo.build_workload("lm")
    sh = built.state.sharding
    group = sh.mesh.group("dp")

    def reduce_grads():
        for name, piece in sh.slices.items():
            p = sh.params[name]
            # the defect: this rank's own gradient, never summed over dp
            piece.grad = slice_along(sh._zero_view(name, local(p.grad)),
                                     sh.zero_dims[name], group).clone()
            p.grad = None

    sh.reduce_grads = reduce_grads
    return hlo.capture_built(workload, built, zero=True)
