"""Pipeline parallelism over the `pp` mesh axis: GPipe, the interleaved
(virtual-stage) schedule, and the fused one-forward-one-backward (1F1B).

The counterpart of `tf_operator_tpu/parallel/pipeline.py`.  JAX runs each
schedule as one `fori_loop` under `shard_map`, every device holding its
stage; here every process holds its rank's stage and runs its rank's steps
with explicit hops.  Stage s of P lives on pp rank s; with M microbatches
GPipe takes M + P - 1 steps, the interleaved schedule V·P + M - 1 (each
rank holding V chunks, chunk g = v·P + r as rank r's v-th), and 1F1B
M + 2(P - 1) cycles.  Stage functions must keep the activation's shape.

Each schedule is written as one step (GPipe, interleaved) or one cycle
(1F1B) of one rank: a function of what the rank receives that returns what
it hands on.  A loop drives it over a ring:
  * `GroupRing`: this process is one rank of the pp group; a hop is a ring
    shift over the group (`parallel/dist.py`), and the sums JAX's `psum`
    makes are all-reduces.  A one-rank group hops to itself (JAX's
    `ppermute` with perm [(0, 0)]) and makes no collective call;
  * `LocalRing`: this process holds every rank (the card check and the
    tests run P = 2 and 4 on one device); a hop hands each rank's tensor to
    the next rank's slot, and a sum adds the ranks' tensors.

GPipe and the interleaved schedule run under autograd.  A hop's backward is
the reverse hop, a collective that runs only where the hop's output reaches
the loss, and the peers' backward waits for it: every rank's graph must
hold every hop.  JAX gets that by computing the stage on zeros at bubble
steps and masking with `where`.  Here a bubble step skips the stage and
hands on a zero that depends on the carry, and what no later step reads
(rank 0's carries, the last step's activations off the last rank) is tied
to the output by a zero that depends on it.  So each rank launches its
stage once per microbatch, M times, not M + P - 1.  The output is summed
over the group with an identity backward (`reduce_from_group`: every rank
computes the same loss from it), and x enters through `copy_to_group`, so
its gradient (rank 0's stage input gradient, the embedding's share) is
summed over the group, as JAX transposes an input replicated over the axis.

1F1B computes the loss and every gradient in its loop: at cycle c rank r
runs the forward of microbatch c - r without a graph, keeping its input in
a 2P-slot buffer, and the backward of microbatch c - 2(P - 1) + r by
running the stage again from the kept input (`torch.autograd.grad`), so at
most 2P microbatch inputs are live where GPipe's autograd keeps every
microbatch's residuals.  The last rank computes the head's loss and seeds
the backward in the same cycle, with cotangent 1/M.  Two hops a cycle,
explicit and without a graph: activations forward, input gradients back.
The loss, the head's gradients and dx are summed over the ring; the stage
gradients stay on their rank.  `_FusedLoss` hands them to autograd as JAX's
`custom_vjp` does.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .dist import copy_to_group, reduce_from_group, ring_shift, shift


def split_microbatches(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """x [B, ...] as [M, B / M, ...]."""
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(
            f"batch {batch} not divisible by microbatches {num_microbatches}")
    return x.reshape(num_microbatches, batch // num_microbatches,
                     *x.shape[1:])


class GroupRing:
    """This process is pp rank `rank` of `size`, its peers over `group`
    (None for one rank)."""

    def __init__(self, group, rank: int, size: int) -> None:
        if size > 1 and group is None:
            raise ValueError(f"a pipeline of {size} stages needs the pp "
                             "process group")
        self.group, self.size, self.ranks = group, size, (rank,)

    def hop(self, tensors: List[torch.Tensor], back: bool = False):
        """What this rank receives: the previous rank's tensor (the next
        rank's with `back`, without a gradient)."""
        if self.size == 1:
            return list(tensors)
        if back:
            return shift([t.contiguous() for t in tensors], self.group, -1)
        return list(ring_shift(self.group, *tensors))

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x, whose gradient is summed over the ring."""
        return x if self.size == 1 else copy_to_group(self.group, x)

    def gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """The ranks' outputs summed, the gradient handed back unchanged."""
        if self.size == 1:
            return outs[0]
        return reduce_from_group(self.group, outs[0])

    def total(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The ranks' values summed (no gradient)."""
        out = values[0].detach().clone()
        if self.size > 1:
            torch.distributed.all_reduce(out, group=self.group)
        return out


class LocalRing:
    """Every rank of a `size`-stage pipeline in this process; a hop moves
    each rank's tensor into the next rank's slot."""

    def __init__(self, size: int) -> None:
        self.size, self.ranks = size, tuple(range(size))

    def hop(self, tensors: List[torch.Tensor], back: bool = False):
        if back:
            return list(tensors[1:]) + list(tensors[:1])
        return list(tensors[-1:]) + list(tensors[:-1])

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        return sum(outs[1:], outs[0])

    def total(self, values: List[torch.Tensor]) -> torch.Tensor:
        return sum(v.detach() for v in values[1:]) + values[0].detach()


def _zero_of(t: torch.Tensor) -> torch.Tensor:
    """A zero scalar that depends on t."""
    return t.reshape(-1)[0] * 0


# ---------------------------------------------------------------------------
# GPipe and the interleaved schedule: forward steps under autograd


def gpipe_step(stage: Callable, rank: int, size: int, step: int,
               x_mb: torch.Tensor, carry: torch.Tensor):
    """Step `step` of rank `rank` of `size` in GPipe (JAX's `step` in
    `gpipe`): microbatch m = step - rank, when 0 <= m < M, through `stage`,
    fed from x_mb on rank 0 and from the carry elsewhere.  Returns (the
    activation handed on, m where that activation is the pipeline's output
    for microbatch m (the last rank) else None, whether x_mb fed the stage
    in place of the carry).  At a bubble the activation is a zero that
    depends on the carry."""
    m = step - rank
    if not 0 <= m < len(x_mb):
        return carry * 0, None, False
    fed = rank == 0
    act = stage(x_mb[m] if fed else carry)
    return act, (m if rank == size - 1 else None), fed


def interleaved_step(chunks: Sequence[Callable], rank: int, size: int,
                     step: int, x_mb: torch.Tensor, carry: torch.Tensor):
    """Step `step` of rank `rank` in the interleaved schedule (JAX's `step`
    in `gpipe_interleaved`): work item (microbatch m, chunk v) runs at step
    v·P + rank + m, so with M <= P each step has at most one.  Rank 0 takes
    the data for chunk 0 only; every other (rank, chunk), rank 0's chunk
    v > 0 included, takes the carry (rank P - 1's chunk v - 1 output for the
    same microbatch).  Returns as `gpipe_step`, the output being the last
    rank's last chunk's."""
    q = step - rank
    v, m = divmod(q, size)
    if q < 0 or v >= len(chunks) or m >= len(x_mb):
        return carry * 0, None, False
    fed = rank == 0 and v == 0
    act = chunks[v](x_mb[m] if fed else carry)
    last = rank == size - 1 and v == len(chunks) - 1
    return act, (m if last else None), fed


def _forward(step_fn: Callable, steps: int, x: torch.Tensor,
             num_microbatches: int, ring) -> torch.Tensor:
    """Run `steps` steps of `step_fn(local index, rank, step, x_mb, carry)`
    for every rank the ring holds, hopping the activations between steps;
    the pipeline's output [B, ...], the same on every rank."""
    if torch.is_grad_enabled() and not x.requires_grad:
        # every rank's hops must be in its graph (see the module docstring)
        x = x.detach().requires_grad_()
    x_mb = split_microbatches(ring.copy(x), num_microbatches)
    carries = [x_mb[0] * 0 for _ in ring.ranks]
    rows: List[dict] = [{} for _ in ring.ranks]
    loose = []
    for s in range(steps):
        acts = []
        for i, rank in enumerate(ring.ranks):
            act, row, fed = step_fn(i, rank, s, x_mb, carries[i])
            if row is not None:
                rows[i][row] = act
            elif s + 1 == steps:
                loose.append(act)
            if fed:
                loose.append(carries[i])
            acts.append(act)
        if s + 1 < steps:  # the last step's hop would reach nothing
            carries = ring.hop(acts)
    outs = [torch.stack([r[m] for m in range(num_microbatches)]) if r
            else torch.zeros_like(x_mb) for r in rows]
    tie = sum((_zero_of(t) for t in loose), x_mb.new_zeros(()))
    return (ring.gather(outs) + tie).reshape(x.shape)


def gpipe(stages: Sequence[Callable], x: torch.Tensor, num_microbatches: int,
          ring) -> torch.Tensor:
    """GPipe's forward: `stages[i]` is the stage of the ring's i-th rank;
    x [B, ...] enters stage 0.  Returns the activations leaving stage P - 1
    on every rank; their backward is autograd's."""
    size = ring.size
    return _forward(
        lambda i, rank, s, x_mb, carry: gpipe_step(stages[i], rank, size, s,
                                                   x_mb, carry),
        num_microbatches + size - 1, x, num_microbatches, ring)


def gpipe_interleaved(chunks: Sequence[Sequence[Callable]], x: torch.Tensor,
                      num_microbatches: int, ring) -> torch.Tensor:
    """The interleaved forward: `chunks[i]` are the ring's i-th rank's V
    chunks in order.  Needs M <= P (the step assignment is conflict-free
    only then)."""
    size, virtual = ring.size, len(chunks[0])
    if num_microbatches > size:
        raise ValueError(
            f"interleaved schedule needs microbatches ({num_microbatches}) "
            f"<= pipeline stages ({size}); the conflict-free step "
            "assignment (item uniqueness per rank per step) depends on it — "
            "use gpipe for deeper microbatching")
    return _forward(
        lambda i, rank, s, x_mb, carry: interleaved_step(
            chunks[i], rank, size, s, x_mb, carry),
        virtual * size + num_microbatches - 1, x, num_microbatches, ring)


# ---------------------------------------------------------------------------
# 1F1B: the fused loop


class CycleState:
    """One rank's 1F1B state: the kept stage inputs (slot -> input, 2P
    slots), rank 0's input gradients (microbatch -> dx), and the summed
    loss, stage gradients and head gradients."""

    def __init__(self, params: Sequence[torch.Tensor],
                 head_params: Sequence[torch.Tensor], device) -> None:
        self.kept: dict = {}
        self.dx: dict = {}
        self.loss = torch.zeros((), device=device)
        self.dparams = [torch.zeros_like(p) for p in params]
        self.dhead = [torch.zeros_like(p) for p in head_params]


def _save_input(kept: dict, slots: int, f: int, valid: bool,
                inp: torch.Tensor) -> None:
    """Keep a valid forward's input for its backward.  An invalid
    (warm-up or cool-down) forward leaves the slot alone: its clipped index
    aliases a live microbatch's slot."""
    if valid:
        kept[f % slots] = inp


def _accumulate(acc: List[torch.Tensor], grads) -> None:
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(g)


def one_f_one_b_cycle(stage: Callable, params: Sequence[torch.Tensor],
                      head_loss: Callable, head_params: Sequence[torch.Tensor],
                      rank: int, size: int, cycle: int, x_mb: torch.Tensor,
                      y_mb: torch.Tensor, carry_f: torch.Tensor,
                      carry_b: torch.Tensor, state: CycleState):
    """Cycle `cycle` of rank `rank` of `size` in the fused 1F1B (JAX's
    `cycle` in `one_f_one_b`), `params` the stage's parameters and
    `head_loss(act, y)` the head's mean loss on a microbatch.  Returns (the
    activation handed forward, the input gradient handed back); updates
    `state`."""
    num_mb, slots = len(x_mb), 2 * size
    last = rank == size - 1
    # forward of microbatch f = cycle - rank, without a graph
    f = cycle - rank
    f_valid = 0 <= f < num_mb
    f_idx = min(max(f, 0), num_mb - 1)
    inp = x_mb[f_idx] if rank == 0 else carry_f
    with torch.no_grad():
        act = stage(inp) if f_valid else torch.zeros_like(inp)
    _save_input(state.kept, slots, f_idx, f_valid, inp)
    seed = None
    if last and f_valid:
        # the head's loss, and the backward's seed, in the same cycle
        with torch.enable_grad():
            a = act.detach().requires_grad_()
            loss = head_loss(a, y_mb[f_idx])
            seed, *dhead = torch.autograd.grad(
                loss, [a, *head_params], loss.new_tensor(1.0 / num_mb),
                allow_unused=True)
        state.loss += loss.detach()
        _accumulate(state.dhead, dhead)
    # backward of microbatch b = cycle - 2(P - 1) + rank, the stage run
    # again from its kept input
    b = cycle - 2 * (size - 1) + rank
    if not 0 <= b < num_mb:
        return act, torch.zeros_like(carry_b)
    cot = seed if last else carry_b
    with torch.enable_grad():
        i = state.kept[b % slots].detach().requires_grad_()
        out = stage(i)
        dinp, *dparams = torch.autograd.grad(
            out, [i, *params], cot.to(out.dtype), allow_unused=True)
    _accumulate(state.dparams, dparams)
    if rank == 0:
        state.dx[b] = dinp
    return act, dinp


def one_f_one_b(stages: Sequence[Callable],
                params: Sequence[Sequence[torch.Tensor]],
                head_loss: Callable, head_params: Sequence[torch.Tensor],
                x: torch.Tensor, y: torch.Tensor, num_microbatches: int,
                ring):
    """The fused loop over every rank the ring holds (`stages[i]`,
    `params[i]`: the i-th rank's stage and its parameters).  Returns (the
    mean loss, each held rank's stage gradients, the head's gradients, dx),
    the loss, head gradients and dx summed over the ring."""
    size = ring.size
    x_mb = split_microbatches(x.detach(), num_microbatches)
    y_mb = split_microbatches(y, num_microbatches)
    states = [CycleState(params[i], head_params, x.device)
              for i in range(len(ring.ranks))]
    carries_f = [torch.zeros_like(x_mb[0]) for _ in ring.ranks]
    carries_b = [torch.zeros_like(x_mb[0]) for _ in ring.ranks]
    for c in range(num_microbatches + 2 * (size - 1)):
        acts, dinps = [], []
        for i, rank in enumerate(ring.ranks):
            act, dinp = one_f_one_b_cycle(
                stages[i], params[i], head_loss, head_params, rank, size, c,
                x_mb, y_mb, carries_f[i], carries_b[i], states[i])
            acts.append(act)
            dinps.append(dinp)
        carries_f = ring.hop(acts)
        carries_b = ring.hop(dinps, back=True)
    loss = ring.total([s.loss for s in states]) / num_microbatches
    dhead = [ring.total([s.dhead[j] for s in states])
             for j in range(len(head_params))]
    dx = ring.total([torch.stack([s.dx[m] for m in range(num_microbatches)])
                     if s.dx else torch.zeros_like(x_mb) for s in states])
    return (loss, [s.dparams for s in states], dhead,
            dx.reshape(x.shape))


class _FusedLoss(torch.autograd.Function):
    """The fused loop's loss, whose backward scales the gradients the loop
    computed by the incoming cotangent (JAX's `custom_vjp`)."""

    @staticmethod
    def forward(ctx, run, *inputs):
        loss, grads = run()
        ctx.grads = grads
        return loss

    @staticmethod
    def backward(ctx, g):
        return (None, *(None if t is None else (t * g).to(t.dtype)
                        for t in ctx.grads))


def one_f_one_b_loss(stages: Sequence[Callable],
                     params: Sequence[Sequence[torch.Tensor]],
                     head_loss: Callable, head_params: Sequence[torch.Tensor],
                     x: torch.Tensor, y: torch.Tensor, num_microbatches: int,
                     ring) -> torch.Tensor:
    """The mean loss through the fused loop, differentiable in x, the head's
    parameters and every held rank's stage parameters."""
    flat = [p for group in params for p in group]

    def run():
        loss, dparams, dhead, dx = one_f_one_b(
            stages, params, head_loss, head_params, x, y, num_microbatches,
            ring)
        return loss, [dx, *dhead, *(g for group in dparams for g in group)]

    return _FusedLoss.apply(run, x, *head_params, *flat)


def needs_grad(tensors) -> bool:
    """Whether autograd would differentiate through any of `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)

