"""Mixture of experts with expert parallelism over the `ep` mesh axis.

The counterpart of `tf_operator_tpu/parallel/moe.py`: top-k gating with a
capacity factor (Switch/GShard), a stacked expert FFN wi [E, d, f] and
wo [E, f, d] (no biases, tanh GELU, bf16 compute), an f32 router with a
bias, and the Switch load-balancing loss E * sum_e(frac_top1_e *
mean_prob_e), averaged over the MoE layers.

The JAX layer builds dense one-hot [N, E, C] dispatch and combine masks and
contracts them with einsums.  At GPT-small (N = 16384 tokens, C = 5120)
each mask holds 671 M elements, so the port computes the same function from
indices (`route`): each token's chosen experts, gates, queue positions and
whether it fits; the kept tokens are scattered into an [E, C', d] buffer,
the experts run as one batched product, and each token gathers its
experts' outputs weighted by its gates.  The result is the einsums': a slot
holds at most one token, an empty slot gives FFN(0) = 0 (the experts have
no bias), and the gates are rounded to the compute dtype before they weigh
the outputs, as JAX rounds `combine`.  `top_k_gating` returns JAX's dense
masks from the same routing, for tests.

Under GSPMD the JAX layer sees the global batch: the capacity, the queue
positions (a cumsum over the flattened [b, t] order) and the loss's means
come from all of its tokens.  A rank of the port holds a slice of them
over the data axes (dp, fsdp) and the sequence axis (sp), so `MoEMLP`
gathers the router logits over those groups (`token_groups`, set by
`parallel/shard.py`), routes the global [N, E] logits in JAX's token order
and keeps its own rows.  The gather's backward sums the ranks' gradients
and hands each rank its slice, so the loss term every data rank adds (and
the step scales by 1 / ranks) counts once.

Over `ep` the tokens are replicated and each rank holds E / ep experts:
it runs its experts on their tokens and the partial outputs are summed over
the ep group (`reduce_from_group`), the expert input's gradient summed back
(`copy_to_group`).  The routing is computed alike on every ep rank; its
logits' gradient (each rank's gates reach only its experts) is summed over
the group, with the load-balancing term's share taken on ep rank 0 alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.initializers import lecun_normal_
from .dist import copy_to_group, reduce_from_group


@dataclass
class Routing:
    """The gating of N tokens over k rounds: `choice`, `gate`, `pos` and
    `keep` are [k, N] (round r's expert, its probability, the token's place
    in that expert's queue, and whether the place is under the capacity);
    `aux` is the load-balancing loss."""

    choice: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor

    def rows(self, select) -> "Routing":
        """The routing of the tokens `select` picks (an index or slice of
        the token dim)."""
        return Routing(self.choice[:, select], self.gate[:, select],
                       self.pos[:, select], self.keep[:, select], self.aux)


def capacity_for(n_tok: int, k: int, capacity_factor: float,
                 num_experts: int) -> int:
    """Slots per expert: max(1, int(k * n_tok * cf / E)), truncated as the
    JAX layer truncates it."""
    return max(1, int(k * n_tok * capacity_factor / num_experts))


def _counts(choice: torch.Tensor, e: int) -> torch.Tensor:
    """[E, N]: for each expert, how many of tokens 0..i chose it."""
    experts = torch.arange(e, device=choice.device)
    return (choice[None, :] == experts[:, None]).cumsum(1)


def route(logits: torch.Tensor, k: int, capacity: int) -> Routing:
    """Top-k gating of logits [N, E] (softmax in f32): round r picks each
    token's best expert among those not yet picked (ties to the first
    index), its gate is that expert's probability, and its queue position
    counts the tokens before it in [N] order that picked the same expert
    this round, after every token any earlier round sent there (dropped
    tokens included, as in JAX)."""
    n, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = probs.argmax(-1)
    frac = F.one_hot(top1, e).float().mean(0)
    aux = e * (frac * probs.mean(0)).sum()
    remaining = probs
    fill = torch.zeros(e, dtype=torch.long, device=logits.device)
    choices, gates, positions = [], [], []
    for _ in range(k):
        choice = remaining.argmax(-1)
        gate = remaining.gather(-1, choice[:, None])[:, 0]
        # [E, N] counts along the tokens (a scan over the inner dim)
        counts = _counts(choice, e)
        remaining = remaining.masked_fill(F.one_hot(choice, e).bool(), 0.0)
        positions.append(counts.gather(0, choice[None])[0] - 1
                         + fill[choice])
        fill = fill + counts[:, -1]
        choices.append(choice)
        gates.append(gate)
    pos = torch.stack(positions)
    return Routing(torch.stack(choices), torch.stack(gates), pos,
                   pos < capacity, aux)


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's (dispatch [N, E, C], combine [N, E, C], aux) in f32, built from
    `route`: the dense masks the port never forms on its path."""
    r = route(logits, k, capacity)
    n, e = logits.shape
    dispatch = logits.new_zeros((n, e, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    for i in range(k):
        rows = r.keep[i].nonzero()[:, 0]
        at = (rows, r.choice[i, rows], r.pos[i, rows])
        dispatch = dispatch.index_put(at, torch.ones_like(r.gate[i, rows]),
                                      accumulate=True)
        combine = combine.index_put(at, r.gate[i, rows], accumulate=True)
    return dispatch, combine, r.aux


def expert_ffn(tokens: torch.Tensor, routing: Routing, wi: torch.Tensor,
               wo: torch.Tensor, dtype, first_expert: int = 0,
               capacity: Optional[int] = None) -> torch.Tensor:
    """sum over rounds of keep * gate * FFN_choice(token) for tokens [n, d]
    and their routing, over the experts wi [E', d, f], wo [E', f, d]
    (experts first_expert .. first_expert + E' - 1; tokens routed elsewhere
    add nothing).  The kept tokens fill a [E', C', d] buffer (C' = at most
    `capacity` per expert, and never more than n), the experts run as one
    batched product in `dtype`, and each token sums its experts' outputs
    times its gates rounded to `dtype`, in f32.  Returns [n, d] in
    `dtype`."""
    n, d = tokens.shape
    local = wi.shape[0]
    choice = routing.choice.reshape(-1) - first_expert
    take = (routing.keep.reshape(-1) & (choice >= 0)
            & (choice < local)).nonzero()[:, 0]
    expert = choice[take]
    row = take % n
    # each expert's entries in order: the slot of an entry in its buffer
    slot = _counts(expert, local).gather(0, expert[None])[0] - 1
    per = min(n, capacity if capacity is not None else n)
    index = expert * per + slot
    x = tokens.to(dtype)
    buf = x.new_zeros((local * per, d)).index_copy(0, index, x[row])
    h = torch.bmm(buf.view(local, per, d), wi.to(dtype))
    h = F.gelu(h, approximate="tanh")
    y = torch.bmm(h, wo.to(dtype)).view(local * per, d)
    gate = routing.gate.reshape(-1)[take].to(dtype)
    out = torch.zeros((n, d), dtype=torch.float32, device=tokens.device)
    out = out.index_add(0, row, y[index].float() * gate.float()[:, None])
    return out.to(dtype)


class _GatherRows(torch.autograd.Function):
    """The group's tensors joined along `dim` in group-rank order; the
    backward sums the gradient over the group and keeps this rank's
    slice (every rank may use every slice)."""

    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return None, None, g.chunk(n, ctx.dim)[dist.get_rank(ctx.group)]


def gather_rows(group, x, dim: int):
    return _GatherRows.apply(group, dim, x)


class MoEMLP(nn.Module):
    """Drop-in replacement for the transformer MLP: forward(x [B, T, d])
    -> [B, T, d] in x's dtype; the layer's load-balancing loss of the last
    forward is in `aux_loss`."""

    # the ep group (parallel.dist.TPGroup) when this rank holds E / ep of
    # the experts
    ep = None
    # (group, dim) for each group whose ranks hold other tokens of the
    # batch, in the order the gather joins them: the sp group on the
    # sequence dim, then the data group (dp, fsdp) on the batch dim; a
    # group of None is the whole world
    token_groups: Tuple[Tuple[Optional[object], int], ...] = ()

    def __init__(self, d_model: int, d_ff: int, num_experts: int = 8,
                 k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_experts, self.k = num_experts, k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.router = nn.Linear(d_model, num_experts)
        self.wi = nn.Parameter(torch.empty(num_experts, d_model, d_ff))
        self.wo = nn.Parameter(torch.empty(num_experts, d_ff, d_model))
        self.aux_loss: Optional[torch.Tensor] = None

    def reset_parameters(self, generator=None):
        """flax's defaults: the router lecun-normal with a zero bias, the
        experts N(0, 0.02)."""
        lecun_normal_(self.router.weight, self.router.in_features, generator)
        with torch.no_grad():
            self.router.bias.zero_()
            self.wi.normal_(0.0, 0.02, generator=generator)
            self.wo.normal_(0.0, 0.02, generator=generator)

    def _gather(self, logits: torch.Tensor):
        """logits [b, t, E] of this rank's tokens -> the global [B, T, E]
        and the indices of this rank's tokens among the global ones (in
        [B, T] order, flattened)."""
        select = [slice(None), slice(None)]
        for group, dim in self.token_groups:
            i = dist.get_rank(group)
            size = logits.shape[dim]
            logits = gather_rows(group, logits, dim)
            select[dim] = slice(i * size, (i + 1) * size)
        grid = torch.arange(logits.shape[0] * logits.shape[1],
                            device=logits.device).view(logits.shape[:2])
        return logits, grid[tuple(select)].reshape(-1)

    def forward(self, x: torch.Tensor, local: bool = False) -> torch.Tensor:
        """`local` routes this rank's tokens alone (decoding, where each
        rank runs its own sequences)."""
        b, t, d = x.shape
        tokens = x.reshape(b * t, d)
        logits = self.router(tokens.float()).view(b, t, -1)
        if self.ep is not None:
            logits = copy_to_group(self.ep.group, logits)
        mine = None
        if self.token_groups and not local:
            logits, mine = self._gather(logits)
        n_tok = logits.shape[0] * logits.shape[1]
        capacity = capacity_for(n_tok, self.k, self.capacity_factor,
                                self.num_experts)
        routing = route(logits.reshape(n_tok, -1), self.k, capacity)
        if mine is not None:
            routing = routing.rows(mine)
        first = 0
        if self.ep is not None:
            tokens = copy_to_group(self.ep.group, tokens)
            first = self.ep.rank * self.wi.shape[0]
            if self.ep.rank:
                # the term's gradient is summed over ep with the gates':
                # count it on one rank
                routing.aux = routing.aux.detach()
        self.aux_loss = routing.aux
        out = expert_ffn(tokens, routing, self.wi, self.wo, self.dtype,
                         first, capacity)
        if self.ep is not None:
            out = reduce_from_group(self.ep.group, out)
        return out.view(b, t, d).to(x.dtype)


def moe_aux_loss(model) -> torch.Tensor:
    """The mean of the MoE layers' load-balancing losses from the model's
    last forward (mean, not sum: the weight tunes alike at any depth); 0
    without MoE layers."""
    losses = [m.aux_loss for m in model.modules()
              if isinstance(m, MoEMLP) and m.aux_loss is not None]
    if not losses:
        return torch.zeros(())
    return sum(losses) / len(losses)

