"""Differentiable collectives for sequence and tensor parallelism and
synced BatchNorm.

JAX transposes `ppermute`, `all_to_all` and `psum` by itself; PyTorch's
collectives have no gradient, so each collective here is an
`autograd.Function` whose backward is the transposed collective:
  * `ring_shift` sends its tensors to the next rank of the group and
    receives the previous rank's (one `batch_isend_irecv`, `shift`); its
    backward shifts the gradients the other way.
  * `all_to_all` exchanges equal chunks of dim 0 with every rank of the
    group (`all_to_all_single`); the exchange is its own transpose.
  * `all_reduce` sums a tensor over the group; every rank's result depends
    on every rank's input, so its backward sums the gradients likewise.
  * `copy_to_group` and `reduce_from_group` are tensor parallelism's
    pair (Megatron's f and g): where every rank of the group computes the
    same loss from a replicated tensor, the replicated tensor's gradient is
    the sum of the ranks' partial gradients (f: identity forward, sum in the
    backward), and a sum of the ranks' partial results hands each rank the
    whole gradient unchanged (g: sum forward, identity backward).
  * `broadcast_from_first` gives every rank group rank 0's tensor (the
    encoders' CLS row under sequence parallelism); its backward sums the
    ranks' gradients onto rank 0, whose input it was, and gives the others
    zero.
Every rank of the group must make the same calls in the same order, in the
forward and (autograd runs them in reverse) in the backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class TPGroup(NamedTuple):
    """A tensor-parallel group as a module sees it: the group, this rank's
    place in it and its size."""

    group: object
    rank: int
    size: int


def shift(tensors, group, step: int):
    """Send each tensor to group rank (i + step) % n and receive the same
    shapes from (i - step) % n, for rank i (no gradient)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    out = [torch.empty_like(x) for x in tensors]
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in tensors]
    ops += [dist.P2POp(dist.irecv, y, src, group) for y in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(shift([x.contiguous() for x in tensors], group, 1))

    @staticmethod
    def backward(ctx, *grads):
        # Autograd runs this only where an output reaches the loss, and the
        # peers' backward waits for ours: every rank's outputs must reach
        # its loss (ring attention gives a skipped hop's blocks a zero
        # gradient for that).
        return (None, *shift([g.contiguous() for g in grads], ctx.group,
                             -1))


def ring_shift(group, *tensors):
    """The tensors of group rank (i - 1) % n, for rank i: one hop of the
    ring, as `lax.ppermute` with perm [(i, (i + 1) % n)]."""
    return _RingShift.apply(group, *tensors)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _exchange(g, ctx.group)


def _exchange(x, group):
    # both buffers contiguous: empty_like would copy a permuted layout
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(group, x):
    """Chunk j of x's dim 0 goes to group rank j; chunk j of the result
    came from group rank j.  Dim 0 must divide by the group's size."""
    if x.shape[0] % dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) does not divide "
                         f"by the group size {dist.get_world_size(group)}")
    return _AllToAll.apply(group, x)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


def all_reduce(group, x):
    """The sum of x over the group's ranks, differentiable: as `lax.psum`
    over a mesh axis, or what the JAX step's batch-wide reductions come to
    when the batch is sharded over dp."""
    return _AllReduce.apply(group, x)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


def copy_to_group(group, x):
    """x as it is; in the backward, the sum of the ranks' gradients: the
    input of a column-parallel product (tensor parallelism's f)."""
    return _CopyToGroup.apply(group, x)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


def reduce_from_group(group, x):
    """The sum of x over the group's ranks, whose gradient goes back to
    every rank unchanged: the output of a row-parallel product (tensor
    parallelism's g)."""
    return _ReduceFromGroup.apply(group, x)


class _BroadcastFromFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.contiguous().clone()
        dist.broadcast(out, dist.get_global_rank(group, 0), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if dist.get_rank(ctx.group):
            g.zero_()
        return None, g


def broadcast_from_first(group, x):
    """Group rank 0's x on every rank; in the backward, the sum of the
    ranks' gradients on rank 0 and zero on the others."""
    return _BroadcastFromFirst.apply(group, x)


def all_reduce_max(group, x):
    """The elementwise maximum of x over the group (no gradient)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
