"""Ring attention: exact attention over a sequence sharded across ranks.

The counterpart of `tf_operator_tpu/parallel/ring_attention.py` (Liu et
al., "Ring Attention with Blockwise Transformers", arXiv:2310.01889).  Each
rank of the `sp` group holds its query block [B, H, T/n, D]; the K/V blocks
travel the ring one hop per step (`dist.ring_shift`), and each hop's
contribution is merged in log-sum-exp form.  Causal masking uses the
blocks' global offsets: the block that arrives at step s came from rank
(i - s) % n.

`ring_hops` is the per-rank hop loop, written against `(my_idx, n)` and an
iterable of the arriving K/V blocks, so the collective version
(`ring_attention`, whose blocks come from the ring shift) and a
single-process check (blocks handed over from a whole sequence) run the
same hop code.

On the flash path each hop is the forward kernel's (o, lse), as the JAX
ring's `flash_attention_lse` hop, merged in log-sum-exp form; the backward
(`_FlashHops`) is the merge's gradient written out: each hop's dq and
dk/dv kernels get the cotangent, the merged lse and rowsum(dO * O), which
is what the merge's (dO * w, dlse) come to, without rounding dO * w to
bf16.  Grouped K/V blocks travel the ring at their own head count.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import torch

from ..ops.attention import (check_gqa, default_blocks, flash_backward_dkv,
                             flash_backward_dq, flash_forward, repeat_kv)
from .dist import ring_shift

NEG_INF = -1e30


def _block_attend(q, k, v, bias, scale):
    """One q-block x kv-block contribution: (numerator [B, H, Tq, D],
    row max [B, H, Tq], row sum of exp [B, H, Tq]), in f32."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale + bias
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o, m, p.sum(-1)


def _hops_einsum(q, my_idx: int, n: int, blocks, causal: bool, scale: float):
    """The pure-PyTorch hop math (O(T_local^2) logits per hop): an online
    softmax accumulator (numerator, row max, row sum)."""
    t = q.shape[2]
    q32 = q.float()
    acc_o = acc_m = acc_l = None
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    for step, (k_blk, v_blk) in enumerate(blocks):
        src = (my_idx - step) % n
        if causal:
            keep = my_idx * t + rows >= src * t + cols
            bias = torch.where(keep, 0.0, NEG_INF).to(q32)
        else:
            bias = torch.zeros((t, t), dtype=torch.float32, device=q.device)
        o, m, l = _block_attend(q32, k_blk, v_blk, bias, scale)
        if acc_o is None:
            acc_o, acc_m, acc_l = o, m, l
            continue
        new_m = torch.maximum(acc_m, m)
        old_w, new_w = torch.exp(acc_m - new_m), torch.exp(m - new_m)
        acc_l = acc_l * old_w + l * new_w
        acc_o = acc_o * old_w[..., None] + o * new_w[..., None]
        acc_m = new_m
    # guard fully masked rows (only exotic masks make them): no 0/0
    denom = torch.where(acc_l == 0.0, torch.ones_like(acc_l), acc_l)
    return acc_o / denom[..., None]


class _FlashHops(torch.autograd.Function):
    """One rank's flash hop loop, its backward written out.  Under the
    global causal mask a hop is one of three cases: the source block before
    mine -> full (non-causal) attention; mine -> the causal diagonal; after
    mine -> no contribution and no launch.  The forward merges each hop's
    (o, lse) from the kernels in log-sum-exp form into the f32 output O and
    lse L.

    Through the merge, hop h's backward gets the cotangent dO * w_h (w_h =
    exp(lse_h - L)) and the lse cotangent that makes its delta' =
    w_h * rowsum(dO * O); its p = exp(s - lse_h) then enters only as
    p * w_h = exp(s - L).  So each hop's dq and dk/dv are the kernels given
    (dO, L, rowsum(dO * O)), the whole sequence's backward restricted to the
    hop's block.  dO goes to the kernels as it came (no rounding of dO * w_h
    to bf16), and the hops' dq is summed in f32.  A skipped hop's blocks
    get zero gradients, so that the shift that brought them runs its
    backward on every rank."""

    @staticmethod
    def forward(ctx, q, my_idx, n, causal, scale, *blocks):
        q = q.contiguous()
        block_q, block_k = default_blocks(None, None)
        acc_o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc_lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                             device=q.device)
        for src, k_blk, v_blk in _live_hops(my_idx, n, causal, blocks):
            o, lse = flash_forward(q, k_blk, v_blk, scale=scale,
                                   causal=causal and src == my_idx,
                                   window=None, sink=0, block_q=block_q,
                                   block_k=block_k)
            # NEG_INF (never -inf) keeps exp(acc - new) finite
            new_lse = torch.logaddexp(acc_lse, lse)
            acc_o.mul_(torch.exp(acc_lse - new_lse)[..., None])
            acc_o.add_(o.float() * torch.exp(lse - new_lse)[..., None])
            acc_lse = new_lse
        ctx.save_for_backward(q, acc_o, acc_lse, *blocks)
        ctx.args = (my_idx, n, causal, scale, block_q, block_k)
        return acc_o

    @staticmethod
    def backward(ctx, g):
        q, o, lse, *blocks = ctx.saved_tensors
        my_idx, n, causal, scale, block_q, block_k = ctx.args
        delta = (g.float() * o).sum(-1)
        do = g.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        grads = [torch.zeros_like(x) for x in blocks]
        for src, k_blk, v_blk in _live_hops(my_idx, n, causal, blocks):
            opts = dict(scale=scale, causal=causal and src == my_idx,
                        window=None, sink=0)
            dq += flash_backward_dq(q, k_blk, v_blk, do, lse, delta,
                                    block_q=block_q, block_k=block_k, **opts)
            step = (my_idx - src) % n
            grads[2 * step], grads[2 * step + 1] = flash_backward_dkv(
                q, k_blk, v_blk, do, lse, delta, block_q=block_q,
                block_k=block_k, **opts)
        return (dq.to(q.dtype), None, None, None, None, *grads)


def _live_hops(my_idx: int, n: int, causal: bool, blocks):
    """(source rank, k block, v block) of each hop that launches: blocks is
    (k_0, v_0, k_1, v_1, ...), step s bringing rank (my_idx - s) % n's."""
    for step in range(n):
        src = (my_idx - step) % n
        if not (causal and src > my_idx):
            yield src, blocks[2 * step], blocks[2 * step + 1]


def ring_hops(q, my_idx: int, n: int,
              blocks: Iterable[Tuple[torch.Tensor, torch.Tensor]], *,
              causal: bool = True, scale: Optional[float] = None,
              use_flash: bool = True):
    """Rank `my_idx` of `n`: attention of its query block q [B, H, T/n, D]
    over the n K/V blocks that arrive, step s bringing the block of rank
    (my_idx - s) % n.  Returns the merge in f32, before the cast to q's
    dtype that `ring_attention` makes (the backward's delta reads this f32
    merge).  On the einsum path (use_flash=False) the blocks must carry q's
    head count."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash:
        flat = [x for pair in blocks for x in pair]
        return _FlashHops.apply(q, my_idx, n, causal, scale, *flat)
    return _hops_einsum(q, my_idx, n, blocks, causal, scale)


def _ring_blocks(k, v, group, n: int) -> Iterator:
    """This rank's blocks first, then each one hop further round the ring;
    the n-th shift would bring them home and is not made."""
    for step in range(n):
        yield k, v
        if step + 1 < n:
            k, v = ring_shift(group, k, v)


def ring_attention(q, k, v, group, *, causal: bool = True,
                   scale: Optional[float] = None, use_flash: bool = True):
    """Exact attention with the sequence sharded over `group` (the mesh's
    `sp` group): q/k/v are this rank's contiguous shard [B, H, T/n, D] of
    the global sequence, rank i of the group holding positions
    [i*T/n, (i+1)*T/n); the result is this rank's shard of the output.

    use_flash=True runs the flash kernels per hop (`_FlashHops`; their
    plain versions on the CPU); use_flash=False keeps the einsum hop math.  GQA: on the flash
    path the grouped blocks travel the ring as they are (1/group of the
    MHA bytes per hop); the einsum path widens k/v first."""
    import torch.distributed as dist

    check_gqa(q, k)
    if not use_flash:
        k, v = repeat_kv(q, k, v)
    n = dist.get_world_size(group)
    my_idx = dist.get_rank(group)
    return ring_hops(q, my_idx, n, _ring_blocks(k, v, group, n),
                     causal=causal, scale=scale,
                     use_flash=use_flash).to(q.dtype)


def reference_attention(q, k, v, *, causal=True, scale=None):
    """Single-process exact attention over the whole sequence, the oracle
    for the tests."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = logits.shape[-2:]
        keep = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v).to(q.dtype)
