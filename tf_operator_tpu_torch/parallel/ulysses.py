"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange.

The counterpart of `tf_operator_tpu/parallel/ulysses.py` (DeepSpeed-
Ulysses, arXiv:2309.14509).  Where the ring keeps queries resident and
rotates K/V blocks hop by hop, Ulysses makes one all-to-all that re-shards
the activations from sequence-sharded [B, H, T/n, D] to head-sharded
[B, H/n, T, D], runs full-sequence attention locally on its heads
(`flash_attention`: the kernels on the card), and all-to-alls back.  The
head axes must divide by the group size; grouped K/V whose head count does
not are widened to q's first.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..ops.attention import attention, check_gqa, flash_attention, repeat_kv
from .dist import all_to_all


def _seq_to_heads(x, group, n: int):
    """[B, H, T/n, D] (this rank's positions) -> [B, H/n, T, D] (this
    rank's heads): split heads, send chunk j to rank j, concatenate the
    sequence chunks in rank order (`lax.all_to_all(split_axis=1,
    concat_axis=2, tiled=True)`)."""
    b, h, t, d = x.shape
    chunks = x.reshape(b, n, h // n, t, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(group, chunks.contiguous())  # [n (src), B, H/n, t, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * t, d)


def _heads_to_seq(x, group, n: int):
    """The inverse: [B, H/n, T, D] -> [B, H, T/n, D]."""
    b, hn, t_all, d = x.shape
    t = t_all // n
    chunks = x.reshape(b, hn, n, t, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(group, chunks.contiguous())  # [n (src), B, H/n, t, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * hn, t, d)


def ulysses_attention(q, k, v, group, *, causal: bool = True,
                      scale: Optional[float] = None, use_flash: bool = True):
    """Exact attention with the sequence sharded over `group` (the mesh's
    sequence-parallel group), exchanged to head sharding for the local
    compute.
    q/k/v are this rank's shard [B, H, T/n, D]; returns this rank's shard
    of the output.  Requires num_heads % n == 0; grouped k/v heads that do
    not divide by n are widened to q's head count before the exchange."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    check_gqa(q, k)
    sp = dist.get_world_size(group)
    h = q.shape[1]
    if h % sp:
        raise ValueError(
            f"ulysses_attention needs num_heads ({h}) divisible by the "
            f"sequence-parallel group size ({sp}); use ring attention for "
            "head-count-constrained shapes")
    if k.shape[1] % sp:
        # kv group too small to split across sp: widen to MHA up front
        k, v = repeat_kv(q, k, v)
    qh, kh, vh = (_seq_to_heads(x, group, sp) for x in (q, k, v))
    if use_flash:
        out = flash_attention(qh, kh, vh, causal, scale)
    else:
        out = attention(qh, *repeat_kv(qh, kh, vh), causal=causal,
                        scale=scale)
    return _heads_to_seq(out, group, sp)
