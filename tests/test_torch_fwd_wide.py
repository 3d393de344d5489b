"""The forward at head-dim class 256 over 128 rows (`fwd_kernel` with two
consumer warpgroups), held here on the CPU: a model of its grid's order
and the host's choice of chunk.

The grid has one block per item, a (b*h, 128-row tile), and is not
persistent: the hardware starts each block, in launch order, on the first
SM to come free.  Block x takes the items longest first across the b*h
rows of a chunk, chunks in turn (flash_attention.cu:lpt_tile).  `items`
below is that formula written out in Python, with `key_steps` for
`key_tiles`, so the tests can show that every item is taken exactly once
under every mask, each chunk's tiles from the last (the longest without a
window) down, and that on 132 SMs the SM that finishes last at Gemma 2B's
causal shape is left about a balanced share (`first_free`).  No JAX; the
kernel is held on the card (tests/test_torch_kernels_cuda.py).
"""
import heapq

import pytest

from tf_operator_tpu_torch.ops import attention as A

BM, BK = 128, 64  # the tile's rows and key step
SMS = 132  # an H100 SXM's
L2 = 50 * 2 ** 20  # and its L2


def key_steps(q0, t, causal=True, window=None, sink=0):
    """The 64-key tiles the rows [q0, q0 + BM) visit
    (flash_attention.cu:key_tiles)."""
    n_kt = -(-t // BK)
    hi = min(n_kt, (min(q0 + BM, t) - 1) // BK + 1) if causal else n_kt
    lo = max(0, q0 - window + 1) // BK if window else 0
    n_sink = min(-(-sink // BK), lo) if sink else 0
    return n_sink + hi - lo


def items(bh, t, chunk):
    """[(b*h, row tile)] of blocks 0, 1, ... (flash_attention.cu:
    lpt_tile)."""
    n = -(-t // BM)
    out = []
    for x in range(bh * n):
        c, r = x // (chunk * n), x % (chunk * n)
        size = min(chunk, bh - c * chunk)
        out.append((c * chunk + r % size, n - 1 - r // size))
    return out


def first_free(blocks, t, sms=SMS):
    """Key steps of the SM that finishes last when the blocks start in
    launch order, each on the first SM to come free."""
    free = [0] * sms
    for _, tile in blocks:
        heapq.heapreplace(free, free[0] + key_steps(tile * BM, t))
    return max(free)


MASKS = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window_sink": dict(causal=True, window=256, sink=4),
    "window": dict(causal=True, window=100),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("bh,t,chunk", [
    (32, 2048, 32), (32, 2048, 8), (32, 2048, 12), (6, 2048, 6),
    (16, 1000, 5), (1, 300, 1), (7, 2048, 3), (400, 1000, 24)])
def test_every_item_is_taken_once_last_tile_first(mask, bh, t, chunk):
    """Each (b*h, row tile) once, by one block, chunk by chunk (a last
    chunk that is short included), each chunk's row tiles from the last
    down; without a window (under one a ragged last tile may visit fewer
    key tiles than the one before it) no item visits more key tiles than
    one before it in its chunk."""
    order = items(bh, t, chunk)
    n = -(-t // BM)
    assert sorted(order) == [(b, i) for b in range(bh) for i in range(n)]
    opts = MASKS[mask]
    for c0 in range(0, bh, chunk):
        mine = [tile for b, tile in order if c0 <= b < c0 + chunk]
        assert mine == sorted(mine, reverse=True)
        steps = [key_steps(tile * BM, t, **opts) for tile in mine]
        if "window" not in opts:
            assert steps == sorted(steps, reverse=True)
    assert {b for b, _ in order[:min(chunk, bh)]} == set(
        range(min(chunk, bh)))


def test_longest_first_evens_out_gemma_2b_s_causal_tail():
    """Gemma 2B's attention (B 4, 8 query heads over one KV head, T 2048,
    causal): 8,704 key steps over 132 SMs, 65.9 each.  With each b*h's
    tiles adjacent (the grid before) the busiest SM took 86; longest first
    over the host's chunk (all 32 rows), 68.  d256_gqa6 (B 1, 6 heads) has
    96 blocks, one wave: its longest, 32 key steps, sets it in any
    order."""
    chunk = A.fwd_chunk(32, 8, 2048, L2)
    assert chunk == 32
    order = items(32, 2048, chunk)
    assert sum(key_steps(tile * BM, 2048) for _, tile in order) == 8704
    bh_major = [(x // 16, 15 - x % 16) for x in range(32 * 16)]
    assert first_free(bh_major, 2048) == 86
    assert first_free(order, 2048) == 68
    assert A.fwd_chunk(6, 6, 2048, L2) == 6
    assert len(items(6, 2048, 6)) == 96
    assert first_free(items(6, 2048, 6), 2048) == 32


@pytest.mark.parametrize("bh,group,t,want", [
    (32, 8, 2048, 32),    # Gemma 2B's attention, B 4: 4 KV heads, 8 MB
    (6, 6, 2048, 6),      # d256_gqa6
    (64, 1, 2048, 4),     # Gemma 7B's widths (16 MHA heads of 256) at B 4
    (64, 8, 2048, 32),    # Gemma 2B at B 8: 8 KV heads, 4 a chunk
    (64, 8, 8192, 8),     # and at T 8192: one KV head of 8 MB a chunk
    (4, 1, 65536, 1),     # one head's K and V past a sixth of L2: 1
])
def test_fwd_chunk_keeps_the_heads_in_flight_within_a_sixth_of_l2(
        bh, group, t, want):
    got = A.fwd_chunk(bh, group, t, L2)
    assert got == want
    assert 1 <= got <= bh and (got == bh or got % group == 0)
    kv_bytes = 2 * t * 256 * 2
    assert got // group <= 1 or got // group * kv_bytes <= L2 // 6
