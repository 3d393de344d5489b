"""dk/dv at head-dim class 256 split over the query heads, held here on the
CPU: a model of the kernel's grid and walk, the host's choice of slices,
the reduce's plain version, and dq's tile of the class.

`dkv_split_kernel` (`ops/csrc/flash_attention.cu`) runs one block per
(64-key tile, b * kv_head, slice of the KV head's query-head group), key
tiles slowest; a block walks its slice's query heads one by one, for each
the query tiles that can see its key tile (`query_tiles`), upward.  `walk`
below is that schedule written out in Python (the same formulas as
`dkv_split_walk`, `query_tiles` and `dkv_producer`), so the tests can
show that the blocks visit every (query head, query tile, key tile) triple
that holds a live (query, key) pair exactly once, under every mask the
kernels take and at splits that do and do not divide the group, and that
launching the blocks in order on 132 SMs evens out the causal imbalance.
The kernels themselves are held on the card
(tests/test_torch_kernels_cuda.py).
"""
import heapq

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.ops import attention as A

BM, BQ = 64, 64  # dkv_split_kernel's key rows and query step


def query_tiles(k0, t, causal, window, sink):
    """[qlo, qhi) of the BQ-row query tiles that can see the key tile [k0,
    k0 + BM) (flash_attention.cu:query_tiles)."""
    n_qt = -(-t // BQ)
    qlo = k0 // BQ if causal else 0
    qhi = n_qt
    if window and not (sink and k0 < sink):
        qhi = min(n_qt, min(t - 1, k0 + BM - 1 + window - 1) // BQ + 1)
    return qlo, qhi


def walk(b, heads, kv_heads, t, splits, causal=True, window=None, sink=0):
    """[(block, [(query row block b * heads + head, query tile, key tile)
    in the order the block visits them])] in launch order
    (flash_attention.cu:dkv_split_walk)."""
    n_kt, bkv_n, group = -(-t // BM), b * kv_heads, heads // kv_heads
    blocks = []
    for x in range(n_kt * bkv_n * splits):
        s, rest = x % splits, x // splits
        bkv, kt = rest % bkv_n, rest // bkv_n
        h0, h1 = s * group // splits, (s + 1) * group // splits
        qbase = (bkv // kv_heads) * heads + (bkv % kv_heads) * group + h0
        qlo, qhi = query_tiles(kt * BM, t, causal, window, sink)
        nq, nh = qhi - qlo, h1 - h0
        blocks.append((x, [(qbase + it // nq, qlo + it % nq, kt)
                           for it in range(nh * nq)]))
    return blocks


def live_triples(b, heads, kv_heads, t, causal=True, window=None, sink=0):
    """Every (query row block, query tile, key tile) holding at least one
    (query i, key j) pair the mask keeps (the plain version's mask)."""
    i = np.arange(t)[:, None]
    j = np.arange(t)[None, :]
    keep = np.ones((t, t), bool)
    if causal:
        keep = j <= i
        if window:
            keep &= (i - j < window) | (j < sink)
    n_qt, n_kt = -(-t // BQ), -(-t // BM)
    tiles = {(qt, kt) for qt in range(n_qt) for kt in range(n_kt)
             if keep[qt * BQ:(qt + 1) * BQ, kt * BM:(kt + 1) * BM].any()}
    return {(bh, qt, kt) for bh in range(b * heads) for qt, kt in tiles}


MASKS = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window_sink": dict(causal=True, window=64, sink=70),
    "window": dict(causal=True, window=100),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("t", [256, 300, 1000])
@pytest.mark.parametrize("heads,kv_heads,splits", [
    (2, 2, 1), (6, 2, 1), (6, 2, 2), (6, 2, 3), (8, 2, 4), (8, 2, 3),
    (8, 1, 1), (8, 1, 3), (8, 1, 5), (8, 1, 8)])
def test_the_split_walk_visits_every_live_triple_once(mask, t, heads,
                                                      kv_heads, splits):
    """Groups 1, 3, 4 and 8 over slices that divide them and that do not
    (3 over 2, 4 over 3, 8 over 3 and 5), ragged T (300, 1000): the
    blocks' walks together visit each live (query head, query tile, key
    tile) triple exactly once and nothing else."""
    opts = MASKS[mask]
    visits = [v for _, tiles in walk(2, heads, kv_heads, t, splits, **opts)
              for v in tiles]
    assert len(visits) == len(set(visits))
    assert set(visits) == live_triples(2, heads, kv_heads, t, **opts)


def test_a_block_walks_its_heads_one_by_one():
    """Block 0 of Gemma 2B's shape at 3 slices: key tile 0, query heads 0
    and 1 (8 over 3: 2, 3, 3), each head's query tiles 0 to 31; its slice
    neighbours take heads 2-4 and 5-7."""
    blocks = walk(4, 8, 1, 2048, 3)
    tiles = blocks[0][1]
    assert tiles[:3] == [(0, 0, 0), (0, 1, 0), (0, 2, 0)]
    assert tiles[31:33] == [(0, 31, 0), (1, 0, 0)]
    assert tiles[-1] == (1, 31, 0) and len(tiles) == 2 * 32
    assert {bh for bh, _, _ in blocks[1][1]} == {2, 3, 4}
    assert {bh for bh, _, _ in blocks[2][1]} == {5, 6, 7}
    # key tiles slowest: the 12 blocks of key tile 0 come first
    assert {tiles[0][2] for _, tiles in blocks[:12]} == {0}
    assert blocks[12][1][0][2] == 1


def makespan(blocks, sms=132, overhead=0):
    """Iterations of the SM that finishes last when the blocks start in
    launch order, each on the first SM to come free (the hardware's block
    scheduler, one block an SM, as dk/dv's shared memory allows); each
    block costs its tiles plus `overhead`."""
    free = [0] * sms
    for _, tiles in blocks:
        heapq.heapreplace(free, free[0] + len(tiles) + overhead)
    return max(free)


def test_the_split_grid_evens_out_the_causal_imbalance():
    """Gemma 2B's attention (B 4, 8 query heads over one KV head, T 2048,
    causal): one slice a KV head (the unsplit grid of 128 blocks) leaves the
    longest SM 256 query tiles, 2.0x a balanced share of 128; the host's 2
    slices, heavy key tiles first, bring it to that share."""
    total = sum(len(tiles) for _, tiles in walk(4, 8, 1, 2048, 1))
    assert total == 8 * 4 * sum(32 - kt for kt in range(32))
    share = total / 132
    assert share == 128
    assert makespan(walk(4, 8, 1, 2048, 1)) == 256
    splits = A.dkv_splits(4, 2048, 8, 132)
    assert splits == 2
    assert makespan(walk(4, 8, 1, 2048, splits)) == share
    # the light key tiles last: launched in reverse, the split grid is
    # worse
    heavy_first = makespan(walk(4, 8, 1, 2048, splits))
    assert makespan(walk(4, 8, 1, 2048, splits)[::-1]) > heavy_first


@pytest.mark.parametrize("bkv,t,group,sms,want", [
    (4 * 1, 2048, 8, 132, 2),    # Gemma 2B's attention, B 4: 128 blocks
    (8 * 3, 2048, 1, 132, 1),    # GPT-small's width at head dim 256 (3 MHA
                                 # heads of 256): no group to split
    (32 * 12, 128, 1, 132, 1),   # BERT-like, B 32, T 128, 12 MHA heads
    (32 * 1, 128, 12, 132, 3),   # the same with one KV head: 64 blocks
    (2 * 1, 2048, 6, 132, 3),    # 6 heads over one KV head at B 2
    (1, 2048, 6, 132, 5),        # at B 1: 5 slices of 6 heads
    (4 * 1, 1024, 8, 132, 3),    # the lse phase's Gemma case, T 1024
    (64 * 1, 2048, 8, 132, 1),   # B 64: 2048 blocks, already 15 waves
    (1, 128, 8, 132, 8),         # one tiny head: one slice a query head
    (4 * 2, 2048, 4, 114, 1),    # an H100 PCIe's 114 SMs: 256 >= 114
])
def test_dkv_splits_gives_every_sm_a_block(bkv, t, group, sms, want):
    """The host's choice: the fewest slices that give every SM a block,
    at most one a query head."""
    got = A.dkv_splits(bkv, t, group, sms)
    assert got == want
    blocks = bkv * -(-t // 64)
    assert 1 <= got <= group
    assert blocks * got >= sms or got == group
    assert got == 1 or blocks * (got - 1) < sms


def test_dkv_reduce_plain_sums_the_slices_in_order():
    """The reduce's plain version (what the kernel is held to bit for bit
    on the card): dk = scale * the sum of ws[0]'s slices, dv the sum of
    ws[1]'s, each in slice order in f32 and rounded once; on CPU tensors
    the wrapper computes it and launches nothing."""
    rng = np.random.RandomState(0)
    ws = torch.from_numpy(rng.randn(2, 3, 2, 1, 40, 16).astype(np.float32))
    before = A.dkv_reduce.launches
    for dtype in (torch.bfloat16, torch.float16):
        dk, dv = A.dkv_reduce(ws, 0.25, dtype)
        assert dk.dtype == dv.dtype == dtype and dk.shape == (2, 1, 40, 16)
        in_order = ws[:, 0] + ws[:, 1] + ws[:, 2]
        assert torch.equal(dk, (in_order[0] * 0.25).to(dtype))
        assert torch.equal(dv, in_order[1].to(dtype))
    assert A.dkv_reduce.launches == before


def test_dq_tile_of_the_256_class_is_two_warpgroups_over_64_keys():
    """dq at head dims 129-256 runs one tile, 128 rows (two consumer
    warpgroups of 64) over a 64-key step, for every block pair the env
    takes and each half-precision dtype; it is a built instantiation and
    the one dq instantiation of the class."""
    built = A.instantiations()
    assert A.INSTANTIATED["dq"][256] == ((128,), (64,))
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).removeprefix("torch.")
        for bq in (8, 32, 64, 128, 256, 1024):
            for bk in (64, 128, 512):
                assert A.resolve_tiles(bq, bk, 256, dtype).dq == (128, 64)
        assert {x for x in built if x[:3] == ("dq", name, 256)} == {
            ("dq", name, 256, 128, 64)}
