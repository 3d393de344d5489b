"""The encoders' forward and dk/dv (`fwd_short_kernel`, `dkv_short_kernel`
in ops/csrc/flash_attention.cu), held here on the CPU: a model of their
persistent walks and of the route rule that sends a call to them.

Both kernels run one block on each SM (at most one a work item), and
block x takes the items x, x + grid, ... in turn.  The forward's item is a
b*h: its producer loads the head's Q in 64-row boxes and its K and V in
64-row boxes up to whole 128-key steps, once; the block's row tiles of 64
rows, item after item, are dealt to its three consumer warpgroups in turn,
each tile run over its key steps (`key_tiles`), the ragged one cut to
sub-steps of 64, 32 and 16 keys.  dk/dv's item is a b*kv_head: its
producer loads K and V once, then streams, pass by pass, the query chunks
(64 queries of each head of the group) that the pass's 128 keys can see
(`query_tiles`), the ragged one taken in 32- and 16-query sub-steps; in
pass p warpgroup w owns key tile 2p + w of 64 keys.  The functions below
write those formulas out in Python, so that the tests can show that every
item is taken exactly once, that its K and V are loaded once (under MHA,
the encoders', once a head), and that every live (query, key) pair of
every mask is visited exactly once at every T the route takes, at the
edges of its tiles.  No JAX; the kernels are held on the card
(tests/test_torch_kernels_cuda.py).
"""
import itertools

import pytest
import torch

import chip_smoke
from tf_operator_tpu_torch.ops import attention as A

SMS = 132  # an H100 SXM's
BK, BQ, ROWS = 128, 64, 64  # forward key step, dk/dv query chunk, a tile
WGS = 3  # the forward's consumer warpgroups (flash_attention.cu:SHORT_WGS)
TS = (1, 63, 64, 65, 127, 128, 129, 197, 255, 256)
MASKS = {
    "noncausal": dict(causal=False, window=None, sink=0),
    "causal": dict(causal=True, window=None, sink=0),
    "window": dict(causal=True, window=100, sink=0),
    "window_sink": dict(causal=True, window=64, sink=70),
}


def live(i, j, t, causal, window, sink):
    """flash_attention.cu:Mask::live."""
    if i >= t or j >= t or (causal and j > i):
        return False
    return not (window and i - j >= window and j >= sink)


def key_tiles(q0, bm, t, causal, window, sink, bk=BK):
    """The key tiles [q0, q0 + bm) visits, in order
    (flash_attention.cu:key_tiles)."""
    n_kt = -(-t // bk)
    hi = min(n_kt, (min(q0 + bm, t) - 1) // bk + 1) if causal else n_kt
    lo = max(0, q0 - window + 1) // bk if window else 0
    n_sink = min(-(-sink // bk), lo) if sink else 0
    return list(range(n_sink)) + list(range(lo, hi))


def query_tiles(k0, bm, t, causal, window, sink, bq=BQ):
    """[qlo, qhi) of the query tiles that see keys [k0, k0 + bm)
    (flash_attention.cu:query_tiles)."""
    n_qt = -(-t // bq)
    qlo = k0 // bq if causal else 0
    qhi = n_qt
    if window and not (sink and k0 < sink):
        qhi = min(n_qt, min(t - 1, k0 + bm - 1 + window - 1) // bq + 1)
    return qlo, qhi


def blocks(items):
    """{block: [its items in order]} of a persistent grid of one block an
    SM, at most one an item."""
    grid = min(items, SMS)
    return {x: list(range(x, items, grid)) for x in range(grid)}


def fwd_item(t):
    """(the producer's loads of one item as (tensor, first row), its
    expected bytes, and [(warpgroup, row tile, key tiles)])."""
    n_rt, n_kc = -(-t // ROWS), -(-t // BK) * 2
    loads = [("q", ROWS * c) for c in range(n_rt)]
    loads += [(x, ROWS * c) for x in ("k", "v") for c in range(n_kc)]
    return loads, (n_rt + 2 * n_kc) * ROWS * 64 * 2, n_rt


def fwd_units(items, t):
    """[(warpgroup, item, row tile)] in each warpgroup's order: the block's
    tile u = i * n_rt + r goes to warpgroup u % WGS."""
    n_rt = -(-t // ROWS)
    return [(w, i, r) for w in range(WGS) for i in range(items)
            for r in range((w - i * n_rt) % WGS, n_rt, WGS)]


def sub_steps(k0, step, t):
    """[(first row, rows)] of a step of `step` rows from k0: whole, or cut
    to the rows before T in whole sub-steps (64, 32, 16 in the forward; 32,
    16 in dk/dv, whose step is 64)."""
    n = min(step, -(-(t - k0) // 16) * 16)
    if n == step:
        return [(k0, step)]
    out, c = [], 0
    while c < n:
        w = next(x for x in (64, 32, 16) if n - c >= x)
        out.append((k0 + c, w))
        c += w
    return out


def dkv_stream(t, group, mask):
    """dk/dv's item: [(pass, member head, query chunk)] in the producer's
    order, which both warpgroups consume in turn."""
    n_kt = -(-t // ROWS)
    out = []
    for p in range((n_kt + 1) // 2):
        qlo, qhi = query_tiles(128 * p, 128, t, **mask)
        out += [(p, h, c) for h in range(group) for c in range(qlo, qhi)]
    return out


@pytest.mark.parametrize("items", [1, 2, 131, 132, 133, 384, 1536, 3072])
def test_every_item_is_taken_once_by_one_block(items):
    """ViT-B/16's 3,072 heads (23 or 24 a block), BERT-base's 384, their
    tp 2 halves, and fewer items than SMs: each item once, by one block,
    and no block more than one item ahead of another."""
    walk = blocks(items)
    taken = sorted(itertools.chain.from_iterable(walk.values()))
    assert taken == list(range(items))
    counts = [len(v) for v in walk.values()]
    assert max(counts) - min(counts) <= 1
    assert all(v == sorted(v) for v in walk.values())


@pytest.mark.parametrize("items", [1, 2, 3, 24])
@pytest.mark.parametrize("t", TS)
def test_forward_deals_every_row_tile_once(t, items):
    """Each (item, row tile) of a block by one warpgroup, each warpgroup's
    tiles in the block's order and within one of the others' counts (ViT's
    T 197: 4 tiles a head over 3 warpgroups; BERT's 128: 2)."""
    n_rt = -(-t // ROWS)
    units = fwd_units(items, t)
    assert sorted((i, r) for _, i, r in units) == [
        (i, r) for i in range(items) for r in range(n_rt)]
    counts = [sum(1 for w, _, _ in units if w == x) for x in range(WGS)]
    assert max(counts) - min(counts) <= 1
    for x in range(WGS):
        mine = [(i, r) for w, i, r in units if w == x]
        assert mine == sorted(mine)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("t", TS)
def test_forward_visits_every_live_pair_once(t, mask):
    """Each live (query, key) pair of an item once in the key steps of its
    row tile (the ragged step's sub-steps reaching every key before T),
    every row and key it reads loaded (the zero fill past T stands in for
    rows beyond it), and no key outside the loaded K and V."""
    opts = MASKS[mask]
    loads, _, _ = fwd_item(t)
    q_rows = {r for x, r0 in loads if x == "q" for r in range(r0, r0 + 64)}
    k_rows = {r for x, r0 in loads if x == "k" for r in range(r0, r0 + 64)}
    seen = {}
    for _, _, r in fwd_units(1, t):
        kts = key_tiles(ROWS * r, ROWS, t, **opts)
        assert len(kts) == len(set(kts))
        for kt in kts:
            for k0, n in sub_steps(BK * kt, BK, t):
                assert set(range(k0, k0 + n)) <= k_rows
                for i in range(ROWS * r, ROWS * r + ROWS):
                    assert i in q_rows
                    for j in range(k0, k0 + n):
                        if live(i, j, t, **opts):
                            seen[i, j] = seen.get((i, j), 0) + 1
    want = {(i, j) for i in range(t) for j in range(t)
            if live(i, j, t, **opts)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("t,keys", [(197, 208), (128, 128), (129, 144),
                                    (256, 256), (1, 16), (65, 80)])
def test_the_ragged_step_stops_at_the_next_16_keys(t, keys):
    """The keys a row tile's products cover: ViT-B/16's 197 as 128 + 64 +
    16 = 208 of the 256 two whole steps would take."""
    covered = sum(n for kt in range(-(-t // BK))
                  for _, n in sub_steps(BK * kt, BK, t))
    assert covered == keys


@pytest.mark.parametrize("t", TS)
def test_forward_loads_each_items_q_k_and_v_once(t):
    """One set of loads an item, each box once, their bytes the barrier's
    expected count: under MHA each head's K and V leave device memory once
    (the tiled kernel read them once for each of a head's row tiles)."""
    loads, nbytes, n_rt = fwd_item(t)
    assert len(loads) == len(set(loads))
    assert nbytes == len(loads) * 64 * 64 * 2
    rows = {x: sorted(r for y, r in loads if y == x) for x in "qkv"}
    assert rows["q"] == [64 * c for c in range(n_rt)]
    assert rows["k"] == rows["v"] == [64 * c for c in range(-(-t // 128)
                                                            * 2)]
    assert 64 * len(rows["k"]) * 64 * 2 <= 32768  # a stage's K tile


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("t", TS)
def test_dkv_visits_every_live_pair_once(t, mask, group):
    """Each key tile of 64 by one warpgroup in one pass (2p + w), each
    member head's live (query, key) pairs once among the chunks its pass
    streams; a warpgroup with no tile left in the last pass (odd key
    tiles) still takes every chunk of it (it waits for each and hands it
    back)."""
    opts = MASKS[mask]
    n_kt = -(-t // ROWS)
    stream = dkv_stream(t, group, opts)
    assert len(stream) == len(set(stream))
    owners = {}
    seen = {}
    for p, h, c in stream:
        for w in (0, 1):
            kt = 2 * p + w
            if kt >= n_kt:
                continue
            owners.setdefault(kt, set()).add((p, w))
            for i in (i for q0, n in sub_steps(BQ * c, BQ, t)
                      for i in range(q0, q0 + n)):
                for j in range(ROWS * kt, ROWS * kt + ROWS):
                    if live(i, j, t, **opts):
                        seen[h, i, j] = seen.get((h, i, j), 0) + 1
    assert sorted(owners) == list(range(n_kt))
    assert all(len(v) == 1 for v in owners.values())
    want = {(h, i, j) for h in range(group) for i in range(t)
            for j in range(t) if live(i, j, t, **opts)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("t,passes,chunks", [
    (128, 1, 2), (197, 2, 8), (256, 2, 8), (64, 1, 1), (129, 2, 6)])
def test_dkv_streams_each_pass_once(t, passes, chunks):
    """Non-causal: K and V once an item, Q and dO once a pass (T 128, BERT:
    one pass of 2 chunks; T 197, ViT: two passes of 4, the second read from
    L2)."""
    stream = dkv_stream(t, 1, MASKS["noncausal"])
    assert len({p for p, _, _ in stream}) == passes
    assert len(stream) == chunks


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t", [197, 256, 257, 2048])
def test_route_rule_for_every_block_request(t, dtype):
    """At head-dim class 64 the forward, dq and dk/dv take the encoders'
    kernels (SHORT's tiles) at T <= 256 whatever blocks the env contract
    accepts (block_q a positive multiple of 8, block_k of 64; until the
    encoders' dq, dq kept the tile the blocks resolve to), and above 256
    every kernel takes the tiled kernels' tiles, as without T; each tile is
    built."""
    built = A.instantiations()
    name = str(dtype).removeprefix("torch.")
    for bq, bk in itertools.product(range(8, 520, 8), range(64, 1088, 64)):
        tiled = A.resolve_tiles(bq, bk, 64, dtype)
        got = A.resolve_tiles(bq, bk, 64, dtype, t)
        if t <= A.SHORT_T:
            assert got == tiled._replace(**A.SHORT)
            assert got == A.Tiles(**A.SHORT)
        else:
            assert got == tiled
        for kernel in ("fwd", "dq", "dkv"):
            assert (kernel, name, 64, *getattr(got, kernel)) in built


@pytest.mark.parametrize("d,dtype,t,short", [
    (64, torch.bfloat16, 197, True), (8, torch.float16, 1, True),
    (64, torch.bfloat16, 256, True), (64, torch.bfloat16, 257, False),
    (64, torch.float32, 197, False), (72, torch.bfloat16, 197, False),
    (128, torch.float16, 128, False), (256, torch.bfloat16, 197, False),
])
def test_route_rule_by_class_length_and_dtype(d, dtype, t, short):
    """Only head-dim class 64 in bf16 and fp16 at T <= 256 takes the
    encoders' kernels, all three; f32 keeps its one tile."""
    assert A.short_route(d, t, dtype) is short
    tiles = A.resolve_tiles(128, 128, d, dtype, t)
    assert (tiles.fwd == A.SHORT["fwd"]) is short
    assert (tiles.dq == A.SHORT["dq"]) is short
    assert (tiles.dkv == A.SHORT["dkv"]) is short


_FWD_SHORT = ("_ZN12_GLOBAL__N_116fwd_short_kernelI13__nv_bfloat16Lb1EEEv14"
              "CUtensorMap_stS2_S2_S2_PfiifN2fa4MaskE")
_DKV_SHORT = ("_ZN12_GLOBAL__N_116dkv_short_kernelI6__halfEEv14CUtensorMap_stS"
              "2_S2_S2_S2_S2_PKfS4_iiifN2fa4MaskE")
_DQ_SHORT = ("_ZN12_GLOBAL__N_115dq_short_kernelI13__nv_bfloat16EEv14CUtensorMa"
             "p_stS2_S2_S2_S2_PKfS4_iiifN2fa4MaskE")


def test_ptxas_report_names_the_encoders_kernels():
    """chip_smoke's build phase reads the encoders' kernels (the
    forward, dk/dv and dq) in nvcc's -Xptxas=-v report (template
    arguments: the element type, and the forward's route) under the keys
    of SHORT's tiles, which attention.instantiations() lists."""
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 4 barriers\n"
        for name in (_FWD_SHORT, _DKV_SHORT, _DQ_SHORT))
    assert chip_smoke.ptxas_report(log) == [
        ("fwd_short_kernel<bfloat16, D 64, rows 256, step 128, scaled 1>",
         128, 0, 0, ("fwd", "bfloat16", 64, 256, 128)),
        ("dkv_short_kernel<float16, D 64, rows 256, step 64>", 128, 0, 0,
         ("dkv", "float16", 64, 256, 64)),
        ("dq_short_kernel<bfloat16, D 64, rows 256, step 64>", 128, 0, 0,
         ("dq", "bfloat16", 64, 256, 64))]
    assert {r[4] for r in chip_smoke.ptxas_report(log)} <= A.instantiations()
