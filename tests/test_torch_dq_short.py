"""The encoders' dq (`dq_short_kernel` in ops/csrc/flash_attention.cu),
held here on the CPU: a model of its persistent walk, its shared-memory
plan and the barriers of its rings.

The kernel runs one block on each SM (at most one a work item), and block
x takes the items x, x + grid, ... in turn.  An item is a b*kv_head: its
producer warp loads the item's K and V in 64-row boxes once, into one of
two K/V stages, then streams the item's query chunks (64 rows of each
query head of the KV head's group, head by head) through a ring of
STAGES stages.  The block's chunks, item after item, are dealt to its
consumer warpgroups in turn (chunk n to warpgroup n % WGS); the
warpgroup that takes a chunk runs it over its key steps (`key_tiles`, BK
keys a step, the ragged one cut to sub-steps of 64, 32 and 16 keys) and
hands its stage back alone, while every warpgroup hands back every item's
K/V stage.  The functions below write those formulas out in Python, so
that the tests can show that every item is taken once, its K and V loaded
once, every query chunk of every head dealt once, every live (query, key)
pair of every mask visited exactly once at every T the route takes, the
ragged sub-steps stopping at the next 16 keys, and that no barrier wait
can pass a phase early.  No JAX; the kernel is held on the card
(tests/test_torch_kernels_cuda.py).
"""
import itertools
import math
import random
import re

import pytest

from test_torch_fwd_short import (MASKS, TS, blocks, key_tiles, live,
                                  sub_steps)
from tf_operator_tpu_torch.ops import _build

ROWS = BQ = 64  # a K/V box's rows and a query chunk's
SMEM = 232448  # the shared memory a block may take alone (smem_budget(1))
# the consumer warpgroups the kernel is built with
WGS = int(re.search(r"constexpr int DQ_SHORT_WGS = (\d+);",
                    _build.SOURCE.read_text()).group(1))


def plan(wgs):
    """(key step, Q/dO stages, bytes) of flash_attention.cu:DqShortSmem at
    `wgs` consumer warpgroups: two K/V stages of 64 KB, a 64-row dQ tile
    for each warpgroup, then as many 16 KB Q/dO stages (and their 512
    bytes of lse and delta) as the rest holds, at most 6, and the
    barriers: a full one for each (stage, warpgroup), an empty one a
    stage, two of each for K/V."""
    bk = 128 if wgs == 2 else 64
    chunk = 64 * 64 * 2
    ring_off = 2 * 2 * 256 * 64 * 2 + wgs * chunk
    q_stage, rows = 2 * chunk, 2 * BQ * 4
    stages = min(6, (SMEM - ring_off - 1024 - 128) // (q_stage + rows))
    nbytes = ring_off + stages * (q_stage + rows) \
        + 8 * (stages * wgs + stages + 4) + 1024
    return bk, stages, nbytes


BK, STAGES, _ = plan(WGS)


def chunks(t, group):
    """An item's query chunks in the producer's order: [(member head,
    first row)]."""
    n_qc = -(-t // BQ)
    return [(h, BQ * c) for h in range(group) for c in range(n_qc)]


def units(items, nc, wgs=WGS):
    """[(warpgroup, item, chunk u)] in each warpgroup's order: the block's
    chunk n = i * nc + u goes to warpgroup n % wgs (the kernel's first u
    of item i is (w - i * nc) mod wgs)."""
    return [(w, i, u) for w in range(wgs) for i in range(items)
            for u in range((w - i * nc) % wgs, nc, wgs)]


@pytest.mark.parametrize("wgs", [2, 3])
def test_the_plan_fits_and_holds_a_stage_for_every_warpgroup(wgs):
    """Both designs fit the 227 KB a block may take and keep at least as
    many Q/dO stages as consumer warpgroups (the kernel's static_assert),
    so that each has a chunk in flight."""
    bk, stages, nbytes = plan(wgs)
    assert nbytes <= SMEM
    assert stages >= wgs
    assert (bk, stages) == ((128, 4) if wgs == 2 else (64, 4))


@pytest.mark.parametrize("items", [1, 2, 128, 131, 132, 133, 192, 384, 1536,
                                   3072])
def test_every_item_is_taken_once_by_one_block(items):
    """dq's items are b*kv_heads: ViT-B/16's 3,072, BERT-base's 384, their
    tp 2 halves (BERT-base tp 2's 192: one and a half waves), BERT-base's
    batch over 4 KV heads (128), and fewer items than SMs."""
    walk = blocks(items)
    assert sorted(itertools.chain.from_iterable(walk.values())) == list(
        range(items))
    counts = [len(v) for v in walk.values()]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("items", [1, 2, 3, 24])
@pytest.mark.parametrize("t", TS)
def test_dq_deals_every_chunk_of_every_head_once(t, items, group):
    """Each (item, member head, chunk) of a block by one warpgroup, each
    warpgroup's chunks in the block's order and within one of the others'
    counts (ViT's T 197: 4 chunks a head over 2 warpgroups; T 64 with MHA:
    one chunk an item, so the warpgroups alternate items)."""
    nc = len(chunks(t, group))
    dealt = units(items, nc)
    assert sorted((i, u) for _, i, u in dealt) == [
        (i, u) for i in range(items) for u in range(nc)]
    counts = [sum(1 for w, _, _ in dealt if w == x) for x in range(WGS)]
    assert max(counts) - min(counts) <= 1
    for x in range(WGS):
        mine = [(i, u) for w, i, u in dealt if w == x]
        assert mine == sorted(mine)
        # chunk n of the block: each warpgroup's n step by exactly WGS
        ns = [i * nc + u for i, u in mine]
        assert all(b - a == WGS for a, b in zip(ns, ns[1:]))


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("t", TS)
def test_dq_visits_every_live_pair_once(t, mask, group):
    """Each member head's live (query, key) pairs once among its chunks'
    key steps and their sub-steps, every key a step reads inside the K and
    V boxes the item loaded (their zero fill past T standing in for the
    keys beyond it), every query row inside its chunk's box."""
    opts = MASKS[mask]
    k_rows = set(range(ROWS * -(-t // ROWS)))
    seen = {}
    for h, q0 in chunks(t, group):
        kts = key_tiles(q0, BQ, t, **opts, bk=BK)
        assert len(kts) == len(set(kts))
        for kt in kts:
            for k0, n in sub_steps(BK * kt, BK, t):
                assert set(range(k0, k0 + n)) <= k_rows
                for i in range(q0, q0 + BQ):
                    for j in range(k0, k0 + n):
                        if live(i, j, t, **opts):
                            seen[h, i, j] = seen.get((h, i, j), 0) + 1
    want = {(h, i, j) for h in range(group) for i in range(t)
            for j in range(t) if live(i, j, t, **opts)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("t", TS)
def test_dq_loads_each_items_k_and_v_once_and_each_chunk_once(t):
    """One K/V load an item, each 64-row box once, their bytes the
    barrier's expected count and within a stage (under MHA each head's K
    and V leave device memory once, where the tiled kernel read them once
    for each of the head's row tiles); each query head's Q and dO once, a
    chunk's box at a time, in rows that cover the head."""
    n_kt = -(-t // ROWS)
    assert 2 * n_kt * ROWS * 64 * 2 <= 2 * 256 * 64 * 2  # a K/V stage
    for group in (1, 4):
        loads = chunks(t, group)
        assert len(loads) == len(set(loads)) == group * -(-t // BQ)
        for h in range(group):
            rows = sorted(q0 for m, q0 in loads if m == h)
            assert rows == list(range(0, ROWS * n_kt, BQ))
            assert rows[-1] < t <= rows[-1] + BQ


@pytest.mark.parametrize("t,keys", [(197, 208), (128, 128), (129, 144),
                                    (256, 256), (1, 16), (65, 80),
                                    (200, 208), (255, 256)])
def test_the_ragged_step_stops_at_the_next_16_keys(t, keys):
    """The keys a non-causal chunk's products cover: ViT-B/16's 197 as 208
    (at 128-key steps 128 + 64 + 16), not the 256 two whole steps would
    take."""
    covered = sum(n for kt in range(-(-t // BK))
                  for _, n in sub_steps(BK * kt, BK, t))
    assert covered == keys


class Barrier:
    """An mbarrier: `expected` arrivals complete a phase; `done` phases
    have completed.  A wait on parity P passes while the phase in progress
    has the other parity: the phase of parity P before it has completed,
    or the phase two before it (what the kernel must never let happen)."""

    def __init__(self, expected):
        self.expected, self.pending, self.done = expected, expected, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.done += 1
            self.pending = self.expected

    def passes(self, phase):
        return self.done & 1 != phase & 1


def run_protocol(items, nc, wgs, stages, seed, shared_full=False):
    """dq_short_kernel's barriers over one block's `items` items of `nc`
    chunks each: its producer warp, `wgs` consumer warpgroups, and the
    copy engine, which completes the loads in flight in any order,
    interleaved at random.  A chunk's load completes on its stage's full
    barrier of the warpgroup that takes it, whose phases count that
    warpgroup's uses of the stage (`shared_full`: one full barrier a stage
    for all warpgroups, counting the stage's chunks, the kernel's first
    build).  Returns the (warpgroup, item, chunk) taken and the waits that
    passed before their phase completed (each as (what, the phase waited
    for, the phases completed)); raises on a deadlock, or when a consumer
    reads a stage that holds another chunk or item."""
    rng = random.Random(seed)
    period = stages // math.gcd(wgs, stages)
    full = [[Barrier(1)] * wgs if shared_full else
            [Barrier(1) for _ in range(wgs)] for _ in range(stages)]
    empty = [Barrier(1) for _ in range(stages)]  # the taking warpgroup's
    kv_full = [Barrier(1) for _ in range(2)]
    kv_empty = [Barrier(wgs) for _ in range(2)]  # every warpgroup's
    stage, kv_stage = [None] * stages, [None] * 2
    inflight, early, taken = [], [], []

    def wait(what, bar, phase):
        while not bar.passes(phase):
            yield
        if bar.done != phase + 1:
            early.append((what, phase, bar.done))

    def producer():
        n = 0
        for i in range(items):
            ks = i & 1
            if i >= 2:
                yield from wait("kv_empty", kv_empty[ks], (i >> 1) - 1)
            inflight.append((kv_stage, ks, i, kv_full[ks]))
            for _ in range(nc):
                s = n % stages
                if n >= stages:
                    yield from wait("empty", empty[s], n // stages - 1)
                inflight.append((stage, s, n, full[s][n % wgs]))
                n += 1
                yield

    def copies():
        while True:
            if inflight:
                where, index, value, bar = inflight.pop(
                    rng.randrange(len(inflight)))
                where[index] = value
                bar.arrive()
            yield

    def consumer(w):
        for i in range(items):
            ks = i & 1
            yield from wait("kv_full", kv_full[ks], i >> 1)
            for u in range((w - i * nc) % wgs, nc, wgs):
                n = i * nc + u
                s = n % stages
                yield from wait("full", full[s][w], n // stages if
                                shared_full else n // wgs // period)
                for _ in range(2):  # the products read the stages
                    if stage[s] != n or kv_stage[ks] != i:
                        raise AssertionError(
                            f"warpgroup {w} read chunk {stage[s]} and item "
                            f"{kv_stage[ks]} for chunk {n} of item {i}")
                    yield
                taken.append((w, i, u))
                empty[s].arrive()
            kv_empty[ks].arrive()

    agents = [producer()] + [consumer(w) for w in range(wgs)]
    engine = copies()
    steps = 0
    while agents:
        agent = rng.choice(agents + [engine])
        if agent is engine:
            next(engine)
        else:
            try:
                next(agent)
            except StopIteration:
                agents.remove(agent)
        steps += 1
        if steps > 200000:
            raise AssertionError("the protocol made no progress: deadlock")
    return taken, early


def broken_runs(items, nc, wgs, stages, seeds, **kw):
    """The runs of `seeds` in which a wait passed early or a consumer read
    a stage that held another chunk (its error)."""
    found = []
    for seed in range(seeds):
        try:
            found += run_protocol(items, nc, wgs, stages, seed, **kw)[1]
        except AssertionError as err:  # a stale read after the early pass
            assert "read chunk" in str(err)
            found.append(str(err))
    return found


@pytest.mark.parametrize("wgs", [2, 3])
@pytest.mark.parametrize("items,nc", [(1, 1), (3, 1), (5, 2), (4, 4),
                                      (3, 12), (24, 4), (6, 3)])
def test_no_barrier_wait_passes_a_phase_early(items, nc, wgs):
    """The producer, the consumer warpgroups and loads that complete in
    any order, over random interleavings of the kernel's barriers: every
    chunk taken once, by its warpgroup, from a stage that holds it and an
    item's K/V stage that holds that item, every wait passing only once
    its phase has completed, and no deadlock: single-chunk items
    (BERT-base's T 64 shards, where a warpgroup takes no chunk of every
    other item), ViT's 4 chunks, GQA's 12."""
    _, stages, _ = plan(wgs)
    for seed in range(20):
        taken, early = run_protocol(items, nc, wgs, stages, seed)
        assert sorted(taken) == sorted(units(items, nc, wgs))
        assert early == []


def test_the_protocol_model_catches_a_full_barrier_shared_by_warpgroups():
    """Three warpgroups over four stages with one full barrier a stage (the
    kernel's first build): the warpgroup that takes chunk n took chunk n -
    3, not chunk n - 4, the stage's previous one, whose load may still be
    in flight when chunk n - 3's has landed; the barrier's parity is then
    already chunk n's and the wait passes at once (a diagnostic build
    without dQ's product, whose loads queue, trapped so on the card).  A
    full barrier for each (stage, warpgroup) counts only that warpgroup's
    uses of the stage, which it waits for in order."""
    assert broken_runs(24, 4, 3, 4, 40, shared_full=True)
    assert not broken_runs(24, 4, 3, 4, 40)
