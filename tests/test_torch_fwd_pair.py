"""The pair forward, held on the CPU.

At head dims 257..512 in bf16 and fp16 (`ops/attention.pair_route`) the
forward runs on the pair kernel (`csrc/flash_attention.cu`:
fwd_pair_kernel): one block a 64-row tile; its two consumer warpgroups
split the head dim's 64-column chunks (warpgroup 0 the first ceil(nc / 2),
warpgroup 1 the rest), each contracts Q K^T over its half into a partial S
in f32, the two partials meet in shared memory and each warpgroup adds
warpgroup 0's + warpgroup 1's, runs the online softmax on the sum and adds
P V for its own half of the columns.  The kernel runs on the card only;
here:
  * the plan in plain torch (partial S by half in f32, summed in that
    order, online softmax by 64-key steps in key_tiles' order, P in the
    input dtype, O by halves) against the Pallas forward in interpret mode
    at tests/test_torch_wide_head.py's head dims up to 512 (264-512: GQA,
    window + sink, ragged T), out and lse within that file's 2e-5 (both
    sides sum the same products in another order); the plan with one
    warpgroup's partial left out fails it;
  * the route (which head dims and dtypes take the pair kernel, the bound
    shared with csrc), the grid (every (b*h, 64-row tile) once, longest
    first), the halves (every column of O owned by one warpgroup, at most
    four chunks each), and the shared-memory plan;
  * the exchange and the two rings under random interleavings of the two
    warpgroups' warps and the two producer threads (mbarriers with parity
    waits over two-slot rings of K and V slabs, the named barrier of each
    warp pair, a partial S passed a 32-column half at a time through two
    buffers a warpgroup): no slot or buffer is overwritten before its
    readers have read it, both warpgroups sum warpgroup 0's partial
    first, nothing waits forever; each planted fault breaks one of
    these.
"""
import math
import random
import re

import numpy as np
import pytest
import torch

from tf_operator_tpu.ops.attention import _flash_forward
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import attention as A

from test_torch_attention import ATOL_OUT, inputs
from test_torch_wide_head import CASES

torch.set_num_threads(1)

ROWS = STEP = 64
PAIR_CASES = [name for name, case in CASES.items() if case[1] <= A.PAIR_LD]


def pair_first(w, nc):
    """csrc's pair_first: warpgroup w's first 64-column chunk of nc."""
    return 0 if w == 0 else (nc + 1) // 2


def pair_count(w, nc):
    return (nc + 1) // 2 if w == 0 else nc - (nc + 1) // 2


def _halves(d):
    """The two warpgroups' columns of a head dim."""
    nc = -(-d // 64)
    return [slice(64 * pair_first(w, nc),
                  min(64 * (pair_first(w, nc) + pair_count(w, nc)), d))
            for w in range(2)]


def key_tiles(q0, t, causal, window, sink):
    """csrc's key_tiles over 64-key tiles: the key tiles a 64-row tile from
    q0 visits, in order (the sink tiles, then the band)."""
    n_kt = -(-t // STEP)
    hi = min(n_kt, (min(q0 + ROWS, t) - 1) // STEP + 1) if causal else n_kt
    lo = max(0, q0 - window + 1) // STEP if window else 0
    n_sink = min(-(-sink // STEP), lo) if sink else 0
    return list(range(n_sink)) + list(range(lo, hi))


def _live(t, causal, window, sink):
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    keep = torch.ones(t, t, dtype=torch.bool)
    if causal:
        keep = j <= i
        if window:
            keep = keep & ((i - j < window) | (j < sink))
    return keep


def pair_forward(q, k, v, scale, causal, window, sink, drop=False):
    """(o, lse) of one head as the pair kernel computes them: per 64-row
    tile and 64-key step (key_tiles' order), each warpgroup's partial S
    over its half of the head dim in f32, warpgroup 0's + warpgroup 1's,
    the online softmax on the sum, P in the input dtype, each half of O
    from its warpgroup's V columns.  `drop` (a planted fault): each
    warpgroup takes its own partial alone."""
    t, d = q.shape
    halves = _halves(d)
    keep = _live(t, causal, window, sink)
    o = torch.zeros(t, d)
    lse = torch.zeros(t)
    for q0 in range(0, t, ROWS):
        rows = slice(q0, min(q0 + ROWS, t))
        n = rows.stop - q0
        m = torch.full((n,), -math.inf)
        l = torch.zeros(n)
        acc = [torch.zeros(n, h.stop - h.start) for h in halves]
        for kt in key_tiles(q0, t, causal, window, sink):
            keys = slice(kt * STEP, min(kt * STEP + STEP, t))
            parts = [q[rows, h].float() @ k[keys, h].float().T
                     for h in halves]
            s = [parts[w] if drop else parts[0] + parts[1]
                 for w in range(2)]
            out = []
            for w in range(2):
                sw = torch.where(keep[rows, keys], s[w] * scale, -math.inf)
                m_new = torch.maximum(m, sw.max(-1).values)
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp(m - m_use)
                p = torch.exp(sw - m_use[:, None])
                out.append((m_new, l * alpha + p.sum(-1), alpha, p))
            for w, h in enumerate(halves):
                _, _, alpha, p = out[w]
                acc[w] = acc[w] * alpha[:, None] + p.to(q.dtype).float() @ \
                    v[keys, h].float()
            m, l = out[0][0], out[0][1]
        inv = torch.where(l > 0, 1.0 / l, 1.0)
        for w, h in enumerate(halves):
            o[rows, h] = acc[w] * inv[:, None]
        lse[rows] = torch.where(l > 0, m + torch.log(l), 0.0)
    return o.to(q.dtype), lse


def plan_outputs(name, drop=False):
    t, d, h, kv_h, causal, window, sink, _, _ = CASES[name]
    q, k, v, _ = (torch.tensor(x) for x in
                  inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=43))
    group = h // kv_h
    outs = [pair_forward(q[0, x], k[0, x // group], v[0, x // group],
                         d ** -0.5, causal, window, sink, drop)
            for x in range(h)]
    return (torch.stack([x[0] for x in outs])[None].numpy(),
            torch.stack([x[1] for x in outs])[None].numpy())


@pytest.fixture(scope="module")
def pallas_forward():
    """The Pallas forward's (out, lse) per case in interpret mode."""
    cache = {}

    def get(name):
        if name not in cache:
            t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
            q, k, v, _ = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=43)
            out, lse = _flash_forward(q, k, v, d ** -0.5, causal, bq, bk,
                                      interpret=True, window=window,
                                      sink=sink)
            cache[name] = (np.asarray(out),
                           np.asarray(lse)[:, :t].reshape(1, h, t))
        return cache[name]

    return get


@pytest.mark.parametrize("name", PAIR_CASES)
def test_pair_plan_matches_pallas_interpret(name, pallas_forward):
    """The plan at head dims 264-512 (GQA, window + sink, ragged T)
    against the Pallas forward in interpret mode: out and lse within
    2e-5."""
    got, want = plan_outputs(name), pallas_forward(name)
    for label, a, b in zip(("out", "lse"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL_OUT, err_msg=label)


@pytest.mark.parametrize("name", ["d264_causal", "d512_gqa4_ragged"])
def test_pair_plan_without_the_other_partial_fails(name, pallas_forward):
    """The planted fault: each warpgroup takes its own partial S alone;
    out and lse leave the tolerance."""
    got, want = plan_outputs(name, drop=True), pallas_forward(name)
    for label, a, b in zip(("out", "lse"), got, want):
        assert not np.allclose(a, b, atol=ATOL_OUT), label


@pytest.mark.parametrize("name", ["d300_noncausal_gqa", "d512_gqa4_ragged"])
def test_forward_entry_at_the_pair_head_dims_matches_pallas(name,
                                                            pallas_forward):
    """`flash_forward` on CPU tensors (the pair kernel's plain version,
    which the card holds the kernel to) against the Pallas forward."""
    t, d, h, kv_h, causal, window, sink, _, _ = CASES[name]
    q, k, v, _ = (torch.tensor(x) for x in
                  inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=43))
    before = A.pair_launches()
    o, lse = A.flash_forward(q, k, v, scale=d ** -0.5, causal=causal,
                             window=window, sink=sink)
    assert A.pair_launches() == before  # the plain path launches nothing
    for label, a, b in zip(("out", "lse"), (o.numpy(), lse.numpy()),
                           pallas_forward(name)):
        np.testing.assert_allclose(a, b, atol=ATOL_OUT, err_msg=label)


# ---------------------------------------------------------------------------
# the route, the grid, the halves and the shared memory


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [256, 257, 264, 300, 304, 384, 504, 512, 513,
                               520, 1024, 2112])
def test_pair_route_by_head_dim(d, dtype):
    """The forward takes the pair kernel (its one tile, (64, 64)) at head
    dims 257..PAIR_LD in bf16 and fp16, the sliced forward above and in
    f32, the class 256 kernel at 256; every tile it launches is built;
    dq's and dk/dv's tiles and `resolve_tiles` stay as they were."""
    on = 256 < d <= A.PAIR_LD and dtype != torch.float32
    assert A.pair_route(d, dtype) == on
    launched = A.launch_tiles(128, 128, d, dtype, 2048)
    tile = launched.fwd
    name = str(dtype).removeprefix("torch.")
    route = A.PAIR if on else A.head_class(d)
    assert ("fwd", name, route, *tile) in A.instantiations()
    tiles = A.resolve_tiles(128, 128, d, dtype, 2048)
    assert tile == ((64, 64) if on else tiles.fwd)
    assert (launched.dq, launched.dkv) == (tiles.dq, tiles.dkv)
    if on:
        assert tiles.fwd == (128, 64) and A.head_class(d) == A.SLICED


def test_the_pair_reach_is_the_dispatchers():
    """One bound chooses the route: ops/attention.PAIR_LD is csrc's
    PAIR_REACH, which the C interface sends the forward by, and the pair
    kernel's shared Q tile and halves are sized by it."""
    src = _build.SOURCE.read_text()
    reach = int(re.search(r"constexpr int PAIR_REACH = (\d+);",
                          src).group(1))
    assert reach == A.PAIR_LD == 512 and reach % 64 == 0
    assert src.count("head_dim > SLICE && head_dim <= PAIR_REACH") == 1
    assert "static constexpr int Q_BYTES = PAIR_REACH / 64 * CHUNK;" in src
    assert "return w == 0 ? 0 : (nc + 1) / 2;" in src
    assert "return w == 0 ? (nc + 1) / 2 : nc - (nc + 1) / 2;" in src


def test_the_pair_instantiations_are_bf16_and_fp16_only():
    """INSTANTIATED lists the pair kernel's one tile, built in bf16 and
    fp16 (both scale routes share the tile), never in f32."""
    pair = sorted(x for x in A.instantiations() if x[2] == A.PAIR)
    assert pair == [("fwd", "bfloat16", A.PAIR, 64, 64),
                    ("fwd", "float16", A.PAIR, 64, 64)]
    assert A.INSTANTIATED["fwd"][A.PAIR] == ((64,), (64,))


def _pair_block(x, t):
    """csrc's slice_tile at one slice over 64-row tiles: block x -> (b*h,
    row tile)."""
    n = -(-t // ROWS)
    return x // n, n - 1 - x % n


@pytest.mark.parametrize("bh,t", [(16, 2048), (3, 300), (2, 1000), (1, 64),
                                  (5, 130)])
def test_pair_grid_covers_every_row_tile_once(bh, t):
    """The launcher's grid (slice_blocks at one slice over 64 rows) visits
    every (b*h, row tile) once, each b*h's tiles from the last down."""
    n_tiles = -(-t // ROWS)
    seen = [_pair_block(x, t) for x in range(bh * n_tiles)]
    assert sorted(seen) == [(b, i) for b in range(bh)
                            for i in range(n_tiles)]
    for b in range(bh):
        mine = [i for bb, i in seen if bb == b]
        assert mine == list(range(n_tiles - 1, -1, -1))


@pytest.mark.parametrize("ld", [264, 272, 304, 384, 448, 504, 512])
def test_every_output_column_has_one_owning_warpgroup(ld):
    """At every chunk count up to the reach, odd ones included (264: 3 and
    2 chunks, 304, 384: 3 and 3, 512: 4 and 4): each column of O (and of
    the contraction) belongs to one warpgroup, each takes 2-4 chunks,
    warpgroup 0 at least as many as warpgroup 1, and the chunks a
    warpgroup loads lie within the head dim's."""
    nc = -(-ld // 64)
    owner = np.full(ld, -1)
    for w in range(2):
        first, count = pair_first(w, nc), pair_count(w, nc)
        assert 2 <= count <= 4 and first + count <= nc
        for c in range(first, first + count):
            cols = slice(64 * c, min(64 * c + 64, ld))
            assert (owner[cols] == -1).all()
            owner[cols] = w
    assert (owner >= 0).all()
    assert pair_count(0, nc) >= pair_count(1, nc)
    assert [h.start for h in _halves(ld)] == [0, 64 * pair_first(1, nc)]


def smem_plan():
    """csrc's FwdPairSmem: Q's resident chunks, the exchange buffers (two
    per warpgroup, one 32-column half of a 64 x 64 f32 partial each), each
    warpgroup's ring of 32 KB slots, the mbarriers and 1 KB of alignment
    slack."""
    src = _build.SOURCE.read_text()
    stages = int(re.search(r"static constexpr int STAGES = (\d+);\s+// a "
                           r"warpgroup's ring", src).group(1))
    chunk = 64 * 128
    q_bytes = A.PAIR_LD // 64 * chunk
    x_bytes = 64 * 32 * 4
    bars = 2 + 4 * stages
    return stages, q_bytes + 4 * x_bytes + 2 * stages * 4 * chunk \
        + 8 * bars + 1024


def test_the_shared_memory_plan_fits_a_block():
    """The plan fits a block's 232,448 bytes, and a warpgroup's ring holds
    two slabs (a slot a phase: its chunks, at most 4), so that the next
    key step's K slab loads while this step's V slab is in use."""
    stages, nbytes = smem_plan()
    assert nbytes <= 232448
    assert stages >= 2
    assert nbytes == 230480


# ---------------------------------------------------------------------------
# the exchange and the rings under random interleavings


class _Barrier:
    """An mbarrier: `count` arrivals complete a phase; a wait on parity p
    passes once the current phase's parity is not p."""

    def __init__(self, count):
        self.count, self.arrived, self.phase = count, 0, 0

    def arrive(self):
        self.arrived += 1
        assert self.arrived <= self.count
        if self.arrived == self.count:
            self.arrived, self.phase = 0, self.phase + 1

    def passes(self, parity):
        return self.phase & 1 != parity


class _Named:
    """A named barrier over `count` warps (bar.sync): a warp passes once
    the generation it arrived in has filled."""

    def __init__(self, count):
        self.count, self.arrived, self.gen = count, 0, 0

    def arrive(self):
        self.arrived += 1
        gen = self.gen
        if self.arrived == self.count:
            self.arrived, self.gen = 0, self.gen + 1
        return gen


class Pair:
    """One block of the pair forward over `steps` key steps: each warp of
    the two consumer warpgroups and each warpgroup's producer thread an
    actor (a warpgroup's warps act alike on the ring, so its empty barrier
    counts warps), each a generator that yields the condition it waits on.
    Per step a warpgroup takes its K slab (its chunks of K, one ring slot),
    whose products complete before the slot goes back, then passes its
    partial S through the exchange a 32-column half at a time (half h
    through its buffer h: stored, the same warp of the other warpgroup met
    at their named barrier, the other's half read and added, warpgroup 0's
    first), then takes its V slab.  `fault` plants one fault (FAULTS)."""

    def __init__(self, steps, stages=2, warps=2, fault=None):
        self.steps, self.warps, self.fault = steps, warps, fault
        self.stages = stages
        self.full = [[_Barrier(1) for _ in range(stages)] for _ in range(2)]
        self.empty = [[_Barrier(warps) for _ in range(stages)]
                      for _ in range(2)]
        self.named = [_Named(3 if fault == "barrier_count" else 2)
                      for _ in range(warps)]
        # a slot's or buffer's content and the readers still to read it
        self.held = {}
        self.sums = {}
        self.violations = []

    def write(self, key, value, readers):
        old = self.held.get(key)
        if old is not None and old[1]:
            self.violations.append(f"{key} overwritten with {value} before "
                                   f"{sorted(old[1])} read {old[0]}")
        self.held[key] = [value, set(readers)]

    def read(self, key, reader, want):
        old = self.held.get(key)
        if old is None or old[0] != want or reader not in old[1]:
            self.violations.append(f"{reader} read {old and old[0]} from "
                                   f"{key}, wanted {want}")
            return
        old[1].discard(reader)

    def items(self):
        """A warpgroup's ring items in order: each step's K slab, then its
        V slab."""
        return [(kind, it) for it in range(self.steps) for kind in "KV"]

    def producer(self, w):
        for n, item in enumerate(self.items()):
            s = n % self.stages
            if n >= self.stages and self.fault != "no_empty_wait":
                bar = self.empty[w][s]
                par = (n // self.stages - 1) & 1
                yield lambda: bar.passes(par)
            self.write(("slot", w, s), item,
                       {(w, x) for x in range(self.warps)})
            self.full[w][s].arrive()

    def take(self, w, n, me):
        """(consumer) item n's slot once filled: read, and handed back once
        its products complete."""
        s, par = n % self.stages, (n // self.stages) & 1
        bar = self.full[w][s]
        yield lambda: bar.passes(par)
        self.read(("slot", w, s), me, self.items()[n])
        self.empty[w][s].arrive()

    def consumer(self, w, warp):
        me, other = (w, warp), (1 - w, warp)
        for it in range(self.steps):
            yield from self.take(w, 2 * it, me)
            for h in range(2):
                buf = 0 if self.fault == "one_buffer" else h
                self.write(("x", w, buf, warp), ("part", it, h, w), {other})
                gen = self.named[warp].arrive()
                if self.fault != "no_barrier":
                    bar = self.named[warp]
                    yield lambda: bar.gen > gen
                self.read(("x", 1 - w, buf, warp), me,
                          ("part", it, h, 1 - w))
                order = [w, 1 - w] if self.fault == "own_first" else [0, 1]
                self.sums[me + (it, h)] = order
            yield from self.take(w, 2 * it + 1, me)

    def run(self, seed):
        """Runs the actors until all end, each pick running one ready actor
        for a random burst of up to 24 moves (warps run ahead of each
        other unevenly); returns the violations (a deadlock among them)."""
        rng = random.Random(seed)
        actors = [self.producer(w) for w in range(2)] + [
            self.consumer(w, x) for w in range(2) for x in range(self.warps)]
        waiting = {i: None for i in range(len(actors))}
        while waiting:
            ready = [i for i, cond in waiting.items()
                     if cond is None or cond()]
            if not ready:
                self.violations.append("deadlock")
                break
            i = rng.choice(ready)
            for _ in range(rng.randint(1, 24)):
                cond = waiting[i]
                if cond is not None and not cond():
                    break
                try:
                    waiting[i] = next(actors[i])
                except StopIteration:
                    del waiting[i]
                    break
        for key, order in self.sums.items():
            if order != [0, 1]:
                self.violations.append(f"{key} summed in the order {order}")
        return self.violations


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("warps", [1, 2, 4])
def test_the_exchange_and_rings_hold_under_random_interleavings(warps, seed):
    """As built (csrc's STAGES, two half buffers a warpgroup, a named
    barrier per warp pair): no violation in random interleavings over 6
    steps with 1, 2 and 4 warps a warpgroup."""
    stages, _ = smem_plan()
    assert Pair(6, stages=stages, warps=warps).run(seed) == []


# planted faults, each of which some interleaving shows: one exchange
# buffer for both halves (a half stored over one the other warpgroup has
# not read); a read of the other's half without the barrier; warpgroup 1
# adding its own partial first; a producer that refills a slot without
# waiting for it to be handed back; a named barrier counting a warp too
# many (nothing passes it)
FAULTS = ["one_buffer", "no_barrier", "own_first", "no_empty_wait",
          "barrier_count"]


@pytest.mark.parametrize("fault", FAULTS)
def test_the_exchange_model_catches_each_planted_fault(fault):
    """Each planted fault shows as a violation in some of 40 random
    interleavings."""
    assert any(Pair(6, fault=fault).run(seed) for seed in range(40))
