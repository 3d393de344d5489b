"""The cluster dq and dk/dv kernels, held on the CPU.

At head dims 257..1024 in bf16 and fp16 (`ops/attention.cluster_route`)
dq and dk/dv run on the cluster kernels (`csrc/flash_attention.cu`:
dq_cluster_kernel, dkv_cluster_kernel): the blocks of one row or key
tile's 256-column slices form a thread-block cluster, each contracts its
own slice into a partial S and dP (S^T and dP^T in dk/dv), the owner of
each 16-row warp sums the partials in slice order, forms P and dS and
hands out their A fragments, and each block adds its slice of the outputs.
The kernels run on the card only; here:
  * the plan in plain torch (partials by slice in f32, summed in slice
    order, P and dS from the sum, outputs by slice) against the Pallas
    kernels in interpret mode at the head dims of
    tests/test_torch_wide_head.py (264-1024, GQA, window + sink, ragged
    T), within that file's gradient tolerance (1e-4: both sides sum the
    same products in another order); the plan with one block's partial
    left out fails it;
  * the route (which head dims take the cluster kernels, the bound shared
    with csrc), the cluster (n_slices blocks, the grid whole clusters),
    every output element written by one block, the ownership of the rows
    and the exchange buffers' slots, and the shared-memory plans;
  * the exchange under random interleavings of every warp of every block
    of a cluster (reduce-scatter, all-gather, the warpgroups' hand-over of
    P and of dS's fragments, mbarriers with their parity waits): no buffer
    is overwritten before its readers have read it, every owner sums the
    partials of its rows in slice order, every reader gets the owner's
    data, no block exits while a partner still stores into it, nothing
    waits forever; each planted fault breaks one of these.
"""
import random
import re

import numpy as np
import pytest
import torch

from tf_operator_tpu.ops.attention import flash_attention_grads_interpret
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import attention as A

from test_torch_attention import ATOL_GRAD, inputs
from test_torch_wide_head import CASES

torch.set_num_threads(1)

SLICE, ROWS, STEP = A.SLICE, 64, 64


def cl_owner(w, ns):
    """csrc's cl_owner: the block of a cluster of ns that owns warp w's
    16 rows of a 64-row tile."""
    return w * ns // 4


def cl_first(r, ns):
    return (4 * r + ns - 1) // ns


def cl_owned(r, ns):
    return cl_first(r + 1, ns) - cl_first(r, ns)


# ---------------------------------------------------------------------------
# the plan in plain torch


def _live(t, causal, window, sink):
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    keep = torch.ones(t, t, dtype=torch.bool)
    if causal:
        keep = j <= i
        if window:
            keep = keep & ((i - j < window) | (j < sink))
    return keep


def _slices(d):
    return [slice(c0, min(c0 + SLICE, d)) for c0 in range(0, d, SLICE)]


def cluster_sum(a, b, drop=None):
    """a @ b^T as the cluster forms it: each block's partial over its own
    slice's columns in f32, the partials of each warp's 16 rows summed by
    the owner in slice order.  `drop` (a planted fault): the owner of
    warp 0's rows leaves out that slice's partial."""
    parts = [a[:, cols] @ b[:, cols].T for cols in _slices(a.shape[-1])]
    out = parts[0].clone()
    for s, part in enumerate(parts[1:], 1):
        out = out + part
        if drop == s:
            out[:16] -= part[:16]
    return out


def cluster_dq(q, k, v, do, lse, delta, scale, keep, drop=None):
    """dq of one head as the cluster dq computes it: per 64-row tile and
    64-key step, S and dP summed across the slices' blocks, p and ds from
    the sums, each slice's columns of dq += ds K[:, slice]."""
    t, d = q.shape
    dq = torch.zeros_like(q)
    for q0 in range(0, t, ROWS):
        rows = slice(q0, q0 + ROWS)
        for k0 in range(0, t, STEP):
            keys = slice(k0, k0 + STEP)
            s = cluster_sum(q[rows], k[keys], drop) * scale
            p = torch.where(keep[rows, keys], torch.exp(s - lse[rows, None]),
                            0.0)
            ds = p * (cluster_sum(do[rows], v[keys], drop)
                      - delta[rows, None])
            for cols in _slices(d):
                dq[rows, cols] += ds @ k[keys, cols]
    return dq * scale


def cluster_dkv(qs, k, v, dos, lses, deltas, scale, keep, drop=None):
    """(dk, dv) of one KV head as the cluster dk/dv computes them: per
    64-key tile, the group's query heads and their 64-query tiles in
    order, S^T and dP^T summed across the slices' blocks, P^T and dS^T
    from the sums, each slice's columns of dV += P^T dO[:, slice] and dK +=
    dS^T Q[:, slice]."""
    t, d = k.shape
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, t, ROWS):
        keys = slice(k0, k0 + ROWS)
        for q, do, lse, delta in zip(qs, dos, lses, deltas):
            for q0 in range(0, t, STEP):
                rows = slice(q0, q0 + STEP)
                st = cluster_sum(k[keys], q[rows], drop) * scale
                pt = torch.where(keep[rows, keys].T,
                                 torch.exp(st - lse[None, rows]), 0.0)
                dst = pt * (cluster_sum(v[keys], do[rows], drop)
                            - delta[None, rows])
                for cols in _slices(d):
                    dv[keys, cols] += pt @ do[rows, cols]
                    dk[keys, cols] += dst @ q[rows, cols]
    return dk * scale, dv


@pytest.fixture(scope="module")
def pallas_grads():
    """The Pallas kernels' (dq, dk, dv) per case in interpret mode."""
    cache = {}

    def get(name):
        if name not in cache:
            t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
            q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=41)
            cache[name] = [np.asarray(x) for x in
                           flash_attention_grads_interpret(
                               q, k, v, g, causal, None, bq, bk,
                               window=window, sink=sink)[1:]]
        return cache[name]

    return get


def plan_grads(name, drop=None):
    """(dq, dk, dv) of the cluster plan at a case, from the plain forward's
    lse and delta."""
    t, d, h, kv_h, causal, window, sink, _, _ = CASES[name]
    q, k, v, g = (torch.tensor(x) for x in
                  inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=41))
    scale = d ** -0.5
    o, lse = A.attention_lse(q, *A.repeat_kv(q, k, v), causal=causal,
                             scale=scale, window=window, sink=sink)
    delta = (g * o).sum(-1)
    keep = _live(t, causal, window, sink)
    group = h // kv_h
    dq = torch.stack([cluster_dq(q[0, x], k[0, x // group], v[0, x // group],
                                 g[0, x], lse[0, x], delta[0, x], scale,
                                 keep, drop) for x in range(h)])[None]
    dkv = [cluster_dkv([q[0, x] for x in heads], k[0, kv], v[0, kv],
                       [g[0, x] for x in heads], [lse[0, x] for x in heads],
                       [delta[0, x] for x in heads], scale, keep, drop)
           for kv, heads in ((kv, range(kv * group, (kv + 1) * group))
                             for kv in range(kv_h))]
    dk = torch.stack([x[0] for x in dkv])[None]
    dv = torch.stack([x[1] for x in dkv])[None]
    return [x.numpy() for x in (dq, dk, dv)]


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("name", list(CASES))
def test_cluster_plan_matches_pallas_interpret(name, kernel, pallas_grads):
    """The plan at head dims 264-1024 (GQA, window + sink, ragged T)
    against the Pallas kernels in interpret mode within 1e-4."""
    got = dict(zip(("dq", "dk", "dv"), plan_grads(name)))
    want = dict(zip(("dq", "dk", "dv"), pallas_grads(name)))
    for label in (("dq",) if kernel == "dq" else ("dk", "dv")):
        np.testing.assert_allclose(got[label], want[label], atol=ATOL_GRAD,
                                   err_msg=label)


@pytest.mark.parametrize("name", ["d512_gqa4_ragged", "d1024_causal"])
def test_cluster_plan_without_a_partners_partial_fails(name, pallas_grads):
    """The planted fault: the owner of one warp's rows leaves out one
    slice's partial of S and dP; dq, dk and dv all leave the tolerance."""
    got = plan_grads(name, drop=1)
    for label, a, b in zip(("dq", "dk", "dv"), got, pallas_grads(name)):
        assert not np.allclose(a, b, atol=ATOL_GRAD), label


# ---------------------------------------------------------------------------
# the route, the cluster and the grid


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [257, 264, 300, 512, 513, 768, 1000, 1016,
                               1024, 1025, 1032, 2048, 2112])
def test_cluster_route_by_head_dim(d, dtype):
    """dq and dk/dv take the cluster kernels (CLUSTER's tiles, one
    cluster of n_slices blocks) at head dims 257..CLUSTER_LD in bf16 and
    fp16, the sliced kernels above and in f32; the forward stays on the
    sliced kernel; every tile they resolve to is built."""
    on = d <= A.CLUSTER_LD and dtype != torch.float32
    assert A.cluster_route(d, dtype) == on
    tiles = A.resolve_tiles(128, 128, d, dtype, 2048)
    name = str(dtype).removeprefix("torch.")
    built = A.instantiations()
    for kernel in ("fwd", "dq", "dkv"):
        route = A.CLUSTER if on and kernel != "fwd" else A.SLICED
        assert (kernel, name, route, *getattr(tiles, kernel)) in built
    if on:
        assert tiles.dq == tiles.dkv == (64, 64)
        assert 2 <= A.n_slices(d) <= 4
    else:
        assert tiles == A.resolve_tiles(128, 128, 2112, dtype, 2048)


def test_the_reach_is_the_dispatchers():
    """One bound chooses the route: ops/attention.CLUSTER_LD is csrc's
    CLUSTER_REACH, which the C interface sends dq and dk/dv by."""
    src = _build.SOURCE.read_text()
    reach = int(re.search(r"constexpr int CLUSTER_REACH = (\d+);",
                          src).group(1))
    assert reach == A.CLUSTER_LD == 1024 and reach % 8 == 0
    assert src.count("head_dim > SLICE && head_dim <= CLUSTER_REACH") == 2


def _dq_block(x, t, ns):
    """csrc's slice_tile over 64-row tiles: block x -> (b*h, row tile,
    slice)."""
    n = -(-t // ROWS)
    return x // ns // n, n - 1 - x // ns % n, x % ns


def _dkv_block(x, n_blocks, t, ns):
    """dkv_cluster_kernel's block x -> (key tile, b*kv_head, slice)."""
    n_kt = -(-t // ROWS)
    bkv_n = n_blocks // (n_kt * ns)
    rest = x // ns
    return rest // bkv_n, rest % bkv_n, x % ns


@pytest.mark.parametrize("n,t,ld", [(16, 2048, 512), (3, 300, 304),
                                    (2, 1000, 264), (1, 64, 1024),
                                    (5, 130, 768)])
def test_clusters_tile_the_grid_and_write_every_element_once(n, t, ld):
    """The launchers' grid (slice_blocks over 64-row tiles) is a whole
    number of clusters of n_slices(ld) blocks; a cluster's blocks share
    one row tile (dq) or key tile (dk/dv) and their cluster ranks are the
    slices 0..ns-1; every element of dq (each warpgroup 128 columns of its
    block's slice) and of dk and dv is written by one block."""
    ns = A.n_slices(ld)
    blocks = n * -(-t // ROWS) * ns
    assert blocks % ns == 0
    for decode in (lambda x: _dq_block(x, t, ns),
                   lambda x: _dkv_block(x, blocks, t, ns)):
        seen = [decode(x) for x in range(blocks)]
        for c in range(0, blocks, ns):
            cluster = seen[c:c + ns]
            assert len({(a, b) for a, b, _ in cluster}) == 1
            assert [s for _, _, s in cluster] == [x % ns for x in
                                                 range(c, c + ns)]
    dq = np.zeros((n, t, ld), np.int32)
    for x in range(blocks):
        bh, tile, s = _dq_block(x, t, ns)
        for wg in range(2):
            c0 = SLICE * s + 128 * wg
            dq[bh, tile * ROWS:(tile + 1) * ROWS, c0:min(c0 + 128, ld)] += 1
    dkv = np.zeros((n, t, ld), np.int32)
    for x in range(blocks):
        kt, bkv, s = _dkv_block(x, blocks, t, ns)
        dkv[bkv, kt * ROWS:(kt + 1) * ROWS,
            SLICE * s:min(SLICE * (s + 1), ld)] += 1
    assert (dq == 1).all() and (dkv == 1).all()


@pytest.mark.parametrize("ns", [2, 3, 4])
def test_every_warp_has_one_owner_and_its_slots_are_distinct(ns):
    """Each warp's rows are owned by one block, every block owns some;
    the reduce-scatter slots an owner reads (one per owned warp and other
    block) and the all-gather slots a block reads (one per warp another
    block owns) are distinct and within the buffers csrc sizes (ClusterX:
    (ns - 1) x the most warps a block owns, 4 - the fewest)."""
    owned = [[w for w in range(4) if cl_owner(w, ns) == r] for r in range(ns)]
    assert sorted(sum(owned, [])) == [0, 1, 2, 3]
    assert all(owned) and [len(x) for x in owned] == [cl_owned(r, ns)
                                                      for r in range(ns)]
    rs_cap = (ns - 1) * max(map(len, owned))
    ag_cap = 4 - min(map(len, owned))
    for r in range(ns):
        assert owned[r] == list(range(cl_first(r, ns),
                                      cl_first(r, ns) + cl_owned(r, ns)))
        rs = [(w - cl_first(r, ns)) * (ns - 1) + s - (s > r)
              for w in owned[r] for s in range(ns) if s != r]
        assert sorted(rs) == list(range(len(rs))) and len(rs) <= rs_cap
        ag = [w if w < cl_first(r, ns) else w - cl_owned(r, ns)
              for w in range(4) if cl_owner(w, ns) != r]
        assert sorted(ag) == list(range(len(ag))) and len(ag) <= ag_cap


def smem_plan(kernel, ns):
    """(ring slots, bytes, exchange buffers) of csrc's DqClusterSmem /
    DkvClusterSmem: the two resident slices, the exchange buffers (dq: two
    steps' where three slots still fit), the warpgroups' hand-over
    buffers, as many 32 KB slots as the rest of a block's 232,448 bytes
    holds (at most 4), the mbarriers and 1 KB of alignment slack."""
    opnd, f32_chunk, frag_chunk = 4 * 64 * 128, 32 * 32 * 4, 32 * 16 * 4
    most = max(cl_owned(r, ns) for r in range(ns))
    fewest = min(cl_owned(r, ns) for r in range(ns))
    rs, ag = (ns - 1) * most * f32_chunk, (4 - fewest) * frag_chunk

    def slots_after(fixed, bars):
        return min(4, (232448 - fixed - 1024 - 8 * bars) // opnd)

    if kernel == "dq":
        hand, bars = most * (f32_chunk + frag_chunk), 1 + 8 + 32 + 8
        buffers = 2 if slots_after(2 * opnd + 2 * (2 * rs + ag) + hand,
                                   bars) >= 3 else 1
        ring_off = 2 * opnd + buffers * (2 * rs + ag) + hand
    else:
        bars, buffers = 1 + 8 + 16 + 8, 1
        ring_off = 2 * opnd + 2 * (rs + ag) + most * f32_chunk
    slots = slots_after(ring_off, bars)
    nbytes = ring_off + slots * opnd + 8 * (bars - 8 + 2 * slots) + 1024
    return slots, nbytes, buffers


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("ns", [2, 3, 4])
def test_shared_memory_plans_fit_a_block(kernel, ns):
    """Every plan fits a block with at least three slots (dq) or two
    (dk/dv); at two slices (d512_mqa) dk/dv keeps four, two tiles' Q and
    dO, and dq two steps' exchange buffers beside three slots."""
    slots, nbytes, buffers = smem_plan(kernel, ns)
    assert (3 if kernel == "dq" else 2) <= slots <= 4
    assert nbytes <= 232448
    if ns == 2:
        assert (slots, buffers) == ((3, 2) if kernel == "dq" else (4, 1))
    else:
        assert buffers == 1


# ---------------------------------------------------------------------------
# the exchange under random interleavings


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


class Cluster:
    """One tile pair's exchange in a cluster of ns blocks over `steps`
    steps: every (block, warpgroup, warp) an actor (its 32 lanes act
    alike, so a barrier counts warps), each a generator that yields the
    condition it waits on.  `kind` "dkv": warpgroup 0 sums S^T and gives
    out P^T's fragments, warpgroup 1 sums dP^T, takes P^T (f32) from
    warpgroup 0 (and hands the buffer back) and gives out dS^T's, each
    warpgroup into an all-gather buffer of its own; "dq": warpgroup 0 sums
    S and hands p to warpgroup 1, which sums dP and hands ds's fragments
    back to warpgroup 0 (the two hand-overs take turns, with no barrier
    back) and gives them out into one all-gather buffer that both
    warpgroups of a block read.  A reduce-scatter or all-gather buffer's
    barrier completes when its writers' stores have landed (st.async
    counts their bytes; here their warps).  dq at two slices keeps two
    steps' exchange buffers (smem_plan): step it uses buffer it % 2, whose
    barrier completes once every two steps, and a non-owner sends the next
    step's partial before it takes this step's fragments; elsewhere one
    buffer, and the partial goes after.  `fault` plants one fault
    (FAULTS); "early_send" sends early with one buffer."""

    def __init__(self, kind, ns, steps, fault=None):
        self.kind, self.ns, self.steps, self.fault = kind, ns, steps, fault
        self.nbuf = 2 if kind == "dq" and ns == 2 else 1
        self.early = self.nbuf == 2 or fault == "early_send"
        self.bars = {}
        for r in range(ns):
            for w in range(4):
                for wg in range(2):
                    for b in range(self.nbuf):
                        self.bars[r, "rs", wg, w, b] = _Barrier(ns - 1)
                        self.bars[r, "ag", wg, w, b] = _Barrier(1)
                for name in ("p_full", "p_empty", "ds_full"):
                    self.bars[r, name, w] = _Barrier(1)
        # buffer -> [value, readers that have still to read it]
        self.buffers = {}
        self.sums = {}  # (block, wg, warp, step) -> sources in added order
        self.violations = []
        self.done = set()
        self.exited = set()

    def write(self, key, value, readers):
        held = self.buffers.get(key)
        if held is not None and held[1]:
            self.violations.append(f"{key} overwritten before {held[1]} "
                                   f"read {held[0]}")
        if key[0] in self.exited:
            self.violations.append(f"{key} stored into an exited block")
        self.buffers[key] = [value, set(readers)]

    def read(self, key, reader, want):
        held = self.buffers.get(key)
        if held is None or held[0] != want or reader not in held[1]:
            self.violations.append(f"{reader} read {held and held[0]} from "
                                   f"{key}, wanted {want}")
            return
        held[1].discard(reader)

    def wait(self, r, *name, parity):
        bar = self.bars[(r, *name)]
        return lambda: bar.passes(parity)

    def ag_area(self, wg):
        return wg if self.kind == "dkv" else 1

    def ag_readers(self, s, w, wg):
        """Who reads the all-gather buffer warp w's owner fills in block
        s: the non-owner warp of the giving warpgroup (dk/dv), or of both
        warpgroups (dq)."""
        wgs = (wg,) if self.kind == "dkv" else (0, 1)
        return {(s, x, w) for x in wgs}

    def send(self, r, wg, w, it):
        """A non-owner's partial of step `it` into its owner's buffer."""
        o, b = cl_owner(w, self.ns), it % self.nbuf
        self.write((o, "rs", wg, w, r, b), ("part", it, r), {(o, wg, w)})
        self.bars[o, "rs", wg, w, b].arrive()

    def actor(self, r, wg, w):
        ns, me = self.ns, (r, wg, w)
        o = cl_owner(w, ns)
        giver = 1 if self.kind == "dq" else wg  # who gives out fragments
        if o != r and self.early:
            self.send(r, wg, w, 0)
        for it in range(self.steps):
            b = it % self.nbuf
            par = (it // self.nbuf) & 1  # an exchange barrier's phase
            turn = it & 1  # a hand-over barrier's: one phase a step
            if o == r:
                if self.fault != "no_rs_wait":
                    yield self.wait(r, "rs", wg, w, b, parity=par)
                order = [] if self.fault == "arrival_order" else list(
                    range(ns))
                if self.fault == "arrival_order":
                    # sums what has arrived first, then the rest
                    order = sorted(range(ns), key=lambda s: (
                        s != r, random.random()))
                for s in order:
                    if s != r:
                        self.read((r, "rs", wg, w, s, b), me, ("part", it, s))
                self.sums[me + (it,)] = order
                dkv = self.kind == "dkv"
                if wg == 0:  # P (or P^T) to warpgroup 1
                    if dkv and it >= 1 and self.fault != "no_p_empty":
                        yield self.wait(r, "p_empty", w, parity=(it - 1) & 1)
                    self.write((r, "p", w), ("p", it), {(r, 1, w)})
                    self.bars[r, "p_full", w].arrive()
                else:
                    yield self.wait(r, "p_full", w, parity=turn)
                    self.read((r, "p", w), me, ("p", it))
                    if dkv:
                        self.bars[r, "p_empty", w].arrive()
                if not dkv:
                    if wg == 1:  # ds's fragments back to warpgroup 0
                        self.write((r, "ds", w), ("ds", it), {(r, 0, w)})
                        self.bars[r, "ds_full", w].arrive()
                    else:
                        if self.fault != "no_ds_wait":
                            yield self.wait(r, "ds_full", w, parity=turn)
                        self.read((r, "ds", w), me, ("ds", it))
                if wg == giver:
                    area = self.ag_area(wg)
                    for s in range(ns):
                        if s != r:
                            self.write((s, "ag", area, w, b),
                                       ("frag", it, r),
                                       self.ag_readers(s, w, wg))
                            self.bars[s, "ag", area, w, b].arrive()
            else:
                if self.early:
                    if it + 1 < self.steps:
                        self.send(r, wg, w, it + 1)
                elif not (self.fault == "send_ahead" and it == 1):
                    self.send(r, wg, w, it)
                if self.fault == "send_ahead" and it == 0:
                    # the next partial before this step's fragments
                    self.send(r, wg, w, 1)
                area = self.ag_area(wg)
                yield self.wait(r, "ag", area, w, b, parity=par)
                self.read((r, "ag", area, w, b), me, ("frag", it, o))
        self.done.add(me)
        if self.fault != "no_cluster_sync":
            yield lambda: len(self.done) == ns * 8
        if all((r, x, v) in self.done for x in range(2) for v in range(4)):
            self.exited.add(r)

    def run(self, seed):
        """Runs every actor in a random interleaving until all end; returns
        the violations (a deadlock among them)."""
        rng = random.Random(seed)
        random.seed(seed)
        actors = [self.actor(r, wg, w) for r in range(self.ns)
                  for wg in range(2) for w in range(4)]
        waiting = {i: None for i in range(len(actors))}
        while waiting:
            ready = [i for i, cond in waiting.items()
                     if cond is None or cond()]
            if not ready:
                self.violations.append("deadlock")
                break
            i = rng.choice(ready)
            try:
                waiting[i] = next(actors[i])
            except StopIteration:
                del waiting[i]
        for (r, wg, w, it), order in self.sums.items():
            if order != list(range(self.ns)):
                self.violations.append(f"block {r} summed warp {w}'s step "
                                       f"{it} in the order {order}")
        return self.violations


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ns", [2, 3, 4])
@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_cluster_exchange_holds_under_random_interleavings(kind, ns, seed):
    """The exchange as built: no violation in 6 random interleavings of
    every warp of every block over 5 steps."""
    assert Cluster(kind, ns, 5).run(seed) == []


# planted faults, each of which some interleaving shows: an owner that
# reads its reduce-scatter buffers without waiting for them; one that sums
# in arrival order; a non-owner that stores its next partial before this
# step's fragments came back (and so into a buffer the owner may not have
# read), or every step's early with one buffer; in dk/dv warpgroup 0
# writing P^T before warpgroup 1 handed the last one back; in dq warpgroup
# 0 reading ds's fragments without waiting for them
FAULTS = [(kind, fault) for kind in ("dq", "dkv")
          for fault in ("no_rs_wait", "arrival_order", "send_ahead",
                        "early_send")] + [
    ("dkv", "no_p_empty"), ("dq", "no_ds_wait")]


@pytest.mark.parametrize("kind,fault", FAULTS)
def test_cluster_exchange_model_catches_each_planted_fault(kind, fault):
    """Each planted fault shows as a violation in some of 40 random
    interleavings at three slices."""
    assert any(Cluster(kind, 3, 5, fault).run(seed) for seed in range(40))


def test_the_two_buffers_hold_where_dq_sends_early():
    """dq at two slices (two exchange buffers, the next partial sent
    before this step's fragments come back) holds in 40 interleavings;
    the same early send into one buffer does not."""
    assert Cluster("dq", 2, 6).nbuf == 2
    assert not any(Cluster("dq", 2, 6).run(seed) for seed in range(40))
    one = [Cluster("dkv", 2, 6, "early_send").run(seed) for seed in range(40)]
    assert any(one)
