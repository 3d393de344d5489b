"""f32 dq on the tensor cores, held on the CPU.

In f32 dq runs on `dq_tf32_kernel` (csrc/flash_attention.cu, with the
three-pass TF32 products of csrc/tf32.cuh) at every head dim: every
product is mma.sync m16n8k8 in three TF32 passes, each short chain of
products (one 32-column block of a contraction, one key step of dq += dS K)
summed on its own and promoted into the long f32 sum, a contraction's
blocks (and the cluster's partials) by Kahan's compensated sum; above head
dim 256 the blocks of a row tile's 256-column slices form a cluster whose
partial S and dP are summed in slice order (above TF32_LD each slice's
block contracts the whole head dim itself); where p >= TF32_REFINE (1/8)
dP - delta comes from a compensated dot product of the element's rows of
dO and V instead.  The kernel runs on the card only; here, with the
emulation of tests/test_torch_f32_dkv.py (TF32 rounding on the float's
bits, each mma's sum rounded toward zero):
  * that plan in plain torch against the Pallas dq kernel in interpret mode
    in f32 by the f32 rule (chip_smoke.RTOL_F32, FRO_F32) at head dims 64,
    128, 256, 300, 512, 1024, 2048 (the cluster's reach) and 2112 beyond
    it, with GQA and MQA, causal, window + sink, a ragged T and the scale
    negated;
  * the plan with one TF32 pass (the planted fault) leaves the rule;
  * at large logits (scale -1) plain f32's dq against the exact result
    (the plain version in f64), and the plan against it, with and without
    the heavy elements' compensated dP;
  * the grid (every row tile and column slice once, clusters whole, the
    longest walks first), the shared-memory plan against 227 KB, and the
    route and tiles by dtype and head dim.
"""
import re

import numpy as np
import pytest
import torch

from chip_smoke import FRO_F32, RTOL_F32, tolerance_ratios
from tf_operator_tpu.ops.attention import flash_attention_grads_interpret
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import attention as A

from test_torch_attention import inputs
from test_torch_f32_dkv import (CASES, _live, case_scale, compensated,
                                contract, large_logits, mma3)

torch.set_num_threads(1)

ROWS = 64  # query rows a block
# csrc's TF32_REFINE: the p at and above which dq_tf32_kernel takes dP -
# delta from a compensated dot product
REFINE = 0.125


# ---------------------------------------------------------------------------
# the plan in plain torch


def dq_step_tile(d):
    """(columns a block takes, key step): attention.F32_DQ's tile."""
    route = A.route("dq", d, torch.float32)
    cols = A.SLICE if route in (A.CLUSTER, A.SLICED) else route
    return cols, A.F32_DQ[route][1]


def plan_dq(q, k, v, do, lse, delta, scale, keep, passes=3, refine=True):
    """dq of one query head (k and v its KV head's) as dq_tf32_kernel
    computes it: S and dP from each column slice's contraction (each
    32-column block's products summed on their own, the blocks and then
    the slices' partials added in order by the compensated sum; above
    TF32_LD one contraction over every column), P and dS (with `refine`,
    dP - delta where p >= REFINE from the compensated dot product, taken
    as exact and rounded once), and for each slice dq += dS K a key step
    at a time, each step's products summed on their own and added in f32,
    dq scaled after.  The contraction is taken
    over whole rows at once: each element's sum is the same whatever tile
    holds it.  A row tile walks its live key steps in increasing order
    (sinks, then the band: key_tiles), and a step it skips adds exact
    zeros here, so every row's sum takes the kernel's order."""
    t, d = q.shape
    ld = d + -d % 8
    q, k, v, do = (torch.nn.functional.pad(x, (0, ld - d))
                   for x in (q, k, v, do))
    width, bk = dq_step_tile(ld)
    slices = [slice(c0, min(c0 + width, ld)) for c0 in range(0, ld, width)]
    streamed = A.route("dq", ld, torch.float32) == A.SLICED
    partials = [slice(0, ld)] if streamed else slices
    chains = width > 64  # two blocks an SM at 64 columns: one sum
    s = compensated([contract(q, k, cols, passes, chains)
                     for cols in partials])
    dp = compensated([contract(do, v, cols, passes, chains)
                      for cols in partials])
    p = torch.where(keep, torch.exp(s * scale - lse[:, None]), 0.0)
    dpd = dp - delta[:, None]
    if refine:
        exact = (do.double() @ v.double().T - delta.double()[:, None]).float()
        dpd = torch.where(p >= REFINE, exact, dpd)
    ds = p * dpd
    dq = torch.zeros_like(q)
    for k0 in range(0, t, bk):
        keys = slice(k0, min(k0 + bk, t))
        for cols in slices:
            dq[:, cols] = dq[:, cols] + mma3(ds[:, keys], k[keys, cols],
                                             passes, chains)
    return (dq * scale)[:, :d]


def plan_from(q, k, v, g, lse, delta, scale, causal, window, sink,
              passes=3, refine=True):
    """dq of the plan [1, h, t, d] from f32 tensors, lse and delta given."""
    t = q.shape[2]
    h, kv_h = q.shape[1], k.shape[1]
    keep = _live(t, causal, window, sink)
    group = h // kv_h
    return torch.stack([plan_dq(q[0, x], k[0, x // group], v[0, x // group],
                                g[0, x], lse[0, x], delta[0, x], scale, keep,
                                passes, refine) for x in range(h)])[None]


def plan_grads(name, passes=3):
    """dq of the plan at a case, from the plain forward's lse and delta."""
    t, d, h, kv_h, causal, window, sink, _, _ = CASES[name]
    q, k, v, g = (torch.tensor(x) for x in
                  inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=53))
    scale = case_scale(name)
    o, lse = A.attention_lse(q, *A.repeat_kv(q, k, v), causal=causal,
                             scale=scale, window=window, sink=sink)
    delta = (g * o).sum(-1)
    return plan_from(q, k, v, g, lse, delta, scale, causal, window, sink,
                     passes).numpy()


@pytest.fixture(scope="module")
def pallas_dq():
    """The Pallas kernels' dq per case in interpret mode, in f32."""
    cache = {}

    def get(name):
        if name not in cache:
            t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
            q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=53)
            cache[name] = np.asarray(flash_attention_grads_interpret(
                q, k, v, g, causal, case_scale(name), bq, bk, window=window,
                sink=sink)[1], np.float32)
        return cache[name]

    return get


# dq's first query row under causal masking, whose one live key makes it
# zero in exact arithmetic but for delta's rounding, held within this of
# the Pallas kernel's (the card's tests' ZERO_ABS for outputs zero in
# exact arithmetic): there the Pallas kernel's f32 dP carries its own
# rounding against a dP - delta cancelled to that size, which the f32
# rule, relative to the tensor's RMS at its floor, does not take (3.0x at
# head dim 1024 here; plain f32 leaves the rule there against the exact
# result, and the plan holds it: the tests below)
FIRST_ROW_ABS = 1e-4


def held(got, want, causal=False):
    """dq within the f32 rule: ((worst err/limit, relative Frobenius),
    whether it holds); with `causal`, the first query row within
    FIRST_ROW_ABS and the rule over the rest."""
    got, want = (torch.tensor(np.asarray(x)) for x in (got, want))
    if causal:
        first = float((got[..., 0, :] - want[..., 0, :]).abs().max())
        got, want = got[..., 1:, :], want[..., 1:, :]
    worst, rel = tolerance_ratios(got, want, RTOL_F32)
    ok = worst <= 1.0 and rel <= FRO_F32
    return (worst, rel), ok and (not causal or first <= FIRST_ROW_ABS)


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_pallas_interpret_by_the_f32_rule(name, pallas_dq):
    """The plan (three TF32 passes, short sums promoted in f32, the
    cluster's partials in slice order) against the Pallas dq kernel in
    interpret mode in f32, by the f32 rule (under causal masking the first
    query row within FIRST_ROW_ABS), at every route: the classes 64, 128
    and 256, the cluster at 2 to 8 slices, and beyond its reach; at the
    cluster and beyond it also with the scale negated."""
    ratios, ok = held(plan_grads(name), pallas_dq(name), CASES[name][4])
    assert ok, ratios


@pytest.mark.parametrize("name", ["d64_gqa_ragged", "d256_mqa_split",
                                  "d512_window_sink_ragged"])
def test_one_tf32_pass_leaves_the_f32_rule(name, pallas_dq):
    """The planted fault: every product in one TF32 pass leaves the f32
    rule by a wide margin, so the rule can see TF32 in dq too."""
    ratios, ok = held(plan_grads(name, passes=1), pallas_dq(name),
                      CASES[name][4])
    assert not ok
    assert ratios[1] > 10 * FRO_F32, ratios


# ---------------------------------------------------------------------------
# large logits: scale -1 at the card's test of the sliced kernels (T 300,
# 4 query heads over 2 KV heads, causal with window 64 and sink 70), where
# dS = P (dP - delta) cancels to a small part of dP at nearly one-hot rows
# (ROADMAP C.5 for dk).  dq shares it: dq_i sums dS_ik K_k, and each dS_ik
# carries dP_ik's rounding, an absolute error of a few units in the last
# place of |dP| (~sqrt(d)), against an exact value that is a small part of
# it.  The same holds at the usual scale on the first query row, whose one
# live key makes dq zero in exact arithmetic but for delta's own rounding.


def exact_dq(q, k, v, g, lse, delta, opts):
    """The plain dq in f64 from the same tensors, rounded to f32."""
    return A.backward_dq_plain(
        *(x.double() for x in (q, k, v, g, lse, delta)), **opts).float()


def plain_dq_ratio(d, scale):
    """(worst err/limit, relative Frobenius) of plain f32's dq against the
    exact result at large_logits(d, scale)."""
    x = large_logits(d, scale)
    plain = A.backward_dq_plain(*x[:6], **x[6])
    return tolerance_ratios(plain, exact_dq(*x), RTOL_F32)


def worst_row(got, ref):
    """The query row of got's worst element by the f32 rule against ref."""
    diff = (got - ref).abs()
    rms_row = ref.pow(2).mean(-1, keepdim=True).sqrt()
    limit = RTOL_F32 * (ref.abs() + rms_row + 0.05 * ref.pow(2).mean().sqrt())
    return int((diff / limit).amax(-1).amax((0, 1)).argmax())


@pytest.mark.parametrize("d", [256, 512])
def test_plain_f32_dq_leaves_the_f32_rule_at_large_logits(d):
    """ROADMAP C.5 for dq: at scale -1 plain f32's dq (one rounding a
    product) leaves the f32 rule against the exact result by some 4-5x,
    and the exact result fails the rule against plain f32, so an f32
    reference cannot judge dq there either.  At d ** -0.5 the whole holds
    and its worst element is on the first query row."""
    x = large_logits(d)
    plain = A.backward_dq_plain(*x[:6], **x[6])
    exact = exact_dq(*x)
    assert tolerance_ratios(plain, exact, RTOL_F32)[0] > 3.0
    assert tolerance_ratios(exact, plain, RTOL_F32)[0] > 3.0
    x = large_logits(d, d ** -0.5)
    plain = A.backward_dq_plain(*x[:6], **x[6])
    exact = exact_dq(*x)
    assert tolerance_ratios(plain, exact, RTOL_F32)[1] <= FRO_F32
    assert worst_row(plain, exact) == 0


@pytest.mark.parametrize("d", [256, 512, 1000])
def test_plan_holds_against_the_exact_result_at_large_logits(d):
    """At scale -1 the plan holds the f32 rule against the plain version
    in f64 with a wide margin, at head-dim class 256 and on the cluster at
    512 and 1000, because its heavy elements take dP - delta from the
    compensated dot product: without them its worst element leaves the
    rule (each mma's sum of dP rounded toward zero), closer to the exact
    result than plain f32 all the same; one TF32 pass is far outside."""
    x = large_logits(d)
    exact = exact_dq(*x)
    plain = A.backward_dq_plain(*x[:6], **x[6])
    opts = x[6]
    args = (opts["scale"], opts["causal"], opts["window"], opts["sink"])
    (worst, rel), ok = held(plan_from(*x[:6], *args), exact)
    assert ok and worst < 0.5, (worst, rel)
    (worst, rel), _ = held(plan_from(*x[:6], *args, refine=False), exact)
    assert rel <= FRO_F32 and 1.0 < worst < 0.5 * tolerance_ratios(
        plain, exact, RTOL_F32)[0], (worst, rel)
    assert held(plan_from(*x[:6], *args, passes=1), exact)[0][0] > 100


def test_the_refinement_bound_is_the_kernels():
    """REFINE is csrc's TF32_REFINE, and at the usual scale the plan's
    first query row (one live key) holds the f32 rule against the exact
    result too, where plain f32's is the tensor's worst."""
    src = _build.SOURCE.read_text()
    assert f"constexpr float TF32_REFINE = {REFINE}f;" in src
    x = large_logits(512, 512 ** -0.5)
    exact = exact_dq(*x)
    opts = x[6]
    args = (opts["scale"], opts["causal"], opts["window"], opts["sink"])
    (worst, rel), ok = held(plan_from(*x[:6], *args), exact)
    assert ok and worst < 0.5, (worst, rel)


# ---------------------------------------------------------------------------
# the grid and the shared memory


# the kernel's own decode of blockIdx.x (slice_tile), which dq_block models
KERNEL_DECODE = "return {x / n, n - 1 - x % n, (int)blockIdx.x % ns};"


def dq_block(x, t, ns):
    """dq_tf32_kernel's block x -> (b*h, row tile, slice)."""
    n = -(-t // ROWS)
    y = x // ns
    return y // n, n - 1 - y % n, x % ns


@pytest.mark.parametrize("bh,t,ld", [
    (96, 2048, 64), (32, 2048, 256), (16, 2048, 512), (4, 300, 304),
    (2, 130, 2048), (3, 100, 1000), (2, 100, 2112), (1, 64, 8)])
def test_the_grid_covers_every_row_tile_and_column_once(bh, t, ld):
    """Every (b*h, 64-row tile, column slice) is one block; a cluster is
    ns consecutive blocks of one row tile, slices in order; each b*h's row
    tiles run from the last (the longest causal walk) down; each element
    of dq is written by one block, the two warpgroups taking the halves of
    its columns."""
    src = _build.SOURCE.read_text()
    assert src.count(KERNEL_DECODE) == 1
    kernel = src[src.index("dq_tf32_kernel(const"):]
    assert "const SliceTile tile = slice_tile(BM, T, ns);" in kernel
    ns = A.n_slices(ld) if ld > A.SLICE else 1
    n = -(-t // ROWS)
    blocks = [dq_block(x, t, ns) for x in range(bh * n * ns)]
    assert len(set(blocks)) == len(blocks) == bh * n * ns
    for x in range(0, len(blocks), ns):
        assert len({b[:2] for b in blocks[x:x + ns]}) == 1
        assert [b[2] for b in blocks[x:x + ns]] == list(range(ns))
    for b in range(bh):
        tiles = [blk[1] for blk in blocks if blk[0] == b and blk[2] == 0]
        assert tiles == list(range(n - 1, -1, -1))
    width = A.SLICE if ns > 1 else A.head_class(ld)
    nt = width // 16  # a warpgroup's m16n8 tiles
    written = {}
    for b, tile, sl in blocks:
        c0 = sl * width
        for wg in (0, 1):
            for j in range(nt):
                for t4 in range(4):
                    c = c0 + 8 * (wg * nt + j) + 2 * t4
                    if c < ld:
                        for col in (c, c + 1):
                            written[(b, tile, col)] = written.get(
                                (b, tile, col), 0) + 1
    assert set(written.values()) == {1}
    assert len(written) == bh * n * ld


def smem_plan(cols, clustered, streamed=False):
    """DqTf32Smem in Python: (key step, blocks an SM, stages, bytes, the
    budget a block may take)."""
    bm, bk = ROWS, 16 if cols == 256 else 32
    blocks = 2 if cols == 64 else 1
    budget = 232448 if blocks == 1 else 115712
    qd, stage = bm * cols * 4, (1 if streamed else 2) * bk * cols * 4
    x = 2 * 2 * bm * bk * 4 if clustered else 0
    chunks = 2 * (2 * bm + 2 * bk) * 128 if streamed else 0
    ring = (0 if streamed else 2 * qd) + bm * bk * 4 + x + chunks
    stages = min(3, (budget - ring - 1024 - 64) // stage)
    nbytes = ring + stages * stage + 8 * (stages + 1) + 1024
    return bk, blocks, stages, nbytes, budget


@pytest.mark.parametrize("cols,clustered,streamed", [
    (64, False, False), (128, False, False), (256, False, False),
    (256, True, False), (256, False, True)])
def test_the_shared_memory_plan_fits(cols, clustered, streamed):
    """Q and dO of the block's columns (streamed: two buffers of a
    32-column chunk of Q, dO, K and V instead, the ring holding K alone),
    P / dS, the cluster's two partial buffers and at least two stages of K
    and V fit a block's share of the SM (227 KB alone, half at two blocks
    an SM); the key step is attention.F32_DQ's; the source sizes the plan
    by the same rule."""
    bk, blocks, stages, nbytes, budget = smem_plan(cols, clustered, streamed)
    assert stages >= 2 and nbytes <= budget <= 232448
    route = A.CLUSTER if clustered else A.SLICED if streamed else cols
    assert A.F32_DQ[route] == (ROWS, bk)
    src = _build.SOURCE.read_text()
    struct = src[src.index("struct DqTf32Smem"):]
    struct = struct[:struct.index("};")]
    for line in ("BM = 64, BK = SW == 256 ? 16 : 32;",
                 "BLOCKS = SW == 64 ? 2 : 1;",
                 "QD_BYTES = STREAM ? 0 : BM * SW * 4;",
                 "STAGE_BYTES = (STREAM ? 1 : 2) * KT_BYTES;",
                 "X_BYTES = CL ? 2 * 2 * BM * BK * 4 : 0;",
                 "CHUNK_BYTES = (2 * BM + 2 * BK) * 128;",
                 "C_BYTES = STREAM ? 2 * CHUNK_BYTES : 0;"):
        assert line in struct, line
    # two blocks an SM at 64 columns: 256 threads each, at most 128
    # registers a thread
    assert blocks * 256 * 128 <= 65536


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [8, 64, 100, 128, 200, 256, 257, 300, 512,
                               1024, 2048, 2049, 2112, 4096])
def test_the_route_and_tiles_go_by_dtype_and_head_dim(d, dtype):
    """f32 dq takes the tensor-core kernel at every head dim (its cluster
    above 256 up to TF32_LD, its streamed slices above), whatever the
    blocks; bf16 and fp16 keep their routes and tiles; every tile resolved
    is built, and the cluster's shared memory and occupancy are asked of
    it only on its route."""
    ld = d + -d % 8
    route = A.route("dq", ld, dtype)
    if dtype == torch.float32:
        want = (A.CLUSTER if A.SLICE < ld <= A.TF32_LD
                else A.head_class(ld))
        assert route == want
        for bq, bk in ((8, 64), (128, 128), (1024, 1024)):
            for t in (None, 100, 2048):
                tiles = A.resolve_tiles(bq, bk, ld, dtype, t)
                assert tiles.dq == A.F32_DQ[want]
                assert tiles.fwd == A.F32_TILE
    else:
        assert route == (A.CLUSTER if A.cluster_route(ld, dtype)
                         else A.head_class(ld))
    tiles = A.launch_tiles(128, 128, ld, dtype, 2048)
    name = str(dtype).removeprefix("torch.")
    assert ("dq", name, route, *tiles.dq) in A.instantiations()
    if route != A.CLUSTER:
        with pytest.raises(ValueError, match="no cluster kernel"):
            A.cluster_info("dq", dtype, ld)


def test_the_reach_and_the_dispatcher():
    """One bound chooses the route: ops/attention.TF32_LD is csrc's
    TF32_REACH, by which the C interface sends f32 dq to the streamed
    slices above it and to the cluster above 256; no SIMT dq is left."""
    src = _build.SOURCE.read_text()
    reach = int(re.search(r"constexpr int TF32_REACH = (\d+);",
                          src).group(1))
    assert reach == A.TF32_LD
    assert "head_dim > TF32_REACH ? fa::dq_tf32_stream" in src
    assert "head_dim > SLICE    ? fa::dq_tf32_cluster" in src
    assert "dq_f32_kernel" not in src and "dq_sliced_f32_kernel" not in src
    assert {key for kernel, dtype, key, *_ in A.instantiations()
            if (kernel, dtype) == ("dq", "float32")} == set(A.F32_DQ)
