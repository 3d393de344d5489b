"""f32 dk/dv on the tensor cores, held on the CPU.

In f32 dk/dv runs on `dkv_tf32_kernel` (csrc/flash_attention.cu, with the
three-pass TF32 products of csrc/tf32.cuh) at every head dim: every
product is mma.sync m16n8k8 in three TF32 passes (each operand split into
hi = tf32(x) and lo = tf32(x - hi); lo hi and hi lo added before hi hi),
each short chain of products (one 32-column block of a contraction, one
query step of a second product) summed on its own and promoted into the
long f32 sum, a contraction's blocks (and the cluster's partials) by
Kahan's compensated sum; above head dim 256
the blocks of a key tile's 256-column slices form a cluster whose partial
S^T and dP^T are summed in slice order (above TF32_LD each slice's block
contracts the whole head dim itself); at head-dim class 256 the query
heads may be split over blocks whose f32 partials `dkv_reduce` sums in
split order.  The kernel runs on the card only; here:
  * that plan in plain torch, TF32 rounding emulated on the float's bits
    as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero), against
    the Pallas dk/dv kernel in interpret mode in f32 by the f32 rule
    (chip_smoke.RTOL_F32, FRO_F32) at head dims 64, 128, 256 (split), 300,
    512, 1024 and 2048 (the cluster's reach) and 2112 beyond it (each
    slice's block contracting the whole head dim), with GQA and MQA,
    causal, window + sink and a ragged T;
  * the plan with one TF32 pass (the planted fault) leaves the rule;
  * the grid (every key tile, column slice and split once, clusters whole,
    the longest walks first), the query-head splits, the shared-memory
    plan against 227 KB, and the route by dtype and head dim.
"""
import math
import re

import numpy as np
import pytest
import torch

from chip_smoke import FRO_F32, RTOL_F32, tolerance_ratios
from tf_operator_tpu.ops.attention import flash_attention_grads_interpret
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import attention as A

from test_torch_attention import inputs

torch.set_num_threads(1)

ROWS = 64  # keys a block
SMS = 132  # the H100's SMs, for the splits the host chooses

# (t, d, h, kv_h, causal, window, sink, block_q, block_k) for the Pallas
# kernels in interpret mode
CASES = {
    "d64_gqa_ragged": (200, 64, 4, 2, True, None, 0, 64, 64),
    "d128_mqa_window_sink": (192, 128, 4, 1, True, 48, 5, 64, 64),
    "d256_mqa_split": (256, 256, 6, 1, True, None, 0, 64, 64),
    "d300_gqa_noncausal": (80, 300, 4, 2, False, None, 0, 64, 64),
    "d512_window_sink_ragged": (130, 512, 2, 1, True, 40, 5, 64, 64),
    "d1024_causal": (64, 1024, 2, 1, True, None, 0, 64, 64),
    "d2048_reach": (64, 2048, 2, 1, True, None, 0, 64, 64),
    "d2112_beyond": (64, 2112, 2, 1, True, None, 0, 64, 64),
    # the scale negated (-d ** -0.5) at the cluster and beyond its reach
    "d1024_scale_neg": (64, 1024, 2, 1, True, None, 0, 64, 64),
    "d2112_scale_neg": (64, 2112, 2, 1, True, None, 0, 64, 64),
}


def case_scale(name):
    """The case's scale: d ** -0.5, negated for the _scale_neg cases."""
    return (-1 if name.endswith("_scale_neg") else 1) * CASES[name][1] ** -0.5


# ---------------------------------------------------------------------------
# the plan in plain torch


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: the low 13 of the
    23 mantissa bits dropped, to nearest, ties away from zero (half of the
    dropped range added to the magnitude, which the sign bit leaves
    apart)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def toward_zero(x):
    """f64 x rounded to f32 toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma3(a, b, passes=3, chains=True):
    """a @ b as the kernel's products sum it: the contraction in steps of 8
    (one mma.sync m16n8k8 each), each step's 8 products (exact) added to
    its f32 accumulator with one rounding, toward zero (the tensor cores'
    rounding as this model takes it: it reproduces the card's errors at
    large logits, PERF.md); in three TF32 passes, lo hi and hi lo before
    hi hi, in three sums of their own added (lh + hl) + hh at the end
    (`chains`, above 64 columns a block) or in one (one pass: hi hi
    alone)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    sums = [torch.zeros(a.shape[0], b.shape[1]) for _ in terms]
    for k0 in range(0, a.shape[1], 8):
        for i, (x, y) in enumerate(terms):
            j = i if chains else 0
            sums[j] = toward_zero(sums[j].double() + x[:, k0:k0 + 8].double()
                                  @ y[k0:k0 + 8].double())
    if passes == 1 or not chains:
        return sums[0]
    return (sums[0] + sums[1]) + sums[2]


def dkv_step_tile(d):
    """(columns a block takes, query step): attention.F32_DKV's tile."""
    route = A.route("dkv", d, torch.float32)
    cols = A.SLICE if route in (A.CLUSTER, A.SLICED) else route
    return cols, A.F32_DKV[route][1]


def kahan(total, comp, x):
    """total + x by Kahan's compensated sum in f32 (tf32::kahan): the new
    (total, comp), whose sum is total - comp."""
    y = x - comp
    s = total + y
    return s, (s - total) - y


def compensated(parts):
    """The parts summed in order by the compensated sum, folded."""
    total = comp = torch.zeros_like(parts[0])
    for x in parts:
        total, comp = kahan(total, comp, x)
    return total - comp


def contract(a, b, cols, passes, chains):
    """a[:, cols] @ b[:, cols]^T over one block's columns: each 32-column
    block's products summed on their own, then added in order, by the
    compensated sum above 64 columns a block (`chains`)."""
    parts = [mma3(a[:, c0:min(c0 + 32, cols.stop)],
                  b[:, c0:min(c0 + 32, cols.stop)].T, passes, chains)
             for c0 in range(cols.start, cols.stop, 32)]
    return compensated(parts) if chains else sum(parts[1:], parts[0])


def plan_dkv(qs, k, v, dos, lses, deltas, scale, keep, splits=1, passes=3):
    """(dk, dv) of one KV head as dkv_tf32_kernel computes them: for each
    column slice (the block's columns; one at the head-dim classes), per
    query head of each split and per query step in order, S^T and dP^T
    from each slice's contraction summed in slice order by the compensated
    sum (above TF32_LD,
    where each slice's block contracts the whole head dim, from one
    contraction over every column), P^T and dS^T, and the slice's dV +=
    P^T dO and dK += dS^T Q, each step's products summed on their own and
    added in f32; with more than one split, the splits' f32 partials
    summed in split order, dk scaled after."""
    t, d = k.shape
    ld = d + -d % 8
    pad = [torch.nn.functional.pad(x, (0, ld - d)) for x in (k, v)]
    k, v = pad
    qs = [torch.nn.functional.pad(x, (0, ld - d)) for x in qs]
    dos = [torch.nn.functional.pad(x, (0, ld - d)) for x in dos]
    width, bq = dkv_step_tile(ld)
    slices = [slice(c0, min(c0 + width, ld)) for c0 in range(0, ld, width)]
    streamed = A.route("dkv", ld, torch.float32) == A.SLICED
    partials = [slice(0, ld)] if streamed else slices
    chains = width > 64  # two blocks an SM at 64 columns: one sum
    group = len(qs)
    parts = []
    for sp in range(splits):
        heads = range(sp * group // splits, (sp + 1) * group // splits)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for h in heads:
            q, do, lse, delta = qs[h], dos[h], lses[h], deltas[h]
            for q0 in range(0, t, bq):
                rows = slice(q0, min(q0 + bq, t))
                # the cluster's partials, summed in slice order
                st = compensated([contract(k, q[rows], cols, passes, chains)
                                  for cols in partials])
                dpt = compensated([contract(v, do[rows], cols, passes,
                                            chains) for cols in partials])
                pt = torch.where(keep[rows, :].T,
                                 torch.exp(st * scale - lse[None, rows]), 0.0)
                dst = pt * (dpt - delta[None, rows])
                for cols in slices:
                    dv[:, cols] = dv[:, cols] + mma3(pt, do[rows, cols],
                                                     passes, chains)
                    dk[:, cols] = dk[:, cols] + mma3(dst, q[rows, cols],
                                                     passes, chains)
        parts.append((dk, dv))
    if splits == 1:
        dk, dv = parts[0][0] * scale, parts[0][1]
    else:
        ws = torch.stack([torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] for p in parts])])
        dk, dv = A.dkv_reduce_plain(ws, scale, torch.float32)
    return dk[:, :d], dv[:, :d]


def _live(t, causal, window, sink):
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    keep = torch.ones(t, t, dtype=torch.bool)
    if causal:
        keep = j <= i
        if window:
            keep = keep & ((i - j < window) | (j < sink))
    return keep


def plan_from(q, k, v, g, lse, delta, scale, causal, window, sink,
              passes=3):
    """(dk, dv) of the plan [1, kv_h, t, d] from f32 tensors, lse and delta
    given (the query heads split as the host splits them at class 256)."""
    t, d = q.shape[2], q.shape[3]
    h, kv_h = q.shape[1], k.shape[1]
    keep = _live(t, causal, window, sink)
    group = h // kv_h
    splits = (A.dkv_splits(kv_h, t, group, SMS)
              if A.head_class(d) == 256 else 1)
    out = [plan_dkv([q[0, x] for x in heads], k[0, kv], v[0, kv],
                    [g[0, x] for x in heads], [lse[0, x] for x in heads],
                    [delta[0, x] for x in heads], scale, keep, splits,
                    passes)
           for kv, heads in ((kv, range(kv * group, (kv + 1) * group))
                             for kv in range(kv_h))]
    return [torch.stack([x[i] for x in out])[None] for i in (0, 1)]


def plan_grads(name, passes=3):
    """(dk, dv) of the plan at a case, from the plain forward's lse and
    delta."""
    t, d, h, kv_h, causal, window, sink, _, _ = CASES[name]
    q, k, v, g = (torch.tensor(x) for x in
                  inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=53))
    scale = case_scale(name)
    o, lse = A.attention_lse(q, *A.repeat_kv(q, k, v), causal=causal,
                             scale=scale, window=window, sink=sink)
    delta = (g * o).sum(-1)
    return [x.numpy() for x in plan_from(q, k, v, g, lse, delta, scale,
                                         causal, window, sink, passes)]


@pytest.fixture(scope="module")
def pallas_dkv():
    """The Pallas kernels' (dk, dv) per case in interpret mode, in f32."""
    cache = {}

    def get(name):
        if name not in cache:
            t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
            q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=53)
            cache[name] = [np.asarray(x, np.float32) for x in
                           flash_attention_grads_interpret(
                               q, k, v, g, causal, case_scale(name),
                               bq, bk,
                               window=window, sink=sink)[2:]]
        return cache[name]

    return get


def held(got, want):
    """Each of (dk, dv) within the f32 rule: (worst err/limit, relative
    Frobenius) and whether both hold."""
    ratios = [tolerance_ratios(torch.tensor(np.asarray(a)),
                               torch.tensor(np.asarray(b)), RTOL_F32)
              for a, b in zip(got, want)]
    return ratios, all(w <= 1.0 and rel <= FRO_F32 for w, rel in ratios)


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_pallas_interpret_by_the_f32_rule(name, pallas_dkv):
    """The plan (three TF32 passes, short sums promoted in f32, the
    cluster's partials in slice order, the splits' partials reduced in
    order) against the Pallas dk/dv kernel in interpret mode in f32, by
    the f32 rule, at every route: the classes 64, 128 and 256 (its query
    heads split), the cluster at 2 to 8 slices, and beyond its reach; at
    the cluster and beyond it also with the scale negated."""
    ratios, ok = held(plan_grads(name), pallas_dkv(name))
    assert ok, ratios


@pytest.mark.parametrize("name", ["d64_gqa_ragged", "d256_mqa_split",
                                  "d512_window_sink_ragged"])
def test_one_tf32_pass_leaves_the_f32_rule(name, pallas_dkv):
    """The planted fault: every product in one TF32 pass (the operands
    rounded to 10-bit mantissas) leaves the f32 rule by a wide margin, so
    the rule can see TF32."""
    ratios, ok = held(plan_grads(name, passes=1), pallas_dkv(name))
    assert not ok
    assert max(rel for _, rel in ratios) > 10 * FRO_F32, ratios


# ---------------------------------------------------------------------------
# large logits: scale -1, logits of standard deviation sqrt(d) (22.6 at d
# 512), at the card's test of the sliced kernels
# (test_torch_kernels_cuda.test_sliced_kernels_match_plain_versions: T 300,
# 4 query heads over 2 KV heads, causal with window 64 and sink 70, its
# inputs).  There the rows' softmax is nearly one-hot, dS = P (dP - delta)
# cancels to a small part of dP, and the rounding of dP's f32 sum over the
# head dim dominates dk: plain f32 (one FMA a product, in order) leaves
# the f32 rule against the exact result, so an f32 reference cannot judge
# a kernel that sums in another order, and f32 dk/dv is held against the
# plain version in f64 (the card's tests do so).


def large_logits(d, scale=-1.0):
    """(q, k, v, g, lse, delta, opts) of that case in f32, lse and delta
    from the plain forward."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.tensor(rng.randn(1, n, 300, d).astype(np.float32))
                  for n in (4, 2, 2, 4))
    opts = dict(scale=scale, causal=True, window=64, sink=70)
    o, lse = A.attention_lse(q, *A.repeat_kv(q, k, v), **opts)
    return q, k, v, g, lse, (g * o).sum(-1), opts


def exact_dkv(q, k, v, g, lse, delta, opts):
    """The plain dk/dv in f64 from the same tensors, rounded to f32."""
    return [x.float() for x in A.backward_dkv_plain(
        *(x.double() for x in (q, k, v, g, lse, delta)), **opts)]


@pytest.mark.parametrize("d", [256, 512])
def test_plain_f32_leaves_the_f32_rule_at_large_logits(d):
    """At scale -1 plain f32 dk leaves the f32 rule against the exact
    result by about 2x, and the exact result fails the rule against plain
    f32: only f32's own order of sums passes a check against plain f32
    there.  At d ** -0.5 both hold with a wide margin."""
    x = large_logits(d)
    plain = A.backward_dkv_plain(*x[:6], **x[6])
    exact = exact_dkv(*x)
    assert tolerance_ratios(plain[0], exact[0], RTOL_F32)[0] > 1.5
    assert tolerance_ratios(exact[0], plain[0], RTOL_F32)[0] > 1.5
    x = large_logits(d, d ** -0.5)
    plain = A.backward_dkv_plain(*x[:6], **x[6])
    ratios, ok = held(plain, exact_dkv(*x))
    assert ok and max(w for w, _ in ratios) < 0.1, ratios


@pytest.mark.parametrize("d", [256, 512])
def test_plan_holds_against_the_exact_result_at_large_logits(d):
    """At scale -1 the plan (the contraction's blocks and the cluster's
    partials added by the compensated sum) holds the f32 rule against the
    plain version in f64, at head-dim class 256 (its query heads split)
    and on the cluster at 512; one TF32 pass leaves it."""
    x = large_logits(d)
    exact = exact_dkv(*x)
    opts = x[6]
    args = (opts["scale"], opts["causal"], opts["window"], opts["sink"])
    ratios, ok = held(plan_from(*x[:6], *args), exact)
    assert ok, ratios
    assert not held(plan_from(*x[:6], *args, passes=1), exact)[1]


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2.0 ** -11,
                               -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11,
                               1.0 + 2.0 ** -12, 3.0e-30, 1.7e38])
def test_tf32_rounds_as_cvt_rna(x):
    """The emulation rounds to a 10-bit mantissa, to nearest with ties
    away from zero (1 + 2^-11 is a tie: up to 1 + 2^-10; 1 + 3 * 2^-11
    rounds to 1 + 2^-9; 1 + 2^-12 down to 1), and the split's halves sum
    back to x within f32's last bits."""
    v = torch.tensor([x], dtype=torch.float32)
    hi = tf32(v)
    want = {1.0 + 2.0 ** -11: 1.0 + 2.0 ** -10,
            -(1.0 + 2.0 ** -11): -(1.0 + 2.0 ** -10),
            1.0 + 3 * 2.0 ** -11: 1.0 + 2.0 ** -9,
            1.0 + 2.0 ** -12: 1.0}.get(x)
    if want is not None:
        assert float(hi) == want
    assert int(hi.view(torch.int32)) & 0x1FFF == 0
    lo = tf32(v - hi)
    assert abs(float(hi + lo) - x) <= abs(x) * 2.0 ** -21


# ---------------------------------------------------------------------------
# the grid, the splits and the shared memory


# the kernel's own decode of blockIdx.x, which dkv_block models
KERNEL_DECODE = ("const int slice = x % ns, sp = x / ns % splits, "
                 "rest = x / ns / splits;")


def dkv_block(x, n_blocks, t, splits, ns):
    """dkv_tf32_kernel's block x -> (key tile, b*kv_head, split, slice)."""
    n_kt = -(-t // ROWS)
    bkv_n = n_blocks // (n_kt * splits * ns)
    slice_, sp, rest = x % ns, x // ns % splits, x // ns // splits
    return rest // bkv_n, rest % bkv_n, sp, slice_


@pytest.mark.parametrize("bkv,t,ld,heads,kv_heads", [
    (96, 2048, 64, 12, 12), (4, 2048, 256, 8, 1), (1, 2048, 256, 6, 1),
    (4, 2048, 512, 4, 1), (2, 300, 304, 4, 2), (1, 130, 2048, 2, 1),
    (3, 100, 1000, 6, 3), (2, 100, 2112, 2, 1)])
def test_the_grid_covers_every_key_tile_column_and_head_once(
        bkv, t, ld, heads, kv_heads):
    """Every (b*kv_head, 64-key tile, column slice, query-head split) is
    one block; a cluster is ns consecutive blocks of one key tile; key
    tiles go slowest, so the longest causal walks start first; each
    output element is written by one block a split, and the splits take
    each query head of a group once."""
    src = _build.SOURCE.read_text()
    assert src.count(KERNEL_DECODE) == 1
    assert "const int bkv = rest % bkv_n, k0 = rest / bkv_n * BM;" in src
    ns = A.n_slices(ld) if ld > A.SLICE else 1
    splits = (A.dkv_splits(bkv, t, heads // kv_heads, SMS)
              if A.head_class(ld) == 256 else 1)
    n_kt = -(-t // ROWS)
    n = bkv * n_kt * splits * ns
    blocks = [dkv_block(x, n, t, splits, ns) for x in range(n)]
    assert len(set(blocks)) == n
    assert {b[:3] for b in blocks} == {(kt, b, s) for kt in range(n_kt)
                                       for b in range(bkv)
                                       for s in range(splits)}
    assert [b[0] for b in blocks] == sorted(b[0] for b in blocks)
    for x in range(0, n, ns):
        assert len({b[:3] for b in blocks[x:x + ns]}) == 1
        assert [b[3] for b in blocks[x:x + ns]] == list(range(ns))
    written = {}
    for kt, b, sp, sl in blocks:
        for key in range(kt * ROWS, min(kt * ROWS + ROWS, t)):
            c0 = sl * (A.SLICE if ns > 1 else ld)
            for col in range(c0, min(c0 + (A.SLICE if ns > 1 else ld), ld),
                             8):
                written[(b, key, col, sp)] = written.get(
                    (b, key, col, sp), 0) + 1
    assert set(written.values()) == {1}
    assert len(written) == bkv * t * (ld // 8) * splits
    group = heads // kv_heads
    taken = [h for sp in range(splits)
             for h in range(sp * group // splits, (sp + 1) * group // splits)]
    assert taken == list(range(group))


def smem_plan(cols, clustered, streamed=False):
    """DkvTf32Smem in Python: (query step, blocks an SM, stages, bytes, the
    budget a block may take)."""
    bm, bq = ROWS, 16 if cols == 256 else 32
    blocks = 2 if cols == 64 else 1
    budget = 232448 if blocks == 1 else 115712
    kv, stage, p = bm * cols * 4, 2 * bq * cols * 4, bm * bq * 4
    x = 2 * 2 * bm * bq * 4 if clustered else 0
    chunks = 2 * (2 * bm + 2 * bq) * 128 if streamed else 0
    ring = (0 if streamed else 2 * kv) + p + x + chunks
    stages = min(3, (budget - ring - 1024 - 64) // stage)
    return bq, blocks, stages, ring + stages * stage + 8 * (stages + 1) + 1024, \
        budget


@pytest.mark.parametrize("cols,clustered,streamed", [
    (64, False, False), (128, False, False), (256, False, False),
    (256, True, False), (256, False, True)])
def test_the_shared_memory_plan_fits(cols, clustered, streamed):
    """K and V of the block's columns (streamed: two buffers of a
    32-column chunk of K, V, Q and dO instead), P^T, the cluster's two
    partial buffers and at least two stages of Q and dO fit a block's
    share of the SM (227 KB alone, half at two blocks an SM); the query
    step is attention.F32_DKV's; the source sizes the plan by the same
    rule."""
    bq, blocks, stages, nbytes, budget = smem_plan(cols, clustered, streamed)
    assert stages >= 2 and nbytes <= budget <= 232448
    route = A.CLUSTER if clustered else A.SLICED if streamed else cols
    assert A.F32_DKV[route] == (ROWS, bq)
    src = _build.SOURCE.read_text()
    struct = src[src.index("struct DkvTf32Smem"):]
    struct = struct[:struct.index("};")]
    assert "BM = 64, BQ = SW == 256 ? 16 : 32;" in struct
    assert "BLOCKS = SW == 64 ? 2 : 1;" in struct
    assert "X_BYTES = CL ? 2 * 2 * BM * BQ * 4 : 0;" in struct
    assert "KV_BYTES = STREAM ? 0 : BM * SW * 4;" in struct
    assert "CHUNK_BYTES = (2 * BM + 2 * BQ) * 128;" in struct
    assert "C_BYTES = STREAM ? 2 * CHUNK_BYTES : 0;" in struct
    # two blocks an SM at 64 columns: 256 threads each, at most 128
    # registers a thread
    assert blocks * 256 * 128 <= 65536


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [8, 64, 100, 128, 200, 256, 257, 300, 512,
                               1024, 2048, 2049, 2112, 4096])
def test_the_route_goes_by_dtype_and_head_dim(d, dtype):
    """f32 dk/dv takes the tensor-core kernel at every head dim (its
    cluster above 256 up to TF32_LD, its streamed slices above), and so
    does f32 dq (the same routes, its tiles F32_DQ's); bf16 and fp16 keep
    their routes; the forward keeps its; every tile resolved is built."""
    on = dtype == torch.float32 and d <= A.TF32_LD
    ld = d + -d % 8
    tiles = A.launch_tiles(128, 128, ld, dtype, 2048)
    route = A.route("dkv", ld, dtype)
    if dtype == torch.float32:
        want = (A.CLUSTER if on and ld > A.SLICE else A.head_class(ld))
        assert route == want == A.route("dq", ld, dtype)
        assert tiles.dkv == A.F32_DKV[want]
        assert tiles.dq == A.F32_DQ[want]
        assert tiles.fwd == A.F32_TILE
    else:
        assert route == (A.CLUSTER if A.cluster_route(ld, dtype)
                         else A.head_class(ld))
    name = str(dtype).removeprefix("torch.")
    for kernel in ("fwd", "dq", "dkv"):
        assert (kernel, name, A.route(kernel, ld, dtype),
                *getattr(tiles, kernel)) in A.instantiations()


def test_the_reach_is_the_dispatchers():
    """One bound chooses the route: ops/attention.TF32_LD is csrc's
    TF32_REACH, which the C interface sends f32 dk/dv above 256 by, eight
    slices of 256 (a portable cluster's most blocks)."""
    src = _build.SOURCE.read_text()
    reach = int(re.search(r"constexpr int TF32_REACH = (\d+);",
                          src).group(1))
    assert reach == A.TF32_LD == 8 * A.SLICE
    assert ("dtype == FA_F32 && head_dim > SLICE && head_dim <= TF32_REACH"
            in src)
    assert math.ceil(reach / A.SLICE) <= 8
