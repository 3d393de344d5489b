"""The port above head dim 256: the flash-attention plumbing against the
Pallas kernels, the sliced kernels' plan modelled in plain torch, and the
llama-style LM at head_dim 512 against the JAX package's.

Above head dim 256 the wrappers launch the sliced kernels
(`ops/attention.py:SLICED`, `csrc/flash_attention.cu`: each block one
256-column slice of its outputs, the head dim streamed through shared
memory in 64-column chunks), on the card only; on CPU tensors each wrapper
computes its kernel's plain version, so these hold what surrounds the
kernels at head dims 264, 300 (padded to 304 on the card), 384, 512 and
1024 against `flash_attention_grads_interpret` and
`flash_attention_lse_grads_interpret` (the Pallas kernels in interpret
mode, which take any head dim).  tests/test_torch_kernels_cuda.py holds
the kernels themselves against the plain versions on the card.

Tolerances: those of tests/test_torch_attention.py (f32: 2e-5 on outputs
and lse, 1e-4 on gradients; fp16 5e-3), and for the model those of
tests/test_torch_transformer.py and tests/test_torch_train.py (logits
1e-5; losses, gradients and parameters 5e-5, PERF.md section 2's LM rule):
both sides sum the same products in another order.  The plan's model is
held to the plain versions at 1e-5 (f32 on both sides, sums in another
order).
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as J
from tf_operator_tpu.ops.attention import (
    flash_attention_grads_interpret,
    flash_attention_lse_grads_interpret,
)
from tf_operator_tpu.train import optim as joptim
from tf_operator_tpu.train.state import create_train_state as j_create
from tf_operator_tpu.train.step import lm_loss_fn as j_loss_fn
from tf_operator_tpu.train.step import make_train_step as j_make_step
from tf_operator_tpu_torch.models import transformer as T
from tf_operator_tpu_torch.models.convert import (
    params_from_flax,
    params_to_flax,
)
from tf_operator_tpu_torch.ops import attention as A
from tf_operator_tpu_torch.train import optim as toptim
from tf_operator_tpu_torch.train.state import create_train_state
from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step

from test_torch_attention import (
    ATOL_F16,
    ATOL_GRAD,
    ATOL_OUT,
    assert_matches,
    inputs,
    port_grads,
)

torch.set_num_threads(1)

# (t, d, h, kv_h, causal, window, sink, block_q, block_k): head dims with
# a last slice of one 64-column block (264), of a padded one (300 -> 304),
# of two blocks (384), two whole slices (512) and four (1024); causal and
# not, GQA (4 over 1 and 2), window + sink, ragged T, all at small T
CASES = {
    "d264_causal": (96, 264, 2, 2, True, None, 0, 64, 64),
    "d300_noncausal_gqa": (80, 300, 4, 2, False, None, 0, 64, 64),
    "d384_window_sink": (128, 384, 2, 1, True, 40, 5, 64, 64),
    "d512_gqa4_ragged": (100, 512, 4, 1, True, None, 0, 128, 128),
    "d1024_causal": (64, 1024, 2, 1, True, None, 0, 64, 64),
}


@pytest.fixture(scope="module")
def interpret_results():
    """The Pallas kernels' (out, dq, dk, dv) per case, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
            q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=31)
            cache[name] = [np.asarray(x) for x in
                           flash_attention_grads_interpret(
                               q, k, v, g, causal, None, bq, bk,
                               window=window, sink=sink)]
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_pallas_interpret(name, interpret_results):
    """The public entry on CPU tensors (plain version under autograd)."""
    t, d, h, kv_h, causal, window, sink, _, _ = CASES[name]
    q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=31)
    got = port_grads(q, k, v, g, lambda q, k, v: A.flash_attention(
        q, k, v, causal, window=window, sink=sink))
    assert_matches(got, interpret_results(name))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_autograd_function_matches_pallas_interpret(
        name, interpret_results):
    """FlashAttentionFn, whose wrappers compute the sliced kernels' plain
    versions on CPU tensors, at head dims above 256."""
    t, d, h, kv_h, causal, window, sink, bq, bk = CASES[name]
    q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=31)
    before = A.launches(), A.sliced_launches()
    got = port_grads(q, k, v, g, lambda q, k, v: A.FlashAttentionFn.apply(
        q, k, v, causal, d ** -0.5, bq, bk, A.check_window(causal, window),
        sink))
    assert_matches(got, interpret_results(name))
    # the plain path launches no kernel
    assert (A.launches(), A.sliced_launches()) == before


@pytest.mark.parametrize("entry", ["public", "autograd_function"])
def test_flash_attention_lse_matches_pallas_interpret(entry):
    """(o, lse) at head_dim 512, 4 query heads over one KV head, causal,
    with cotangents on both outputs: out and lse within 2e-5, gradients
    1e-4 of the Pallas kernels in interpret mode; the autograd function's
    backward hands the kernels delta' = rowsum(dO * O) - dlse."""
    t, d, h = 72, 512, 4
    q, k, v, g = inputs(t, d=d, b=1, h=h, kv_h=1, seed=33)
    g_lse = np.random.RandomState(34).randn(1, h, t).astype(np.float32)
    want = flash_attention_lse_grads_interpret(q, k, v, g, g_lse, True,
                                               None, 64, 64)
    if entry == "public":
        def fn(q, k, v):
            return A.flash_attention_lse(q, k, v, True)
    else:
        def fn(q, k, v):
            return A.FlashAttentionLseFn.apply(q, k, v, True, d ** -0.5,
                                               64, 64)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = fn(qt, kt, vt)
    torch.autograd.backward((out, lse), (torch.tensor(g), torch.tensor(g_lse)))
    got = [x.detach().numpy() for x in (out, lse, qt.grad, kt.grad, vt.grad)]
    for label, a, b, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                                (ATOL_OUT,) * 2 + (ATOL_GRAD,) * 3):
        assert a.shape == np.asarray(b).shape, label
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, err_msg=label)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32],
                         ids=["fp16", "f32"])
def test_fp16_and_f32_at_head_dim_512_match_pallas_interpret(dtype):
    """fp16 and f32 inputs at head_dim 512, causal, GQA 4:1, T 64: the
    dtypes kept through FlashAttentionFn's plumbing."""
    np_dtype = {torch.float16: np.float16, torch.float32: np.float32}[dtype]
    q, k, v, g = (x.astype(np_dtype) for x in
                  inputs(64, d=512, b=1, h=4, kv_h=1, seed=35))
    want = flash_attention_grads_interpret(
        *(jnp.asarray(x) for x in (q, k, v, g)), True, None, 64, 64)
    got = port_grads(q, k, v, g, lambda q, k, v: A.FlashAttentionFn.apply(
        q, k, v, True, 512 ** -0.5, 64, 64, None, 0))
    tol = ATOL_F16 if dtype == torch.float16 else ATOL_GRAD
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == np_dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a.astype(np.float32),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# host logic: the route, its tiles, its grid and its counters


@pytest.mark.parametrize("d", [257, 264, 300, 384, 512, 513, 1000, 1024,
                               2048, 4096])
def test_head_class_sends_every_head_dim_above_256_to_the_sliced_kernels(d):
    assert A.head_class(d) == A.SLICED
    assert A.n_slices(d) == -(-d // 256) >= 2


@pytest.mark.parametrize("d", [0, -1])
def test_head_class_raises_only_below_1(d):
    with pytest.raises(ValueError, match=r"head_dim >= 1"):
        A.head_class(d)


def test_resolve_tiles_maps_every_block_pair_onto_the_sliced_tiles():
    """Every (block_q, block_k) the env takes resolves above head dim 256
    to the sliced kernels' one tile in each dtype (f32: its own), dq's and
    dk/dv's in bf16 and fp16 up to CLUSTER_LD to the cluster kernels' one
    tile, f32 dq's and dk/dv's to their tensor-core kernels' (up to TF32_LD
    on their clusters), an instantiation attention.INSTANTIATED lists,
    whatever T."""
    built = A.instantiations()
    want = {torch.bfloat16: A.Tiles((128, 64), (128, 64), (64, 64)),
            torch.float16: A.Tiles((128, 64), (128, 64), (64, 64)),
            torch.float32: A.Tiles((64, 32), (64, 16), (64, 16))}
    for dtype, sliced in want.items():
        name = str(dtype).removeprefix("torch.")
        for d in (257, 304, 512, 4096):
            cluster = A.cluster_route(d, dtype)
            assert cluster == (dtype != torch.float32 and d <= 1024)
            tf32 = dtype == torch.float32 and d <= A.TF32_LD
            tiles_want = (sliced._replace(dq=(64, 64), dkv=(64, 64))
                          if cluster else sliced)
            for bq in range(8, 1025, 40):
                for bk in range(64, 1025, 64):
                    for t in (None, 100, 2048):
                        tiles = A.resolve_tiles(bq, bk, d, dtype, t)
                        assert tiles == tiles_want
                        for kernel in ("fwd", "dq", "dkv"):
                            route = (A.CLUSTER if (cluster or tf32)
                                     and kernel != "fwd" else A.SLICED)
                            assert route == A.route(kernel, d, dtype) or (
                                kernel == "fwd" and A.pair_route(d, dtype))
                            assert (kernel, name, route,
                                    *getattr(tiles, kernel)) in built
    assert not A.short_route(512, 100, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [257, 300, 512, 1024, 4096])
def test_check_cuda_takes_every_head_dim_above_256(dtype, d):
    """`_check_cuda` (shapes, dtypes and layouts only) takes head dims up
    to 4096 at GQA 4:1 (meta tensors: no memory)."""
    q = torch.empty(2, 4, 64, d, dtype=dtype, device="meta")
    kv = torch.empty(2, 1, 64, d, dtype=dtype, device="meta")
    rows = torch.empty(2, 4, 64, device="meta")
    A._check_cuda(q, kv, kv, q, rows, rows)


def test_check_cuda_counts_the_slices_in_the_grid():
    """The grid check counts one block per column slice above head dim
    256: a shape whose b*h x 64-row tiles fit 2^31 - 1 blocks but whose
    slices do not is refused with the grid's own message."""
    t = 64 * 2**20  # 2^20 row tiles of 64
    for d, heads, ok in ((256, 2047, True), (512, 1023, True),
                         (512, 1024, False), (1024, 511, True),
                         (1024, 512, False)):
        q = torch.empty(1, heads, t, d, dtype=torch.bfloat16, device="meta")
        if ok:
            A._check_cuda(q, q, q)
        else:
            with pytest.raises(ValueError, match="column slice"):
                A._check_cuda(q, q, q)


def test_padded_head_dims_above_256_stay_sliced():
    """A head dim that is not a multiple of 8 is zero-padded to the next
    one (300 -> 304, 257 -> 264) and the outputs sliced back; the slices
    of the stored head dim are those of the head dim."""
    for d, stored in ((300, 304), (257, 264), (1001, 1008)):
        (x,) = A._padded(torch.ones(1, 1, 2, d))
        assert x.shape[-1] == stored and A.head_class(stored) == A.SLICED
        assert A.n_slices(stored) == A.n_slices(d)
        assert float(x[..., d:].abs().sum()) == 0.0
        assert A._unpadded(x, d).shape[-1] == d


def test_sliced_launch_counters_reset_and_skip_the_plain_path():
    """`sliced_launches` has one counter per wrapper and
    `cluster_launches` one for dq and one for dk/dv, `reset_launches`
    zeroes them with the others, and the plain path (CPU tensors) counts
    nothing."""
    saved = {fn: (fn.launches, fn.short_launches, fn.sliced_launches)
             for fn in A.KERNELS}
    cluster = {fn: fn.cluster_launches for fn in A.CLUSTER_KERNELS}
    try:
        for fn in A.KERNELS:
            fn.sliced_launches = 7
        for fn in A.CLUSTER_KERNELS:
            fn.cluster_launches = 5
        A.reset_launches()
        assert A.sliced_launches() == {fn.__name__: 0 for fn in A.KERNELS}
        assert A.cluster_launches() == {fn.__name__: 0
                                        for fn in A.CLUSTER_KERNELS}
        q, k, v, g = (torch.tensor(x) for x in
                      inputs(16, d=300, b=1, h=2, kv_h=1, seed=1))
        opts = dict(scale=0.1, causal=True, window=None, sink=0)
        o, lse = A.flash_forward(q, k, v, **opts)
        delta = (g * o).sum(-1)
        A.flash_backward_dq(q, k, v, g, lse, delta, **opts)
        A.flash_backward_dkv(q, k, v, g, lse, delta, **opts)
        assert A.sliced_launches() == A.launches() == {
            fn.__name__: 0 for fn in A.KERNELS}
        assert not any(A.cluster_launches().values())
    finally:
        for fn, (n, short, sliced) in saved.items():
            fn.launches, fn.short_launches, fn.sliced_launches = (
                n, short, sliced)
        for fn, n in cluster.items():
            fn.cluster_launches = n


# ---------------------------------------------------------------------------
# the sliced kernels' plan, modelled in plain torch

CHUNK, SLICE_W, BK, BQ = 64, A.SLICE, 64, 64


def _chunked(a, b):
    """a @ b^T over the last dim, summed one 64-column chunk at a time in
    order (the kernels' S and dP)."""
    out = 0
    for c0 in range(0, a.shape[-1], CHUNK):
        out = out + a[..., c0:c0 + CHUNK] @ b[..., c0:c0 + CHUNK].T
    return out


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
    return [slice(c0, min(c0 + SLICE_W, d)) for c0 in range(0, d, SLICE_W)]


def sliced_forward(q, k, v, scale, causal, window, sink):
    """(o, lse) of one head (q [T, D], k/v [T, D]) as the sliced forward
    computes them: per column slice, an online softmax over 64-key steps
    whose scores sum the head dim's 64-column chunks in order, o's slice
    from that slice's V columns; lse from slice 0, and every slice's row
    max and sum the same bits."""
    t, d = q.shape
    keep = _live(t, causal, window, sink)
    o = torch.empty_like(q)
    stats = []
    for cols in _slices(d):
        m = torch.full((t,), -torch.inf)
        l = torch.zeros(t)
        acc = torch.zeros(t, cols.stop - cols.start)
        for k0 in range(0, t, BK):
            s = _chunked(q, k[k0:k0 + BK]) * scale
            s = s.masked_fill(~keep[:, k0:k0 + BK], -torch.inf)
            m_new = torch.maximum(m, s.max(-1).values)
            m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
            alpha = torch.exp(m - m_use)
            p = torch.exp(s - m_use[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ v[k0:k0 + BK, cols]
            m = m_new
        o[:, cols] = acc / torch.where(l > 0, l, 1.0)[:, None]
        stats.append((m, l))
    for m, l in stats[1:]:
        assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])
    m, l = stats[0]
    return o, torch.where(l > 0, m + torch.log(l), 0.0)


def _p_ds(q, k, v, do, lse, delta, scale, keep):
    """p and ds of a [queries x keys] block from chunked S and dP."""
    s = _chunked(q, k) * scale
    p = torch.where(keep, torch.exp(s - lse[:, None]), 0.0)
    return p, p * (_chunked(do, v) - delta[:, None])


def sliced_dq(q, k, v, do, lse, delta, scale, causal, window, sink):
    """dq of one head as the sliced dq computes it: per column slice, the
    sum over 64-key steps of dS (from chunked S and dP) times that slice's
    K columns."""
    t, d = q.shape
    keep = _live(t, causal, window, sink)
    dq = torch.empty_like(q)
    for cols in _slices(d):
        acc = 0
        for k0 in range(0, t, BK):
            _, ds = _p_ds(q, k[k0:k0 + BK], v[k0:k0 + BK], do, lse, delta,
                          scale, keep[:, k0:k0 + BK])
            acc = acc + ds @ k[k0:k0 + BK, cols]
        dq[:, cols] = acc * scale
    return dq


def sliced_dkv(qs, k, v, dos, lses, deltas, scale, causal, window, sink):
    """(dk, dv) of one KV head as the sliced dk/dv computes them: per
    column slice and 64-key tile, the walk over the group's query heads in
    order and each head's 64-query tiles, P^T and dS^T (from chunked S^T
    and dP^T) times that slice's dO and Q columns."""
    t, d = k.shape
    keep = _live(t, causal, window, sink)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for cols in _slices(d):
        for k0 in range(0, t, BK):
            keys = slice(k0, k0 + BK)
            dk_acc, dv_acc = 0, 0
            for q, do, lse, delta in zip(qs, dos, lses, deltas):
                for q0 in range(0, t, BQ):
                    rows = slice(q0, q0 + BQ)
                    p, ds = _p_ds(q[rows], k[keys], v[keys], do[rows],
                                  lse[rows], delta[rows], scale,
                                  keep[rows, keys])
                    dv_acc = dv_acc + p.T @ do[rows, cols]
                    dk_acc = dk_acc + ds.T @ q[rows, cols]
            dk[keys, cols] = dk_acc * scale
            dv[keys, cols] = dv_acc
    return dk, dv


@pytest.mark.parametrize("t,d,h,kv_h,causal,window,sink,scale", [
    (150, 300, 2, 1, True, None, 0, None),
    (130, 512, 4, 2, True, 40, 5, -0.0625),
    (70, 600, 2, 2, False, None, 0, None),
], ids=["d300_causal", "d512_window_sink_neg_scale", "d600_noncausal"])
def test_sliced_plan_matches_the_plain_versions(t, d, h, kv_h, causal,
                                                window, sink, scale):
    """The sliced kernels' plan (S and dP over 64-column chunks, outputs
    by 256-column slice, lse from slice 0, dk/dv walking the group) in f32
    against the plain versions the card holds the kernels to."""
    q, k, v, do = (torch.tensor(x, dtype=torch.float64).float() for x in
                   inputs(t, d=d, b=1, h=h, kv_h=kv_h, seed=37))
    scale = d ** -0.5 if scale is None else scale
    opts = dict(scale=scale, causal=causal, window=window, sink=sink)
    o_ref, lse_ref = A.attention_lse(q, *A.repeat_kv(q, k, v), **opts)
    delta = (do * o_ref).sum(-1)
    dq_ref = A.backward_dq_plain(q, k, v, do, lse_ref, delta, **opts)
    dk_ref, dv_ref = A.backward_dkv_plain(q, k, v, do, lse_ref, delta,
                                          **opts)
    group = h // kv_h
    args = (scale, causal, window, sink)
    for head in range(h):
        o, lse = sliced_forward(q[0, head], k[0, head // group],
                                v[0, head // group], *args)
        torch.testing.assert_close(o, o_ref[0, head], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(lse, lse_ref[0, head], atol=1e-5,
                                   rtol=1e-5)
        dq = sliced_dq(q[0, head], k[0, head // group], v[0, head // group],
                       do[0, head], lse_ref[0, head], delta[0, head], *args)
        torch.testing.assert_close(dq, dq_ref[0, head], atol=1e-5, rtol=1e-5)
    for kv in range(kv_h):
        heads = range(kv * group, (kv + 1) * group)
        dk, dv = sliced_dkv([q[0, x] for x in heads], k[0, kv], v[0, kv],
                            [do[0, x] for x in heads],
                            [lse_ref[0, x] for x in heads],
                            [delta[0, x] for x in heads], *args)
        torch.testing.assert_close(dk, dk_ref[0, kv], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dv, dv_ref[0, kv], atol=1e-5, rtol=1e-5)


def _slice_tile(x, rows, t, ns):
    """csrc's slice_tile: block x -> (b*h, row tile, slice)."""
    n = -(-t // rows)
    return x // ns // n, n - 1 - x // ns % n, x % ns


def _dkv_block(x, n_blocks, t, ns):
    """dkv_sliced_kernel's block x -> (key tile, b*kv_head, slice)."""
    n_kt = -(-t // 64)
    bkv_n = n_blocks // (n_kt * ns)
    rest = x // ns
    return rest // bkv_n, rest % bkv_n, x % ns


@pytest.mark.parametrize("bh,t,ld", [(16, 2048, 512), (3, 300, 304),
                                     (2, 1000, 264), (1, 64, 1024)])
def test_sliced_grids_cover_every_block_once(bh, t, ld):
    """The sliced grids (csrc: slice_tile, dkv_sliced_kernel's walk, the
    launchers' slice_blocks) visit every (row, tile, slice) once: the
    forward's and dq's slices of one row tile adjacent and each b*h's
    tiles longest first; dk/dv's key tiles slowest.  The slices' 64-column
    blocks within ld (nb) cover [0, ld) once."""
    nc = -(-ld // 64)
    ns = A.n_slices(ld)
    assert ns == -(-nc // 4)
    for rows in (128, 64):
        n = bh * -(-t // rows) * ns
        seen = [_slice_tile(x, rows, t, ns) for x in range(n)]
        assert sorted(seen) == sorted(
            (b, tile, s) for b in range(bh) for tile in range(-(-t // rows))
            for s in range(ns))
        assert seen[0] == (0, -(-t // rows) - 1, 0)  # the longest first
    n = bh * -(-t // 64) * ns
    seen = [_dkv_block(x, n, t, ns) for x in range(n)]
    assert sorted(seen) == sorted(
        (kt, b, s) for kt in range(-(-t // 64)) for b in range(bh)
        for s in range(ns))
    assert [kt for kt, _, _ in seen] == sorted(kt for kt, _, _ in seen)
    cols = []
    for s in range(ns):
        nb = min(4, nc - 4 * s)
        assert 1 <= nb <= 4
        cols += range(64 * 4 * s, min(64 * (4 * s + nb), ld))
    assert cols == list(range(ld))


class _Barrier:
    """An mbarrier: `count` arrivals complete a phase; a wait on parity p
    passes once the current phase's parity is not p."""

    def __init__(self, count):
        self.count, self.arrived, self.phase = count, 0, 0

    def arrive(self):
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.phase = 0, self.phase + 1

    def passes(self, parity):
        return self.phase & 1 != parity


@pytest.mark.parametrize("stages,items,seed", [(8, 37, 0), (4, 40, 1),
                                               (5, 23, 2), (2, 9, 3)])
def test_sliced_ring_hands_each_stage_over_in_order(stages, items, seed):
    """csrc's SlicedRing under random interleavings of its producer and two
    consumer warpgroups: the producer refills a stage only after both
    handed it back, each consumer reads every item from the stage the
    producer filled with it, in order, and hands a stage back only once
    the products of the item after it were issued (one group in flight),
    and nothing waits forever."""
    rng = random.Random(seed)
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(2) for _ in range(stages)]
    slots = [None] * stages
    # per actor: the next step to take; consumers keep the item whose
    # stage they still hold
    prod = {"n": 0}
    cons = [{"n": 0, "held": [], "seen": []} for _ in range(2)]

    def producer_step():
        n = prod["n"]
        if n == items:
            return False
        s = n % stages
        if n >= stages and not empty[s].passes((n // stages - 1) & 1):
            return False
        slots[s] = n
        full[s].arrive()
        prod["n"] += 1
        return True

    def consumer_step(c):
        n = c["n"]
        if n == items:
            if c["held"]:  # drain: the last item's stage goes back
                empty[c["held"].pop() % stages].arrive()
                return True
            return False
        s = n % stages
        if not full[s].passes((n // stages) & 1):
            return False
        c["seen"].append(slots[s])
        c["n"] += 1
        c["held"].append(n)
        if len(c["held"]) == 2:  # issued: the previous item's stage back
            empty[c["held"].pop(0) % stages].arrive()
        return True

    actors = [producer_step, lambda: consumer_step(cons[0]),
              lambda: consumer_step(cons[1])]
    while True:
        order = actors[:]
        rng.shuffle(order)
        if not any(step() for step in order):
            break
    assert prod["n"] == items
    for c in cons:
        assert c["seen"] == list(range(items)) and not c["held"]


# ---------------------------------------------------------------------------
# the llama-style LM at head_dim 512: 2 layers, d_model 1024 (2 heads of 512
# over one KV head), vocab 256, T 64; d_ff = d_model * 8 // 3 as the LM
# workload sizes its SwiGLU
WIDE_ATTN = dict(num_layers=2, d_model=1024, num_heads=2, num_kv_heads=1,
                 d_ff=1024 * 8 // 3, vocab_size=256, max_len=64)
LOGITS_ATOL = 1e-5
LM_ATOL = 5e-5
OPT = dict(schedule="cosine", warmup_steps=2, total_steps=5,
           weight_decay=0.1, grad_clip=1.0)


def _lm_tokens(b=2, t=64, seed=0):
    return np.random.RandomState(seed).randint(
        0, WIDE_ATTN["vocab_size"], (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def wide_head_lms():
    jcfg = J.llama_style_config(dtype=jnp.float32, **WIDE_ATTN)
    tcfg = T.llama_style_config(dtype=torch.float32, **WIDE_ATTN)
    assert tcfg.d_model // tcfg.num_heads == 512
    params = jax.device_get(J.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(_lm_tokens()))["params"])
    return jcfg, tcfg, params


def _port_model(tcfg, params):
    model = T.TransformerLM(tcfg)
    model.load_state_dict(params_from_flax(params))
    return model


def test_lm_at_head_dim_512_logits_match_flax(wide_head_lms):
    jcfg, tcfg, params = wide_head_lms
    model = _port_model(tcfg, params)
    tok = _lm_tokens()
    want = J.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        got = model(torch.from_numpy(tok))
    assert got.shape == want.shape == (2, 64, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL)


def test_lm_at_head_dim_512_loss_and_gradients_match_jax(wide_head_lms):
    """The LM workload's loss (next-token cross-entropy) and its gradient
    with respect to every parameter, on the same tokens; the port's
    gradients go back through params_to_flax."""
    jcfg, tcfg, params = wide_head_lms
    model = _port_model(tcfg, params)
    tok = _lm_tokens(seed=1)
    jloss = j_loss_fn(J.TransformerLM(jcfg).apply)
    (want_loss, _), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        params, {"tokens": jnp.asarray(tok)})
    loss, _ = lm_loss_fn(model)({"tokens": torch.from_numpy(tok)})
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < LM_ATOL
    grads = params_to_flax({name: p.grad for name, p in
                            model.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(got) == len(leaves)
    for path, want in leaves:
        np.testing.assert_allclose(got[path], np.asarray(want), atol=LM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_lm_at_head_dim_512_train_steps_match_jax(wide_head_lms):
    """Four steps of the LM's train step and AdamW schedule (clip 1.0,
    decay 0.1, warmup + cosine) from the same params: losses and the
    parameters after them."""
    jcfg, tcfg, params = wide_head_lms
    jmodel = J.TransformerLM(jcfg)
    jstate = j_create(jax.random.PRNGKey(0), jmodel,
                      joptim.lm_optimizer(3e-3, **OPT),
                      jnp.zeros((2, 64), jnp.int32))
    jstate = jstate.replace(params=params)
    model = _port_model(tcfg, params)
    state = create_train_state(model, toptim.lm_optimizer(3e-3, **OPT),
                               seed=None)
    jstep = j_make_step(j_loss_fn(jmodel.apply), donate=False)
    step = make_train_step(lm_loss_fn(model))
    for seed in (2, 3, 4, 5):
        tok = _lm_tokens(seed=seed)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        state, m = step(state, {"tokens": torch.from_numpy(tok)})
        assert abs(float(m["loss"]) - float(jm["loss"])) < LM_ATOL
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_flax(model.state_dict())))
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jstate.params)):
        np.testing.assert_allclose(got[path], np.asarray(want), atol=LM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    for (path, init), (_, after) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(
                jax.device_get(jstate.params))):
        moved = max(moved, float(np.abs(np.asarray(after) - init).max()))
    assert moved > 100 * LM_ATOL  # the steps really moved the params
