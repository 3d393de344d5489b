"""The port's hand-written flash-attention kernels against their plain
PyTorch versions, on the card.

The tests marked `cuda` need a CUDA device and skip elsewhere.  The machine
with the card has no JAX, so this file imports none, and is run there
without the repo's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerance: `chip_smoke.tolerance_ratios`, each element within
2e-2 * (|plain| + RMS of its row + 0.05 * RMS of the tensor) and the
whole within 1e-2 relative Frobenius error, the plain version in f32 on
the same bf16 inputs; the kernels round P and dS to bf16 before their
second product and write bf16 outputs.  lse within 1e-3 (f32 on both
sides).  `flash_attention_lse` is held by `chip_smoke.lse_case` with
cotangents on both outputs, and the same kernels given delta where the
backward needs delta' = delta - dlse (a planted fault) must fail.  The
unmarked tests check that rule itself on the CPU.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import FRO, lse_case, ptxas_report, tolerance_ratios
from tf_operator_tpu_torch.parallel.ring_attention import ring_hops
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import attention as A


def _inputs(t, h, kv_h, d=64, b=2, seed=0, device="cuda"):
    rng = np.random.RandomState(seed)
    shapes = ((b, h, t, d), (b, kv_h, t, d), (b, kv_h, t, d), (b, h, t, d))
    return [torch.tensor(rng.randn(*s).astype(np.float32), device=device)
            .bfloat16() for s in shapes]


def _held(got, ref):
    worst, rel = tolerance_ratios(got, ref)
    return worst <= 1.0 and rel <= FRO


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _pv_without_early_keys(q, k, v, t_drop, n_drop):
    """o with the P.V terms of keys [0, n_drop) left out for query rows >=
    t_drop, the softmax denominator kept: a fault on late rows only."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    t = q.shape[2]
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), -1e30)
    p = torch.softmax(s, -1)
    p[:, :, t_drop:, :n_drop] = 0
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.parametrize("t", [512, 2048])
@pytest.mark.parametrize("n_drop", [16, 64])
def test_tolerance_takes_rounding_and_rejects_a_late_tile_fault(t, n_drop):
    """The rule passes the plain output rounded to bf16 (what a right
    kernel adds) and rejects one that drops the first keys' P.V terms for
    the last 128 rows only."""
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 2, t, 64).bfloat16().float() for _ in range(3))
    ref, _ = A.attention_lse(q, k, v, causal=True, scale=0.125)
    assert _held(ref.bfloat16(), ref)
    assert not _held(_pv_without_early_keys(q, k, v, t - 128, n_drop), ref)


def _dq_without_early_keys(q, k, v, do, t_drop, n_drop):
    """(plain dq, dq with the dS.K terms of keys [0, n_drop) left out for
    query rows >= t_drop): a fault on late rows only."""
    o, lse = A.attention_lse(q, k, v, causal=True, scale=0.125)
    delta = (do * o).sum(-1)
    ref = A.backward_dq_plain(q, k, v, do, lse, delta, scale=0.125,
                              causal=True, window=None, sink=0)
    _, ds = A._probs_and_ds(q, k, v, do, lse, delta, 0.125, True, None, 0)
    ds[:, :, t_drop:, :n_drop] = 0
    return ref, torch.einsum("bhqk,bhkd->bhqd", ds, k) * 0.125


@pytest.mark.parametrize("t", [512, 2048])
@pytest.mark.parametrize("n_drop", [16, 64])
def test_tolerance_takes_rounding_and_rejects_a_late_dq_fault(t, n_drop):
    """The rule passes the plain dq rounded to bf16 and rejects one that
    drops the first keys' dS.K terms for the last 128 rows only (what the
    planted dq fault on the card does)."""
    torch.manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, t, 64).bfloat16().float()
                   for _ in range(4))
    ref, faulty = _dq_without_early_keys(q, k, v, do, t - 128, n_drop)
    assert _held(ref.bfloat16(), ref)
    assert not _held(faulty, ref)


@pytest.mark.parametrize("t", [256, 1024])
def test_tolerance_rejects_delta_for_delta_prime(t):
    """The rule passes the plain dq and dk of the (o, lse) backward rounded
    to bf16 and rejects those computed with delta where the lse cotangent
    asks for delta' = delta - dlse (what the planted fault on the card
    does); dv reads no delta."""
    torch.manual_seed(1)
    q, k, v, do = (torch.randn(1, 2, t, 64).bfloat16().float()
                   for _ in range(4))
    dlse = torch.randn(1, 2, t)
    o, lse = A.attention_lse(q, k, v, causal=True, scale=0.125)
    delta = (do * o).sum(-1)
    opts = dict(scale=0.125, causal=True, window=None, sink=0)
    for wrong, right in (
            (A.backward_dq_plain(q, k, v, do, lse, delta, **opts),
             A.backward_dq_plain(q, k, v, do, lse, delta - dlse, **opts)),
            (A.backward_dkv_plain(q, k, v, do, lse, delta, **opts)[0],
             A.backward_dkv_plain(q, k, v, do, lse, delta - dlse,
                                  **opts)[0])):
        assert _held(right.bfloat16(), right)
        assert not _held(wrong, right)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_rule_rejects_a_ring_without_its_last_shift(causal):
    """The ring phase's rule (the kernel rule per element and as a whole,
    against plain attention over the whole sequence) passes the plain ring
    of 4 ranks rounded to bf16 and rejects one whose last step sees the
    blocks of the step before (the planted fault on the card: causal, only
    the last rank's first block goes missing)."""
    torch.manual_seed(2)
    q, k, v = (torch.randn(1, 2, 512, 64).bfloat16().float()
               for _ in range(3))
    n, tl = 4, 128
    ref = A.attention(q, k, v, causal=causal)

    def ring(last):
        blocks = [(k[:, :, i * tl:(i + 1) * tl], v[:, :, i * tl:(i + 1) * tl])
                  for i in range(n)]
        return torch.cat([ring_hops(
            q[:, :, me * tl:(me + 1) * tl], me, n,
            [blocks[(me - min(s, last)) % n] for s in range(n)],
            causal=causal) for me in range(n)], dim=2)

    assert _held(ring(n - 1).bfloat16(), ref)
    assert not _held(ring(n - 2), ref)


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19dq_kernelILi64ELi2EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19dq_kernelILi64ELi2EEEv
    8 bytes stack frame, 8 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110fwd_kernelILi128ELi1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110fwd_kernelILi128ELi1EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def test_ptxas_report_names_each_instantiation_and_its_spills():
    """chip_smoke's build phase reads each kernel instantiation's
    registers and spills from nvcc's -Xptxas=-v output (a report in the
    card's format) and fails on any spill."""
    assert ptxas_report(_PTXAS_LOG) == [
        ("dq_kernel<D 64, WG 2>", 168, 8, 20),
        ("fwd_kernel<D 128, WG 1>", 128, 0, 0)]


@pytest.mark.parametrize("scale,ok", [(0.125, True), (0.0, False),
                                      (-0.125, False), (float("nan"), False)])
def test_the_kernels_take_only_a_positive_scale(scale, ok):
    """The forward kernel takes the row max of the unscaled scores, which
    is the max of the scaled ones only for a positive scale."""
    if ok:
        A._check_scale(scale)
    else:
        with pytest.raises(ValueError, match="positive scale"):
            A._check_scale(scale)


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,kv_h,causal,window,sink,block,d", [
    (256, 4, 2, True, None, 0, 128, 64),
    (200, 4, 4, False, None, 0, 64, 64),
    (512, 2, 2, True, 64, 4, 128, 64),
    (300, 4, 2, True, None, 0, 128, 128),
    (200, 4, 4, False, None, 0, 64, 128),
    # ragged T with window + sink at every (head_dim, block): the 70 sink
    # keys end inside a key tile that later query tiles visit as band
    # (keys 0-127 at head_dim 64, keys 64-127 at head_dim 128)
    (1000, 4, 2, True, 64, 70, 128, 64),
    (1000, 4, 2, True, 64, 70, 64, 64),
    (1000, 4, 2, True, 64, 70, 128, 128),
    (1000, 4, 2, True, 64, 70, 64, 128),
])
def test_kernels_match_plain_versions(cuda, t, h, kv_h, causal, window,
                                      sink, block, d):
    q, k, v, g = _inputs(t, h, kv_h, d)
    opts = dict(scale=0.125, causal=causal, window=window, sink=sink)
    before = A.launches()
    o, lse = A.flash_forward(q, k, v, block_q=block, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, block_q=block, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, block_k=block,
                                  **opts)
    torch.cuda.synchronize()
    assert all(A.launches()[n] == before[n] + 1 for n in before)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf),
                                     causal=causal, scale=0.125,
                                     window=window, sink=sink)
    dq_ref = A.backward_dq_plain(qf, kf, vf, gf, lse, delta, **opts)
    dk_ref, dv_ref = A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts)
    for got, ref in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _held(got, ref), tolerance_ratios(got, ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t", [(256, 12, 197), (32, 12, 128),
                                   (256, 6, 197), (32, 6, 128)],
                         ids=["vit_b16", "bert_base", "vit_b16_tp2",
                              "bert_base_tp2"])
def test_kernels_at_the_classification_shapes(cuda, b, h, t):
    """Non-causal at the encoders' shapes: ViT-B/16 at 224x224 (T 197, a
    ragged last key tile of 69, B*H 3072) and BERT-base at T 128 (one tile
    a head), 12 heads of 64, and each tp rank's 6 of them at tp 2."""
    q, k, v, g = _inputs(t, h, h, b=b)
    opts = dict(scale=0.125, causal=False, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, block_q=128, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, block_q=128, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, block_k=128,
                                  **opts)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = A.attention_lse(qf, kf, vf, causal=False, scale=0.125)
    dq_ref = A.backward_dq_plain(qf, kf, vf, gf, lse, delta, **opts)
    dk_ref, dv_ref = A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts)
    for got, ref in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _held(got, ref), tolerance_ratios(got, ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv_h", [(6, 6), (6, 2)],
                         ids=["gpt_small_tp2", "llama_tp2"])
def test_kernels_at_the_tp_local_shapes(cuda, h, kv_h):
    """Causal at T 2048 and B 8 with each tp rank's heads at tp 2:
    GPT-small's 12 -> 6 and llama's 12 query / 4 KV heads -> 6 / 2 (a GQA
    group of 3)."""
    q, k, v, g = _inputs(2048, h, kv_h, b=8)
    opts = dict(scale=0.125, causal=True, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, block_q=128, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, block_q=128, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, block_k=128,
                                  **opts)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf),
                                     causal=True, scale=0.125)
    dq_ref = A.backward_dq_plain(qf, kf, vf, gf, lse, delta, **opts)
    dk_ref, dv_ref = A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts)
    for got, ref in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _held(got, ref), tolerance_ratios(got, ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card(cuda):
    """The public entry on CUDA tensors goes through the kernels, forward
    and backward.  Its gradients are held per element against the plain
    backward in f32 given the forward's output in the inputs' dtype (the
    flash backward's delta = rowsum(dO * O) reads the bf16 O, as the JAX
    package's does), and as a whole against f32 autograd of the plain
    version, whose delta reads an f32 O: that difference is shared by a
    whole row and does not cancel where a row's gradient does."""
    q, k, v, g = _inputs(300, 4, 2)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = A.launches()
    out = A.flash_attention(*leaves, True)
    out.backward(g)
    assert all(A.launches()[n] == before[n] + 1 for n in before)
    got = [out.detach()] + [x.grad for x in leaves]

    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf),
                                     causal=True, scale=0.125)
    delta = (gf * o_ref.bfloat16().float()).sum(-1)
    opts = dict(scale=0.125, causal=True, window=None, sink=0)
    plain = [o_ref, A.backward_dq_plain(qf, kf, vf, gf, lse_ref, delta,
                                        **opts),
             *A.backward_dkv_plain(qf, kf, vf, gf, lse_ref, delta, **opts)]
    for x, want in zip(got, plain):
        assert _held(x, want), tolerance_ratios(x, want)

    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = A.attention(ref_leaves[0], *A.repeat_kv(*ref_leaves), causal=True)
    ref.backward(gf)
    for x, want in zip(got, [ref.detach()] + [x.grad for x in ref_leaves]):
        assert tolerance_ratios(x, want)[1] <= FRO


def _faulty_library(tmp_path, monkeypatch, site, fault):
    """Build the kernels from a copy of ops/csrc with `site` (which must
    occur once) replaced by `fault`, and make the wrappers launch them."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    source = csrc / _build.SOURCE.name
    src = source.read_text()
    assert src.count(site) == 1
    source.write_text(src.replace(site, fault))
    lib = tmp_path / "libflash_attention_fault.so"
    _build.nvcc(source, lib)
    monkeypatch.setattr(A, "_lib", None)
    monkeypatch.setattr(_build, "library", lambda: ctypes.CDLL(str(lib)))


@pytest.mark.cuda
def test_tolerance_rejects_a_kernel_that_skips_a_late_tile(cuda, tmp_path,
                                                           monkeypatch):
    """A forward built with a planted fault (the P.V product of the first
    16 keys skipped for the last query tile; m, l and lse untouched) at
    the LM's main-path shape: o fails the tolerance while lse still
    passes."""
    site = "hopper::wgmma_rs64(acc[h], pa[kk]"
    _faulty_library(tmp_path, monkeypatch, site,
                    "if (it > 0 || kk > 0 || q0 + BM < T) " + site)

    q, k, v, _ = _inputs(2048, 12, 12, b=8)
    o, lse = A.flash_forward(q, k, v, scale=0.125, causal=True, window=None,
                             sink=0, block_q=128)
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = A.attention_lse(qf, kf, vf, causal=True, scale=0.125)
    worst, rel = tolerance_ratios(o, o_ref)
    err = float((o.float() - o_ref).abs().max())
    print(f"planted fault: o worst err/limit {worst:.3f}, relative "
          f"Frobenius {rel:.3e}, max_abs_err {err:.3e} (a limit of 2e-2 * "
          f"max(1, max|o|) would be "
          f"{2e-2 * max(1.0, float(o_ref.abs().max())):.3e})")
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    assert not _held(o, o_ref)


@pytest.mark.cuda
def test_tolerance_rejects_a_dkv_kernel_that_skips_a_query_tile(
        cuda, tmp_path, monkeypatch):
    """A dk/dv kernel built with a planted fault (each key tile leaves out
    the dV contribution of the first query tile it visits; dK untouched)
    at the LM's main-path shape: dv fails the tolerance, dk still passes."""
    site = "hopper::wgmma_rs64(dv_acc[h], pa[kk]"
    _faulty_library(tmp_path, monkeypatch, site, "if (it > 0) " + site)

    q, k, v, g = _inputs(2048, 12, 12, b=8)
    opts = dict(scale=0.125, causal=True, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, block_q=128, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, block_k=128,
                                  **opts)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    dk_ref, dv_ref = A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts)
    worst, rel = tolerance_ratios(dv, dv_ref)
    print(f"planted dk/dv fault: dv worst err/limit {worst:.3f}, relative "
          f"Frobenius {rel:.3e}")
    assert _held(dk, dk_ref), tolerance_ratios(dk, dk_ref)
    assert not _held(dv, dv_ref)


@pytest.mark.cuda
def test_tolerance_rejects_a_dq_kernel_that_skips_early_keys(
        cuda, tmp_path, monkeypatch):
    """A dq kernel built with a planted fault (the dS.K product of the
    first 16 keys skipped for the last query tile) at the LM's main-path
    shape: dq fails the tolerance."""
    site = "hopper::wgmma_rs64(dq_acc[h], da[kk]"
    _faulty_library(tmp_path, monkeypatch, site,
                    "if (it > 0 || kk > 0 || q0 + BM < T) " + site)

    q, k, v, g = _inputs(2048, 12, 12, b=8)
    opts = dict(scale=0.125, causal=True, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, block_q=128, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, block_q=128, **opts)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    dq_ref = A.backward_dq_plain(qf, kf, vf, gf, lse, delta, **opts)
    worst, rel = tolerance_ratios(dq, dq_ref)
    print(f"planted dq fault: dq worst err/limit {worst:.3f}, relative "
          f"Frobenius {rel:.3e}")
    assert not _held(dq, dq_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv_h,t,d,causal", [
    (2, 4, 4, 300, 64, True),
    (2, 4, 2, 512, 64, False),
    (2, 4, 4, 200, 128, True),
    (8, 12, 12, 1024, 64, True),
])
def test_flash_attention_lse_with_both_cotangents(cuda, b, h, kv_h, t, d,
                                                  causal):
    """flash_attention_lse through the kernels (one launch of each), o and
    lse, and dq/dk/dv under cotangents on both outputs within the rule;
    the planted delta-for-delta' fault fails it (lse_case raises
    otherwise) by a wide margin."""
    ratios = lse_case(("card", b, h, kv_h, t, d, causal))
    print(f"lse case: {ratios}")
    assert max(ratios[key] for key in ("o", "dq", "dk", "dv")) <= 1.0
    assert ratios["fault_dq"] > 5.0


@pytest.mark.cuda
def test_flash_attention_lse_raises_on_what_the_kernels_do_not_take(cuda):
    """No fallback on the card: f32 inputs or head_dim 32 raise."""
    q, k, v, _ = _inputs(128, 2, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_attention_lse(q.float(), k.float(), v.float())
    q32 = torch.zeros(1, 2, 64, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention_lse(q32, q32, q32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,causal", [(32, 12, 128, False),
                                          (256, 12, 197, False),
                                          (8, 12, 2048, True)],
                         ids=["bert_base", "vit_b16", "gpt_small"])
def test_kernels_repeat_bit_for_bit(cuda, b, h, t, causal):
    """Each kernel run twice on the same inputs gives the same bits: no
    atomics, and no read of shared memory or padding that a launch leaves
    unset.  BERT-base at T 128 is one 128-row tile a head, fewer tiles
    than the TMA ring has stages."""
    q, k, v, g = _inputs(t, h, h, b=b)
    opts = dict(scale=0.125, causal=causal, window=None, sink=0)

    def run():
        o, lse = A.flash_forward(q, k, v, block_q=128, **opts)
        delta = (g.float() * o.float()).sum(-1)
        dq = A.flash_backward_dq(q, k, v, g, lse, delta, block_q=128,
                                 **opts)
        dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, block_k=128,
                                      **opts)
        return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}

    first, second = run(), run()
    torch.cuda.synchronize()
    differ = [name for name in first
              if not torch.equal(first[name], second[name])]
    assert not differ, f"outputs that differ between two launches: {differ}"


def bert_base_steps(steps: int, device="cuda"):
    """(every step's loss, every step's gradients by parameter name) of
    BERT-base (12 x 768, B 32, T 128, 2 labels, adamw 5e-5) from seed 0 on
    the bert workload's token and label stream, as its step computes
    them."""
    from tf_operator_tpu_torch.models.transformer import (BertEncoder,
                                                          bert_base_config)
    from tf_operator_tpu_torch.train.optim import adamw
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.step import (classification_loss_fn,
                                                  make_train_step)

    cfg = bert_base_config(max_len=128)
    model = BertEncoder(cfg, num_labels=2)
    state = create_train_state(model, adamw(5e-5), seed=0,
                               device=torch.device(device))
    step = make_train_step(classification_loss_fn(model))
    rng = np.random.RandomState(0)
    losses, grads = [], []
    for _ in range(steps):
        batch = {"x": rng.randint(0, cfg.vocab_size, (32, 128)),
                 "label": rng.randint(0, 2, 32)}
        state, metrics = step(state, {
            key: torch.from_numpy(x.astype(np.int32)).to(device)
            for key, x in batch.items()})
        losses.append(metrics["loss"].detach().clone())
        grads.append({name: p.grad.detach().clone()
                      for name, p in model.named_parameters()})
    return losses, grads


def first_difference(a, b):
    """(step, [(leaf, max abs difference)]) of the first step at which two
    `bert_base_steps` results differ (the loss counts as a leaf), or
    None."""
    for i, ((loss_a, grads_a), (loss_b, grads_b)) in enumerate(
            zip(zip(*a), zip(*b))):
        differ = [(name, float((grads_a[name] - grads_b[name]).abs().max()))
                  for name in grads_a
                  if not torch.equal(grads_a[name], grads_b[name])]
        if not torch.equal(loss_a, loss_b):
            differ.insert(0, ("loss", float((loss_a - loss_b).abs())))
        if differ:
            return i, differ
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["default", "deterministic_algorithms"])
def test_two_bert_base_runs_repeat_bit_for_bit(cuda, deterministic,
                                               monkeypatch):
    """Two BERT-base runs from one seed on one batch stream give equal
    losses and gradients, leaf by leaf, at each of 6 steps, with torch's
    default algorithms and under `torch.use_deterministic_algorithms`
    (which raises on any op that torch knows to be nondeterministic)."""
    if deterministic:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(deterministic)
    try:
        runs = [bert_base_steps(6) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    found = first_difference(*runs)
    print(f"bert-base, deterministic algorithms {deterministic}: losses "
          f"{[float(x) for x in runs[0][0]]} / "
          f"{[float(x) for x in runs[1][0]]}; first difference {found}")
    assert found is None


@pytest.mark.cuda
def test_lookup_table_gradient_repeats_bit_for_bit(cuda):
    """BERT-base's type embedding: every one of the B*T = 4096 token types
    0.  `transformer.lookup`'s table gradient is the same bits in two
    backward passes, and within f32 rounding of the sum in f64."""
    from tf_operator_tpu_torch.models.transformer import lookup

    rng = np.random.RandomState(0)
    table = torch.tensor(rng.randn(2, 768).astype(np.float32),
                         device="cuda", requires_grad=True)
    tokens = torch.zeros(32, 128, dtype=torch.int32, device="cuda")
    cot = torch.tensor(rng.randn(32, 128, 768).astype(np.float32),
                       device="cuda")
    grads = []
    for _ in range(2):
        table.grad = None
        lookup(table, tokens).backward(cot)
        grads.append(table.grad.clone())
    assert torch.equal(grads[0], grads[1])
    want = cot.double().sum((0, 1))
    torch.testing.assert_close(grads[0][0].double(), want, rtol=1e-5,
                               atol=1e-3)
    assert not grads[0][1].any()
