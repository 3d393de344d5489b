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
sides).  fp16 inputs are held by the same rule (fp16 rounds at 2^-11,
finer than bf16's 2^-8).  f32 inputs run the f32 kernels, f32 throughout,
so only the order of the sums differs from the plain version: the factor
is 1e-4 instead of 2e-2, the whole 1e-5 instead of 1e-2, lse 1e-5
(`chip_smoke.rule`; PERF.md gives the ratios measured on the card).  `flash_attention_lse` is held by `chip_smoke.lse_case` with
cotangents on both outputs, and the same kernels given delta where the
backward needs delta' = delta - dlse (a planted fault) must fail.  The
unmarked tests check that rule itself on the CPU.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import (CASES, FRO, LSE_CASES, kernel_case, lse_case,
                        ptxas_report, rule, tolerance_ratios)
from tf_operator_tpu_torch.parallel.ring_attention import ring_hops
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import attention as A


def _inputs(t, h, kv_h, d=64, b=2, seed=0, device="cuda",
            dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    shapes = ((b, h, t, d), (b, kv_h, t, d), (b, kv_h, t, d), (b, h, t, d))
    return [torch.tensor(rng.randn(*s).astype(np.float32), device=device)
            .to(dtype) for s in shapes]


DEFAULT = dict(block_q=128, block_k=128)
# an output that is zero in exact arithmetic, on either side: unit-variance
# inputs leave rounding of ~1e-7 there (measured on the card), real
# gradients of ~1e-1
ZERO_ABS = 1e-4


def _held(got, ref, dtype="bfloat16"):
    rtol, fro, _ = rule(dtype)
    worst, rel = tolerance_ratios(got, ref, rtol)
    return worst <= 1.0 and rel <= fro


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


_DQ = ("_ZN12_GLOBAL__N_19dq_kernelI13__nv_bfloat16Li64ELi2ELi128EEEv14CU"
       "tensorMap_stS2_S2_S2_PKfS4_PT_iifN2fa4MaskE")
_FWD = ("_ZN12_GLOBAL__N_110fwd_kernelI6__halfLi128ELi1ELi64ELb1EEEv14CUtens"
        "orMap_stS2_S2_PT_PfiifN2fa4MaskE")
_DKV32 = ("_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_0a3d1bee15"
          "dkv_tf32_kernelILi128ELb0ELb0EEEv14CUtensorMap_stS1_S1_S1_PKfS3_"
          "S3_S3_S3_S3_PfS4_S4_iiiifN2fa4MaskE")
_DQ32 = ("_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_0a3d1bee14"
         "dq_tf32_kernelILi64ELb0ELb0EEEv14CUtensorMap_stS1_S1_S1_PKfS3_S3_"
         "S3_S3_S3_PfiifN2fa4MaskE")
_PTXAS_LOG = f"""\
ptxas info    : Compiling entry function '{_DQ}' for 'sm_90a'
ptxas info    : Function properties for {_DQ}
    8 bytes stack frame, 8 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '{_FWD}' for 'sm_90a'
ptxas info    : Function properties for {_FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '{_DKV32}' for 'sm_90a'
ptxas info    : Function properties for {_DKV32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 190 registers, used 1 barriers
ptxas info    : Compiling entry function '{_DQ32}' for 'sm_90a'
ptxas info    : Function properties for {_DQ32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 3 barriers
"""


def test_ptxas_report_names_each_instantiation_and_its_spills():
    """chip_smoke's build phase reads each kernel instantiation's
    registers and spills from nvcc's -Xptxas=-v output (a report in the
    card's format, template arguments mangled as nvcc mangles them), fails
    on any spill, and holds the instantiations against
    attention.INSTANTIATED by the last field."""
    assert ptxas_report(_PTXAS_LOG) == [
        ("dq_kernel<bfloat16, D 64, rows 128, step 128>", 168, 8, 20,
         ("dq", "bfloat16", 64, 128, 128)),
        ("fwd_kernel<float16, D 128, rows 64, step 64, scaled 1>", 128, 0, 0,
         ("fwd", "float16", 128, 64, 64)),
        ("dkv_tf32_kernel<D 128>", 190, 0, 0,
         ("dkv", "float32", 128, 64, 32)),
        ("dq_tf32_kernel<D 64>", 126, 0, 0, ("dq", "float32", 64, 64, 32))]
    assert {r[4] for r in ptxas_report(_PTXAS_LOG)} <= A.instantiations()


def test_ptxas_report_names_f32_dq_on_the_tensor_cores():
    """f32 dq on the tensor cores (dq_tf32_kernel; its template arguments:
    the columns a block takes, whether it is a cluster's, whether it
    streams the head dim) at head-dim class 256, on its cluster and in its
    streamed slices: each keyed as the instantiation attention.F32_DQ
    gives that route, a spill reported as it stands."""
    name = _DQ32.replace("ILi64ELb0ELb0E", "ILi{}ELb{}ELb{}E")
    log = "".join(
        f"ptxas info    : Compiling entry function '{name.format(*args)}' "
        "for 'sm_90a'\nptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes"
        " spill loads\nptxas info    : Used 168 registers, used 3 barriers\n"
        for args, spill in (((256, 0, 0), 0), ((256, 1, 0), 4),
                            ((256, 0, 1), 0)))
    report = ptxas_report(log)
    assert report == [
        ("dq_tf32_kernel<D 256>", 168, 0, 0, ("dq", "float32", 256, 64, 16)),
        ("dq_tf32_kernel<cluster>", 168, 4, 4,
         ("dq", "float32", A.CLUSTER, 64, 16)),
        ("dq_tf32_kernel<streamed slices>", 168, 0, 0,
         ("dq", "float32", A.SLICED, 64, 16))]
    assert {r[4] for r in report} <= A.instantiations()


_SPLIT = ("_ZN12_GLOBAL__N_116dkv_split_kernelI6__halfLi64EEEv14CUtensorMap_"
          "stS2_S2_S2_PKfS4_PT_S6_PfiiiifN2fa4MaskE")
_FWD256 = ("_ZN12_GLOBAL__N_110fwd_kernelI13__nv_bfloat16Li256ELi2ELi64ELb0EEE"
           "v14CUtensorMap_stS2_S2_PT_PfiifN2fa4MaskE")
_DKV256_32 = ("_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_e115676f15"
              "dkv_tf32_kernelILi256ELb0ELb0EEEv14CUtensorMap_stS1_S1_S1_"
              "PKfS3_S3_S3_S3_S3_PfS4_S4_iiiifN2fa4MaskE")
_DQ256 = ("_ZN12_GLOBAL__N_114dq_wide_kernelI13__nv_bfloat16EEv14CUtensorMap"
          "_stS2_S2_S2_PKfS4_PT_iifN2fa4MaskE")


def test_ptxas_report_names_the_head_dim_256_kernels():
    """The head-dim class 256's kernels in the same report: dk/dv's split
    kernel (its template arguments are the element type and the query
    step; its 64 keys are shared by two warpgroups), the forward's 128
    rows, the f32 dk/dv on the tensor cores at 256 columns a block (its
    16-query step, attention.F32_DKV) and dq's wide kernel (two
    warpgroups of 64 rows over a 64-key step), each an instantiation that
    attention.INSTANTIATED lists."""
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for name, regs in ((_SPLIT, 168), (_FWD256, 168), (_DKV256_32, 160),
                           (_DQ256, 168)))
    report = ptxas_report(log)
    assert report == [
        ("dkv_split_kernel<float16, D 256, rows 64, step 64>", 168, 0, 0,
         ("dkv", "float16", 256, 64, 64)),
        ("fwd_kernel<bfloat16, D 256, rows 128, step 64, scaled 0>", 168, 0,
         0, ("fwd", "bfloat16", 256, 128, 64)),
        ("dkv_tf32_kernel<D 256>", 160, 0, 0,
         ("dkv", "float32", 256, 64, 16)),
        ("dq_wide_kernel<bfloat16, D 256, rows 128, step 64>", 168, 0, 0,
         ("dq", "bfloat16", 256, 128, 64))]
    assert {r[4] for r in report} <= A.instantiations()


_FWD_WIDE = ("_ZN12_GLOBAL__N_115fwd_wide_kernelI6__halfLb1EEEv14CUtensorMap_st"
             "S2_S2_PT_PfiifN2fa4MaskEi")


def test_ptxas_report_names_the_wide_forward():
    """kernel_variants.py's split-ring forward at head-dim class 256 over
    128 rows (fwd_wide_kernel, templated on the element type and the
    route): the report names it and gives it the key of the (fwd, 256,
    128, 64) instantiation it stands in for."""
    log = (f"ptxas info    : Compiling entry function '{_FWD_WIDE}' for "
           f"'sm_90a'\nptxas info    : Function properties for {_FWD_WIDE}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 168 registers, used 3 barriers\n")
    assert ptxas_report(log) == [
        ("fwd_wide_kernel<float16, D 256, rows 128, step 64, scaled 1>", 168,
         0, 0, ("fwd", "float16", 256, 128, 64))]
    assert ("fwd", "float16", 256, 128, 64) in A.instantiations()


_FWD_SLICED = ("_ZN12_GLOBAL__N_117fwd_sliced_kernelI13__nv_bfloat16Lb0EEEv"
               "14CUtensorMap_stS2_S2_PT_PfiifN2fa4MaskE")
_DQ_SLICED = ("_ZN12_GLOBAL__N_116dq_sliced_kernelI6__halfEEv14CUtensorMap_st"
              "S2_S2_S2_PKfS4_PT_iifN2fa4MaskE")
_DKV_SLICED_F32 = ("_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_0a3d1b"
                   "ee15dkv_tf32_kernelILi256ELb0ELb1EEEv14CUtensorMap_stS1_"
                   "S1_S1_PKfS3_S3_S3_S3_S3_PfS4_S4_iiiifN2fa4MaskE")


def test_ptxas_report_names_the_sliced_kernels():
    """The sliced kernels of head dims above 256 in the same report (their
    template arguments: the element type and, for the forward, its route;
    for f32 dk/dv, on the tensor cores, the slice width and its streamed
    route), each keyed as the SLICED instantiation attention.INSTANTIATED
    lists."""
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for name, regs in ((_FWD_SLICED, 168), (_DQ_SLICED, 168),
                           (_DKV_SLICED_F32, 200)))
    report = ptxas_report(log)
    assert report == [
        ("fwd_sliced_kernel<bfloat16, rows 128, step 64, scaled 0>", 168, 0,
         0, ("fwd", "bfloat16", A.SLICED, 128, 64)),
        ("dq_sliced_kernel<float16, rows 128, step 64>", 168, 0, 0,
         ("dq", "float16", A.SLICED, 128, 64)),
        ("dkv_tf32_kernel<streamed slices>", 200, 0, 0,
         ("dkv", "float32", A.SLICED, 64, 16))]
    assert {r[4] for r in report} <= A.instantiations()


_DQ_CLUSTER = ("_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_0605655217"
               "dq_cluster_kernelI13__nv_bfloat16Li2EEEv14CUtensorMap_stS2_"
               "S2_S2_PKfS4_PT_iifN2fa4MaskE")
_DKV_CLUSTER = ("_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_0605655218"
                "dkv_cluster_kernelI6__halfLi4EEEv14CUtensorMap_stS2_S2_S2_"
                "PKfS4_PT_S6_iiifN2fa4MaskE")


def test_ptxas_report_names_the_cluster_kernels():
    """The cluster kernels in the same report (their template arguments:
    the element type and the slices, the cluster's blocks), each keyed as
    the CLUSTER instantiation attention.INSTANTIATED lists, a spill
    reported as it stands."""
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
        "spill loads\n"
        f"ptxas info    : Used 168 registers, used 2 barriers\n"
        for name, spill in ((_DQ_CLUSTER, 0), (_DKV_CLUSTER, 4)))
    report = ptxas_report(log)
    assert report == [
        ("dq_cluster_kernel<bfloat16, 2 slices, rows 64, step 64>", 168, 0,
         0, ("dq", "bfloat16", A.CLUSTER, 64, 64)),
        ("dkv_cluster_kernel<float16, 4 slices, rows 64, step 64>", 168, 4,
         4, ("dkv", "float16", A.CLUSTER, 64, 64))]
    assert {r[4] for r in report} <= A.instantiations()


_FWD_PAIR = ("_ZN51_GLOBAL__N__d6002ca6_18_flash_attention_cu_183a6efc15"
             "fwd_pair_kernelI{}Lb{}EEEv14CUtensorMap_stS2_S2_PT_PfiifN2fa4"
             "MaskE")


def test_ptxas_report_names_the_pair_forward():
    """The pair forward in the same report (its template arguments: the
    element type and the route), each keyed as the PAIR instantiation
    attention.INSTANTIATED lists."""
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 5 barriers\n"
        for name in (_FWD_PAIR.format("13__nv_bfloat16", 1),
                     _FWD_PAIR.format("6__half", 0)))
    report = ptxas_report(log)
    assert report == [
        ("fwd_pair_kernel<bfloat16, rows 64, step 64, scaled 1>", 168, 0, 0,
         ("fwd", "bfloat16", A.PAIR, 64, 64)),
        ("fwd_pair_kernel<float16, rows 64, step 64, scaled 0>", 168, 0, 0,
         ("fwd", "float16", A.PAIR, 64, 64))]
    assert {r[4] for r in report} <= A.instantiations()


@pytest.mark.parametrize("scale,ok", [(0.125, True), (0.0, False),
                                      (-0.125, False), (float("nan"), False)])
def test_the_kernels_take_only_a_positive_scale(scale, ok):
    """The forward kernel's raw-max route takes only a positive scale (the
    row max of the raw scores is the max of the scaled ones only then);
    every other scale goes to the route that scales first
    (`scales_first`), so the kernels take every scale.  On CPU tensors the
    wrapper's plain version gives softmax(scale * Q K^T) V for each: at 0
    the mean of the live values, at NaN NaN."""
    assert A.scales_first(scale) is (not ok)
    q, k, v, _ = _inputs(40, 2, 2, d=8, device="cpu", dtype=torch.float32)
    A._check_cuda(q, k, v)
    o, lse = A.flash_forward(q, k, v, scale=scale, causal=True, window=None,
                             sink=0)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    if scale != scale:
        assert torch.isnan(o).all()
    else:
        torch.testing.assert_close(o, want)
        torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    if scale == 0:
        counts = torch.arange(1, 41, dtype=torch.float32)[:, None]
        torch.testing.assert_close(o, v.cumsum(2) / counts)


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
    blocks = dict(block_q=block, block_k=block)
    o, lse = A.flash_forward(q, k, v, **blocks, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, **blocks, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **blocks, **opts)
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
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, **DEFAULT, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT,
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
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, **DEFAULT, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT,
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


def _kernels_against_plain(q, k, v, g, blocks, zero=(), short=False,
                           **opts):
    """Each kernel once (one launch each) against its plain version in f32
    on the same inputs, by the rule of the inputs' dtype; the outputs named
    in `zero`, which are zero in exact arithmetic (dq and dk at T 1: a
    softmax over one key has no gradient), only to within ZERO_ABS of 0 on
    both sides, since the rule, relative to the reference, would hold each
    side's rounding against the other's.  With `short`, each launch must
    have been the encoders' kernel's (`attention.short_launches`); above
    head dim 256 each must have been the sliced kernels'
    (`attention.sliced_launches`).  f32 dq and dk/dv, whose products the
    tensor cores sum in an order of their own, are held against the plain
    version in f64: at large logits plain f32's own rounding leaves the f32
    rule against the exact result (tests/test_torch_f32_dkv.py,
    tests/test_torch_f32_dq.py)."""
    dtype = str(q.dtype).removeprefix("torch.")
    before = A.launches()
    short_before = A.short_launches()
    sliced_before = A.sliced_launches()
    o, lse = A.flash_forward(q, k, v, **blocks, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, **blocks, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **blocks, **opts)
    torch.cuda.synchronize()
    assert all(A.launches()[n] == before[n] + 1 for n in before)
    if short:
        assert {n: c - short_before[n]
                for n, c in A.short_launches().items()} == {
            "flash_forward": 1, "flash_backward_dq": 1,
            "flash_backward_dkv": 1}
    assert {n: c - sliced_before[n]
            for n, c in A.sliced_launches().items()} == {
        n: int(q.shape[-1] > 256) for n in before}
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf), **opts)
    ref_in = [x.double() if dtype == "float32" else x
              for x in (qf, kf, vf, gf, lse, delta)]
    dq_ref = A.backward_dq_plain(*ref_in, **opts)
    dk_ref, dv_ref = A.backward_dkv_plain(*ref_in, **opts)
    ratios = {}
    for name, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                           ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert got.shape == ref.shape and got.dtype == q.dtype
        assert torch.isfinite(got).all(), name
        if name in zero:
            ratios[name] = float(got.float().abs().max())
            assert max(ratios[name], float(ref.abs().max())) <= ZERO_ABS
            continue
        ratios[name] = tolerance_ratios(got, ref, rule(dtype)[0])
        assert _held(got, ref, dtype), (name, ratios[name])
    assert float((lse - lse_ref).abs().max()) <= rule(dtype)[2]
    print(f"{dtype} {tuple(q.shape)} {blocks}: {ratios}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,scale,blocks", [
    # each dtype at each head-dim class and the padded route
    ("float16", 64, None, (128, 128)),
    ("float16", 128, None, (64, 64)),
    ("float16", 96, None, (128, 128)),
    ("float16", 100, None, (32, 256)),
    ("float32", 64, None, (128, 128)),
    ("float32", 128, None, (128, 128)),
    ("float32", 100, None, (8, 128)),
    ("float32", 20, None, (128, 128)),
    ("bfloat16", 8, None, (128, 128)),
    ("bfloat16", 32, None, (64, 256)),
    ("bfloat16", 80, None, (128, 128)),
    ("bfloat16", 100, None, (64, 64)),
    ("bfloat16", 120, None, (32, 64)),
    # scales the raw-max route does not take, at both routes' dtypes
    ("bfloat16", 64, -0.125, (128, 128)),
    ("bfloat16", 128, 0.0, (64, 64)),
    ("float16", 64, -1.0, (128, 256)),
    ("float32", 64, -0.125, (128, 128)),
    ("float32", 64, 0.0, (128, 128)),
    # every tile the env can reach at head_dim 64
    ("bfloat16", 64, None, (256, 512)),
    ("bfloat16", 64, None, (8, 128)),
    ("bfloat16", 64, None, (32, 64)),
    ("bfloat16", 64, None, (1024, 1024)),
])
def test_kernels_take_every_dtype_head_dim_scale_and_tile(cuda, dtype, d,
                                                          scale, blocks):
    """Ragged T 1000, GQA 4/2, causal with window 64 and sink 70 (every
    mask the kernels bound), at the inputs the Pallas kernels also take."""
    q, k, v, g = _inputs(1000, 4, 2, d=d, dtype=getattr(torch, dtype))
    _kernels_against_plain(
        q, k, v, g, dict(block_q=blocks[0], block_k=blocks[1]),
        scale=d ** -0.5 if scale is None else scale, causal=True, window=64,
        sink=70)


# the encoders' route (attention.short_route: head-dim class 64, bf16 and
# fp16, T <= 256): every T where a 64-row tile or a 128-key step begins or
# ends, and ViT-B/16's 197
SHORT_TS = (1, 63, 64, 65, 127, 128, 129, 197, 255, 256)
SHORT_MASKS = {"noncausal": dict(causal=False, window=None, sink=0),
               "causal": dict(causal=True, window=None, sink=0),
               "window_sink": dict(causal=True, window=64, sink=70)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("mask", list(SHORT_MASKS))
@pytest.mark.parametrize("t", SHORT_TS)
def test_short_route_matches_plain_versions(cuda, t, mask, dtype):
    """The encoders' forward, dq and dk/dv kernels against their plain
    versions at GQA 12/4 over two batches, at both forward routes (scale
    0.125 and -0.125), with blocks that name other tiles: the route takes
    the encoders' kernels whatever the blocks."""
    q, k, v, g = _inputs(t, 12, 4, dtype=getattr(torch, dtype))
    for scale, blocks in ((0.125, DEFAULT),
                          (-0.125, dict(block_q=32, block_k=64))):
        assert A.resolve_tiles(blocks["block_q"], blocks["block_k"], 64,
                               q.dtype, t) == A.Tiles(**A.SHORT)
        _kernels_against_plain(q, k, v, g, blocks, scale=scale,
                               zero=("dq", "dk") if t == 1 else (),
                               short=True, **SHORT_MASKS[mask])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 20, 32, 40, 64])
def test_short_route_takes_every_head_dim_of_its_class(cuda, d):
    """Head dims 8..64 on the encoders' route at ViT's T 197: the TMA
    boxes' columns past the head dim load as zeros and are not stored (20
    is padded to 24 by the wrapper)."""
    q, k, v, g = _inputs(197, 4, 4, d=d)
    _kernels_against_plain(q, k, v, g, DEFAULT, scale=d ** -0.5,
                           causal=False, window=None, sink=0, short=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv_h,t", [(1, 1, 1, 200), (3, 4, 1, 256),
                                        (200, 2, 2, 128)])
def test_short_route_at_more_and_fewer_heads_than_sms(cuda, b, h, kv_h, t):
    """The persistent grid with one item (a grid of one block), a GQA
    group of 4 in each item, and 400 items over the card's SMs (each block
    walking several, both stages of its ring in turn)."""
    q, k, v, g = _inputs(t, h, kv_h, b=b)
    _kernels_against_plain(q, k, v, g, DEFAULT, scale=0.125, causal=False,
                           window=None, sink=0, short=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("scale", [0.0, -1.0, 1.0])
def test_short_route_takes_any_scale(cuda, scale, dtype):
    """Scales 0 (dq and dk exactly zero, held exactly), -1 and 1 on the
    encoders' route at T 197, causal with a window and a sink over GQA
    12/4: p = exp(s * scale - lse) at any scale in dq and dk/dv, and the
    forward's route that scales the scores first."""
    q, k, v, g = _inputs(197, 12, 4, dtype=getattr(torch, dtype))
    _kernels_against_plain(q, k, v, g, DEFAULT, scale=scale, causal=True,
                           window=64, sink=70, short=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,scale,blocks", [
    # each tile of the 256 class in bf16 and fp16, the f32 kernels, both
    # forward routes, and head dims across the class (250 padded to 256)
    ("bfloat16", 256, None, (128, 128)),
    ("bfloat16", 256, None, (64, 64)),
    ("float16", 256, None, (128, 128)),
    ("float16", 256, None, (32, 64)),
    ("float32", 256, None, (128, 128)),
    ("bfloat16", 256, -0.0625, (128, 128)),
    ("float16", 256, 0.0, (64, 64)),
    ("float32", 256, -0.0625, (128, 128)),
    ("bfloat16", 136, None, (128, 128)),
    ("bfloat16", 160, None, (64, 64)),
    ("float16", 192, None, (128, 128)),
    ("bfloat16", 250, None, (128, 128)),
    ("float32", 250, None, (128, 128)),
])
def test_kernels_take_head_dims_up_to_256(cuda, dtype, d, scale, blocks):
    """Ragged T 1000, GQA 8:1 (Gemma 2B's 8 query heads over one KV head),
    causal with window 64 and sink 70, at head dims 129-256: the head-dim
    class 256 (dk/dv split over two warpgroups; f32 with four threads a
    row in dk/dv)."""
    q, k, v, g = _inputs(1000, 8, 1, d=d, b=1, dtype=getattr(torch, dtype))
    _kernels_against_plain(
        q, k, v, g, dict(block_q=blocks[0], block_k=blocks[1]),
        scale=d ** -0.5 if scale is None else scale, causal=True, window=64,
        sink=70)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
def test_kernels_at_gemma_2b_attention_shape(cuda, causal):
    """Gemma 2B's attention (8 query heads of 256 over one KV head) at T
    2048, B 1, bf16, on the default blocks: every query head of the group
    summed into the one KV head's dk/dv."""
    q, k, v, g = _inputs(2048, 8, 1, d=256, b=1)
    _kernels_against_plain(q, k, v, g, DEFAULT, scale=256 ** -0.5,
                           causal=causal, window=None, sink=0)


@pytest.mark.cuda
def test_every_head_dim_256_instantiation_holds(cuda):
    """Each instantiation of the 256 class (bf16, fp16 and f32; every tile
    INSTANTIATED lists; both forward routes) against its plain version at
    T 300, GQA 4/2, causal with window 64 and sink 70."""
    reached = set()
    for dtype in ("bfloat16", "float16", "float32"):
        for blocks in ((64, 64), (128, 128)):
            for scale in (256 ** -0.5, -256 ** -0.5):
                q, k, v, g = _inputs(300, 4, 2, d=256, b=1,
                                     dtype=getattr(torch, dtype))
                _kernels_against_plain(
                    q, k, v, g, dict(block_q=blocks[0], block_k=blocks[1]),
                    scale=scale, causal=True, window=64, sink=70)
                tiles = A.resolve_tiles(*blocks, 256, getattr(torch, dtype))
                reached.update((kernel, dtype, 256, *getattr(tiles, kernel))
                               for kernel in ("fwd", "dq", "dkv"))
    assert reached == {x for x in A.instantiations() if x[2] == 256}


_D256_CASES = [c for c in CASES
               if 128 < c.d <= 256 and c.dtype != "float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _D256_CASES, ids=[c.name for c in
                                                    _D256_CASES])
def test_kernels_at_chip_smoke_head_dim_256_cases(cuda, case):
    """chip_smoke's kernel cases of the 256 class in bf16 and fp16 (Gemma
    2B's shape, non-causal, window + sink, a negative scale over GQA 8/2,
    head dims 160 and 250, and 6 query heads over one KV head, whose dk/dv
    splits its heads over 5 slices), each kernel against its plain version
    and launched twice for the same bits, as the kernels phase runs them."""
    result = kernel_case(case, timing=False)
    assert set(result) == {"flash_forward", "flash_backward_dq",
                           "flash_backward_dkv"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", _D256_CASES, ids=[c.name for c in
                                                    _D256_CASES])
def test_the_head_dim_256_forward_at_chip_smoke_cases(cuda, case):
    """The forward alone at each of those cases: o and lse against the
    plain version by rule(dtype), the same bits from a second launch, and
    the kernel that ran (profiler) fwd_kernel (over 128 rows its grid
    longest first across the b*h rows of a chunk, attention.fwd_chunk)."""
    from chip_smoke import profiled_events

    dtype = getattr(torch, case.dtype)
    q, k, v, _ = _inputs(case.t, case.h, case.hkv, d=case.d, b=case.b,
                         dtype=dtype)
    scale = case.d ** -0.5 if case.scale is None else case.scale
    opts = dict(scale=scale, causal=case.causal, window=case.window,
                sink=case.sink)
    blocks = dict(block_q=case.blocks[0], block_k=case.blocks[1])
    o, lse = A.flash_forward(q, k, v, **blocks, **opts)
    again = A.flash_forward(q, k, v, **blocks, **opts)
    torch.cuda.synchronize()
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf), **opts)
    assert _held(o, o_ref, case.dtype), tolerance_ratios(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= rule(case.dtype)[2]
    for _ in range(3):  # the profiler drops a cycle's device events at times
        names = {e["name"] for e in profiled_events(
            lambda: A.flash_forward(q, k, v, **blocks, **opts))}
        if names:
            break
    assert any("fwd_kernel" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv_h,causal", [
    (1, 3, 3, True), (2, 3, 3, False), (1, 6, 2, True), (1, 2, 1, True)],
    ids=["mha_odd_heads", "mha_noncausal", "group_3", "group_2"])
def test_the_wide_forward_at_other_groupings(cuda, b, h, kv_h, causal):
    """The forward over 128 rows beside the chip_smoke cases' groups of 6
    and 8: one head a KV head (an odd b*h), a group of 3 and of 2, each
    against its plain version by the kernel rule, at a ragged T."""
    q, k, v, _ = _inputs(1000, h, kv_h, d=256, b=b)
    opts = dict(scale=256 ** -0.5, causal=causal, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf), **opts)
    assert _held(o, o_ref), tolerance_ratios(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_flash_attention_lse_at_chip_smoke_gemma_case(cuda):
    """The lse phase's case of the 256 class (8 query heads over one KV
    head, T 1024, causal: dk/dv in 5 slices)."""
    (case,) = [c for c in LSE_CASES if c[0] == "d256_gqa8_causal"]
    ratios = lse_case(case)
    assert max(ratios[key] for key in ("o", "dq", "dk", "dv")) <= 1.0


# above head dim 256: the sliced kernels (attention.SLICED), each dtype
# at head dims 264 (a last slice of one 64-column block), 512 and 1024
# (four slices)
_SLICED_DTYPES = [("bfloat16", 264), ("bfloat16", 512), ("float16", 512),
                  ("float32", 512), ("bfloat16", 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [None, 0.0, -1.0],
                         ids=["scale_default", "scale_0", "scale_-1"])
@pytest.mark.parametrize("dtype,d", _SLICED_DTYPES,
                         ids=[f"{t}_d{d}" for t, d in _SLICED_DTYPES])
def test_sliced_kernels_match_plain_versions(cuda, dtype, d, scale):
    """The sliced forward, dq and dk/dv (every launch theirs) against
    their plain versions at ragged T 300, GQA 4/2, causal with window 64
    and sink 70, at d ** -0.5, 0 (dq and dk zero: held exactly) and -1
    (the forward's scaled route); the blocks map onto their one tile."""
    q, k, v, g = _inputs(300, 4, 2, d=d, b=1, dtype=getattr(torch, dtype))
    _kernels_against_plain(
        q, k, v, g, DEFAULT, scale=d ** -0.5 if scale is None else scale,
        causal=True, window=64, sink=70)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
def test_sliced_kernels_at_the_wide_head_attention(cuda, causal):
    """The wide_head phase's attention (4 query heads of 512 over one KV
    head) at T 2048, B 1, bf16: every query head of the group summed into
    the one KV head's dk/dv inside each block."""
    q, k, v, g = _inputs(2048, 4, 1, d=512, b=1)
    _kernels_against_plain(q, k, v, g, DEFAULT, scale=512 ** -0.5,
                           causal=causal, window=None, sink=0)


_SLICED_CASES = [c for c in CASES if c.d > 256 and c.dtype != "float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SLICED_CASES,
                         ids=[c.name for c in _SLICED_CASES])
def test_kernels_at_chip_smoke_sliced_cases(cuda, case):
    """chip_smoke's kernel cases above head dim 256 in bf16 and fp16, each
    kernel against its plain version and launched twice for the same
    bits, as the kernels phase runs them; every dq and dk/dv launch the
    cluster kernels' up to CLUSTER_LD (d512_mqa, the wide_head phase's
    attention, among them), none above (d2112)."""
    result, ran, cluster = _launched(lambda: kernel_case(case, timing=False))
    assert set(result) == {"flash_forward", "flash_backward_dq",
                           "flash_backward_dkv"}
    on_route = A.cluster_route(case.d, getattr(torch, case.dtype))
    assert all(n >= 2 for n in ran.values())
    assert cluster == {n: c * on_route for n, c in ran.items()}


@pytest.mark.cuda
def test_flash_attention_lse_at_chip_smoke_wide_head_case(cuda):
    """The lse phase's case above head dim 256 (4 query heads of 512 over
    one KV head, T 1024, causal)."""
    (case,) = [c for c in LSE_CASES if c[0] == "d512_gqa4_causal"]
    ratios = lse_case(case)
    assert max(ratios[key] for key in ("o", "dq", "dk", "dv")) <= 1.0


def _launched(fn):
    """(fn(), dq's and dk/dv's launches in it, the cluster kernels')."""
    before, cluster = A.launches(), A.cluster_launches()
    out = fn()
    torch.cuda.synchronize()
    return (out, {n: A.launches()[n] - before[n] for n in cluster},
            {n: c - cluster[n] for n, c in A.cluster_launches().items()})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cluster_kernels_repeat_bit_for_bit_at_d512_mqa(cuda, dtype):
    """Two runs of dq and of dk/dv at the wide_head phase's attention (B 4,
    4 query heads of 512 over one KV head, T 2048, causal) give the same
    bits: each sum is taken in one order by one block (no atomics)."""
    q, k, v, g = _inputs(2048, 4, 1, d=512, b=4, dtype=getattr(torch, dtype))
    opts = dict(scale=512 ** -0.5, causal=True, window=None, sink=0,
                **DEFAULT)
    o, lse = A.flash_forward(q, k, v, **opts)
    delta = (g.float() * o.float()).sum(-1)

    def run():
        return (A.flash_backward_dq(q, k, v, g, lse, delta, **opts),
                *A.flash_backward_dkv(q, k, v, g, lse, delta, **opts))

    first, ran, cluster = _launched(run)
    second = run()
    torch.cuda.synchronize()
    assert ran == cluster == {"flash_backward_dq": 1,
                              "flash_backward_dkv": 1}
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cluster_kernels_build_without_spills(cuda, tmp_path):
    """ptxas's report of a build: every cluster kernel (dq and dk/dv, bf16
    and fp16, two to four slices) is there and spills nothing."""
    log = _build.build_log or _build.nvcc(_build.SOURCE,
                                          tmp_path / "libfa.so")
    cluster = [r for r in ptxas_report(log) if "_cluster_" in r[0]]
    print("\n".join(f"{r[0]}: {r[1]} registers at launch, {r[2]}/{r[3]} "
                    "bytes spilled" for r in cluster))
    assert len(cluster) == 2 * 2 * 3
    assert all(r[2] == r[3] == 0 for r in cluster)


@pytest.mark.cuda
def test_tolerance_rejects_a_cluster_without_a_partners_partial(
        cuda, tmp_path, monkeypatch):
    """The cluster kernels built with a planted fault (the owner of each
    tile's first 16 rows leaves slice 1's partial out of its sum of S and
    dP, or S^T and dP^T) at two slices: dq, dk and dv fail the
    tolerance."""
    site = "v[e] = s == 0 ? x : v[e] + x;"
    _faulty_library(tmp_path, monkeypatch, site,
                    "v[e] = s == 0 ? x : s == 1 && w == 0 ? v[e] : v[e] + x;")
    q, k, v, g = _inputs(512, 4, 1, d=512, b=1)
    opts = dict(scale=512 ** -0.5, causal=True, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, **opts, **DEFAULT)
    delta = (g.float() * o.float()).sum(-1)
    (dq, dk, dv), _, cluster = _launched(lambda: (
        A.flash_backward_dq(q, k, v, g, lse, delta, **opts, **DEFAULT),
        *A.flash_backward_dkv(q, k, v, g, lse, delta, **opts, **DEFAULT)))
    assert all(n == 1 for n in cluster.values())
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    refs = (A.backward_dq_plain(qf, kf, vf, gf, lse, delta, **opts),
            *A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        worst, rel = tolerance_ratios(got, ref)
        print(f"planted cluster fault: {name} worst err/limit {worst:.1f}, "
              f"relative Frobenius {rel:.3e}")
        assert not _held(got, ref), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dq_and_dkv_above_the_cluster_reach_take_the_sliced_kernels(
        cuda, dtype):
    """Head dim 2112 (nine slices, above CLUSTER_LD): dq and dk/dv run on
    the sliced kernels (no cluster launch) and hold against their plain
    versions."""
    q, k, v, g = _inputs(300, 2, 1, d=2112, b=1, dtype=getattr(torch, dtype))
    _, ran, cluster = _launched(lambda: _kernels_against_plain(
        q, k, v, g, DEFAULT, scale=2112 ** -0.5, causal=True, window=None,
        sink=0))
    assert ran == {"flash_backward_dq": 1, "flash_backward_dkv": 1}
    assert cluster == {"flash_backward_dq": 0, "flash_backward_dkv": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_pair_forward_repeats_bit_for_bit_at_d512_mqa(cuda, dtype):
    """Two runs of the forward at the wide_head phase's attention (B 4, 4
    query heads of 512 over one KV head, T 2048, causal) are the pair
    kernel's (`attention.pair_launches`) and give the same bits: both
    warpgroups sum warpgroup 0's partial S + warpgroup 1's."""
    q, k, v, _ = _inputs(2048, 4, 1, d=512, b=4, dtype=getattr(torch, dtype))
    opts = dict(scale=512 ** -0.5, causal=True, window=None, sink=0,
                **DEFAULT)
    before = A.pair_launches()["flash_forward"]
    first = A.flash_forward(q, k, v, **opts)
    second = A.flash_forward(q, k, v, **opts)
    torch.cuda.synchronize()
    assert A.pair_launches()["flash_forward"] == before + 2
    for name, a, b in zip(("o", "lse"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 520), ("float16", 1024),
                                     ("float32", 512)])
def test_forward_off_the_pair_route_takes_the_sliced_kernel(cuda, dtype, d):
    """Above PAIR_LD, and in f32, the forward runs on the sliced kernels
    (no pair launch) and holds against its plain version."""
    q, k, v, g = _inputs(300, 4, 2, d=d, b=1, dtype=getattr(torch, dtype))
    before = A.pair_launches()
    _kernels_against_plain(q, k, v, g, DEFAULT, scale=d ** -0.5, causal=True,
                           window=64, sink=70)
    assert A.pair_launches() == before


@pytest.mark.cuda
def test_pair_forward_builds_without_spills(cuda, tmp_path):
    """ptxas's report of a build: the pair forward (bf16 and fp16, both
    scale routes) is there and spills nothing."""
    log = _build.build_log or _build.nvcc(_build.SOURCE,
                                          tmp_path / "libfa.so")
    pair = [r for r in ptxas_report(log) if r[4][2] == A.PAIR]
    print("\n".join(f"{r[0]}: {r[1]} registers at launch, {r[2]}/{r[3]} "
                    "bytes spilled" for r in pair))
    assert len(pair) == 2 * 2
    assert all(r[2] == r[3] == 0 for r in pair)


@pytest.mark.cuda
def test_tolerance_rejects_a_pair_without_the_other_partial(
        cuda, tmp_path, monkeypatch):
    """The pair forward built with a planted fault (warpgroup 0's first
    warp leaves warpgroup 1's partial S out of its sum, rows 0-15 of each
    tile) at head dim 512: o and lse fail the tolerance."""
    site = "v = wg == 0 ? v + x : x + v;"
    _faulty_library(tmp_path, monkeypatch, site,
                    "v = wg == 0 ? v + (warp == 0 ? 0.f : x) : x + v;")
    q, k, v, _ = _inputs(512, 4, 1, d=512, b=1)
    opts = dict(scale=512 ** -0.5, causal=True, window=None, sink=0)
    before = A.pair_launches()["flash_forward"]
    o, lse = A.flash_forward(q, k, v, **opts, **DEFAULT)
    torch.cuda.synchronize()
    assert A.pair_launches()["flash_forward"] == before + 1
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf), **opts)
    worst, rel = tolerance_ratios(o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    print(f"planted pair fault: o worst err/limit {worst:.1f}, relative "
          f"Frobenius {rel:.3e}; lse max_abs_err {lse_err:.3e}")
    assert not _held(o, o_ref) and lse_err > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("h,kv_h", [(8, 1), (12, 4), (6, 1)])
def test_dkv_holds_at_every_split_of_the_group(cuda, monkeypatch, dtype, h,
                                               kv_h):
    """dk/dv at head dim 256 with each KV head's query heads split over
    every count of slices from 1 (dk and dv written directly) to the group
    (one head a slice), dividing it or not (8 over 3, 5, 6, 7; 3 over 2; 6
    over 4 and 5), at ragged T 300 with window 64 and sink 70: within the
    rule, and one launch of the reduce per split launch; the kernel refuses
    more slices than heads."""
    q, k, v, g = _inputs(300, h, kv_h, d=256, b=2,
                         dtype=getattr(torch, dtype))
    opts = dict(scale=256 ** -0.5, causal=True, window=64, sink=70)
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    delta = (g.float() * o.float()).sum(-1)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    refs = A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts)
    for splits in range(1, h // kv_h + 1):
        monkeypatch.setattr(A, "dkv_splits", lambda *args, n=splits: n)
        before = A.dkv_reduce.launches
        got = A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT,
                                   **opts)
        torch.cuda.synchronize()
        assert A.dkv_reduce.launches == before + (splits > 1)
        for name, x, ref in zip(("dk", "dv"), got, refs):
            assert x.dtype == q.dtype and torch.isfinite(x).all()
            assert _held(x, ref, dtype), (splits, name,
                                          tolerance_ratios(x, ref))
    monkeypatch.setattr(A, "dkv_splits", lambda *args: h // kv_h + 1)
    with pytest.raises(RuntimeError, match="dk/dv kernel launch failed"):
        A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT, **opts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("splits,shape", [(2, (1, 1, 300, 256)),
                                          (3, (4, 1, 2048, 256)),
                                          (8, (2, 2, 64, 136))])
def test_dkv_reduce_matches_a_plain_f32_sum(cuda, dtype, splits, shape):
    """The reduce kernel against its plain version (the slices summed in
    order in f32, dk times scale, one rounding to the element type): the
    same bits, and within f32 rounding of torch's own sum over the slices;
    the workspace shapes of Gemma 2B's dk/dv and of small and padded ones."""
    gen = torch.Generator(device="cuda").manual_seed(splits)
    ws = torch.randn(2, splits, *shape, generator=gen, device="cuda")
    dt = getattr(torch, dtype)
    before = A.dkv_reduce.launches
    dk, dv = A.dkv_reduce(ws, 0.0625, dt)
    torch.cuda.synchronize()
    assert A.dkv_reduce.launches == before + 1
    want = A.dkv_reduce_plain(ws, 0.0625, dt)
    assert torch.equal(dk, want[0]) and torch.equal(dv, want[1])
    total = ws.sum(1)
    torch.testing.assert_close(dk.float(), (total[0] * 0.0625).to(dt).float(),
                               rtol=1e-2, atol=1e-5)
    torch.testing.assert_close(dv.float(), total[1].to(dt).float(),
                               rtol=1e-2, atol=1e-4)
    with pytest.raises(ValueError, match="dkv_reduce takes"):
        A.dkv_reduce(ws, 0.0625, torch.float64)


# ---------------------------------------------------------------------------
# f32 dk/dv on the tensor cores (dkv_tf32_kernel, every f32 launch)

_F32_CASES = [c for c in CASES if c.dtype == "float32"]


def _f32_dkv(q, k, v, g, **opts):
    """(dk, dv) of two launches of f32 dk/dv on the same inputs, their
    plain version's in f64, and the launches among the two."""
    o, lse = A.flash_forward(q, k, v, **opts, **DEFAULT)
    delta = (g * o).sum(-1)
    before = A.launches()["flash_backward_dkv"]
    first = A.flash_backward_dkv(q, k, v, g, lse, delta, **opts, **DEFAULT)
    second = A.flash_backward_dkv(q, k, v, g, lse, delta, **opts, **DEFAULT)
    torch.cuda.synchronize()
    launched = A.launches()["flash_backward_dkv"] - before
    refs = A.backward_dkv_plain(
        *(x.double() for x in (q, k, v, g, lse, delta)), **opts)
    return first, second, refs, launched


@pytest.mark.cuda
def test_f32_dkv_holds_at_every_f32_instantiation(cuda):
    """f32 dk/dv at every head dim of chip_smoke.every_instantiation's f32
    runs (T 300, B 1, 4 query heads over 2 KV heads, causal with window 64
    and sink 70; both signs of the scale at the classes and at 300): on
    the tensor-core kernel up to TF32_LD (classes 64, 128, 256 with its
    heads split, its cluster at 2, 4 and 8 slices) and its streamed slices
    above (2056), each against its plain version in f64 by the f32 rule,
    two launches the same bits; every f32 dk/dv instantiation reached."""
    reached = set()
    for d, sign in [(64, 1), (64, -1), (128, 1), (128, -1), (256, 1),
                    (256, -1), (300, 1), (300, -1), (1000, 1), (2048, 1),
                    (2056, 1)]:
        q, k, v, g = _inputs(300, 4, 2, d=d, b=1, seed=d,
                             dtype=torch.float32)
        first, second, refs, launched = _f32_dkv(
            q, k, v, g, scale=sign * d ** -0.5, causal=True, window=64,
            sink=70)
        assert launched == 2
        for name, a, b, ref in zip(("dk", "dv"), first, second, refs):
            assert torch.equal(a, b), (d, name)
            assert _held(a, ref, "float32"), (
                d, sign, name, tolerance_ratios(a, ref, rule("float32")[0]))
        tiles = A.resolve_tiles(128, 128, d, torch.float32, 300)
        reached.add(("dkv", "float32", A.route("dkv", d, torch.float32),
                     *tiles.dkv))
    assert reached == {x for x in A.instantiations()
                       if x[:2] == ("dkv", "float32")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", _F32_CASES, ids=[c.name for c in
                                                   _F32_CASES])
def test_f32_dkv_at_chip_smoke_f32_cases(cuda, case):
    """chip_smoke's f32 kernel cases (main_f32, gemma_2b_f32 with its
    query heads split, d512_mqa_f32 on the cluster), each kernel against
    its plain version by the f32 rule (dq and dk/dv in f64) and launched
    twice for the same bits as the kernels phase runs them; dq and dk/dv
    on the tensor cores, on their clusters at d512_mqa_f32."""
    result, ran, cluster = _launched(lambda: kernel_case(case,
                                                         timing=False))
    assert set(result) == {"flash_forward", "flash_backward_dq",
                           "flash_backward_dkv"}
    assert ran == {"flash_backward_dq": 2, "flash_backward_dkv": 2}
    assert cluster == {n: c * (case.d > A.SLICE) for n, c in ran.items()}


@pytest.mark.cuda
def test_f32_dkv_builds_without_spills(cuda, tmp_path):
    """ptxas's report of a build: f32 dk/dv on the tensor cores (the three
    head-dim classes, the cluster and the streamed slices) is there and
    spills nothing."""
    log = _build.build_log or _build.nvcc(_build.SOURCE,
                                          tmp_path / "libfa.so")
    tf32 = [r for r in ptxas_report(log) if r[0].startswith("dkv_tf32")]
    print("\n".join(f"{r[0]}: {r[1]} registers at launch, {r[2]}/{r[3]} "
                    "bytes spilled" for r in tf32))
    assert {r[4][2] for r in tf32} == {64, 128, 256, A.CLUSTER, A.SLICED}
    assert all(r[2] == r[3] == 0 for r in tf32)


@pytest.mark.cuda
def test_f32_rule_rejects_dkv_in_one_tf32_pass(cuda, tmp_path, monkeypatch):
    """f32 dk/dv built with a planted fault, every product in one TF32
    pass (kernel_variants.py's one_pass edit): dk and dv leave the f32
    rule at head dims 64 (class 64), 256 (split) and 512 (the cluster)."""
    from kernel_variants import F32_VARIANTS

    (site, fault), = F32_VARIANTS["one_pass"]
    _faulty_library(tmp_path, monkeypatch, site, fault)
    for h, kv_h, d in ((4, 4, 64), (8, 1, 256), (4, 1, 512)):
        q, k, v, g = _inputs(1024, h, kv_h, d=d, b=1, dtype=torch.float32)
        first, _, refs, launched = _f32_dkv(q, k, v, g, scale=d ** -0.5,
                                            causal=True, window=None, sink=0)
        assert launched == 2
        for name, got, ref in zip(("dk", "dv"), first, refs):
            worst, rel = tolerance_ratios(got, ref, rule("float32")[0])
            print(f"one TF32 pass at D {d}: {name} worst err/limit "
                  f"{worst:.1f}, relative Frobenius {rel:.3e}")
            assert not _held(got, ref, "float32"), (d, name)


def _f32_dq(q, k, v, g, **opts):
    """(two launches of f32 dq on the same inputs, its plain version's in
    f64, dq's launches and its cluster launches among the two)."""
    o, lse = A.flash_forward(q, k, v, **opts, **DEFAULT)
    delta = (g * o).sum(-1)

    def run():
        return (A.flash_backward_dq(q, k, v, g, lse, delta, **opts,
                                    **DEFAULT),
                A.flash_backward_dq(q, k, v, g, lse, delta, **opts,
                                    **DEFAULT))

    (first, second), ran, cluster = _launched(run)
    ref = A.backward_dq_plain(
        *(x.double() for x in (q, k, v, g, lse, delta)), **opts)
    return first, second, ref, ran["flash_backward_dq"], cluster[
        "flash_backward_dq"]


@pytest.mark.cuda
def test_f32_dq_holds_at_every_f32_instantiation(cuda):
    """f32 dq at every head dim of chip_smoke.every_instantiation's f32
    runs (T 300, B 1, 4 query heads over 2 KV heads, causal with window 64
    and sink 70; both signs of the scale at the classes and at 300): on
    the tensor-core kernel at the classes 64, 128 and 256, its cluster at
    2, 4 and 8 slices and its streamed slices above TF32_LD (2056), each
    against its plain version in f64 by the f32 rule, two launches the same
    bits, the cluster's launches counted; every f32 dq instantiation
    reached."""
    reached = set()
    for d, sign in [(64, 1), (64, -1), (128, 1), (128, -1), (256, 1),
                    (256, -1), (300, 1), (300, -1), (1000, 1), (2048, 1),
                    (2056, 1)]:
        q, k, v, g = _inputs(300, 4, 2, d=d, b=1, seed=d,
                             dtype=torch.float32)
        first, second, ref, launched, clustered = _f32_dq(
            q, k, v, g, scale=sign * d ** -0.5, causal=True, window=64,
            sink=70)
        assert launched == 2
        assert clustered == 2 * (A.SLICE < d <= A.TF32_LD)
        assert torch.equal(first, second), d
        assert _held(first, ref, "float32"), (
            d, sign, tolerance_ratios(first, ref, rule("float32")[0]))
        tiles = A.resolve_tiles(128, 128, d, torch.float32, 300)
        reached.add(("dq", "float32", A.route("dq", d, torch.float32),
                     *tiles.dq))
    assert reached == {x for x in A.instantiations()
                       if x[:2] == ("dq", "float32")}


@pytest.mark.cuda
def test_f32_dq_builds_without_spills(cuda, tmp_path):
    """ptxas's report of a build: f32 dq on the tensor cores (the three
    head-dim classes, the cluster and the streamed slices) is there and
    spills nothing, and no SIMT dq is left."""
    log = _build.build_log or _build.nvcc(_build.SOURCE,
                                          tmp_path / "libfa.so")
    report = ptxas_report(log)
    tf32 = [r for r in report if r[0].startswith("dq_tf32")]
    print("\n".join(f"{r[0]}: {r[1]} registers at launch, {r[2]}/{r[3]} "
                    "bytes spilled" for r in tf32))
    assert {r[4][2] for r in tf32} == {64, 128, 256, A.CLUSTER, A.SLICED}
    assert all(r[2] == r[3] == 0 for r in tf32)
    assert not [r for r in report if r[0].startswith("dq_") and
                r[4][1] == "float32" and "tf32" not in r[0]]


@pytest.mark.cuda
def test_f32_rule_rejects_dq_in_one_tf32_pass(cuda, tmp_path, monkeypatch):
    """f32 dq built with a planted fault, every product in one TF32 pass
    (kernel_variants.py's one_pass edit): dq leaves the f32 rule at head
    dims 64 (class 64), 256 and 512 (the cluster)."""
    from kernel_variants import F32_VARIANTS

    (site, fault), = F32_VARIANTS["one_pass"]
    _faulty_library(tmp_path, monkeypatch, site, fault)
    for h, kv_h, d in ((4, 4, 64), (8, 1, 256), (4, 1, 512)):
        q, k, v, g = _inputs(1024, h, kv_h, d=d, b=1, dtype=torch.float32)
        first, _, ref, launched, _ = _f32_dq(q, k, v, g, scale=d ** -0.5,
                                             causal=True, window=None,
                                             sink=0)
        assert launched == 2
        worst, rel = tolerance_ratios(first, ref, rule("float32")[0])
        print(f"one TF32 pass at D {d}: dq worst err/limit {worst:.1f}, "
              f"relative Frobenius {rel:.3e}")
        assert not _held(first, ref, "float32"), d


@pytest.mark.cuda
def test_f32_rule_rejects_dq_without_its_refinement(cuda, tmp_path,
                                                    monkeypatch):
    """f32 dq built without its heavy elements' compensated dP
    (kernel_variants.py's no_refine edit) leaves the f32 rule against the
    plain version in f64 at scale -1 (T 300, 4 query heads over 2 KV
    heads, window 64 + sink 70, head dim 512: the sliced test's case that
    the refined kernel holds), its relative Frobenius error within the
    rule: what the refinement repairs is the heavy elements alone."""
    from kernel_variants import F32_VARIANTS

    (site, fault), = F32_VARIANTS["no_refine"]
    _faulty_library(tmp_path, monkeypatch, site, fault)
    q, k, v, g = _inputs(300, 4, 2, d=512, b=1, dtype=torch.float32)
    first, second, ref, launched, _ = _f32_dq(q, k, v, g, scale=-1.0,
                                              causal=True, window=64,
                                              sink=70)
    assert launched == 2 and torch.equal(first, second)
    worst, rel = tolerance_ratios(first, ref, rule("float32")[0])
    print(f"dq without its refinement at scale -1, D 512: worst err/limit "
          f"{worst:.3f}, relative Frobenius {rel:.3e}")
    assert worst > 1.0 and rel <= rule("float32")[1]


@pytest.mark.cuda
def test_kernels_take_more_batch_heads_than_a_grid_y(cuda):
    """B 4400 x H 16 = 70,400 rows of the grid's x (the y dimension, which
    held batch*heads before, stops at 65,535)."""
    q, k, v, g = _inputs(64, 16, 16, b=4400)
    _kernels_against_plain(q, k, v, g, DEFAULT, scale=0.125, causal=True,
                           window=None, sink=0)


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
    site = "hopper::Mma<E>::rs64(acc[h], pa[kk]"
    _faulty_library(tmp_path, monkeypatch, site,
                    "if (it > 0 || kk > 0 || q0 + BM < T) " + site)

    q, k, v, _ = _inputs(2048, 12, 12, b=8)
    o, lse = A.flash_forward(q, k, v, scale=0.125, causal=True, window=None,
                             sink=0, **DEFAULT)
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
def test_tolerance_rejects_a_short_forward_that_skips_the_ragged_key_tile(
        cuda, tmp_path, monkeypatch):
    """The encoders' forward built with a planted fault (the P.V product of
    the ragged last key tile, keys 128..196, skipped; m, l and lse
    untouched) at ViT-B/16's T 197 over 8 x 12 heads: o fails the
    tolerance while lse still passes."""
    site = "hopper::Mma<E>::rs64(acc, pa[kk]"
    _faulty_library(tmp_path, monkeypatch, site, "if (k0 < 128) " + site)

    q, k, v, _ = _inputs(197, 12, 12, b=8)
    o, lse = A.flash_forward(q, k, v, scale=0.125, causal=False,
                             window=None, sink=0, **DEFAULT)
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = A.attention_lse(qf, kf, vf, causal=False, scale=0.125)
    worst, rel = tolerance_ratios(o, o_ref)
    print(f"planted short forward fault: o worst err/limit {worst:.3f}, "
          f"relative Frobenius {rel:.3e}")
    assert A.short_route(64, 197, q.dtype)
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    assert not _held(o, o_ref)


@pytest.mark.cuda
def test_tolerance_rejects_a_short_dkv_that_skips_the_last_query_chunk(
        cuda, tmp_path, monkeypatch):
    """The encoders' dk/dv built with a planted fault (the dV product of
    the ragged last query chunk, queries 192..196, skipped; dK untouched)
    at ViT-B/16's T 197: dv fails the tolerance, dk still passes."""
    site = "hopper::Mma<E>::rs64(dv_acc, pa[kk]"
    _faulty_library(tmp_path, monkeypatch, site,
                    "if (q0 + NQ <= mk.T) " + site)

    q, k, v, g = _inputs(197, 12, 12, b=8)
    opts = dict(scale=0.125, causal=False, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT,
                                  **opts)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    dk_ref, dv_ref = A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts)
    worst, rel = tolerance_ratios(dv, dv_ref)
    print(f"planted short dk/dv fault: dv worst err/limit {worst:.3f}, "
          f"relative Frobenius {rel:.3e}")
    assert _held(dk, dk_ref), tolerance_ratios(dk, dk_ref)
    assert not _held(dv, dv_ref)


@pytest.mark.cuda
def test_tolerance_rejects_a_short_dq_that_skips_the_ragged_key_tile(
        cuda, tmp_path, monkeypatch):
    """The encoders' dq built with a planted fault (the dS.K product of
    the ragged key tile's last sub-step, keys 192..196, skipped) at
    ViT-B/16's T 197 over 8 x 12 heads: dq fails the tolerance while dk
    and dv (another kernel) still pass."""
    site = "hopper::Mma<E>::rs64(dq_acc, da[kk]"
    _faulty_library(tmp_path, monkeypatch, site,
                    "if (k0 + N <= mk.T) " + site)

    q, k, v, g = _inputs(197, 12, 12, b=8)
    opts = dict(scale=0.125, causal=False, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    delta = (g.float() * o.float()).sum(-1)
    before = A.short_launches()["flash_backward_dq"]
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, **DEFAULT, **opts)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT,
                                  **opts)
    assert A.short_launches()["flash_backward_dq"] == before + 1
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    dq_ref = A.backward_dq_plain(qf, kf, vf, gf, lse, delta, **opts)
    dk_ref, dv_ref = A.backward_dkv_plain(qf, kf, vf, gf, lse, delta, **opts)
    worst, rel = tolerance_ratios(dq, dq_ref)
    print(f"planted short dq fault: dq worst err/limit {worst:.3f}, "
          f"relative Frobenius {rel:.3e}")
    assert _held(dk, dk_ref) and _held(dv, dv_ref)
    assert not _held(dq, dq_ref)


@pytest.mark.cuda
def test_tolerance_rejects_a_wide_forward_that_skips_a_late_tile(
        cuda, tmp_path, monkeypatch):
    """The forward at head-dim class 256 over 128 rows (its grid longest
    first) built with the same planted fault (the P.V product of the first
    16 keys skipped for the last query tile) at Gemma 2B's attention, B 1:
    o fails the tolerance, lse still passes."""
    site = "hopper::Mma<E>::rs64(acc[h], pa[kk]"
    _faulty_library(tmp_path, monkeypatch, site,
                    "if (it > 0 || kk > 0 || q0 + BM < T) " + site)

    q, k, v, _ = _inputs(2048, 8, 1, d=256, b=1)
    o, lse = A.flash_forward(q, k, v, scale=256 ** -0.5, causal=True,
                             window=None, sink=0, **DEFAULT)
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf),
                                     causal=True, scale=256 ** -0.5)
    worst, rel = tolerance_ratios(o, o_ref)
    print(f"planted wide forward fault: o worst err/limit {worst:.3f}, "
          f"relative Frobenius {rel:.3e}")
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    assert not _held(o, o_ref)


@pytest.mark.cuda
def test_tolerance_rejects_a_sliced_forward_that_skips_the_last_chunk(
        cuda, tmp_path, monkeypatch):
    """The sliced forward built with a planted fault (S = Q K^T summed
    over every 64-column chunk of the head dim but the last) at 4 query
    heads of 1024 over one KV head (above the pair forward's reach, where
    the sliced forward runs), B 1, T 1024: o and lse both fail."""
    site = ("hopper::Mma<E>::ss(s_tile, hopper::desc_k(at + wg * 64 * 128, "
            "64, kk),\n                           hopper::desc_k(at + "
            "S::Q_BYTES, BK, kk),")
    _faulty_library(tmp_path, monkeypatch, site, "if (c + 1 < nc) " + site)

    q, k, v, _ = _inputs(1024, 4, 1, d=1024, b=1)
    pair = A.pair_launches()
    o, lse = A.flash_forward(q, k, v, scale=1024 ** -0.5, causal=True,
                             window=None, sink=0, **DEFAULT)
    assert A.pair_launches() == pair
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf),
                                     causal=True, scale=1024 ** -0.5)
    worst, rel = tolerance_ratios(o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    print(f"planted sliced forward fault: o worst err/limit {worst:.3f}, "
          f"relative Frobenius {rel:.3e}; lse max_abs_err {lse_err:.3e}")
    assert not _held(o, o_ref)
    assert lse_err > 1e-3


@pytest.mark.cuda
def test_tolerance_rejects_a_dkv_kernel_that_skips_a_query_tile(
        cuda, tmp_path, monkeypatch):
    """A dk/dv kernel built with a planted fault (each key tile leaves out
    the dV contribution of the first query tile it visits; dK untouched)
    at the LM's main-path shape: dv fails the tolerance, dk still passes."""
    site = "hopper::Mma<E>::rs64(dv_acc[h], pa[kk]"
    _faulty_library(tmp_path, monkeypatch, site, "if (it > 0) " + site)

    q, k, v, g = _inputs(2048, 12, 12, b=8)
    opts = dict(scale=0.125, causal=True, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT,
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
    site = "hopper::Mma<E>::rs64(dq_acc[h], da[kk]"
    _faulty_library(tmp_path, monkeypatch, site,
                    "if (it > 0 || kk > 0 || q0 + BM < T) " + site)

    q, k, v, g = _inputs(2048, 12, 12, b=8)
    opts = dict(scale=0.125, causal=True, window=None, sink=0)
    o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
    delta = (g.float() * o.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, g, lse, delta, **DEFAULT, **opts)
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
    (2, 8, 1, 300, 256, True),
    (2, 8, 1, 256, 200, False),
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
    """No fallback on the card: f64 inputs, mixed dtypes or a
    non-contiguous q raise; head_dim 264 (which raised until the sliced
    kernels were built) launches the sliced forward."""
    q, k, v, _ = _inputs(128, 2, 2)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        A.flash_attention_lse(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="one dtype"):
        A.flash_attention_lse(q, k.half(), v)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention_lse(q.transpose(2, 3).contiguous().transpose(2, 3),
                              k, v)
    before = A.sliced_launches()["flash_forward"]
    q264 = torch.zeros(1, 2, 64, 264, device="cuda", dtype=torch.bfloat16)
    A.flash_attention_lse(q264, q264, q264)
    assert A.sliced_launches()["flash_forward"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv_h,t,d,causal", [
    (32, 12, 12, 128, 64, False), (256, 12, 12, 197, 64, False),
    (32, 6, 6, 128, 64, False), (256, 6, 6, 197, 64, False),
    (8, 12, 4, 200, 64, True),
    (8, 12, 12, 2048, 64, True), (4, 8, 1, 2048, 256, True)],
    ids=["bert_base", "vit_b16", "bert_base_tp2", "vit_b16_tp2",
         "short_gqa_causal", "gpt_small", "gemma_2b"])
def test_kernels_repeat_bit_for_bit(cuda, b, h, kv_h, t, d, causal):
    """Each kernel run twice on the same inputs gives the same bits: no
    atomics, and no read of shared memory or padding that a launch leaves
    unset.  At the encoders' shapes (and a causal GQA one at T 200) all
    three take the encoders' kernels, whose persistent blocks walk several
    heads each through their rings (dq's rows each written once by one
    warpgroup, no atomics); at Gemma 2B's shape
    dk/dv's query heads are split over slices whose f32 partials the
    reduce sums in order."""
    q, k, v, g = _inputs(t, h, kv_h, d=d, b=b)
    opts = dict(scale=0.125, causal=causal, window=None, sink=0)

    def run():
        o, lse = A.flash_forward(q, k, v, **DEFAULT, **opts)
        delta = (g.float() * o.float()).sum(-1)
        dq = A.flash_backward_dq(q, k, v, g, lse, delta, **DEFAULT,
                                 **opts)
        dk, dv = A.flash_backward_dkv(q, k, v, g, lse, delta, **DEFAULT,
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


@pytest.mark.cuda
def test_tiny_lm_capture_on_the_card_bounds_and_inventory(cuda):
    """`analysis/hlo.capture_workload("lm", 1)` over a one-rank NCCL group:
    peak (max_memory_allocated over the recorded step) >= resident >= the
    admission lower bound, no finding, each kernel launched once per layer,
    and the inventory equal to the same capture's over a one-rank gloo
    group on the CPU."""
    import torch.distributed as dist

    from chip_smoke import free_port
    from tf_operator_tpu_torch.analysis import hlo

    caps = {}
    for backend in ("gloo", "nccl"):
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
        try:
            caps[backend] = hlo.capture_workload("lm", 1)
        finally:
            dist.destroy_process_group()
    card, cpu = caps["nccl"], caps["gloo"]
    mem = card.memory
    bound = hlo.admission_peak_lower_bound(card.n_params,
                                           moments_per_param=2)
    print(f"tiny lm on the card: peak {mem.peak_bytes} B, resident "
          f"{mem.resident_bytes} B, lower bound {bound} B; on the CPU "
          f"resident {cpu.memory.resident_bytes} B")
    assert (mem.device, cpu.memory.device) == ("cuda", "cpu")
    assert mem.peak_bytes >= mem.resident_bytes >= bound
    assert hlo.check_capture(card) == []
    assert card.program.kernel_launches == {
        fn.__name__: 2 for fn in A.KERNELS}

    def inventory(cap):
        return [(op.kind, op.operand_shapes, op.result_shapes,
                 op.group_size, op.asynchronous, op.op_name)
                for op in cap.program.collectives]

    assert inventory(card) == inventory(cpu)
    assert hlo.workload_signature(card) == hlo.workload_signature(cpu)
