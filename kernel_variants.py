#!/usr/bin/env python3
"""Time variants of the flash-attention kernels against the checked-in
source, on one NVIDIA card.

    python3 kernel_variants.py                  # dq at head_dim 64
    python3 kernel_variants.py --d256           # dq and dk/dv at 256
    python3 kernel_variants.py --d256-fwd       # the forward at 256
    python3 kernel_variants.py --encoder [VARIANT ...]  # ViT-B/16, BERT
    python3 kernel_variants.py --sliced [VARIANT ...]   # head dims > 256
    python3 kernel_variants.py --trees DIR ...  # whole trees in turns
    python3 kernel_variants.py --f32 [VARIANT ...] [--parent DIR]  # f32

Each variant in VARIANTS (D256_VARIANTS with --d256) is a list of (text,
replacement) edits to ops/csrc/flash_attention.cu (each text must occur
exactly once).  Every variant, and the source as checked in ("base"), is
built into its own library (printing ptxas's registers and spills for the
kernels timed), checked against the plain version with chip_smoke's
tolerance, and timed with CUDA events in turns: base, v1, ..., vn, then
the reverse, ROUNDS times.  Without flags: dq at the LM's main-path shape
(B 8, H 12, T 2048, D 64, causal, blocks (128, 128)).  With --d256: dq
and dk/dv (its reduce included) at Gemma 2B's attention (B 4, 8 query
heads of 256 over one KV head, T 2048, causal, bf16) against dq's
one-warpgroup 64-row plan and dk/dv's 32-query step, and dk/dv (on the D256_SPLITS_ON build) at
each count of slices of the query heads, beside the host's choice
(`attention.dkv_splits`), and the reduce alone.  With --d256-fwd: the
forward (D256_FWD_VARIANTS: the checked-in grid order against the
parent's and against all rows in one chunk, and K and V in rings of their
own at the same order with that design's variants and diagnostics) at
D256_FWD_SHAPES (Gemma 2B's attention, d256_gqa6, Gemma 7B's widths, a
window + sink), each timed both ways, CUDA events around 20 back-to-back
calls and the kernel's own device time (profiler, mean per launch of 10),
with the host's time per call and SDPA's forward beside it, and the
card's clocks before and after.  With --encoder: at the encoders' shapes
(ENCODER_CASES: ViT-B/16 and BERT-base, whole and at tp 2) SDPA's forward
and whole backward, every tiled tile the wrappers reach at head-dim class
64 (ENCODER_TILES) on the base build, then the wrappers' route (the
encoders' forward, dq and dk/dv kernels) for the base and each
ENCODER_VARIANTS build in turns; every time is the profiler's device time.
With --sliced: the same for the kernels of head dims above 256 at
SLICED_CASES (the pair forward, the cluster dq and dk/dv) against
SLICED_VARIANTS: the parent's sliced forward, dq and dk/dv in the same
build, and diagnostics of what sets their pace (SDPA's memory-efficient
backend beside its default dispatch).
With --trees: each wrapper's device time at chip_smoke's cases main,
gemma_2b and the encoders' (TREE_CASES), and the forward's at other cases
of its tiled kernel (TREE_FWD_CASES), each kernel apart (dk/dv's reduce
too), checked against its plain version, in each tree given (a checkout, e.g. a parent commit unpacked
with `git archive` into a git-ignored directory), one process per tree
per round, in turns.  With --f32: f32 dq and dk/dv on the tensor cores
(dq_tf32_kernel, dkv_tf32_kernel) at chip_smoke's f32 cases (F32_CASES) by
device time, checked against their plain versions by the f32 rule, for
the base build and each F32_VARIANTS build (diagnostics of what their time
is made of) in turns, and with --parent DIR the parent's f32 dq and dk/dv
from that checkout in the same turns, beside SDPA's f32 backward (its
default dispatch and its memory-efficient backend); before the times,
each build's dq, dk and dv at large logits (F32_LARGE: scale -1) against
the plain version in f64, beside plain f32's.  The edits record
the designs the kernels were chosen from (PERF.md); a kernel's next
variants replace them.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke

ROUNDS = 4
DQ_PRODUCTS = """    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
      hopper::Mma<E>::ss(dp, hopper::desc_k(sdOw, BM, kk),
                         hopper::desc_k(sv, BK, kk), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::wg_fence_regs(dp);
"""
# S and dP in two commit groups: the exponentials of S run while dP is in
# flight
DQ_SPLIT = """    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(dp, hopper::desc_k(sdOw, BM, kk),
                         hopper::desc_k(sv, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait<1>();
    hopper::wg_fence_regs(sc);
"""
DQ_DA = """    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(da[kk], dp, kk);"""
DQ_SPLIT_DA = """    hopper::wg_wait();
    hopper::wg_fence_regs(dp);
""" + DQ_DA
DQ_MASK = """    if (!tile_full(mk, r0, 64, k0, BK)) mask_tile(sc, mk, row0, k0, t);"""
# the element test of the first version: Mask::live on each element
DQ_LIVE = """    if (!tile_full(mk, r0, 64, k0, BK)) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        const int j = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
        if (!mk.live(row0 + 8 * ((x >> 1) & 1), j)) sc[x] = 0.f;
      }
    }"""
# stages (at most; shared memory may hold fewer)
DQ_STAGES = """  static constexpr int STAGES =
      cmin(WG == 2 ? 4 : 2,"""


def dq_stages(stages: str) -> str:
    return DQ_STAGES.replace("WG == 2 ? 4 : 2", stages)


# the default tile (128 query rows) at head_dim 64 run with 64-key steps
DQ_DEFAULT_TILE = """  FA_DQ(64, 128, 128)
"""
DQ_BK64 = """  if (dc == 64 && rows == 128 && step == 128)
    return dq<E, 64, 2, 64>(bh, a, st);
"""


# dQ += dS K of tile j left in flight while S and dP of tile j + 1 are
# issued; its stage is freed after the next wait (da kept live until then)
DQ_LOOP = """dq_acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_iter; ++it) {"""
DQ_DEFER_LOOP = """dq_acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  uint32_t da[BK / 16][4];
  for (int it = 0; it < n_iter; ++it) {"""
DQ_DEFER_ISSUE = DQ_PRODUCTS + """    if (it > 0) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(dq_acc[h]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        asm volatile("" ::"r"(da[kk][0]), "r"(da[kk][1]), "r"(da[kk][2]),
                     "r"(da[kk][3]));
      hopper::mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
    }
"""
DQ_DEFER_DA = DQ_DA.replace("    uint32_t da[BK / 16][4];\n", "")
DQ_END = """    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(dq_acc[h]);
    hopper::mbar_arrive(bars + 8 * (STAGES + s));
  }
"""
DQ_DEFER_END = """    hopper::wg_commit();
  }
  hopper::wg_wait();
#pragma unroll
  for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(dq_acc[h]);
"""

VARIANTS = {
    "stages3": [(DQ_STAGES, dq_stages("WG == 2 ? 3 : 2"))],
    "stages5": [(DQ_STAGES, dq_stages("WG == 2 ? 5 : 2"))],
    "bk64": [(DQ_DEFAULT_TILE, DQ_BK64),
             (DQ_STAGES, dq_stages("WG == 2 ? 4 : 3"))],
    "live_mask": [(DQ_MASK, DQ_LIVE)],
    "split": [(DQ_PRODUCTS, DQ_SPLIT), (DQ_DA, DQ_SPLIT_DA)],
    "defer": [(DQ_LOOP, DQ_DEFER_LOOP), (DQ_PRODUCTS, DQ_DEFER_ISSUE),
              (DQ_DA, DQ_DEFER_DA), (DQ_END, DQ_DEFER_END)],
}

# head-dim class 256: the kernels against the designs they replaced
# dq: the earlier plan, dq_kernel with one consumer warpgroup of 64 rows over
# 64-key steps (two 64 KB stages), run for the tile (128, 64)
D256_DQ_64ROWS = [
    ("""    FA_DQ(256, 128, 64)
""", """    if (dc == 256 && rows == 128 && step == 64)
      return dq<E, 256, 1, 64>(bh, a, st);
"""),
    ("std::conditional_t<D == 256, DqWideSmem",
     "std::conditional_t<D == 256 && WG == 2, DqWideSmem"),
    ("""  static_assert(D != 256 || (WG == 2 && BK == 64), "dq's tile at D 256");
""", ""),
    ("""    if constexpr (D == 256)
      return dq_wide_kernel<E>;""", """    if constexpr (D == 256 && WG == 2)
      return dq_wide_kernel<E>;"""),
]
# dk/dv: the earlier 32-query step (three stages; S^T and dP^T m64n32)
D256_DKV_STEP32 = [("""      return dkv<E, 256, 2, 64>(bkv, a, st);""",
                    """      return dkv<E, 256, 2, 32>(bkv, a, st);""")]
# dk/dv: the producer warp stores each tile's lse and delta itself, as
# below head_dim 256 (waiting on its loads), instead of by cp.async
D256_DKV_ROWS_SYNC = [
    ("""    if constexpr (S::SPLIT) {
      // the rows by cp.async, raw lse, 0 past T: each lane's arrival
      // completes when its copies have landed, so the warp goes on to the
      // next tile without waiting for them (32 such arrivals and lane 0's
      // below complete the stage)
      const uint32_t rows = sK + S::rows_off(s);
      for (int c = lane; c < BQ; c += 32) {
        const int i = q0 + c;
        const size_t off = (size_t)bh * T + (i < T ? i : 0);
        hopper::cp_async4(rows + 4 * c, lse + off, i < T);
        hopper::cp_async4(rows + 4 * (BQ + c), delta + off, i < T);
      }
      hopper::cp_async_mbar_arrive(bars + 8 * s);
    } else {""", """    {"""),
    ("""  const DkvWalk w = dkv_split_walk<BQ>(mk, heads, kv_heads, splits, &slice);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's 32 lanes' row copies and lane 0's TMA bytes
      hopper::mbar_init(bars + 8 * s, 33);""",
     """  const DkvWalk w = dkv_split_walk<BQ>(mk, heads, kv_heads, splits, &slice);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bars + 8 * s, 32);"""),
    ("""      dkv_probs<BQ>(x, rows, mk, q0, w.k0, key, t, sl2, LOG2E);""",
     """      dkv_probs<BQ>(x, rows, mk, q0, w.k0, key, t, sl2);"""),
]
D256_VARIANTS = {
    "dq_64rows": D256_DQ_64ROWS,
    "dkv_step32": D256_DKV_STEP32,
    "dkv_rows_sync": D256_DKV_ROWS_SYNC,
}
# the build dk/dv is timed at each count of slices on
D256_SPLITS_ON = "base"
D256_SPLITS = (1, 2, 3, 4, 8)

# The forward at head-dim class 256 over 128 rows is fwd_kernel with its
# blocks taken longest first across a chunk's b*h rows (lpt_tile).  FWD_SPLIT
# is the design it was held against at that order: fwd_wide_kernel, the same
# loop with K and V in rings of their own (3 and 2 stages of 32 KB behind
# the 64 KB Q tile, each stage handed back as soon as its one product has
# read it, K loaded one tile ahead of V).  The split_* variants and the
# diagnostics are edits on top of it; the diagnostics' outputs are wrong on
# purpose (each leaves out one part of the work).
FWD_SPLIT_SRC = """// The forward's epilogue for this thread's two rows: o = acc / l (l = 0 ->
// 1) in E, the columns < ld, and lse = m ln 2 + log l (0 for a row with no
// live key).
template <typename E, int D>
__device__ __forceinline__ void fwd_store(const float (&acc)[D / 64][32],
                                          const float (&m)[2], float (&l)[2],
                                          E* __restrict__ o,
                                          float* __restrict__ lse, int bh,
                                          int T, int ld, int row0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int i = row0 + 8 * h;
    if (i >= T) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
    E* op = o + ((size_t)bh * T + i) * ld;
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dh * 64 + 8 * j + 2 * t;
        if (c < ld)
          store2(op + c, acc[dh][4 * j + 2 * h] * inv,
                 acc[dh][4 * j + 2 * h + 1] * inv);
      }
    }
    if (lse != nullptr && t == 0) {
      lse[(size_t)bh * T + i] = l[h] > 0.f ? m[h] * LN2 + logf(l[h]) : 0.f;
    }
  }
}


// K and V in rings of their own
struct FwdWideSmem {
  static constexpr int DIM = 256, BM = 128, BK = 64;
  static constexpr int K_STAGES = 3, V_STAGES = 2;
  static constexpr int Q_BYTES = BM * DIM * 2;
  static constexpr int KV_BYTES = BK * DIM * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + K_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * KV_BYTES;
  // k_full[K_STAGES], k_empty[K_STAGES], v_full[V_STAGES],
  // v_empty[V_STAGES], q
  static constexpr int BYTES =
      BAR_OFF + 8 * (2 * K_STAGES + 2 * V_STAGES + 1) + 1024;
  static_assert(BYTES <= smem_budget(1), "forward tile does not fit");
};


template <typename E, bool SCALED>
__global__ void __launch_bounds__(384, 1)
    fwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    E* __restrict__ o, float* __restrict__ lse, int group,
                    int ld, float scale, Mask mk, int chunk) {
  using S = FwdWideSmem;
  constexpr int D = S::DIM, BM = S::BM, BK = S::BK;
  constexpr int KS = S::K_STAGES, VS = S::V_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t sK = sQ + S::K_OFF, sV = sQ + S::V_OFF;
  const uint32_t k_full = sQ + S::BAR_OFF, k_empty = k_full + 8 * KS;
  const uint32_t v_full = k_empty + 8 * KS, v_empty = v_full + 8 * VS;
  const uint32_t q_bar = v_empty + 8 * VS;

  const int T = mk.T;
  const GridTile gt = lpt_tile(BM, T, chunk);
  const int bh = gt.bh;
  const int q0 = gt.tile * BM;
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);

  if (threadIdx.x == 0) {
    for (int s = 0; s < KS; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(k_empty + 8 * s, 256);
    }
    for (int s = 0; s < VS; ++s) {
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(v_empty + 8 * s, 256);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int bkv = bh / group;
      hopper::mbar_arrive_tx(q_bar, S::Q_BYTES);
      hopper::tma_tile<D>(sQ, &map_q, BM, q0, bh, q_bar);
      // tile j of K (V) into its ring's stage, once the product of tile
      // j - stages has handed that stage back
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                      uint32_t empty, int stages, int j) {
        const int s = j % stages;
        if (j >= stages)
          hopper::mbar_wait(empty + 8 * s, (j / stages - 1) & 1);
        const int k0 = (j < n_sink ? j : lo + j - n_sink) * BK;
        hopper::mbar_arrive_tx(full + 8 * s, S::KV_BYTES);
        hopper::tma_tile<D>(ring + s * S::KV_BYTES, map, BK, k0, bkv,
                            full + 8 * s);
      };
      // K one tile ahead of V
      if (n_iter > 0) load(&map_k, sK, k_full, k_empty, KS, 0);
      for (int j = 0; j < n_iter; ++j) {
        if (j + 1 < n_iter) load(&map_k, sK, k_full, k_empty, KS, j + 1);
        load(&map_v, sV, v_full, v_empty, VS, j);
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(2, 1)>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t sQw = sQ + wg * 64 * 128;
  const float sl2 = scale * LOG2E;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float o_acc[D / 64][32];
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int ks = it % KS, vs = it % VS;
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
    const uint32_t sk = sK + ks * S::KV_BYTES, sv = sV + vs * S::KV_BYTES;
    hopper::mbar_wait(k_full + 8 * ks, (it / KS) & 1);

    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty + 8 * ks);

    online_softmax<BK, SCALED>(sc, m, l, alpha, mk, r0, row0, k0, t, sl2);
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int x = 0; x < 32; ++x) o_acc[dh][x] *= alpha[(x >> 1) & 1];
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(pa[kk], sc, kk);
    hopper::mbar_wait(v_full + 8 * vs, (it / VS) & 1);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(o_acc[h], pa[kk],
                             hopper::desc_mn(sv, BK, kk, h));
    }
    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(o_acc[h]);
    hopper::mbar_arrive(v_empty + 8 * vs);
  }
  fwd_store<E, D>(o_acc, m, l, o, lse, bh, T, ld, row0, t);
}


// The forward at head-dim class 256 over 128 rows (fwd_wide_kernel).
template <typename E, bool SCALED>
int fwd_wide(int bh, const FwdArgs& a, cudaStream_t stream) {
  using S = FwdWideSmem;
  const int T = a.mk.T;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / a.group, T, a.ld, S::BK)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / a.group, T, a.ld, S::BK)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = fwd_wide_kernel<E, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = grid_blocks(bh, T, S::BM);
  if (grid == 0 || a.chunk < 1 || a.chunk > bh)
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, 384, S::BYTES, stream>>>(map_q, map_k, map_v,
                                          static_cast<E*>(a.o), a.lse,
                                          a.group, a.ld, a.scale, a.mk,
                                          a.chunk);
  return (int)cudaGetLastError();
}


"""
DQ_HOST = "// dq: dq_wide_kernel at head-dim class 256 (its one tile, 128 x 64), else"
FWD_SPLIT = [(DQ_HOST, FWD_SPLIT_SRC + DQ_HOST),
             ("    FA_FWD(256, 128, 64)\n",
              """    if (dc == 256 && rows == 128 && step == 64)
      return fwd_wide<E, SCALED>(bh, a, st);
""")]
FWD_LOOP = '''  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int ks = it % KS, vs = it % VS;
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
    const uint32_t sk = sK + ks * S::KV_BYTES, sv = sV + vs * S::KV_BYTES;
    hopper::mbar_wait(k_full + 8 * ks, (it / KS) & 1);

    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty + 8 * ks);

    online_softmax<BK, SCALED>(sc, m, l, alpha, mk, r0, row0, k0, t, sl2);
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int x = 0; x < 32; ++x) o_acc[dh][x] *= alpha[(x >> 1) & 1];
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(pa[kk], sc, kk);
    hopper::mbar_wait(v_full + 8 * vs, (it / VS) & 1);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(o_acc[h], pa[kk],
                             hopper::desc_mn(sv, BK, kk, h));
    }
    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(o_acc[h]);
    hopper::mbar_arrive(v_empty + 8 * vs);
  }
'''
# S(it + 1) issued ahead of P V(it) inside each warpgroup
FWD_OVERLAP = '''  hopper::mbar_wait(q_bar, 0);
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  {  // S(0) and its softmax
    hopper::mbar_wait(k_full, 0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sK, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty);
    online_softmax<BK, SCALED>(sc, m, l, alpha, mk, r0, row0,
                               (n_sink > 0 ? 0 : lo) * BK, t, sl2);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(pa[kk], sc, kk);
  }
  // S(it + 1) issued ahead of P V(it): its softmax runs while P V(it) is in
  // flight
  for (int it = 0; it < n_iter - 1; ++it) {
    const int ks = (it + 1) % KS, vs = it % VS;
    const int k1 = (it + 1 < n_sink ? it + 1 : lo + it + 1 - n_sink) * BK;
    const uint32_t sk = sK + ks * S::KV_BYTES, sv = sV + vs * S::KV_BYTES;
    hopper::mbar_wait(k_full + 8 * ks, ((it + 1) / KS) & 1);
    hopper::mbar_wait(v_full + 8 * vs, (it / VS) & 1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(o_acc[h], pa[kk],
                             hopper::desc_mn(sv, BK, kk, h));
    }
    hopper::wg_commit();
    hopper::wg_wait<1>();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty + 8 * ks);
    online_softmax<BK, SCALED>(sc, m, l, alpha, mk, r0, row0, k1, t, sl2);
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(o_acc[h]);
    hopper::mbar_arrive(v_empty + 8 * vs);
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int x = 0; x < 32; ++x) o_acc[dh][x] *= alpha[(x >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(pa[kk], sc, kk);
  }
  {  // P V of the last tile
    const int vs = (n_iter - 1) % VS;
    const uint32_t sv = sV + vs * S::KV_BYTES;
    hopper::mbar_wait(v_full + 8 * vs, ((n_iter - 1) / VS) & 1);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(o_acc[h], pa[kk],
                             hopper::desc_mn(sv, BK, kk, h));
    }
    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(o_acc[h]);
    hopper::mbar_arrive(v_empty + 8 * vs);
  }
'''
FWD_LOAD = """        hopper::mbar_arrive_tx(full + 8 * s, S::KV_BYTES);
        hopper::tma_tile<D>(ring + s * S::KV_BYTES, map, BK, k0, bkv,
                            full + 8 * s);"""
D256_FWD_VARIANTS = {
    # each b*h's row tiles adjacent, longest first (the parent's order)
    "fwd_bh_major": [("constexpr bool LPT = D == 256 && WG == 2;",
                      "constexpr bool LPT = false;")],
    # longest first over all b*h rows, whatever their K and V take of L2
    "fwd_one_chunk": [("      a.scale, a.mk, a.chunk);",
                       "      a.scale, a.mk, bh);")],
    # K and V in rings of their own, at the same order
    "split_rings": FWD_SPLIT,
    # K in two stages
    "split_k2": FWD_SPLIT + [("static constexpr int K_STAGES = 3, V_STAGES = 2;",
                "static constexpr int K_STAGES = 2, V_STAGES = 2;")],
    # each b*h's row tiles adjacent, longest first (the parent's order)
    "split_bh_major": FWD_SPLIT + [("""                                          a.group, a.ld, a.scale, a.mk,
                                          a.chunk);""", """                                          a.group, a.ld, a.scale, a.mk,
                                          1);""")],
    # K and V loaded tile by tile in turn (K not one tile ahead)
    "split_interleave": FWD_SPLIT + [("""      // K one tile ahead of V
      if (n_iter > 0) load(&map_k, sK, k_full, k_empty, KS, 0);
      for (int j = 0; j < n_iter; ++j) {
        if (j + 1 < n_iter) load(&map_k, sK, k_full, k_empty, KS, j + 1);
        load(&map_v, sV, v_full, v_empty, VS, j);
      }""", """      for (int j = 0; j < n_iter; ++j) {
        load(&map_k, sK, k_full, k_empty, KS, j);
        load(&map_v, sV, v_full, v_empty, VS, j);
      }""")],
    # longest first over all b*h rows, whatever their K and V take of L2
    "split_one_chunk": FWD_SPLIT + [("""                                          a.group, a.ld, a.scale, a.mk,
                                          a.chunk);""", """                                          a.group, a.ld, a.scale, a.mk,
                                          bh);""")],
    # the warpgroups take turns to issue S (named barriers 1 and 2; P V as
    # it comes), FA3's ping-pong
    "split_turns_s": FWD_SPLIT + [
        ("""  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int ks = it % KS, vs = it % VS;""", """  hopper::mbar_wait(q_bar, 0);
  if (wg == 1) hopper::named_arrive(1, 256);  // warpgroup 0 issues first
  for (int it = 0; it < n_iter; ++it) {
    const int ks = it % KS, vs = it % VS;"""),
        ("""    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty + 8 * ks);""", """    hopper::named_sync(1 + wg, 256);  // this warpgroup's turn
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::named_arrive(2 - wg, 256);  // the other's
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty + 8 * ks);"""),
        ("""    hopper::mbar_arrive(v_empty + 8 * vs);
  }
  fwd_store<E, D>(o_acc""", """    hopper::mbar_arrive(v_empty + 8 * vs);
  }
  if (wg == 0) hopper::named_sync(1, 256);  // warpgroup 1's last turn
  fwd_store<E, D>(o_acc""")],
    # FA3's overlap inside a warpgroup (a second set of S registers)
    "split_overlap": FWD_SPLIT + [(FWD_LOOP, FWD_OVERLAP)],
    # diagnostics of the split rings, each leaving out one part of the work (outputs wrong on
    # purpose): the S product, the P V product, the exponentials (p = the
    # scaled score less the max), the K and V loads after each stage's
    # first (the stage reused)
    "diag_no_s": FWD_SPLIT + [("""    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty + 8 * ks);""", """    for (int kk = 0; kk < 0; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::mbar_arrive(k_empty + 8 * ks);""")],
    "diag_no_pv": FWD_SPLIT + [("""        hopper::Mma<E>::rs64(o_acc[h], pa[kk],
                             hopper::desc_mn(sv, BK, kk, h));""",
                    """        asm volatile("" ::"r"(pa[kk][0]), "r"(pa[kk][1]),
                     "r"(pa[kk][2]), "r"(pa[kk][3]));""")],
    "diag_no_exp": FWD_SPLIT + [(
        "const float p = exp2_approx(fmaf(s[4 * j + 2 * h + e], sl2, -m_use));",
        "const float p = fmaf(s[4 * j + 2 * h + e], sl2, -m_use);")],
    "diag_no_kv": FWD_SPLIT + [(FWD_LOAD, """        if (j < stages) {
""" + FWD_LOAD + """
        } else {
          hopper::mbar_arrive(full + 8 * s);
        }""")],
}

# (name, B, query heads, KV heads, window, sink) of the forward's shapes,
# T 2048, causal
D256_FWD_SHAPES = (("gemma_2b", 4, 8, 1, None, 0),
                   ("d256_gqa6", 1, 6, 1, None, 0),
                   ("gemma_7b", 4, 16, 16, None, 0),
                   ("d256_window_sink", 2, 8, 1, 256, 4))


def build(name: str, edits, root: Path):
    from tf_operator_tpu_torch.ops import _build

    csrc = root / name
    shutil.copytree(_build.CSRC, csrc)
    source = csrc / _build.SOURCE.name
    # each edit's text occurs once in all of csrc (the source or a header)
    texts = {p: p.read_text() for p in csrc.iterdir() if p.is_file()}
    for old, new in edits:
        where = [p for p, src in texts.items() if old in src]
        count = sum(texts[p].count(old) for p in where)
        if count != 1:
            raise RuntimeError(f"variant {name}: an edit's text occurs "
                               f"{count} times")
        texts[where[0]] = texts[where[0]].replace(old, new)
    for p, src in texts.items():
        p.write_text(src)
    lib = root / f"lib-{name}.so"
    log = _build.nvcc(source, lib)
    return lib, log


def report(name: str, log: str, kernels=None, head_class=256,
           dtype=None) -> None:
    """ptxas's registers and spills for the dq kernel's instantiations (with
    `kernels`: those of these kernels at `head_class`, one class or a
    tuple of them, and of `dtype` when given), and every warning or
    performance note."""
    classes = head_class if isinstance(head_class, tuple) else (head_class,)
    for line in log.splitlines():
        if "warning" in line.lower() or "Performance" in line:
            print(f"  {name}: {line.strip()}")
    for inst, regs, stores, loads, key in chip_smoke.ptxas_report(log):
        if dtype is not None and key[1] != dtype:
            continue
        if (key[0] in kernels and key[2] in classes if kernels
                else inst.startswith("dq_kernel")):
            print(f"  {name}: {inst} {regs} registers at launch, {stores} "
                  f"bytes spill stores, {loads} bytes spill loads")


def bind(lib) -> None:
    """Make the wrappers launch the kernels of `lib`."""
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import attention as A

    A._lib = None
    _build.library = lambda: lib


def main_d256() -> int:
    """dq and dk/dv at Gemma 2B's attention for each D256 variant, in
    turns; dk/dv at each count of slices and the reduce on the base."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hkv, t, d = 4, 8, 1, 2048, 256
    q, do = (torch.randn(b, h, t, d, generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    opts = dict(scale=d ** -0.5, causal=True, window=None, sink=0,
                block_q=128, block_k=128)
    plain = dict(opts)
    del plain["block_q"], plain["block_k"]
    auto = A.dkv_splits(b * hkv, t, h // hkv, A.sm_count(dev))
    print(f"gemma_2b: B {b}, H {h} over {hkv} KV head, T {t}, D {d}, "
          f"causal, bf16; dk/dv slices (dkv_splits) {auto}", flush=True)

    choose = A.dkv_splits

    def calls(splits=None):
        # dk/dv at `splits` slices (None: the host's choice)
        A.dkv_splits = choose if splits is None else lambda *_: splits
        return {
            "dq": lambda: A.flash_backward_dq(q, k, v, do, lse, delta,
                                              **opts),
            "dkv": lambda: A.flash_backward_dkv(q, k, v, do, lse, delta,
                                                **opts)}

    libs = {}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        for name, edits in [("base", [])] + list(D256_VARIANTS.items()):
            lib, log = build(name, edits, Path(tmp))
            report(name, log, ("dq", "dkv"))
            libs[name] = ctypes.CDLL(str(lib))
        bind(libs["base"])
        o, lse = A.flash_forward(q, k, v, **opts)
        delta = (do.float() * o.float()).sum(-1)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        refs = {"dq": (A.backward_dq_plain(qf, kf, vf, dof, lse, delta,
                                           **plain),),
                "dkv": A.backward_dkv_plain(qf, kf, vf, dof, lse, delta,
                                            **plain)}
        del qf, kf, vf, dof
        runs = [(name, None) for name in libs]
        runs += [(D256_SPLITS_ON, n) for n in D256_SPLITS if n != auto]
        times = {run: {} for run in runs}
        for r in range(ROUNDS):
            for name, splits in runs if r % 2 == 0 else runs[::-1]:
                bind(libs[name])
                label = name if splits is None else f"{name} {splits} sl."
                for kernel, fn in calls(splits).items():
                    if splits is not None and kernel == "dq":
                        continue
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    torch.cuda.synchronize()
                    held = all(
                        chip_smoke.tolerance_ratios(x, ref)[0] <= 1.0 and
                        chip_smoke.tolerance_ratios(x, ref)[1] <=
                        chip_smoke.FRO for x, ref in zip(got, refs[kernel]))
                    ms = chip_smoke.cuda_ms(fn, 20)
                    times[(name, splits)].setdefault(kernel, []).append(ms)
                    print(f"  round {r} {label:16s} {kernel:3s} ms {ms:.4f}"
                          f"{'' if held else ' OUTSIDE THE TOLERANCE'}",
                          flush=True)
        A.dkv_splits = choose
        bind(libs["base"])
        ws = torch.randn(2, auto, b, hkv, t, d, generator=gen, device=dev)
        reduce_ms = chip_smoke.kernel_device_ms(
            lambda: A.dkv_reduce(ws, opts["scale"], torch.bfloat16),
            "dkv_reduce_kernel")
        nbytes = ws.numel() * 4 + 2 * b * hkv * t * d * 2
        print(f"dkv_reduce at {auto} slices: device ms {reduce_ms:.4f}, "
              f"{nbytes:,} bytes, bound ms "
              f"{nbytes / chip_smoke.PEAK_BYTES * 1e3:.4f}", flush=True)
    for (name, splits), kernels in times.items():
        label = name if splits is None else f"{name} {splits} sl."
        for kernel, ts in kernels.items():
            print(f"{label:16s} {kernel:3s} mean ms {sum(ts) / len(ts):.4f} "
                  f"over {len(ts)} ({' '.join(f'{x:.4f}' for x in ts)})")
    return 0


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True, timeout=60).stdout.strip()


def fwd_times(fn, sdpa=None) -> str:
    """The forward both ways: CUDA events around 20 back-to-back calls, and
    the kernel's own device time (profiler, mean per launch of 10); the
    host's time per call (100 calls enqueued, no wait); with `sdpa` its
    forward's device time."""
    import time

    import torch

    ev = chip_smoke.cuda_ms(fn, 20)
    dev = chip_smoke.kernel_device_ms(lambda: [fn() for _ in range(10)],
                                      "fwd_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fn()
    host = (time.perf_counter() - t0) * 1e4  # us per call
    torch.cuda.synchronize()
    out = f"cuda_ms {ev:.4f} device_ms {dev:.4f} host_us {host:.1f}"
    if sdpa is not None:
        busy = chip_smoke.device_busy(lambda: [sdpa() for _ in range(10)])
        out += f" sdpa device_ms {busy[0] / 10:.4f}"
    return out


def main_d256_fwd() -> int:
    """The forward at D256_FWD_SHAPES for each D256_FWD_VARIANTS build and
    the base, in turns."""
    import torch
    import torch.nn.functional as F

    from tf_operator_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = {}
    for name, b, h, hkv, window, sink in D256_FWD_SHAPES:
        q = torch.randn(b, h, 2048, 256, generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn(b, hkv, 2048, 256, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        opts = dict(scale=256 ** -0.5, causal=True, window=window, sink=sink)
        qf, kf, vf = (x.float() for x in (q, k, v))
        ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf), **opts)
        # SDPA as chip_smoke.kernel_case calls it: causal, or a mask
        mask = None
        if window:
            i = torch.arange(2048, device=dev)
            mask = ((i[None, :] <= i[:, None]) &
                    ((i[:, None] - i[None, :] < window) | (i[None, :] < sink)))
        calls[name] = (
            lambda q=q, k=k, v=v, opts=opts: A.flash_forward(
                q, k, v, block_q=128, block_k=128, **opts),
            lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                scale=256 ** -0.5, enable_gqa=True),
            ref)
    print(f"clocks (sm, max sm, power, temperature) before: {clocks()}",
          flush=True)
    libs = {}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        for name, edits in [("base", [])] + list(D256_FWD_VARIANTS.items()):
            lib, log = build(name, edits, Path(tmp))
            report(name, log, ("fwd",))
            libs[name] = ctypes.CDLL(str(lib))
        order = list(libs)
        for r in range(ROUNDS):
            for name in order if r % 2 == 0 else order[::-1]:
                bind(libs[name])
                for shape, (fn, sdpa, ref) in calls.items():
                    o, lse = fn()
                    torch.cuda.synchronize()
                    worst, rel = chip_smoke.tolerance_ratios(o, ref[0])
                    held = (worst <= 1.0 and rel <= chip_smoke.FRO and float(
                        (lse - ref[1]).abs().max()) <= chip_smoke.TOL_LSE)
                    print(f"  round {r} {name:12s} {shape:9s} "
                          f"{fwd_times(fn, sdpa if name == 'base' else None)}"
                          f"{'' if held else ' OUTSIDE THE TOLERANCE'}",
                          flush=True)
    print(f"clocks (sm, max sm, power, temperature) after: {clocks()}",
          flush=True)
    return 0


# The encoders' shapes (chip_smoke's cases: ViT-B/16 and BERT-base, each
# whole and as one tp rank's 6 heads at tp 2; non-causal, bf16, D 64).
ENCODER_CASES = ("vit_b16", "vit_b16_tp2", "bert_base", "bert_base_tp2")
# every tile of the tiled kernels the wrapper reaches at head-dim class 64
# (INSTANTIATED), each timed at the encoders' shapes on the base build
ENCODER_TILES = {"fwd": [(r, s) for r in (64, 128) for s in (64, 128)],
                 "dq": [(r, s) for r in (64, 128) for s in (64, 128)],
                 "dkv": [(r, s) for r in (64, 128) for s in (32, 64)]}
# The encoders' kernels (fwd_short_kernel, dq_short_kernel,
# dkv_short_kernel) against variants of their design, as edits of the
# checked-in source.
# the forward with two consumer warpgroups (240 registers a thread)
ENC_WG2 = [("constexpr int SHORT_WGS = 3;", "constexpr int SHORT_WGS = 2;")]
# whole 128-key steps in the forward and whole 64-query chunks in dk/dv
# (not the ragged last one cut to 16-row sub-steps)
ENC_WHOLE = [
    ("        const int n = cmin(BK, (T - k0 + 15) / 16 * 16);",
     "        const int n = BK;"),
    ("            const int nq = cmin(BQ, (T - q0 + 15) / 16 * 16);",
     "            const int nq = BQ;")]
# the forward's element mask by Mask::live on each element (in
# online_softmax, so the tiled forward's too)
ENC_LIVE = [("""  if (!tile_full(mk, r0, 64, k0, BK))
    mask_tile(s, mk, row0, k0, t, -INFINITY);
""", """  if (!tile_full(mk, r0, 64, k0, BK)) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const int j = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
      if (!mk.live(row0 + 8 * ((x >> 1) & 1), j)) s[x] = -INFINITY;
    }
  }
""")]
ENCODER_VARIANTS = {
    "fwd_wg2": ENC_WG2,
    # the first build's design (two warpgroups, whole steps, Mask::live)
    "plain_steps": ENC_WG2 + ENC_WHOLE + ENC_LIVE,
    "no_trim": ENC_WHOLE,
    "live_mask": ENC_LIVE,
    # a warp whose 16 rows (dk/dv: keys) all lie past T skips its softmax
    "dead_warps": [
        ("""  float alpha[2];
  online_softmax<N, SCALED>(sc, m, l, alpha, mk, q0, row0, k0, t, sl2);
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] *= alpha[(x >> 1) & 1];
""", """  if (q0 + (row0 - q0) / 16 * 16 < mk.T) {
    float alpha[2];
    online_softmax<N, SCALED>(sc, m, l, alpha, mk, q0, row0, k0, t, sl2);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] *= alpha[(x >> 1) & 1];
  } else {
#pragma unroll
    for (int x = 0; x < N / 2; ++x) sc[x] = 0.f;
  }
"""),
        ("""  dkv_probs<NQ>(sc, rows, mk, q0, kr0, key, t, sl2, LOG2E);
#pragma unroll
  for (int x = 0; x < NQ / 2; ++x) {
    const float dl = rows[BQ + 8 * (x >> 2) + 2 * t + (x & 1)];
    dp[x] = sc[x] * (dp[x] - dl);
  }""", """  if (key[0] / 16 * 16 < mk.T) {
    dkv_probs<NQ>(sc, rows, mk, q0, kr0, key, t, sl2, LOG2E);
#pragma unroll
    for (int x = 0; x < NQ / 2; ++x) {
      const float dl = rows[BQ + 8 * (x >> 2) + 2 * t + (x & 1)];
      dp[x] = sc[x] * (dp[x] - dl);
    }
  } else {
#pragma unroll
    for (int x = 0; x < NQ / 2; ++x) sc[x] = dp[x] = 0.f;
  }""")],
    # the forward in 64-key steps throughout
    "fwd_bk64": [("        if (n == BK) {", "        if (false) {")],
    # diagnostics of the forward, each leaving out one part of its work
    # (outputs wrong on purpose): the S product, the P V product, the
    # exponentials, the loads after each stage's first, the O stores
    "diag_no_s": [("""  for (int kk = 0; kk < 4; ++kk)
    hopper::Mma<E>::ss(sc, hopper::desc_k(sQr, 64, kk),""",
                   """  for (int kk = 0; kk < 0; ++kk)
    hopper::Mma<E>::ss(sc, hopper::desc_k(sQr, 64, kk),""")],
    "diag_no_pv": [(
        "    hopper::Mma<E>::rs64(acc, pa[kk], hopper::desc_mn(sv, N, kk, 0));",
                    """    asm volatile("" ::"r"(pa[kk][0]), "r"(pa[kk][1]),
                 "r"(pa[kk][2]), "r"(pa[kk][3]));""")],
    "diag_no_exp": [(
        "const float p = exp2_approx(fmaf(s[4 * j + 2 * h + e], sl2, -m_use));",
        "const float p = fmaf(s[4 * j + 2 * h + e], sl2, -m_use);")],
    "diag_no_loads": [(
        "        hopper::mbar_arrive_tx(full, (n_rt + 2 * n_kc) * S::CHUNK);",
        """        if (i >= STAGES) {
          hopper::mbar_arrive(full);
          continue;
        }
        hopper::mbar_arrive_tx(full, (n_rt + 2 * n_kc) * S::CHUNK);""")],
    "diag_no_store": [("        hopper::tma_store(&map_o, sO, 0, q0, bh);",
                       "")],
    # dq with two consumer warpgroups (240 registers a thread) over
    # 128-key steps
    "dq_wg2": [("constexpr int DQ_SHORT_WGS = 3;",
                "constexpr int DQ_SHORT_WGS = 2;")],
    # diagnostics of dq, each leaving out one part of its work (outputs
    # wrong on purpose): the exponentials, the dS.K product, every item of
    # a block after its first (one wave at most: what BERT-base tp 2's
    # half wave costs)
    "dq_diag_no_exp": [(
        """  for (int x = 0; x < N / 2; ++x)
    sc[x] = exp2_approx(fmaf(sc[x], sl2, -lse2[(x >> 1) & 1]));""",
        """  for (int x = 0; x < N / 2; ++x)
    sc[x] = fmaf(sc[x], sl2, -lse2[(x >> 1) & 1]);""")],
    "dq_diag_no_dq": [(
        "    hopper::Mma<E>::rs64(dq_acc, da[kk], hopper::desc_mn(sk, N, kk, 0));",
        """    asm volatile("" ::"r"(da[kk][0]), "r"(da[kk][1]),
                 "r"(da[kk][2]), "r"(da[kk][3]));""")],
    "dq_diag_one_item": [(
        """  const int items = (bkv_n - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;""",
        "  const int items = 1;")],
}
# what each variant changes: the kernels its rounds time
ENCODER_VARIANT_KERNELS = {
    name: ("fwd", "dkv") if name in ("plain_steps", "no_trim", "dead_warps")
    else ("dq",) if name.startswith("dq_") else ("fwd",)
    for name in ENCODER_VARIANTS}
# the profiler's name fragments of each wrapper's kernels, each timed
# apart (dk/dv's kernel and, with its heads split, the reduce after it)
KERNEL_NAMES = {"fwd": ("fwd_",), "dq": ("dq_",),
                "dkv": ("dkv_kernel", "dkv_split", "dkv_short",
                        "dkv_reduce", "dkv_sliced", "dkv_cluster",
                        "dkv_tf32", "dkv_f32")}


def device_ms(fn, names, reps: int = 10) -> str:
    """The mean device time of a launch of each kernel named by one of
    `names` over `reps` back-to-back calls of fn, as "name device_ms x"
    joined by " + " (the profiler: a short kernel's wrapper outlasts it on
    the host, so CUDA events would time the host; the mean is over the
    launches caught, and a profile that caught none is taken again, three
    times at most)."""
    for _ in range(3):
        events = chip_smoke.profiled_events(
            lambda: [fn() for _ in range(reps)])
        durs = {n: [e["dur"] for e in events if n in e["name"]]
                for n in names}
        if any(durs.values()):
            return " + ".join(
                f"{n.rstrip('_')} device_ms {sum(d) / len(d) / 1e3:.4f}"
                for n, d in durs.items() if d)
    raise RuntimeError(f"three profiles saw no kernel named by {names}")


def case_calls(A, case):
    """The three wrappers at a chip_smoke case (its blocks), their plain
    versions' outputs, and SDPA's forward and backward: {kernel: (call,
    refs)}, sdpa_fwd, sdpa_bwd."""
    import torch
    import torch.nn.functional as F

    dtype = getattr(torch, case.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(case.b, n, case.t, case.d, generator=gen,
                               device="cuda").to(dtype)
                   for n in (case.h, case.hkv, case.hkv, case.h))
    scale = case.d ** -0.5 if case.scale is None else case.scale
    plain = dict(scale=scale, causal=case.causal, window=case.window,
                 sink=case.sink)
    opts = dict(plain, block_q=case.blocks[0], block_k=case.blocks[1])
    o, lse = A.flash_forward(q, k, v, **opts)
    delta = (do.float() * o.float()).sum(-1)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    # f32 dq and dk/dv against the plain version in f64 (chip_smoke's rule)
    bwd = [x.double() if dtype == torch.float32 else x
           for x in (qf, kf, vf, dof, lse, delta)]
    calls = {
        "fwd": (lambda: A.flash_forward(q, k, v, **opts),
                A.attention_lse(qf, *A.repeat_kv(qf, kf, vf), **plain)),
        "dq": (lambda: A.flash_backward_dq(q, k, v, do, lse, delta, **opts),
               (A.backward_dq_plain(*bwd, **plain),)),
        "dkv": (lambda: A.flash_backward_dkv(q, k, v, do, lse, delta,
                                             **opts),
                A.backward_dkv_plain(*bwd, **plain))}
    kw = dict(is_causal=case.causal, scale=scale,
              enable_gqa=case.hkv != case.h)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, **kw)

    def sdpa_bwd():
        return torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)

    return calls, sdpa_fwd, sdpa_bwd


def held(got, refs, dtype: str = "bfloat16", worst=None) -> bool:
    """The kernel's outputs against its plain version's by chip_smoke's
    rule for inputs of `dtype` (the forward's lse by its lse tolerance);
    each output's worst err/limit appended to `worst` when given."""
    rtol, fro, tol_lse = chip_smoke.rule(dtype)
    got = got if isinstance(got, tuple) else (got,)
    ok = True
    for i, (x, ref) in enumerate(zip(got, refs)):
        if x.dim() == 3:  # lse
            ok &= float((x - ref).abs().max()) <= tol_lse
        else:
            ratio, rel = chip_smoke.tolerance_ratios(x, ref, rtol)
            ok &= ratio <= 1.0 and rel <= fro
            if worst is not None:
                worst.append(ratio)
    return ok


def device_line(A, case, kernels=("fwd", "dq", "dkv")) -> str:
    """Each wrapper's device time at a case and whether it held against
    its plain version (with its outputs' worst err/limit), as one line."""
    import torch

    calls, _, _ = case_calls(A, case)
    parts = []
    for kernel in kernels:
        fn, refs = calls[kernel]
        got = fn()
        torch.cuda.synchronize()
        worst = []
        ok = held(got, refs, case.dtype, worst)
        parts.append(f"{device_ms(fn, KERNEL_NAMES[kernel])} (worst "
                     f"{'/'.join(f'{w:.3f}' for w in worst)})"
                     f"{'' if ok else ' OUTSIDE THE TOLERANCE'}")
    return f"{case.name:13s} " + "; ".join(parts)


def main_encoder(names) -> int:
    """The encoders' shapes: the wrappers' route (the encoders' forward, dq
    and dk/dv kernels) for the base build and each
    ENCODER_VARIANTS build named (all without names) in turns, by device
    time; before, on the base build, every tiled tile the wrapper can reach
    at head-dim class 64 (ENCODER_TILES, through a patched
    `resolve_tiles`), and SDPA's forward and whole backward."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    cases = [x for x in chip_smoke.CASES if x.name in ENCODER_CASES]
    resolve = A.resolve_tiles
    print(f"clocks (sm, max sm, power, temperature) before: {clocks()}",
          flush=True)
    libs = {}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        variants = [(name, edits) for name, edits in ENCODER_VARIANTS.items()
                    if not names or name in names]
        for name, edits in [("base", [])] + variants:
            lib, log = build(name, edits, Path(tmp))
            report(name, log, ("fwd", "dq", "dkv"), 64)
            libs[name] = ctypes.CDLL(str(lib))
        bind(libs["base"])
        for case in cases:
            calls, sdpa_fwd, sdpa_bwd = case_calls(A, case)
            fwd_ms = device_busy_ms(sdpa_fwd)
            bwd_ms = device_busy_ms(sdpa_bwd)
            print(f"  {case.name:13s} sdpa forward device_ms {fwd_ms:.4f} "
                  f"backward (dq, dk, dv) device_ms {bwd_ms:.4f}",
                  flush=True)
            for kernel, tiles in ENCODER_TILES.items():
                fn, refs = calls[kernel]
                for tile in tiles:
                    A.resolve_tiles = (
                        lambda *a, kernel=kernel, tile=tile, **k:
                        resolve(*a[:4])._replace(**{kernel: tile}))
                    got = fn()
                    torch.cuda.synchronize()
                    ok = held(got, refs)
                    print(f"  {case.name:13s} tiled tile {tile} "
                          f"{device_ms(fn, KERNEL_NAMES[kernel])}"
                          f"{'' if ok else ' OUTSIDE THE TOLERANCE'}",
                          flush=True)
                A.resolve_tiles = resolve
            del calls
            torch.cuda.empty_cache()
        order = list(libs)
        for r in range(ROUNDS):
            for name in order if r % 2 == 0 else order[::-1]:
                bind(libs[name])
                kernels = ENCODER_VARIANT_KERNELS.get(name,
                                                      ("fwd", "dq", "dkv"))
                for case in cases:
                    print(f"  round {r} {name:13s} "
                          f"{device_line(A, case, kernels)}", flush=True)
    print(f"clocks (sm, max sm, power, temperature) after: {clocks()}",
          flush=True)
    return 0


# Above head dim 256 at chip_smoke's d512_mqa (4 query heads of 512 over
# one KV head, B 4, T 2048, causal, bf16).  The forward runs on the pair
# kernel there; "fwd_sliced" routes it to the sliced forward of the same
# build instead (the parent's design: the pair's reach cut to 256,
# attention.PAIR_LD with it), and four diagnostics, wrong on purpose, show
# what each link of a step's chain costs: "pair_no_exchange" takes each
# warpgroup's own partial for the whole S (no store, no barrier, no read),
# "pair_no_loads" fills the rings at a block's first key step only (the
# later steps read stale stages), "pair_no_products" issues no product,
# "pair_no_softmax" takes S as P (no exponentials, no rescale).  dq and dk/dv run on the cluster kernels
# there; "sliced" routes them to the sliced kernels of the same build
# instead (the cluster's reach cut to 256, attention.CLUSTER_LD with it),
# and three diagnostics show what the SM-to-SM sum and the loads cost:
# "no_exchange" sums each block's own partial only (no store to a partner,
# no wait), "exchange_only" issues no product (the loads, the exchange,
# the exponentials and the stores alone), "loads_once" loads the ring's
# slots at a block's first step only.
SLICED_CASES = ("d512_mqa",)
CLUSTER_REACH = "constexpr int CLUSTER_REACH = 1024;"
PAIR_REACH = "constexpr int PAIR_REACH = 512;"
# the cluster dk/dv's and dq's ring loads (Q's and dO's slices, V's and
# K's)
CLUSTER_LOADS = ["""          const uint32_t at = rg.put(n, 0, S::OPND);
          for (int b = 0; b < 4; ++b)
            hopper::tma_load(at + b * BOX, o == 0 ? &map_q : &map_do,""",
                 """          const uint32_t at = rg.put(n, 0, S::OPND);
          for (int b = 0; b < 4; ++b)
            hopper::tma_load(at + b * BOX, o == 0 ? &map_v : &map_k,"""]
# the pair forward's contraction at the head of a key step, and the end
# of its P V
PAIR_CONTRACT = """    for (int it = 0; it < n_iter; ++it) {
      const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
      float s_tile[BK / 2];
      if (!PAIR_PRODUCTS)
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s_tile[i] = 0.f;
      // the contraction over this warpgroup's chunks, one group over the
      // K slab
      const int ks = rg.take();
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * CN * PAIR_PRODUCTS; ++kk)
        hopper::Mma<E>::ss(s_tile, hopper::desc_k(q_tile, BM, kk),
                           hopper::desc_k(ring + ks * S::SLAB, BK, kk),
                           kk > 0);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::mbar_arrive(rg.empty(ks));
      hopper::wg_fence_regs(s_tile);
"""
PAIR_AHEAD = """    float s_tile[BK / 2];
    if (!PAIR_PRODUCTS)
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s_tile[i] = 0.f;
    auto contract = [&]() {
      const int ks = rg.take();
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * CN * PAIR_PRODUCTS; ++kk)
        hopper::Mma<E>::ss(s_tile, hopper::desc_k(q_tile, BM, kk),
                           hopper::desc_k(ring + ks * S::SLAB, BK, kk),
                           kk > 0);
      hopper::wg_commit();
      return ks;
    };
    int ks = n_iter > 0 ? contract() : 0;
    for (int it = 0; it < n_iter; ++it) {
      const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
      hopper::wg_wait<0>();
      hopper::mbar_arrive(rg.empty(ks));
      hopper::wg_fence_regs(s_tile);
"""
PAIR_PV_END = """      if (PAIR_PRODUCTS) pair_pv<E, CN>(o_acc, p_frag, ring + vs * S::SLAB);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::mbar_arrive(rg.empty(vs));
"""
PAIR_LOOP_END = """      for (int b = 0; b < 4; ++b) hopper::wg_fence_regs(o_acc[b]);
    }
"""
PAIR_PRODUCER_END = """                             bkv, rg.full(s));
        }
      }
"""
SLICED_VARIANTS = {
    # the next key step's contraction issued behind this step's P V, in a
    # branch at the last step
    "pair_ahead": [(PAIR_CONTRACT, PAIR_AHEAD),
                   (PAIR_PV_END, PAIR_PV_END.replace(
                       """      hopper::wg_wait<0>();
""", """      if (it + 1 < n_iter) {
        ks = contract();
        hopper::wg_wait<1>();
      } else {
        hopper::wg_wait<0>();
      }
"""))],
    # the same with no branch: after the last step the producer hands over
    # one more K slab, never loaded, whose products are thrown away
    "pair_ahead_phantom": [
        (PAIR_CONTRACT, PAIR_AHEAD),
        (PAIR_PV_END, PAIR_PV_END.replace("""      hopper::wg_wait<0>();
""", """      ks = contract();
      hopper::wg_wait<1>();
""")),
        (PAIR_LOOP_END, PAIR_LOOP_END + """    hopper::wg_wait<0>();
"""),
        (PAIR_PRODUCER_END, PAIR_PRODUCER_END + """      if (n_iter > 0) rg.put(0);
""")],
    # the forward on the sliced kernel (the parent's)
    "fwd_sliced": [(PAIR_REACH, PAIR_REACH.replace("512", "256"))],
    # the pair forward without the exchange, and without the loads after a
    # block's first key step
    "pair_no_exchange": [("constexpr bool PAIR_EXCHANGE = true;",
                          "constexpr bool PAIR_EXCHANGE = false;")],
    "pair_no_loads": [("constexpr bool PAIR_LOADS = true;",
                       "constexpr bool PAIR_LOADS = false;")],
    # ... and without its products, and without its softmax
    "pair_no_products": [("constexpr bool PAIR_PRODUCTS = true;",
                          "constexpr bool PAIR_PRODUCTS = false;")],
    "pair_no_softmax": [("constexpr bool PAIR_SOFTMAX = true;",
                         "constexpr bool PAIR_SOFTMAX = false;")],
    # dq and dk/dv on the sliced kernels (the parent's)
    "sliced": [(CLUSTER_REACH, CLUSTER_REACH.replace("1024", "256"))],
    # the cluster kernels without the exchange, and without the products
    "no_exchange": [("constexpr bool CLUSTER_EXCHANGE = true;",
                     "constexpr bool CLUSTER_EXCHANGE = false;")],
    "exchange_only": [("constexpr bool CLUSTER_PRODUCTS = true;",
                       "constexpr bool CLUSTER_PRODUCTS = false;")],
    # the cluster kernels' ring loads at a block's first step only (the
    # later steps read stale slots): what the loads' waits cost
    "loads_once": [(CLUSTER_LOADS[0], CLUSTER_LOADS[0].replace(
        "rg.put(n, 0, S::OPND);", "rg.put(n, 0, it == 0 ? S::OPND : 0);")
        .replace("            hopper::tma_load(", "            if (it == 0) "
                 "hopper::tma_load(")),
        (CLUSTER_LOADS[1], CLUSTER_LOADS[1].replace(
            "rg.put(n, 0, S::OPND);", "rg.put(n, 0, it == 0 ? S::OPND : 0);")
         .replace("            hopper::tma_load(", "            if (it == 0) "
                  "hopper::tma_load("))],
}
SLICED_VARIANT_KERNELS = {
    "fwd_sliced": ("fwd",), "pair_no_exchange": ("fwd",),
    "pair_no_loads": ("fwd",), "pair_no_products": ("fwd",),
    "pair_ahead": ("fwd",), "pair_ahead_phantom": ("fwd",),
    "pair_no_softmax": ("fwd",), "sliced": ("dq", "dkv"),
    "no_exchange": ("dq", "dkv"), "exchange_only": ("dq", "dkv"),
    "loads_once": ("dq", "dkv")}
# the routes' bounds a variant's wrappers must route by (its build's
# PAIR_REACH and CLUSTER_REACH)
SLICED_VARIANT_BOUNDS = {"fwd_sliced": {"PAIR_LD": 256},
                         "sliced": {"CLUSTER_LD": 256}}


def main_sliced(names) -> int:
    """The sliced and cluster kernels at SLICED_CASES: SDPA's forward and
    whole backward (its default dispatch and its memory-efficient backend)
    on the base build, then each wrapper's device time for the base build
    and each SLICED_VARIANTS build named (all without names) in turns."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    cases = [x for x in chip_smoke.CASES if x.name in SLICED_CASES]
    print(f"clocks (sm, max sm, power, temperature) before: {clocks()}",
          flush=True)
    libs = {}
    bounds = {"PAIR_LD": A.PAIR_LD, "CLUSTER_LD": A.CLUSTER_LD}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        variants = [(name, edits) for name, edits in SLICED_VARIANTS.items()
                    if not names or name in names]
        for name, edits in [("base", [])] + variants:
            lib, log = build(name, edits, Path(tmp))
            report(name, log, ("fwd", "dq", "dkv"),
                   (A.SLICED, A.CLUSTER, A.PAIR))
            libs[name] = ctypes.CDLL(str(lib))
        bind(libs["base"])
        for case in cases:
            _, sdpa_fwd, sdpa_bwd = case_calls(A, case)
            print(f"  {case.name:13s} sdpa forward device_ms "
                  f"{device_busy_ms(sdpa_fwd):.4f} backward (dq, dk, dv) "
                  f"device_ms {device_busy_ms(sdpa_bwd):.4f}", flush=True)
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn(case.b, n, case.t, case.d,
                                       generator=gen, device="cuda")
                           .to(getattr(torch, case.dtype))
                           for n in (case.h, case.hkv, case.hkv, case.h))
            eff = chip_smoke.sdpa_efficient(q, k, v, do, dict(
                is_causal=case.causal, scale=case.d ** -0.5
                if case.scale is None else case.scale))
            if isinstance(eff, str):
                print(f"  {case.name:13s} sdpa memory-efficient {eff}",
                      flush=True)
            else:
                print(f"  {case.name:13s} sdpa memory-efficient (K, V "
                      f"expanded) forward device_ms "
                      f"{device_busy_ms(eff[0]):.4f} backward device_ms "
                      f"{device_busy_ms(eff[1]):.4f}; ran "
                      f"{chip_smoke.sdpa_kernel(eff[0])!r}, "
                      f"{chip_smoke.sdpa_kernel(eff[1])!r}", flush=True)
            del eff, q, k, v, do
            torch.cuda.empty_cache()
        order = list(libs)
        for r in range(ROUNDS):
            for name in order if r % 2 == 0 else order[::-1]:
                bind(libs[name])
                for key, value in dict(
                        bounds, **SLICED_VARIANT_BOUNDS.get(name, {})).items():
                    setattr(A, key, value)
                A.resolve_tiles.cache_clear()
                kernels = SLICED_VARIANT_KERNELS.get(name,
                                                     ("fwd", "dq", "dkv"))
                for case in cases:
                    print(f"  round {r} {name:13s} "
                          f"{device_line(A, case, kernels)}", flush=True)
        for key, value in bounds.items():
            setattr(A, key, value)
        A.resolve_tiles.cache_clear()
    print(f"clocks (sm, max sm, power, temperature) after: {clocks()}",
          flush=True)
    return 0


def device_busy_ms(fn, reps: int = 10) -> float:
    """Device time of one call of fn, every kernel it launches, as the
    mean over `reps` calls (the profiler)."""
    busy = chip_smoke.device_busy(lambda: [fn() for _ in range(reps)])
    return busy[0] / reps


# whole trees in turns: each wrapper's device time at the main shape, at
# Gemma 2B's attention and at the encoders' shapes
TREE_CASES = ("main", "gemma_2b") + ENCODER_CASES
# and the forward's alone at other cases of its tiled kernel: masked
# (window + sink, ragged), fp16, head dim 128, and the other head-dim-256
# cases
TREE_FWD_CASES = ("main_fp16", "window_sink", "ragged", "d128",
                  "gemma_2b_fp16", "d256_noncausal", "d256_window_sink",
                  "d256_scale_neg", "d160", "d250", "d256_gqa6", "gemma_7b")
TREE_CODE = """\
import importlib.util
import chip_smoke as c
spec = importlib.util.spec_from_file_location("timing", {path!r})
kv = importlib.util.module_from_spec(spec)
spec.loader.exec_module(kv)
from tf_operator_tpu_torch.ops import attention as A
for x, kernels in {cases!r}:
    print("  " + kv.device_line(A, c.Case(*x), kernels), flush=True)
"""


def main_trees(trees) -> int:
    """Each wrapper's device time at TREE_CASES, and the forward's at
    TREE_FWD_CASES, in each tree, in turns, one process per tree per round
    (each imports its own tree's package and builds its own library; the
    timing helpers and the cases are this file's)."""
    cases = [(tuple(x), ("fwd", "dq", "dkv")) for x in chip_smoke.CASES
             if x.name in TREE_CASES]
    cases += [(tuple(x), ("fwd",)) for x in chip_smoke.CASES
              if x.name in TREE_FWD_CASES]
    code = TREE_CODE.format(cases=cases, path=str(Path(__file__).resolve()))
    for r in range(ROUNDS):
        for tree in trees if r % 2 == 0 else trees[::-1]:
            print(f"round {r} tree {tree}:", flush=True)
            proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                                  capture_output=True, text=True, check=False)
            for line in proc.stdout.splitlines():
                if "device_ms" in line:
                    print(f"  {tree}: {line.strip()}", flush=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
                return proc.returncode
    return 0


# f32 dq and dk/dv on the tensor cores: the cases, and the diagnostics of
# what their time is made of (each edit reaches both kernels and leaves one
# part out, so its outputs are wrong, but for one_pass, which computes
# every product in one TF32 pass: the planted fault the f32 rule must
# catch)
F32_CASES = ("main_f32", "gemma_2b_f32", "d512_mqa_f32")
F32_MMA = """\
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""
# each product one FMA of its operands on the CUDA cores (every load and
# split kept): what the tensor cores' products cost
F32_NO_MMA = """\
  d[0] = fmaf(__uint_as_float(a[0] ^ a[1]), __uint_as_float(b0), d[0]);
  d[1] = fmaf(__uint_as_float(a[2] ^ a[3]), __uint_as_float(b1), d[1]);"""
F32_VARIANTS = {
    "no_mma": [(F32_MMA, F32_NO_MMA)],
    # lo passed to the products unrounded (the tensor cores read a TF32
    # operand's top 19 bits, so lo is cut rather than rounded): what the
    # split's rounding of lo costs
    "lo_trunc": [("    s.lo[i] = to_tf32(x[i] - __uint_as_float(s.hi[i]));",
                  "    s.lo[i] = __float_as_uint(x[i] - __uint_as_float(s.hi[i]));")],
    "no_second": [("constexpr bool TF32_SECOND = true;",
                   "constexpr bool TF32_SECOND = false;")],
    "one_pass": [("constexpr int TF32_PASSES = 3;",
                  "constexpr int TF32_PASSES = 1;")],
    "no_exchange": [("constexpr bool TF32_EXCHANGE = true;",
                     "constexpr bool TF32_EXCHANGE = false;")],
    # each 32-column block of a contraction added to the step's sum in f32
    # without the compensation (tf32::kahan): what it costs, and what it
    # holds at large logits
    "no_kahan": [("      tf32::kahan(st[j], sc[j], part[j]);",
                  "      tf32::promote(st[j], part[j]);")],
    # dq without its heavy elements' compensated dP (the code left out,
    # the tensor cores' dP everywhere): what the refinement costs, and what
    # it holds at large logits
    "no_refine": [("      if (heavy) {", "      if (false && heavy) {")],
    # the refinement's dot product out of line, or its branch marked
    # unlikely: what its code costs where it never runs
    "refine_noinline": [("__device__ __forceinline__ float tf32_dp_less(",
                         "__device__ __noinline__ float tf32_dp_less(")],
    "refine_expect": [("      if (heavy) {",
                       "      if (__builtin_expect(heavy != 0, 0)) {")],
}
# large logits (scale -1: logits of standard deviation sqrt(d)) at the
# card's test of the sliced kernels (T 300, 4 query heads over 2 KV heads,
# causal with window 64 and sink 70), by head dim: the classes, the
# cluster at 2, 4 and 8 slices, and beyond its reach
F32_LARGE = (64, 128, 256, 512, 1000, 2048, 2112)
# the cases a diagnostic changes (the exchange runs above head dim 256)
F32_VARIANT_CASES = {"no_exchange": ("d512_mqa_f32",)}
F32_TREE_CODE = """\
import importlib.util
import chip_smoke as c
spec = importlib.util.spec_from_file_location("timing", {path!r})
kv = importlib.util.module_from_spec(spec)
spec.loader.exec_module(kv)
from tf_operator_tpu_torch.ops import attention as A
for x in {cases!r}:
    print("  " + kv.device_line(A, c.Case(*x), ("dq", "dkv")), flush=True)
"""


def f32_large_logits(name) -> None:
    """f32 dq and dk/dv of the bound build at F32_LARGE against the plain
    version in f64 (lse and delta the f32 forward's), beside plain f32
    against the same: (worst err/limit, relative Frobenius) of dq, dk and
    dv."""
    import numpy as np
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    rtol = chip_smoke.RTOL_F32
    for d in F32_LARGE:
        rng = np.random.RandomState(0)
        q, k, v, g = (torch.tensor(rng.randn(1, n, 300, d).astype(
            np.float32), device="cuda") for n in (4, 2, 2, 4))
        opts = dict(scale=-1.0, causal=True, window=64, sink=70)
        o, lse = A.flash_forward(q, k, v, **opts)
        delta = (g * o).sum(-1)
        got = (A.flash_backward_dq(q, k, v, g, lse, delta, **opts),
               *A.flash_backward_dkv(q, k, v, g, lse, delta, **opts))
        plain = (A.backward_dq_plain(q, k, v, g, lse, delta, **opts),
                 *A.backward_dkv_plain(q, k, v, g, lse, delta, **opts))
        wide = [x.double() for x in (q, k, v, g, lse, delta)]
        exact = (A.backward_dq_plain(*wide, **opts),
                 *A.backward_dkv_plain(*wide, **opts))

        def ratios(xs):
            return "; ".join(
                f"{n} {w:.3f} {f:.2e}" for n, (w, f) in zip(
                    ("dq", "dk", "dv"),
                    (chip_smoke.tolerance_ratios(x, e, rtol)
                     for x, e in zip(xs, exact))))
        print(f"  {name:13s} scale -1 D {d:4d} against f64: kernel "
              f"{ratios(got)} | plain f32 {ratios(plain)}", flush=True)


def main_f32(names, parent) -> int:
    """f32 dq and dk/dv at F32_CASES: SDPA's f32 backward (default
    dispatch and memory-efficient backend, with the kernel each ran) on
    the base build, then the device time of dq and of dk/dv for the base
    build, each F32_VARIANTS build named (all without names) and, given a
    parent checkout, the parent's (a process of its own, its own package
    and library), in turns."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    cases = [x for x in chip_smoke.CASES if x.name in F32_CASES]
    print(f"clocks (sm, max sm, power, temperature) before: {clocks()}",
          flush=True)
    libs = {}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        variants = [(name, edits) for name, edits in F32_VARIANTS.items()
                    if not names or name in names]
        for name, edits in [("base", [])] + variants:
            lib, log = build(name, edits, Path(tmp))
            report(name, log, ("dq", "dkv"),
                   (64, 128, 256, A.CLUSTER, A.SLICED), "float32")
            libs[name] = ctypes.CDLL(str(lib))
        for name in libs:
            if name in ("base", "no_kahan", "no_refine"):
                bind(libs[name])
                f32_large_logits(name)
        bind(libs["base"])
        for case in cases:
            _, sdpa_fwd, sdpa_bwd = case_calls(A, case)
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn(case.b, n, case.t, case.d,
                                       generator=gen, device="cuda")
                           for n in (case.h, case.hkv, case.hkv, case.h))
            eff = chip_smoke.sdpa_efficient(q, k, v, do, dict(
                is_causal=case.causal, scale=case.d ** -0.5))
            line = (f"  {case.name:13s} sdpa f32 backward (dq, dk, dv) "
                    f"device_ms {device_busy_ms(sdpa_bwd):.4f} ran "
                    f"{chip_smoke.sdpa_kernel(sdpa_bwd)!r}")
            if isinstance(eff, str):
                line += f"; memory-efficient {eff}"
            else:
                line += (f"; memory-efficient (K, V expanded) device_ms "
                         f"{device_busy_ms(eff[1]):.4f} ran "
                         f"{chip_smoke.sdpa_kernel(eff[1])!r}")
            print(line, flush=True)
            del eff, q, k, v, do
            torch.cuda.empty_cache()
        order = list(libs) + (["parent"] if parent else [])
        code = F32_TREE_CODE.format(cases=[tuple(x) for x in cases],
                                    path=str(Path(__file__).resolve()))
        for r in range(ROUNDS):
            for name in order if r % 2 == 0 else order[::-1]:
                if name == "parent":
                    proc = subprocess.run([sys.executable, "-c", code],
                                          cwd=parent, capture_output=True,
                                          text=True, check=False)
                    for line in proc.stdout.splitlines():
                        if "device_ms" in line:
                            print(f"  round {r} parent        "
                                  f"{line.strip()}", flush=True)
                    if proc.returncode != 0:
                        print(proc.stdout[-4000:] + proc.stderr[-4000:],
                              flush=True)
                        return proc.returncode
                    continue
                bind(libs[name])
                for case in cases:
                    if case.name not in F32_VARIANT_CASES.get(name,
                                                              F32_CASES):
                        continue
                    try:
                        line = device_line(A, case, ("dq", "dkv"))
                    except RuntimeError as e:  # a profile that caught none
                        line = f"{case.name:13s} {e}"
                    print(f"  round {r} {name:13s} {line}", flush=True)
    print(f"clocks (sm, max sm, power, temperature) after: {clocks()}",
          flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--d256", action="store_true",
                        help="dq and dk/dv at head-dim class 256")
    parser.add_argument("--d256-fwd", action="store_true",
                        help="the forward at head-dim class 256")
    parser.add_argument("--encoder", nargs="*", default=None,
                        metavar="VARIANT",
                        help="the forward and dk/dv at the encoders' shapes "
                             "against the ENCODER_VARIANTS named (all "
                             "without names)")
    parser.add_argument("--sliced", nargs="*", default=None,
                        metavar="VARIANT",
                        help="the sliced kernels (head dims above 256) "
                             "against the SLICED_VARIANTS named (all "
                             "without names)")
    parser.add_argument("--trees", nargs="+", default=None,
                        help="checkouts to run chip_smoke's cases in, in "
                             "turns")
    parser.add_argument("--f32", nargs="*", default=None, metavar="VARIANT",
                        help="f32 dq and dk/dv at the f32 cases against the "
                             "F32_VARIANTS named (all without names)")
    parser.add_argument("--parent", default=None,
                        help="with --f32: a checkout whose f32 dq and dk/dv "
                             "are timed in the same turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    if args.trees:
        return main_trees(args.trees)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.d256:
        return main_d256()
    if args.d256_fwd:
        return main_d256_fwd()
    if args.encoder is not None:
        return main_encoder(args.encoder)
    if args.sliced is not None:
        return main_sliced(args.sliced)
    if args.f32 is not None:
        return main_f32(args.f32, args.parent)
    from tf_operator_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, t, d = 8, 12, 2048, 64
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    opts = dict(scale=d ** -0.5, causal=True, window=None, sink=0)
    blocks = dict(block_q=128, block_k=128)
    o, lse = A.flash_forward(q, k, v, **blocks, **opts)
    delta = (do.float() * o.float()).sum(-1)

    def call():
        return A.flash_backward_dq(q, k, v, do, lse, delta, **blocks,
                                   **opts)

    ref = A.backward_dq_plain(*(x.float() for x in (q, k, v, do)), lse, delta,
                              **opts)

    libs = {}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        for name, edits in [("base", [])] + list(VARIANTS.items()):
            lib, log = build(name, edits, Path(tmp))
            report(name, log)
            libs[name] = ctypes.CDLL(str(lib))
        times = {name: [] for name in libs}
        order = list(libs)
        for r in range(ROUNDS):
            for name in order if r % 2 == 0 else order[::-1]:
                bind(libs[name])
                got = call()
                torch.cuda.synchronize()
                worst, rel = chip_smoke.tolerance_ratios(got, ref)
                held = worst <= 1.0 and rel <= chip_smoke.FRO
                ms = chip_smoke.cuda_ms(call, 20)
                times[name].append(ms)
                print(f"  round {r} {name:12s} dq ms {ms:.4f} worst "
                      f"err/limit {worst:.3f} Frobenius {rel:.2e}"
                      f"{'' if held else ' OUTSIDE THE TOLERANCE'}",
                      flush=True)
    for name, ts in times.items():
        print(f"{name:12s} dq mean ms {sum(ts) / len(ts):.4f} over "
              f"{len(ts)} ({' '.join(f'{x:.4f}' for x in ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
