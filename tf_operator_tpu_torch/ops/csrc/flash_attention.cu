// Flash attention for Hopper (sm_90a): forward with logsumexp, dq, and dk/dv.
//
// These three kernels compute what the Pallas TPU kernels in
// tf_operator_tpu/ops/attention.py compute, written for the GPU rather than
// translated block by block.  Layout at the C boundary: q/o/dq are
// [B*H, T, D] bf16, k/v/dk/dv are [B*Hkv, T, D] bf16, lse and delta are
// compact [B*H, T] f32 rows (no lane-replicated row-scalar tiles).
//
// Shared design (all three kernels):
//   * Where the TPU grid walks its reduction axis sequentially with VMEM
//     scratch, each CUDA block loops over its own reduction range: blocks
//     run in parallel and share nothing, so no atomics are needed.
//   * Masks become loop bounds: the causal upper bound, the sliding-window
//     band, and a sink prefix in front of the band (each tile visited once).
//     Inside a visited tile that is not full, an element test masks
//     causal/window/sink and the ragged edge (rows or keys >= T), so no
//     input is ever padded in memory.
//   * One producer warp (in a warpgroup of its own, which hands its
//     registers to the consumers) keeps tiles in flight through a ring of
//     128-byte-swizzled shared-memory stages filled by TMA (3-D tensor maps,
//     so the zero fill of a ragged tile stops at its own head), and one or
//     two consumer warpgroups issue every product as wgmma, reading each
//     operand in its stored layout (the descriptor's transpose bit where the
//     reduction runs along the sequence axis) and feeding P and dS to the
//     second product from registers.
//
// Bounds on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s), at the LM's
// main-path shape B*H = 96, T = 2048, D = 64, causal, counting two FLOPs per
// multiply-add and only the causal half of the score matrix:
//   forward  2 products, ~51.5 GFLOP -> ~52 us (bytes ~101 MB -> ~30 us)
//   dq       3 products, ~77.3 GFLOP -> ~78 us
//   dk/dv    4 products, ~103 GFLOP  -> ~104 us
// All three are bound by operations, so the design keeps every product on
// the tensor cores, keeps the T x T score tile out of device memory, and
// skips causally dead tiles outright (the loop never reaches them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// Which (query i, key j) pairs attend: the same predicate as the plain
// version's mask (causal, sliding window with optional sink prefix) plus
// the ragged edge, since nothing is padded in memory.
struct Mask {
  int T;
  int causal;
  int window;  // 0 = no window (a window implies causal)
  int sink;    // 0 = no sink (a sink implies a window)

  __device__ __forceinline__ bool live(int i, int j) const {
    if (i >= T || j >= T) return false;
    if (causal && j > i) return false;
    if (window > 0 && i - j >= window && j >= sink) return false;
    return true;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma accumulator layout of m64nN (per thread, warp w of the
// warpgroup, lane g * 4 + t: d[4j + 2h + e] is row 16w + g + 8h, column
// 8j + 2t + e) is also the layout of an A operand held in registers, so
// columns 16kk..16kk+15 of it, rounded to bf16, are the A fragment of k
// step kk of the next product.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N],
                                         int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Key tiles a query tile [q0, q0 + bm) must visit, in order: `n_sink` sink
// tiles 0.. first, then the band lo..hi-1.  The band starts at the first
// tile the window reaches (0 without a window) and ends at the causal
// diagonal (the last tile without causality).  Sink tiles that fall inside
// the band are left to the band, so no tile is visited twice.  Tiles are
// BK keys wide.
template <int BK>
__device__ __forceinline__ void key_tiles(int q0, int bm, const Mask& mk,
                                          int* lo, int* n_sink, int* n_iter) {
  const int n_kt = (mk.T + BK - 1) / BK;
  int hi = n_kt;
  if (mk.causal) hi = min(n_kt, (min(q0 + bm, mk.T) - 1) / BK + 1);
  int l0 = 0;
  if (mk.window > 0) l0 = max(0, q0 - mk.window + 1) / BK;
  int ns = 0;
  if (mk.sink > 0) ns = min((mk.sink + BK - 1) / BK, l0);
  *lo = l0;
  *n_sink = ns;
  *n_iter = ns + (hi - l0);
}

// ---------------------------------------------------------------------------
// Shared by the kernels.

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// True when every pair of queries [i0, i0 + ni) x keys [j0, j0 + nj)
// attends, so the element test can be skipped: interior tiles.  The
// causal diagonal, window-edge, sink and ragged tiles are not full.
__device__ __forceinline__ bool tile_full(const Mask& mk, int i0, int ni,
                                          int j0, int nj) {
  if (i0 + ni > mk.T || j0 + nj > mk.T) return false;
  if (mk.causal && j0 + nj - 1 > i0) return false;
  if (mk.window > 0 && i0 + ni - 1 - j0 >= mk.window && j0 + nj > mk.sink)
    return false;
  return true;
}

// Zeroes the dead elements of one m64nN accumulator tile of scores (this
// thread's rows row0 and row0 + 8, keys k0 + column): Mask::live, with
// each row's live keys taken once as bounds relative to the thread's first
// column (an upper bound from the causal diagonal and the ragged edge; under
// a window a lower bound, with the sink prefix kept), so that an element
// costs compares against constants.
template <int N>
__device__ __forceinline__ void mask_tile(float (&s)[N], const Mask& mk,
                                          int row0, int k0, int t) {
  const int j0 = k0 + 2 * t;
  const int sink = mk.sink - j0;
  int hi[2], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    int last = mk.causal ? min(i, mk.T - 1) : mk.T - 1;
    if (i >= mk.T) last = -1;
    hi[h] = last - j0;
    lo[h] = mk.window > 0 ? i - mk.window + 1 - j0 : INT_MIN;
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int c = 8 * (x >> 2) + (x & 1), h = (x >> 1) & 1;
    if (!(c <= hi[h] && (c >= lo[h] || c < sink))) s[x] = 0.f;
  }
}

// The dynamic shared memory, moved up to a 1024-byte boundary (the
// 128-byte swizzle repeats every 8 lines); launches ask for 1 KB of slack.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// Forward.  Replaces tf_operator_tpu/ops/attention.py:_fwd_kernel.
//
// One block per (query tile of 64 * WG rows, b*h): WG consumer warpgroups
// of 64 query rows each and a producer warpgroup, whose first thread loads
// the Q tile once and keeps K/V tiles of BK keys in flight through a ring
// of STAGES 128-byte-swizzled stages (TMA, completion on an mbarrier per
// stage; the consumers free a stage on a second mbarrier).  Key tiles come
// in key_tiles' order (sinks, then the band).  Per key tile each consumer
// warpgroup issues S = Q K^T (wgmma, both operands K-major as stored), runs
// the online softmax on the accumulators, and issues O += P V with P from
// registers and V read as stored through the descriptor's transpose bit.
// The softmax works in the base-2 domain with log2(e) folded into the
// scale, and runs the element mask only on tiles that are not full.
// o = acc / l (l = 0 -> 1), lse = m + log l (0 for a row with no live
// key).  Bound: operations (2 products).  At head_dim 64 the exponentials
// (one per score, 16 per clock on an SM) cost about as much as the
// products, so the two consumer warpgroups of a block are left to
// interleave one's softmax with the other's products.  At head_dim 64 a
// block takes the whole SM, which gives its consumers 240 registers and
// room for 128-key tiles; PERF.md has the variants this was chosen from.
template <int D, int WG>
struct FwdSmem {
  static constexpr int BM = 64 * WG;
  static constexpr int BK = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int BLOCKS = WG == 2 ? 1 : 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// Online softmax of one score tile (the accumulator of S = Q K^T, BK keys
// from k0) for this thread's two rows: masks the tile unless it is full,
// updates the running max m (base 2) and this thread's share of the row
// sums l, leaves p in s, and returns in alpha the factor the output
// accumulator is to be rescaled by.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const Mask& mk, int r0,
                                               int row0, int k0, int t,
                                               float sl2) {
  if (!tile_full(mk, r0, 64, k0, BK)) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const int j = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
      if (!mk.live(row0 + 8 * ((x >> 1) & 1), j)) s[x] = -INFINITY;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // row max of the raw scores (the scale is positive), in 4 chains
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx[j & 3] = fmaxf(mx[j & 3], fmaxf(s[4 * j + 2 * h],
                                         s[4 * j + 2 * h + 1]));
    float rmax = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
    const float m_new = fmaxf(m[h], rmax * sl2);
    // a row with no live key so far keeps m = -inf; exp against 0 then
    // gives p = 0 instead of exp(-inf + inf)
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = exp2_approx(m[h] - m_use);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2_approx(fmaf(s[4 * j + 2 * h + e], sl2, -m_use));
        s[4 * j + 2 * h + e] = p;
        sum[e] += p;
      }
    }
    l[h] = l[h] * alpha[h] + (sum[0] + sum[1]);
    m[h] = m_new;
  }
}

template <int D, int WG>
__global__ void __launch_bounds__(128 * (WG + 1), FwdSmem<D, WG>::BLOCKS)
    fwd_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               bf16* __restrict__ o, float* __restrict__ lse, int group,
               float scale, Mask mk) {
  using S = FwdSmem<D, WG>;
  constexpr int BM = S::BM, BK = S::BK, STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t sKV = sQ + S::Q_BYTES;  // stage s: K, then V
  const uint32_t bars = sQ + S::BAR_OFF;  // full[STAGES], empty[STAGES], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int T = mk.T;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (STAGES + s), WG * 128);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WG * 128) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == WG * 128) {
      const int bkv = bh / group;
      hopper::mbar_arrive_tx(q_bar, S::Q_BYTES);
      hopper::tma_tile<D>(sQ, &map_q, BM, q0, bh, q_bar);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          hopper::mbar_wait(bars + 8 * (STAGES + s), (it / STAGES - 1) & 1);
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        const uint32_t sk = sKV + s * S::STAGE_BYTES;
        hopper::mbar_arrive_tx(bars + 8 * s, S::STAGE_BYTES);
        hopper::tma_tile<D>(sk, &map_k, BK, k0, bkv, bars + 8 * s);
        hopper::tma_tile<D>(sk + S::KV_BYTES, &map_v, BK, k0, bkv,
                            bars + 8 * s);
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(WG, S::BLOCKS)>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t sQw = sQ + wg * 64 * 128;
  const float sl2 = scale * LOG2E;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float acc[D / 64][32];
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
    const uint32_t sk = sKV + s * S::STAGE_BYTES, sv = sk + S::KV_BYTES;
    hopper::mbar_wait(bars + 8 * s, (it / STAGES) & 1);

    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss(sc, hopper::desc_k(sQw, BM, kk),
                       hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);

    online_softmax<BK>(sc, m, l, alpha, mk, r0, row0, k0, t, sl2);
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[dh][x] *= alpha[(x >> 1) & 1];
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::wgmma_rs64(acc[h], pa[kk], hopper::desc_mn(sv, BK, kk, h));
    }
    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(acc[h]);
    hopper::mbar_arrive(bars + 8 * (STAGES + s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int i = row0 + 8 * h;
    if (i >= T) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
    bf16* op = o + ((size_t)bh * T + i) * D;
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(op + dh * 64 + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[dh][4 * j + 2 * h] * inv,
                                  acc[dh][4 * j + 2 * h + 1] * inv);
      }
    }
    if (lse != nullptr && t == 0) {
      lse[(size_t)bh * T + i] = l[h] > 0.f ? m[h] * LN2 + logf(l[h]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// dq.  Replaces tf_operator_tpu/ops/attention.py:_bwd_dq_kernel.
//
// One block per (query tile of 64 * WG rows, b*h), longest rows first: WG
// consumer warpgroups of 64 query rows each and a producer warpgroup, whose
// first thread loads the block's Q and dO tiles once and keeps K/V tiles of
// BK keys in flight through a ring of STAGES stages (TMA, full/empty
// mbarriers), in key_tiles' order (sinks, then the band), each K/V tile
// read at the query head's KV head (GQA).  Per key tile each consumer
// warpgroup issues S = Q K^T and dP = dO V^T (wgmma, all four operands
// K-major as stored), forms p = exp2(s * scale * log2 e - lse * log2 e)
// and ds = p (dp - delta) with the element mask only on tiles that are not
// full, and issues dQ += dS K with dS from registers and the same K stage
// read through the descriptor's transpose bit: one copy of K in shared
// memory serves both of its products.  The dq sum stays inside the block
// (no atomics, deterministic); dq is written times scale.  A row with no
// live key (rows past T) has lse 0, so p stays finite before the mask.
// Bound: operations (3 products, ~77.3 GFLOP at the main shape -> ~78 us).
// Against it the design keeps all three products on wgmma with no operand
// staged twice, overlaps the loads with the products, and keeps the
// exponentials (one per score, as in the forward, but with no running max
// or rescale) down to one FMA and one ex2 each.  At head_dim 64, 128-key
// tiles hold S, dP (64 floats each) and the dQ accumulator (32) in the
// consumers' 240 registers (232 with two blocks per SM); the element mask
// takes per-row bounds (mask_tile), since Mask::live on each element made
// the compiler hold 64 results in registers and spill.  Two consumer
// warpgroups keep four stages in flight (PERF.md has the variants this was
// chosen from).
template <int D, int WG>
struct DqSmem {
  static constexpr int BM = 64 * WG;
  static constexpr int BK = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int BLOCKS = WG == 2 ? 1 : 2;
  // two blocks of one warpgroup share an SM's 227 KB
  static constexpr int STAGES = WG == 2 ? 4 : 2;
  static constexpr int QT_BYTES = BM * D * 2;  // the Q or dO tile
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING_OFF = 2 * QT_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

template <int D, int WG>
__global__ void __launch_bounds__(128 * (WG + 1), DqSmem<D, WG>::BLOCKS)
    dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int group, float scale, Mask mk) {
  using S = DqSmem<D, WG>;
  constexpr int BM = S::BM, BK = S::BK, STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t sdO = sQ + S::QT_BYTES;
  const uint32_t ring = sQ + S::RING_OFF;  // stage s: K, then V
  const uint32_t bars = sQ + S::BAR_OFF;   // full[STAGES], empty[STAGES], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int T = mk.T;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (STAGES + s), WG * 128);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WG * 128) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == WG * 128) {
      const int bkv = bh / group;
      hopper::mbar_arrive_tx(q_bar, 2 * S::QT_BYTES);
      hopper::tma_tile<D>(sQ, &map_q, BM, q0, bh, q_bar);
      hopper::tma_tile<D>(sdO, &map_do, BM, q0, bh, q_bar);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          hopper::mbar_wait(bars + 8 * (STAGES + s), (it / STAGES - 1) & 1);
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        const uint32_t sk = ring + s * S::STAGE_BYTES;
        hopper::mbar_arrive_tx(bars + 8 * s, S::STAGE_BYTES);
        hopper::tma_tile<D>(sk, &map_k, BK, k0, bkv, bars + 8 * s);
        hopper::tma_tile<D>(sk + S::KV_BYTES, &map_v, BK, k0, bkv,
                            bars + 8 * s);
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(WG, S::BLOCKS)>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t sQw = sQ + wg * 64 * 128, sdOw = sdO + wg * 64 * 128;
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];  // lse * log2 e and delta of this thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    lse2[h] = i < T ? lse[(size_t)bh * T + i] * LOG2E : 0.f;
    dl[h] = i < T ? delta[(size_t)bh * T + i] : 0.f;
  }

  float dq_acc[D / 64][32];
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
    const uint32_t sk = ring + s * S::STAGE_BYTES, sv = sk + S::KV_BYTES;
    hopper::mbar_wait(bars + 8 * s, (it / STAGES) & 1);

    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::wgmma_ss(sc, hopper::desc_k(sQw, BM, kk),
                       hopper::desc_k(sk, BK, kk), kk > 0);
      hopper::wgmma_ss(dp, hopper::desc_k(sdOw, BM, kk),
                       hopper::desc_k(sv, BK, kk), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::wg_fence_regs(dp);

#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      sc[x] = exp2_approx(fmaf(sc[x], sl2, -lse2[(x >> 1) & 1]));
    if (!tile_full(mk, r0, 64, k0, BK)) mask_tile(sc, mk, row0, k0, t);
#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      dp[x] = sc[x] * (dp[x] - dl[(x >> 1) & 1]);  // ds
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(da[kk], dp, kk);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::wgmma_rs64(dq_acc[h], da[kk],
                           hopper::desc_mn(sk, BK, kk, h));
    }
    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(dq_acc[h]);
    hopper::mbar_arrive(bars + 8 * (STAGES + s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    if (i >= T) continue;
    bf16* out = dq + ((size_t)bh * T + i) * D;
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + dh * 64 + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dq_acc[dh][4 * j + 2 * h] * scale,
                                  dq_acc[dh][4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv.  Replaces tf_operator_tpu/ops/attention.py:_bwd_dkv_kernel.
//
// One block per (key tile of 64 * WG keys, b*kv_head), in the transposed
// frame (rows are keys): WG consumer warpgroups of 64 keys each and a
// producer warpgroup, whose first warp loads K and V once and then walks
// every query head of the GQA group and, for each, the query tiles of BQ
// rows that can see the key tile, putting each tile's Q, dO, lse (times
// log2 e) and delta through a ring of STAGES stages (Q and dO by TMA, the
// two rows by the warp's lanes; 32 arrivals plus the TMA bytes complete a
// stage).  Per query tile each warpgroup issues S^T = K Q^T and
// dP^T = V dO^T (wgmma, K-major as stored), forms p = exp(s - lse) and
// ds = p (dp - delta) with the element mask only on tiles that are not
// full, then dV += P^T dO and dK += dS^T Q with P^T and dS^T from
// registers and dO, Q read as stored through the transpose bit.  The GQA
// sum stays inside the block (no atomics, deterministic).  dk is written
// times scale.  BQ is 32 at head_dim 128 so that the two [64 x 128]
// accumulators and the two [64 x BQ] score tiles fit in registers.
// Bound: operations (4 products).
template <int D, int WG>
struct DkvSmem {
  static constexpr int BM = 64 * WG;
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int STAGES = 3;
  static constexpr int BLOCKS = WG == 2 ? 1 : 2;
  static constexpr int KV_BYTES = BM * D * 2;  // K or V
  static constexpr int QT_BYTES = BQ * D * 2;  // Q or dO tile
  static constexpr int STAGE_BYTES =
      (2 * QT_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

template <int D, int WG>
__global__ void __launch_bounds__(128 * (WG + 1), DkvSmem<D, WG>::BLOCKS)
    dkv_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
               int kv_heads, float scale, Mask mk) {
  using S = DkvSmem<D, WG>;
  constexpr int BM = S::BM, BQ = S::BQ, STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sK = hopper::smem_addr(smem);
  const uint32_t sV = sK + S::KV_BYTES;
  const uint32_t ring = sK + S::RING_OFF;  // stage: Q, dO, lse2[BQ], delta[BQ]
  const uint32_t bars = sK + S::BAR_OFF;   // full[STAGES], empty[STAGES], kv
  const uint32_t kv_bar = bars + 16 * STAGES;

  const int T = mk.T;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BM;
  const int group = heads / kv_heads;
  // query rows of kv row b: (b / Hkv) * H + (b % Hkv) * group + member
  const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group;

  // Query tiles that can see this key tile: from the diagonal (causal) to
  // the last query the window reaches; a tile holding sink keys is seen by
  // every later query, so it keeps the full range.
  const int n_qt = (T + BQ - 1) / BQ;
  const int qlo = mk.causal ? k0 / BQ : 0;
  int qhi = n_qt;
  if (mk.window > 0 && !(mk.sink > 0 && k0 < mk.sink)) {
    qhi = min(n_qt, min(T - 1, k0 + BM - 1 + mk.window - 1) / BQ + 1);
  }
  const int nq = qhi - qlo;
  const int n_iter = group * nq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bars + 8 * s, 32);
      hopper::mbar_init(bars + 8 * (STAGES + s), WG * 128);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WG * 128) {  // producer warpgroup: its first warp
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x >= WG * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::mbar_arrive_tx(kv_bar, 2 * S::KV_BYTES);
      hopper::tma_tile<D>(sK, &map_k, BM, k0, bkv, kv_bar);
      hopper::tma_tile<D>(sV, &map_v, BM, k0, bkv, kv_bar);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES)
        hopper::mbar_wait(bars + 8 * (STAGES + s), (it / STAGES - 1) & 1);
      const int bh = qbase + it / nq;
      const int q0 = (qlo + it % nq) * BQ;
      const uint32_t st = ring + s * S::STAGE_BYTES;
      float* rows = reinterpret_cast<float*>(smem + S::RING_OFF +
                                             s * S::STAGE_BYTES +
                                             2 * S::QT_BYTES);
      for (int c = lane; c < BQ; c += 32) {
        const int i = q0 + c;
        const size_t off = (size_t)bh * T + i;
        rows[c] = i < T ? lse[off] * LOG2E : 0.f;
        rows[BQ + c] = i < T ? delta[off] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_arrive_tx(bars + 8 * s, 2 * S::QT_BYTES);
        hopper::tma_tile<D>(st, &map_q, BQ, q0, bh, bars + 8 * s);
        hopper::tma_tile<D>(st + S::QT_BYTES, &map_do, BQ, q0, bh,
                            bars + 8 * s);
      } else {
        hopper::mbar_arrive(bars + 8 * s);
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(WG, S::BLOCKS)>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + 64 * wg;  // this warpgroup's first key
  const int key[2] = {kr0 + warp * 16 + g, kr0 + warp * 16 + g + 8};
  const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;
  const float sl2 = scale * LOG2E;

  float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  hopper::mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int q0 = (qlo + it % nq) * BQ;
    const uint32_t sq = ring + s * S::STAGE_BYTES, sdo = sq + S::QT_BYTES;
    const float* rows = reinterpret_cast<const float*>(
        smem + S::RING_OFF + s * S::STAGE_BYTES + 2 * S::QT_BYTES);
    hopper::mbar_wait(bars + 8 * s, (it / STAGES) & 1);

    float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::wgmma_ss(sc, hopper::desc_k(sKw, BM, kk),
                       hopper::desc_k(sq, BQ, kk), kk > 0);
      hopper::wgmma_ss(dp, hopper::desc_k(sVw, BM, kk),
                       hopper::desc_k(sdo, BQ, kk), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::wg_fence_regs(dp);

#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const float lse2 = rows[8 * (x >> 2) + 2 * t + (x & 1)];
      sc[x] = exp2_approx(fmaf(sc[x], sl2, -lse2));
    }
    if (!tile_full(mk, q0, BQ, kr0, 64)) {
#pragma unroll
      for (int x = 0; x < BQ / 2; ++x) {
        const int i = q0 + 8 * (x >> 2) + 2 * t + (x & 1);
        if (!mk.live(i, key[(x >> 1) & 1])) sc[x] = 0.f;
      }
    }
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const float dl = rows[BQ + 8 * (x >> 2) + 2 * t + (x & 1)];
      dp[x] = sc[x] * (dp[x] - dl);
    }

    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a(pa[kk], sc, kk);
      acc_to_a(da[kk], dp, kk);
    }
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        hopper::wgmma_rs64(dv_acc[h], pa[kk], hopper::desc_mn(sdo, BQ, kk, h));
        hopper::wgmma_rs64(dk_acc[h], da[kk], hopper::desc_mn(sq, BQ, kk, h));
      }
    }
    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      hopper::wg_fence_regs(dv_acc[h]);
      hopper::wg_fence_regs(dk_acc[h]);
    }
    hopper::mbar_arrive(bars + 8 * (STAGES + s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key[h];
    if (j >= T) continue;
    const size_t off = ((size_t)bkv * T + j) * D;
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int x = 4 * n + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + dh * 64 + 8 * n +
                                           2 * t) =
            __floats2bfloat162_rn(dk_acc[dh][x] * scale,
                                  dk_acc[dh][x + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + dh * 64 + 8 * n +
                                           2 * t) =
            __floats2bfloat162_rn(dv_acc[dh][x], dv_acc[dh][x + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers: dynamic shared memory (above 48 KB needs the opt-in), grid
// (row tiles, b*heads) on the caller's stream; each returns the launch error.
// Each launcher first encodes its tensor maps (a few microseconds of host
// time per call); a failed encoding returns TENSOR_MAP_ERROR + its
// CUresult.

constexpr int TENSOR_MAP_ERROR = 100000;

struct FwdArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;
  int group;
  float scale;
  Mask mk;
};

template <int D, int WG>
int fwd(int bh, const FwdArgs& a, cudaStream_t stream) {
  using S = FwdSmem<D, WG>;
  const int T = a.mk.T;
  if (!(a.scale > 0.f)) return (int)cudaErrorInvalidValue;  // max of raw s
  CUtensorMap map_q, map_k, map_v;
  int e;
  if ((e = hopper::tile_map(&map_q, a.q, bh, T, D, S::BM)) ||
      (e = hopper::tile_map(&map_k, a.k, bh / a.group, T, D, S::BK)) ||
      (e = hopper::tile_map(&map_v, a.v, bh / a.group, T, D, S::BK)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = fwd_kernel<D, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + S::BM - 1) / S::BM, bh);
  kernel<<<grid, 128 * (WG + 1), S::BYTES, stream>>>(
      map_q, map_k, map_v, a.o, a.lse, a.group, a.scale, a.mk);
  return (int)cudaGetLastError();
}

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int heads, kv_heads;
  float scale;
  Mask mk;
};

template <int D, int WG>
int dq(int bh, const BwdArgs& a, cudaStream_t stream) {
  using S = DqSmem<D, WG>;
  const int T = a.mk.T;
  const int group = a.heads / a.kv_heads;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, a.q, bh, T, D, S::BM)) ||
      (e = hopper::tile_map(&map_k, a.k, bh / group, T, D, S::BK)) ||
      (e = hopper::tile_map(&map_v, a.v, bh / group, T, D, S::BK)) ||
      (e = hopper::tile_map(&map_do, a.dout, bh, T, D, S::BM)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = dq_kernel<D, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + S::BM - 1) / S::BM, bh);
  kernel<<<grid, 128 * (WG + 1), S::BYTES, stream>>>(
      map_q, map_k, map_v, map_do, a.lse, a.delta, a.dq, group, a.scale,
      a.mk);
  return (int)cudaGetLastError();
}

template <int D, int WG>
int dkv(int bkv, const BwdArgs& a, cudaStream_t stream) {
  using S = DkvSmem<D, WG>;
  const int T = a.mk.T;
  const int bh = bkv / a.kv_heads * a.heads;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, a.q, bh, T, D, S::BQ)) ||
      (e = hopper::tile_map(&map_k, a.k, bkv, T, D, S::BM)) ||
      (e = hopper::tile_map(&map_v, a.v, bkv, T, D, S::BM)) ||
      (e = hopper::tile_map(&map_do, a.dout, bh, T, D, S::BQ)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = dkv_kernel<D, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + S::BM - 1) / S::BM, bkv);
  kernel<<<grid, 128 * (WG + 1), S::BYTES, stream>>>(
      map_q, map_k, map_v, map_do, a.lse, a.delta, a.dk, a.dv, a.heads,
      a.kv_heads, a.scale, a.mk);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, bound with ctypes (tf_operator_tpu_torch/ops/attention.py).
// head_dim in {64, 128} and warps in {4, 8} (rows per block = 16 * warps:
// one or two consumer warpgroups of 64 rows) are the instantiated shapes;
// anything else returns cudaErrorInvalidValue.

extern "C" const char* fa_error_string(int err) {
  static char buf[96];
  if (err >= TENSOR_MAP_ERROR - 1) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (%d)",
             err - TENSOR_MAP_ERROR);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          void* lse, int bh, int heads, int kv_heads, int T,
                          int head_dim, int warps, float scale, int causal,
                          int window, int sink, void* stream) {
  FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v),  static_cast<bf16*>(o),
            static_cast<float*>(lse),     heads / kv_heads,
            scale,                        Mask{T, causal, window, sink}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 && warps == 4) return fwd<64, 1>(bh, a, st);
  if (head_dim == 64 && warps == 8) return fwd<64, 2>(bh, a, st);
  if (head_dim == 128 && warps == 4) return fwd<128, 1>(bh, a, st);
  if (head_dim == 128 && warps == 8) return fwd<128, 2>(bh, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fa_backward_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq_out, int bh,
                              int heads, int kv_heads, int T, int head_dim,
                              int warps, float scale, int causal, int window,
                              int sink, void* stream) {
  BwdArgs a{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
            static_cast<const bf16*>(v),     static_cast<const bf16*>(dout),
            static_cast<const float*>(lse),  static_cast<const float*>(delta),
            static_cast<bf16*>(dq_out),      nullptr,
            nullptr,                         heads,
            kv_heads,                        scale,
            Mask{T, causal, window, sink}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 && warps == 4) return dq<64, 1>(bh, a, st);
  if (head_dim == 64 && warps == 8) return dq<64, 2>(bh, a, st);
  if (head_dim == 128 && warps == 4) return dq<128, 1>(bh, a, st);
  if (head_dim == 128 && warps == 8) return dq<128, 2>(bh, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fa_backward_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk_out, void* dv_out,
                               int bkv, int heads, int kv_heads, int T,
                               int head_dim, int warps, float scale,
                               int causal, int window, int sink,
                               void* stream) {
  BwdArgs a{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
            static_cast<const bf16*>(v),     static_cast<const bf16*>(dout),
            static_cast<const float*>(lse),  static_cast<const float*>(delta),
            nullptr,                         static_cast<bf16*>(dk_out),
            static_cast<bf16*>(dv_out),      heads,
            kv_heads,                        scale,
            Mask{T, causal, window, sink}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 && warps == 4) return dkv<64, 1>(bkv, a, st);
  if (head_dim == 64 && warps == 8) return dkv<64, 2>(bkv, a, st);
  if (head_dim == 128 && warps == 4) return dkv<128, 1>(bkv, a, st);
  if (head_dim == 128 && warps == 8) return dkv<128, 2>(bkv, a, st);
  return (int)cudaErrorInvalidValue;
}
