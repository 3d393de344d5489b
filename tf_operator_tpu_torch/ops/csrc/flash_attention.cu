// Flash attention for Hopper (sm_90a): forward with logsumexp, dq, and dk/dv.
//
// These three kernels compute what the Pallas TPU kernels in
// tf_operator_tpu/ops/attention.py compute, written for the GPU rather than
// translated block by block.  Layout at the C boundary: q/o/dq are
// [B*H, T, D] bf16, k/v/dk/dv are [B*Hkv, T, D] bf16, lse and delta are
// compact [B*H, T] f32 rows (no lane-replicated row-scalar tiles).
//
// Shared design (all three kernels):
//   * Products are warp-level mma.sync.m16n8k16 with bf16 operands and f32
//     accumulators; each warp owns 16 rows of the block's output tile and
//     keeps its accumulators in registers.
//   * Where the TPU grid walks its reduction axis sequentially with VMEM
//     scratch, each CUDA block loops over its own reduction range: blocks
//     run in parallel and share nothing, so no atomics are needed.
//   * Masks become loop bounds: the causal upper bound, the sliding-window
//     band, and a sink prefix in front of the band (each tile visited once).
//     Inside a visited tile an element test masks causal/window/sink and the
//     ragged edge (rows or keys >= T), so no input is ever padded in memory.
//   * Tiles are staged in shared memory with a padded row stride (bank
//     spread); operands whose fragment pairs run along the sequence axis are
//     staged transposed.  Loads are plain 16-byte loads with a barrier, no
//     cp.async/TMA pipeline and no wgmma yet: this is the simple, right
//     first version; its time sits beside its bound in PERF.md.
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
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BN = 64;   // inner-loop tile: keys (forward, dq) or queries (dk/dv)
constexpr int PAD = 8;   // halves of padding per shared-memory row

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

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A operand (16 x 16) of a row-major tile s[row * ld + k], rows [0, 16),
// k in [k0, k0 + 16).  g = lane / 4, t = lane % 4.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld,
                                       int k0, int g, int t) {
  const bf16* p = s + g * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B operand (16 x 8) of a tile stored n-major, s[n * ld + k] = B[k][n],
// n in [0, 8), k in [k0, k0 + 16).
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* s, int ld,
                                       int k0, int g, int t) {
  const bf16* p = s + g * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator layout of two neighbouring 16 x 8 tiles is the A-operand
// layout of one 16 x 16 tile: scores become the next product's A in
// registers, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [row0, row0 + nrows) of a [T, D] matrix into shared memory, row-major
// (dst[r * ld + d]) and, when dst_t is given, also transposed
// (dst_t[d * ld_t + r]).  Rows at or past T read as zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, bf16* dst_t,
                                          int ld_t, const bf16* src, int row0,
                                          int nrows, int T) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < nrows * CH; c += blockDim.x) {
    const int r = c / CH, cc = c % CH;
    const int gr = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < T) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + cc * 8);
    }
    if (dst != nullptr) {
      *reinterpret_cast<uint4*>(dst + r * ld + cc * 8) = val;
    }
    if (dst_t != nullptr) {
      const bf16* h = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst_t[(cc * 8 + e) * ld_t + r] = h[e];
    }
  }
}

// Key tiles a query tile [q0, q0 + bm) must visit, in order: `n_sink` sink
// tiles 0.. first, then the band lo..hi-1.  The band starts at the first
// tile the window reaches (0 without a window) and ends at the causal
// diagonal (the last tile without causality).  Sink tiles that fall inside
// the band are left to the band, so no tile is visited twice.
__device__ __forceinline__ void key_tiles(int q0, int bm, const Mask& mk,
                                          int* lo, int* n_sink, int* n_iter) {
  const int n_kt = (mk.T + BN - 1) / BN;
  int hi = n_kt;
  if (mk.causal) hi = min(n_kt, (min(q0 + bm, mk.T) - 1) / BN + 1);
  int l0 = 0;
  if (mk.window > 0) l0 = max(0, q0 - mk.window + 1) / BN;
  int ns = 0;
  if (mk.sink > 0) ns = min((mk.sink + BN - 1) / BN, l0);
  *lo = l0;
  *n_sink = ns;
  *n_iter = ns + (hi - l0);
}

// ---------------------------------------------------------------------------
// Forward.  Replaces tf_operator_tpu/ops/attention.py:_fwd_kernel.
// One block per (query tile of 16*WARPS rows, b*h); it loops over its key
// tiles with an online softmax (running max m, sum l, accumulator in
// registers), then writes o = acc / l (l = 0 -> 1) and lse = m + log l
// (0 for a row with no live key).  Bound: operations (2 products).
template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int group, float scale, Mask mk) {
  constexpr int BM = 16 * WARPS;
  constexpr int LD = D + PAD;
  constexpr int LDT = BN + PAD;
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BM][LD]
  bf16* sK = sQ + BM * LD;                   // [BN][LD]
  bf16* sVt = sK + BN * LD;                  // [D][LDT]

  const int T = mk.T;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qp = q + (size_t)bh * T * D;
  const bf16* kp = k + (size_t)(bh / group) * T * D;
  const bf16* vp = v + (size_t)(bh / group) * T * D;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<D>(sQ, LD, nullptr, 0, qp, q0, BM, T);
  int lo, n_sink, n_iter;
  key_tiles(q0, BM, mk, &lo, &n_sink, &n_iter);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BN;
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(sK, LD, nullptr, 0, kp, k0, BN, T);
    load_tile<D>(nullptr, 0, sVt, LDT, vp, k0, BN, T);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ + warp * 16 * LD, LD, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[2];
        load_b(b, sK + n * 8 * LD, LD, kk * 16, g, t);
        mma16816(s[n], a, b);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + n * 8 + 2 * t + e;
          const float x =
              mk.live(row[h], j) ? s[n][2 * h + e] * scale : -INFINITY;
          s[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // a row with no live key so far keeps m = -inf; exp against 0 then
      // gives p = 0 instead of exp(-inf + inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(s[n][2 * h + e] - m_use);
          s[n][2 * h + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        acc[dn][2 * h] *= alpha;
        acc[dn][2 * h + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        uint32_t b[2];
        load_b(b, sVt + dn * 8 * LDT, LDT, kk * 16, g, t);
        mma16816(acc[dn], a, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row[h];
    if (i >= T) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
    bf16* op = o + ((size_t)bh * T + i) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(op + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dn][2 * h] * inv, acc[dn][2 * h + 1] * inv);
    }
    if (lse != nullptr && t == 0) {
      lse[(size_t)bh * T + i] = l[h] > 0.f ? m[h] + logf(l[h]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// dq.  Replaces tf_operator_tpu/ops/attention.py:_bwd_dq_kernel.
// One block per (query tile, b*h), looping over the same key tiles as the
// forward: p = exp(s - lse), dp = dO V^T, ds = p (dp - delta),
// dq += ds K; dq is written times scale.  Bound: operations (3 products).
template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int group, float scale, Mask mk) {
  constexpr int BM = 16 * WARPS;
  constexpr int LD = D + PAD;
  constexpr int LDT = BN + PAD;
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BM][LD]
  bf16* sdO = sQ + BM * LD;                  // [BM][LD]
  bf16* sK = sdO + BM * LD;                  // [BN][LD]
  bf16* sV = sK + BN * LD;                   // [BN][LD]
  bf16* sKt = sV + BN * LD;                  // [D][LDT]

  const int T = mk.T;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * T * D;
  const bf16* kp = k + (size_t)(bh / group) * T * D;
  const bf16* vp = v + (size_t)(bh / group) * T * D;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < T;
    lse_r[h] = in ? lse[(size_t)bh * T + row[h]] : 0.f;
    delta_r[h] = in ? delta[(size_t)bh * T + row[h]] : 0.f;
  }

  load_tile<D>(sQ, LD, nullptr, 0, q + qoff, q0, BM, T);
  load_tile<D>(sdO, LD, nullptr, 0, dout + qoff, q0, BM, T);
  int lo, n_sink, n_iter;
  key_tiles(q0, BM, mk, &lo, &n_sink, &n_iter);

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BN;
    __syncthreads();
    load_tile<D>(sK, LD, sKt, LDT, kp, k0, BN, T);
    load_tile<D>(sV, LD, nullptr, 0, vp, k0, BN, T);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], a2[4];
      load_a(a, sQ + warp * 16 * LD, LD, kk * 16, g, t);
      load_a(a2, sdO + warp * 16 * LD, LD, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[2];
        load_b(b, sK + n * 8 * LD, LD, kk * 16, g, t);
        mma16816(s[n], a, b);
        load_b(b, sV + n * 8 * LD, LD, kk * 16, g, t);
        mma16816(dp[n], a2, b);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + n * 8 + 2 * t + e;
          const float p = mk.live(row[h], j)
                              ? __expf(s[n][2 * h + e] * scale - lse_r[h])
                              : 0.f;
          s[n][2 * h + e] = p * (dp[n][2 * h + e] - delta_r[h]);
        }
      }
    }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        uint32_t b[2];
        load_b(b, sKt + dn * 8 * LDT, LDT, kk * 16, g, t);
        mma16816(acc[dn], a, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row[h];
    if (i >= T) continue;
    bf16* dp_out = dq + qoff + (size_t)i * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(dp_out + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dn][2 * h] * scale,
                                acc[dn][2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv.  Replaces tf_operator_tpu/ops/attention.py:_bwd_dkv_kernel.
// One block per (key tile of 16*WARPS keys, b*kv_head), looping over every
// query head of the GQA group and, for each, over the query tiles that can
// see the key tile: dv += p^T dO, dk += ds^T Q, summed inside the block (no
// atomics).  Works in the transposed frame (rows are keys).  dk is written
// times scale.  Bound: operations (4 products).
template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
               int kv_heads, float scale, Mask mk) {
  constexpr int BM = 16 * WARPS;
  constexpr int LD = D + PAD;
  constexpr int LDT = BN + PAD;
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [BM][LD]
  bf16* sV = sK + BM * LD;                   // [BM][LD]
  bf16* sQ = sV + BM * LD;                   // [BN][LD]
  bf16* sdO = sQ + BN * LD;                  // [BN][LD]
  bf16* sQt = sdO + BN * LD;                 // [D][LDT]
  bf16* sdOt = sQt + D * LDT;                // [D][LDT]
  float* sL = reinterpret_cast<float*>(sdOt + D * LDT);  // [BN]
  float* sDl = sL + BN;                                  // [BN]

  const int T = mk.T;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = heads / kv_heads;
  // query rows of kv row b: (b / Hkv) * H + (b % Hkv) * group + member
  const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group;
  const size_t koff = (size_t)bkv * T * D;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile<D>(sK, LD, nullptr, 0, k + koff, k0, BM, T);
  load_tile<D>(sV, LD, nullptr, 0, v + koff, k0, BM, T);

  // Query tiles that can see this key tile: from the diagonal (causal) to
  // the last query the window reaches; a tile holding sink keys is seen by
  // every later query, so it keeps the full range.
  const int n_qt = (T + BN - 1) / BN;
  const int qlo = mk.causal ? k0 / BN : 0;
  int qhi = n_qt;
  if (mk.window > 0 && !(mk.sink > 0 && k0 < mk.sink)) {
    qhi = min(n_qt, min(T - 1, k0 + BM - 1 + mk.window - 1) / BN + 1);
  }

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int member = 0; member < group; ++member) {
    const size_t qoff = (size_t)(qbase + member) * T;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * BN;
      __syncthreads();
      load_tile<D>(sQ, LD, sQt, LDT, q + qoff * D, q0, BN, T);
      load_tile<D>(sdO, LD, sdOt, LDT, dout + qoff * D, q0, BN, T);
      for (int c = threadIdx.x; c < BN; c += blockDim.x) {
        const int i = q0 + c;
        sL[c] = i < T ? lse[qoff + i] : 0.f;
        sDl[c] = i < T ? delta[qoff + i] : 0.f;
      }
      __syncthreads();

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], a2[4];
        load_a(a, sK + warp * 16 * LD, LD, kk * 16, g, t);
        load_a(a2, sV + warp * 16 * LD, LD, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b[2];
          load_b(b, sQ + n * 8 * LD, LD, kk * 16, g, t);
          mma16816(s[n], a, b);
          load_b(b, sdO + n * 8 * LD, LD, kk * 16, g, t);
          mma16816(dp[n], a2, b);
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n * 8 + 2 * t + e;
            const float p = mk.live(q0 + c, key[h])
                                ? __expf(s[n][2 * h + e] * scale - sL[c])
                                : 0.f;
            s[n][2 * h + e] = p;
            dp[n][2 * h + e] = p * (dp[n][2 * h + e] - sDl[c]);
          }
        }
      }

#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4], a2[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        c_to_a(a2, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          uint32_t b[2];
          load_b(b, sdOt + dn * 8 * LDT, LDT, kk * 16, g, t);
          mma16816(dv_acc[dn], a, b);
          load_b(b, sQt + dn * 8 * LDT, LDT, kk * 16, g, t);
          mma16816(dk_acc[dn], a2, b);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key[h];
    if (j >= T) continue;
    const size_t off = koff + (size_t)j * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[dn][2 * h] * scale,
                                dk_acc[dn][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[dn][2 * h], dv_acc[dn][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers: dynamic shared memory (above 48 KB needs the opt-in), grid
// (row tiles, b*heads) on the caller's stream; each returns the launch error.

struct FwdArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;
  int group;
  float scale;
  Mask mk;
};

template <int D, int WARPS>
int fwd(int bh, const FwdArgs& a, cudaStream_t stream) {
  constexpr int BM = 16 * WARPS;
  const size_t smem =
      ((BM + BN) * (D + PAD) + D * (BN + PAD)) * sizeof(bf16);
  auto kernel = fwd_kernel<D, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.mk.T + BM - 1) / BM, bh);
  kernel<<<grid, WARPS * 32, smem, stream>>>(a.q, a.k, a.v, a.o, a.lse,
                                             a.group, a.scale, a.mk);
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

template <int D, int WARPS>
int dq(int bh, const BwdArgs& a, cudaStream_t stream) {
  constexpr int BM = 16 * WARPS;
  const size_t smem =
      (2 * BM * (D + PAD) + 2 * BN * (D + PAD) + D * (BN + PAD)) *
      sizeof(bf16);
  auto kernel = dq_kernel<D, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.mk.T + BM - 1) / BM, bh);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.heads / a.kv_heads,
      a.scale, a.mk);
  return (int)cudaGetLastError();
}

template <int D, int WARPS>
int dkv(int bkv, const BwdArgs& a, cudaStream_t stream) {
  constexpr int BM = 16 * WARPS;
  const size_t smem =
      (2 * BM * (D + PAD) + 2 * BN * (D + PAD) + 2 * D * (BN + PAD)) *
          sizeof(bf16) +
      2 * BN * sizeof(float);
  auto kernel = dkv_kernel<D, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.mk.T + BM - 1) / BM, bkv);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.heads, a.kv_heads,
      a.scale, a.mk);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, bound with ctypes (tf_operator_tpu_torch/ops/attention.py).
// head_dim in {64, 128} and warps in {4, 8} (rows per block = 16 * warps)
// are the instantiated shapes; anything else returns cudaErrorInvalidValue.

extern "C" const char* fa_error_string(int err) {
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
  if (head_dim == 64 && warps == 4) return fwd<64, 4>(bh, a, st);
  if (head_dim == 64 && warps == 8) return fwd<64, 8>(bh, a, st);
  if (head_dim == 128 && warps == 4) return fwd<128, 4>(bh, a, st);
  if (head_dim == 128 && warps == 8) return fwd<128, 8>(bh, a, st);
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
  if (head_dim == 64 && warps == 4) return dq<64, 4>(bh, a, st);
  if (head_dim == 64 && warps == 8) return dq<64, 8>(bh, a, st);
  if (head_dim == 128 && warps == 4) return dq<128, 4>(bh, a, st);
  if (head_dim == 128 && warps == 8) return dq<128, 8>(bh, a, st);
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
  if (head_dim == 64 && warps == 4) return dkv<64, 4>(bkv, a, st);
  if (head_dim == 64 && warps == 8) return dkv<64, 8>(bkv, a, st);
  if (head_dim == 128 && warps == 4) return dkv<128, 4>(bkv, a, st);
  if (head_dim == 128 && warps == 8) return dkv<128, 8>(bkv, a, st);
  return (int)cudaErrorInvalidValue;
}
