// Flash attention for Hopper (sm_90a): forward with logsumexp, dq, and dk/dv.
//
// These three kernels compute what the Pallas TPU kernels in
// tf_operator_tpu/ops/attention.py compute, written for the GPU rather than
// translated block by block.  Layout at the C boundary: q/o/dq are
// [B*H, T, ld], k/v/dk/dv are [B*Hkv, T, ld], all of one element type (bf16,
// fp16 or f32), lse and delta are compact [B*H, T] f32 rows (no
// lane-replicated row-scalar tiles).
//
// What the kernels take (all that the Pallas kernels take):
//   * bf16 and fp16: the tensor-core kernels, templated on the element type
//     E (wgmma's bf16 or f16 form; P and dS are rounded to E before their
//     second product, outputs are written in E).  f32: behind the same C
//     entry points, the forward on SIMT kernels of its own (f32 products
//     and sums, as the Pallas kernels compute in f32 inside; one TF32 pass
//     would round the products), dq and dk/dv on the tensor cores in three
//     TF32 passes (dq_tf32_kernel, dkv_tf32_kernel, tf32.cuh).
//   * Head dims: the tensor-core kernels are built for the head-dim classes
//     D = 64, 128 and 256, and a stored head dim ld runs on the smallest
//     class that holds it: 8..64 on D 64, 72..128 on D 128, 136..256 on
//     D 256.  ld is a multiple of 8 (TMA takes row strides in multiples of
//     16 bytes; the Python wrapper pads any other head dim up to the next
//     multiple of 8 and slices the outputs).  The tensor maps zero-fill the
//     columns past ld (a 64-column box wholly past it included), so Q K^T
//     and dO V^T are unchanged, and the epilogues store only the columns <
//     ld.  The f32 forward takes any ld up to 256 on DMAX 64, 128 or 256
//     (dq and dk/dv: on 64, 128 or 256 columns a block).
//     Every ld above 256 runs on the sliced kernels (below: each block one
//     256-column slice of the outputs, the head dim streamed through shared
//     memory in 64-column chunks), in bf16, fp16 and f32, with no bound of
//     their own on ld; but dq and dk/dv in bf16 and fp16 up to ld
//     CLUSTER_REACH (1024) run on the cluster kernels (below: the blocks
//     of a row or key tile's slices form a thread-block cluster that splits
//     the head dim's contraction and sums S and dP across its blocks), and
//     the forward in bf16 and fp16 up to ld PAIR_REACH (512) on the pair
//     forward (below: a block's two consumer warpgroups split the head dim
//     and sum their partial S through shared memory), and dq and dk/dv in
//     f32 up to ld TF32_REACH (2048) on dq_tf32_kernel's and
//     dkv_tf32_kernel's clusters (the same split of the contraction across
//     a row or key tile's slices; above it a block for each slice
//     contracts the whole head dim).
//   * Any scale: dq and dk/dv form p = exp(s * scale - lse) for any scale.
//     The forward takes the row max of the raw scores, which is the max of
//     the scaled ones only for scale > 0; every other scale (negative, 0,
//     NaN) takes the forward's SCALED instantiation, which scales the scores
//     before the mask and the max (the caller picks the route,
//     ops/attention.py:scales_first; scaled = 0 with a scale that is not
//     positive returns cudaErrorInvalidValue).
//   * Any batch*heads: the grid is one dimension of (b*h, row tile) pairs,
//     up to 2^31 - 1 blocks (grid_tile).
//   * Tiles follow the JAX kernels' two numbers: the forward and dq take
//     their rows per block from block_q and their key step from block_k;
//     dk/dv take its key rows per block from block_k and its query step
//     from block_q.  The instantiated tiles are listed at the dispatchers
//     below (ops/attention.py's INSTANTIATED mirrors them, and resolve_tiles
//     maps any pair of blocks onto them); any other tile returns
//     cudaErrorInvalidValue.
//
// Shared design (the three tensor-core kernels):
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
// Bounds on an H100 SXM (989 TFLOP/s dense bf16 and fp16, 3.35 TB/s), at
// the LM's main-path shape B*H = 96, T = 2048, D = 64, causal, counting two
// FLOPs per multiply-add and only the causal half of the score matrix:
//   forward  2 products, ~51.5 GFLOP -> ~52 us (bytes ~101 MB -> ~30 us)
//   dq       3 products, ~77.3 GFLOP -> ~78 us
//   dk/dv    4 products, ~103 GFLOP  -> ~104 us
// All three are bound by operations, so the design keeps every product on
// the tensor cores, keeps the T x T score tile out of device memory, and
// skips causally dead tiles outright (the loop never reaches them).
//
// FA_PART selects a translation unit: ops/_build.py compiles the parts in
// parallel and links them into one library.  1-4: the forward in bf16 and
// fp16, each route apart; 5-6: dq, 7-8: dk/dv in bf16 and fp16; 9: the f32
// kernels; 10: the C interface (which sends head-dim class 256 to parts
// 11-15, head dims above 256 to parts 16-20, and dq's and dk/dv's up to
// CLUSTER_REACH in bf16 and fp16 to parts 21-24, the forward's up to
// PAIR_REACH in bf16 and fp16 to parts 25-26, and dk/dv's and dq's up to
// TF32_REACH in f32 to parts 27 and 28); 11-12: the forward at
// D 256 in bf16 and fp16; 13: dq and 14: dk/dv at D 256 (with the
// reduction of its slices' partials); 15: the f32 kernels at D 256; 16-17:
// the sliced forward in bf16 and fp16; 18: the sliced dq and 19: dk/dv;
// 20: the sliced f32 kernels; 21-22: the cluster dq in bf16 and fp16;
// 23-24: the cluster dk/dv in bf16 and fp16; 25-26: the pair forward in
// bf16 and fp16; 27: the f32 dk/dv's cluster; 28: the f32 dq's cluster; 0
// (unset): every part in one unit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

#ifndef FA_PART
#define FA_PART 0
#endif
#define FA_IN_PART(n) (FA_PART == 0 || FA_PART == (n))

typedef __nv_bfloat16 bf16;
typedef __half f16;

namespace fa {

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

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int group;
  int ld;  // the stored head dim
  float scale;
  Mask mk;
  // the b*h rows whose row tiles the forward at head-dim class 256 over 128
  // rows takes longest first together (lpt_tile)
  int chunk;
};

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int heads, kv_heads;
  int ld;
  float scale;
  Mask mk;
  // dk/dv at head-dim class 256: the slices each KV head's query-head group
  // is split into, and with more than one the f32 workspace [2][splits][b *
  // kv_heads][T][ld] (dK, then dV) their partials go to; else 1 and null
  int splits;
  float* partial;
};

// The parts' entry points: each launches the instantiation of its element
// type for (rows, step) at the head-dim class of a.ld on the caller's
// stream and returns the launch error (cudaErrorInvalidValue when there is
// no such instantiation).
int forward_bf16(int bh, const FwdArgs& a, int rows, int step,
                 cudaStream_t st);
int forward_bf16_scaled(int bh, const FwdArgs& a, int rows, int step,
                        cudaStream_t st);
int forward_f16(int bh, const FwdArgs& a, int rows, int step,
                cudaStream_t st);
int forward_f16_scaled(int bh, const FwdArgs& a, int rows, int step,
                       cudaStream_t st);
int forward_f32(int bh, const FwdArgs& a, int rows, int step,
                cudaStream_t st);
int dq_bf16(int bh, const BwdArgs& a, int rows, int step, cudaStream_t st);
int dq_f16(int bh, const BwdArgs& a, int rows, int step, cudaStream_t st);
int dkv_bf16(int bkv, const BwdArgs& a, int rows, int step, cudaStream_t st);
int dkv_f16(int bkv, const BwdArgs& a, int rows, int step, cudaStream_t st);
int dkv_f32(int bkv, const BwdArgs& a, int rows, int step, cudaStream_t st);
// the same at head-dim class 256 (parts 11-15)
int forward_bf16_256(int bh, const FwdArgs& a, int rows, int step,
                     cudaStream_t st);
int forward_bf16_scaled_256(int bh, const FwdArgs& a, int rows, int step,
                            cudaStream_t st);
int forward_f16_256(int bh, const FwdArgs& a, int rows, int step,
                    cudaStream_t st);
int forward_f16_scaled_256(int bh, const FwdArgs& a, int rows, int step,
                           cudaStream_t st);
int forward_f32_256(int bh, const FwdArgs& a, int rows, int step,
                    cudaStream_t st);
int dq_bf16_256(int bh, const BwdArgs& a, int rows, int step,
                cudaStream_t st);
int dq_f16_256(int bh, const BwdArgs& a, int rows, int step, cudaStream_t st);
int dkv_bf16_256(int bkv, const BwdArgs& a, int rows, int step,
                 cudaStream_t st);
int dkv_f16_256(int bkv, const BwdArgs& a, int rows, int step,
                cudaStream_t st);
int dkv_f32_256(int bkv, const BwdArgs& a, int rows, int step,
                cudaStream_t st);
// the sliced kernels, every head dim above 256 (parts 16-20)
int forward_bf16_sliced(int bh, const FwdArgs& a, int rows, int step,
                        cudaStream_t st);
int forward_bf16_scaled_sliced(int bh, const FwdArgs& a, int rows, int step,
                               cudaStream_t st);
int forward_f16_sliced(int bh, const FwdArgs& a, int rows, int step,
                       cudaStream_t st);
int forward_f16_scaled_sliced(int bh, const FwdArgs& a, int rows, int step,
                              cudaStream_t st);
int forward_f32_sliced(int bh, const FwdArgs& a, int rows, int step,
                       cudaStream_t st);
int dq_bf16_sliced(int bh, const BwdArgs& a, int rows, int step,
                   cudaStream_t st);
int dq_f16_sliced(int bh, const BwdArgs& a, int rows, int step,
                  cudaStream_t st);
int dkv_bf16_sliced(int bkv, const BwdArgs& a, int rows, int step,
                    cudaStream_t st);
int dkv_f16_sliced(int bkv, const BwdArgs& a, int rows, int step,
                   cudaStream_t st);
int dkv_f32_sliced(int bkv, const BwdArgs& a, int rows, int step,
                   cudaStream_t st);
// the cluster kernels, head dims 257..CLUSTER_REACH in bf16 and fp16
// (parts 21-24), and each one's shared memory and clusters at once
int dq_bf16_cluster(int bh, const BwdArgs& a, int rows, int step,
                    cudaStream_t st);
int dq_f16_cluster(int bh, const BwdArgs& a, int rows, int step,
                   cudaStream_t st);
int dkv_bf16_cluster(int bkv, const BwdArgs& a, int rows, int step,
                     cudaStream_t st);
int dkv_f16_cluster(int bkv, const BwdArgs& a, int rows, int step,
                    cudaStream_t st);
int dq_bf16_cluster_info(int ld, int* smem, int* clusters);
int dq_f16_cluster_info(int ld, int* smem, int* clusters);
int dkv_bf16_cluster_info(int ld, int* smem, int* clusters);
int dkv_f16_cluster_info(int ld, int* smem, int* clusters);
// the pair forward, head dims 257..PAIR_REACH in bf16 and fp16 (parts
// 25-26)
int forward_bf16_pair(int bh, const FwdArgs& a, int rows, int step,
                      cudaStream_t st);
int forward_bf16_scaled_pair(int bh, const FwdArgs& a, int rows, int step,
                             cudaStream_t st);
int forward_f16_pair(int bh, const FwdArgs& a, int rows, int step,
                     cudaStream_t st);
int forward_f16_scaled_pair(int bh, const FwdArgs& a, int rows, int step,
                            cudaStream_t st);
// f32 dk/dv on the tensor cores over a cluster of the slices of head dims
// 257..TF32_REACH (part 27), and its shared memory and clusters at once
int dkv_f32_cluster(int bkv, const BwdArgs& a, int rows, int step,
                    cudaStream_t st);
int dkv_f32_cluster_info(int ld, int* smem, int* clusters);
// f32 dq on the tensor cores (dq_tf32_kernel): at head-dim classes 64 and
// 128 (part 9) and 256 (part 15), a block for each slice above TF32_REACH
// (part 20), and over a cluster of the slices of head dims 257..TF32_REACH
// (part 28), with the cluster's shared memory and clusters at once
int dq_tf32(int bh, const BwdArgs& a, int rows, int step, cudaStream_t st);
int dq_tf32_256(int bh, const BwdArgs& a, int rows, int step,
                cudaStream_t st);
int dq_tf32_stream(int bh, const BwdArgs& a, int rows, int step,
                   cudaStream_t st);
int dq_tf32_cluster(int bh, const BwdArgs& a, int rows, int step,
                    cudaStream_t st);
int dq_f32_cluster_info(int ld, int* smem, int* clusters);
// the sum of dk/dv's slices (parts 14 and 15): ws [2][splits][n] f32 -> dk,
// dv [n]
int dkv_reduce_bf16(const float* ws, void* dk, void* dv, long long n,
                    int splits, float scale, cudaStream_t st);
int dkv_reduce_f16(const float* ws, void* dk, void* dv, long long n,
                   int splits, float scale, cudaStream_t st);
int dkv_reduce_f32(const float* ws, void* dk, void* dv, long long n,
                   int splits, float scale, cudaStream_t st);

}  // namespace fa

namespace {

using fa::BwdArgs;
using fa::FwdArgs;
using fa::Mask;

constexpr int TENSOR_MAP_ERROR = 100000;

// The head-dim class a stored head dim runs on: 64 for 1..64, 128 for
// 65..128, 256 for 129..256, 0 above (no class: the sliced kernels).
__host__ __device__ constexpr int head_class(int ld) {
  return ld < 1 ? 0 : ld <= 64 ? 64 : ld <= 128 ? 128 : ld <= 256 ? 256 : 0;
}

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cgcd(int a, int b) {
  return b ? cgcd(b, a % b) : a;
}

// Shared memory a block may take when `blocks` blocks share an SM: 227 KB
// alone, or half of the SM's 228 KB less the 1 KB reserved per block.
__host__ __device__ constexpr int smem_budget(int blocks) {
  return blocks == 1 ? 232448 : 115712;
}

// The register plan of a block of `wg` consumer warpgroups: the blocks an
// SM holds by registers (the launch bound; hopper::reg_consumer).  One
// warpgroup plans for two blocks whether or not shared memory holds two
// (at head-dim class 256 it holds one), so its consumers take 232
// registers from what the producer frees; two warpgroups take 240.
__host__ __device__ constexpr int reg_blocks(int wg) {
  return wg == 2 ? 1 : 2;
}

// The element type E of the tensor-core kernels (bf16 or fp16): its tensor
// map type, and two f32 values rounded to E and packed in 32 bits (a
// register of an A fragment, or a stored pair of outputs).
template <typename E>
struct Elt;

template <>
struct Elt<bf16> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Elt<f16> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Columns c, c + 1 of an output row (c even, so 4-byte aligned).
template <typename E>
__device__ __forceinline__ void store2(E* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = Elt<E>::pack(lo, hi);
}

// The wgmma accumulator layout of m64nN (per thread, warp w of the
// warpgroup, lane g * 4 + t: d[4j + 2h + e] is row 16w + g + 8h, column
// 8j + 2t + e) is also the layout of an A operand held in registers, so
// columns 16kk..16kk+15 of it, rounded to E, are the A fragment of k
// step kk of the next product.
template <typename E, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N],
                                         int kk) {
  a[0] = Elt<E>::pack(d[8 * kk], d[8 * kk + 1]);
  a[1] = Elt<E>::pack(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = Elt<E>::pack(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = Elt<E>::pack(d[8 * kk + 6], d[8 * kk + 7]);
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

// Query tiles [qlo, qhi) of BQ rows that can see the key tile [k0, k0 +
// bm): from the diagonal (causal) to the last query the window reaches; a
// tile holding sink keys is seen by every later query, so it keeps the full
// range.
template <int BQ>
__device__ __forceinline__ void query_tiles(int k0, int bm, const Mask& mk,
                                            int* qlo, int* qhi) {
  const int n_qt = (mk.T + BQ - 1) / BQ;
  *qlo = mk.causal ? k0 / BQ : 0;
  *qhi = n_qt;
  if (mk.window > 0 && !(mk.sink > 0 && k0 < mk.sink))
    *qhi = min(n_qt, min(mk.T - 1, k0 + bm - 1 + mk.window - 1) / BQ + 1);
}

// ---------------------------------------------------------------------------
// Shared by the kernels.

// The grid: blockIdx.x walks (b*h, row tile) pairs, the n row tiles of one
// b*h adjacent, so that b*h is bounded only by the 2^31 - 1 blocks of x
// (y stops at 65,535).  The forward and dq take a b*h's tiles in reverse,
// longest rows first (the forward at head-dim class 256 over 128 rows
// across b*h rows: lpt_tile, below); that is the order the default tiles
// were tuned under (b*h fastest, b*h on x and tiles on y, measured 1.7 %
// slower in dq at the LM's main shape; PERF.md).
struct GridTile {
  int bh, tile, n;
};

__device__ __forceinline__ GridTile grid_tile(int rows, int T) {
  const int n = (T + rows - 1) / rows;
  return {(int)blockIdx.x / n, (int)blockIdx.x % n, n};
}

// The forward's grid at head-dim class 256 over 128 rows: blockIdx.x walks
// chunks of `chunk` b*h rows (the host's choice, ops/attention.py:
// fwd_chunk: as many as keep their K and V within a sixth of L2), and in
// each chunk the row tiles from the last (the longest under causal
// masking) down, the chunk's b*h fastest.  With each b*h's tiles adjacent,
// a head's long tiles started late and the causal tail took 86 key steps
// on the busiest SM of Gemma 2B's attention against an average of 66 (68
// longest first; tests/test_torch_fwd_wide.py models both).  Under a
// window or without causal masking, where the tiles are of about one
// length, it gains nothing and measured up to 4 % slower (PERF.md).
// GridTile.tile is the row tile itself.
__device__ __forceinline__ GridTile lpt_tile(int rows, int T, int chunk) {
  const int n = (T + rows - 1) / rows;
  const int bh_n = (int)gridDim.x / n;
  const int x = (int)blockIdx.x;
  const int c = x / (chunk * n), r = x % (chunk * n);
  const int size = min(chunk, bh_n - c * chunk);
  return {c * chunk + r % size, n - 1 - r / size, n};
}

// Blocks of that grid for bh rows of T; 0 when they pass 2^31 - 1.
inline unsigned grid_blocks(int bh, int T, int rows) {
  const long long n = (long long)bh * ((T + rows - 1) / rows);
  return n > INT_MAX ? 0u : (unsigned)n;
}

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
                                          int row0, int k0, int t,
                                          float fill = 0.f) {
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
    if (!(c <= hi[h] && (c >= lo[h] || c < sink))) s[x] = fill;
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
// A tile takes as many stages as shared memory holds, at most the counts
// chosen for the default tiles (3 at head_dim 64, 2 at 128).  At head_dim
// 256 (key step 64 only: a 128-key step doubles S, 64 registers, beside
// the 128 of the output accumulator, and spills) a block takes the SM's
// shared memory: 3 stages of 64 KB behind a 32 KB Q tile with one
// consumer warpgroup, 2 behind 64 KB with two.
template <int D, int WG, int BK>
struct FwdSmem {
  static constexpr int BM = 64 * WG;
  static constexpr int BLOCKS = WG == 2 || D == 256 ? 1 : 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int STAGES =
      cmin(D == 128 ? 2 : 3,
           (smem_budget(BLOCKS) - Q_BYTES - 1024 - 128) / STAGE_BYTES);
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  static_assert(STAGES >= 1 && BYTES <= smem_budget(BLOCKS),
                "forward tile does not fit in shared memory");
};

// Online softmax of one score tile (the accumulator of S = Q K^T, BK keys
// from k0) for this thread's two rows: masks the tile unless it is full,
// updates the running max m (base 2) and this thread's share of the row
// sums l, leaves p in s, and returns in alpha the factor the output
// accumulator is to be rescaled by.  SCALED (a scale that is not positive)
// scales the scores first, so that the row max is that of the scaled
// scores; otherwise the max is taken of the raw ones and scaled after.
// The mask takes each row's bounds (mask_tile): Mask::live on each element
// made the encoders' forward 16 % slower (PERF.md).
template <int BK, bool SCALED>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const Mask& mk, int r0,
                                               int row0, int k0, int t,
                                               float sl2) {
  if (SCALED) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) s[x] *= sl2;
    sl2 = 1.f;
  }
  if (!tile_full(mk, r0, 64, k0, BK))
    mask_tile(s, mk, row0, k0, t, -INFINITY);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // row max of the raw scores (of the scaled ones on the SCALED route),
    // in 4 chains
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

template <typename E, int D, int WG, int BK, bool SCALED>
__global__ void __launch_bounds__(128 * (WG + 1), reg_blocks(WG))
    fwd_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               E* __restrict__ o, float* __restrict__ lse, int group, int ld,
               float scale, Mask mk, int chunk) {
  using S = FwdSmem<D, WG, BK>;
  constexpr int BM = S::BM, STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t sKV = sQ + S::Q_BYTES;  // stage s: K, then V
  const uint32_t bars = sQ + S::BAR_OFF;  // full[STAGES], empty[STAGES], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int T = mk.T;
  // longest rows first: across a chunk's b*h rows at head-dim class 256
  // over 128 rows, else within each b*h
  constexpr bool LPT = D == 256 && WG == 2;
  const GridTile gt = LPT ? lpt_tile(BM, T, chunk) : grid_tile(BM, T);
  const int bh = gt.bh;
  const int q0 = (LPT ? gt.tile : gt.n - 1 - gt.tile) * BM;
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
  hopper::reg_alloc<hopper::reg_consumer(WG, reg_blocks(WG))>();

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
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);

    online_softmax<BK, SCALED>(sc, m, l, alpha, mk, r0, row0, k0, t, sl2);
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[dh][x] *= alpha[(x >> 1) & 1];
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(pa[kk], sc, kk);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(acc[h], pa[kk], hopper::desc_mn(sv, BK, kk, h));
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
// warpgroups keep up to four stages in flight (PERF.md has the variants
// this was chosen from).  Head-dim class 256 runs dq_wide_kernel (below),
// and T <= 256 at class 64 the encoders' dq_short_kernel.
template <int D, int WG, int BK>
struct DqSmem {
  static constexpr int BM = 64 * WG;
  static constexpr int BLOCKS = WG == 2 || D == 256 ? 1 : 2;
  static constexpr int QT_BYTES = BM * D * 2;  // the Q or dO tile
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING_OFF = 2 * QT_BYTES;
  // two blocks of one warpgroup share an SM's 227 KB (below head_dim 256)
  static constexpr int STAGES =
      cmin(WG == 2 ? 4 : 2,
           (smem_budget(BLOCKS) - RING_OFF - 1024 - 128) / STAGE_BYTES);
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  static_assert(STAGES >= 1 && BYTES <= smem_budget(BLOCKS),
                "dq tile does not fit in shared memory");
};

template <typename E, int D, int WG, int BK>
__global__ void __launch_bounds__(128 * (WG + 1), reg_blocks(WG))
    dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              E* __restrict__ dq, int group, int ld, float scale, Mask mk) {
  using S = DqSmem<D, WG, BK>;
  constexpr int BM = S::BM, STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t sdO = sQ + S::QT_BYTES;
  const uint32_t ring = sQ + S::RING_OFF;  // stage s: K, then V
  const uint32_t bars = sQ + S::BAR_OFF;   // full[STAGES], empty[STAGES], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int T = mk.T;
  const GridTile gt = grid_tile(BM, T);
  const int bh = gt.bh;
  const int q0 = (gt.n - 1 - gt.tile) * BM;  // longest rows first
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
  hopper::reg_alloc<hopper::reg_consumer(WG, reg_blocks(WG))>();

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
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
      hopper::Mma<E>::ss(dp, hopper::desc_k(sdOw, BM, kk),
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
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(da[kk], dp, kk);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(dq_acc[h], da[kk],
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
    E* out = dq + ((size_t)bh * T + i) * ld;
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dh * 64 + 8 * j + 2 * t;
        if (c < ld)
          store2(out + c, dq_acc[dh][4 * j + 2 * h] * scale,
                 dq_acc[dh][4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

// dq at head-dim class 256 (dq_wide_kernel): 128 query rows a block in
// two consumer warpgroups of 64 over 64-key steps, so that every product is
// m64n64 (an m64n32 product, as a 32-key step gives S and dP, ran dq at
// 0.261 ms against the one-warpgroup plan's 0.233 at Gemma 2B's shape;
// PERF.md) and each K/V tile serves 128 rows (half the L2 traffic per
// product of a 64-row tile).  Q and dO take 128 KB, which leaves room for
// three 32 KB tiles, not two K/V stages: K keeps a ring of two stages (S
// and dQ += dS K read it to the tile's end) and V one (only dP = dO V^T
// reads it, so its stage is handed back mid-tile and refilled while the
// tile's dQ product and the next tile's S run).  The producer loads K and
// V tile by tile in the order their stages come free.  Per tile each
// warpgroup waits for both, issues S and dP, hands V back, forms p and dS
// in place, and issues dQ += dS K: dq_kernel's loop, whose products ptxas
// does not serialise.  The two warpgroups take turns to issue (named
// barriers: S and dP of one, then of the other, then dQ of one, ...), so
// that one's element work runs under the other's products: 6 % (PERF.md).
// Registers: dQ 128, S and dP 32 each, dS in E 16, under the consumers'
// 240.
struct DqWideSmem {
  static constexpr int DIM = 256, BM = 128, BK = 64;
  static constexpr int QT_BYTES = BM * DIM * 2;  // Q or dO
  static constexpr int KV_BYTES = BK * DIM * 2;  // one K or V tile
  static constexpr int K_OFF = 2 * QT_BYTES;     // K stages 0 and 1
  static constexpr int V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + KV_BYTES;
  // k_full[2], k_empty[2], v_full, v_empty, q
  static constexpr int BYTES = BAR_OFF + 8 * 7 + 1024;
  static_assert(BYTES <= smem_budget(1), "dq tile does not fit");
};

template <typename E>
__global__ void __launch_bounds__(384, reg_blocks(2))
    dq_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, E* __restrict__ dq,
                   int group, int ld, float scale, Mask mk) {
  using S = DqWideSmem;
  constexpr int D = S::DIM, BM = S::BM, BK = S::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t sdO = sQ + S::QT_BYTES;
  const uint32_t sK = sQ + S::K_OFF, sV = sQ + S::V_OFF;
  const uint32_t bars = sQ + S::BAR_OFF;
  const uint32_t k_full = bars, k_empty = bars + 16;
  const uint32_t v_full = bars + 32, v_empty = bars + 40, q_bar = bars + 48;

  const int T = mk.T;
  const GridTile gt = grid_tile(BM, T);
  const int bh = gt.bh;
  const int q0 = (gt.n - 1 - gt.tile) * BM;  // longest rows first
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(k_empty + 8 * s, 256);
    }
    hopper::mbar_init(v_full, 1);
    hopper::mbar_init(v_empty, 256);
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int bkv = bh / group;
      hopper::mbar_arrive_tx(q_bar, 2 * S::QT_BYTES);
      hopper::tma_tile<D>(sQ, &map_q, BM, q0, bh, q_bar);
      hopper::tma_tile<D>(sdO, &map_do, BM, q0, bh, q_bar);
      for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        const int ks = it & 1;
        // K's stage comes free at the end of tile it - 2, V's mid tile
        // it - 1
        if (it >= 2) hopper::mbar_wait(k_empty + 8 * ks, ((it >> 1) - 1) & 1);
        hopper::mbar_arrive_tx(k_full + 8 * ks, S::KV_BYTES);
        hopper::tma_tile<D>(sK + ks * S::KV_BYTES, &map_k, BK, k0, bkv,
                            k_full + 8 * ks);
        if (it >= 1) hopper::mbar_wait(v_empty, (it - 1) & 1);
        hopper::mbar_arrive_tx(v_full, S::KV_BYTES);
        hopper::tma_tile<D>(sV, &map_v, BK, k0, bkv, v_full);
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(2, reg_blocks(2))>();

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

  float acc[D / 64][32];
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  // the two warpgroups take turns to issue their products (named barriers
  // 1 and 2, FA3's ping-pong), so that one's exponentials and dS run under
  // the other's products; warpgroup 0 goes first
  if (wg == 1) hopper::named_arrive(1, 256);
  for (int it = 0; it < n_iter; ++it) {
    const int ks = it & 1;
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
    const uint32_t sk = sK + ks * S::KV_BYTES;
    hopper::mbar_wait(k_full + 8 * ks, (it >> 1) & 1);
    hopper::mbar_wait(v_full, it & 1);

    float ps[BK / 2], dps[BK / 2];  // S, then P; dP, then dS
    hopper::named_sync(1 + wg, 256);  // this warpgroup's turn
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Mma<E>::ss(ps, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
      hopper::Mma<E>::ss(dps, hopper::desc_k(sdOw, BM, kk),
                         hopper::desc_k(sV, BK, kk), kk > 0);
    }
    hopper::wg_commit();
    hopper::named_arrive(2 - wg, 256);  // the other's
    hopper::wg_wait();
    hopper::wg_fence_regs(ps);
    hopper::wg_fence_regs(dps);
    hopper::mbar_arrive(v_empty);

#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      ps[x] = exp2_approx(fmaf(ps[x], sl2, -lse2[(x >> 1) & 1]));
    if (!tile_full(mk, r0, 64, k0, BK)) mask_tile(ps, mk, row0, k0, t);
#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      dps[x] = ps[x] * (dps[x] - dl[(x >> 1) & 1]);  // ds
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(da[kk], dps, kk);
    hopper::named_sync(1 + wg, 256);  // this warpgroup's turn
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(acc[h], da[kk], hopper::desc_mn(sk, BK, kk, h));
    }
    hopper::wg_commit();
    hopper::named_arrive(2 - wg, 256);  // the other's
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(acc[h]);
    hopper::mbar_arrive(k_empty + 8 * ks);
  }
  if (wg == 0) hopper::named_sync(1, 256);  // warpgroup 1's last turn

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    if (i >= T) continue;
    E* out = dq + ((size_t)bh * T + i) * ld;
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dh * 64 + 8 * j + 2 * t;
        if (c < ld)
          store2(out + c, acc[dh][4 * j + 2 * h] * scale,
                 acc[dh][4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv.  Replaces tf_operator_tpu/ops/attention.py:_bwd_dkv_kernel.
//
// One block per (key tile of BM keys, b*kv_head), in the transposed frame
// (rows are keys): WG consumer warpgroups and a producer warpgroup, whose
// first warp loads K and V once and then walks every query head of the GQA
// group and, for each, the query tiles of BQ rows that can see the key
// tile, putting each tile's Q, dO, lse (times log2 e) and delta through a
// ring of STAGES stages (Q and dO by TMA, the two rows by the warp's lanes;
// 32 arrivals plus the TMA bytes complete a stage; dkv_producer).  The GQA
// sum stays inside the block (no atomics, deterministic).  dk is written
// times scale.  Bound: operations (4 products).
//
// Head-dim classes 64 and 128 (dkv_kernel): each consumer warpgroup owns
// 64 keys (BM = 64 * WG).  Per query tile it issues S^T = K Q^T and
// dP^T = V dO^T (wgmma, K-major as stored), forms p = exp(s - lse) and
// ds = p (dp - delta) with the element mask only on tiles that are not
// full, then dV += P^T dO and dK += dS^T Q with P^T and dS^T from
// registers and dO, Q read as stored through the transpose bit.  At
// head_dim 128 the query step is 32 so that the two [64 x 128]
// accumulators and the two [64 x BQ] score tiles fit in registers.
//
// Head-dim class 256 (dkv_split_kernel): the two [64 x 256] f32
// accumulators of one warpgroup would be 256 registers a thread, over the
// 255 a thread may hold.  So two consumer warpgroups share the same 64 keys
// and split the accumulators: warpgroup 0 holds dV (128 registers), forms
// S^T = K Q^T and P^T and issues dV += P^T dO; warpgroup 1 holds dK, forms
// dP^T = V dO^T, takes P^T from warpgroup 0 through shared memory (f32, in
// the accumulator layout, so thread i of one reads what thread i of the
// other wrote; two buffers, each handed over on an mbarrier and handed
// back on another) to form dS^T, and issues dK += dS^T Q.  Each product is
// computed once, and each warpgroup issues two of the four.  Splitting the
// head dim instead (each warpgroup 128 columns of both) would compute S
// and dP twice (1.5x the operations); a dK accumulator in shared memory
// (64 KB f32) would add a read and a write of it per query tile.
//   Query step 64: every product is m64n64, where S^T and dP^T at a
// 32-query step were m64n32 products, 0.354 ms against 0.290 at Gemma 2B's
// shape (PERF.md).  K, V 32 KB each, P 2 x 16
// KB, two stages of Q and dO (64 KB) and the tiles' lse and delta in a
// ring of their own, copied by the producer warp's lanes with cp.async
// (completing on the stage's barrier), so that it never waits on a load
// of its own.  Each warpgroup finishes a tile before the next: keeping the
// second product in flight under the next tile's element work, with three
// 32-query stages, measured 1 % (PERF.md).
//   The grid (dkv_split_walk) is b*kv_heads x key tiles x `splits` slices
// of each KV head's query-head group (the host's choice,
// ops/attention.py:dkv_splits; a slice takes heads [s * group / splits,
// (s + 1) * group / splits)), key tiles slowest: under causal masking key
// tile kt is seen by T/64 - kt query tiles, so the blocks of the low key
// tiles, the longest, start first and the short ones fill in behind them
// (the longest-processing-time order).  One KV head's 8 query heads over
// B 4, T 2048 were 128 blocks, under one wave on 132 SMs, the first
// walking 8 x 32 query tiles, twice an SM's balanced share; at 2 slices
// 256 blocks of at most 4 x 32.  A block walks its heads one by one, each
// head's query tiles upward.  With one slice it writes dK and dV in E;
// with more, f32 partials to a workspace [2][splits][b * kv_heads][T][ld],
// which dkv_reduce_kernel sums in slice order: deterministic, no atomics.
template <int D, int WG, int BQ>
struct DkvSmem {
  static constexpr bool SPLIT = D == 256;  // dkv_split_kernel's plan
  static constexpr int DIM = D, STEP = BQ;
  static constexpr int BM = SPLIT ? 64 : 64 * WG;
  static constexpr int BLOCKS = WG == 2 ? 1 : 2;
  static constexpr int KV_BYTES = BM * D * 2;  // K or V
  static constexpr int QT_BYTES = BQ * D * 2;  // Q or dO tile
  static constexpr int ROWS_BYTES = 2 * BQ * 4;  // a tile's lse and delta
  // a stage: Q, dO and (below head_dim 256) the tile's rows; SPLIT keeps
  // the rows in a ring of their own, so that a stage is whole KB
  static constexpr int STAGE_BYTES =
      SPLIT ? 2 * QT_BYTES : (2 * QT_BYTES + ROWS_BYTES + 1023) / 1024 * 1024;
  static constexpr int P_OFF = 2 * KV_BYTES;   // SPLIT: P^T, two buffers
  static constexpr int P_BYTES = SPLIT ? BM * BQ * 4 : 0;  // one buffer
  static constexpr int RING_OFF = P_OFF + 2 * P_BYTES;
  static constexpr int STAGES =
      cmin(3, (smem_budget(BLOCKS) - RING_OFF - 1024 - 128) /
                  (STAGE_BYTES + (SPLIT ? ROWS_BYTES : 0)));
  static constexpr int ROWS_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + (SPLIT ? STAGES * ROWS_BYTES : 0);
  // full[STAGES], empty[STAGES], kv, and SPLIT: p_full[2], p_empty[2]
  static constexpr int BYTES =
      BAR_OFF + 8 * (2 * STAGES + (SPLIT ? 5 : 1)) + 1024;
  static_assert(STAGES >= 1 && BYTES <= smem_budget(BLOCKS),
                "dk/dv tile does not fit in shared memory");

  // where stage s keeps its tile's lse (times log2 e below head_dim 256)
  // and delta, BQ floats each
  static __device__ __forceinline__ int rows_off(int s) {
    return SPLIT ? ROWS_OFF + s * ROWS_BYTES
                 : RING_OFF + s * STAGE_BYTES + 2 * QT_BYTES;
  }
};

// Where a dk/dv block starts: its key tile, and the query heads and query
// tiles it walks.
struct DkvWalk {
  int bkv, k0, qbase, qlo, nq, n_iter;
};

template <int BM, int BQ>
__device__ __forceinline__ DkvWalk dkv_walk(const Mask& mk, int heads,
                                            int kv_heads) {
  const GridTile gt = grid_tile(BM, mk.T);
  DkvWalk w;
  w.bkv = gt.bh;
  w.k0 = gt.tile * BM;
  const int group = heads / kv_heads;
  // query rows of kv row b: (b / Hkv) * H + (b % Hkv) * group + member
  w.qbase = (w.bkv / kv_heads) * heads + (w.bkv % kv_heads) * group;
  int qhi;
  query_tiles<BQ>(w.k0, BM, mk, &w.qlo, &qhi);
  w.nq = qhi - w.qlo;
  w.n_iter = group * w.nq;
  return w;
}

// dkv_split_kernel's block: blockIdx.x walks (key tile, b * kv_head, slice)
// with slices fastest and key tiles slowest (see above); *slice gets the
// block's slice.  64 keys a block.
template <int BQ>
__device__ __forceinline__ DkvWalk dkv_split_walk(const Mask& mk, int heads,
                                                  int kv_heads, int splits,
                                                  int* slice) {
  const int n_kt = (mk.T + 63) / 64;
  const int bkv_n = (int)gridDim.x / (n_kt * splits);
  const int x = (int)blockIdx.x;
  const int s = x % splits, rest = x / splits;
  DkvWalk w;
  w.bkv = rest % bkv_n;
  w.k0 = rest / bkv_n * 64;
  const int group = heads / kv_heads;
  const int h0 = s * group / splits, h1 = (s + 1) * group / splits;
  w.qbase = (w.bkv / kv_heads) * heads + (w.bkv % kv_heads) * group + h0;
  int qhi;
  query_tiles<BQ>(w.k0, 64, mk, &w.qlo, &qhi);
  w.nq = qhi - w.qlo;
  w.n_iter = (h1 - h0) * w.nq;
  *slice = s;
  return w;
}

// The producer warp of a dk/dv block (see above).
template <typename S>
__device__ __forceinline__ void dkv_producer(
    unsigned char* smem, uint32_t sK, const CUtensorMap* map_q,
    const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_do, const float* __restrict__ lse,
    const float* __restrict__ delta, const DkvWalk& w, int T) {
  constexpr int D = S::DIM, BQ = S::STEP, STAGES = S::STAGES;
  const uint32_t sV = sK + S::KV_BYTES;
  const uint32_t ring = sK + S::RING_OFF;
  const uint32_t bars = sK + S::BAR_OFF;
  const uint32_t kv_bar = bars + 16 * STAGES;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    hopper::mbar_arrive_tx(kv_bar, 2 * S::KV_BYTES);
    hopper::tma_tile<D>(sK, map_k, S::BM, w.k0, w.bkv, kv_bar);
    hopper::tma_tile<D>(sV, map_v, S::BM, w.k0, w.bkv, kv_bar);
  }
  for (int it = 0; it < w.n_iter; ++it) {
    const int s = it % STAGES;
    if (it >= STAGES)
      hopper::mbar_wait(bars + 8 * (STAGES + s), (it / STAGES - 1) & 1);
    const int bh = w.qbase + it / w.nq;
    const int q0 = (w.qlo + it % w.nq) * BQ;
    const uint32_t st = ring + s * S::STAGE_BYTES;
    if constexpr (S::SPLIT) {
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
    } else {
      float* rows = reinterpret_cast<float*>(smem + S::rows_off(s));
      for (int c = lane; c < BQ; c += 32) {
        const int i = q0 + c;
        const size_t off = (size_t)bh * T + i;
        rows[c] = i < T ? lse[off] * LOG2E : 0.f;
        rows[BQ + c] = i < T ? delta[off] : 0.f;
      }
      if (lane != 0) hopper::mbar_arrive(bars + 8 * s);
    }
    if (lane == 0) {
      hopper::mbar_arrive_tx(bars + 8 * s, 2 * S::QT_BYTES);
      hopper::tma_tile<D>(st, map_q, BQ, q0, bh, bars + 8 * s);
      hopper::tma_tile<D>(st + S::QT_BYTES, map_do, BQ, q0, bh,
                          bars + 8 * s);
    }
  }
}

// p = exp2(s * scale * log2 e - lse * log2 e) of a [64 keys x BQ queries]
// score tile (this thread's keys key[0], key[1]; queries q0 + column),
// zero where the pair does not attend (the element mask only on tiles that
// are not full).  rows holds lse * lse_mul (lse_mul 1: the rows are stored
// times log2 e already).
template <int BQ>
__device__ __forceinline__ void dkv_probs(float (&sc)[BQ / 2],
                                          const float* rows, const Mask& mk,
                                          int q0, int kr0, const int (&key)[2],
                                          int t, float sl2,
                                          float lse_mul = 1.f) {
#pragma unroll
  for (int x = 0; x < BQ / 2; ++x) {
    const float lse2 = rows[8 * (x >> 2) + 2 * t + (x & 1)] * lse_mul;
    sc[x] = exp2_approx(fmaf(sc[x], sl2, -lse2));
  }
  if (!tile_full(mk, q0, BQ, kr0, 64)) {
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const int i = q0 + 8 * (x >> 2) + 2 * t + (x & 1);
      if (!mk.live(i, key[(x >> 1) & 1])) sc[x] = 0.f;
    }
  }
}

template <typename E, int D, int WG, int BQ>
__global__ void __launch_bounds__(128 * (WG + 1), reg_blocks(WG))
    dkv_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               E* __restrict__ dk, E* __restrict__ dv, int heads,
               int kv_heads, int ld, float scale, Mask mk) {
  using S = DkvSmem<D, WG, BQ>;
  constexpr int BM = S::BM, STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sK = hopper::smem_addr(smem);
  const uint32_t sV = sK + S::KV_BYTES;
  const uint32_t ring = sK + S::RING_OFF;  // stage: Q, dO, lse2[BQ], delta[BQ]
  const uint32_t bars = sK + S::BAR_OFF;   // full[STAGES], empty[STAGES], kv
  const uint32_t kv_bar = bars + 16 * STAGES;

  const int T = mk.T;
  const DkvWalk w = dkv_walk<BM, BQ>(mk, heads, kv_heads);

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
    if (threadIdx.x < WG * 128 + 32)
      dkv_producer<S>(smem, sK, &map_q, &map_k, &map_v, &map_do, lse, delta,
                      w, T);
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(WG, reg_blocks(WG))>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kr0 = w.k0 + 64 * wg;  // this warpgroup's first key
  const int key[2] = {kr0 + warp * 16 + g, kr0 + warp * 16 + g + 8};
  const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;
  const float sl2 = scale * LOG2E;

  float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  hopper::mbar_wait(kv_bar, 0);
  for (int it = 0; it < w.n_iter; ++it) {
    const int s = it % STAGES;
    const int q0 = (w.qlo + it % w.nq) * BQ;
    const uint32_t sq = ring + s * S::STAGE_BYTES, sdo = sq + S::QT_BYTES;
    const float* rows =
        reinterpret_cast<const float*>(smem + S::rows_off(s));
    hopper::mbar_wait(bars + 8 * s, (it / STAGES) & 1);

    float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Mma<E>::ss(sc, hopper::desc_k(sKw, BM, kk),
                         hopper::desc_k(sq, BQ, kk), kk > 0);
      hopper::Mma<E>::ss(dp, hopper::desc_k(sVw, BM, kk),
                         hopper::desc_k(sdo, BQ, kk), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::wg_fence_regs(dp);

    dkv_probs<BQ>(sc, rows, mk, q0, kr0, key, t, sl2);
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const float dl = rows[BQ + 8 * (x >> 2) + 2 * t + (x & 1)];
      dp[x] = sc[x] * (dp[x] - dl);
    }

    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a<E>(pa[kk], sc, kk);
      acc_to_a<E>(da[kk], dp, kk);
    }
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        hopper::Mma<E>::rs64(dv_acc[h], pa[kk],
                             hopper::desc_mn(sdo, BQ, kk, h));
        hopper::Mma<E>::rs64(dk_acc[h], da[kk],
                             hopper::desc_mn(sq, BQ, kk, h));
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
    const size_t off = ((size_t)w.bkv * T + j) * ld;
#pragma unroll
    for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int x = 4 * n + 2 * h;
        const int c = dh * 64 + 8 * n + 2 * t;
        if (c < ld) {
          store2(dk + off + c, dk_acc[dh][x] * scale,
                 dk_acc[dh][x + 1] * scale);
          store2(dv + off + c, dv_acc[dh][x], dv_acc[dh][x + 1]);
        }
      }
    }
  }
}

template <typename E, int BQ>
__global__ void __launch_bounds__(384, reg_blocks(2))
    dkv_split_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dk,
                     E* __restrict__ dv, float* __restrict__ partial,
                     int heads, int kv_heads, int splits, int ld,
                     float scale, Mask mk) {
  constexpr int D = 256;
  using S = DkvSmem<D, 2, BQ>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sK = hopper::smem_addr(smem);
  const uint32_t sV = sK + S::KV_BYTES;
  const uint32_t ring = sK + S::RING_OFF;  // stage: Q, dO (rows: rows_off)
  // full[STAGES], empty[STAGES], kv, p_full[2], p_empty[2]
  const uint32_t bars = sK + S::BAR_OFF;
  const uint32_t kv_bar = bars + 16 * STAGES;
  const uint32_t p_full = kv_bar + 8, p_empty = kv_bar + 24;

  const int T = mk.T;
  int slice;
  const DkvWalk w = dkv_split_walk<BQ>(mk, heads, kv_heads, splits, &slice);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's 32 lanes' row copies and lane 0's TMA bytes
      hopper::mbar_init(bars + 8 * s, 33);
      hopper::mbar_init(bars + 8 * (STAGES + s), 256);
    }
    hopper::mbar_init(kv_bar, 1);
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(p_full + 8 * b, 128);
      hopper::mbar_init(p_empty + 8 * b, 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: its first warp
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x < 256 + 32)
      dkv_producer<S>(smem, sK, &map_q, &map_k, &map_v, &map_do, lse, delta,
                      w, T);
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(2, reg_blocks(2))>();

  // warpgroup 0: P^T and dV; warpgroup 1: dP^T, dS^T and dK
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int key[2] = {w.k0 + warp * 16 + g, w.k0 + warp * 16 + g + 8};
  const float sl2 = scale * LOG2E;
  // this warpgroup's first product reads K (S^T) or V (dP^T) against Q or
  // dO, its second reads dO (dV) or Q (dK)
  const uint32_t sA = wg == 0 ? sK : sV;

  float acc[D / 64][32];  // dV in warpgroup 0, dK in warpgroup 1
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  hopper::mbar_wait(kv_bar, 0);
  for (int it = 0; it < w.n_iter; ++it) {
    const int s = it % STAGES, b = it & 1;
    const int q0 = (w.qlo + it % w.nq) * BQ;
    const uint32_t sq = ring + s * S::STAGE_BYTES, sdo = sq + S::QT_BYTES;
    const float* rows = reinterpret_cast<const float*>(smem + S::rows_off(s));
    float* p_buf =
        reinterpret_cast<float*>(smem + S::P_OFF + b * S::P_BYTES);
    hopper::mbar_wait(bars + 8 * s, (it / STAGES) & 1);

    float x[BQ / 2];  // S^T, then P^T (wg 0); dP^T, then dS^T (wg 1)
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) x[i] = 0.f;
    const uint32_t sB = wg == 0 ? sq : sdo;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(x, hopper::desc_k(sA, 64, kk),
                         hopper::desc_k(sB, BQ, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(x);

    if (wg == 0) {
      // rows holds the raw lse (the producer copies it as stored)
      dkv_probs<BQ>(x, rows, mk, q0, w.k0, key, t, sl2, LOG2E);
      // the buffer's previous P^T (two tiles back) has been read
      if (it >= 2) hopper::mbar_wait(p_empty + 8 * b, ((it >> 1) - 1) & 1);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) p_buf[i * 128 + tid] = x[i];
      hopper::mbar_arrive(p_full + 8 * b);
    } else {
      hopper::mbar_wait(p_full + 8 * b, (it >> 1) & 1);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const float dl = rows[BQ + 8 * (i >> 2) + 2 * t + (i & 1)];
        x[i] = p_buf[i * 128 + tid] * (x[i] - dl);
      }
      hopper::mbar_arrive(p_empty + 8 * b);
    }

    uint32_t a[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a<E>(a[kk], x, kk);
    const uint32_t sC = wg == 0 ? sdo : sq;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        hopper::Mma<E>::rs64(acc[h], a[kk], hopper::desc_mn(sC, BQ, kk, h));
    }
    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(acc[h]);
    hopper::mbar_arrive(bars + 8 * (STAGES + s));
  }

  // elements of dk (or dv): b*kv_heads x T x ld
  const size_t n_out =
      (size_t)(gridDim.x / ((T + 63) / 64 * splits)) * T * ld;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key[h];
    if (j >= T) continue;
    const size_t off = ((size_t)w.bkv * T + j) * ld;
    if (partial == nullptr) {  // one slice: dK (times scale) and dV in E
      E* out = wg == 0 ? dv : dk;
      const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
      for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const int i = 4 * c8 + 2 * h;
          const int c = dh * 64 + 8 * c8 + 2 * t;
          if (c < ld)
            store2(out + off + c, acc[dh][i] * mul, acc[dh][i + 1] * mul);
        }
      }
    } else {  // this slice's f32 partial: dK at [0][slice], dV at [1][slice]
      float* out = partial + ((size_t)(wg == 0) * splits + slice) * n_out;
#pragma unroll
      for (int dh = 0; dh < D / 64; ++dh) {
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const int i = 4 * c8 + 2 * h;
          const int c = dh * 64 + 8 * c8 + 2 * t;
          if (c < ld)
            *reinterpret_cast<float2*>(out + off + c) =
                make_float2(acc[dh][i], acc[dh][i + 1]);
        }
      }
    }
  }
}

// The sum of dkv_split_kernel's slices: dK = scale * sum_s ws[0][s] and
// dV = sum_s ws[1][s], each sum taken in slice order (so a launch repeats
// bit for bit), written in E (bf16, fp16 or f32); n (a multiple of 4)
// elements each.  Four
// consecutive elements a thread, in a grid-stride loop.  Bound: bytes (2 *
// splits * n * 4 read, 2 * n * sizeof(E) written).  It replaces no TPU
// kernel: the Pallas dk/dv kernel sums a GQA group in VMEM scratch across
// its sequential grid, which blocks running in parallel cannot share.
template <typename E>
__global__ void __launch_bounds__(256)
    dkv_reduce_kernel(const float* __restrict__ ws, E* __restrict__ dk,
                      E* __restrict__ dv, long long n, int splits,
                      float scale) {
  const long long n4 = n / 4;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * 256) {
    const int which = i >= n4;  // 0: dK, 1: dV
    const long long j = i - which * n4;
    const float4* src =
        reinterpret_cast<const float4*>(ws + (size_t)which * splits * n) + j;
    float4 sum = src[0];
    for (int s = 1; s < splits; ++s) {
      const float4 p = src[(size_t)s * n4];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const float mul = which ? 1.f : scale;
    if constexpr (std::is_same_v<E, float>) {
      *reinterpret_cast<float4*>((which ? dv : dk) + 4 * j) =
          make_float4(sum.x * mul, sum.y * mul, sum.z * mul, sum.w * mul);
    } else {
      uint2 out;
      out.x = Elt<E>::pack(sum.x * mul, sum.y * mul);
      out.y = Elt<E>::pack(sum.z * mul, sum.w * mul);
      *reinterpret_cast<uint2*>((which ? dv : dk) + 4 * j) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// The encoders' kernels: the forward, dq and dk/dv at head-dim class 64 for
// T <= 256 (ViT-B/16 at T 197, BERT-base at T 128 and their tp shards; any
// mask, GQA, both forward routes).  ops/attention.py:short_route sends such
// a call here whatever its blocks.
//
// Bound at these shapes: bytes.  A ViT-B/16 head moves ~101 KB (Q, K, V
// and O of 197 x 64 bf16, lse) against ~10 MFLOP, 100 FLOP a byte, a third
// of the card's 295.  The tiled kernels above give each (b*h, 128-row
// tile) a block of its own, one block an SM: at ViT's shape 6,144 blocks
// of two key tiles each, every block paying its barrier set-up, its first
// TMA round trip and its scattered 4-byte epilogue stores with nothing of
// another block's to overlap them, and each head's K and V read by both of
// its row tiles' blocks.  Here a persistent grid (one block an SM) walks
// whole heads (items; block x takes x, x + grid, ...), so that
//   * each head's K and V are read from device memory once: an item's
//     Q, K and V (or K and V) sit in shared memory for all its tiles;
//   * the producer fills a two-item ring (the forward) or a K/V ring of two
//     items and a ring of query chunks (dq, dk/dv), so the next head's
//     loads run under the current head's products;
//   * the outputs leave by TMA stores from shared memory, issued by one
//     thread of a warpgroup: the consumers go on to the next tile.
// Every tile is 64 rows (one warpgroup's wgmma M), and the ragged last
// step is cut to whole 16-row sub-steps (the forward's keys 128..207 at T
// 197 as 64 + 16, not 128..255; dk/dv's last query chunk 192..207).
// Measured at ViT-B/16 (PERF.md; kernel_variants.py --encoder): the
// forward's chain of S, softmax and P V per step, not its bytes, sets its
// pace (leaving out the loads saved 1 %, any one of S, P V and the
// exponentials 8-15 %), so it runs three consumer warpgroups, where two
// read 0.178-0.183 ms against three's 0.153; its element mask by row bounds
// (Mask::live on each element: +16 %); whole 128-key steps +3.5 % (dk/dv's
// whole chunks +10 %); 64-key steps throughout +10 %; warps whose rows
// all lie past T skipping their softmax +4 % (dk/dv +2.5 %).

// A warpgroup's 64 x 64 f32 accumulator (this thread's rows 16 * warp + g
// + 8h, columns 8j + 2t + e), times mul[h], rounded to E, into a
// 128-byte-swizzled [64][64] tile at `tile` (the layout its TMA store
// reads; each row one 128-byte line, 16-byte chunk j at j ^ (row % 8), so
// a warp's stores fall in 32 banks).
template <typename E>
__device__ __forceinline__ void acc_to_smem(uint32_t tile, const float (&d)[32],
                                            const float (&mul)[2], int warp,
                                            int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t line = tile + (16 * warp + g + 8 * h) * 128 + 4 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      hopper::st_shared(line + ((j ^ g) << 4),
                        Elt<E>::pack(d[4 * j + 2 * h] * mul[h],
                                     d[4 * j + 2 * h + 1] * mul[h]));
  }
}

// The forward (fwd_short_kernel).  Replaces
// tf_operator_tpu/ops/attention.py:_fwd_kernel for T <= 256 at head-dim
// class 64.  An item is one b*h: its Q, K and V (64-row TMA boxes, zero
// past T; K and V to whole 128-key tiles) in one of two 96 KB stages.  The
// block's row tiles, item after item, are dealt to its SHORT_WGS consumer
// warpgroups in turn; each runs a row tile over its key tiles (key_tiles,
// 128 keys a step, the ragged one in sub-steps) as fwd_kernel does: S =
// Q K^T, the base-2 online softmax (online_softmax: the element mask, by
// row bounds, only on tiles that are not full), O += P V with P from
// registers.  Its o = acc / l (l = 0 -> 1) goes to a 64-row tile of the
// warpgroup's own in shared memory and leaves by one TMA store; lse = m +
// log l (0 for a row with no live key) by the rows' first lanes.
// The encoders' forward's consumer warpgroups: three (160 registers a
// thread) keep a third more of the step's chain in flight than two (PERF.md).
constexpr int SHORT_WGS = 3;

struct FwdShortSmem {
  static constexpr int D = 64, ROWS = 256, BK = 128;
  static constexpr int CHUNK = 64 * D * 2;          // 64 rows: 8 KB
  static constexpr int TILE = ROWS * D * 2;         // Q, K or V of a head
  static constexpr int STAGE_BYTES = 3 * TILE;      // Q, K, V
  static constexpr int STAGES = 2;
  // a 64-row O tile for each consumer warpgroup
  static constexpr int O_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = O_OFF + SHORT_WGS * CHUNK;
  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * 2 * STAGES + 1024;
  static_assert(BYTES <= smem_budget(1), "short forward does not fit");
};

// One key step of N keys from k0 for a warpgroup's 64 rows from q0 (S from
// the Q rows at sQr and the K rows at sk, P V with the V rows at sv): S =
// Q K^T, the online softmax, O += P V.
template <typename E, int N, bool SCALED>
__device__ __forceinline__ void fwd_short_step(
    float (&acc)[32], float (&m)[2], float (&l)[2], uint32_t sQr,
    uint32_t sk, uint32_t sv, const Mask& mk, int q0, int row0, int k0,
    int t, float sl2) {
  float sc[N / 2];
#pragma unroll
  for (int x = 0; x < N / 2; ++x) sc[x] = 0.f;
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::Mma<E>::ss(sc, hopper::desc_k(sQr, 64, kk),
                       hopper::desc_k(sk, N, kk), kk > 0);
  hopper::wg_commit();
  hopper::wg_wait();
  hopper::wg_fence_regs(sc);

  float alpha[2];
  online_softmax<N, SCALED>(sc, m, l, alpha, mk, q0, row0, k0, t, sl2);
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] *= alpha[(x >> 1) & 1];
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) acc_to_a<E>(pa[kk], sc, kk);
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::Mma<E>::rs64(acc, pa[kk], hopper::desc_mn(sv, N, kk, 0));
  hopper::wg_commit();
  hopper::wg_wait();
  hopper::wg_fence_regs(acc);
}

template <typename E, bool SCALED>
__global__ void __launch_bounds__(128 * (SHORT_WGS + 1), 1)
    fwd_short_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     float* __restrict__ lse, int bh_n, int group,
                     float scale, Mask mk) {
  using S = FwdShortSmem;
  constexpr int BK = S::BK, STAGES = S::STAGES, WGS = SHORT_WGS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t bars = base + S::BAR_OFF;  // full[STAGES], empty[STAGES]
  const int T = mk.T;
  const int n_rt = (T + 63) / 64;         // row tiles (Q's 64-row boxes)
  const int n_kc = (T + BK - 1) / BK * 2;  // K/V boxes: whole key tiles
  // this block's items: b*h rows blockIdx.x, + gridDim.x, ...
  const int items = (bh_n - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      // every consumer warpgroup hands each item's stage back, once its
      // last product of the item has read it
      hopper::mbar_init(bars + 8 * (STAGES + s), 128 * WGS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * WGS) {  // producer warpgroup: its first thread
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 128 * WGS) {
      for (int i = 0; i < items; ++i) {
        const int s = i % STAGES, bh = blockIdx.x + i * gridDim.x;
        const uint32_t sQ = base + s * S::STAGE_BYTES, full = bars + 8 * s;
        if (i >= STAGES)
          hopper::mbar_wait(bars + 8 * (STAGES + s), (i / STAGES - 1) & 1);
        hopper::mbar_arrive_tx(full, (n_rt + 2 * n_kc) * S::CHUNK);
        const int bkv = bh / group;
        for (int c = 0; c < n_kc; ++c) {
          if (c < n_rt)
            hopper::tma_load(sQ + c * S::CHUNK, &map_q, 0, 64 * c, bh, full);
          hopper::tma_load(sQ + S::TILE + c * S::CHUNK, &map_k, 0, 64 * c,
                           bkv, full);
          hopper::tma_load(sQ + 2 * S::TILE + c * S::CHUNK, &map_v, 0,
                           64 * c, bkv, full);
        }
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(WGS, 1)>();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t sO = base + S::O_OFF + wg * S::CHUNK;  // its O tile
  const float sl2 = scale * LOG2E;
  // The block's row tiles, item by item, are dealt to the warpgroups in
  // turn (tile u = i * n_rt + r to warpgroup u % WGS).  Each warpgroup
  // waits for every item's stage and hands every one back, those where it
  // has no tile included, so that no stage moves on to its next item
  // before every warpgroup is past this one.
  for (int i = 0; i < items; ++i) {
    const int s = i % STAGES, bh = blockIdx.x + i * gridDim.x;
    const uint32_t sQ = base + s * S::STAGE_BYTES;
    const uint32_t sK = sQ + S::TILE, sV = sK + S::TILE;
    const uint32_t empty = bars + 8 * (STAGES + s);
    hopper::mbar_wait(bars + 8 * s, (i / STAGES) & 1);
    const int r_first = ((wg - i * n_rt) % WGS + WGS) % WGS;
    if (r_first >= n_rt) hopper::mbar_arrive(empty);
    for (int r = r_first; r < n_rt; r += WGS) {
      const int q0 = 64 * r;
      const int row0 = q0 + warp * 16 + g;  // this thread's rows: +0, +8
      const uint32_t sQr = sQ + r * S::CHUNK;
      int lo, n_sink, n_iter;
      key_tiles<BK>(q0, 64, mk, &lo, &n_sink, &n_iter);
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums
      float acc[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[x] = 0.f;
      for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        // the keys of this step that exist, in whole 16-key sub-steps
        const int n = cmin(BK, (T - k0 + 15) / 16 * 16);
        if (n == BK) {
          fwd_short_step<E, BK, SCALED>(acc, m, l, sQr, sK + k0 * 128,
                                        sV + k0 * 128, mk, q0, row0, k0, t,
                                        sl2);
          continue;
        }
        for (int c = 0; c < n;) {
          const int kc = k0 + c;
          const uint32_t sk = sK + kc * 128, sv = sV + kc * 128;
          if (n - c >= 64) {
            fwd_short_step<E, 64, SCALED>(acc, m, l, sQr, sk, sv, mk, q0, row0,
                                          kc, t, sl2);
            c += 64;
          } else if (n - c >= 32) {
            fwd_short_step<E, 32, SCALED>(acc, m, l, sQr, sk, sv, mk, q0, row0,
                                          kc, t, sl2);
            c += 32;
          } else {
            fwd_short_step<E, 16, SCALED>(acc, m, l, sQr, sk, sv, mk, q0, row0,
                                          kc, t, sl2);
            c += 16;
          }
        }
      }
      // this warpgroup's last tile of the item: the stage is read
      if (r + WGS >= n_rt) hopper::mbar_arrive(empty);

      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = l[h] > 0.f ? 1.f / l[h] : 1.f;
        const int row = row0 + 8 * h;
        if (lse != nullptr && t == 0 && row < T)
          lse[(size_t)bh * T + row] = l[h] > 0.f ? m[h] * LN2 + logf(l[h])
                                                 : 0.f;
      }
      // o into this warpgroup's tile once its previous store has read it
      if (tid == 0) hopper::bulk_wait_read();
      hopper::named_sync(1 + wg, 128);
      acc_to_smem<E>(sO, acc, inv, warp, g, t);
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (tid == 0) {
        hopper::tma_store(&map_o, sO, 0, q0, bh);
        hopper::bulk_commit();
      }
    }
  }
  if (tid == 0) hopper::bulk_wait();
}

// dk/dv (dkv_short_kernel).  Replaces
// tf_operator_tpu/ops/attention.py:_bwd_dkv_kernel for T <= 256 at
// head-dim class 64.  An item is one b*kv_head: its K and V (64-row boxes,
// zero past T) in one of two 64 KB stages.  The item's key tiles of 64 go
// in passes: in pass p warpgroup w owns key tile 2p + w and holds its dK
// and dV accumulators (dkv_kernel's registers); the producer warp streams
// the pass's query chunks (64 queries of each head of the KV head's group
// that the pass's 128 keys can see, query_tiles) through a ring of
// STAGES stages: Q and dO by TMA, lse and delta by its lanes' cp.async,
// all completing on the stage's barrier, which both warpgroups read and
// hand back.  Per chunk (the ragged last one in 16-query sub-steps), as
// dkv_kernel: S^T = K Q^T and dP^T = V dO^T, p = exp2(s * scale * log2 e
// - lse * log2 e) and ds = p (dp - delta) (dkv_probs), dV += P^T dO and dK
// += dS^T Q.  A pass's dK (times scale) and dV go to the key tile's own K
// and V rows in shared memory and leave by TMA stores, which the item's
// stage waits for before it is handed back.  The GQA sum stays in the
// warpgroup (no atomics, one order: deterministic).  A T <= 128 item is
// one pass; T 197 two, the second of which gives warpgroup 1 the 5 live
// keys of 192..255.  Two consumer warpgroups: a third would leave each
// thread 128 registers, under the 160 of dkv_kernel's accumulators and
// score tiles.
struct DkvShortSmem {
  static constexpr int D = 64, ROWS = 256, BQ = 64;
  static constexpr int CHUNK = 64 * D * 2;             // 64 rows: 8 KB
  static constexpr int KV_TILE = ROWS * D * 2;         // K or V of a head
  static constexpr int KV_STAGE = 2 * KV_TILE;
  static constexpr int RING_OFF = 2 * KV_STAGE;        // two K/V stages
  static constexpr int Q_STAGE = 2 * CHUNK;            // Q, dO
  static constexpr int ROWS_BYTES = 2 * BQ * 4;        // lse, delta
  static constexpr int STAGES =
      cmin(6, (smem_budget(1) - RING_OFF - 1024 - 128) /
                  (Q_STAGE + ROWS_BYTES));
  static constexpr int ROWS_OFF = RING_OFF + STAGES * Q_STAGE;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * ROWS_BYTES;
  // full[STAGES], empty[STAGES], kv_full[2], kv_empty[2]
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;
  static_assert(STAGES >= 2 && BYTES <= smem_budget(1),
                "short dk/dv does not fit");
};

// The producer warp's loads of the encoders' dq and dk/dv (S: their
// shared-memory plan).  short_kv_load: an item's K and V, n_kt 64-row boxes
// each, into the K/V stage at sK, on bar (lane 0 only).
template <typename S>
__device__ __forceinline__ void short_kv_load(uint32_t sK,
                                              const CUtensorMap* map_k,
                                              const CUtensorMap* map_v,
                                              int n_kt, int bkv, uint32_t bar) {
  hopper::mbar_arrive_tx(bar, 2 * n_kt * S::CHUNK);
  for (int c = 0; c < n_kt; ++c) {
    hopper::tma_load(sK + c * S::CHUNK, map_k, 0, 64 * c, bkv, bar);
    hopper::tma_load(sK + S::KV_TILE + c * S::CHUNK, map_v, 0, 64 * c, bkv,
                     bar);
  }
}

// short_chunk_load: a query chunk (BQ rows from q0 of b*h row bh) into
// ring stage s, completing on full: its lse and delta (raw, 0 past T) by
// the warp's lanes' cp.async, each lane's arrival made when its copies
// have landed (32 of the barrier's 33), and its Q and dO by lane 0's TMA.
template <typename S>
__device__ __forceinline__ void short_chunk_load(
    uint32_t base, int s, const CUtensorMap* map_q, const CUtensorMap* map_do,
    const float* __restrict__ lse, const float* __restrict__ delta, int bh,
    int q0, int T, int lane, uint32_t full) {
  const uint32_t rows = base + S::ROWS_OFF + s * S::ROWS_BYTES;
  for (int x = lane; x < S::BQ; x += 32) {
    const int q = q0 + x;
    const size_t off = (size_t)bh * T + (q < T ? q : 0);
    hopper::cp_async4(rows + 4 * x, lse + off, q < T);
    hopper::cp_async4(rows + 4 * (S::BQ + x), delta + off, q < T);
  }
  hopper::cp_async_mbar_arrive(full);
  if (lane == 0) {
    const uint32_t st = base + S::RING_OFF + s * S::Q_STAGE;
    hopper::mbar_arrive_tx(full, S::Q_STAGE);
    hopper::tma_load(st, map_q, 0, q0, bh, full);
    hopper::tma_load(st + S::CHUNK, map_do, 0, q0, bh, full);
  }
}

// One query chunk of NQ queries from q0 (Q at sq, dO at sdo, lse and delta
// at rows) for a warpgroup's 64 keys from kr0 (K at sKt, V at sVt): S^T =
// K Q^T and dP^T = V dO^T, p and ds, dV += P^T dO and dK += dS^T Q.
template <typename E, int NQ>
__device__ __forceinline__ void dkv_short_step(
    float (&dk_acc)[32], float (&dv_acc)[32], uint32_t sKt, uint32_t sVt,
    uint32_t sq, uint32_t sdo, const float* rows, const Mask& mk, int q0,
    int kr0, const int (&key)[2], int t, float sl2) {
  constexpr int BQ = DkvShortSmem::BQ;  // the rows' stride: lse, then delta
  float sc[NQ / 2], dp[NQ / 2];
#pragma unroll
  for (int x = 0; x < NQ / 2; ++x) sc[x] = dp[x] = 0.f;
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::Mma<E>::ss(sc, hopper::desc_k(sKt, 64, kk),
                       hopper::desc_k(sq, NQ, kk), kk > 0);
    hopper::Mma<E>::ss(dp, hopper::desc_k(sVt, 64, kk),
                       hopper::desc_k(sdo, NQ, kk), kk > 0);
  }
  hopper::wg_commit();
  hopper::wg_wait();
  hopper::wg_fence_regs(sc);
  hopper::wg_fence_regs(dp);

  // rows holds the raw lse (copied as stored)
  dkv_probs<NQ>(sc, rows, mk, q0, kr0, key, t, sl2, LOG2E);
#pragma unroll
  for (int x = 0; x < NQ / 2; ++x) {
    const float dl = rows[BQ + 8 * (x >> 2) + 2 * t + (x & 1)];
    dp[x] = sc[x] * (dp[x] - dl);
  }
  uint32_t pa[NQ / 16][4], da[NQ / 16][4];
#pragma unroll
  for (int kk = 0; kk < NQ / 16; ++kk) {
    acc_to_a<E>(pa[kk], sc, kk);
    acc_to_a<E>(da[kk], dp, kk);
  }
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < NQ / 16; ++kk) {
    hopper::Mma<E>::rs64(dv_acc, pa[kk], hopper::desc_mn(sdo, NQ, kk, 0));
    hopper::Mma<E>::rs64(dk_acc, da[kk], hopper::desc_mn(sq, NQ, kk, 0));
  }
  hopper::wg_commit();
  hopper::wg_wait();
  hopper::wg_fence_regs(dv_acc);
  hopper::wg_fence_regs(dk_acc);
}

template <typename E>
__global__ void __launch_bounds__(384, 1)
    dkv_short_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dk,
                     const __grid_constant__ CUtensorMap map_dv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int bkv_n, int heads,
                     int kv_heads, float scale, Mask mk) {
  using S = DkvShortSmem;
  constexpr int BQ = S::BQ, STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t ring = base + S::RING_OFF;  // stage: Q, dO
  const uint32_t bars = base + S::BAR_OFF;
  const uint32_t kv_full = bars + 16 * STAGES, kv_empty = kv_full + 16;
  const int T = mk.T;
  const int n_kt = (T + 63) / 64;      // key tiles (K/V's 64-row boxes)
  const int n_pass = (n_kt + 1) / 2;
  const int group = heads / kv_heads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's 32 lanes' row copies and lane 0's TMA bytes
      hopper::mbar_init(bars + 8 * s, 33);
      hopper::mbar_init(bars + 8 * (STAGES + s), 256);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(kv_full + 8 * s, 1);
      hopper::mbar_init(kv_empty + 8 * s, 256);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: its first warp
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    int n = 0, i = 0;  // chunks and items so far
    for (int bkv = blockIdx.x; bkv < bkv_n; bkv += gridDim.x, ++i) {
      const int ks = i & 1;
      if (i >= 2) hopper::mbar_wait(kv_empty + 8 * ks, ((i >> 1) - 1) & 1);
      if (lane == 0)
        short_kv_load<S>(base + ks * S::KV_STAGE, &map_k, &map_v, n_kt, bkv,
                         kv_full + 8 * ks);
      // query rows of kv row b: (b / Hkv) * H + (b % Hkv) * group + member
      const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group;
      for (int p = 0; p < n_pass; ++p) {
        int qlo, qhi;
        query_tiles<BQ>(128 * p, 128, mk, &qlo, &qhi);
        for (int hq = 0; hq < group; ++hq) {
          for (int c = qlo; c < qhi; ++c, ++n) {
            const int s = n % STAGES, bh = qbase + hq, q0 = BQ * c;
            if (n >= STAGES)
              hopper::mbar_wait(bars + 8 * (STAGES + s), (n / STAGES - 1) & 1);
            short_chunk_load<S>(base, s, &map_q, &map_do, lse, delta, bh, q0,
                                T, lane, bars + 8 * s);
          }
        }
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(2, 1)>();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * LOG2E;
  const float mul[2] = {scale, scale};
  const float one[2] = {1.f, 1.f};
  int n = 0, i = 0;
  for (int bkv = blockIdx.x; bkv < bkv_n; bkv += gridDim.x, ++i) {
    const int ks = i & 1;
    const uint32_t sK = base + ks * S::KV_STAGE, sV = sK + S::KV_TILE;
    hopper::mbar_wait(kv_full + 8 * ks, (i >> 1) & 1);
    for (int p = 0; p < n_pass; ++p) {
      const int kt = 2 * p + wg;
      const bool mine = kt < n_kt;  // warpgroup 1 may have no tile left
      const int kr0 = 64 * kt;
      const int key[2] = {kr0 + warp * 16 + g, kr0 + warp * 16 + g + 8};
      const uint32_t sKt = sK + kt * S::CHUNK, sVt = sV + kt * S::CHUNK;
      int qlo, qhi;
      query_tiles<BQ>(128 * p, 128, mk, &qlo, &qhi);
      float dk_acc[32], dv_acc[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) dk_acc[x] = dv_acc[x] = 0.f;
      for (int hq = 0; hq < group; ++hq) {
        for (int c = qlo; c < qhi; ++c, ++n) {
          const int s = n % STAGES, q0 = BQ * c;
          hopper::mbar_wait(bars + 8 * s, (n / STAGES) & 1);
          if (mine) {
            const uint32_t sq = ring + s * S::Q_STAGE, sdo = sq + S::CHUNK;
            const float* rows = reinterpret_cast<const float*>(
                smem + S::ROWS_OFF + s * S::ROWS_BYTES);
            // the chunk's queries that exist, in whole 16-query sub-steps
            const int nq = cmin(BQ, (T - q0 + 15) / 16 * 16);
            if (nq == BQ) {
              dkv_short_step<E, BQ>(dk_acc, dv_acc, sKt, sVt, sq, sdo, rows,
                                    mk, q0, kr0, key, t, sl2);
            } else {
              for (int c = 0; c < nq;) {
                const uint32_t o = c * 128;
                if (nq - c >= 32) {
                  dkv_short_step<E, 32>(dk_acc, dv_acc, sKt, sVt, sq + o,
                                        sdo + o, rows + c, mk, q0 + c, kr0,
                                        key, t, sl2);
                  c += 32;
                } else {
                  dkv_short_step<E, 16>(dk_acc, dv_acc, sKt, sVt, sq + o,
                                        sdo + o, rows + c, mk, q0 + c, kr0,
                                        key, t, sl2);
                  c += 16;
                }
              }
            }
          }
          hopper::mbar_arrive(bars + 8 * (STAGES + s));
        }
      }
      if (mine) {
        // dK and dV over the key tile's own K and V rows, which no
        // product reads any more
        acc_to_smem<E>(sKt, dk_acc, mul, warp, g, t);
        acc_to_smem<E>(sVt, dv_acc, one, warp, g, t);
        hopper::fence_proxy_async();
        hopper::named_sync(1 + wg, 128);
        if (tid == 0) {
          hopper::tma_store(&map_dk, sKt, 0, kr0, bkv);
          hopper::tma_store(&map_dv, sVt, 0, kr0, bkv);
          hopper::bulk_commit();
        }
      }
    }
    // the stores have read the stage before it is handed back
    if (tid == 0) hopper::bulk_wait_read();
    hopper::mbar_arrive(kv_empty + 8 * ks);
  }
  if (tid == 0) hopper::bulk_wait();
}

// dq (dq_short_kernel).  Replaces
// tf_operator_tpu/ops/attention.py:_bwd_dq_kernel for T <= 256 at head-dim
// class 64.  An item is one b*kv_head: its K and V (64-row boxes, zero
// past T) in one of two 64 KB stages, as in dkv_short_kernel.  The producer
// warp then streams the item's query chunks (64 rows of each head of the
// KV head's group, head by head) through a ring of STAGES stages: Q and dO
// by TMA, lse and delta by its lanes' cp.async, all completing on one
// full barrier.  The block's chunks, item after item, are dealt to its
// DQ_SHORT_WGS consumer warpgroups in turn (chunk n of the block to
// warpgroup n % WGS), and the warpgroup that takes a chunk alone reads it
// and hands its stage back.  Per chunk, over its key steps (key_tiles, BK
// keys a step, the ragged one in 16-key sub-steps), as dq_kernel: S = Q
// K^T and dP = dO V^T, p = exp2(s * scale * log2 e - lse * log2 e) and ds =
// p (dp - delta) with the element mask by row bounds (mask_tile) only on
// steps that are not full, and dQ += dS K with dS from registers and the
// same K rows read through the descriptor's transpose bit.  dQ (times
// scale) goes to a 64-row tile of the warpgroup's own and leaves by one TMA
// store: each dq row is written once, with no atomics (deterministic).
// Every item's K/V stage is waited for and handed back by every
// warpgroup, those with no chunk of it included.  A stage has a full
// barrier for each warpgroup, whose phases count that warpgroup's chunks
// in the stage: with one barrier a stage for all three, the warpgroup
// taking chunk n had not waited for chunk n - STAGES, the stage's previous
// one, whose load may land after that of chunk n - WGS (loads complete in
// any order), and the parity wait then passed a phase early (a build
// without dQ's product, whose loads queue, trapped so;
// tests/test_torch_dq_short.py models both).  The consumer
// warpgroups: three, whose 160 registers a thread hold S and dP at 64-key
// steps (32 floats each) beside dQ (32), measured 9 % faster at ViT-B/16
// than two at 128-key steps (240 registers; PERF.md), as the forward's
// third warpgroup was: more of the step's chain in flight.
constexpr int DQ_SHORT_WGS = 3;

struct DqShortSmem {
  static constexpr int D = 64, ROWS = 256, BQ = 64;
  static constexpr int WGS = DQ_SHORT_WGS;
  static constexpr int BK = WGS == 2 ? 128 : 64;     // the key step
  static constexpr int CHUNK = 64 * D * 2;            // 64 rows: 8 KB
  static constexpr int KV_TILE = ROWS * D * 2;        // K or V of a head
  static constexpr int KV_STAGE = 2 * KV_TILE;
  static constexpr int O_OFF = 2 * KV_STAGE;          // two K/V stages
  static constexpr int RING_OFF = O_OFF + WGS * CHUNK;  // a dQ tile a wg
  static constexpr int Q_STAGE = 2 * CHUNK;           // Q, dO
  static constexpr int ROWS_BYTES = 2 * BQ * 4;       // lse, delta
  static constexpr int STAGES =
      cmin(6, (smem_budget(1) - RING_OFF - 1024 - 256) /
                  (Q_STAGE + ROWS_BYTES));
  // the stages one warpgroup's chunks cycle through
  static constexpr int PERIOD = STAGES / cgcd(WGS, STAGES);
  static constexpr int ROWS_OFF = RING_OFF + STAGES * Q_STAGE;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * ROWS_BYTES;
  // full[STAGES][WGS], empty[STAGES], kv_full[2], kv_empty[2]
  static constexpr int BYTES =
      BAR_OFF + 8 * (STAGES * WGS + STAGES + 4) + 1024;
  // each warpgroup a chunk in flight
  static_assert(STAGES >= WGS && BYTES <= smem_budget(1),
                "short dq does not fit");
};

// One key step of N keys from k0 (K at sk, V at sv) for a warpgroup's 64
// query rows from q0 (Q at sq, dO at sdo; this thread's rows row0 and
// row0 + 8, their lse times log2 e in lse2 and their delta in dl): S = Q
// K^T and dP = dO V^T, p and ds, dQ += dS K.
template <typename E, int N>
__device__ __forceinline__ void dq_short_step(
    float (&dq_acc)[32], uint32_t sq, uint32_t sdo, uint32_t sk, uint32_t sv,
    const float (&lse2)[2], const float (&dl)[2], const Mask& mk, int q0,
    int row0, int k0, int t, float sl2) {
  float sc[N / 2], dp[N / 2];
#pragma unroll
  for (int x = 0; x < N / 2; ++x) sc[x] = dp[x] = 0.f;
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::Mma<E>::ss(sc, hopper::desc_k(sq, 64, kk),
                       hopper::desc_k(sk, N, kk), kk > 0);
    hopper::Mma<E>::ss(dp, hopper::desc_k(sdo, 64, kk),
                       hopper::desc_k(sv, N, kk), kk > 0);
  }
  hopper::wg_commit();
  hopper::wg_wait();
  hopper::wg_fence_regs(sc);
  hopper::wg_fence_regs(dp);

#pragma unroll
  for (int x = 0; x < N / 2; ++x)
    sc[x] = exp2_approx(fmaf(sc[x], sl2, -lse2[(x >> 1) & 1]));
  if (!tile_full(mk, q0, 64, k0, N)) mask_tile(sc, mk, row0, k0, t);
#pragma unroll
  for (int x = 0; x < N / 2; ++x)
    dp[x] = sc[x] * (dp[x] - dl[(x >> 1) & 1]);  // ds
  uint32_t da[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) acc_to_a<E>(da[kk], dp, kk);
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::Mma<E>::rs64(dq_acc, da[kk], hopper::desc_mn(sk, N, kk, 0));
  hopper::wg_commit();
  hopper::wg_wait();
  hopper::wg_fence_regs(dq_acc);
}

template <typename E>
__global__ void __launch_bounds__(128 * (DQ_SHORT_WGS + 1), 1)
    dq_short_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int bkv_n, int heads,
                    int kv_heads, float scale, Mask mk) {
  using S = DqShortSmem;
  constexpr int BQ = S::BQ, BK = S::BK, STAGES = S::STAGES, WGS = S::WGS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t ring = base + S::RING_OFF;  // stage: Q, dO
  // the full barriers: stage s's of warpgroup w at s * WGS + w
  const uint32_t bars = base + S::BAR_OFF;
  const uint32_t empty = bars + 8 * STAGES * WGS;
  const uint32_t kv_full = empty + 8 * STAGES, kv_empty = kv_full + 16;
  const int T = mk.T;
  const int n_kt = (T + 63) / 64;      // K/V's 64-row boxes
  const int n_qc = (T + BQ - 1) / BQ;  // a head's query chunks
  const int group = heads / kv_heads;
  const int nc = group * n_qc;         // an item's chunks
  // this block's items: b*kv_head rows blockIdx.x, + gridDim.x, ...
  const int items = (bkv_n - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;

  if (threadIdx.x == 0) {
    // the producer's 32 lanes' row copies and lane 0's TMA bytes
    for (int b = 0; b < STAGES * WGS; ++b)
      hopper::mbar_init(bars + 8 * b, 33);
    // the one warpgroup that takes the stage's chunk
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(empty + 8 * s, 128);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(kv_full + 8 * s, 1);
      hopper::mbar_init(kv_empty + 8 * s, 128 * WGS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * WGS) {  // producer warpgroup: its first warp
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x >= 128 * WGS + 32) return;
    const int lane = threadIdx.x & 31;
    int n = 0;  // chunks so far
    for (int i = 0; i < items; ++i) {
      const int ks = i & 1, bkv = blockIdx.x + i * gridDim.x;
      if (i >= 2) hopper::mbar_wait(kv_empty + 8 * ks, ((i >> 1) - 1) & 1);
      if (lane == 0)
        short_kv_load<S>(base + ks * S::KV_STAGE, &map_k, &map_v, n_kt, bkv,
                         kv_full + 8 * ks);
      // query rows of kv row b: (b / Hkv) * H + (b % Hkv) * group + member
      const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group;
      for (int u = 0; u < nc; ++u, ++n) {
        const int s = n % STAGES, bh = qbase + u / n_qc, q0 = BQ * (u % n_qc);
        if (n >= STAGES)
          hopper::mbar_wait(empty + 8 * s, (n / STAGES - 1) & 1);
        // onto the full barrier of the stage of chunk n's warpgroup
        short_chunk_load<S>(base, s, &map_q, &map_do, lse, delta, bh, q0, T,
                            lane, bars + 8 * (s * WGS + n % WGS));
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(WGS, 1)>();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t sO = base + S::O_OFF + wg * S::CHUNK;  // its dQ tile
  const float sl2 = scale * LOG2E;
  const float mul[2] = {scale, scale};
  for (int i = 0; i < items; ++i) {
    const int ks = i & 1, bkv = blockIdx.x + i * gridDim.x;
    const uint32_t sK = base + ks * S::KV_STAGE, sV = sK + S::KV_TILE;
    const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group;
    hopper::mbar_wait(kv_full + 8 * ks, (i >> 1) & 1);
    // this warpgroup's chunks of the item: the block's chunk n = i * nc + u
    // goes to warpgroup n % WGS
    for (int u = ((wg - i * nc) % WGS + WGS) % WGS; u < nc; u += WGS) {
      const int n = i * nc + u, s = n % STAGES;
      const int bh = qbase + u / n_qc, q0 = BQ * (u % n_qc);
      const int row0 = q0 + warp * 16 + g;  // this thread's rows: +0, +8
      const uint32_t sq = ring + s * S::Q_STAGE, sdo = sq + S::CHUNK;
      const float* rows = reinterpret_cast<const float*>(
          smem + S::ROWS_OFF + s * S::ROWS_BYTES);
      // this warpgroup's (n / WGS / PERIOD)-th chunk in the stage
      hopper::mbar_wait(bars + 8 * (s * WGS + wg), (n / WGS / S::PERIOD) & 1);
      float lse2[2], dl[2];  // the rows hold the raw lse, 0 past T
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse2[h] = rows[row0 - q0 + 8 * h] * LOG2E;
        dl[h] = rows[BQ + row0 - q0 + 8 * h];
      }
      int lo, n_sink, n_iter;
      key_tiles<BK>(q0, BQ, mk, &lo, &n_sink, &n_iter);
      float dq_acc[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) dq_acc[x] = 0.f;
      for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        // the keys of this step that exist, in whole 16-key sub-steps
        const int n_keys = cmin(BK, (T - k0 + 15) / 16 * 16);
        if (n_keys == BK) {
          dq_short_step<E, BK>(dq_acc, sq, sdo, sK + k0 * 128, sV + k0 * 128,
                               lse2, dl, mk, q0, row0, k0, t, sl2);
          continue;
        }
        for (int c = 0; c < n_keys;) {
          const int kc = k0 + c;
          const uint32_t sk = sK + kc * 128, sv = sV + kc * 128;
          if (n_keys - c >= 64) {
            dq_short_step<E, 64>(dq_acc, sq, sdo, sk, sv, lse2, dl, mk, q0,
                                 row0, kc, t, sl2);
            c += 64;
          } else if (n_keys - c >= 32) {
            dq_short_step<E, 32>(dq_acc, sq, sdo, sk, sv, lse2, dl, mk, q0,
                                 row0, kc, t, sl2);
            c += 32;
          } else {
            dq_short_step<E, 16>(dq_acc, sq, sdo, sk, sv, lse2, dl, mk, q0,
                                 row0, kc, t, sl2);
            c += 16;
          }
        }
      }
      // every product has read the chunk's Q and dO
      hopper::mbar_arrive(empty + 8 * s);

      // dQ into this warpgroup's tile once its previous store has read it
      if (tid == 0) hopper::bulk_wait_read();
      hopper::named_sync(1 + wg, 128);
      acc_to_smem<E>(sO, dq_acc, mul, warp, g, t);
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (tid == 0) {
        hopper::tma_store(&map_dq, sO, 0, q0, bh);
        hopper::bulk_commit();
      }
    }
    hopper::mbar_arrive(kv_empty + 8 * ks);
  }
  if (tid == 0) hopper::bulk_wait();
}

// ---------------------------------------------------------------------------
// Launchers of the tensor-core kernels: dynamic shared memory (above 48 KB
// needs the opt-in), grid (b*heads, row tiles) on the caller's stream; each
// returns the launch error.  Each launcher first encodes its tensor maps (a
// few microseconds of host time per call); a failed encoding returns
// TENSOR_MAP_ERROR + its CUresult.

template <typename E, int D, int WG, int BK, bool SCALED>
int fwd(int bh, const FwdArgs& a, cudaStream_t stream) {
  using S = FwdSmem<D, WG, BK>;
  const int T = a.mk.T;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / a.group, T, a.ld, BK)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / a.group, T, a.ld, BK)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = fwd_kernel<E, D, WG, BK, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = grid_blocks(bh, T, S::BM);
  if (grid == 0 || a.chunk < 1 || a.chunk > bh)
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, 128 * (WG + 1), S::BYTES, stream>>>(
      map_q, map_k, map_v, static_cast<E*>(a.o), a.lse, a.group, a.ld,
      a.scale, a.mk, a.chunk);
  return (int)cudaGetLastError();
}

// dq: dq_wide_kernel at head-dim class 256 (its one tile, 128 x 64), else
// dq_kernel.
template <typename E, int D, int WG, int BK>
int dq(int bh, const BwdArgs& a, cudaStream_t stream) {
  using S = std::conditional_t<D == 256, DqWideSmem, DqSmem<D, WG, BK>>;
  static_assert(D != 256 || (WG == 2 && BK == 64), "dq's tile at D 256");
  const int T = a.mk.T;
  const int group = a.heads / a.kv_heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / group, T, a.ld, BK)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / group, T, a.ld, BK)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, S::BM)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = [] {
    if constexpr (D == 256)
      return dq_wide_kernel<E>;
    else
      return dq_kernel<E, D, WG, BK>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = grid_blocks(bh, T, S::BM);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 128 * (WG + 1), S::BYTES, stream>>>(
      map_q, map_k, map_v, map_do, a.lse, a.delta, static_cast<E*>(a.dq),
      group, a.ld, a.scale, a.mk);
  return (int)cudaGetLastError();
}

// dk/dv: dkv_split_kernel at head-dim class 256 (its grid: key tiles x
// b*kv_heads x a.splits slices; a.partial non-null exactly when a.splits >
// 1), else dkv_kernel (one slice).
template <typename E, int D, int WG, int BQ>
int dkv(int bkv, const BwdArgs& a, cudaStream_t stream) {
  using S = DkvSmem<D, WG, BQ>;
  const int T = a.mk.T;
  const int bh = bkv / a.kv_heads * a.heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, BQ)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bkv, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bkv, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, BQ)))
    return TENSOR_MAP_ERROR + e;
  if constexpr (S::SPLIT) {
    const long long grid = (long long)bkv * ((T + 63) / 64) * a.splits;
    if (a.splits < 1 || a.splits > a.heads / a.kv_heads ||
        (a.splits > 1) != (a.partial != nullptr) || grid > INT_MAX)
      return (int)cudaErrorInvalidValue;
    auto kernel = dkv_split_kernel<E, BQ>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, 384, S::BYTES, stream>>>(
        map_q, map_k, map_v, map_do, a.lse, a.delta, static_cast<E*>(a.dk),
        static_cast<E*>(a.dv), a.partial, a.heads, a.kv_heads, a.splits,
        a.ld, a.scale, a.mk);
  } else {
    if (a.splits != 1 || a.partial != nullptr)
      return (int)cudaErrorInvalidValue;
    auto kernel = dkv_kernel<E, D, WG, BQ>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = grid_blocks(bkv, T, S::BM);
    if (grid == 0) return (int)cudaErrorInvalidValue;
    kernel<<<grid, 128 * (WG + 1), S::BYTES, stream>>>(
        map_q, map_k, map_v, map_do, a.lse, a.delta, static_cast<E*>(a.dk),
        static_cast<E*>(a.dv), a.heads, a.kv_heads, a.ld, a.scale, a.mk);
  }
  return (int)cudaGetLastError();
}

// The SMs of the current device: the persistent grids' size.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// The encoders' forward: one persistent block an SM (at most one a b*h).
template <typename E, bool SCALED>
int fwd_short(int bh, const FwdArgs& a, cudaStream_t stream) {
  using S = FwdShortSmem;
  const int T = a.mk.T;
  if (T > S::ROWS || head_class(a.ld) != S::D)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_o;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / a.group, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / a.group, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_o, ty, a.o, bh, T, a.ld, 64)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = fwd_short_kernel<E, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = cmin(bh, sm_count());
  if (grid < 1) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 128 * (SHORT_WGS + 1), S::BYTES, stream>>>(
      map_q, map_k, map_v, map_o, a.lse, bh, a.group, a.scale, a.mk);
  return (int)cudaGetLastError();
}

// The encoders' dk/dv: one persistent block an SM (at most one a
// b*kv_head).
template <typename E>
int dkv_short(int bkv, const BwdArgs& a, cudaStream_t stream) {
  using S = DkvShortSmem;
  const int T = a.mk.T;
  if (T > S::ROWS || head_class(a.ld) != S::D || a.splits != 1 ||
      a.partial != nullptr)
    return (int)cudaErrorInvalidValue;
  const int bh = bkv / a.kv_heads * a.heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do, map_dk, map_dv;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bkv, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bkv, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_dk, ty, a.dk, bkv, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_dv, ty, a.dv, bkv, T, a.ld, 64)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = dkv_short_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = cmin(bkv, sm_count());
  if (grid < 1) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 384, S::BYTES, stream>>>(
      map_q, map_k, map_v, map_do, map_dk, map_dv, a.lse, a.delta, bkv,
      a.heads, a.kv_heads, a.scale, a.mk);
  return (int)cudaGetLastError();
}

// The encoders' dq: one persistent block an SM (at most one a b*kv_head).
template <typename E>
int dq_short(int bh, const BwdArgs& a, cudaStream_t stream) {
  using S = DqShortSmem;
  const int T = a.mk.T;
  if (T > S::ROWS || head_class(a.ld) != S::D)
    return (int)cudaErrorInvalidValue;
  const int bkv = bh / a.heads * a.kv_heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do, map_dq;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bkv, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bkv, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, 64)) ||
      (e = hopper::tile_map(&map_dq, ty, a.dq, bh, T, a.ld, 64)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = dq_short_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = cmin(bkv, sm_count());
  if (grid < 1) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 128 * (S::WGS + 1), S::BYTES, stream>>>(
      map_q, map_k, map_v, map_do, map_dq, a.lse, a.delta, bkv, a.heads,
      a.kv_heads, a.scale, a.mk);
  return (int)cudaGetLastError();
}

template <typename E>
int dkv_reduce(const float* ws, void* dk, void* dv, long long n, int splits,
               float scale, cudaStream_t stream) {
  if (n % 4 || splits < 2) return (int)cudaErrorInvalidValue;
  const long long blocks = (2 * (n / 4) + 255) / 256;
  dkv_reduce_kernel<E><<<(unsigned)(blocks < (1 << 30) ? blocks : 1 << 30),
                         256, 0, stream>>>(ws, static_cast<E*>(dk),
                                           static_cast<E*>(dv), n, splits,
                                           scale);
  return (int)cudaGetLastError();
}

// The instantiated tiles of the tensor-core kernels (rows per block, step),
// by head-dim class; ops/attention.py's INSTANTIATED is the same table.
//   forward      D 64: rows {64, 128} x key step {64, 128}
//                D 128 and D 256: rows {64, 128} x key step {64}
//   dq           D 64: rows {64, 128} x key step {64, 128}
//                D 128: rows {64, 128} x key step {64}
//                D 256: rows {128} x key step {64} (dq_wide_kernel)
//   dk/dv        D 64: key rows {64, 128} x query step {32, 64}
//                D 128: key rows {64, 128} x query step {32}
//                D 256: key rows {64} x query step {64} (dkv_split_kernel)
// and the encoders' kernels (T <= 256), a whole head a work item:
//   forward      D 64: rows 256 x key step 128 (fwd_short_kernel)
//   dq           D 64: rows 256 x key step 64 (dq_short_kernel; a whole
//                KV head's query heads an item)
//   dk/dv        D 64: key rows 256 x query step 64 (dkv_short_kernel)
// Left out, each for registers or shared memory: a 256-key step (the
// forward's spilled 520-604 bytes under ptxas, with S as 128 f32 a thread,
// at both row counts; dq's S and dP alone would take 256 registers),
// dk/dv's 64-query step at head_dim 128 (its two [64 x 128] accumulators
// and two [64 x 64] score tiles), and a 128-key step at head_dim 128 and
// 256 for dq (S, dP and dQ, 192 registers at 128, besides dS's 32) and for
// the forward, which keeps dq's steps so that one block_k means the same
// tiles in both and the default pair (128, 128) keeps the tiles the
// kernels were tuned at.  At head_dim 256 (PERF.md has the times): dq's
// 64 rows (one consumer warpgroup) and its 32-key step
// (m64n32 products), both slower than dq_wide_kernel's tile; dk/dv's 128
// keys (four consumer warpgroups) and its 32-query step (m64n32 products,
// the earlier plan).
// WIDE selects head-dim class 256 (parts 11-14), else 64 and 128.
template <typename E, bool SCALED, bool WIDE>
int forward_tiles(int bh, const FwdArgs& a, int rows, int step,
                  cudaStream_t st) {
  const int dc = a.ld % 8 ? 0 : head_class(a.ld);
#define FA_FWD(DC, R, K)                  \
  if (dc == DC && rows == R && step == K) \
    return fwd<E, DC, R / 64, K, SCALED>(bh, a, st);
  if constexpr (WIDE) {
    FA_FWD(256, 64, 64)
    FA_FWD(256, 128, 64)
  } else {
    FA_FWD(64, 64, 64)
    FA_FWD(64, 64, 128)
    FA_FWD(64, 128, 64)
    FA_FWD(64, 128, 128)
    FA_FWD(128, 64, 64)
    FA_FWD(128, 128, 64)
    if (dc == 64 && rows == 256 && step == 128)
      return fwd_short<E, SCALED>(bh, a, st);
  }
#undef FA_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename E, bool WIDE>
int dq_tiles(int bh, const BwdArgs& a, int rows, int step, cudaStream_t st) {
  const int dc = a.ld % 8 ? 0 : head_class(a.ld);
#define FA_DQ(DC, R, K)                 \
  if (dc == DC && rows == R && step == K) \
    return dq<E, DC, R / 64, K>(bh, a, st);
  if constexpr (WIDE) {
    FA_DQ(256, 128, 64)
  } else {
    FA_DQ(64, 64, 64)
    FA_DQ(64, 64, 128)
    FA_DQ(64, 128, 64)
    FA_DQ(64, 128, 128)
    FA_DQ(128, 64, 64)
    FA_DQ(128, 128, 64)
    if (dc == 64 && rows == 256 && step == 64) return dq_short<E>(bh, a, st);
  }
#undef FA_DQ
  return (int)cudaErrorInvalidValue;
}

template <typename E, bool WIDE>
int dkv_tiles(int bkv, const BwdArgs& a, int rows, int step,
              cudaStream_t st) {
  const int dc = a.ld % 8 ? 0 : head_class(a.ld);
#define FA_DKV(DC, R, Q)                \
  if (dc == DC && rows == R && step == Q) \
    return dkv<E, DC, R / 64, Q>(bkv, a, st);
  if constexpr (WIDE) {
    // 64 keys over two warpgroups (dkv_split_kernel)
    if (dc == 256 && rows == 64 && step == 64)
      return dkv<E, 256, 2, 64>(bkv, a, st);
  } else {
    FA_DKV(64, 64, 32)
    FA_DKV(64, 64, 64)
    FA_DKV(64, 128, 32)
    FA_DKV(64, 128, 64)
    FA_DKV(128, 64, 32)
    FA_DKV(128, 128, 32)
    if (dc == 64 && rows == 256 && step == 64) return dkv_short<E>(bkv, a, st);
  }
#undef FA_DKV
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32: the SIMT forward.  The Pallas kernels compute in f32, and one TF32
// pass on the tensor cores would round the products to 10-bit mantissas,
// so the forward takes f32 products and f32 sums on the CUDA cores, one
// step at a time between two barriers: right, and not tuned.  (dq and
// dk/dv in f32 run on the tensor cores in three TF32 passes: dq_tf32_kernel
// and dkv_tf32_kernel, below the sliced kernels.)
//
// A block of F32_THREADS threads owns F32_ROWS query rows of one b*h, and
// walks the same tiles as the tensor-core kernels (key_tiles) F32_STEP keys
// at a time.  Thread 2r + h works on row r with its partner 2r + 1 - h in
// the same warp: per step the pair splits the step's columns (thread h
// takes 2j + h, so the two read neighbouring shared-memory rows) and the
// output columns (thread h takes [h * DMAX / 2, (h + 1) * DMAX / 2)), and
// trades the step's p with one shuffle.  Tiles are stored with a row stride
// of DMAX + 1 floats, so the 16 rows a warp reads lie in 16 banks.  The
// mask is Mask::live on every element, and exp is expf.
// Bound: operations on the f32 pipes (67 TFLOP/s on an H100 SXM), far from
// reached.  DMAX 256's tiles (64 KB each) take opted-in dynamic shared
// memory, as every launch here does.
constexpr int F32_ROWS = 64;
constexpr int F32_STEP = 32;
constexpr int F32_THREADS = 128;

// Rows [row0, row0 + n) of a [T, ld] f32 slab into a [n][DMAX + 1] tile,
// with zeros for the rows past T and the columns past ld, by a block of
// THREADS threads.
template <int DMAX, int THREADS = F32_THREADS>
__device__ __forceinline__ void f32_load(float* tile,
                                         const float* __restrict__ src,
                                         int row0, int n, int T, int ld) {
  for (int x = threadIdx.x; x < n * DMAX; x += THREADS) {
    const int r = x / DMAX, c = x % DMAX, i = row0 + r;
    tile[r * (DMAX + 1) + c] =
        i < T && c < ld ? src[(size_t)i * ld + c] : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(F32_THREADS)
    fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int group, int ld, float scale,
                   Mask mk) {
  constexpr int SD = DMAX + 1, J = F32_STEP / 2, C = DMAX / 2;
  extern __shared__ float f32_smem[];
  float* sQ = f32_smem;             // [F32_ROWS][SD]
  float* sK = sQ + F32_ROWS * SD;   // [F32_STEP][SD]
  float* sV = sK + F32_STEP * SD;   // [F32_STEP][SD]
  const int T = mk.T;
  const GridTile gt = grid_tile(F32_ROWS, T);
  const int bh = gt.bh, bkv = bh / group;
  const int q0 = (gt.n - 1 - gt.tile) * F32_ROWS;
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1, i = q0 + r;
  int lo, n_sink, n_iter;
  key_tiles<F32_STEP>(q0, F32_ROWS, mk, &lo, &n_sink, &n_iter);

  f32_load<DMAX>(sQ, q + (size_t)bh * T * ld, q0, F32_ROWS, T, ld);
  float m = -INFINITY, l = 0.f, acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * F32_STEP;
    __syncthreads();
    f32_load<DMAX>(sK, k + (size_t)bkv * T * ld, k0, F32_STEP, T, ld);
    f32_load<DMAX>(sV, v + (size_t)bkv * T * ld, k0, F32_STEP, T, ld);
    __syncthreads();
    float s[J];
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] = 0.f;
    for (int d = 0; d < ld; ++d) {
      const float qd = sQ[r * SD + d];
#pragma unroll
      for (int j = 0; j < J; ++j)
        s[j] = fmaf(qd, sK[(2 * j + h) * SD + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[j] = mk.live(i, k0 + 2 * j + h) ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[j] = expf(s[j] - m_use);
      sum += s[j];
    }
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float pm = s[j], po = __shfl_xor_sync(0xffffffffu, s[j], 1);
      const float* vm = sV + (2 * j + h) * SD + h * C;
      const float* vo = sV + (2 * j + 1 - h) * SD + h * C;
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c] = fmaf(pm, vm[c], fmaf(po, vo[c], acc[c]));
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  if (i >= T) return;
  const float inv = l > 0.f ? 1.f / l : 1.f;
  float* op = o + ((size_t)bh * T + i) * ld + h * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (h * C + c < ld) op[c] = acc[c] * inv;
  if (lse != nullptr && h == 0)
    lse[(size_t)bh * T + i] = l > 0.f ? m + logf(l) : 0.f;
}

// The f32 forward's launcher (dynamic shared memory above 48 KB, as above).

template <int DMAX>
int launch_fwd_f32(int bh, const FwdArgs& a, cudaStream_t st) {
  const int bytes = (F32_ROWS + 2 * F32_STEP) * (DMAX + 1) * 4;
  auto kernel = fwd_f32_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = grid_blocks(bh, a.mk.T, F32_ROWS);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, F32_THREADS, bytes, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.group, a.ld, a.scale, a.mk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims above 256: the sliced kernels.  They replace the same three
// Pallas kernels (tf_operator_tpu/ops/attention.py:_fwd_kernel,
// _bwd_dq_kernel, _bwd_dkv_kernel), which take any head dim, at every
// stored head dim ld > 256: fwd_sliced_kernel, dq_sliced_kernel and
// dkv_sliced_kernel in bf16 and fp16, and the forward's f32 counterpart.
// In bf16 and fp16, dq and dk/dv up to ld CLUSTER_REACH run on the cluster
// kernels below them instead, which split the contraction across a cluster
// of the slices' blocks rather than recompute it in each; dq_sliced_kernel
// and dkv_sliced_kernel take the head dims above that reach.  In f32, dq
// and dk/dv run on dq_tf32_kernel and dkv_tf32_kernel (below): up to ld
// TF32_REACH on their clusters, above it a block for each slice that
// contracts the whole head dim.
//
// Where the plans above stop: a warpgroup's 64-row f32 accumulator over W
// columns takes W/2 registers a thread (255 at most), wgmma's N is at most
// 256, and a 64-row bf16 tile of Q or a 64-key tile of K takes 128 * ld
// bytes of shared memory (64 KB at ld 512, 128 KB at 1024).  So:
//   * Each block produces one column slice of its outputs, SLICE (256)
//     columns wide: the grid is (b*h or b*kv_head, row tile, slice), the
//     slices of a row tile adjacent, so that they read the same tiles from
//     L2 together.  The last slice of a head dim that is not a multiple of
//     256 neither loads nor multiplies its 64-column blocks that lie wholly
//     past ld.  Each element of o, dq, dk and dv is written by one block.
//   * The contractions over the head dim (S = Q K^T and dP = dO V^T, or
//     their transposes in dk/dv) stream through a ring of shared-memory
//     stages, one 64-column chunk of each operand a stage (one TMA box
//     each): no buffer grows with ld.  The second products (P V, dS K,
//     P^T dO, dS^T Q) then stream their slice's 64-column blocks of V, K,
//     dO or Q through the same ring.  The producer warp walks the same
//     sequence of stages as the consumers (SlicedRing), and a consumer
//     hands a stage back once the products that read it have completed,
//     with one group of products left in flight.
//   * Every slice of a row tile recomputes S (and dP): at ld 512 in two
//     slices 1.5x the forward's products, 1.67x dq's and 1.5x dk/dv's.  In
//     return each block keeps the class-256 kernels' register plan (an
//     output accumulator of 128 registers a thread beside 64-key or
//     64-query score tiles) and nothing is summed across blocks.  The
//     slices sum S in the same order from the same inputs, so each slice's
//     row max and row sum are the same bits, and slice 0 writes lse.
//   * dk/dv walks each KV head's query-head group inside the block, in
//     order (no atomics, no workspace: dkv_splits and dkv_reduce stay at
//     head-dim class 256); its slices and key tiles give the grid its
//     blocks.
// Bound: operations, as above (2, 3 and 4 products).  These are the simple
// kernels, at 0.18-0.23 of that bound on an H100: they read the streamed
// chunks from L2 again at every key (or query) step, but reading an operand
// once per block saved only 2-5 % in the forward and dk/dv and 21 % in dq
// (kernel_variants.py --sliced); what sets their pace is the recomputed S
// and dP, the chain of one chunk's small products (4 k-steps of m64n64 a
// warpgroup), its stage's wait, and one group of products in flight
// (PERF.md has their times).  The cluster kernels answer the first two for
// dq and dk/dv.
constexpr int SLICE = 256;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// The slices of a stored head dim ld (> 256).
inline int n_slices(int ld) { return ceil_div(ld, SLICE); }

// A block of the sliced forward and dq (and of the f32 kernels): blockIdx.x
// walks (b*h, row tile, slice), slices fastest, each b*h's row tiles from
// the last (the longest under causal masking) down.  tile is the row tile.
struct SliceTile {
  int bh, tile, slice;
};

__device__ __forceinline__ SliceTile slice_tile(int rows, int T, int ns) {
  const int n = (T + rows - 1) / rows;
  const int x = (int)blockIdx.x / ns;
  return {x / n, n - 1 - x % n, (int)blockIdx.x % ns};
}

// Blocks of a sliced grid of n (b*h or b*kv_head) rows; 0 when they pass
// 2^31 - 1.
inline unsigned slice_blocks(int n, int T, int rows, int ns) {
  const long long b = (long long)n * ((T + rows - 1) / rows) * ns;
  return b > INT_MAX ? 0u : (unsigned)b;
}

// The ring of a sliced kernel: STAGES stages, full[STAGES] (the producer's
// arrival with the stage's TMA bytes) and empty[STAGES] (every consumer
// thread's) mbarriers at `bars`.  The producer and the consumers each keep
// one, counting the items (stages' fills) they have passed; both walk the
// same items in the same order.
template <int STAGES>
struct SlicedRing {
  uint32_t bars;
  int n;

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (STAGES + s);
  }
  // (thread 0) the barriers, `consumers` threads handing each stage back
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), consumers);
    }
  }
  // (producer) the next item's stage, once handed back; announces `bytes`
  __device__ __forceinline__ int put(uint32_t bytes) {
    const int s = n % STAGES;
    if (n >= STAGES) hopper::mbar_wait(empty(s), (n / STAGES - 1) & 1);
    hopper::mbar_arrive_tx(full(s), bytes);
    ++n;
    return s;
  }
  // (consumers) the next item's stage, once filled
  __device__ __forceinline__ int take() {
    const int s = n % STAGES;
    hopper::mbar_wait(full(s), (n / STAGES) & 1);
    ++n;
    return s;
  }
  // (consumers) after committing the products of the item just taken: the
  // previous item's products complete and its stage goes back (none for the
  // first item of a phase)
  __device__ __forceinline__ void issued(bool first) {
    if (first) return;
    hopper::wg_wait<1>();
    hopper::mbar_arrive(empty((n - 2) % STAGES));
  }
  // (consumers) the end of a phase: every product completes and the last
  // item's stage goes back
  __device__ __forceinline__ void drain() {
    hopper::wg_wait<0>();
    hopper::mbar_arrive(empty((n - 1) % STAGES));
  }
};

// fwd_sliced_kernel: 128 query rows a block in two consumer warpgroups of
// 64, 64-key steps in key_tiles' order.  Per key step the producer fills
// one stage per 64-column chunk of the head dim (the chunk of the 128-row
// Q tile, 16 KB, and of the K tile, 8 KB), then one per 64-column block of
// the slice's V columns (8 KB).  Each warpgroup accumulates S = Q K^T over
// the chunks, runs online_softmax (the class kernels' own), and adds P V
// into its [64 x 256] output accumulator, one column block a stage.
struct FwdSlicedSmem {
  static constexpr int BM = 128, BK = 64;
  static constexpr int Q_BYTES = BM * 128;  // a 64-column chunk of Q
  static constexpr int K_BYTES = BK * 128;  // of K, or a column block of V
  static constexpr int STAGE_BYTES = Q_BYTES + K_BYTES;
  static constexpr int STAGES = 8;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  static_assert(BYTES <= smem_budget(1), "sliced forward does not fit");
};

template <typename E, bool SCALED>
__global__ void __launch_bounds__(384, 1)
    fwd_sliced_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      E* __restrict__ o, float* __restrict__ lse, int group,
                      int ld, float scale, Mask mk) {
  using S = FwdSlicedSmem;
  constexpr int BM = S::BM, BK = S::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = hopper::smem_addr(aligned_smem(smem_raw));
  SlicedRing<S::STAGES> rg{ring + S::BAR_OFF, 0};

  const int T = mk.T;
  const int nc = ceil_div(ld, 64);  // the head dim's 64-column chunks
  const SliceTile st = slice_tile(BM, T, ceil_div(nc, 4));
  const int bh = st.bh, q0 = st.tile * BM;
  const int cb = 4 * st.slice;      // the slice's first column block
  const int nb = min(4, nc - cb);   // and its blocks within ld
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);

  if (threadIdx.x == 0) {
    rg.init(256);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int bkv = bh / group;
      for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        for (int c = 0; c < nc; ++c) {
          const int s = rg.put(S::STAGE_BYTES);
          const uint32_t at = ring + s * S::STAGE_BYTES;
          hopper::tma_load(at, &map_q, 64 * c, q0, bh, rg.full(s));
          hopper::tma_load(at + S::Q_BYTES, &map_k, 64 * c, k0, bkv,
                           rg.full(s));
        }
        for (int b = 0; b < nb; ++b) {
          const int s = rg.put(S::K_BYTES);
          hopper::tma_load(ring + s * S::STAGE_BYTES, &map_v, 64 * (cb + b),
                           k0, bkv, rg.full(s));
        }
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(2, 1)>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = scale * LOG2E;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float o_acc[4][32];  // the slice's four 64-column blocks
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[b][i] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
    float s_tile[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s_tile[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const uint32_t at = ring + rg.take() * S::STAGE_BYTES;
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Mma<E>::ss(s_tile, hopper::desc_k(at + wg * 64 * 128, 64, kk),
                           hopper::desc_k(at + S::Q_BYTES, BK, kk),
                           c > 0 || kk > 0);
      hopper::wg_commit();
      rg.issued(c == 0);
    }
    rg.drain();
    hopper::wg_fence_regs(s_tile);

    online_softmax<BK, SCALED>(s_tile, m, l, alpha, mk, r0, row0, k0, t, sl2);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int x = 0; x < 32; ++x) o_acc[b][x] *= alpha[(x >> 1) & 1];
    }
    uint32_t p_frag[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(p_frag[kk], s_tile, kk);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < nb) {
        const uint32_t at = ring + rg.take() * S::STAGE_BYTES;
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::Mma<E>::rs64(o_acc[b], p_frag[kk],
                               hopper::desc_mn(at, BK, kk, 0));
        hopper::wg_commit();
        rg.issued(b == 0);
      }
    }
    rg.drain();
#pragma unroll
    for (int b = 0; b < 4; ++b) hopper::wg_fence_regs(o_acc[b]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int i = row0 + 8 * h;
    if (i >= T) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
    E* op = o + ((size_t)bh * T + i) * ld;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * (cb + b) + 8 * j + 2 * t;
        if (c < ld)
          store2(op + c, o_acc[b][4 * j + 2 * h] * inv,
                 o_acc[b][4 * j + 2 * h + 1] * inv);
      }
    }
    if (st.slice == 0 && lse != nullptr && t == 0)
      lse[(size_t)bh * T + i] = l[h] > 0.f ? m[h] * LN2 + logf(l[h]) : 0.f;
  }
}

// dq_sliced_kernel: 128 query rows a block in two consumer warpgroups of
// 64, 64-key steps in key_tiles' order.  Per key step the producer fills
// one stage per 64-column chunk of the head dim (the chunks of the 128-row
// Q and dO tiles, 16 KB each, and of the K and V tiles, 8 KB each), then
// one per 64-column block of the slice's K columns.  Each warpgroup
// accumulates S = Q K^T and dP = dO V^T over the chunks, forms p and ds as
// dq_kernel does, and adds dS K into its [64 x 256] dq accumulator, one
// column block a stage.
struct DqSlicedSmem {
  static constexpr int BM = 128, BK = 64;
  static constexpr int QT_BYTES = BM * 128;  // a chunk of Q or dO
  static constexpr int KV_BYTES = BK * 128;  // a chunk of K or V
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + 2 * KV_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  static_assert(BYTES <= smem_budget(1), "sliced dq does not fit");
};

template <typename E>
__global__ void __launch_bounds__(384, 1)
    dq_sliced_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dq,
                     int group, int ld, float scale, Mask mk) {
  using S = DqSlicedSmem;
  constexpr int BM = S::BM, BK = S::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = hopper::smem_addr(aligned_smem(smem_raw));
  SlicedRing<S::STAGES> rg{ring + S::BAR_OFF, 0};

  const int T = mk.T;
  const int nc = ceil_div(ld, 64);
  const SliceTile st = slice_tile(BM, T, ceil_div(nc, 4));
  const int bh = st.bh, q0 = st.tile * BM;
  const int cb = 4 * st.slice, nb = min(4, nc - cb);
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);

  if (threadIdx.x == 0) {
    rg.init(256);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int bkv = bh / group;
      for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        for (int c = 0; c < nc; ++c) {
          const int s = rg.put(S::STAGE_BYTES);
          const uint32_t at = ring + s * S::STAGE_BYTES;
          hopper::tma_load(at, &map_q, 64 * c, q0, bh, rg.full(s));
          hopper::tma_load(at + S::QT_BYTES, &map_do, 64 * c, q0, bh,
                           rg.full(s));
          hopper::tma_load(at + 2 * S::QT_BYTES, &map_k, 64 * c, k0, bkv,
                           rg.full(s));
          hopper::tma_load(at + 2 * S::QT_BYTES + S::KV_BYTES, &map_v,
                           64 * c, k0, bkv, rg.full(s));
        }
        for (int b = 0; b < nb; ++b) {
          const int s = rg.put(S::KV_BYTES);
          hopper::tma_load(ring + s * S::STAGE_BYTES, &map_k, 64 * (cb + b),
                           k0, bkv, rg.full(s));
        }
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(2, 1)>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];  // lse * log2 e and delta of this thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    lse2[h] = i < T ? lse[(size_t)bh * T + i] * LOG2E : 0.f;
    dl[h] = i < T ? delta[(size_t)bh * T + i] : 0.f;
  }

  float dq_part[4][32];  // the slice's four 64-column blocks
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_part[b][i] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
    float s_tile[BK / 2], dp_tile[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s_tile[i] = dp_tile[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const uint32_t at = ring + rg.take() * S::STAGE_BYTES;
      const uint32_t kv = at + 2 * S::QT_BYTES;
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::Mma<E>::ss(s_tile, hopper::desc_k(at + wg * 64 * 128, 64, kk),
                           hopper::desc_k(kv, BK, kk), c > 0 || kk > 0);
        hopper::Mma<E>::ss(
            dp_tile, hopper::desc_k(at + S::QT_BYTES + wg * 64 * 128, 64, kk),
            hopper::desc_k(kv + S::KV_BYTES, BK, kk), c > 0 || kk > 0);
      }
      hopper::wg_commit();
      rg.issued(c == 0);
    }
    rg.drain();
    hopper::wg_fence_regs(s_tile);
    hopper::wg_fence_regs(dp_tile);

#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      s_tile[x] = exp2_approx(fmaf(s_tile[x], sl2, -lse2[(x >> 1) & 1]));
    if (!tile_full(mk, r0, 64, k0, BK)) mask_tile(s_tile, mk, row0, k0, t);
#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      dp_tile[x] = s_tile[x] * (dp_tile[x] - dl[(x >> 1) & 1]);  // ds
    uint32_t ds_frag[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(ds_frag[kk], dp_tile, kk);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < nb) {
        const uint32_t at = ring + rg.take() * S::STAGE_BYTES;
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::Mma<E>::rs64(dq_part[b], ds_frag[kk],
                               hopper::desc_mn(at, BK, kk, 0));
        hopper::wg_commit();
        rg.issued(b == 0);
      }
    }
    rg.drain();
#pragma unroll
    for (int b = 0; b < 4; ++b) hopper::wg_fence_regs(dq_part[b]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    if (i >= T) continue;
    E* out = dq + ((size_t)bh * T + i) * ld;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * (cb + b) + 8 * j + 2 * t;
        if (c < ld)
          store2(out + c, dq_part[b][4 * j + 2 * h] * scale,
                 dq_part[b][4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

// dkv_sliced_kernel: 64 keys a block (the transposed frame, as
// dkv_split_kernel), whose two consumer warpgroups split the products as
// that kernel does: warpgroup 0 forms S^T = K Q^T and P^T and holds the
// slice of dV (+= P^T dO), warpgroup 1 forms dP^T = V dO^T, takes P^T
// through shared memory (f32 in the accumulator layout, two buffers handed
// over and back on mbarriers) to form dS^T, and holds the slice of dK (+=
// dS^T Q).  The block walks each query head of its KV head's group and,
// for each, the 64-query tiles that see its keys; per query tile the
// producer fills one stage per 64-column chunk of the head dim (the chunks
// of K, V, Q and dO, 8 KB each), then one per 64-column block of the
// slice's dO and Q columns.  Each warpgroup reads its query rows' lse or
// delta from device memory itself.  The grid is (key tile, b*kv_head,
// slice), key tiles slowest, so that under causal masking the blocks of
// the low key tiles, which walk the most query tiles, start first.
struct DkvSlicedSmem {
  static constexpr int BM = 64, BQ = 64;
  static constexpr int BOX = 64 * 128;  // one 64 x 64 box
  static constexpr int STAGE_BYTES = 4 * BOX;
  static constexpr int STAGES = 5;
  static constexpr int P_OFF = STAGES * STAGE_BYTES;  // P^T, two buffers
  static constexpr int P_BYTES = BM * BQ * 4;
  static constexpr int BAR_OFF = P_OFF + 2 * P_BYTES;
  // full[STAGES], empty[STAGES], p_full[2], p_empty[2]
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;
  static_assert(BYTES <= smem_budget(1), "sliced dk/dv does not fit");
};

template <typename E>
__global__ void __launch_bounds__(384, 1)
    dkv_sliced_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, E* __restrict__ dk,
                      E* __restrict__ dv, int heads, int kv_heads, int ld,
                      float scale, Mask mk) {
  using S = DkvSlicedSmem;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t ring = hopper::smem_addr(smem);
  SlicedRing<S::STAGES> rg{ring + S::BAR_OFF, 0};
  const uint32_t p_full = ring + S::BAR_OFF + 16 * S::STAGES;
  const uint32_t p_empty = p_full + 16;

  const int T = mk.T;
  const int nc = ceil_div(ld, 64);
  const int ns = ceil_div(nc, 4), n_kt = (T + 63) / 64;
  const int x = (int)blockIdx.x;
  const int slice = x % ns, rest = x / ns;
  const int bkv_n = (int)gridDim.x / (n_kt * ns);
  const int bkv = rest % bkv_n, k0 = rest / bkv_n * 64;
  const int cb = 4 * slice, nb = min(4, nc - cb);
  const int group = heads / kv_heads;
  // query rows of kv row b: (b / Hkv) * H + (b % Hkv) * group + member
  const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group;
  int qlo, qhi;
  query_tiles<BQ>(k0, 64, mk, &qlo, &qhi);
  const int nq = qhi - qlo, n_iter = group * nq;

  if (threadIdx.x == 0) {
    rg.init(256);
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(p_full + 8 * b, 128);
      hopper::mbar_init(p_empty + 8 * b, 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int it = 0; it < n_iter; ++it) {
        const int bh = qbase + it / nq, q0 = (qlo + it % nq) * BQ;
        for (int c = 0; c < nc; ++c) {
          const int s = rg.put(S::STAGE_BYTES);
          const uint32_t at = ring + s * S::STAGE_BYTES;
          hopper::tma_load(at, &map_k, 64 * c, k0, bkv, rg.full(s));
          hopper::tma_load(at + S::BOX, &map_v, 64 * c, k0, bkv, rg.full(s));
          hopper::tma_load(at + 2 * S::BOX, &map_q, 64 * c, q0, bh,
                           rg.full(s));
          hopper::tma_load(at + 3 * S::BOX, &map_do, 64 * c, q0, bh,
                           rg.full(s));
        }
        for (int b = 0; b < nb; ++b) {
          const int s = rg.put(2 * S::BOX);
          const uint32_t at = ring + s * S::STAGE_BYTES;
          hopper::tma_load(at, &map_do, 64 * (cb + b), q0, bh, rg.full(s));
          hopper::tma_load(at + S::BOX, &map_q, 64 * (cb + b), q0, bh,
                           rg.full(s));
        }
      }
    }
    return;
  }
  hopper::reg_alloc<hopper::reg_consumer(2, 1)>();

  // warpgroup 0: P^T and dV; warpgroup 1: dP^T, dS^T and dK
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float sl2 = scale * LOG2E;
  // this warpgroup's operands in a chunk's stage (K against Q, or V
  // against dO) and in a column block's (dO for dV, Q for dK); its row
  // scalars (lse or delta)
  const uint32_t a_off = wg == 0 ? 0 : S::BOX, b_off = a_off + 2 * S::BOX;
  const uint32_t c_off = wg == 0 ? 0 : S::BOX;
  const float* row_src = wg == 0 ? lse : delta;

  float kv_part[4][32];  // dV (warpgroup 0) or dK (1): the slice's blocks
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) kv_part[b][i] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int bh = qbase + it / nq, q0 = (qlo + it % nq) * BQ;
    const int pb = it & 1;
    float* p_buf = reinterpret_cast<float*>(smem + S::P_OFF + pb * S::P_BYTES);
    // the row scalars of this thread's query columns q0 + 8j + 2t + e
    float rowv[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = q0 + 8 * j + 2 * t + e;
        rowv[2 * j + e] = i < T ? row_src[(size_t)bh * T + i] : 0.f;
      }
    }
    float st_tile[BQ / 2];  // S^T, then P^T (wg 0); dP^T, then dS^T (wg 1)
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st_tile[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const uint32_t at = ring + rg.take() * S::STAGE_BYTES;
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Mma<E>::ss(st_tile, hopper::desc_k(at + a_off, 64, kk),
                           hopper::desc_k(at + b_off, BQ, kk),
                           c > 0 || kk > 0);
      hopper::wg_commit();
      rg.issued(c == 0);
    }
    rg.drain();
    hopper::wg_fence_regs(st_tile);

    if (wg == 0) {
      const bool full = tile_full(mk, q0, BQ, k0, 64);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = 2 * (i >> 2) + (i & 1);
        const float p = exp2_approx(
            fmaf(st_tile[i], sl2, -rowv[col] * LOG2E));
        const int q = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
        st_tile[i] = full || mk.live(q, key[(i >> 1) & 1]) ? p : 0.f;
      }
      // the buffer's previous P^T (two tiles back) has been read
      if (it >= 2) hopper::mbar_wait(p_empty + 8 * pb, ((it >> 1) - 1) & 1);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) p_buf[i * 128 + tid] = st_tile[i];
      hopper::mbar_arrive(p_full + 8 * pb);
    } else {
      hopper::mbar_wait(p_full + 8 * pb, (it >> 1) & 1);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        st_tile[i] = p_buf[i * 128 + tid] *
                     (st_tile[i] - rowv[2 * (i >> 2) + (i & 1)]);
      hopper::mbar_arrive(p_empty + 8 * pb);
    }

    uint32_t a_frag[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a<E>(a_frag[kk], st_tile, kk);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < nb) {
        const uint32_t at = ring + rg.take() * S::STAGE_BYTES;
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          hopper::Mma<E>::rs64(kv_part[b], a_frag[kk],
                               hopper::desc_mn(at + c_off, BQ, kk, 0));
        hopper::wg_commit();
        rg.issued(b == 0);
      }
    }
    rg.drain();
#pragma unroll
    for (int b = 0; b < 4; ++b) hopper::wg_fence_regs(kv_part[b]);
  }

  E* out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key[h];
    if (j >= T) continue;
    const size_t off = ((size_t)bkv * T + j) * ld;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int i = 4 * c8 + 2 * h;
        const int c = 64 * (cb + b) + 8 * c8 + 2 * t;
        if (c < ld)
          store2(out + off + c, kv_part[b][i] * mul,
                 kv_part[b][i + 1] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster kernels: dq and dk/dv at stored head dims 257..CLUSTER_REACH
// (two to four slices) in bf16 and fp16, dq_cluster_kernel and
// dkv_cluster_kernel.  They replace the same Pallas kernels
// (tf_operator_tpu/ops/attention.py:_bwd_dq_kernel, _bwd_dkv_kernel) there;
// above the reach, and in f32, the sliced kernels above run (but f32
// dk/dv up to TF32_REACH: dkv_tf32_kernel).
//
// The sliced kernels recompute the full-width S and dP in every slice.
// Here the blocks of one row tile (dq) or key tile (dk/dv), one per slice,
// form a thread-block cluster of NS = n_slices(ld) blocks on neighbouring
// SMs, and split the head dim's contraction instead:
//   * Block r (its cluster rank, which is its slice) holds its slice of
//     every operand in shared memory and contracts over those 256 columns
//     only: a partial S and dP (in dk/dv S^T and dP^T), 64 x 64 f32 each.
//   * The partials are summed across the cluster in one fixed order:
//     block r owns the 16-row warps w of each 64-row tile with w * NS / 4
//     == r (cl_owner).  The other blocks store their partials of those
//     rows into its shared memory (reduce-scatter: st.async, whose bytes
//     complete a phase of the owner's mbarrier, as a TMA load's do; the
//     reader announces the bytes it expects); it sums the NS partials in
//     slice order in f32, forms P and dS from the sum, and stores the
//     rows' A fragments of the second product (P^T or dS^T or dS rounded
//     to E: half the bytes of the sums) into every other block's shared
//     memory (all-gather, the same way).  So every block multiplies the
//     same bits, and nothing is summed with atomics.
//   * Each block then accumulates its own slice of the outputs over the
//     slice's 256 columns as m64n256 products from one shared-memory stage.
// At ld 512 the products are what the bound counts (from 1.5x in dk/dv and
// 1.67x in dq), each contraction is 256 columns deep, and a step reads its
// slice's operand blocks once, for both products.  A block stores into a
// partner's exchange buffer only after the partner's last reader of it
// has answered: the owner's next all-gather follows the non-owners' next
// partials, which follow their reading of the last all-gather; where dq
// keeps two steps' buffers (two slices) a non-owner sends its next
// partial before this step's fragments come back, into the other buffer
// (tests/test_torch_sliced_cluster.py models both under random
// interleavings).  A cluster barrier after the mbarriers' init and before
// exit keeps every remote store inside the partners' lifetime.
// Bound: operations (3 products in dq, 4 in dk/dv).  At ld 512 on an H100
// they run at 0.24 (dq) and 0.26 (dk/dv) of it, 6 % and 13 % under the
// sliced kernels: without the exchange (kernel_variants.py --sliced
// no_exchange) they take 0.31 and 0.41 ms, with the exchange and no
// product 0.31 and 0.33, so each step's chain (contraction, sum,
// exponentials, the warpgroups' hand-over, products) sets the pace, and
// the exchange adds about a quarter (PERF.md has the times).
constexpr int CLUSTER_REACH = 1024;

// Diagnostics for kernel_variants.py only (both true in every build the
// wrappers load): without CLUSTER_EXCHANGE each block takes its own
// partial for the whole sum (no SM-to-SM traffic; wrong outputs); without
// CLUSTER_PRODUCTS no product is issued (the loads and the exchange alone;
// wrong outputs).
constexpr bool CLUSTER_EXCHANGE = true;
constexpr bool CLUSTER_PRODUCTS = true;

// The block of a cluster of ns that owns warp w's rows; the first warp
// block r owns and how many.
__host__ __device__ constexpr int cl_owner(int w, int ns) {
  return w * ns / 4;
}
__host__ __device__ constexpr int cl_first(int r, int ns) {
  return (4 * r + ns - 1) / ns;
}
__host__ __device__ constexpr int cl_owned(int r, int ns) {
  return cl_first(r + 1, ns) - cl_first(r, ns);
}
__host__ __device__ constexpr int cl_max_owned(int ns) {
  int m = 0;
  for (int r = 0; r < ns; ++r) m = cl_owned(r, ns) > m ? cl_owned(r, ns) : m;
  return m;
}
__host__ __device__ constexpr int cl_min_owned(int ns) {
  int m = 4;
  for (int r = 0; r < ns; ++r) m = cl_owned(r, ns) < m ? cl_owned(r, ns) : m;
  return m;
}

// One warp's share of a tile in an exchange buffer: a lane's 32 f32 values
// (a partial) or 16 registers of A fragments, as 16-byte groups q at q *
// 512 + lane * 16 (each warp's store one contiguous 512 bytes).
constexpr int CL_F32_CHUNK = 32 * 32 * 4;
constexpr int CL_FRAG_CHUNK = 32 * 16 * 4;

// A tile's exchange area in each block: the reduce-scatter's buffers (one
// chunk per owned warp and other block) and the all-gather's (one chunk
// per warp another block owns).
template <int NS>
struct ClusterX {
  static constexpr int RS_BYTES = (NS - 1) * cl_max_owned(NS) * CL_F32_CHUNK;
  static constexpr int AG_BYTES = (4 - cl_min_owned(NS)) * CL_FRAG_CHUNK;
};

__device__ __forceinline__ void ld_shared4(uint32_t addr, uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// (owner, rank r) Waits for the other blocks' partials of warp w's rows
// (their reduce-scatter into `rs`, whose bytes complete `bar`'s phase)
// and sums all NS partials in slice order, this block's own (`part`)
// among them, into part.
template <int NS>
__device__ __forceinline__ void cl_sum(float (&part)[32], uint32_t rs,
                                       uint32_t bar, int w, int lane, int r,
                                       uint32_t parity) {
  if (lane == 0) hopper::mbar_arrive_tx(bar, (NS - 1) * CL_F32_CHUNK);
  hopper::mbar_wait_cluster(bar, parity);
  const uint32_t base =
      rs + (w - cl_first(r, NS)) * (NS - 1) * CL_F32_CHUNK + lane * 16;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v[4];
    // (rolled at four slices: unrolled there, the sources' addresses and
    // loads spilled; unrolled below, where rolled cost a fifth of the
    // kernels' time at two)
#pragma unroll(NS < 4 ? NS : 1)
    for (int s = 0; s < NS; ++s) {
      // slice s's partial: this block's own, or source s's chunk (the
      // chunks skip rank r)
      uint32_t in[4];
      if (s != r) ld_shared4(base + (s - (s > r)) * CL_F32_CHUNK + q * 512, in);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s == r ? part[4 * q + e] : __uint_as_float(in[e]);
        v[e] = s == 0 ? x : v[e] + x;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) part[4 * q + e] = v[e];
  }
}

// (not the owner) Stores this thread's partial of warp w's rows into the
// owner's reduce-scatter buffer `rs`, each store's bytes counted on the
// owner's `bar` for the warp.
template <int NS>
__device__ __forceinline__ void cl_send(const float (&part)[32], uint32_t rs,
                                        uint32_t bar, int w, int lane,
                                        int r) {
  const int o = cl_owner(w, NS);
  const uint32_t dst = hopper::mapa(
      rs + ((w - cl_first(o, NS)) * (NS - 1) + r - (r > o)) * CL_F32_CHUNK +
          lane * 16,
      o);
  const uint32_t at = hopper::mapa(bar, o);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    hopper::st_async(dst + q * 512, __float_as_uint(part[4 * q]),
                     __float_as_uint(part[4 * q + 1]),
                     __float_as_uint(part[4 * q + 2]),
                     __float_as_uint(part[4 * q + 3]), at);
}

// The all-gather slot of warp w's rows in the buffer of rank r.
template <int NS>
__device__ __forceinline__ int cl_ag_slot(int w, int r) {
  return w < cl_first(r, NS) ? w : w - cl_owned(r, NS);
}

// (owner) Stores warp w's A fragments into every other block's all-gather
// buffer `ag`, each store's bytes counted on that block's `bar` for the
// warp.
template <int NS>
__device__ __forceinline__ void cl_give(const uint32_t (&frag)[4][4],
                                        uint32_t ag, uint32_t bar, int w,
                                        int lane, int r) {
  // (rolled at four slices, as cl_sum's)
#pragma unroll(NS < 4 ? NS : 1)
  for (int s = 0; s < NS; ++s) {
    if (s == r) continue;
    const uint32_t dst = hopper::mapa(
        ag + cl_ag_slot<NS>(w, s) * CL_FRAG_CHUNK + lane * 16, s);
    const uint32_t at = hopper::mapa(bar, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::st_async(dst + kk * 512, frag[kk][0], frag[kk][1], frag[kk][2],
                       frag[kk][3], at);
  }
}

// (not the owner) Waits for the owner's A fragments of warp w's rows in
// this block's all-gather buffer `ag` (with `announce`, its lane 0 posts
// the bytes `bar`'s phase expects: one warp does, where two read) and
// reads them.
template <int NS>
__device__ __forceinline__ void cl_take(uint32_t (&frag)[4][4], uint32_t ag,
                                        uint32_t bar, int w, int lane, int r,
                                        uint32_t parity, bool announce) {
  if (announce && lane == 0) hopper::mbar_arrive_tx(bar, CL_FRAG_CHUNK);
  hopper::mbar_wait_cluster(bar, parity);
  const uint32_t src = ag + cl_ag_slot<NS>(w, r) * CL_FRAG_CHUNK + lane * 16;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ld_shared4(src + kk * 512, frag[kk]);
}

// The exchange barriers of one tile: a reduce-scatter barrier per warp
// and an all-gather barrier per warp, 8 barriers at `bars`, each phase
// one arrival (the reader's, announcing the bytes) and the bytes the
// other blocks store.
__device__ __forceinline__ void cl_init_bars(uint32_t bars) {
  for (int w = 0; w < 8; ++w) hopper::mbar_init(bars + 8 * w, 1);
}

// The ring of a cluster kernel: SLOTS slots of one operand's 256-column
// slice (64 rows, four 64-column boxes, 32 KB), filled in item order, item
// n in slot n % SLOTS.  An item is for one of G groups of consumers: the
// producer's arrival (with the item's bytes) completes that group's full
// barrier of the slot, full[SLOTS][G], and `consumers` threads hand the
// slot back on empty[SLOTS].  A consumer keeps a phase bit for each slot
// of its group's (`phases`), so that a group that skips the other group's
// items never waits on a phase it is more than one ahead of; the producer
// waits for every item's slot in order.
template <int SLOTS, int G>
struct ClusterRing {
  uint32_t base, bars;
  static constexpr int OPND = 4 * 64 * 128;
  static constexpr int BARS = SLOTS * (G + 1);

  __device__ __forceinline__ uint32_t full(int n, int grp) const {
    return bars + 8 * ((n % SLOTS) * G + grp);
  }
  __device__ __forceinline__ uint32_t empty(int n) const {
    return bars + 8 * (SLOTS * G + n % SLOTS);
  }
  __device__ __forceinline__ uint32_t slot(int n) const {
    return base + (n % SLOTS) * OPND;
  }
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < SLOTS; ++s) {
      for (int grp = 0; grp < G; ++grp) hopper::mbar_init(full(s, grp), 1);
      hopper::mbar_init(empty(s), consumers);
    }
  }
  // (producer) item n's slot once handed back, announcing `bytes` to
  // group grp
  __device__ __forceinline__ uint32_t put(int n, int grp,
                                          uint32_t bytes) const {
    if (n >= SLOTS) hopper::mbar_wait(empty(n), (n / SLOTS - 1) & 1);
    hopper::mbar_arrive_tx(full(n, grp), bytes);
    return slot(n);
  }
  // (group grp) item n's slot once filled
  __device__ __forceinline__ uint32_t take(int n, int grp,
                                           uint32_t& phases) const {
    const int s = n % SLOTS;
    hopper::mbar_wait(full(n, grp), (phases >> s) & 1);
    phases ^= 1u << s;
    return slot(n);
  }
  __device__ __forceinline__ void give(int n) const {
    hopper::mbar_arrive(empty(n));
  }
};

// The slots a cluster kernel's ring gets: as many as the block's shared
// memory holds after `fixed` bytes and `bars` mbarriers besides the ring's,
// at most 4.
__host__ __device__ constexpr int cluster_slots(int fixed, int bars) {
  return cmin(4, (smem_budget(1) - fixed - 1024 - 8 * bars) /
                     ClusterRing<1, 1>::OPND);
}

// dkv_cluster_kernel: 64 keys a block (the transposed frame), warpgroup 0
// forming S^T and holding dV's slice, warpgroup 1 forming dP^T and holding
// dK's, as dkv_sliced_kernel; the block walks its KV head's query-head
// group and each head's 64-query tiles in order.  Its K and V slices stay
// in shared memory; per query tile the producer fills one slot with Q's
// slice and one with dO's.  Warpgroup 0 contracts K Q^T, warpgroup 1 V
// dO^T over the slice; each tile is summed across the cluster; the owner
// of a warp's rows forms P^T (warpgroup 0), hands it to warpgroup 1
// through shared memory (f32, its owned warps' rows only) to form dS^T,
// and gives out the rows' fragments; then dV += P^T dO (dO's slot) and dK
// += dS^T Q (Q's slot), m64n256 each; with four slots the next tile's
// contraction runs while this tile's fragments are handed out.  Every
// slot holds a whole slice:
// its boxes past ld come back zero, so the last slice of a head dim that
// is not a multiple of 256 runs the same products.  Grid:
// dkv_sliced_kernel's (key tile, b*kv_head, slice), slices fastest, one
// cluster per (key tile, b*kv_head).
template <int NS>
struct DkvClusterSmem {
  static constexpr int BM = 64, BQ = 64;
  static constexpr int BOX = 64 * 128;
  static constexpr int OPND = 4 * BOX;  // a 64-row slice of one operand
  static constexpr int X_BYTES =
      ClusterX<NS>::RS_BYTES + ClusterX<NS>::AG_BYTES;
  static constexpr int X_OFF = 2 * OPND;  // K's and V's slices first
  static constexpr int P_OFF = X_OFF + 2 * X_BYTES;  // S^T's, dP^T's area
  static constexpr int P_BYTES = cl_max_owned(NS) * CL_F32_CHUNK;
  static constexpr int RING_OFF = P_OFF + P_BYTES;
  // kv_full; ring full/empty; S^T's and dP^T's exchange bars; p_full[4],
  // p_empty[4]
  static constexpr int SLOTS = cluster_slots(RING_OFF, 1 + 8 + 16 + 8);
  using Ring = ClusterRing<SLOTS, 1>;
  static constexpr int BAR_OFF = RING_OFF + SLOTS * OPND;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + Ring::BARS + 16 + 8) + 1024;
  static_assert(SLOTS >= 2 && BYTES <= smem_budget(1),
                "cluster dk/dv does not fit");
};

template <typename E, int NS>
__global__ void __launch_bounds__(384, 1)
    dkv_cluster_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, E* __restrict__ dk,
                       E* __restrict__ dv, int heads, int kv_heads, int ld,
                       float scale, Mask mk) {
  using S = DkvClusterSmem<NS>;
  constexpr int BQ = S::BQ, BOX = S::BOX;
  // with two tiles' slots in the ring the next tile's contraction is
  // issued before this tile's products; with fewer it would wait for
  // their slots, so it follows them
  constexpr bool AHEAD = S::SLOTS >= 4;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t bars = base + S::BAR_OFF;
  const uint32_t kv_full = bars;
  const typename S::Ring rg{base + S::RING_OFF, bars + 8};
  const uint32_t x_bars = bars + 8 * (1 + S::Ring::BARS);  // [2][8]
  const uint32_t p_full = x_bars + 8 * 16, p_empty = p_full + 32;

  const int T = mk.T;
  const int n_kt = (T + 63) / 64;
  const int x = (int)blockIdx.x;
  const int slice = x % NS, rest = x / NS;
  const int bkv_n = (int)gridDim.x / (n_kt * NS);
  const int bkv = rest % bkv_n, k0 = rest / bkv_n * 64;
  const int cb = 4 * slice;
  const int group = heads / kv_heads;
  const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group;
  int qlo, qhi;
  query_tiles<BQ>(k0, 64, mk, &qlo, &qhi);
  const int nq = qhi - qlo, n_iter = group * nq;
  const int r = (int)hopper::cluster_rank();

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    rg.init(256);
    cl_init_bars(x_bars);
    cl_init_bars(x_bars + 64);
    for (int w = 0; w < 4; ++w) {
      hopper::mbar_init(p_full + 8 * w, 32);
      hopper::mbar_init(p_empty + 8 * w, 32);
    }
    hopper::mbar_init_fence();
  }
  // no partner arrives on a barrier before it is initialised
  hopper::cluster_sync();

  if (threadIdx.x >= 256) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_tx(kv_full, 2 * S::OPND);
      for (int b = 0; b < 4; ++b) {
        hopper::tma_load(base + b * BOX, &map_k, 64 * (cb + b), k0, bkv,
                         kv_full);
        hopper::tma_load(base + S::OPND + b * BOX, &map_v, 64 * (cb + b), k0,
                         bkv, kv_full);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int bh = qbase + it / nq, q0 = (qlo + it % nq) * BQ;
        for (int o = 0; o < 2; ++o) {  // Q's slice, then dO's
          const int n = 2 * it + o;
          const uint32_t at = rg.put(n, 0, S::OPND);
          for (int b = 0; b < 4; ++b)
            hopper::tma_load(at + b * BOX, o == 0 ? &map_q : &map_do,
                             64 * (cb + b), q0, bh, rg.full(n, 0));
        }
      }
    }
  } else {
    hopper::reg_alloc<hopper::reg_consumer(2, 1)>();
    // warpgroup 0: S^T, P^T and dV; warpgroup 1: dP^T, dS^T and dK; each
    // warpgroup's code apart (wg a constant), so that neither holds what
    // only the other needs
    auto consumer = [&](auto wg_c) {
      constexpr int wg = decltype(wg_c)::value;
      const int tid = threadIdx.x & 127;
      const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
      const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
      const float sl2 = scale * LOG2E;
      const bool own = !CLUSTER_EXCHANGE || cl_owner(warp, NS) == r;
      // this warpgroup's contraction operand (K or V), its tile's exchange
      // area and bars, its row scalars (lse or delta)
      const uint32_t a_tile = base + wg * S::OPND;
      const uint32_t rs = base + S::X_OFF + wg * S::X_BYTES;
      const uint32_t ag = rs + ClusterX<NS>::RS_BYTES;
      const uint32_t rs_bar = x_bars + 64 * wg + 8 * warp;
      const uint32_t ag_bar = rs_bar + 32;
      const int ow = CLUSTER_EXCHANGE ? warp - cl_first(r, NS)
                                      : warp % cl_max_owned(NS);
      const uint32_t p_at = base + S::P_OFF + ow * CL_F32_CHUNK + lane * 16;
      const float* row_src = wg == 0 ? lse : delta;

      float acc[128];  // dV (warpgroup 0) or dK (1): the slice's 256 columns
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      float st[BQ / 2];  // S^T, then P^T (wg 0); dP^T, then dS^T (wg 1)
      uint32_t phases = 0;
      hopper::mbar_wait(kv_full, 0);

      // the contraction of query tile `it` over the slice (Q's item for
      // warpgroup 0, dO's for 1)
      auto contract = [&](int it) {
        const uint32_t b_tile = rg.take(2 * it + wg, 0, phases);
        hopper::wg_fence();
        // a rolled loop over the column blocks: the block's resident K or V
        // slice would otherwise keep 16 descriptors in registers beside dV's
        // or dK's 128
#pragma unroll 1
        for (int cb4 = 0; cb4 < 16; cb4 += 4) {
#pragma unroll
          for (int kk = cb4; kk < cb4 + 4; ++kk)
            if (CLUSTER_PRODUCTS)
              hopper::Mma<E>::ss(st, hopper::desc_k(a_tile, 64, kk),
                                 hopper::desc_k(b_tile, BQ, kk), kk > 0);
        }
        hopper::wg_commit();
      };

      if (n_iter > 0) contract(0);
      for (int it = 0; it < n_iter; ++it) {
        const int bh = qbase + it / nq, q0 = (qlo + it % nq) * BQ;
        // the owner's row scalars (lse or delta) of queries q0 + 2 lane +
        // e, loaded under the contraction; the thread's query columns q0 +
        // 8j + 2t + e are lane 4j + t's
        float rv[2];
        if (own) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = q0 + 2 * lane + e;
            rv[e] = i < T ? row_src[(size_t)bh * T + i] : 0.f;
          }
        }
        // this tile's contraction (ahead: and the last tile's products)
        hopper::wg_wait<0>();
        hopper::wg_fence_regs(st);
        if (AHEAD && it > 0) {
          rg.give(2 * it - 2);
          rg.give(2 * it - 1);
        }
        if (!CLUSTER_PRODUCTS) {
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) st[i] = 0.f;
        }
        const uint32_t parity = it & 1;
        uint32_t frag[BQ / 16][4];
        if (own) {
          if (CLUSTER_EXCHANGE)
            cl_sum<NS>(st, rs, rs_bar, warp, lane, r, parity);
          if (wg == 0) {
            const bool full = tile_full(mk, q0, BQ, k0, 64);
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float l2 =
                    __shfl_sync(0xffffffffu, rv[e], 4 * j + t) * LOG2E;
                const int q = q0 + 8 * j + 2 * t + e;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int i = 4 * j + 2 * h + e;
                  const float p = exp2_approx(fmaf(st[i], sl2, -l2));
                  st[i] = full || mk.live(q, key[h]) ? p : 0.f;
                }
              }
            }
            // warpgroup 1 has read the previous P^T
            if (it >= 1) hopper::mbar_wait(p_empty + 8 * warp, (it - 1) & 1);
#pragma unroll
            for (int q = 0; q < 8; ++q)
              st_shared4(p_at + q * 512, __float_as_uint(st[4 * q]),
                         __float_as_uint(st[4 * q + 1]),
                         __float_as_uint(st[4 * q + 2]),
                         __float_as_uint(st[4 * q + 3]));
            hopper::mbar_arrive(p_full + 8 * warp);
          } else {
            hopper::mbar_wait(p_full + 8 * warp, parity);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              uint32_t p[4];  // elements 4j + 2h + e
              ld_shared4(p_at + j * 512, p);
              const float dl[2] = {__shfl_sync(0xffffffffu, rv[0], 4 * j + t),
                                   __shfl_sync(0xffffffffu, rv[1], 4 * j + t)};
#pragma unroll
              for (int x = 0; x < 4; ++x)
                st[4 * j + x] =
                    __uint_as_float(p[x]) * (st[4 * j + x] - dl[x & 1]);
            }
            hopper::mbar_arrive(p_empty + 8 * warp);
          }
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a<E>(frag[kk], st, kk);
        } else if (CLUSTER_EXCHANGE) {
          cl_send<NS>(st, rs, rs_bar, warp, lane, r);
        }
        // ahead: the next tile's contraction runs while this tile's
        // fragments are handed out
        if (AHEAD && it + 1 < n_iter) contract(it + 1);
        if (own) {
          if (CLUSTER_EXCHANGE) cl_give<NS>(frag, ag, ag_bar, warp, lane, r);
        } else if (CLUSTER_EXCHANGE) {
          cl_take<NS>(frag, ag, ag_bar, warp, lane, r, parity, true);
        }

        // dV += P^T dO (dO's item), dK += dS^T Q (Q's item)
        const uint32_t c_tile = rg.take(2 * it + 1 - wg, 0, phases);
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          if (CLUSTER_PRODUCTS)
            hopper::Mma<E>::rs256(acc, frag[kk],
                                  hopper::desc_mn_wide(c_tile, BQ, kk));
        hopper::wg_commit();
        if (!AHEAD) {
          hopper::wg_wait<0>();
          rg.give(2 * it);
          rg.give(2 * it + 1);
          if (it + 1 < n_iter) contract(it + 1);
        }
      }
      hopper::wg_wait<0>();
      if (AHEAD && n_iter > 0) {
        rg.give(2 * n_iter - 2);
        rg.give(2 * n_iter - 1);
      }
      hopper::wg_fence_regs(acc);

      E* out = wg == 0 ? dv : dk;
      const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = key[h];
        if (j >= T) continue;
        const size_t off = ((size_t)bkv * T + j) * ld;
#pragma unroll
        for (int c8 = 0; c8 < 32; ++c8) {
          const int i = 4 * c8 + 2 * h;
          const int c = SLICE * slice + 8 * c8 + 2 * t;
          if (c < ld) store2(out + off + c, acc[i] * mul, acc[i + 1] * mul);
        }
      }
    };
    if (threadIdx.x < 128)
      consumer(std::integral_constant<int, 0>{});
    else
      consumer(std::integral_constant<int, 1>{});
  }
  // no block exits while a partner may still store or arrive into it
  hopper::cluster_sync();
}

// dq_cluster_kernel: 64 query rows a block, the dk/dv kernel's plan in
// the row frame: warpgroup 0 forms S = Q K^T and holds dq's first 128
// columns of the slice, warpgroup 1 forms dP = dO V^T and holds the other
// 128.  The Q and dO slices stay in shared memory; per 64-key step (in
// key_tiles' order) the producer fills one slot with V's slice and one
// with K's.  Each tile is summed across the cluster; the owner of a
// warp's rows forms p (warpgroup 0) and hands it to warpgroup 1 through
// shared memory (f32) to form ds as dq_kernel does, whose fragments go to
// warpgroup 0 through shared memory and to the other blocks (one
// all-gather area that both warpgroups read); then each warpgroup adds dS
// K over its half of the slice, m64n128.  The two hand-overs take turns,
// so neither buffer needs a barrier back: warpgroup 0 writes the next p
// only after it has read ds, which warpgroup 1 wrote after reading p.  The
// next step's contraction is issued once this step's partials are summed
// or sent, and runs while the fragments are handed out (V's slot goes
// back at its contraction, so the ring never waits on the products).
// Every slot holds a whole slice, its boxes past ld zero, as in
// dkv_cluster_kernel.  Grid: dq_sliced_kernel's (b*h, row tile, slice)
// over 64-row tiles, one cluster per (b*h, row tile).
// 64 rows and not dq_sliced_kernel's 128: the two warpgroups' Q and dO
// slices (128 KB) leave no room for two K and V slots beside the exchange;
// and each warpgroup holds half of the slice's columns, not one of two
// warpgroups taking the key steps in turns with the whole slice each,
// because that plan's 128 accumulator registers beside S and dP spilled.
template <int NS>
struct DqClusterSmem {
  static constexpr int BM = 64, BK = 64;
  static constexpr int BOX = 64 * 128;
  static constexpr int OPND = 4 * BOX;
  static constexpr int RS_BYTES = ClusterX<NS>::RS_BYTES;
  // one step's exchange: S's and dP's reduce-scatter, dS's all-gather
  static constexpr int X_STEP = 2 * RS_BYTES + ClusterX<NS>::AG_BYTES;
  // p (f32) and ds's fragments of the owned warps, warpgroup to warpgroup
  static constexpr int HAND = cl_max_owned(NS) * (CL_F32_CHUNK + CL_FRAG_CHUNK);
  // qd_full; ring full/empty; [2 buffers][S, dP][8] exchange bars;
  // p_full[4], ds_full[4]
  static constexpr int N_BARS = 1 + 8 + 32 + 8;
  // two steps' exchange buffers where they leave three slots (two
  // slices): the next step's partial goes out before this step's
  // fragments come back
  static constexpr bool DB =
      cluster_slots(2 * OPND + 2 * X_STEP + HAND, N_BARS) >= 3;
  static constexpr int X_OFF = 2 * OPND;  // Q's and dO's slices first
  static constexpr int P_OFF = X_OFF + (DB ? 2 : 1) * X_STEP;
  static constexpr int DS_OFF = P_OFF + cl_max_owned(NS) * CL_F32_CHUNK;
  static constexpr int RING_OFF = X_OFF + (DB ? 2 : 1) * X_STEP + HAND;
  static constexpr int SLOTS = cluster_slots(RING_OFF, N_BARS);
  using Ring = ClusterRing<SLOTS, 1>;
  static constexpr int BAR_OFF = RING_OFF + SLOTS * OPND;
  static constexpr int BYTES =
      BAR_OFF + 8 * (N_BARS - 8 + Ring::BARS) + 1024;
  static_assert(SLOTS >= 3 && BYTES <= smem_budget(1),
                "cluster dq does not fit");
};

template <typename E, int NS>
__global__ void __launch_bounds__(384, 1)
    dq_cluster_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, E* __restrict__ dq,
                      int group, int ld, float scale, Mask mk) {
  using S = DqClusterSmem<NS>;
  constexpr int BM = S::BM, BK = S::BK, BOX = S::BOX;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t bars = base + S::BAR_OFF;
  const uint32_t qd_full = bars;
  const typename S::Ring rg{base + S::RING_OFF, bars + 8};
  const uint32_t x_bars = bars + 8 * (1 + S::Ring::BARS);  // [2][2][8]
  const uint32_t p_full = x_bars + 8 * 32, ds_full = p_full + 32;

  const int T = mk.T;
  const SliceTile tl = slice_tile(BM, T, NS);
  const int bh = tl.bh, q0 = tl.tile * BM;
  const int cb = 4 * tl.slice;
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);
  const int r = (int)hopper::cluster_rank();

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    rg.init(256);
    for (int x = 0; x < 4; ++x) cl_init_bars(x_bars + 64 * x);
    for (int w = 0; w < 4; ++w) {
      hopper::mbar_init(p_full + 8 * w, 32);
      hopper::mbar_init(ds_full + 8 * w, 32);
    }
    hopper::mbar_init_fence();
  }
  // no partner arrives on a barrier before it is initialised
  hopper::cluster_sync();

  if (threadIdx.x >= 256) {  // producer warpgroup
    hopper::reg_dealloc<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int bkv = bh / group;
      hopper::mbar_arrive_tx(qd_full, 2 * S::OPND);
      for (int b = 0; b < 4; ++b) {
        hopper::tma_load(base + b * BOX, &map_q, 64 * (cb + b), q0, bh,
                         qd_full);
        hopper::tma_load(base + S::OPND + b * BOX, &map_do, 64 * (cb + b),
                         q0, bh, qd_full);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        for (int o = 0; o < 2; ++o) {  // V's slice, then K's
          const int n = 2 * it + o;
          const uint32_t at = rg.put(n, 0, S::OPND);
          for (int b = 0; b < 4; ++b)
            hopper::tma_load(at + b * BOX, o == 0 ? &map_v : &map_k,
                             64 * (cb + b), k0, bkv, rg.full(n, 0));
        }
      }
    }
  } else {
    hopper::reg_alloc<hopper::reg_consumer(2, 1)>();

    // warpgroup 0: S, p and dq's first half; warpgroup 1: dP, ds and the
    // second half
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, +8
    const float sl2 = scale * LOG2E;
    const bool own = !CLUSTER_EXCHANGE || cl_owner(warp, NS) == r;
    // this warpgroup's contraction operand (Q or dO); in exchange buffer b
    // (the step's parity with two, else 0) its tile's reduce-scatter area
    // and bars, the all-gather's (dP's tile's bars)
    const uint32_t a_tile = base + wg * S::OPND;
    auto rs = [&](int b) {
      return base + S::X_OFF + b * S::X_STEP + wg * S::RS_BYTES;
    };
    auto ag = [&](int b) {
      return base + S::X_OFF + b * S::X_STEP + 2 * S::RS_BYTES;
    };
    auto rs_bar = [&](int b) {
      return x_bars + 128 * b + 64 * wg + 8 * warp;
    };
    auto ag_bar = [&](int b) { return x_bars + 128 * b + 96 + 8 * warp; };
    // a buffer's barrier completes once every two steps with two
    auto buf = [&](int it) { return S::DB ? it & 1 : 0; };
    auto xpar = [&](int it) { return S::DB ? (it >> 1) & 1 : it & 1; };
    const int ow =
        CLUSTER_EXCHANGE ? warp - cl_first(r, NS) : warp % cl_max_owned(NS);
    const uint32_t p_at = base + S::P_OFF + ow * CL_F32_CHUNK + lane * 16;
    const uint32_t ds_at = base + S::DS_OFF + ow * CL_FRAG_CHUNK + lane * 16;
    // lse * log2 e (warpgroup 0) or delta (1) of this thread's rows
    float rowv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + 8 * h;
      rowv[h] = i >= T ? 0.f
                : wg == 0 ? lse[(size_t)bh * T + i] * LOG2E
                          : delta[(size_t)bh * T + i];
    }

    float acc[64];  // dq over this warpgroup's half of the slice
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float st[BK / 2];  // S, then p (wg 0); dP, then ds (wg 1)
    uint32_t phases = 0;
    hopper::mbar_wait(qd_full, 0);

    // the contraction of key step `it` over the slice (Q K^T for
    // warpgroup 0, dO V^T for 1); warpgroup 0 hands V's slot back at once,
    // warpgroup 1 once its contraction completes
    auto contract = [&](int it) {
      const uint32_t v_tile = rg.take(2 * it, 0, phases);
      const uint32_t k_tile = rg.take(2 * it + 1, 0, phases);
      if (wg == 0) rg.give(2 * it);
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        if (CLUSTER_PRODUCTS)
          hopper::Mma<E>::ss(st, hopper::desc_k(a_tile, 64, kk),
                             hopper::desc_k(wg == 0 ? k_tile : v_tile, BK,
                                            kk),
                             kk > 0);
      hopper::wg_commit();
    };

    // The step's exchange: the owner of a warp's rows sums its partials,
    // forms p and ds and gives out ds's fragments; the others send their
    // partials and take the fragments.  With two exchange buffers a
    // non-owner sends the next step's partial as soon as it is formed,
    // before this step's fragments come back (with one, after).
    if (n_iter > 0) {
      contract(0);
      hopper::wg_wait<0>();
      hopper::wg_fence_regs(st);
      if (wg == 1) rg.give(0);
      if (!own && CLUSTER_EXCHANGE)
        cl_send<NS>(st, rs(0), rs_bar(0), warp, lane, r);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
      const int b = buf(it);
      // the last step's products are done; its K's slot goes back
      hopper::wg_wait<0>();
      if (it > 0) rg.give(2 * it - 1);
      const bool next = it + 1 < n_iter;
      uint32_t frag[BK / 16][4];
      if (own) {
        if (!CLUSTER_PRODUCTS) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) st[i] = 0.f;
        }
        if (CLUSTER_EXCHANGE)
          cl_sum<NS>(st, rs(b), rs_bar(b), warp, lane, r, xpar(it));
        if (wg == 0) {
#pragma unroll
          for (int x = 0; x < BK / 2; ++x)
            st[x] = exp2_approx(fmaf(st[x], sl2, -rowv[(x >> 1) & 1]));
          if (!tile_full(mk, q0, 64, k0, BK)) mask_tile(st, mk, row0, k0, t);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            st_shared4(p_at + q * 512, __float_as_uint(st[4 * q]),
                       __float_as_uint(st[4 * q + 1]),
                       __float_as_uint(st[4 * q + 2]),
                       __float_as_uint(st[4 * q + 3]));
          hopper::mbar_arrive(p_full + 8 * warp);
        } else {
          hopper::mbar_wait(p_full + 8 * warp, it & 1);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            uint32_t pv[4];
            ld_shared4(p_at + q * 512, pv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = 4 * q + e;
              st[x] = __uint_as_float(pv[e]) * (st[x] - rowv[(x >> 1) & 1]);
            }
          }
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(frag[kk], st, kk);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            st_shared4(ds_at + kk * 512, frag[kk][0], frag[kk][1],
                       frag[kk][2], frag[kk][3]);
          hopper::mbar_arrive(ds_full + 8 * warp);
        }
      }
      // the next step's contraction, while this step's fragments are
      // handed out
      if (next) {
        contract(it + 1);
        hopper::wg_wait<0>();
        hopper::wg_fence_regs(st);
        if (wg == 1) rg.give(2 * it + 2);  // V's slot
        if (S::DB && !own && CLUSTER_EXCHANGE)
          cl_send<NS>(st, rs(buf(it + 1)), rs_bar(buf(it + 1)), warp, lane,
                      r);
      }
      if (own) {
        if (wg == 0) {  // ds's fragments from warpgroup 1
          hopper::mbar_wait(ds_full + 8 * warp, it & 1);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            ld_shared4(ds_at + kk * 512, frag[kk]);
        } else if (CLUSTER_EXCHANGE) {
          cl_give<NS>(frag, ag(b), ag_bar(b), warp, lane, r);
        }
      } else if (CLUSTER_EXCHANGE) {
        cl_take<NS>(frag, ag(b), ag_bar(b), warp, lane, r, xpar(it),
                    wg == 1);
        if (!S::DB && next)
          cl_send<NS>(st, rs(0), rs_bar(0), warp, lane, r);
      }

      // dq's half += dS K (K's slot, this warpgroup's two column blocks)
      const uint32_t k_tile = rg.slot(2 * it + 1);
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        if (CLUSTER_PRODUCTS)
          hopper::Mma<E>::rs128(
              acc, frag[kk],
              hopper::desc_mn_wide(k_tile + wg * 2 * BOX, BK, kk));
      hopper::wg_commit();
    }
    hopper::wg_wait<0>();
    if (n_iter > 0) rg.give(2 * n_iter - 1);
    hopper::wg_fence_regs(acc);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + 8 * h;
      if (i >= T) continue;
      E* out = dq + ((size_t)bh * T + i) * ld;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = SLICE * tl.slice + 128 * wg + 8 * j + 2 * t;
        if (c < ld)
          store2(out + c, acc[4 * j + 2 * h] * scale,
                 acc[4 * j + 2 * h + 1] * scale);
      }
    }
  }
  // no block exits while a partner may still store or arrive into it
  hopper::cluster_sync();
}

// ---------------------------------------------------------------------------
// The pair forward: head dims 257..PAIR_REACH in bf16 and fp16,
// fwd_pair_kernel.  It replaces tf_operator_tpu/ops/attention.py:_fwd_kernel
// there; above the reach, and in f32, fwd_sliced_kernel and its f32
// counterpart run.
//
// fwd_sliced_kernel writes one 256-column slice of O a block, so every
// slice's block of a row tile contracts S over the whole head dim: at ld
// 512, 1.5x the bound's products.  Here one block takes a 64-row tile and
// the whole head dim, and its two consumer warpgroups split the head dim's
// 64-column chunks: warpgroup 0 the first ceil(nc / 2), warpgroup 1 the
// rest (at most 4 each up to the reach, so an output accumulator stays at
// 128 registers a thread).  The same half serves twice:
//   * each warpgroup contracts Q K^T over its chunks into a partial S [64 x
//     64] f32 and passes it through shared memory a 32-column half at a
//     time: stores the half into its buffer of that half, meets the same
//     warp of the other warpgroup at a named barrier (one per warp pair,
//     64 threads) and reads the other's.  The two warpgroups' accumulator
//     layouts are the same, so each thread reads the other's partial of
//     its own elements and adds warpgroup 0's + warpgroup 1's: both hold
//     the same bits, and both run online_softmax to the same m, l and P;
//   * each warpgroup adds P V over its own V column blocks into its output
//     accumulator, P from registers, as one m64n256 product a 16-key step
//     at four blocks (m64n128, + m64n64, below), and writes those columns
//     of O (warpgroup 0 writes lse).
// So each element of S is computed once, and the products are the
// bound's.  Q's 64 x ld tile is loaded once and stays (each warpgroup's
// chunks on a barrier of its own).  Each warpgroup streams a key step's K
// chunks and then its V column blocks as two 32 KB slabs (their 64-column
// boxes 8 KB apart, one ring item each) through a ring of two slots,
// filled by a producer thread of its own: the next step's K slab loads
// while this step's V slab is in use, and a step waits on two items.  A
// warpgroup writes a half's buffer again a step later only after the
// barrier of the other half, which the other warpgroup reaches only after
// it has read the first, so one barrier a half is the whole exchange
// (tests/test_torch_fwd_pair.py models it and the rings under random
// interleavings).  The grid is fwd_sliced_kernel's with one slice: (b*h,
// row tile), each b*h's tiles from the last (the longest under causal
// masking) down.
// Bound: operations (2 products), 0.0695 ms at the wide_head path's d512_mqa
// on an H100, where the kernel runs at 0.32 of it, 29 % under
// fwd_sliced_kernel.  The same split over 8 KB ring stages, a wait for
// each chunk and m64n64 P V products ran level with fwd_sliced_kernel, and
// issuing the next step's contraction behind this step's P V (with a
// branch at the last step, or a last K slab never loaded) was 2-14 %
// slower than this.  Without its products the kernel still takes 0.69 of
// its time, without the exchange 0.79, without the softmax 0.78 (PERF.md
// has the times and the designs tried): the two warpgroups walk each
// step's chain in lockstep, so that neither's exchange and softmax hide
// under the other's products.
constexpr int PAIR_REACH = 512;

// Diagnostics for kernel_variants.py only (all true in every build the
// wrappers load; each one false gives wrong outputs): without
// PAIR_EXCHANGE each warpgroup takes its own partial for the whole S (no
// exchange); without PAIR_LOADS the rings are filled at a block's first
// key step only (later steps read stale stages); without PAIR_PRODUCTS no
// product is issued; without PAIR_SOFTMAX P is S as it stands (no
// exponentials, no rescale).
constexpr bool PAIR_EXCHANGE = true;
constexpr bool PAIR_LOADS = true;
constexpr bool PAIR_PRODUCTS = true;
constexpr bool PAIR_SOFTMAX = true;

// Shared memory (bytes; of a block's 232,448): Q's resident tile, up to 8
// chunks of 64 rows x 64 columns (65,536); the exchange buffers, two per
// warpgroup of one 32-column half of a partial S each, 64 x 32 f32 (4 x
// 8,192); each warpgroup's ring of two 32 KB slots, a key step's K chunks
// (a slab) or V column blocks in each, their 64-column boxes 8 KB apart
// (2 x 65,536); the mbarriers (Q's two, then each ring's full and empty)
// and 1 KB of alignment slack: 230,480 in all.
struct FwdPairSmem {
  static constexpr int BM = 64, BK = 64;
  static constexpr int CHUNK = 64 * 128;  // 64 rows of one 64-column chunk
  static constexpr int Q_BYTES = PAIR_REACH / 64 * CHUNK;
  static constexpr int X_BYTES = 64 * 32 * 4;  // a half's partial S
  static constexpr int X_OFF = Q_BYTES;        // [warpgroup][half]
  static constexpr int SLAB = 4 * CHUNK;       // a warpgroup's chunks
  static constexpr int STAGES = 2;             // a warpgroup's ring
  static constexpr int RING_OFF = X_OFF + 4 * X_BYTES;
  static constexpr int BAR_OFF = RING_OFF + 2 * STAGES * SLAB;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;
  static_assert(BYTES <= smem_budget(1), "pair forward does not fit");
};

// The block's registers: its producer threads keep 40 (at the other
// kernels' 24 the producer's walk over two slabs of up to four boxes
// spilled), each consumer 232 (not 240).
constexpr int PAIR_PRODUCER_REGS = 40;
constexpr int PAIR_CONSUMER_REGS = 232;
static_assert(PAIR_PRODUCER_REGS + 2 * PAIR_CONSUMER_REGS ==
                  3 * hopper::reg_base(2, 1),
              "pair forward's register split");

// Warpgroup w's chunks of nc: [first, first + count).
__host__ __device__ constexpr int pair_first(int w, int nc) {
  return w == 0 ? 0 : (nc + 1) / 2;
}
__host__ __device__ constexpr int pair_count(int w, int nc) {
  return w == 0 ? (nc + 1) / 2 : nc - (nc + 1) / 2;
}

// Warpgroup w's ring.
__device__ __forceinline__ SlicedRing<FwdPairSmem::STAGES> pair_ring(
    uint32_t base, int w) {
  using S = FwdPairSmem;
  return {base + S::BAR_OFF + 16 + w * 16 * S::STAGES, 0};
}

// P V over CN column blocks of a V slab whose 64-column blocks lie CHUNK
// apart: m64n256 at four blocks, m64n128 (+ m64n64) below.
template <typename E, int CN>
__device__ __forceinline__ void pair_pv(float (&o_acc)[4][32],
                                        const uint32_t (&p_frag)[4][4],
                                        uint32_t slab) {
  using S = FwdPairSmem;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (CN == 4) {
      hopper::Mma<E>::rs256(reinterpret_cast<float(&)[128]>(o_acc),
                            p_frag[kk], hopper::desc_mn_wide(slab, 64, kk));
    } else {
      hopper::Mma<E>::rs128(reinterpret_cast<float(&)[64]>(o_acc),
                            p_frag[kk], hopper::desc_mn_wide(slab, 64, kk));
      if constexpr (CN == 3)
        hopper::Mma<E>::rs64(o_acc[2], p_frag[kk],
                             hopper::desc_mn(slab + 2 * S::CHUNK, 64, kk, 0));
    }
  }
}

template <typename E, bool SCALED>
__global__ void __launch_bounds__(384, 1)
    fwd_pair_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    E* __restrict__ o, float* __restrict__ lse, int group,
                    int ld, float scale, Mask mk) {
  using S = FwdPairSmem;
  constexpr int BM = S::BM, BK = S::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = hopper::smem_addr(aligned_smem(smem_raw));
  const uint32_t q_full = base + S::BAR_OFF;  // [warpgroup]

  const int T = mk.T;
  const int nc = ceil_div(ld, 64);  // the head dim's 64-column chunks
  const SliceTile st = slice_tile(BM, T, 1);
  const int bh = st.bh, q0 = st.tile * BM;
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      hopper::mbar_init(q_full + 8 * w, 1);
      pair_ring(base, w).init(128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: warp w feeds warpgroup w
    hopper::reg_dealloc<PAIR_PRODUCER_REGS>();
    const int w = (threadIdx.x - 256) >> 5;
    if (w < 2 && (threadIdx.x & 31) == 0) {
      const int c0 = pair_first(w, nc), cn = pair_count(w, nc);
      const int bkv = bh / group;
      hopper::mbar_arrive_tx(q_full + 8 * w, cn * S::CHUNK);
      for (int c = c0; c < c0 + cn; ++c)
        hopper::tma_load(base + c * S::CHUNK, &map_q, 64 * c, q0, bh,
                         q_full + 8 * w);
      SlicedRing<S::STAGES> rg = pair_ring(base, w);
      const uint32_t ring = base + S::RING_OFF + w * S::STAGES * S::SLAB;
      for (int it = 0; it < n_iter; ++it) {
        const int k0 = (it < n_sink ? it : lo + it - n_sink) * BK;
        const bool load = PAIR_LOADS || it == 0;
        // the step's K slab, then its V slab
        for (int x = 0; x < 2; ++x) {
          const int s = rg.put(load ? cn * S::CHUNK : 0);
          for (int c = 0; load && c < cn; ++c)
            hopper::tma_load(ring + s * S::SLAB + c * S::CHUNK,
                             x == 0 ? &map_k : &map_v, 64 * (c0 + c), k0,
                             bkv, rg.full(s));
        }
      }
    }
    return;
  }
  hopper::reg_alloc<PAIR_CONSUMER_REGS>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = scale * LOG2E;
  const int c0 = pair_first(wg, nc), cn = pair_count(wg, nc);
  SlicedRing<S::STAGES> rg = pair_ring(base, wg);
  const uint32_t ring = base + S::RING_OFF + wg * S::STAGES * S::SLAB;
  const uint32_t q_tile = base + c0 * S::CHUNK;  // this warpgroup's Q
  // this thread's 16 values of a half's partial in an exchange buffer: its
  // warp's 2 KB, 16-byte group q at q * 512 + lane * 16 (each warp's store
  // one contiguous 512 bytes), in its own warpgroup's buffers and the
  // other's
  const uint32_t x_own =
      base + S::X_OFF + wg * 2 * S::X_BYTES + warp * 2048 + lane * 16;
  const uint32_t x_other =
      base + S::X_OFF + (1 - wg) * 2 * S::X_BYTES + warp * 2048 + lane * 16;
  hopper::mbar_wait(q_full + 8 * wg, 0);

  // The body at CN chunks (2..4, known at compile time, so that the P V
  // product's width is).
  auto run = [&](auto count) {
    constexpr int CN = decltype(count)::value;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];
    float o_acc[4][32];  // this warpgroup's 64-column blocks (CN of them)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[b][i] = 0.f;
    for (int it = 0; it < n_iter; ++it) {
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

      // the partial S through the exchange buffers, a 32-column half at a
      // time: each stored, the other warpgroup's same warp met, its half
      // added (warpgroup 0's + warpgroup 1's in both)
#pragma unroll
      for (int h = 0; h < 2 * PAIR_EXCHANGE; ++h) {
        const uint32_t at = h * S::X_BYTES;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st_shared4(x_own + at + q * 512,
                     __float_as_uint(s_tile[16 * h + 4 * q]),
                     __float_as_uint(s_tile[16 * h + 4 * q + 1]),
                     __float_as_uint(s_tile[16 * h + 4 * q + 2]),
                     __float_as_uint(s_tile[16 * h + 4 * q + 3]));
        hopper::named_sync(1 + warp, 64);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t in[4];
          ld_shared4(x_other + at + q * 512, in);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& v = s_tile[16 * h + 4 * q + e];
            const float x = __uint_as_float(in[e]);
            v = wg == 0 ? v + x : x + v;
          }
        }
      }

      if (PAIR_SOFTMAX) {
        online_softmax<BK, SCALED>(s_tile, m, l, alpha, mk, q0, row0, k0, t,
                                   sl2);
#pragma unroll
        for (int b = 0; b < CN; ++b) {
#pragma unroll
          for (int x = 0; x < 32; ++x) o_acc[b][x] *= alpha[(x >> 1) & 1];
        }
      }
      uint32_t p_frag[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        acc_to_a<E>(p_frag[kk], s_tile, kk);
      // P V over this warpgroup's column blocks, one group over the V slab
      const int vs = rg.take();
      hopper::wg_fence();
      if (PAIR_PRODUCTS) pair_pv<E, CN>(o_acc, p_frag, ring + vs * S::SLAB);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::mbar_arrive(rg.empty(vs));
#pragma unroll
      for (int b = 0; b < 4; ++b) hopper::wg_fence_regs(o_acc[b]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int i = row0 + 8 * h;
      if (i >= T) continue;
      const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
      E* op = o + ((size_t)bh * T + i) * ld;
#pragma unroll
      for (int b = 0; b < CN; ++b) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * (c0 + b) + 8 * j + 2 * t;
          if (c < ld)
            store2(op + c, o_acc[b][4 * j + 2 * h] * inv,
                   o_acc[b][4 * j + 2 * h + 1] * inv);
        }
      }
      if (wg == 0 && lse != nullptr && t == 0)
        lse[(size_t)bh * T + i] = l[h] > 0.f ? m[h] * LN2 + logf(l[h]) : 0.f;
    }
  };
  switch (cn) {
    case 2: run(std::integral_constant<int, 2>()); break;
    case 3: run(std::integral_constant<int, 3>()); break;
    default: run(std::integral_constant<int, 4>()); break;
  }
}

// The sliced f32 forward: the f32 forward above with the head dim
// streamed F32_CHUNK columns at a time through [rows][F32_CHUNK + 1] tiles
// for the contraction, and each block one SW-column slice of the output,
// whose rows of V it loads into [rows][SW + 1] tiles for the second
// product: the same grid and sums as the tensor-core sliced kernels, f32
// products and sums on the CUDA cores, the thread plan of the f32 forward
// at DMAX SW (two threads a row).  (dq and dk/dv in f32 run on
// dq_tf32_kernel and dkv_tf32_kernel.)
constexpr int F32_CHUNK = 64;

// Rows [row0, row0 + n) x columns [c0, c0 + W) of a [T, ld] f32 slab into
// an [n][W + 1] tile, zeros past T and past ld, by a block of THREADS.
template <int W, int THREADS>
__device__ __forceinline__ void f32_load_cols(float* tile,
                                              const float* __restrict__ src,
                                              int row0, int n, int c0, int T,
                                              int ld) {
  for (int x = threadIdx.x; x < n * W; x += THREADS) {
    const int r = x / W, c = x % W, i = row0 + r, col = c0 + c;
    tile[r * (W + 1) + c] =
        i < T && col < ld ? src[(size_t)i * ld + col] : 0.f;
  }
}

template <int SW>
__global__ void __launch_bounds__(F32_THREADS)
    fwd_sliced_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int group, int ld,
                          float scale, Mask mk) {
  constexpr int CD = F32_CHUNK + 1, SD = SW + 1, J = F32_STEP / 2;
  constexpr int C = SW / 2;
  extern __shared__ float f32_smem[];
  float* sQ = f32_smem;               // [F32_ROWS][CD]
  float* sK = sQ + F32_ROWS * CD;     // [F32_STEP][CD]
  float* sV = sK + F32_STEP * CD;     // [F32_STEP][SD]
  const int T = mk.T;
  const SliceTile st = slice_tile(F32_ROWS, T, ceil_div(ld, SW));
  const int bh = st.bh, bkv = bh / group;
  const int q0 = st.tile * F32_ROWS, c0 = st.slice * SW;
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1, i = q0 + r;
  const float* qh = q + (size_t)bh * T * ld;
  const float* kh = k + (size_t)bkv * T * ld;
  const float* vh = v + (size_t)bkv * T * ld;
  int lo, n_sink, n_iter;
  key_tiles<F32_STEP>(q0, F32_ROWS, mk, &lo, &n_sink, &n_iter);

  float m = -INFINITY, l = 0.f, acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (it < n_sink ? it : lo + it - n_sink) * F32_STEP;
    float s[J];
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] = 0.f;
    for (int d0 = 0; d0 < ld; d0 += F32_CHUNK) {
      __syncthreads();
      f32_load_cols<F32_CHUNK, F32_THREADS>(sQ, qh, q0, F32_ROWS, d0, T, ld);
      f32_load_cols<F32_CHUNK, F32_THREADS>(sK, kh, k0, F32_STEP, d0, T, ld);
      __syncthreads();
      const int n = min(F32_CHUNK, ld - d0);
      for (int d = 0; d < n; ++d) {
        const float qd = sQ[r * CD + d];
#pragma unroll
        for (int j = 0; j < J; ++j)
          s[j] = fmaf(qd, sK[(2 * j + h) * CD + d], s[j]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[j] = mk.live(i, k0 + 2 * j + h) ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[j] = expf(s[j] - m_use);
      sum += s[j];
    }
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
    __syncthreads();
    f32_load_cols<SW, F32_THREADS>(sV, vh, k0, F32_STEP, c0, T, ld);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float pm = s[j], po = __shfl_xor_sync(0xffffffffu, s[j], 1);
      const float* vm = sV + (2 * j + h) * SD + h * C;
      const float* vo = sV + (2 * j + 1 - h) * SD + h * C;
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c] = fmaf(pm, vm[c], fmaf(po, vo[c], acc[c]));
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  if (i >= T) return;
  const float inv = l > 0.f ? 1.f / l : 1.f;
  float* op = o + ((size_t)bh * T + i) * ld + c0 + h * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c0 + h * C + c < ld) op[c] = acc[c] * inv;
  if (st.slice == 0 && lse != nullptr && h == 0)
    lse[(size_t)bh * T + i] = l > 0.f ? m + logf(l) : 0.f;
}

// ---------------------------------------------------------------------------
// f32 dq and dk/dv on the tensor cores: dq_tf32_kernel and dkv_tf32_kernel.
// They replace tf_operator_tpu/ops/attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel in f32 at every head dim: dq = scale * sum ds K, dv = sum
// p^T dO and dk = scale * sum ds^T Q over the GQA group, p = exp(scale * s
// - lse) (expf), ds = p (dp - delta), every mask, any scale.
//
// Every product is mma.sync m16n8k8 in three TF32 passes (tf32.cuh): f32
// tiles in shared memory, each fragment split in registers into its TF32
// halves, lo * hi and hi * lo added before hi * hi, f32 accumulators; each
// short chain of products (a 32-column block of a contraction, a step of a
// second product) summed apart and added to the long sum in f32
// (tf32::promote: one long chain into an accumulator left the rule), a
// contraction's blocks and the cluster's partials by the compensated sum
// (tf32::kahan: at large logits, scale -1 at head dim 512, dk left the
// rule by its f32 sum of 16 blocks); the f32 rule (chip_smoke.RTOL_F32,
// FRO_F32) holds against the plain version in f64 at the usual scales
// everywhere, where one pass misses it by some 40x, and at scale -1 for
// dk up to head dim 512 (above it, dk reaches 1.1 to 2.1 of the limit,
// where plain f32 reaches 8 to 18: PERF.md) and for dq, whose heavy
// elements take dP - delta from a compensated dot product (TF32_REFINE),
// at every head dim measured (0.16 to 0.27 of the limit up to 1000, where
// plain f32 reaches 4 to 12).  Not wgmma: its TF32 form takes both
// operands K-major in shared memory, and dq = dS K, dV = P^T dO and dK =
// dS^T Q contract across K's, dO's and Q's stored rows, which would need
// transposed (and, for three passes, split) copies of them; mma.sync reads
// its fragments from one f32 copy in either orientation.
//
// Both kernels: a block of 8 warps in two warpgroups over the same 64 rows
// (keys for dk/dv, queries for dq) and SW columns of the head dim (SW 64,
// 128 or 256: the head-dim classes; above 256, one 256-column slice), warp
// w4 of each warpgroup holding rows 16 w4 .. 16 w4 + 15.  The block's
// operand of those rows stays in shared memory, and the other side's
// operand goes through a ring of STAGES stages by the step (thread 0, TMA,
// 32-column boxes, zero past T and past ld; a stage is refilled after the
// block's barrier at the end of the step that read it, so the next steps'
// loads run under this step's products).  A step:
//   * the contraction over the block's columns (16 rows x the step a warp,
//     m16n8 tiles; the 32-column blocks wholly past ld skipped; tf32_block);
//   * above 256, the slices of a row tile are one thread-block cluster:
//     each block's partials (its columns' contraction) go to shared memory,
//     the cluster meets at its barrier, and every block sums all the
//     partials in slice order (its own and, through distributed shared
//     memory, its partners'), so each forms the same sum once for all the
//     slices (two buffers, one barrier a step: a block writes a buffer
//     again two steps later, after every partner has passed the barrier
//     that follows its last read of it; tf32_exchange); above TF32_REACH
//     (nine slices and more, past a portable cluster's eight blocks) each
//     block of a slice contracts the whole head dim itself (STREAM: every
//     32-column chunk of both operands through two buffers by cp.async,
//     the next chunk's loads under this one's products), (n + 1) / 2 times
//     the contraction over n slices;
//   * P (P^T) forms in warpgroup 0's accumulators (the element mask only
//     on tiles that are not full) and goes to warpgroup 1 through shared
//     memory (each thread the elements it holds, so thread i of one reads
//     what thread i of the other wrote: 16-byte stores and loads, no
//     re-layout), which forms dS (dS^T);
//   * the second products over the block's columns: A is the accumulator
//     of the step's first product as it stands (the permuted k index,
//     tf32.cuh), B read down the other operand's columns (tf32_second).
// Bound: operations, 3 TF32 passes of 3 (dq) or 4 (dk/dv) products at 495
// TFLOP/s dense (the card's TF32 rate; 165 TFLOP/s of three-pass
// products).  dk/dv measured at 0.18-0.27 of it on an H100 (PERF.md): the
// products are about a fifth of the time; the fragments' loads and TF32
// splits (each B value split by the four warps of its warpgroup) the
// rest, which more warps (two pairs of warpgroups over column halves at
// 256) did not move.  dq at 0.14-0.24: one TF32 pass (two of three
// products and the lo splits dropped) takes 29-46 % off its time, at 512
// the cluster's barrier every 16-key step 17 %.
constexpr int TF32_REACH = 2048;  // the clusters' reach: 8 slices

// Diagnostics for kernel_variants.py only (the values below in every build
// the wrappers load): TF32_PASSES 1 takes one TF32 pass (the planted fault
// the f32 rule must catch); without TF32_SECOND no second product is
// issued; without TF32_EXCHANGE a block of a cluster takes its own partial
// for the whole sum (no SM-to-SM traffic).  The last two give wrong
// outputs.
constexpr int TF32_PASSES = 3;
constexpr bool TF32_SECOND = true;
constexpr bool TF32_EXCHANGE = true;

// dq's heavy elements: an element of dS = P (dP - delta) whose p is at
// least TF32_REFINE takes dP - delta from a compensated dot product of its
// rows of dO and V (tf32_dp_less) in place of the tensor cores' dP.  At
// nearly one-hot rows (large logits) dP - delta cancels to a small part of
// dP there, and dq's error is that of dP's sum over the head dim; where p
// is small, p scales it down.  On the CPU (tests/test_torch_f32_dq.py)
// the plan's dq against the plain version in f64 at scale -1 moves from
// 1.7x the f32 rule to 0.03x at head dims 256-2112 with the heavy elements
// exact, and at the usual scale dq's first query row (one live key) with
// it.  Each row has at most 1 / TF32_REFINE such keys; the rows of long
// sequences at the usual scale have none.  (kernel_variants.py's no_refine
// leaves the refinement out.)
constexpr float TF32_REFINE = 0.125f;

// (sum_c x[c] y[c]) - sub over n columns (n a multiple of 4, 16-byte
// aligned rows) by Ogita, Rump and Oishi's compensated dot product: each
// product's rounding error from an FMA, each sum's by TwoSum, their total
// added at the end, as if summed in twice f32's precision; sub is taken
// from the rounded sum before the errors are added, so that a cancellation
// against it keeps them.  The roundings are explicit (__fmul_rn,
// __fadd_rn) so that nothing is contracted into an FMA.
__device__ __forceinline__ float tf32_dp_less(const float* __restrict__ x,
                                              const float* __restrict__ y,
                                              int n, float sub) {
  float s = 0.f, c = 0.f;
#pragma unroll 1
  for (int i = 0; i < n; i += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(y + i));
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __fmul_rn(av[e], bv[e]);
      const float pe = fmaf(av[e], bv[e], -p);
      const float t = __fadd_rn(s, p);
      const float z = __fsub_rn(t, s);
      const float te =
          __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(p, z));
      c = __fadd_rn(c, __fadd_rn(te, pe));
      s = t;
    }
  }
  return __fadd_rn(__fsub_rn(s, sub), c);
}

// One 32-column block of a contraction added to st (the warp's 16 rows x
// NJ m16n8 tiles; sc its compensation): A's rows from ab (the block's row
// of the warp's lane g), B's from bb (row g of the step), ro the row
// offsets (tf32::row_off).  The block's products in sums of their own (one
// a pass with CHAINS), added to st by the compensated sum (COMPENSATED) or
// in f32 (tf32::promote).
template <int NJ, bool CHAINS, bool COMPENSATED>
__device__ __forceinline__ void tf32_block(float (&st)[NJ][4],
                                           float (&sc)[NJ][4],
                                           const float* ab, const float* bb,
                                           const int (&ro)[8]) {
  float part[NJ][4] = {}, part_lh[NJ][4] = {}, part_hl[NJ][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int o0 = ro[2 * kk], o1 = ro[2 * kk + 1];
    const float a[4] = {ab[o0], ab[8 * 32 + o0], ab[o1], ab[8 * 32 + o1]};
    const tf32::Split<4> as = tf32::split(a);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float bv[2] = {bb[j * 8 * 32 + o0], bb[j * 8 * 32 + o1]};
      if constexpr (CHAINS)
        tf32::mma3<TF32_PASSES>(part_lh[j], part_hl[j], part[j], as,
                                tf32::split(bv));
      else
        tf32::mma3<TF32_PASSES>(part[j], as, tf32::split(bv));
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if constexpr (CHAINS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] += part_lh[j][i] + part_hl[j][i];
    }
    if constexpr (COMPENSATED)
      tf32::kahan(st[j], sc[j], part[j]);
    else
      tf32::promote(st[j], part[j]);
  }
}

// st less its compensation: the compensated sum's total.
template <int NJ>
__device__ __forceinline__ void tf32_fold(float (&st)[NJ][4],
                                          const float (&sc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) st[j][i] -= sc[j][i];
}

// A cluster's sum of st: this block's partial out to its slot `mine` (16
// bytes a lane, a warp's NJ tiles 32 slots apart), the cluster's barrier,
// then the ns slices' partials summed in slice order by the compensated
// sum, so that every block forms the same bits.
template <int NJ>
__device__ __forceinline__ void tf32_exchange(float (&st)[NJ][4],
                                              float4* mine, int ns) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    mine[j * 32] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
  hopper::cluster_sync();
  const uint32_t at = hopper::smem_addr(mine);
  float sc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) st[j][i] = sc[j][i] = 0.f;
  for (int r = 0; r < ns; ++r) {
    const uint32_t src = hopper::mapa(at, r);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 v = tf32::ld_cluster4(src + j * 32 * 16);
      const float x[4] = {v.x, v.y, v.z, v.w};
      tf32::kahan(st[j], sc[j], x);
    }
  }
  tf32_fold(st, sc);
}

// The step's accumulator st (16 rows x NJ m16n8 tiles) as the split A
// operands of a second product: k step j is the accumulator's columns 8j
// .. 8j + 7, k = t and t + 4 being columns 8j + 2t and 8j + 2t + 1 (the
// columns this thread holds: tf32.cuh's permuted k index).
template <int NJ>
__device__ __forceinline__ void tf32_as_a(tf32::Split<4> (&as)[NJ],
                                          const float (&st)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float a[4] = {st[j][0], st[j][2], st[j][1], st[j][3]};
    as[j] = tf32::split(a);
  }
}

// acc (one m16n8 tile of the warp's 16 rows) += A B over a step's NJ k
// steps: A from tf32_as_a, B read down the columns of cb (the step's first
// row in a 32-column block; co the tile's column offsets, tf32::col_off),
// the step's products in sums of their own (one a pass with CHAINS) added
// to acc in f32 (tf32::promote).
template <int NJ, bool CHAINS>
__device__ __forceinline__ void tf32_second(float (&acc)[4],
                                            const tf32::Split<4> (&as)[NJ],
                                            const float* cb,
                                            const int (&co)[2]) {
  float part[4] = {}, part_lh[4] = {}, part_hl[4] = {};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float bv[2] = {cb[j * 8 * 32 + co[0]], cb[j * 8 * 32 + co[1]]};
    if constexpr (CHAINS)
      tf32::mma3<TF32_PASSES>(part_lh, part_hl, part, as[j], tf32::split(bv));
    else
      tf32::mma3<TF32_PASSES>(part, as[j], tf32::split(bv));
  }
  if constexpr (CHAINS)
    tf32::promote(acc, part_lh, part_hl, part);
  else
    tf32::promote(acc, part);
}

// (every thread of 256) chunk b (columns 32 b ..) of two operands into the
// chunk buffer at dst, as TMA's 128-byte swizzle lays a 32-column box out,
// zeros past T and past ld: n0 rows of each of x0 and x1 from row i0, then
// n1 rows of each of y0 and y1 from row j0 ([T, ld] slabs).
__device__ __forceinline__ void tf32_chunk(uint32_t dst, int b,
                                           const float* x0, const float* x1,
                                           int n0, int i0, const float* y0,
                                           const float* y1, int n1, int j0,
                                           int T, int ld) {
  for (int i = threadIdx.x; i < (2 * n0 + 2 * n1) * 8; i += 256) {
    const int row = i >> 3, c4 = i & 7, c = 32 * b + 4 * c4;
    const bool x_row = row < 2 * n0;
    const int r = x_row ? row % n0 : (row - 2 * n0) % n1;
    const int at = (x_row ? i0 : j0) + r;
    const float* src = x_row ? (row < n0 ? x0 : x1)
                             : (row < 2 * n0 + n1 ? y0 : y1);
    const bool valid = at < T && c < ld;
    tf32::cp_async16(dst + row * 128 + ((c4 ^ (row & 7)) << 4),
                     valid ? src + (size_t)at * ld + c : x0, valid);
  }
  tf32::cp_async_commit();
}

// dk/dv: a block is 64 keys of one b*kv_head.  Warpgroup 0 forms S^T = K
// Q^T, P^T, and holds dV; warpgroup 1 forms dP^T = V dO^T and dS^T, and
// holds dK (dk/dv_split's plan: each product once, two of the four a
// warpgroup).  K and V (the block's columns) stay in shared memory; Q and
// dO come a query step of BQ queries a stage.  dV += P^T dO and dK += dS^T
// Q over all the block's columns.  The blocks walk dkv_split_kernel's
// grid: (key tile, b*kv_head, split of the query-head group, slice),
// slices fastest, key tiles slowest, so the longest causal walks start
// first.  At SW 256 the host may split each group's query heads
// (ops/attention.py:dkv_splits), and then the blocks write f32 partials
// that dkv_reduce_kernel sums in slice order.  Outputs are f32, dk times
// scale.  Registers: a warp's [16 x SW] accumulator is SW / 2 a thread (128
// at SW 256, beside the step's 16 x BQ score tile); at SW 64 two blocks
// share an SM.  Shared memory: K, V (64 x SW f32 each), P^T, the ring, and
// above 256 the two partial buffers or (STREAM, in place of K and V) the
// two chunk buffers (DkvTf32Smem).
template <int SW, bool CL, bool STREAM = false>
struct DkvTf32Smem {
  static constexpr int BM = 64, BQ = SW == 256 ? 16 : 32;
  static constexpr int BLOCKS = SW == 64 ? 2 : 1;
  // each pass in a sum of its own (tf32::mma3's three sums): at two blocks
  // an SM (128 registers a thread) they spilled, so one sum there
  static constexpr bool CHAINS = BLOCKS == 1;
  // a contraction's 32-column blocks added by the compensated sum
  // (tf32::kahan): at 64 columns (two blocks at most, little to
  // compensate) its registers spilled
  static constexpr bool COMPENSATED = SW > 64;
  // K or V (STREAM: none resident)
  static constexpr int KV_BYTES = STREAM ? 0 : BM * SW * 4;
  static constexpr int QT_BYTES = BQ * SW * 4;   // Q or dO of a step
  static constexpr int STAGE_BYTES = 2 * QT_BYTES;
  static constexpr int P_OFF = 2 * KV_BYTES;     // P^T: [4][BQ / 8][32] x 16 B
  static constexpr int P_BYTES = BM * BQ * 4;
  static constexpr int X_OFF = P_OFF + P_BYTES;  // partials: [2][8][BQ / 8][32] x 16 B
  static constexpr int X_BYTES = CL ? 2 * 2 * BM * BQ * 4 : 0;
  // STREAM: two buffers of one 32-column chunk of K, V, Q and dO (rows in
  // that order, 128 bytes each, swizzled as TMA would)
  static constexpr int CHUNK_BYTES = (2 * BM + 2 * BQ) * 128;
  static constexpr int C_OFF = X_OFF + X_BYTES;
  static constexpr int C_BYTES = STREAM ? 2 * CHUNK_BYTES : 0;
  static constexpr int RING_OFF = C_OFF + C_BYTES;
  static constexpr int STAGES =
      cmin(3, (smem_budget(BLOCKS) - RING_OFF - 1024 - 64) / STAGE_BYTES);
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // full[STAGES], kv
  static constexpr int BYTES = BAR_OFF + 8 * (STAGES + 1) + 1024;
  static_assert(STAGES >= 2 && BYTES <= smem_budget(BLOCKS),
                "f32 dk/dv does not fit in shared memory");
  static_assert(KV_BYTES % 1024 == 0 && (BQ * 128) % 1024 == 0 &&
                    P_BYTES % 1024 == 0 && CHUNK_BYTES % 1024 == 0,
                "the swizzled tiles start on 1024 bytes");
};

template <int SW, bool CL, bool STREAM>
__global__ void __launch_bounds__(256, DkvTf32Smem<SW, CL, STREAM>::BLOCKS)
    dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ partial,
                    int heads, int kv_heads, int splits, int ld, float scale,
                    Mask mk) {
  using S = DkvTf32Smem<SW, CL, STREAM>;
  constexpr int BM = S::BM, BQ = S::BQ, STAGES = S::STAGES;
  constexpr int NJ = BQ / 8, NT = SW / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t bars = base + S::BAR_OFF;  // full[STAGES], kv
  const uint32_t kv_bar = bars + 8 * STAGES;

  // the block: (key tile, b*kv_head, split, slice), slices fastest
  const int T = mk.T;
  const int ns = CL       ? (int)tf32::cluster_size()
                 : STREAM ? (ld + SW - 1) / SW
                          : 1;
  const int n_kt = (T + BM - 1) / BM;
  const int x = (int)blockIdx.x;
  const int slice = x % ns, sp = x / ns % splits, rest = x / ns / splits;
  const int bkv_n = (int)gridDim.x / (n_kt * splits * ns);
  const int bkv = rest % bkv_n, k0 = rest / bkv_n * BM;
  const int group = heads / kv_heads;
  const int h0 = sp * group / splits, h1 = (sp + 1) * group / splits;
  const int qbase = (bkv / kv_heads) * heads + (bkv % kv_heads) * group + h0;
  int qlo, qhi;
  query_tiles<BQ>(k0, BM, mk, &qlo, &qhi);
  const int nq = qhi - qlo, n_iter = (h1 - h0) * nq;
  const int c0 = slice * SW;  // the block's first column
  // its 32-column blocks that hold a column < ld
  const int nblk = cmin(SW / 32, (ld - c0 + 31) / 32);

  // (thread 0) step it's Q and dO into stage it % STAGES
  const CUtensorMap* mq = &map_q;
  const CUtensorMap* mdo = &map_do;
  auto load_step = [=](int it) {
    const int s = it % STAGES;
    const int bh = qbase + it / nq, q0 = (qlo + it % nq) * BQ;
    const uint32_t st = base + S::RING_OFF + s * S::STAGE_BYTES;
    const uint32_t bar = bars + 8 * s;
    hopper::mbar_arrive_tx(bar, 2 * nblk * BQ * 128);
    for (int b = 0; b < nblk; ++b) {
      hopper::tma_load(st + b * BQ * 128, mq, c0 + 32 * b, q0, bh, bar);
      hopper::tma_load(st + S::QT_BYTES + b * BQ * 128, mdo, c0 + 32 * b,
                       q0, bh, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(bars + 8 * s, 1);
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
    // (STREAM: K and V come by the chunk, below; the phase completes empty)
    hopper::mbar_arrive_tx(kv_bar, STREAM ? 0 : 2 * nblk * BM * 128);
    for (int b = 0; b < (STREAM ? 0 : nblk); ++b) {
      hopper::tma_load(base + b * BM * 128, &map_k, c0 + 32 * b, k0, bkv,
                       kv_bar);
      hopper::tma_load(base + S::KV_BYTES + b * BM * 128, &map_v,
                       c0 + 32 * b, k0, bkv, kv_bar);
    }
    for (int it = 0; it < cmin(STAGES, n_iter); ++it) load_step(it);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, w4 = warp & 3;
  const int key[2] = {k0 + 16 * w4 + g, k0 + 16 * w4 + g + 8};
  // this warpgroup's contraction operand (K or V) from its warp's first row
  const float* a_rows = reinterpret_cast<const float*>(smem) +
                        wg * (BM * SW) + (16 * w4 + g) * 32;
  const float* row_src = wg == 0 ? lse : delta;
  int ro[8], co[4][2];
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) ro[ch] = tf32::row_off(ch, g, t);
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4) {
    co[c4][0] = tf32::col_off(c4, 0, g, t);
    co[c4][1] = tf32::col_off(c4, 1, g, t);
  }
  // this thread's P^T slot and partial slot (16 bytes a lane)
  float4* p_slot = reinterpret_cast<float4*>(smem + S::P_OFF) +
                   w4 * NJ * 32 + lane;
  float4* x_slot = reinterpret_cast<float4*>(smem + S::X_OFF) +
                   warp * NJ * 32 + lane;

  float acc[NT][4];  // dV (warpgroup 0) or dK (1): keys x the SW columns
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  hopper::mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int bh = qbase + it / nq, q0 = (qlo + it % nq) * BQ;
    // the row scalars (lse or delta) of this thread's queries q0 + 8j + 2t
    // + e, loaded under the contraction
    float rv[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = q0 + 8 * j + 2 * t + e;
        rv[j][e] = i < T ? row_src[(size_t)bh * T + i] : 0.f;
      }
    hopper::mbar_wait(bars + 8 * s, (it / STAGES) & 1);
    const float* stage = reinterpret_cast<const float*>(
        smem + S::RING_OFF + s * S::STAGE_BYTES);
    // the contraction's B (Q or dO) from row g, the second product's (dO
    // or Q)
    const float* b_rows = stage + wg * (BQ * SW) + g * 32;
    const float* c_tile = stage + (1 - wg) * (BQ * SW);

    // S^T (warpgroup 0) or dP^T (1): 16 keys x BQ queries over the columns
    float st[NJ][4], sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = sc[j][i] = 0.f;
    if constexpr (STREAM) {
      // every column of the head dim, a chunk at a time through the two
      // buffers (K, V, Q, dO), the next chunk's loads in flight under this
      // one's products
      const int n_all = (ld + 31) / 32;
      const float* kh = k + (size_t)bkv * T * ld;
      const float* vh = v + (size_t)bkv * T * ld;
      const float* qh = q + (size_t)bh * T * ld;
      const float* gh = dout + (size_t)bh * T * ld;
      auto load_chunk = [&](int b) {
        tf32_chunk(base + S::C_OFF + (b & 1) * S::CHUNK_BYTES, b, kh, vh, BM,
                   k0, qh, gh, BQ, q0, T, ld);
      };
      load_chunk(0);
#pragma unroll 1
      for (int b = 0; b < n_all; ++b) {
        if (b + 1 < n_all) {
          load_chunk(b + 1);
          tf32::cp_async_wait<1>();
        } else {
          tf32::cp_async_wait<0>();
        }
        __syncthreads();
        const float* chunk = reinterpret_cast<const float*>(
            smem + S::C_OFF + (b & 1) * S::CHUNK_BYTES);
        tf32_block<NJ, S::CHAINS, S::COMPENSATED>(
            st, sc, chunk + wg * (BM * 32) + (16 * w4 + g) * 32,
            chunk + 2 * BM * 32 + wg * (BQ * 32) + g * 32, ro);
        // every warp is done with this buffer before the chunk after next
        // is loaded into it
        __syncthreads();
      }
    } else {
#pragma unroll 1
      for (int b = 0; b < nblk; ++b)
        tf32_block<NJ, S::CHAINS, S::COMPENSATED>(
            st, sc, a_rows + b * (BM * 32), b_rows + b * (BQ * 32), ro);
    }
    if constexpr (S::COMPENSATED) tf32_fold(st, sc);
    if (CL && TF32_EXCHANGE)
      tf32_exchange(st, x_slot + (it & 1) * (8 * NJ * 32), ns);

    if (wg == 0) {
      // P^T, handed to warpgroup 1
      const bool full = tile_full(mk, q0, BQ, k0, BM);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1, q = q0 + 8 * j + 2 * t + e;
          const float p = expf(st[j][i] * scale - rv[j][e]);
          st[j][i] = full || mk.live(q, key[i >> 1]) ? p : 0.f;
        }
        p_slot[j * 32] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
      }
      hopper::named_arrive(1, 256);
    } else {
      // dS^T = P^T (dP^T - delta)
      hopper::named_sync(1, 256);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 p = p_slot[j * 32];
        st[j][0] = p.x * (st[j][0] - rv[j][0]);
        st[j][1] = p.y * (st[j][1] - rv[j][1]);
        st[j][2] = p.z * (st[j][2] - rv[j][0]);
        st[j][3] = p.w * (st[j][3] - rv[j][1]);
      }
    }

    // dV += P^T dO or dK += dS^T Q: k step j is queries 8j .. 8j + 7
    if (TF32_SECOND) {
      tf32::Split<4> as[NJ];
      tf32_as_a(as, st);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt / 4 >= nblk) continue;  // columns wholly past ld
        tf32_second<NJ, S::CHAINS>(acc[nt], as,
                                   c_tile + (nt / 4) * (BQ * 32), co[nt % 4]);
      }
    }
    // every warp is done with stage s (and warpgroup 1 with P^T): refill
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES < n_iter) load_step(it + STAGES);
  }
  // no block exits while a partner may still read its partials
  if (CL) hopper::cluster_sync();

  // dV (warpgroup 0) and dK (1): f32, or f32 partials of this split
  const int which = wg == 0 ? 1 : 0;  // the workspace's order: dK, dV
  float* out = splits > 1
                   ? partial + (((size_t)which * splits + sp) * bkv_n + bkv) *
                                   T * ld
                   : (wg == 0 ? dv : dk) + (size_t)bkv * T * ld;
  const float mul = wg == 1 && splits == 1 ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= T) continue;
    float* row = out + (size_t)key[h] * ld + c0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * nt + 2 * t;
      if (c0 + c < ld)
        *reinterpret_cast<float2*>(row + c) =
            make_float2(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  }
}

// dq: a block is 64 query rows of one b*h (its KV head bh / group).
// Warpgroup 0 forms S = Q K^T and P; warpgroup 1 forms dP = dO V^T and dS,
// which it hands back to warpgroup 0 through the same slot; each then
// holds half of the block's columns of dq += dS K (dq_cluster_kernel's
// split: each product once, the second one's columns halved, so that the
// two warpgroups take equal shares).  Q and dO (the block's columns) stay
// in shared memory with lse and delta of the thread's rows in registers;
// K and V come a key step of BK keys a stage, in key_tiles' order (sinks,
// then the band).  The grid walks (b*h, row tile, slice), slices fastest,
// each b*h's row tiles from the last (the longest under causal masking)
// down (slice_tile).  Where p >= TF32_REFINE, warpgroup 1 takes dP -
// delta from a compensated dot product of the element's rows of dO and V
// (above).  dq is f32, times scale.  Registers: a warp's [16 x
// SW / 2] accumulator is SW / 4 a thread (64 at SW 256); at SW 64 two
// blocks share an SM.  Shared memory: Q, dO (64 x SW f32 each), P then
// dS, the ring of K and V, and above 256 the two partial buffers or
// (STREAM, in place of Q and dO) the two chunk buffers, its ring then
// holding K alone for the second product (DqTf32Smem).
template <int SW, bool CL, bool STREAM = false>
struct DqTf32Smem {
  // dk/dv's plan (DkvTf32Smem) with rows for keys: a key step of 16 at 256
  // columns, where Q, dO and two stages of K and V fill the SM's shared
  // memory; two blocks an SM at 64, one sum a pass above, the compensated
  // sum above 64 columns
  static constexpr int BM = 64, BK = SW == 256 ? 16 : 32;
  static constexpr int BLOCKS = SW == 64 ? 2 : 1;
  static constexpr bool CHAINS = BLOCKS == 1;
  static constexpr bool COMPENSATED = SW > 64;
  // Q or dO (STREAM: none resident)
  static constexpr int QD_BYTES = STREAM ? 0 : BM * SW * 4;
  static constexpr int KT_BYTES = BK * SW * 4;  // K or V of a step
  static constexpr int STAGE_BYTES = (STREAM ? 1 : 2) * KT_BYTES;
  // P, then dS: [4][BK / 8][32] x 16 B
  static constexpr int P_OFF = 2 * QD_BYTES;
  static constexpr int P_BYTES = BM * BK * 4;
  // partials: [2][8][BK / 8][32] x 16 B
  static constexpr int X_OFF = P_OFF + P_BYTES;
  static constexpr int X_BYTES = CL ? 2 * 2 * BM * BK * 4 : 0;
  // STREAM: two buffers of one 32-column chunk of Q, dO, K and V (rows in
  // that order, 128 bytes each, swizzled as TMA would)
  static constexpr int CHUNK_BYTES = (2 * BM + 2 * BK) * 128;
  static constexpr int C_OFF = X_OFF + X_BYTES;
  static constexpr int C_BYTES = STREAM ? 2 * CHUNK_BYTES : 0;
  static constexpr int RING_OFF = C_OFF + C_BYTES;
  static constexpr int STAGES =
      cmin(3, (smem_budget(BLOCKS) - RING_OFF - 1024 - 64) / STAGE_BYTES);
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // full[STAGES], qd
  static constexpr int BYTES = BAR_OFF + 8 * (STAGES + 1) + 1024;
  static_assert(STAGES >= 2 && BYTES <= smem_budget(BLOCKS),
                "f32 dq does not fit in shared memory");
  static_assert(QD_BYTES % 1024 == 0 && (BK * 128) % 1024 == 0 &&
                    P_BYTES % 1024 == 0 && CHUNK_BYTES % 1024 == 0,
                "the swizzled tiles start on 1024 bytes");
};

template <int SW, bool CL, bool STREAM>
__global__ void __launch_bounds__(256, DqTf32Smem<SW, CL, STREAM>::BLOCKS)
    dq_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int group, int ld, float scale, Mask mk) {
  using S = DqTf32Smem<SW, CL, STREAM>;
  constexpr int BM = S::BM, BK = S::BK, STAGES = S::STAGES;
  // NT: the m16n8 tiles of this warpgroup's half of the columns
  constexpr int NJ = BK / 8, NT = SW / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t bars = base + S::BAR_OFF;  // full[STAGES], qd
  const uint32_t qd_bar = bars + 8 * STAGES;

  // the block: (b*h, row tile, slice), slices fastest
  const int T = mk.T;
  const int ns = CL       ? (int)tf32::cluster_size()
                 : STREAM ? (ld + SW - 1) / SW
                          : 1;
  const SliceTile tile = slice_tile(BM, T, ns);
  const int bh = tile.bh, bkv = bh / group, q0 = tile.tile * BM;
  const int c0 = tile.slice * SW;  // the block's first column
  // its 32-column blocks that hold a column < ld
  const int nblk = cmin(SW / 32, (ld - c0 + 31) / 32);
  int lo, n_sink, n_iter;
  key_tiles<BK>(q0, BM, mk, &lo, &n_sink, &n_iter);
  auto key0 = [=](int it) {
    return (it < n_sink ? it : lo + it - n_sink) * BK;
  };

  // (thread 0) step it's K and V (STREAM: K) into stage it % STAGES
  const CUtensorMap* mkt = &map_k;
  const CUtensorMap* mvt = &map_v;
  auto load_step = [=](int it) {
    const int s = it % STAGES, k0 = key0(it);
    const uint32_t st = base + S::RING_OFF + s * S::STAGE_BYTES;
    const uint32_t bar = bars + 8 * s;
    hopper::mbar_arrive_tx(bar, (STREAM ? 1 : 2) * nblk * BK * 128);
    for (int b = 0; b < nblk; ++b) {
      hopper::tma_load(st + b * BK * 128, mkt, c0 + 32 * b, k0, bkv, bar);
      if (!STREAM)
        hopper::tma_load(st + S::KT_BYTES + b * BK * 128, mvt, c0 + 32 * b,
                         k0, bkv, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(bars + 8 * s, 1);
    hopper::mbar_init(qd_bar, 1);
    hopper::mbar_init_fence();
    // (STREAM: Q and dO come by the chunk, below; the phase completes
    // empty)
    hopper::mbar_arrive_tx(qd_bar, STREAM ? 0 : 2 * nblk * BM * 128);
    for (int b = 0; b < (STREAM ? 0 : nblk); ++b) {
      hopper::tma_load(base + b * BM * 128, &map_q, c0 + 32 * b, q0, bh,
                       qd_bar);
      hopper::tma_load(base + S::QD_BYTES + b * BM * 128, &map_do,
                       c0 + 32 * b, q0, bh, qd_bar);
    }
    for (int it = 0; it < cmin(STAGES, n_iter); ++it) load_step(it);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, w4 = warp & 3;
  const int row0 = q0 + 16 * w4 + g;  // this thread's rows: row0, row0 + 8
  // this warpgroup's contraction operand (Q or dO) from its warp's first
  // row, and the row scalar (lse or delta) of the thread's two rows
  const float* a_rows = reinterpret_cast<const float*>(smem) +
                        wg * (BM * SW) + (16 * w4 + g) * 32;
  float rv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    rv[h] = i < T ? (wg == 0 ? lse : delta)[(size_t)bh * T + i] : 0.f;
  }
  int ro[8], co[4][2];
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) ro[ch] = tf32::row_off(ch, g, t);
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4) {
    co[c4][0] = tf32::col_off(c4, 0, g, t);
    co[c4][1] = tf32::col_off(c4, 1, g, t);
  }
  // this thread's P / dS slot and partial slot (16 bytes a lane)
  float4* p_slot = reinterpret_cast<float4*>(smem + S::P_OFF) +
                   w4 * NJ * 32 + lane;
  float4* x_slot = reinterpret_cast<float4*>(smem + S::X_OFF) +
                   warp * NJ * 32 + lane;

  // dq over this warpgroup's half of the columns (the 32-column blocks
  // from wg * SW / 64)
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  hopper::mbar_wait(qd_bar, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES, k0 = key0(it);
    hopper::mbar_wait(bars + 8 * s, (it / STAGES) & 1);
    const float* stage = reinterpret_cast<const float*>(
        smem + S::RING_OFF + s * S::STAGE_BYTES);

    // S (warpgroup 0) or dP (1): 16 rows x BK keys over the columns
    float st[NJ][4], sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = sc[j][i] = 0.f;
    if constexpr (STREAM) {
      // every column of the head dim, a chunk at a time through the two
      // buffers (Q, dO, K, V), the next chunk's loads in flight under this
      // one's products
      const int n_all = (ld + 31) / 32;
      const float* qh = q + (size_t)bh * T * ld;
      const float* gh = dout + (size_t)bh * T * ld;
      const float* kh = k + (size_t)bkv * T * ld;
      const float* vh = v + (size_t)bkv * T * ld;
      auto load_chunk = [&](int b) {
        tf32_chunk(base + S::C_OFF + (b & 1) * S::CHUNK_BYTES, b, qh, gh, BM,
                   q0, kh, vh, BK, k0, T, ld);
      };
      load_chunk(0);
#pragma unroll 1
      for (int b = 0; b < n_all; ++b) {
        if (b + 1 < n_all) {
          load_chunk(b + 1);
          tf32::cp_async_wait<1>();
        } else {
          tf32::cp_async_wait<0>();
        }
        __syncthreads();
        const float* chunk = reinterpret_cast<const float*>(
            smem + S::C_OFF + (b & 1) * S::CHUNK_BYTES);
        tf32_block<NJ, S::CHAINS, S::COMPENSATED>(
            st, sc, chunk + wg * (BM * 32) + (16 * w4 + g) * 32,
            chunk + 2 * BM * 32 + wg * (BK * 32) + g * 32, ro);
        // every warp is done with this buffer before the chunk after next
        // is loaded into it
        __syncthreads();
      }
    } else {
      // B: K or V of the step, from key g
      const float* b_rows = stage + wg * (BK * SW) + g * 32;
#pragma unroll 1
      for (int b = 0; b < nblk; ++b)
        tf32_block<NJ, S::CHAINS, S::COMPENSATED>(
            st, sc, a_rows + b * (BM * 32), b_rows + b * (BK * 32), ro);
    }
    if constexpr (S::COMPENSATED) tf32_fold(st, sc);
    if (CL && TF32_EXCHANGE)
      tf32_exchange(st, x_slot + (it & 1) * (8 * NJ * 32), ns);

    if (wg == 0) {
      // P, handed to warpgroup 1; dS back from it
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st[j][i] = expf(st[j][i] * scale - rv[i >> 1]);
      // the bounds of the live keys, on tiles that are not full
      if (!tile_full(mk, q0, BM, k0, BK))
        mask_tile(*reinterpret_cast<float(*)[NJ * 4]>(&st[0][0]), mk, row0,
                  k0, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        p_slot[j * 32] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
      hopper::named_arrive(1, 256);
      hopper::named_sync(2, 256);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 ds = p_slot[j * 32];
        st[j][0] = ds.x;
        st[j][1] = ds.y;
        st[j][2] = ds.z;
        st[j][3] = ds.w;
      }
    } else {
      // dS = P (dP - delta), handed to warpgroup 0; where p >=
      // TF32_REFINE, dP - delta again from dO and V (one copy of that
      // loop, over the heavy elements' bits: each of its results replaces
      // its element's p in the slot, read back below)
      hopper::named_sync(1, 256);
      uint32_t heavy = 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 p4 = p_slot[j * 32];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          st[j][i] = p[i] * (st[j][i] - rv[i >> 1]);
          heavy |= (uint32_t)(p[i] >= TF32_REFINE) << (4 * j + i);
        }
      }
      if (heavy) {
        for (uint32_t todo = heavy; todo; todo &= todo - 1) {
          const int x = __ffs(todo) - 1, j = x >> 2, h = x >> 1 & 1;
          float* slot = reinterpret_cast<float*>(p_slot + j * 32) + (x & 3);
          *slot *= tf32_dp_less(
              dout + ((size_t)bh * T + row0 + 8 * h) * ld,
              v + ((size_t)bkv * T + k0 + 8 * j + 2 * t + (x & 1)) * ld, ld,
              h ? rv[1] : rv[0]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 r4 = p_slot[j * 32];
          const float r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (heavy >> (4 * j + i) & 1) st[j][i] = r[i];
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        p_slot[j * 32] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
      hopper::named_arrive(2, 256);
    }

    // dq += dS K over this warpgroup's columns: k step j is keys 8j .. 8j
    // + 7, B read down K's columns
    if (TF32_SECOND) {
      tf32::Split<4> as[NJ];
      tf32_as_a(as, st);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int blk = (wg * NT + nt) / 4;
        if (blk >= nblk) continue;  // columns wholly past ld
        tf32_second<NJ, S::CHAINS>(acc[nt], as, stage + blk * (BK * 32),
                                   co[nt % 4]);
      }
    }
    // every warp is done with stage s (and with P / dS): refill
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES < n_iter) load_step(it + STAGES);
  }
  // no block exits while a partner may still read its partials
  if (CL) hopper::cluster_sync();

  float* out = dq + (size_t)bh * T * ld + c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    if (i >= T) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * (wg * NT + nt) + 2 * t;
      if (c0 + c < ld)
        *reinterpret_cast<float2*>(out + (size_t)i * ld + c) =
            make_float2(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
    }
  }
}

// Launcher of dkv_tf32_kernel: CL the cluster of ld's slices (an ld in
// (256, TF32_REACH]), STREAM a block for each slice (an ld above
// TF32_REACH), else head-dim class SW.  Its one tile is (64, BQ); any other
// tile, an ld outside the route or not a multiple of 8, or splits that are
// not 1..group with a workspace exactly when more than one returns
// cudaErrorInvalidValue; a cluster launch the card refuses returns its
// error.
template <int SW, bool CL, bool STREAM = false>
int dkv_tf32(int bkv, const BwdArgs& a, int rows, int step,
             cudaStream_t stream) {
  using S = DkvTf32Smem<SW, CL, STREAM>;
  const int T = a.mk.T;
  const int ns = CL || STREAM ? n_slices(a.ld) : 1;
  const bool route = CL       ? a.ld > SLICE && a.ld <= TF32_REACH
                     : STREAM ? a.ld > TF32_REACH
                              : head_class(a.ld) == SW;
  if (rows != S::BM || step != S::BQ || a.ld % 8 || !route ||
      a.splits < 1 || a.splits > a.heads / a.kv_heads ||
      (a.splits > 1) != (a.partial != nullptr))
    return (int)cudaErrorInvalidValue;
  const int bh = bkv / a.kv_heads * a.heads;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = tf32::tile_map(&map_q, a.q, bh, T, a.ld, S::BQ)) ||
      (e = tf32::tile_map(&map_k, a.k, bkv, T, a.ld, S::BM)) ||
      (e = tf32::tile_map(&map_v, a.v, bkv, T, a.ld, S::BM)) ||
      (e = tf32::tile_map(&map_do, a.dout, bh, T, a.ld, S::BQ)))
    return TENSOR_MAP_ERROR + e;
  const long long grid =
      (long long)bkv * ceil_div(T, S::BM) * a.splits * ns;
  if (grid < 1 || grid > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = dkv_tf32_kernel<SW, CL, STREAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = S::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CL ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, map_q, map_k, map_v, map_do,
                           static_cast<const float*>(a.q),
                           static_cast<const float*>(a.k),
                           static_cast<const float*>(a.v),
                           static_cast<const float*>(a.dout), a.lse,
                           a.delta, static_cast<float*>(a.dk),
                           static_cast<float*>(a.dv), a.partial, a.heads,
                           a.kv_heads, a.splits, a.ld, a.scale, a.mk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launcher of dq_tf32_kernel: CL the cluster of ld's slices (an ld in
// (256, TF32_REACH]), STREAM a block for each slice (an ld above
// TF32_REACH), else head-dim class SW.  Its one tile is (64, BK); any other
// tile, or an ld outside the route or not a multiple of 8, returns
// cudaErrorInvalidValue; a cluster launch the card refuses returns its
// error.
template <int SW, bool CL, bool STREAM = false>
int launch_dq_tf32(int bh, const BwdArgs& a, int rows, int step,
                   cudaStream_t stream) {
  using S = DqTf32Smem<SW, CL, STREAM>;
  const int T = a.mk.T;
  const int group = a.heads / a.kv_heads;
  const int ns = CL || STREAM ? n_slices(a.ld) : 1;
  const bool route = CL       ? a.ld > SLICE && a.ld <= TF32_REACH
                     : STREAM ? a.ld > TF32_REACH
                              : head_class(a.ld) == SW;
  if (rows != S::BM || step != S::BK || a.ld % 8 || !route)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = tf32::tile_map(&map_q, a.q, bh, T, a.ld, S::BM)) ||
      (e = tf32::tile_map(&map_k, a.k, bh / group, T, a.ld, S::BK)) ||
      (e = tf32::tile_map(&map_v, a.v, bh / group, T, a.ld, S::BK)) ||
      (e = tf32::tile_map(&map_do, a.dout, bh, T, a.ld, S::BM)))
    return TENSOR_MAP_ERROR + e;
  const unsigned grid = slice_blocks(bh, T, S::BM, ns);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  auto kernel = dq_tf32_kernel<SW, CL, STREAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = S::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CL ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, map_q, map_k, map_v, map_do,
                           static_cast<const float*>(a.q),
                           static_cast<const float*>(a.k),
                           static_cast<const float*>(a.v),
                           static_cast<const float*>(a.dout), a.lse, a.delta,
                           static_cast<float*>(a.dq), group, a.ld, a.scale,
                           a.mk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launchers of the sliced kernels.  Their one tile each (rows per block,
// step): the forward and dq (128, 64), dk/dv (64, 64), the f32 forward
// (F32_ROWS, F32_STEP); any other, or ld <= 256 (and for the tensor-core
// kernels an ld that is not a multiple of 8), returns
// cudaErrorInvalidValue.

template <typename E, bool SCALED>
int fwd_sliced(int bh, const FwdArgs& a, int rows, int step,
               cudaStream_t stream) {
  using S = FwdSlicedSmem;
  const int T = a.mk.T;
  if (rows != S::BM || step != S::BK || a.ld <= SLICE || a.ld % 8)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / a.group, T, a.ld, S::BK)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / a.group, T, a.ld, S::BK)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = fwd_sliced_kernel<E, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = slice_blocks(bh, T, S::BM, n_slices(a.ld));
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 384, S::BYTES, stream>>>(map_q, map_k, map_v,
                                          static_cast<E*>(a.o), a.lse,
                                          a.group, a.ld, a.scale, a.mk);
  return (int)cudaGetLastError();
}

template <typename E>
int dq_sliced(int bh, const BwdArgs& a, int rows, int step,
              cudaStream_t stream) {
  using S = DqSlicedSmem;
  const int T = a.mk.T;
  if (rows != S::BM || step != S::BK || a.ld <= SLICE || a.ld % 8)
    return (int)cudaErrorInvalidValue;
  const int group = a.heads / a.kv_heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / group, T, a.ld, S::BK)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / group, T, a.ld, S::BK)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, S::BM)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = dq_sliced_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = slice_blocks(bh, T, S::BM, n_slices(a.ld));
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 384, S::BYTES, stream>>>(
      map_q, map_k, map_v, map_do, a.lse, a.delta, static_cast<E*>(a.dq),
      group, a.ld, a.scale, a.mk);
  return (int)cudaGetLastError();
}

template <typename E>
int dkv_sliced(int bkv, const BwdArgs& a, int rows, int step,
               cudaStream_t stream) {
  using S = DkvSlicedSmem;
  const int T = a.mk.T;
  if (rows != S::BM || step != S::BQ || a.ld <= SLICE || a.ld % 8 ||
      a.splits != 1 || a.partial != nullptr)
    return (int)cudaErrorInvalidValue;
  const int bh = bkv / a.kv_heads * a.heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BQ)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bkv, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bkv, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, S::BQ)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = dkv_sliced_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = slice_blocks(bkv, T, S::BM, n_slices(a.ld));
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 384, S::BYTES, stream>>>(
      map_q, map_k, map_v, map_do, a.lse, a.delta, static_cast<E*>(a.dk),
      static_cast<E*>(a.dv), a.heads, a.kv_heads, a.ld, a.scale, a.mk);
  return (int)cudaGetLastError();
}

template <int SW>
int launch_fwd_sliced_f32(int bh, const FwdArgs& a, int rows, int step,
                          cudaStream_t st) {
  if (rows != F32_ROWS || step != F32_STEP || a.ld <= SW)
    return (int)cudaErrorInvalidValue;
  const int bytes =
      ((F32_ROWS + F32_STEP) * (F32_CHUNK + 1) + F32_STEP * (SW + 1)) * 4;
  auto kernel = fwd_sliced_f32_kernel<SW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = slice_blocks(bh, a.mk.T, F32_ROWS, ceil_div(a.ld, SW));
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, F32_THREADS, bytes, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.group, a.ld, a.scale, a.mk);
  return (int)cudaGetLastError();
}

// Launchers of the cluster kernels.  Their one tile each is (64, 64): dq's
// 64 rows over 64-key steps, dk/dv's 64 keys over 64-query steps.  Any
// other tile, or an ld outside (256, CLUSTER_REACH] or not a multiple of
// 8, returns cudaErrorInvalidValue; a cluster launch the card refuses (a
// cluster it cannot place, too much shared memory) returns its error.

template <typename... P, typename... A>
int cluster_launch(void (*kernel)(P...), unsigned grid, int ns, int bytes,
                   cudaStream_t stream, A&&... args) {
  if (grid == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<A&&>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of ns blocks of `threads` the card holds at once of a
// kernel taking `bytes` of shared memory (cudaOccupancyMaxActiveClusters).
template <typename... P>
int cluster_occupancy(void (*kernel)(P...), int ns, int bytes,
                      int* clusters, int threads = 384) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

inline bool cluster_tile(const BwdArgs& a, int rows, int step) {
  return rows == 64 && step == 64 && a.ld > SLICE &&
         a.ld <= CLUSTER_REACH && a.ld % 8 == 0;
}

template <typename E, int NS>
int dq_cluster_ns(int bh, const BwdArgs& a, cudaStream_t stream) {
  using S = DqClusterSmem<NS>;
  const int T = a.mk.T;
  const int group = a.heads / a.kv_heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / group, T, a.ld, S::BK)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / group, T, a.ld, S::BK)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, S::BM)))
    return TENSOR_MAP_ERROR + e;
  return cluster_launch(dq_cluster_kernel<E, NS>,
                        slice_blocks(bh, T, S::BM, NS), NS, S::BYTES, stream,
                        map_q, map_k, map_v, map_do, a.lse, a.delta,
                        static_cast<E*>(a.dq), group, a.ld, a.scale, a.mk);
}

template <typename E>
int dq_cluster(int bh, const BwdArgs& a, int rows, int step,
               cudaStream_t stream) {
  if (!cluster_tile(a, rows, step)) return (int)cudaErrorInvalidValue;
  switch (n_slices(a.ld)) {
    case 2: return dq_cluster_ns<E, 2>(bh, a, stream);
    case 3: return dq_cluster_ns<E, 3>(bh, a, stream);
    case 4: return dq_cluster_ns<E, 4>(bh, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename E, int NS>
int dkv_cluster_ns(int bkv, const BwdArgs& a, cudaStream_t stream) {
  using S = DkvClusterSmem<NS>;
  const int T = a.mk.T;
  const int bh = bkv / a.kv_heads * a.heads;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v, map_do;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BQ)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bkv, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bkv, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_do, ty, a.dout, bh, T, a.ld, S::BQ)))
    return TENSOR_MAP_ERROR + e;
  return cluster_launch(dkv_cluster_kernel<E, NS>,
                        slice_blocks(bkv, T, S::BM, NS), NS, S::BYTES, stream,
                        map_q, map_k, map_v, map_do, a.lse, a.delta,
                        static_cast<E*>(a.dk), static_cast<E*>(a.dv),
                        a.heads, a.kv_heads, a.ld, a.scale, a.mk);
}

template <typename E>
int dkv_cluster(int bkv, const BwdArgs& a, int rows, int step,
                cudaStream_t stream) {
  if (!cluster_tile(a, rows, step) || a.splits != 1 || a.partial != nullptr)
    return (int)cudaErrorInvalidValue;
  switch (n_slices(a.ld)) {
    case 2: return dkv_cluster_ns<E, 2>(bkv, a, stream);
    case 3: return dkv_cluster_ns<E, 3>(bkv, a, stream);
    case 4: return dkv_cluster_ns<E, 4>(bkv, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// A cluster kernel's shared memory and the clusters the card holds at
// once, at the slices of ld.
template <typename E, bool DQ>
int cluster_info(int ld, int* smem, int* clusters) {
  if (ld <= SLICE || ld > CLUSTER_REACH) return (int)cudaErrorInvalidValue;
  switch (n_slices(ld)) {
#define FA_CLUSTER_INFO(NS)                                                  \
  case NS:                                                                   \
    if constexpr (DQ) {                                                      \
      *smem = DqClusterSmem<NS>::BYTES;                                      \
      return cluster_occupancy(dq_cluster_kernel<E, NS>, NS, *smem,          \
                               clusters);                                    \
    } else {                                                                 \
      *smem = DkvClusterSmem<NS>::BYTES;                                     \
      return cluster_occupancy(dkv_cluster_kernel<E, NS>, NS, *smem,         \
                               clusters);                                    \
    }
    FA_CLUSTER_INFO(2)
    FA_CLUSTER_INFO(3)
    FA_CLUSTER_INFO(4)
#undef FA_CLUSTER_INFO
  }
  return (int)cudaErrorInvalidValue;
}

// f32 dq's or dk/dv's cluster (dq_tf32_kernel, dkv_tf32_kernel): its
// shared memory and the clusters the card holds at once, at the slices of
// ld.
template <bool DQ>
int tf32_cluster_info(int ld, int* smem, int* clusters) {
  if (ld <= SLICE || ld > TF32_REACH) return (int)cudaErrorInvalidValue;
  if constexpr (DQ) {
    *smem = DqTf32Smem<SLICE, true>::BYTES;
    return cluster_occupancy(dq_tf32_kernel<SLICE, true, false>,
                             n_slices(ld), *smem, clusters, 256);
  } else {
    *smem = DkvTf32Smem<SLICE, true>::BYTES;
    return cluster_occupancy(dkv_tf32_kernel<SLICE, true, false>,
                             n_slices(ld), *smem, clusters, 256);
  }
}

// Launcher of the pair forward.  Its one tile is (64, 64); any other, or
// an ld outside (256, PAIR_REACH] or not a multiple of 8, returns
// cudaErrorInvalidValue.
template <typename E, bool SCALED>
int fwd_pair(int bh, const FwdArgs& a, int rows, int step,
             cudaStream_t stream) {
  using S = FwdPairSmem;
  const int T = a.mk.T;
  if (rows != S::BM || step != S::BK || a.ld <= SLICE || a.ld > PAIR_REACH ||
      a.ld % 8)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType ty = Elt<E>::MAP;
  CUtensorMap map_q, map_k, map_v;
  int e;
  if ((e = hopper::tile_map(&map_q, ty, a.q, bh, T, a.ld, S::BM)) ||
      (e = hopper::tile_map(&map_k, ty, a.k, bh / a.group, T, a.ld, S::BK)) ||
      (e = hopper::tile_map(&map_v, ty, a.v, bh / a.group, T, a.ld, S::BK)))
    return TENSOR_MAP_ERROR + e;
  auto kernel = fwd_pair_kernel<E, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = slice_blocks(bh, T, S::BM, 1);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 384, S::BYTES, stream>>>(map_q, map_k, map_v,
                                          static_cast<E*>(a.o), a.lse,
                                          a.group, a.ld, a.scale, a.mk);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The parts.

#if FA_IN_PART(1)
int fa::forward_bf16(int bh, const FwdArgs& a, int rows, int step,
                     cudaStream_t st) {
  return forward_tiles<bf16, false, false>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(2)
int fa::forward_bf16_scaled(int bh, const FwdArgs& a, int rows, int step,
                            cudaStream_t st) {
  return forward_tiles<bf16, true, false>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(3)
int fa::forward_f16(int bh, const FwdArgs& a, int rows, int step,
                    cudaStream_t st) {
  return forward_tiles<f16, false, false>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(4)
int fa::forward_f16_scaled(int bh, const FwdArgs& a, int rows, int step,
                           cudaStream_t st) {
  return forward_tiles<f16, true, false>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(5)
int fa::dq_bf16(int bh, const BwdArgs& a, int rows, int step,
                cudaStream_t st) {
  return dq_tiles<bf16, false>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(6)
int fa::dq_f16(int bh, const BwdArgs& a, int rows, int step,
               cudaStream_t st) {
  return dq_tiles<f16, false>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(7)
int fa::dkv_bf16(int bkv, const BwdArgs& a, int rows, int step,
                 cudaStream_t st) {
  return dkv_tiles<bf16, false>(bkv, a, rows, step, st);
}
#endif

#if FA_IN_PART(8)
int fa::dkv_f16(int bkv, const BwdArgs& a, int rows, int step,
                cudaStream_t st) {
  return dkv_tiles<f16, false>(bkv, a, rows, step, st);
}
#endif

#if FA_IN_PART(9)
// the forward's one f32 tile (F32_ROWS, F32_STEP), at head-dim class 64 or
// 128
int fa::forward_f32(int bh, const FwdArgs& a, int rows, int step,
                    cudaStream_t st) {
  if (rows != F32_ROWS || step != F32_STEP) return (int)cudaErrorInvalidValue;
  switch (head_class(a.ld)) {
    case 64: return launch_fwd_f32<64>(bh, a, st);
    case 128: return launch_fwd_f32<128>(bh, a, st);
  }
  return (int)cudaErrorInvalidValue;
}
// dq: dq_tf32_kernel's tile at head-dim class 64 or 128
int fa::dq_tf32(int bh, const BwdArgs& a, int rows, int step,
                cudaStream_t st) {
  switch (head_class(a.ld)) {
    case 64: return launch_dq_tf32<64, false>(bh, a, rows, step, st);
    case 128: return launch_dq_tf32<128, false>(bh, a, rows, step, st);
  }
  return (int)cudaErrorInvalidValue;
}
// dk/dv: dkv_tf32_kernel's tile at head-dim class 64 or 128
int fa::dkv_f32(int bkv, const BwdArgs& a, int rows, int step,
                cudaStream_t st) {
  switch (head_class(a.ld)) {
    case 64: return dkv_tf32<64, false>(bkv, a, rows, step, st);
    case 128: return dkv_tf32<128, false>(bkv, a, rows, step, st);
  }
  return (int)cudaErrorInvalidValue;
}
#endif

#if FA_IN_PART(11)
int fa::forward_bf16_256(int bh, const FwdArgs& a, int rows, int step,
                         cudaStream_t st) {
  return forward_tiles<bf16, false, true>(bh, a, rows, step, st);
}
int fa::forward_bf16_scaled_256(int bh, const FwdArgs& a, int rows, int step,
                                cudaStream_t st) {
  return forward_tiles<bf16, true, true>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(12)
int fa::forward_f16_256(int bh, const FwdArgs& a, int rows, int step,
                        cudaStream_t st) {
  return forward_tiles<f16, false, true>(bh, a, rows, step, st);
}
int fa::forward_f16_scaled_256(int bh, const FwdArgs& a, int rows, int step,
                               cudaStream_t st) {
  return forward_tiles<f16, true, true>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(13)
int fa::dq_bf16_256(int bh, const BwdArgs& a, int rows, int step,
                    cudaStream_t st) {
  return dq_tiles<bf16, true>(bh, a, rows, step, st);
}
int fa::dq_f16_256(int bh, const BwdArgs& a, int rows, int step,
                   cudaStream_t st) {
  return dq_tiles<f16, true>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(14)
int fa::dkv_bf16_256(int bkv, const BwdArgs& a, int rows, int step,
                     cudaStream_t st) {
  return dkv_tiles<bf16, true>(bkv, a, rows, step, st);
}
int fa::dkv_f16_256(int bkv, const BwdArgs& a, int rows, int step,
                    cudaStream_t st) {
  return dkv_tiles<f16, true>(bkv, a, rows, step, st);
}
int fa::dkv_reduce_bf16(const float* ws, void* dk, void* dv, long long n,
                        int splits, float scale, cudaStream_t st) {
  return dkv_reduce<bf16>(ws, dk, dv, n, splits, scale, st);
}
int fa::dkv_reduce_f16(const float* ws, void* dk, void* dv, long long n,
                       int splits, float scale, cudaStream_t st) {
  return dkv_reduce<f16>(ws, dk, dv, n, splits, scale, st);
}
#endif

#if FA_IN_PART(15)
// the forward's one f32 tile at head-dim class 256, dq's
// (dq_tf32_kernel) and dk/dv's (dkv_tf32_kernel, its query heads split as
// the host asks) with the sum of its splits' partials
int fa::forward_f32_256(int bh, const FwdArgs& a, int rows, int step,
                        cudaStream_t st) {
  if (rows != F32_ROWS || step != F32_STEP || head_class(a.ld) != 256)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_f32<256>(bh, a, st);
}
int fa::dq_tf32_256(int bh, const BwdArgs& a, int rows, int step,
                    cudaStream_t st) {
  return launch_dq_tf32<256, false>(bh, a, rows, step, st);
}
int fa::dkv_f32_256(int bkv, const BwdArgs& a, int rows, int step,
                    cudaStream_t st) {
  return dkv_tf32<256, false>(bkv, a, rows, step, st);
}
int fa::dkv_reduce_f32(const float* ws, void* dk, void* dv, long long n,
                       int splits, float scale, cudaStream_t st) {
  return dkv_reduce<float>(ws, dk, dv, n, splits, scale, st);
}
#endif

#if FA_IN_PART(16)
int fa::forward_bf16_sliced(int bh, const FwdArgs& a, int rows, int step,
                            cudaStream_t st) {
  return fwd_sliced<bf16, false>(bh, a, rows, step, st);
}
int fa::forward_bf16_scaled_sliced(int bh, const FwdArgs& a, int rows,
                                   int step, cudaStream_t st) {
  return fwd_sliced<bf16, true>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(17)
int fa::forward_f16_sliced(int bh, const FwdArgs& a, int rows, int step,
                           cudaStream_t st) {
  return fwd_sliced<f16, false>(bh, a, rows, step, st);
}
int fa::forward_f16_scaled_sliced(int bh, const FwdArgs& a, int rows,
                                  int step, cudaStream_t st) {
  return fwd_sliced<f16, true>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(18)
int fa::dq_bf16_sliced(int bh, const BwdArgs& a, int rows, int step,
                       cudaStream_t st) {
  return dq_sliced<bf16>(bh, a, rows, step, st);
}
int fa::dq_f16_sliced(int bh, const BwdArgs& a, int rows, int step,
                      cudaStream_t st) {
  return dq_sliced<f16>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(19)
int fa::dkv_bf16_sliced(int bkv, const BwdArgs& a, int rows, int step,
                        cudaStream_t st) {
  return dkv_sliced<bf16>(bkv, a, rows, step, st);
}
int fa::dkv_f16_sliced(int bkv, const BwdArgs& a, int rows, int step,
                       cudaStream_t st) {
  return dkv_sliced<f16>(bkv, a, rows, step, st);
}
#endif

#if FA_IN_PART(20)
int fa::forward_f32_sliced(int bh, const FwdArgs& a, int rows, int step,
                           cudaStream_t st) {
  return launch_fwd_sliced_f32<SLICE>(bh, a, rows, step, st);
}
int fa::dq_tf32_stream(int bh, const BwdArgs& a, int rows, int step,
                       cudaStream_t st) {
  return launch_dq_tf32<SLICE, false, true>(bh, a, rows, step, st);
}
int fa::dkv_f32_sliced(int bkv, const BwdArgs& a, int rows, int step,
                       cudaStream_t st) {
  return dkv_tf32<SLICE, false, true>(bkv, a, rows, step, st);
}
#endif

#if FA_IN_PART(21)
int fa::dq_bf16_cluster(int bh, const BwdArgs& a, int rows, int step,
                        cudaStream_t st) {
  return dq_cluster<bf16>(bh, a, rows, step, st);
}
int fa::dq_bf16_cluster_info(int ld, int* smem, int* clusters) {
  return cluster_info<bf16, true>(ld, smem, clusters);
}
#endif

#if FA_IN_PART(22)
int fa::dq_f16_cluster(int bh, const BwdArgs& a, int rows, int step,
                       cudaStream_t st) {
  return dq_cluster<f16>(bh, a, rows, step, st);
}
int fa::dq_f16_cluster_info(int ld, int* smem, int* clusters) {
  return cluster_info<f16, true>(ld, smem, clusters);
}
#endif

#if FA_IN_PART(23)
int fa::dkv_bf16_cluster(int bkv, const BwdArgs& a, int rows, int step,
                         cudaStream_t st) {
  return dkv_cluster<bf16>(bkv, a, rows, step, st);
}
int fa::dkv_bf16_cluster_info(int ld, int* smem, int* clusters) {
  return cluster_info<bf16, false>(ld, smem, clusters);
}
#endif

#if FA_IN_PART(24)
int fa::dkv_f16_cluster(int bkv, const BwdArgs& a, int rows, int step,
                        cudaStream_t st) {
  return dkv_cluster<f16>(bkv, a, rows, step, st);
}
int fa::dkv_f16_cluster_info(int ld, int* smem, int* clusters) {
  return cluster_info<f16, false>(ld, smem, clusters);
}
#endif

#if FA_IN_PART(25)
int fa::forward_bf16_pair(int bh, const FwdArgs& a, int rows, int step,
                          cudaStream_t st) {
  return fwd_pair<bf16, false>(bh, a, rows, step, st);
}
int fa::forward_bf16_scaled_pair(int bh, const FwdArgs& a, int rows,
                                 int step, cudaStream_t st) {
  return fwd_pair<bf16, true>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(26)
int fa::forward_f16_pair(int bh, const FwdArgs& a, int rows, int step,
                         cudaStream_t st) {
  return fwd_pair<f16, false>(bh, a, rows, step, st);
}
int fa::forward_f16_scaled_pair(int bh, const FwdArgs& a, int rows, int step,
                                cudaStream_t st) {
  return fwd_pair<f16, true>(bh, a, rows, step, st);
}
#endif

#if FA_IN_PART(27)
int fa::dkv_f32_cluster(int bkv, const BwdArgs& a, int rows, int step,
                        cudaStream_t st) {
  return dkv_tf32<SLICE, true>(bkv, a, rows, step, st);
}
int fa::dkv_f32_cluster_info(int ld, int* smem, int* clusters) {
  return tf32_cluster_info<false>(ld, smem, clusters);
}
#endif

#if FA_IN_PART(28)
int fa::dq_tf32_cluster(int bh, const BwdArgs& a, int rows, int step,
                        cudaStream_t st) {
  return launch_dq_tf32<SLICE, true>(bh, a, rows, step, st);
}
int fa::dq_f32_cluster_info(int ld, int* smem, int* clusters) {
  return tf32_cluster_info<true>(ld, smem, clusters);
}
#endif

#if FA_IN_PART(10)
// ---------------------------------------------------------------------------
// C interface, bound with ctypes (tf_operator_tpu_torch/ops/attention.py).
// dtype: 0 bf16, 1 fp16, 2 f32 (q, k, v, dO and the outputs alike; lse and
// delta f32).  head_dim is the stored head dim; rows and step the tile
// (rows per block, step of the reduction loop); scaled the forward's route,
// chunk the b*h rows it takes longest first together (lpt_tile).
// A dtype, head dim or tile that has no instantiation returns
// cudaErrorInvalidValue.  Head-dim class 256 goes to the parts that build
// it, and every head dim above 256 to the sliced kernels' parts, but for
// dq and dk/dv in bf16 and fp16 up to CLUSTER_REACH, which go to the
// cluster kernels' (ops/attention.py:CLUSTER_LD is the same bound), and
// the forward in bf16 and fp16 up to PAIR_REACH, which goes to the pair
// forward's (ops/attention.py:PAIR_LD); dq in f32 goes to dq_tf32_kernel
// at every head dim (above 256 its cluster's part up to TF32_REACH,
// ops/attention.py:TF32_LD, and its streamed slices above).

enum { FA_BF16 = 0, FA_F16 = 1, FA_F32 = 2 };

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
                          int head_dim, int dtype, int rows, int step,
                          int scaled, int chunk, float scale, int causal,
                          int window, int sink, void* stream) {
  const FwdArgs a{q,
                  k,
                  v,
                  o,
                  static_cast<float*>(lse),
                  heads / kv_heads,
                  head_dim,
                  scale,
                  Mask{T, causal, window, sink},
                  chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!scaled && !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  if (head_dim > SLICE && head_dim <= PAIR_REACH) {
    switch (dtype) {
      case FA_BF16:
        return (scaled ? fa::forward_bf16_scaled_pair
                       : fa::forward_bf16_pair)(bh, a, rows, step, st);
      case FA_F16:
        return (scaled ? fa::forward_f16_scaled_pair
                       : fa::forward_f16_pair)(bh, a, rows, step, st);
    }
  }
  if (head_dim > SLICE) {
    switch (dtype) {
      case FA_BF16:
        return (scaled ? fa::forward_bf16_scaled_sliced
                       : fa::forward_bf16_sliced)(bh, a, rows, step, st);
      case FA_F16:
        return (scaled ? fa::forward_f16_scaled_sliced
                       : fa::forward_f16_sliced)(bh, a, rows, step, st);
      case FA_F32:
        return fa::forward_f32_sliced(bh, a, rows, step, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = head_class(head_dim) == 256;
  switch (dtype) {
    case FA_BF16:
      return (wide ? (scaled ? fa::forward_bf16_scaled_256
                             : fa::forward_bf16_256)
                   : (scaled ? fa::forward_bf16_scaled : fa::forward_bf16))(
          bh, a, rows, step, st);
    case FA_F16:
      return (wide ? (scaled ? fa::forward_f16_scaled_256
                             : fa::forward_f16_256)
                   : (scaled ? fa::forward_f16_scaled : fa::forward_f16))(
          bh, a, rows, step, st);
    case FA_F32:
      return (wide ? fa::forward_f32_256 : fa::forward_f32)(bh, a, rows, step,
                                                            st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int fa_backward_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq_out, int bh,
                              int heads, int kv_heads, int T, int head_dim,
                              int dtype, int rows, int step, float scale,
                              int causal, int window, int sink,
                              void* stream) {
  const BwdArgs a{q,
                  k,
                  v,
                  dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  dq_out,
                  nullptr,
                  nullptr,
                  heads,
                  kv_heads,
                  head_dim,
                  scale,
                  Mask{T, causal, window, sink},
                  1,
                  nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = head_class(head_dim) == 256;
  if (dtype == FA_F32)
    return (head_dim > TF32_REACH ? fa::dq_tf32_stream
            : head_dim > SLICE    ? fa::dq_tf32_cluster
            : wide                ? fa::dq_tf32_256
                                  : fa::dq_tf32)(bh, a, rows, step, st);
  if (head_dim > SLICE && head_dim <= CLUSTER_REACH) {
    switch (dtype) {
      case FA_BF16: return fa::dq_bf16_cluster(bh, a, rows, step, st);
      case FA_F16: return fa::dq_f16_cluster(bh, a, rows, step, st);
    }
  }
  if (head_dim > SLICE) {
    switch (dtype) {
      case FA_BF16: return fa::dq_bf16_sliced(bh, a, rows, step, st);
      case FA_F16: return fa::dq_f16_sliced(bh, a, rows, step, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case FA_BF16:
      return (wide ? fa::dq_bf16_256 : fa::dq_bf16)(bh, a, rows, step, st);
    case FA_F16:
      return (wide ? fa::dq_f16_256 : fa::dq_f16)(bh, a, rows, step, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dk/dv; at head-dim class 256 `splits` slices of each KV head's
// query-head group, and with more than one `partial` (the f32 workspace
// [2][splits][bkv][T][head_dim]) takes their partials, which fa_dkv_reduce
// sums into dk_out and dv_out; elsewhere (the sliced and cluster kernels
// too: they walk the group in the block) splits is 1 and partial null.  In
// f32 head dims 257..TF32_REACH go to dkv_tf32_kernel's cluster (part
// 27), and those above to its streamed slices (part 20).
extern "C" int fa_backward_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk_out, void* dv_out,
                               void* partial, int bkv, int heads,
                               int kv_heads, int T, int head_dim, int dtype,
                               int rows, int step, int splits, float scale,
                               int causal, int window, int sink,
                               void* stream) {
  const BwdArgs a{q,
                  k,
                  v,
                  dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  nullptr,
                  dk_out,
                  dv_out,
                  heads,
                  kv_heads,
                  head_dim,
                  scale,
                  Mask{T, causal, window, sink},
                  splits,
                  static_cast<float*>(partial)};
  if (splits != 1 && head_class(head_dim) != 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FA_F32 && head_dim > SLICE && head_dim <= TF32_REACH)
    return fa::dkv_f32_cluster(bkv, a, rows, step, st);
  if (head_dim > SLICE && head_dim <= CLUSTER_REACH) {
    switch (dtype) {
      case FA_BF16: return fa::dkv_bf16_cluster(bkv, a, rows, step, st);
      case FA_F16: return fa::dkv_f16_cluster(bkv, a, rows, step, st);
    }
  }
  if (head_dim > SLICE) {
    switch (dtype) {
      case FA_BF16: return fa::dkv_bf16_sliced(bkv, a, rows, step, st);
      case FA_F16: return fa::dkv_f16_sliced(bkv, a, rows, step, st);
      case FA_F32: return fa::dkv_f32_sliced(bkv, a, rows, step, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = head_class(head_dim) == 256;
  switch (dtype) {
    case FA_BF16:
      return (wide ? fa::dkv_bf16_256 : fa::dkv_bf16)(bkv, a, rows, step, st);
    case FA_F16:
      return (wide ? fa::dkv_f16_256 : fa::dkv_f16)(bkv, a, rows, step, st);
    case FA_F32:
      return (wide ? fa::dkv_f32_256 : fa::dkv_f32)(bkv, a, rows, step, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The shared memory (bytes) a cluster kernel takes at a head dim, and the
// clusters of its n_slices blocks the card holds at once: kernel 0 dq, 1
// dk/dv; dtype bf16, fp16 (up to CLUSTER_REACH) or f32 (the tensor-core
// kernels' clusters, up to TF32_REACH).
extern "C" int fa_cluster_info(int kernel, int dtype, int head_dim,
                               int* smem, int* clusters) {
  switch (kernel * 3 + dtype) {
    case 0: return fa::dq_bf16_cluster_info(head_dim, smem, clusters);
    case 1: return fa::dq_f16_cluster_info(head_dim, smem, clusters);
    case 2: return fa::dq_f32_cluster_info(head_dim, smem, clusters);
    case 3: return fa::dkv_bf16_cluster_info(head_dim, smem, clusters);
    case 4: return fa::dkv_f16_cluster_info(head_dim, smem, clusters);
    case 5: return fa::dkv_f32_cluster_info(head_dim, smem, clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// dk = scale * sum_s ws[0][s], dv = sum_s ws[1][s] in the element type
// (bf16, fp16 or f32), n elements each (ws: [2][splits][n] f32).
extern "C" int fa_dkv_reduce(const void* ws, void* dk, void* dv, long long n,
                             int splits, int dtype, float scale,
                             void* stream) {
  const float* w = static_cast<const float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case FA_BF16: return fa::dkv_reduce_bf16(w, dk, dv, n, splits, scale, st);
    case FA_F16: return fa::dkv_reduce_f16(w, dk, dv, n, splits, scale, st);
    case FA_F32: return fa::dkv_reduce_f32(w, dk, dv, n, splits, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
#endif
