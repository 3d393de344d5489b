// f32 products on the tensor cores in three TF32 passes, for the f32
// kernels of flash_attention.cu: f32 tiles in shared memory, their
// fragments for mma.sync m16n8k8, the split of an operand into two TF32
// halves, the three products of a split, and the compensated sum.
//
// A TF32 product rounds each operand to a 10-bit mantissa, which one pass
// leaves some 4e-4 from the f32 result (relative Frobenius error of dk and
// dv), above the f32 kernels' rule.  Three passes split each operand x
// into hi = tf32(x) and lo = tf32(x - hi) and add lo * hi, hi * lo and then
// hi * hi in f32: each product to within about 2^-22 of itself (lo * lo
// and lo's own rounding dropped; an f32 FMA's is 2^-24), at three times
// the products of one pass (the route CUTLASS calls OpMultiplyAddFastF32,
// which PyTorch's memory-efficient attention takes for f32).  The tensor
// cores add each mma's 8 products to its accumulator with one rounding
// (toward zero, as a model of them that reproduces the card's errors
// takes it: PERF.md), so short chains of products and a compensated sum
// of the chains (kahan) keep a long contraction's sum closer to the exact
// one than plain f32's (one rounding a product), which at large logits
// leaves the f32 rule against it.
//
// Tiles: a tile of `rows` x W f32 values (W a multiple of 32) is stored as
// W / 32 column blocks of [rows][32], block b at b * rows * 128 bytes, each
// row one 128-byte line whose 16-byte chunk c sits at chunk c ^ (row % 8):
// what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B from a 32-column box (the
// blocks start on 1024 bytes).  Both orientations a kernel reads are free
// of bank conflicts in that layout:
//   * along a row (A[16 rows][8 k], or B of a product that contracts the
//     columns: lane g * 4 + t reads row g (mod 8), column t (and t + 4) of
//     an 8-column step): the 8 rows' chunks land in 8 different bank
//     groups of 4, the 4 columns in one group's 4 banks;
//   * down the columns (B of a product that contracts the rows, read with
//     its k index permuted so that k = t, t + 4 are rows 2t, 2t + 1 of the
//     step, below): lane g * 4 + t reads row 2t (or 2t + 1), column g of an
//     8-column group: the 4 rows' XOR moves the chunk across the 4 groups
//     of 8 banks, the 8 columns fill a group.
// The permuted k index is also what lets a product's accumulator feed the
// next product as its A operand without a shuffle: the accumulator of an
// m16n8 tile holds, in lane g * 4 + t, columns 2t and 2t + 1 of rows g and
// g + 8, which are A's k = t and k = t + 4 when A's k step maps k = t to
// column 2t and k = t + 4 to 2t + 1.  A contraction's sum does not depend
// on the order of its k index, so B is read in the same order.
#pragma once

#include "hopper.cuh"

namespace tf32 {

// A [n, T, ld] f32 tensor mapped in 3-D as hopper::tile_map maps 16-bit
// ones (the zero fill of a box stops at a head's end and at ld), in boxes
// of 32 columns (128 bytes) by `rows`, 128-byte swizzled.  Returns 0, or
// the CUresult (-1 when the entry point is missing).
inline int tile_map(CUtensorMap* map, const void* base, int n, int T, int ld,
                    int rows) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)T, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)T * ld * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                 const_cast<void*>(base), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: half of the 13 dropped bits' range added to the magnitude,
// then those bits cleared), as the bits mma.sync takes, for finite x.  Two
// integer operations and not the cvt itself: measured on an H100, the cvt
// (two for each value split) made f32 dk/dv 10-18 % slower (PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// An operand split in two TF32 halves: hi = tf32(x), lo = tf32(x - hi).
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.hi[i] = to_tf32(x[i]);
    s.lo[i] = to_tf32(x[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

// d[16 x 8] += a[16 x 8] b[8 x 8] in one TF32 pass (f32 accumulators):
// lane g * 4 + t holds a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t +
// 4], b = B[t][g], B[t + 4][g] and d = D[g][2t], D[g][2t + 1], D[g + 8][2t],
// D[g + 8][2t + 1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The product in PASSES passes (3, or 1 for one TF32 pass):
// d += a.lo b.hi, then a.hi b.lo, then a.hi b.hi.
template <int PASSES>
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  static_assert(PASSES == 1 || PASSES == 3, "one or three TF32 passes");
  if (PASSES == 3) {
    mma(d, a.lo, b.hi[0], b.hi[1]);
    mma(d, a.hi, b.lo[0], b.lo[1]);
  }
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

// The same three passes into three sums of their own (a.lo b.hi, a.hi b.lo,
// a.hi b.hi: three chains of products where one would wait on each
// product), and their total (lh + hl) + hh added to d in f32 (promote's
// rounding): measured on an H100, 10 % off f32 dk/dv at 256 columns a
// block (PERF.md).
template <int PASSES>
__device__ __forceinline__ void mma3(float (&lh)[4], float (&hl)[4],
                                     float (&hh)[4], const Split<4>& a,
                                     const Split<2>& b) {
  static_assert(PASSES == 1 || PASSES == 3, "one or three TF32 passes");
  if (PASSES == 3) {
    mma(lh, a.lo, b.hi[0], b.hi[1]);
    mma(hl, a.hi, b.lo[0], b.lo[1]);
  }
  mma(hh, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ void promote(float (&d)[4], const float (&lh)[4],
                                        const float (&hl)[4],
                                        const float (&hh)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += (lh[i] + hl[i]) + hh[i];
}

// d += x by Kahan's compensated sum: c holds what the sums so far lost
// (negated), so that their total is d - c (fold), to within one rounding
// of the total, however many x are added.  For a contraction over a long
// head dim: its f32 sum of one rounding an addend errs with the number of
// addends, which at large logits (scale -1 at head dim 512: dP of ~22
// summed from 16 blocks) leaves the f32 rule against the exact product
// (PERF.md).  Four additions where promote takes one.
__device__ __forceinline__ void kahan(float& d, float& c, float x) {
  const float y = x - c;
  const float s = d + y;
  c = (s - d) - y;
  d = s;
}
template <int N>
__device__ __forceinline__ void kahan(float (&d)[N], float (&c)[N],
                                      const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) kahan(d[i], c[i], x[i]);
}

// d += part in f32 on the CUDA cores (round to nearest).  Over a long
// chain of products into one accumulator the tensor cores' f32 sum errs
// well beyond f32's rounding: measured on an H100, dk and dv summed over
// 16,384 queries in the accumulator left the f32 rule by 6x in relative
// Frobenius error (2,048 queries: 2.2x; 1.4e-6 with this promotion).  So a chain stays short (one 32-column block
// of a contraction, one query step of a second product, 3 x 4 products at
// most), and its sum is promoted into the long one here.
__device__ __forceinline__ void promote(float (&d)[4], const float (&part)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += part[i];
}

// Offsets (in floats) into a tile of the layout above, for lane g * 4 + t.
//   row_off(ch): column 4 * ch + t of a row r with r % 8 == g, from the
//     row's first float in its column block (a row-wise fragment: A's, or
//     B's of a product that contracts the columns);
//   col_off(c4, e): column 8 * c4 + g of row 2t + e of an 8-row step, from
//     the step's first row in its column block (a column-wise fragment: B
//     of a product that contracts the rows, k = t at e = 0, k = t + 4 at
//     e = 1).
__device__ __forceinline__ int row_off(int ch, int g, int t) {
  return ((ch ^ g) << 2) + t;
}
__device__ __forceinline__ int col_off(int c4, int e, int g, int t) {
  const int r = 2 * t + e;
  return r * 32 + ((((2 * c4 + (g >> 2)) ^ r) << 2) | (g & 3));
}

// 16 bytes from global src to shared dst without waiting (cp.async, cached
// in L2 only), or 16 zero bytes when !valid (src is then not read); the
// thread's copies so far closed into a group; and the wait until at most N
// of its groups are in flight.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes from another block's shared memory (a shared::cluster address
// from hopper::mapa).
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The blocks of this block's cluster.
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

}  // namespace tf32
