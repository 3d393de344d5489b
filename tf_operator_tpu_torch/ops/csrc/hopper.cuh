// Hopper (sm_90a) building blocks for the flash-attention kernels: tensor
// maps and TMA loads, mbarriers, wgmma shared-memory descriptors and the
// wgmma products the kernels issue.  Plain PTX through asm volatile; no
// CUTLASS/CuTe templates, so a build stays a matter of seconds.
//
// Shared-memory tiles are 128-byte swizzled: a tile of `rows` x D 16-bit
// elements (bf16 or fp16) is stored as D/64 column blocks of [rows][64],
// each row one 128-byte line whose 16-byte chunk c sits at chunk c ^ (row %
// 8) (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B).  Every column block
// starts on 1024 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Tensor maps (host).  A [n, T, ld] tensor of 16-bit elements is mapped in
// 3-D so that the zero fill of a box reaching past row T stops at that
// head's end: rows past T of one head never read the next head's rows, and
// nothing is padded in memory.  Boxes are 64 columns (one 128-byte line) by
// `rows`.  The stored head dim ld (a multiple of 8: TMA takes row strides
// in multiples of 16 bytes) may be narrower than the kernel's head-dim
// class D (64, 128 or 256): the columns of a box past ld are zero-filled
// too (a box wholly past ld comes back all zeros), so a product over them
// adds nothing.

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has
// already loaded, so it is looked up there rather than linked.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Returns 0, or the CUresult (or -1 when the entry point is missing).
inline int tile_map(CUtensorMap* map, CUtensorMapDataType type,
                    const void* base, int n, int T, int ld, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)T, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)T * ld * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return (int)fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
                 elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ---------------------------------------------------------------------------
// Shared memory, mbarriers and TMA (device).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete.  A pipeline fault that
// would wait forever traps after about 10 s instead (a launch error the
// caller sees) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

// 4 bytes from global src to shared dst without waiting (cp.async), or 4
// zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// This thread's arrival on `bar`, made when its cp.async copies so far
// have landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// One box {64 columns from d0, rows from row0, index n} into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d0, int row0, int n,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(row0), "r"(n),
      "r"(bar)
      : "memory");
}

// A whole rows x D tile: its D/64 column blocks, rows * 128 bytes apart.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int rows, int row0, int n,
                                         uint32_t bar) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
    tma_load(dst + h * rows * 128, map, h * 64, row0, n, bar);
}

// One box {64 columns from d0, rows from row0, index n} from src in shared
// memory to global memory (the tensor map clips what falls past the
// tensor's edges: rows past T, columns past ld), in this thread's bulk
// group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int d0, int row0, int n) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d0), "r"(row0), "r"(n)
      : "memory");
}

// Closes this thread's bulk group of stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed stores have read their shared memory
// (which may then be overwritten).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's committed stores have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later reads of the
// async proxy (a TMA store of what it wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads') over `n` threads: sync
// waits until n threads have arrived (its own warps included), arrive
// counts this warp's threads and goes on.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Warp specialisation.  A block is WG consumer warpgroups and one producer
// warpgroup, whose first warp issues the loads and whose other three exit;
// the producer gives its registers back (setmaxnreg) so that the consumers
// can hold their accumulators.  With `blocks` blocks on an SM, the launch
// gives every thread reg_base registers; the consumers then take
// reg_consumer each, which the registers the producer frees must cover
// (the pool setmaxnreg draws on is the block's own).

constexpr int PRODUCER_REGS = 24;

__host__ __device__ constexpr int reg_base(int wg, int blocks) {
  return 65536 / (blocks * 128 * (wg + 1)) / 8 * 8;
}

__host__ __device__ constexpr int reg_consumer(int wg, int blocks) {
  return ((reg_base(wg, blocks) * (wg + 1) - PRODUCER_REGS) / wg / 8 * 8) > 240
             ? 240
             : (reg_base(wg, blocks) * (wg + 1) - PRODUCER_REGS) / wg / 8 * 8;
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma.  Descriptors for 128-byte-swizzled tiles: bits 0-13 start address
// >> 4, 16-29 leading byte offset >> 4, 32-45 stride byte offset >> 4,
// 62-63 layout (1 = 128-byte swizzle).  The stride between 8-row groups is
// 1024 bytes.  A product never spans two 64-column blocks (wide outputs are
// issued per block), so the leading offset is never read; it is set to
// 1024 all the same.  Stepping k inside a 128-byte line adds the unswizzled
// byte offset to the start; the hardware applies the XOR.

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand (the reduction axis is a tile's columns, as Q, K, V and
// dO are stored): k step kk (16 columns) of a rows x D tile at `tile`.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32);
}

// MN-major operand (the reduction axis is a tile's rows: V in P.V, K in
// dS.K, dO and Q in the dk/dv products): k step kk (16 rows), column
// block h.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk,
                                            int h) {
  return desc(tile + h * rows * 128 + kk * 16 * 128);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product (it does not know wgmma is async).
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_F4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F16(d, i) \
  HOPPER_F4(d, i), HOPPER_F4(d, i + 4), HOPPER_F4(d, i + 8), \
      HOPPER_F4(d, i + 12)
#define HOPPER_F64(d, i) \
  HOPPER_F16(d, i), HOPPER_F16(d, i + 16), HOPPER_F16(d, i + 32), \
      HOPPER_F16(d, i + 48)
#define HOPPER_D8 "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}"
#define HOPPER_D16 \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15" "}"
#define HOPPER_D32 \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" "}"
#define HOPPER_D64 \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63" "}"

// The products for one element type E (__nv_bfloat16: "bf16", __half:
// "f16"); f32 accumulators in both.
//   ss: d[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory,
//       K-major; N = 2 x the accumulator's length (16, 32, 64 or 128).
//   rs64: d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the
//       accumulator layout of a previous product, rounded to E), B from
//       shared memory MN-major (the transpose bit).
template <typename E>
struct Mma;

#define HOPPER_MMA_SS(N, R, A, B, P, TY, OUTS)                              \
  static __device__ __forceinline__ void ss(float(&d)[R], uint64_t a,        \
                                            uint64_t b, int accumulate) {    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
                 " " HOPPER_D##R ", %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"    \
                 : OUTS                                                      \
                 : "l"(a), "l"(b), "r"(accumulate));                         \
  }

#define HOPPER_MMA(TY)                                                       \
  HOPPER_MMA_SS(16, 8, 8, 9, 10, TY,                                         \
                HOPPER_F4(d, 0) HOPPER_COMMA HOPPER_F4(d, 4))                \
  HOPPER_MMA_SS(32, 16, 16, 17, 18, TY, HOPPER_F16(d, 0))                    \
  HOPPER_MMA_SS(64, 32, 32, 33, 34, TY,                                      \
                HOPPER_F16(d, 0) HOPPER_COMMA HOPPER_F16(d, 16))             \
  HOPPER_MMA_SS(128, 64, 64, 65, 66, TY, HOPPER_F64(d, 0))                   \
  static __device__ __forceinline__ void rs64(float(&d)[32],                 \
                                              const uint32_t(&a)[4],         \
                                              uint64_t b) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
                 " " HOPPER_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"\
                 : HOPPER_F16(d, 0), HOPPER_F16(d, 16)                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                   "r"(1));                                                  \
  }

#define HOPPER_COMMA ,
template <>
struct Mma<__nv_bfloat16> {
  HOPPER_MMA("bf16")
};
template <>
struct Mma<__half> {
  HOPPER_MMA("f16")
};

#undef HOPPER_COMMA
#undef HOPPER_MMA
#undef HOPPER_MMA_SS
#undef HOPPER_D64
#undef HOPPER_D32
#undef HOPPER_D16
#undef HOPPER_D8
#undef HOPPER_F64
#undef HOPPER_F16
#undef HOPPER_F4

}  // namespace hopper
