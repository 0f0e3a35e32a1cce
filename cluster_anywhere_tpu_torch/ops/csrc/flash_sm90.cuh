// Hopper (sm_90a) plumbing for hand-written kernels: mbarriers, TMA tile
// loads and stores through a tensor map, wgmma shared-memory descriptors
// and products, register reallocation between warpgroups, and the
// host-side encoding of a [B, T, H, D] bf16 tensor's TMA map.  Header-only,
// like flash_common.cuh, which it includes; used by flash_bwd.cu.
//
// Conventions (PTX ISA, "Asynchronous warpgroup level matrix multiply"):
//   * Every tile lands by TMA with 128-byte swizzle, in boxes of 64 bf16
//     columns (128-byte rows): a [R, D] tile is D / 64 boxes of R rows, box
//     b (columns 64b .. 64b + 63) at byte offset b * R * 128, row r of a box
//     at r * 128.  Each box starts 1024-byte aligned, so the hardware's
//     swizzle phase (address bits 7-9) is the row index mod 8.
//   * A K-major operand (K contiguous: Q, K, V, dO as A or as B of Q K^T)
//     is described from its first row and 16-column step: start + 32 bytes
//     per step inside a box, the next box every 4 steps; 8-row groups are
//     1024 bytes apart (SBO); LBO is unused.
//   * An MN-major operand (N contiguous: dO, Q or K as B of P^T dO, dS^T Q,
//     dS K) is described from its first K row: 16 K rows = 2048 bytes a
//     step; 8-row groups along K are 1024 bytes apart (SBO), and the 64-wide
//     column boxes along N are LBO = R * 128 bytes apart.
//   * A wgmma accumulator of m64nN holds, in thread 32w + 4g + t of the
//     warpgroup, rows 16w + g (elements 4j, 4j + 1) and 16w + g + 8 (4j + 2,
//     4j + 3) at columns 8j + 2t, 8j + 2t + 1: the mma.sync C layout per
//     warp.  Packed to bf16, columns 16k .. 16k + 15 of it are the register
//     A operand of k-step k (wgmma_a_frag).
//   * Results leave the same way they came in: acc_to_tma_tile writes an
//     accumulator into the swizzled box layout, and one thread stores the
//     boxes by TMA after a proxy fence and a warpgroup barrier.
#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// one arrival, and `bytes` more to come by TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// `bytes` more to come by TMA, without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A ring's round r
// waits for parity r & 1 on its full barrier (consumer) and (r & 1) ^ 1 on
// its empty barrier (producer; passes at once in round 0).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

// One box of a 4-d tensor map into shared memory at `dst`; completion
// (the box's bytes, out-of-bounds elements zero-filled) goes to `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A tile of shared memory at `src` into the box of a 4-d tensor map at
// (c0, c1, c2, c3); elements out of bounds are not written.  The issuing
// thread tracks it in its bulk group (tma_store_wait).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Waits until this thread's TMA stores are complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `n` threads (a multiple of 32) on hardware barrier `id`
// (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// --------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle (offsets in bytes).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties an accumulator to this point of the program, so that the compiler
// neither reads it before the wgmma that writes it has been waited for nor
// moves its registers while one is in flight.
template <int N>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A operands, which a wgmma reads until it completes.
template <int M, int N>
__device__ __forceinline__ void wgmma_fence_operand(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Columns 16k .. 16k + 15 of an m64n64 accumulator, rounded to bf16, as the
// register A operand of one k-step.
__device__ __forceinline__ void wgmma_a_frag(uint32_t (&a)[4], const float (&acc)[32], int k) {
  a[0] = pack_bf16(acc[8 * k], acc[8 * k + 1]);
  a[1] = pack_bf16(acc[8 * k + 2], acc[8 * k + 3]);
  a[2] = pack_bf16(acc[8 * k + 4], acc[8 * k + 5]);
  a[3] = pack_bf16(acc[8 * k + 6], acc[8 * k + 7]);
}

// D[64 x 64] = A[64 x 16] B[16 x 64], the first k-step of a product: D's
// earlier values are neither read nor kept alive
__device__ __forceinline__ void wgmma_m64n64k16_ss_init(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the fragment of
// wgmma_a_frag), B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the fragment of
// wgmma_a_frag), B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// An m64nD accumulator of this warpgroup times `scale`, as bf16, into a
// [64, D] tile of shared memory in the TMA layout (64-column boxes `box`
// bytes apart, 128-byte rows, 128-byte swizzle), ready for tma_store_4d.
// The swizzle spreads the eight rows of each store over all 32 banks.
template <int D>
__device__ __forceinline__ void acc_to_tma_tile(uint32_t tile, uint32_t box,
                                                const float (&acc)[D / 2], float scale, int warp,
                                                int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t addr =
          tile + (j >> 3) * box + row * 128 + (((j & 7) ^ (row & 7)) << 4) + 4 * t;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                   "r"(pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale))
                   : "memory");
    }
  }
}

// D[64 x N] += A[64 x 16] B[16 x N], N = 64 or 128: the register-A instruction
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_m64n64k16_rs(d, a, b);
  } else {
    static_assert(N == 128, "wgmma_rs: N is 64 or 128");
    wgmma_m64n128k16_rs(d, a, b);
  }
}

// ---------------------------------------------------- register budgets

// Warp specialisation: the producer warpgroup gives registers back and
// the consumer warpgroups take them (both counts multiples of 8, 24..256).
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------- host: tensor maps

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched once through the
// runtime, so the library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 [B, T, H, D] tensor read through its strides
// (elements; unit stride on D, 16-byte-aligned strides), in boxes of
// `rows` rows of one (b, h) by 64 columns, 128-byte swizzled.  Rows past T
// read as zeros.  Returns false where the driver refuses the map.
inline bool make_bthd_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
                          long long sb, long long st, long long sh, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
