// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the mask predicate of the JAX reference, a fast 2^x, bf16 packing,
// mma.sync m16n8k16, ldmatrix and cp.async.  Header-only; every kernel file
// includes it into its own anonymous namespace scope.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// The reference's mask: keys past T_kv (the ragged edge of a tile) and below
// the row's left pad are dropped, and under causal a query row sees keys
// 0..row (top-left aligned, also when T != T_kv).  Masked probabilities are
// zeroed by this predicate, never by the value of the score: a fully masked
// row has LSE = -1e30, where a masked score would give exp(s - lse) = 1.
__device__ __forceinline__ bool mask_ok(int row, int key, int tkv, int pad, int causal) {
  return key < tkv && key >= pad && (!causal || row >= key);
}

// 2^x by the special-function unit (ex2.approx.ftz: about 2^-22 relative,
// denormal results flushed to zero), where exp2f adds range handling.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) ~= hi + lo with hi and lo bf16 pairs: 16 significant bits, so a
// product through two bf16 mma's keeps the operand to ~1e-5 relative, as
// the reference's fp32 operand does, instead of bf16's ~4e-3.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, fp32 accumulators.
//
// Fragment layout (lane = 4 * g + t): A holds rows g and g + 8, columns
// 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k rows 2t, 2t + 1 and 2t + 8,
// 2t + 9 of column g; C holds rows g and g + 8, columns 2t, 2t + 1.  So the
// C fragments of two 8-column blocks are, packed to bf16, the A fragment of
// one 16-deep step.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a
// row-major shared tile with row stride S (elements).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int S,
                                            int r0, int c0, int g, int t) {
  a[0] = ld32(tile + (r0 + g) * S + c0 + 2 * t);
  a[1] = ld32(tile + (r0 + g + 8) * S + c0 + 2 * t);
  a[2] = ld32(tile + (r0 + g) * S + c0 + 8 + 2 * t);
  a[3] = ld32(tile + (r0 + g + 8) * S + c0 + 8 + 2 * t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte asynchronous copy, global -> shared; `in` false fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way:
// lanes 8j..8j+7 give the addresses of matrix j's eight rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// The B fragments of d blocks nd and nd + 1 for a 16-deep step over rows
// [k0, k0 + 16) of a row-major [rows, D] shared tile (row stride S): one
// transposing ldmatrix gives matrices (rows 0-7 | 8-15) x (nd | nd + 1).
__device__ __forceinline__ void load_b_frags_trans(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                                   int S, int k0, int nd, int lane) {
  const int mj = lane >> 3;
  ldmatrix_x4_trans(r, tile + (k0 + (mj & 1) * 8 + (lane & 7)) * S + (nd + (mj >> 1)) * 8);
}

// Rows [r0, r0 + ROWS) of a [rows, D] operand (row stride `st`) into a
// [ROWS][D + 8] shared tile; rows past n_rows become zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long st, int r0, int n_rows) {
  constexpr int CH = D / 8, S = D + 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r0 + r < n_rows;
    cp_async16(dst + r * S + c, in ? src + (r0 + r) * st + c : src, in);
  }
}

// Raises the kernel's dynamic shared-memory limit where it needs more than
// the default 48 KB, launches it with `args`, and returns cudaGetLastError().
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                          const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
