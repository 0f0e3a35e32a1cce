// Decode attention for Hopper (sm_90a): one query token a row against that
// row's live columns of a KV cache, split over key chunks ("flash-decoding"),
// bound to Python with ctypes (cluster_anywhere_tpu_torch/ops/attention.py::
// _decode_attention_cuda).
//
// Replaces no Pallas kernel: the JAX package's decode attention
// (cluster_anywhere_tpu/models/generate.py::_masked_attention) is plain jnp,
// which XLA fuses on the TPU.  The port's plain version of it, run eagerly on
// the card, cast the whole K cache of every slot to fp32, made strided
// permute copies of that K and of V, and ran Q K^T as an fp32 GEMV over all
// T_max columns of every row, in every layer of every decode step: about
// 6 GB of traffic a layer for the 32-slot, T_max 2560, 32-head, D 128 bf16
// cache of a 7B chat server, where the rows' live keys need a few hundred MB
// at most, mostly left padding and free slots read for nothing.  This kernel
// computes the same function and reads only what it needs:
//   O[b, h] = softmax(scale * q[b, h] . K[b, j, h / G]) V[b, j, h / G]
//             over the cache columns j in [start[b], end[b])
// with G = H / KV query heads a KV head.  Columns outside the range are never
// read.  A row whose range is empty (a free slot) reads nothing and gets
// O = 0.  q, the caches and O keep their dtype (bf16 or fp32); scores,
// softmax and P V are fp32.  The caches [B, T_max, KV, D] are read in place
// through their strides: no cast, no permute, no copy.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): bytes.  A key costs
// 2 * D * elt bytes of K and V and 4 * D FLOPs a query head, about one FLOP a
// byte under MHA (G under GQA), far below the ~295 FLOPs a byte at which the
// tensor cores would bound it.  So the products run on CUDA cores in fp32 at
// no cost, and the design is about reading each live K/V row once a query
// head, at HBM's rate, whatever the rows' lengths:
//   * Split-KV grid: a block per (key chunk of DEC_CHUNK = 256 columns,
//     query head, row).  The grid and the scratch are sized from T_max, not
//     from the lengths, so the launch needs no host synchronisation (and a
//     CUDA graph could hold it): a block reads start[b] and end[b] on the
//     device and exits at once where its chunk lies outside the range.  A
//     few long rows or many short ones both give hundreds to thousands of
//     working blocks for 132 SMs.
//   * GQA: each of a KV head's G query heads reads its rows in a block of
//     its own, G times the bytes the bound counts.  Blocks that took 2 or 4
//     query heads of a KV head ran 1.3x and 1.9-2.4x faster at 7B sizes,
//     but 4% slower at the small GQA model this repo runs, and no measured
//     configuration is GQA, so this kernel keeps one head a block.
//   * Loads: the chunk's live K rows, then its V rows, stream through a ring
//     of DEC_STAGES tiles of 64 rows in shared memory by 16-byte cp.async,
//     DEC_STAGES - 1 tiles in flight ahead of the compute (V's first tiles
//     arrive while the last K tile's scores are computed); four blocks fit
//     an SM at D 128 bf16, so about 128 KB are in flight an SM.
//   * Scores: D / 8 (bf16) or D / 4 (fp32) neighbouring lanes hold one key
//     row, 16 bytes each, and their partial dot products with the q slices
//     held in registers meet by warp shuffles.  The chunk's scores (in base
//     2, scale * log2(e) folded into q) stay in shared memory; one warp
//     takes their max and sum, and P V runs from them with the same lane
//     layout, each lane accumulating its 16 bytes' worth of D in fp32.
//   * Combine: the chunk's unnormalised O, max and sum go to fp32 scratch
//     ([B, H, n_chunks, D] and [B, H, n_chunks, 2]); a second, small kernel
//     merges a row's chunks as an online softmax does (each chunk's share
//     rescaled by 2^(m_c - M)), divides by the total sum and writes O in q's
//     dtype.
// D (d_head) is a template argument: 16, 32, 64 or 128.

#include <math_constants.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

constexpr int DEC_CHUNK = 256;  // cache columns a block (the split-KV unit)
constexpr int DEC_TILE = 64;    // rows a ring stage
constexpr int DEC_STAGES = 3;   // ring depth
constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;            // [B, 1, H, D]
  const void* k;            // [B, T_max, KV, D]
  const void* v;
  const long long* start;   // [B]
  const long long* end;     // [B]
  void* o;                  // [B, 1, H, D] contiguous, q's dtype
  float* o_part;            // [B, H, n_chunks, D] unnormalised chunk outputs
  float* ml;                // [B, H, n_chunks, 2] chunk max (base 2) and sum
  int B, H, KV, T_max, n_chunks;
  long long q_sb, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  float scale_log2;         // scale * log2(e)
};

// 16 bytes of a row as floats
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* ptr, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(ptr);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static void store(__nv_bfloat16* ptr, float x) { *ptr = __float2bfloat16(x); }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* ptr, float (&f)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(ptr);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ static void store(float* ptr, float x) { *ptr = x; }
};

// The live columns [lo, hi) of row b, clamped to the cache
__device__ __forceinline__ void row_range(const Params& p, int b, long long& lo, long long& hi) {
  lo = p.start[b] < 0 ? 0 : p.start[b];
  hi = p.end[b] > p.T_max ? p.T_max : p.end[b];
}

template <typename T, int D>
constexpr int split_smem_bytes() {
  constexpr int ring = DEC_STAGES * DEC_TILE * D * int(sizeof(T));
  constexpr int red = DEC_WARPS * D * 4;  // P V's partial sums, over the ring once drained
  return (ring > red ? ring : red) + DEC_CHUNK * 4 + 2 * 4;
}

// One block: the chunk blockIdx.x of row blockIdx.z for query head
// blockIdx.y, which reads KV head blockIdx.y / G.
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS) decode_split(const Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = D / VEC;               // lanes a row
  constexpr int RPP = DEC_THREADS / LPR;     // rows a pass over the block
  constexpr int RING = DEC_STAGES * DEC_TILE * D * int(sizeof(T));
  constexpr int RED = DEC_WARPS * D * 4;
  static_assert(LPR <= 32 && DEC_TILE % RPP == 0 && DEC_CHUNK % DEC_TILE == 0, "tile shape");

  const int c = blockIdx.x, b = blockIdx.z, h = blockIdx.y;
  long long lo, hi;
  row_range(p, b, lo, hi);
  lo = lo > (long long)c * DEC_CHUNK ? lo : (long long)c * DEC_CHUNK;
  hi = hi < (long long)(c + 1) * DEC_CHUNK ? hi : (long long)(c + 1) * DEC_CHUNK;
  if (lo >= hi) return;  // the chunk holds none of the row's live columns
  const int n_keys = int(hi - lo);
  const int n_tiles = (n_keys + DEC_TILE - 1) / DEC_TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // reused once the ring is drained
  float* s_s = reinterpret_cast<float*>(smem + (RING > RED ? RING : RED));  // [DEC_CHUNK]
  float* m_s = s_s + DEC_CHUNK;                                             // the chunk's max
  float* l_s = m_s + 1;                                                     // and sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = tid % LPR, rp = tid / LPR;  // this lane's 16 bytes of a row, and the row of a pass
  const int kvh = h / (p.H / p.KV);
  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the tile sequence: K tiles 0..n_tiles-1, then V tiles; rows past the
  // chunk's live ones are zero-filled, never read from the cache
  auto issue = [&](int idx) {
    if (idx < 2 * n_tiles) {
      const bool is_v = idx >= n_tiles;
      const T* base = is_v ? vbase : kbase;
      const long long st = is_v ? p.v_st : p.k_st;
      const long long r0 = lo + (long long)(is_v ? idx - n_tiles : idx) * DEC_TILE;
      const int n = int(hi - r0 < DEC_TILE ? hi - r0 : DEC_TILE);
      T* dst = ring + (idx % DEC_STAGES) * DEC_TILE * D;
      for (int i = tid; i < DEC_TILE * LPR; i += DEC_THREADS) {
        const int r = i / LPR, cc = (i % LPR) * VEC;
        const bool in = r < n;
        cp_async16(dst + r * D + cc, in ? base + (r0 + r) * st + cc : base, in);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  for (int s = 0; s < DEC_STAGES - 1; ++s) issue(s);

  float qr[VEC];  // this lane's slice of the query head, scaled to base 2
  Vec<T>::load(static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + lr * VEC, qr);
#pragma unroll
  for (int e = 0; e < VEC; ++e) qr[e] *= p.scale_log2;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int idx = 0; idx < 2 * n_tiles; ++idx) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // tile idx has landed, and every thread is done with tile idx - 1
    issue(idx + DEC_STAGES - 1);
    const T* tile = ring + (idx % DEC_STAGES) * DEC_TILE * D;
    const bool is_v = idx >= n_tiles;
    const int j = is_v ? idx - n_tiles : idx;
    const int n = n_keys - j * DEC_TILE < DEC_TILE ? n_keys - j * DEC_TILE : DEC_TILE;
    if (is_v && j == 0) {
      // every score is in shared memory: warp 0 takes their max and sum
      // over the chunk, and turns them into probabilities
      if (warp == 0) {
        float m = -CUDART_INF_F;
        for (int i = lane; i < n_keys; i += 32) m = fmaxf(m, s_s[i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float l = 0.f;
        for (int i = lane; i < DEC_CHUNK; i += 32) {
          const float pr = i < n_keys ? exp2_approx(s_s[i] - m) : 0.f;
          s_s[i] = pr;
          l += pr;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        if (lane == 0) {
          *m_s = m;
          *l_s = l;
        }
      }
      __syncthreads();
    }
    // whole passes, so that every lane of a warp reaches the shuffles: rows
    // past n are the ring's zeros, whose scores the softmax drops and whose
    // P is 0
    for (int r0 = 0; r0 < n; r0 += RPP) {
      const int r = r0 + rp;
      float x[VEC];
      Vec<T>::load(tile + r * D + lr * VEC, x);
      const int key = j * DEC_TILE + r;
      if (!is_v) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[e], x[e], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off, LPR);
        if (lr == 0) s_s[key] = dot;
      } else {
        const float pr = s_s[key];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pr, x[e], acc[e]);
      }
    }
  }

  // P V's partial sums: over the rows of a warp by shuffles, then over the
  // warps through shared memory (the drained ring)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  cp_async_wait<0>();
  __syncthreads();
  if (lane < LPR) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[warp * D + lr * VEC + e] = acc[e];
  }
  __syncthreads();
  const long long row = ((long long)b * p.H + h) * p.n_chunks + c;
  for (int d = tid; d < D; d += DEC_THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) o += red[w * D + d];
    p.o_part[row * D + d] = o;
  }
  if (tid == 0) {
    p.ml[row * 2] = *m_s;
    p.ml[row * 2 + 1] = *l_s;
  }
}

// One block a (head, row): merges the row's chunks, O = sum_c 2^(m_c - M)
// O_c / sum_c 2^(m_c - M) l_c, in q's dtype; an empty range gives O = 0.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  long long lo, hi;
  row_range(p, b, lo, hi);
  T* out = static_cast<T*>(p.o) + ((long long)b * p.H + h) * D + d;
  if (lo >= hi) {
    Vec<T>::store(out, 0.f);
    return;
  }
  const int c0 = int(lo / DEC_CHUNK), c1 = int((hi - 1) / DEC_CHUNK);
  const long long row = ((long long)b * p.H + h) * p.n_chunks;
  float m = -CUDART_INF_F;
  for (int c = c0; c <= c1; ++c) m = fmaxf(m, p.ml[(row + c) * 2]);
  float l = 0.f, o = 0.f;
  for (int c = c0; c <= c1; ++c) {
    const float w = exp2_approx(p.ml[(row + c) * 2] - m);
    l = fmaf(w, p.ml[(row + c) * 2 + 1], l);
    o = fmaf(w, p.o_part[(row + c) * D + d], o);
  }
  Vec<T>::store(out, o / l);
}

template <typename T, int D>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<T, D>();
  if (smem > 48 * 1024) {
    // set once a device: a bit a device whose attribute is set
    static std::atomic<unsigned long long> ready{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(ready.load() & bit)) {
      err = cudaFuncSetAttribute(decode_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      ready.fetch_or(bit);
    }
  }
  decode_split<T, D><<<dim3(p.n_chunks, p.H, p.B), DEC_THREADS, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, D><<<dim3(p.H, p.B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int is_bf16, const Params& p, cudaStream_t stream) {
  return is_bf16 ? launch_all<__nv_bfloat16, D>(p, stream) : launch_all<float, D>(p, stream);
}

}  // namespace

// Cache columns a block takes: the wrapper sizes the scratch by it.
extern "C" int decode_attention_chunk() { return DEC_CHUNK; }

extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* start,
                                const void* end, void* o, void* o_part, void* ml, int B, int H,
                                int KV, int T_max, int D, int is_bf16, long long q_sb,
                                long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh, float scale,
                                void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    static_cast<const long long*>(start),
                 static_cast<const long long*>(end), o, static_cast<float*>(o_part),
                 static_cast<float*>(ml), B, H, KV, T_max, (T_max + DEC_CHUNK - 1) / DEC_CHUNK,
                 q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale * LOG2E};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return dispatch_dtype<16>(is_bf16, p, st);
    case 32: return dispatch_dtype<32>(is_bf16, p, st);
    case 64: return dispatch_dtype<64>(is_bf16, p, st);
    case 128: return dispatch_dtype<128>(is_bf16, p, st);
    default: return cudaErrorInvalidValue;
  }
}
