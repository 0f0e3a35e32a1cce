// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes
// (cluster_anywhere_tpu_torch/ops/attention.py::_flash_fwd_cuda).
//
// Replaces: cluster_anywhere_tpu/ops/attention.py::_fwd_kernel, the Pallas
// kernel launched by _fwd_impl.  It computes the same function:
//   O   = softmax(scale * Q K^T + mask) V      (fp32 accumulation)
//   LSE = m + log(l)                           (per b, h, query row; fp32)
// with the reference's masks: causal is top-left aligned (q_pos >= k_pos,
// both counted from 0, also when T != T_kv); keys below pad[b] are dropped;
// masked scores are held at -1e30 (not -inf: exp(-inf - -inf) is NaN) and
// their probabilities zeroed; a fully masked row gives O = 0, LSE = -1e30.
// q, k, v are read in the [B, T, H, D] layout through their strides, so no
// transpose to [B*H, T, D] is made on the host.  Any T and T_kv: the ragged
// edge of a tile is masked here.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the serving
// prefill shape (B 8, T 512, H 8, D 128, bf16, causal) without pad, q, k, v
// and O are 33.6 MB, about 10 us of memory traffic, against 4.3 GFLOP of
// causal products, about 4.3 us of tensor-core work.  With the rows padded
// to 128..512 real tokens, as the serving smoke run prefills them, the
// output depends only on the live q, k, v rows: 15.7 MB of them plus 8.5 MB
// of O and LSE, about 7.2 us, against 1.9 GFLOP, about 2 us.  So one
// launch is bound by bytes.  What the design does about it: a block owns
// one (64-row query tile, b*h) pair, reads its Q tile once, and streams K/V
// tiles of 64 keys through shared memory, double-buffered with cp.async so
// that the next tile's copy overlaps this tile's products; the scores and
// probabilities live only in registers, so device memory sees q, k, v and
// O once each (the other query tiles of a head re-read K/V from the 50 MB
// L2).  Causal blocks stop at the diagonal, and the grid launches the
// longest (last) query tiles first so that the short ones fill the tail.
// Key tiles below pad[b], and query tiles wholly inside the pad, are still
// read and masked here: the bound above does not count them.
//
// Two instances of the same algorithm:
//   bf16: four warps, 16 query rows each, mma.sync m16n8k16 with fp32
//         accumulation for Q K^T and P V.  P enters P V as the sum of two
//         bf16 parts (hi + lo), so it keeps ~16 bits as the reference's
//         fp32 P does; one bf16 part alone flipped near-tie greedy tokens
//         of the flagship model against the fp32 plain version.
//   fp32: CUDA-core FMAs in full fp32 (never TF32), four threads per query
//         row, each holding every fourth element of d_head.
// D (d_head) is a template argument: 16, 32, 64 or 128.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per shared-memory tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pad;  // [B] left-pad counts, or null
  void* o;
  float* lse;      // [B, H, T]
  int B, T, Tkv, H;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ bool key_ok(const Params& p, int row, int key, int pad) {
  return mask_ok(row, key, p.Tkv, pad, p.causal);
}

// ---------------------------------------------------------------- bf16 path

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * BK * (D + 8) * 2;
}

// Fragment layouts of m16n8k16: flash_common.cuh, mma_bf16.
//
// K/V tiles are double-buffered: the copy of tile j + 1 (cp.async) is in
// flight while the block computes on tile j.
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(const Params p) {
  static_assert(BQ == BK, "Q shares a tile-sized buffer with K");
  constexpr int S = D + 8;  // row stride of every tile (bf16): rows fall on other banks
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // 4 x [64][S]
  // buffers: K0, V0, V1 and K1; Q lives in K1, which is first written after
  // the Q fragments are in registers
  __nv_bfloat16* const Qs = tiles;
  auto k_buf = [&](int j) { return (j & 1) ? tiles : tiles + BK * S; };
  auto v_buf = [&](int j) { return tiles + (2 + (j & 1)) * BK * S; };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pad = p.pad ? p.pad[b] : 0;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int kv_end = p.causal ? min(p.Tkv, q0 + BQ) : p.Tkv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_tile_async<BK, D>(Qs, qg, p.q_st, q0, p.T);
  if (n_tiles > 0) {
    load_tile_async<BK, D>(k_buf(0), kg, p.k_st, 0, p.Tkv);
    load_tile_async<BK, D>(v_buf(0), vg, p.v_st, 0, p.Tkv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld32(Qs + (r0 + g) * S + kk * 16 + 2 * t);
    qf[kk][1] = ld32(Qs + (r0 + g + 8) * S + kk * 16 + 2 * t);
    qf[kk][2] = ld32(Qs + (r0 + g) * S + kk * 16 + 8 + 2 * t);
    qf[kk][3] = ld32(Qs + (r0 + g + 8) * S + kk * 16 + 8 + 2 * t);
  }
  __syncthreads();  // Qs is the second K buffer from here on

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    const __nv_bfloat16* Ks = k_buf(j);
    const __nv_bfloat16* Vs = v_buf(j);
    if (j + 1 < n_tiles) {
      load_tile_async<BK, D>(k_buf(j + 1), kg, p.k_st, k0 + BK, p.Tkv);
      load_tile_async<BK, D>(v_buf(j + 1), vg, p.v_st, k0 + BK, p.Tkv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed; tile j + 1 may still be in flight
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = Ks + (nb * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(s[nb], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + 2 * t + (e & 1);
        const float x = key_ok(p, rows[e >> 1], key, pad) ? s[nb][e] * p.scale : NEG_INF;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row is spread over the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nb][e];
        const float pe = x <= NEG_INF ? 0.f : expf(x - mx[e >> 1]);
        s[nb][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
    // P V: the C fragments of two score blocks are the A fragment of one
    // 16-key step; P goes in as hi + lo bf16 parts.  The B fragments of two
    // 8-wide d blocks come from one transposing ldmatrix of the row-major V
    // tile: matrices (keys 0-7 | 8-15) x (d block nd | nd + 1).
    const int mj = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a_hi[4], a_lo[4];
      split_bf16(s[2 * ks][0], s[2 * ks][1], a_hi[0], a_lo[0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], a_hi[1], a_lo[1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], a_hi[2], a_lo[2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], a_hi[3], a_lo[3]);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (ks * 16 + (mj & 1) * 8 + (lane & 7)) * S + (nd + (mj >> 1)) * 8);
        mma_bf16(o[nd], a_hi, vb[0], vb[1]);
        mma_bf16(o[nd], a_lo, vb[0], vb[1]);
        mma_bf16(o[nd + 1], a_hi, vb[2], vb[3]);
        mma_bf16(o[nd + 1], a_lo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with tile j before its buffers refill
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.T) continue;
    const float ls = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(og + rows[r] * p.o_st + nd * 8 + 2 * t) =
          pack_bf16(o[nd][2 * r] / ls, o[nd][2 * r + 1] / ls);
    }
    if (t == 0) p.lse[(long long)bh * p.T + rows[r]] = m[r] + logf(ls);
  }
}

// ---------------------------------------------------------------- fp32 path

template <int D>
constexpr int f32_smem_bytes() {
  return 2 * BK * D * 4;
}

template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(const Params p) {
  constexpr int DP = D / 4;  // elements of d_head per thread: part, part + 4, ...
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [BK][D]
  float* Vs = Ks + BK * D;                     // [BK][D]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = q0 + (tid >> 2);
  const int pad = p.pad ? p.pad[b] : 0;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    q[i] = row < p.T ? qg[row * p.q_st + 4 * i + part] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int kv_end = p.causal ? min(p.Tkv, q0 + BQ) : p.Tkv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Tkv;
      Ks[i] = in ? kg[(k0 + r) * p.k_st + c] : 0.f;
      Vs[i] = in ? vg[(k0 + r) * p.v_st + c] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) d = fmaf(q[i], Ks[j * D + 4 * i + part], d);
      // the four partial sums meet in the same order on every lane of the quad
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[j] = key_ok(p, row, k0 + j, pad) ? d * p.scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = s[j] <= NEG_INF ? 0.f : expf(s[j] - mx);
      rs += s[j];
    }
    l = l * alpha + rs;
    m = mx;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(s[j], Vs[j * D + 4 * i + part], acc[i]);
    }
  }

  if (row < p.T) {
    const float ls = l == 0.f ? 1.f : l;
    float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_st;
#pragma unroll
    for (int i = 0; i < DP; ++i) og[4 * i + part] = acc[i] / ls;
    if (part == 0) p.lse[(long long)bh * p.T + row] = m + logf(ls);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, const Params& p, cudaStream_t stream) {
  return launch_kernel(kernel, dim3(p.B * p.H, (p.T + BQ - 1) / BQ), threads, smem, stream, p);
}

template <int D>
cudaError_t dispatch_dtype(int is_bf16, const Params& p, cudaStream_t stream) {
  if (is_bf16) return launch(flash_fwd_bf16<D>, 128, bf16_smem_bytes<D>(), p, stream);
  return launch(flash_fwd_f32<D>, 256, f32_smem_bytes<D>(), p, stream);
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() after the
// launch (0 on success).  Pointers are device pointers; strides are in
// elements; q, k, v, o must have unit stride along d_head and, for bf16,
// 16-byte-aligned rows.  The caller checks shapes, dtypes and alignment.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* pad, void* o,
                         void* lse, int B, int T, int Tkv, int H, int D, int is_bf16,
                         long long q_sb, long long q_st, long long q_sh, long long k_sb,
                         long long k_st, long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, long long o_sb, long long o_st, long long o_sh,
                         float scale, int causal, void* stream) {
  const Params p{q,    k,    v,    static_cast<const int*>(pad), o,    static_cast<float*>(lse),
                 B,    T,    Tkv,  H,    q_sb, q_st, q_sh,         k_sb, k_st, k_sh,
                 v_sb, v_st, v_sh, o_sb, o_st, o_sh, scale,        causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return dispatch_dtype<16>(is_bf16, p, st);
    case 32: return dispatch_dtype<32>(is_bf16, p, st);
    case 64: return dispatch_dtype<64>(is_bf16, p, st);
    case 128: return dispatch_dtype<128>(is_bf16, p, st);
    default: return cudaErrorInvalidValue;
  }
}
