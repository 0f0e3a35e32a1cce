// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bound to Python with ctypes
// (cluster_anywhere_tpu_torch/ops/attention.py::flash_bwd_dq, flash_bwd_dkv).
//
// Replaces: cluster_anywhere_tpu/ops/attention.py::_bwd_dq_kernel and
// _bwd_dkv_kernel, the two Pallas kernels launched by _bwd_impl.  They
// compute the same FA2 backward from the forward's saved LSE:
//   P  = exp(scale * Q K^T - LSE)        (masked entries zero)
//   dP = dO V^T,  dS = P * (dP - delta)  (delta = rowsum(dO * O) - dLSE,
//                                         a torch reduction in the wrapper)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// with the forward's masks (flash_common.cuh, mask_ok): causal top-left
// aligned, keys below pad[b] dropped, any T and T_kv (ragged tile edges
// masked here; the JAX kernels want divisible tiles).  P is zeroed by the
// predicate, so a fully masked row (LSE = -1e30) gets no gradient.
//
// As in the JAX package, the work is split so that no block carries a sum
// into another: a dQ block owns 64 query rows and loops over key tiles (up
// to the diagonal under causal); a dK/dV block owns 64 keys and loops over
// query tiles (from its first key on under causal).  There are no atomics,
// so the gradients are the same bits from run to run.  Every output row is
// written, zeros where nothing contributes.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the flagship
// training shape (B 8, T 1024, H 8 after the GQA repeat, D 128, bf16,
// causal): 5 products of 2 D flops per causal (query, key) pair, 42.99
// GFLOP or 43.5 us of tensor-core work, against 134.5 MB of q, k, v, O,
// dO, LSE read and dQ, dK, dV written, 40.1 us of memory traffic: bound by
// operations.  What the design does about it: the five products run on the
// tensor cores (mma.sync), the [T, T_kv] scores and their gradients live
// only in registers, and the tiles a block streams (K/V for dQ, Q/dO and
// LSE/delta for dK/dV) are double-buffered with cp.async so that the next
// tile's copy overlaps this tile's products.  The dQ kernel recomputes
// dP = dO V^T that the dK/dV kernel also computes (7 products in all, not
// 5): the price of having no carry between blocks.
//
// Two instances of each kernel:
//   bf16: four warps, mma.sync m16n8k16 with fp32 accumulation.  P and dS
//         enter their products (dV, dQ, dK) rounded to bf16, as FA2 does;
//         on the card's flagship inputs that keeps every gradient within
//         the stated tolerance of the fp32 plain version (PERF.md).
//   fp32: CUDA-core FMAs in full fp32 (never TF32), four threads per row,
//         each holding every fourth element of d_head.
// D (d_head) is a template argument: 16, 32, 64 or 128.

#include <type_traits>

#include "flash_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  const int* pad;      // [B] left-pad counts, or null
  void* dq;            // [B, T, H, D], contiguous
  void* dk;            // [B, T_kv, H, D], contiguous
  void* dv;            // [B, T_kv, H, D], contiguous
  int B, T, Tkv, H;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  float scale;
  int causal;
};

constexpr int DQ_BQ = 64;   // dQ: query rows per block
constexpr int DQ_BK = 64;   // dQ: keys per shared tile
constexpr int KV_BK = 64;   // dK/dV: keys per block
constexpr int KV_BQ = 32;   // dK/dV, bf16: query rows per shared tile
constexpr int KV_BQ32 = 64; // dK/dV, fp32: query rows per shared tile

// ------------------------------------------------------------- dQ, bf16

template <int D>
constexpr int dq_bf16_smem_bytes() {
  return 6 * DQ_BK * (D + 8) * 2;  // Q, dO, K0, V0, K1, V1
}

template <int D>
__global__ void __launch_bounds__(128) bwd_dq_bf16(const Params p) {
  static_assert(DQ_BQ == DQ_BK, "every shared tile has the same shape");
  constexpr int S = D + 8;  // row stride of every tile (bf16)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const dOs = Qs + DQ_BQ * S;
  __nv_bfloat16* const kv = dOs + DQ_BQ * S;
  auto k_buf = [&](int j) { return kv + 2 * (j & 1) * DQ_BK * S; };
  auto v_buf = [&](int j) { return kv + (2 * (j & 1) + 1) * DQ_BK * S; };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pad = p.pad ? p.pad[b] : 0;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;

  const int kv_end = p.causal ? min(p.Tkv, q0 + DQ_BQ) : p.Tkv;
  const int n_tiles = (kv_end + DQ_BK - 1) / DQ_BK;

  load_tile_async<DQ_BQ, D>(Qs, qg, p.q_st, q0, p.T);
  load_tile_async<DQ_BQ, D>(dOs, dog, p.do_st, q0, p.T);
  if (n_tiles > 0) {
    load_tile_async<DQ_BK, D>(k_buf(0), kg, p.k_st, 0, p.Tkv);
    load_tile_async<DQ_BK, D>(v_buf(0), vg, p.v_st, 0, p.Tkv);
  }
  cp_async_commit();

  const int r0 = warp * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < p.T;
    lse[r] = in ? p.lse[(long long)bh * p.T + rows[r]] : 0.f;
    delta[r] = in ? p.delta[(long long)bh * p.T + rows[r]] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * DQ_BK;
    const __nv_bfloat16* Ks = k_buf(j);
    const __nv_bfloat16* Vs = v_buf(j);
    if (j + 1 < n_tiles) {
      load_tile_async<DQ_BK, D>(k_buf(j + 1), kg, p.k_st, k0 + DQ_BK, p.Tkv);
      load_tile_async<DQ_BK, D>(v_buf(j + 1), vg, p.v_st, k0 + DQ_BK, p.Tkv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q, dO) have landed; tile j + 1 may be in flight
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < DQ_BK / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, Qs, S, r0, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < DQ_BK / 8; ++nb) {
        const __nv_bfloat16* kp = Ks + (nb * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(s[nb], a, ld32(kp), ld32(kp + 8));
      }
      load_a_frag(a, dOs, S, r0, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < DQ_BK / 8; ++nb) {
        const __nv_bfloat16* vp = Vs + (nb * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(dp[nb], a, ld32(vp), ld32(vp + 8));
      }
    }
    // dS = P * (dP - delta), in place of S
#pragma unroll
    for (int nb = 0; nb < DQ_BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + nb * 8 + 2 * t + (e & 1);
        const float pe = mask_ok(rows[r], key, p.Tkv, pad, p.causal)
                             ? expf(s[nb][e] * p.scale - lse[r])
                             : 0.f;
        s[nb][e] = pe * (dp[nb][e] - delta[r]);
      }
    }
    // dQ += dS K: dS (bf16) as the A operand, K's B fragments by ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < DQ_BK / 16; ++ks) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t kb[4];
        load_b_frags_trans(kb, Ks, S, ks * 16, nd, lane);
        mma_bf16(dq[nd], a, kb[0], kb[1]);
        mma_bf16(dq[nd + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with tile j before its buffers refill
  }
  cp_async_wait<0>();  // no copy is left in flight when the block exits

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + ((long long)b * p.T * p.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.T) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dqg + (long long)rows[r] * p.H * D + nd * 8 + 2 * t) =
          pack_bf16(dq[nd][2 * r] * p.scale, dq[nd][2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------- dK/dV, bf16

template <int D>
constexpr int dkv_bf16_smem_bytes() {
  // K, V [64][S]; two stages of Q, dO [32][S]; two stages of LSE, delta [32]
  return 2 * KV_BK * (D + 8) * 2 + 4 * KV_BQ * (D + 8) * 2 + 4 * KV_BQ * 4;
}

// Each warp owns 16 keys and computes the transposed scores S^T = K Q^T and
// dP^T = V dO^T of its keys against a 32-row query tile, so that P^T and
// dS^T come out as A fragments of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(128) bwd_dkv_bf16(const Params p) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const Vs = Ks + KV_BK * S;
  __nv_bfloat16* const qdo = Vs + KV_BK * S;  // stage s: Q at 2s, dO at 2s + 1
  float* const stats = reinterpret_cast<float*>(qdo + 4 * KV_BQ * S);  // stage s: LSE, delta
  auto q_buf = [&](int j) { return qdo + 2 * (j & 1) * KV_BQ * S; };
  auto do_buf = [&](int j) { return qdo + (2 * (j & 1) + 1) * KV_BQ * S; };
  auto lse_buf = [&](int j) { return stats + 2 * (j & 1) * KV_BQ; };
  auto delta_buf = [&](int j) { return stats + (2 * (j & 1) + 1) * KV_BQ; };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * KV_BK;  // under causal the first key tiles see the most queries
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pad = p.pad ? p.pad[b] : 0;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lseg = p.lse + (long long)bh * p.T;
  const float* deltag = p.delta + (long long)bh * p.T;

  // query rows before this block's first key see none of its keys under causal
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = q_start < p.T ? (p.T - q_start + KV_BQ - 1) / KV_BQ : 0;

  auto load_q_tile = [&](int j) {
    const int qt0 = q_start + j * KV_BQ;
    load_tile_async<KV_BQ, D>(q_buf(j), qg, p.q_st, qt0, p.T);
    load_tile_async<KV_BQ, D>(do_buf(j), dog, p.do_st, qt0, p.T);
    if (tid < KV_BQ) {
      const int row = qt0 + tid;
      lse_buf(j)[tid] = row < p.T ? lseg[row] : 0.f;
      delta_buf(j)[tid] = row < p.T ? deltag[row] : 0.f;
    }
  };

  load_tile_async<KV_BK, D>(Ks, kg, p.k_st, k0, p.Tkv);
  load_tile_async<KV_BK, D>(Vs, vg, p.v_st, k0, p.Tkv);
  if (n_tiles > 0) load_q_tile(0);
  cp_async_commit();

  const int kr0 = warp * 16;
  const int keys[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int qt0 = q_start + j * KV_BQ;
    const __nv_bfloat16* Qs = q_buf(j);
    const __nv_bfloat16* dOs = do_buf(j);
    const float* lse = lse_buf(j);
    const float* delta = delta_buf(j);
    if (j + 1 < n_tiles) load_q_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and K, V) have landed; tile j + 1 may be in flight
    __syncthreads();

    float st[KV_BQ / 8][4], dpt[KV_BQ / 8][4];
#pragma unroll
    for (int nb = 0; nb < KV_BQ / 8; ++nb) {
      st[nb][0] = st[nb][1] = st[nb][2] = st[nb][3] = 0.f;
      dpt[nb][0] = dpt[nb][1] = dpt[nb][2] = dpt[nb][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, Ks, S, kr0, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < KV_BQ / 8; ++nb) {
        const __nv_bfloat16* qp = Qs + (nb * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(st[nb], a, ld32(qp), ld32(qp + 8));
      }
      load_a_frag(a, Vs, S, kr0, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < KV_BQ / 8; ++nb) {
        const __nv_bfloat16* dop = dOs + (nb * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(dpt[nb], a, ld32(dop), ld32(dop + 8));
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int nb = 0; nb < KV_BQ / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + 2 * t + (e & 1), row = qt0 + col, key = keys[e >> 1];
        const float pe = row < p.T && mask_ok(row, key, p.Tkv, pad, p.causal)
                             ? expf(st[nb][e] * p.scale - lse[col])
                             : 0.f;
        st[nb][e] = pe;
        dpt[nb][e] = pe * (dpt[nb][e] - delta[col]);
      }
    }
    // dV += P^T dO and dK += dS^T Q (both bf16 A operands)
#pragma unroll
    for (int ks = 0; ks < KV_BQ / 16; ++ks) {
      const uint32_t ap[4] = {pack_bf16(st[2 * ks][0], st[2 * ks][1]),
                              pack_bf16(st[2 * ks][2], st[2 * ks][3]),
                              pack_bf16(st[2 * ks + 1][0], st[2 * ks + 1][1]),
                              pack_bf16(st[2 * ks + 1][2], st[2 * ks + 1][3])};
      const uint32_t ads[4] = {pack_bf16(dpt[2 * ks][0], dpt[2 * ks][1]),
                               pack_bf16(dpt[2 * ks][2], dpt[2 * ks][3]),
                               pack_bf16(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]),
                               pack_bf16(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t fb[4];
        load_b_frags_trans(fb, dOs, S, ks * 16, nd, lane);
        mma_bf16(dv[nd], ap, fb[0], fb[1]);
        mma_bf16(dv[nd + 1], ap, fb[2], fb[3]);
        load_b_frags_trans(fb, Qs, S, ks * 16, nd, lane);
        mma_bf16(dk[nd], ads, fb[0], fb[1]);
        mma_bf16(dk[nd + 1], ads, fb[2], fb[3]);
      }
    }
    __syncthreads();  // every warp is done with tile j before its buffers refill
  }
  cp_async_wait<0>();

  const long long out_off = ((long long)b * p.Tkv * p.H + h) * D;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + out_off;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + out_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.Tkv) continue;
    const long long row_off = (long long)keys[r] * p.H * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = nd * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + row_off + c) =
          pack_bf16(dk[nd][2 * r] * p.scale, dk[nd][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + row_off + c) = pack_bf16(dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- dQ, fp32

template <int D>
constexpr int dq_f32_smem_bytes() {
  return 2 * DQ_BK * D * 4;  // K, V
}

template <int D>
__global__ void __launch_bounds__(256) bwd_dq_f32(const Params p) {
  constexpr int DP = D / 4;  // elements of d_head per thread: part, part + 4, ...
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [BK][D]
  float* Vs = Ks + DQ_BK * D;                  // [BK][D]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = q0 + (tid >> 2);
  const bool live = row < p.T;
  const int pad = p.pad ? p.pad[b] : 0;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;

  float q[DP], dout[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    q[i] = live ? qg[row * p.q_st + 4 * i + part] : 0.f;
    dout[i] = live ? dog[row * p.do_st + 4 * i + part] : 0.f;
    acc[i] = 0.f;
  }
  const float lse = live ? p.lse[(long long)bh * p.T + row] : 0.f;
  const float delta = live ? p.delta[(long long)bh * p.T + row] : 0.f;

  const int kv_end = p.causal ? min(p.Tkv, q0 + DQ_BQ) : p.Tkv;
  for (int k0 = 0; k0 < kv_end; k0 += DQ_BK) {
    __syncthreads();
    for (int i = tid; i < DQ_BK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Tkv;
      Ks[i] = in ? kg[(k0 + r) * p.k_st + c] : 0.f;
      Vs[i] = in ? vg[(k0 + r) * p.v_st + c] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < DQ_BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(q[i], Ks[j * D + 4 * i + part], s);
        dp = fmaf(dout[i], Vs[j * D + 4 * i + part], dp);
      }
      // the four partial sums meet in the same order on every lane of the quad
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float pe = mask_ok(row, k0 + j, p.Tkv, pad, p.causal) ? expf(s * p.scale - lse) : 0.f;
      const float ds = pe * (dp - delta);
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(ds, Ks[j * D + 4 * i + part], acc[i]);
    }
  }

  if (live) {
    float* dqg = static_cast<float*>(p.dq) + (((long long)b * p.T + row) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) dqg[4 * i + part] = acc[i] * p.scale;
  }
}

// ---------------------------------------------------------- dK/dV, fp32

template <int D>
constexpr int dkv_f32_smem_bytes() {
  return 2 * KV_BQ32 * D * 4 + 2 * KV_BQ32 * 4;  // Q, dO, LSE, delta
}

template <int D>
__global__ void __launch_bounds__(256) bwd_dkv_f32(const Params p) {
  constexpr int DP = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ][D]
  float* dOs = Qs + KV_BQ32 * D;               // [BQ][D]
  float* lse_s = dOs + KV_BQ32 * D;            // [BQ]
  float* delta_s = lse_s + KV_BQ32;            // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * KV_BK;
  const int tid = threadIdx.x, part = tid & 3;
  const int key = k0 + (tid >> 2);
  const bool live = key < p.Tkv;
  const int pad = p.pad ? p.pad[b] : 0;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lseg = p.lse + (long long)bh * p.T;
  const float* deltag = p.delta + (long long)bh * p.T;

  float k[DP], v[DP], dk[DP], dv[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    k[i] = live ? kg[key * p.k_st + 4 * i + part] : 0.f;
    v[i] = live ? vg[key * p.v_st + 4 * i + part] : 0.f;
    dk[i] = dv[i] = 0.f;
  }

  for (int qt0 = p.causal ? k0 : 0; qt0 < p.T; qt0 += KV_BQ32) {
    __syncthreads();
    for (int i = tid; i < KV_BQ32 * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = qt0 + r < p.T;
      Qs[i] = in ? qg[(qt0 + r) * p.q_st + c] : 0.f;
      dOs[i] = in ? dog[(qt0 + r) * p.do_st + c] : 0.f;
    }
    if (tid < KV_BQ32) {
      const bool in = qt0 + tid < p.T;
      lse_s[tid] = in ? lseg[qt0 + tid] : 0.f;
      delta_s[tid] = in ? deltag[qt0 + tid] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < KV_BQ32; ++j) {
      const int row = qt0 + j;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(k[i], Qs[j * D + 4 * i + part], s);
        dp = fmaf(v[i], dOs[j * D + 4 * i + part], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float pe = row < p.T && mask_ok(row, key, p.Tkv, pad, p.causal)
                           ? expf(s * p.scale - lse_s[j])
                           : 0.f;
      const float ds = pe * (dp - delta_s[j]);
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dv[i] = fmaf(pe, dOs[j * D + 4 * i + part], dv[i]);
        dk[i] = fmaf(ds, Qs[j * D + 4 * i + part], dk[i]);
      }
    }
  }

  if (live) {
    const long long off = (((long long)b * p.Tkv + key) * p.H + h) * D;
    float* dkg = static_cast<float*>(p.dk) + off;
    float* dvg = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      dkg[4 * i + part] = dk[i] * p.scale;
      dvg[4 * i + part] = dv[i];
    }
  }
}

// -------------------------------------------------------------- dispatch

// f(std::integral_constant<int, D>) for the d_head instances there are
template <typename F>
cudaError_t by_d_head(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* pad, void* dq, void* dk,
                   void* dv, int B, int T, int Tkv, int H, const long long* st, float scale,
                   int causal) {
  return Params{q,      k,      v,      dout,   static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<const int*>(pad),
                dq,     dk,     dv,     B,      T,      Tkv,    H,
                st[0],  st[1],  st[2],  st[3],  st[4],  st[5],  st[6],
                st[7],  st[8],  st[9],  st[10], st[11], scale,  causal};
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() after
// the launch (0 on success).  Pointers are device pointers.  q, k, v and dO
// are read through their strides (in elements; unit stride along d_head,
// 16-byte-aligned rows for bf16); lse and delta are contiguous [B, H, T]
// fp32; outputs are contiguous [B, T(_kv), H, D] in the inputs' dtype.
// `strides` (host memory) holds q's, k's, v's and dO's (batch, time, head)
// strides in that order.  The caller checks shapes, dtypes and alignment.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* pad, void* dq,
                            int B, int T, int Tkv, int H, int D, int is_bf16,
                            const long long* strides, float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, pad, dq, nullptr, nullptr, B, T, Tkv,
                               H, strides, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (T + DQ_BQ - 1) / DQ_BQ);
  return by_d_head(D, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    if (is_bf16) return launch_kernel(bwd_dq_bf16<DH>, grid, 128, dq_bf16_smem_bytes<DH>(), p, st);
    return launch_kernel(bwd_dq_f32<DH>, grid, 256, dq_f32_smem_bytes<DH>(), p, st);
  });
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* pad, void* dk,
                             void* dv, int B, int T, int Tkv, int H, int D, int is_bf16,
                             const long long* strides, float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, pad, nullptr, dk, dv, B, T, Tkv, H,
                               strides, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (Tkv + KV_BK - 1) / KV_BK);
  return by_d_head(D, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    if (is_bf16) return launch_kernel(bwd_dkv_bf16<DH>, grid, 128, dkv_bf16_smem_bytes<DH>(), p, st);
    return launch_kernel(bwd_dkv_f32<DH>, grid, 256, dkv_f32_smem_bytes<DH>(), p, st);
  });
}
