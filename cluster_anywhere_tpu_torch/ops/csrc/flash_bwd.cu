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
// predicate, never by the score's value, so a fully masked row (LSE =
// -1e30) gets no gradient, and rows or keys that a tile load zero-filled
// past T or T_kv contribute nothing.
//
// As in the JAX package, the work is split so that no block carries a sum
// into another: a dQ block owns query rows and loops over key tiles (up to
// the diagonal under causal); a dK/dV block owns keys and loops over query
// tiles (from its first key on under causal).  There are no atomics, so the
// gradients are the same bits from run to run.  Every output row is
// written, zeros where nothing contributes.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the flagship
// training shape (B 8, T 1024, H 8 after the GQA repeat, D 128, bf16,
// causal): 5 products of 2 D flops per causal (query, key) pair, 42.99
// GFLOP or 43.5 us of tensor-core work, against 134.5 MB of q, k, v, O,
// dO, LSE read and dQ, dK, dV written, 40.1 us of memory traffic: bound by
// operations.  The split computes 7 products, not 5 (the dQ kernel
// recomputes S and dP), a floor of 61 us.
//
// bf16 at D 64 and 128 (every training step): the Hopper design.
//   * Products on the tensor cores by wgmma (a warpgroup of 128 threads
//     issues m64nNk16 asynchronously): S = Q K^T and dP = dO V^T with both
//     operands K-major in shared memory; dV += P^T dO, dK += dS^T Q and
//     dQ += dS K with P^T, dS^T or dS as the register A operand, straight
//     from the fp32 accumulator rounded to bf16 (as FA2 does), and B read
//     MN-major from the same shared tile (flash_sm90.cuh has the
//     descriptor conventions).  The [T, T_kv] scores never leave registers.
//   * Warp specialisation, 384 threads a block: two consumer warpgroups
//     (threads 0-255) compute, one producer warp (the first of warpgroup 2)
//     keeps TMA loads in flight, and setmaxnreg moves registers from the
//     producer warpgroup (24 a thread) to the consumers (240 a thread).
//   * A TMA ring of HOP_STAGES stages, each with a full and an empty
//     mbarrier: tiles arrive by TMA in 64-column boxes with 128-byte swizzle
//     through tensor maps over the [B, T, H, D] strides (encoded on the host
//     per call), rows past T or T_kv zero-filled.
//   * dK/dV: a block owns 128 keys of one (b, h), 64 per consumer
//     warpgroup; K and V come in once; 64-row Q and dO tiles stream through
//     the ring with their LSE (times log2 e) and delta, which the producer
//     warp stores beside them.  Each warpgroup computes S^T = K Q^T and
//     dP^T = V dO^T (m64n64), so P^T and dS^T come out as A operands of
//     dV and dK (m64nD), and skips tiles its keys cannot see under causal.
//     Per consumer thread at D 128: dK and dV, 2 x 64 fp32 accumulators,
//     S^T and dP^T 2 x 32.  Shared memory at D 128: K, V 64 KB, each stage
//     32.5 KB, 130 KB a block: one block an SM.
//   * dQ: a block owns 128 query rows, 64 per consumer warpgroup; Q and dO
//     come in once; 64-key K and V tiles stream through the ring up to the
//     diagonal.  Per consumer thread at D 128: dQ 64 fp32 accumulators, S
//     and dP 2 x 32.  Shared memory at D 128: Q, dO 64 KB, each stage 32 KB,
//     129 KB a block.
//   * Blocks run in groups of 16 (b, h) pairs, the causally longest first
//     within a group, so that the tiles the blocks in flight re-read stay
//     in L2 (block_coords).
//   * dV's product is issued before dS^T is computed, so that the tensor
//     cores work while the CUDA cores compute.
//   * What bounds it now (PERF.md, scripts/torch_flash_bwd_ablation.py):
//     the tile stream of the split design.  With every product and the
//     softmax taken out, the kernels still take about two thirds of their
//     time; a deeper ring or half the bytes per stage barely change that.
// bf16 at D 16 and 32: four warps of mma.sync m16n8k16 with cp.async double
//   buffering (the first port's design): their 32- and 64-byte rows would
//   need other swizzle modes, and no main path runs them.
// fp32, every D: CUDA-core FMAs in full fp32 (never TF32), four threads per
//   row, each holding every fourth element of d_head.  No main path runs
//   them either: training is bf16.
// D (d_head) is a template argument: 16, 32, 64 or 128.

#include <type_traits>

#include "flash_sm90.cuh"

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

// ------------------------------------------ bf16, D 64 and 128: Hopper

constexpr int HOP_THREADS = 3 * WG_THREADS;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int HOP_CONSUMER_WARPS = 8;
constexpr int HOP_STAGES = 2;    // ring depth
constexpr int HKV_KEYS = 128;    // dK/dV: keys per block, 64 per consumer warpgroup
constexpr int HKV_ROWS = 64;     // dK/dV: query rows per ring stage
constexpr int HQ_ROWS = 128;     // dQ: query rows per block, 64 per consumer warpgroup
constexpr int HQ_KEYS = 64;      // dQ: keys per ring stage

// The inputs' maps, and the outputs' (dQ; or dK and dV) in 64-row boxes.
struct TmaMaps {
  CUtensorMap q, k, v, dout, out0, out1;
};

// 1024 bytes of slack let the kernel align its tiles to the 128-byte
// swizzle's 1024-byte period.
template <int D>
constexpr int dkv_wgmma_smem_bytes() {
  // K, V [128, D]; per stage Q, dO [64, D] and LSE, delta [64] fp32; the
  // full and empty barrier of each stage and K/V's barrier
  return 2 * HKV_KEYS * D * 2 + HOP_STAGES * (2 * HKV_ROWS * D * 2 + 2 * HKV_ROWS * 4) +
         8 * (2 * HOP_STAGES + 1) + 1024;
}

template <int D>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    bwd_dkv_bf16_wgmma(const Params p, const __grid_constant__ TmaMaps maps) {
  constexpr int NB = D / 64;  // 64-column boxes a row
  constexpr uint32_t KV_TILE = HKV_KEYS * D * 2, Q_TILE = HKV_ROWS * D * 2;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sk = (raw + 1023) & ~1023u, sv = sk + KV_TILE;
  const uint32_t ring = sv + KV_TILE;  // stage s: Q at ring + 2 s Q_TILE, dO after it
  const uint32_t stats_at = ring + HOP_STAGES * 2 * Q_TILE;
  // stage s: LSE * log2(e) at [128 s, 128 s + 64), delta at [128 s + 64, 128 s + 128)
  float* const stats = reinterpret_cast<float*>(smem + (stats_at - raw));
  const uint32_t bars = stats_at + HOP_STAGES * 2 * HKV_ROWS * 4;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (HOP_STAGES + s); };
  const uint32_t kv_bar = bars + 16 * HOP_STAGES;

  int bh, y;
  block_coords(p.B * p.H, (p.Tkv + HKV_KEYS - 1) / HKV_KEYS, bh, y);
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = y * HKV_KEYS;  // under causal the first key blocks see the most queries
  // query rows before this block's first key see none of its keys under causal
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = q_start < p.T ? (p.T - q_start + HKV_ROWS - 1) / HKV_ROWS : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HOP_STAGES; ++s) {
      mbar_init(full(s), 32);                    // the producer warp's lanes
      mbar_init(empty(s), HOP_CONSUMER_WARPS);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG_THREADS) {
    // producer warpgroup: its first warp loads, the other three are done
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x >= 2 * WG_THREADS + 32 || n_tiles == 0) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * KV_TILE);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(sk + nb * HKV_KEYS * 128, &maps.k, kv_bar, 64 * nb, h, k0, b);
        tma_load_4d(sv + nb * HKV_KEYS * 128, &maps.v, kv_bar, 64 * nb, h, k0, b);
      }
    }
    const float* lseg = p.lse + (long long)bh * p.T;
    const float* deltag = p.delta + (long long)bh * p.T;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % HOP_STAGES, qt0 = q_start + j * HKV_ROWS;
      mbar_wait(empty(s), ((j / HOP_STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t sq = ring + 2 * s * Q_TILE;
        mbar_expect_tx(full(s), 2 * Q_TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(sq + nb * HKV_ROWS * 128, &maps.q, full(s), 64 * nb, h, qt0, b);
          tma_load_4d(sq + Q_TILE + nb * HKV_ROWS * 128, &maps.dout, full(s), 64 * nb, h, qt0, b);
        }
      }
      float* const st = stats + s * 2 * HKV_ROWS;
      for (int i = lane; i < HKV_ROWS; i += 32) {
        const int row = qt0 + i;
        const bool in = row < p.T;
        st[i] = in ? lseg[row] * LOG2E : 0.f;
        st[HKV_ROWS + i] = in ? deltag[row] : 0.f;
      }
      mbar_arrive(full(s));  // releases the stats stored above
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
    const int pad = p.pad ? p.pad[b] : 0;
    const bool keys_live = kw0 < p.Tkv && kw0 + 64 > pad;
    const float scale_log2 = p.scale * LOG2E;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (n_tiles > 0) mbar_wait(kv_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % HOP_STAGES, qt0 = q_start + j * HKV_ROWS;
      const uint32_t sq = ring + 2 * s * Q_TILE, sdo = sq + Q_TILE;
      mbar_wait(full(s), (j / HOP_STAGES) & 1);
      // under causal, rows before this warpgroup's first key see none of its keys
      if (keys_live && (!p.causal || qt0 + HKV_ROWS > kw0)) {
        // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 rows
        float st[32], dpt[32];
        wgmma_fence();
        wgmma_m64n64k16_ss_init(st, kmajor_desc<HKV_KEYS>(sk, 64 * wg, 0),
                                kmajor_desc<HKV_ROWS>(sq, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss(st, kmajor_desc<HKV_KEYS>(sk, 64 * wg, kk),
                             kmajor_desc<HKV_ROWS>(sq, 0, kk));
        wgmma_commit();
        wgmma_m64n64k16_ss_init(dpt, kmajor_desc<HKV_KEYS>(sv, 64 * wg, 0),
                                kmajor_desc<HKV_ROWS>(sdo, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss(dpt, kmajor_desc<HKV_KEYS>(sv, 64 * wg, kk),
                             kmajor_desc<HKV_ROWS>(sdo, 0, kk));
        wgmma_commit();
        const float* const lse = stats + s * 2 * HKV_ROWS;
        const float* const delta = lse + HKV_ROWS;

        // P^T in place of S^T, while dP^T may still be in flight
        wgmma_wait<1>();
        wgmma_fence_operand(st);
        // a tile that no mask reaches (most tiles of a long causal
        // sequence) skips the predicate
        if (qt0 + HKV_ROWS <= p.T && kw0 + 64 <= p.Tkv && kw0 >= pad &&
            (!p.causal || qt0 >= kw0 + 63)) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            st[i] = exp2_approx(st[i] * scale_log2 - lse[col64(i, t)]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = col64(i, t), row = qt0 + col;
            const int key = kw0 + 16 * warp + g + 8 * row_half(i);
            st[i] = row < p.T && mask_ok(row, key, p.Tkv, pad, p.causal)
                        ? exp2_approx(st[i] * scale_log2 - lse[col])
                        : 0.f;
          }
        }
        // dV += P^T dO, P^T from registers, while dS^T is computed
        uint32_t ap[4][4], ads[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_a_frag(ap[ks], st, ks);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_rs<D>(dv, ap[ks], mnmajor_desc<HKV_ROWS>(sdo, ks));
        wgmma_commit();

        // dS^T in place of dP^T (with at most dV's group pending, dP^T's is done)
        wgmma_wait<1>();
        wgmma_fence_operand(dpt);
#pragma unroll
        for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - delta[col64(i, t)]);

        // dK += dS^T Q, dS^T from registers
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_a_frag(ads[ks], dpt, ks);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_rs<D>(dk, ads[ks], mnmajor_desc<HKV_ROWS>(sq, ks));
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand(dv);
        wgmma_fence_operand(dk);
        wgmma_fence_operand(ap);
        wgmma_fence_operand(ads);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    // dK and dV leave through this warpgroup's own K and V rows, which no
    // product reads any more, by TMA stores (rows past T_kv not written)
    if (kw0 >= p.Tkv) return;
    const uint32_t dk_tile = sk + 64 * wg * 128, dv_tile = sv + 64 * wg * 128;
    acc_to_tma_tile<D>(dk_tile, HKV_KEYS * 128, dk, {p.scale, p.scale}, warp, g, t);
    acc_to_tma_tile<D>(dv_tile, HKV_KEYS * 128, dv, {1.f, 1.f}, warp, g, t);
    fence_proxy_async_smem();
    named_barrier_sync(1 + wg, WG_THREADS);
    if (tid == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_store_4d(&maps.out0, dk_tile + nb * HKV_KEYS * 128, 64 * nb, h, kw0, b);
        tma_store_4d(&maps.out1, dv_tile + nb * HKV_KEYS * 128, 64 * nb, h, kw0, b);
      }
      tma_store_wait();
    }
  }
}

template <int D>
constexpr int dq_wgmma_smem_bytes() {
  // Q, dO [128, D]; per stage K, V [64, D]; the full and empty barrier of
  // each stage and Q/dO's barrier
  return 2 * HQ_ROWS * D * 2 + HOP_STAGES * 2 * HQ_KEYS * D * 2 + 8 * (2 * HOP_STAGES + 1) + 1024;
}

template <int D>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    bwd_dq_bf16_wgmma(const Params p, const __grid_constant__ TmaMaps maps) {
  constexpr int NB = D / 64;
  constexpr uint32_t Q_TILE = HQ_ROWS * D * 2, K_TILE = HQ_KEYS * D * 2;
  extern __shared__ unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u, sdo = sq + Q_TILE;
  const uint32_t ring = sdo + Q_TILE;  // stage s: K at ring + 2 s K_TILE, V after it
  const uint32_t bars = ring + HOP_STAGES * 2 * K_TILE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (HOP_STAGES + s); };
  const uint32_t q_bar = bars + 16 * HOP_STAGES;

  const int n_y = (p.T + HQ_ROWS - 1) / HQ_ROWS;
  int bh, y;
  block_coords(p.B * p.H, n_y, bh, y);
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (n_y - 1 - y) * HQ_ROWS;  // under causal the last query blocks see the most keys
  const int kv_end = p.causal ? min(p.Tkv, q0 + HQ_ROWS) : p.Tkv;
  const int n_tiles = (kv_end + HQ_KEYS - 1) / HQ_KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HOP_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), HOP_CONSUMER_WARPS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG_THREADS) {
    // producer warpgroup: one thread issues every load, the others are done
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 2 * WG_THREADS) return;
    mbar_arrive_expect_tx(q_bar, 2 * Q_TILE);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(sq + nb * HQ_ROWS * 128, &maps.q, q_bar, 64 * nb, h, q0, b);
      tma_load_4d(sdo + nb * HQ_ROWS * 128, &maps.dout, q_bar, 64 * nb, h, q0, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % HOP_STAGES;
      const uint32_t sk = ring + 2 * s * K_TILE;
      mbar_wait(empty(s), ((j / HOP_STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(full(s), 2 * K_TILE);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(sk + nb * HQ_KEYS * 128, &maps.k, full(s), 64 * nb, h, j * HQ_KEYS, b);
        tma_load_4d(sk + K_TILE + nb * HQ_KEYS * 128, &maps.v, full(s), 64 * nb, h, j * HQ_KEYS, b);
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + 64 * wg;  // this warpgroup's first query row
    const int pad = p.pad ? p.pad[b] : 0;
    const float scale_log2 = p.scale * LOG2E;
    const int rows[2] = {qw0 + 16 * warp + g, qw0 + 16 * warp + g + 8};
    float lse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < p.T;
      lse[r] = in ? p.lse[(long long)bh * p.T + rows[r]] * LOG2E : 0.f;
      delta[r] = in ? p.delta[(long long)bh * p.T + rows[r]] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % HOP_STAGES, kt0 = j * HQ_KEYS;
      const uint32_t sk = ring + 2 * s * K_TILE, sv = sk + K_TILE;
      mbar_wait(full(s), (j / HOP_STAGES) & 1);
      // a tile this warpgroup's rows cannot see: past the diagonal under
      // causal, or wholly below the pad
      if (qw0 < p.T && (!p.causal || kt0 < qw0 + 64) && kt0 + HQ_KEYS > pad) {
        // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows x 64 keys
        float sc[32], dp[32];
        wgmma_fence();
        wgmma_m64n64k16_ss_init(sc, kmajor_desc<HQ_ROWS>(sq, 64 * wg, 0),
                                kmajor_desc<HQ_KEYS>(sk, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss(sc, kmajor_desc<HQ_ROWS>(sq, 64 * wg, kk),
                             kmajor_desc<HQ_KEYS>(sk, 0, kk));
        wgmma_commit();
        wgmma_m64n64k16_ss_init(dp, kmajor_desc<HQ_ROWS>(sdo, 64 * wg, 0),
                                kmajor_desc<HQ_KEYS>(sv, 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss(dp, kmajor_desc<HQ_ROWS>(sdo, 64 * wg, kk),
                             kmajor_desc<HQ_KEYS>(sv, 0, kk));
        wgmma_commit();

        // P in place of S, while dP may still be in flight
        wgmma_wait<1>();
        wgmma_fence_operand(sc);
        // a tile that no mask reaches (most tiles of a long causal
        // sequence) skips the predicate
        if (kt0 + HQ_KEYS <= p.Tkv && kt0 >= pad && (!p.causal || qw0 >= kt0 + HQ_KEYS - 1)) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = exp2_approx(sc[i] * scale_log2 - lse[row_half(i)]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = row_half(i);
            sc[i] = mask_ok(rows[r], kt0 + col64(i, t), p.Tkv, pad, p.causal)
                        ? exp2_approx(sc[i] * scale_log2 - lse[r])
                        : 0.f;
          }
        }
        // dS in place of dP
        wgmma_wait<0>();
        wgmma_fence_operand(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - delta[row_half(i)]);

        // dQ += dS K, dS from registers
        uint32_t ads[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_a_frag(ads[ks], dp, ks);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_rs<D>(dq, ads[ks], mnmajor_desc<HQ_KEYS>(sk, ks));
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand(dq);
        wgmma_fence_operand(ads);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    // dQ leaves through this warpgroup's own Q rows, which no product
    // reads any more, by TMA stores (rows past T not written)
    if (qw0 >= p.T) return;
    const uint32_t dq_tile = sq + 64 * wg * 128;
    acc_to_tma_tile<D>(dq_tile, HQ_ROWS * 128, dq, {p.scale, p.scale}, warp, g, t);
    fence_proxy_async_smem();
    named_barrier_sync(1 + wg, WG_THREADS);
    if (tid == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_store_4d(&maps.out0, dq_tile + nb * HQ_ROWS * 128, 64 * nb, h, qw0, b);
      tma_store_wait();
    }
  }
}

// Tiles of the mma.sync (bf16, D 16 and 32) and fp32 instances
constexpr int DQ_BQ = 64;   // dQ: query rows per block
constexpr int DQ_BK = 64;   // dQ: keys per shared tile
constexpr int KV_BK = 64;   // dK/dV: keys per block
constexpr int KV_BQ = 32;   // dK/dV, bf16: query rows per shared tile
constexpr int KV_BQ32 = 64; // dK/dV, fp32: query rows per shared tile

// ------------------------------------ bf16, D 16 and 32: mma.sync, dQ

template <int D>
constexpr int dq_bf16_smem_bytes() {
  return 6 * DQ_BK * (D + 8) * 2;  // Q, dO, K0, V0, K1, V1
}

template <int D>
__global__ void __launch_bounds__(128) bwd_dq_bf16_mma(const Params p) {
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

// ---------------------------------- bf16, D 16 and 32: mma.sync, dK/dV

template <int D>
constexpr int dkv_bf16_smem_bytes() {
  // K, V [64][S]; two stages of Q, dO [32][S]; two stages of LSE, delta [32]
  return 2 * KV_BK * (D + 8) * 2 + 4 * KV_BQ * (D + 8) * 2 + 4 * KV_BQ * 4;
}

// Each warp owns 16 keys and computes the transposed scores S^T = K Q^T and
// dP^T = V dO^T of its keys against a 32-row query tile, so that P^T and
// dS^T come out as A fragments of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(128) bwd_dkv_bf16_mma(const Params p) {
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

// The TMA maps of q, k, v and dO (through their strides), in boxes of
// `q_rows` rows for q and dO and `kv_rows` rows for k and v, and of the
// contiguous outputs in 64-row boxes: dQ ([B, T, H, D]) when p.dq is set,
// else dK and dV ([B, T_kv, H, D]).
bool make_maps(TmaMaps* maps, const Params& p, int D, int q_rows, int kv_rows) {
  const long long hd = (long long)p.H * D;
  const bool inputs =
      make_bthd_map(&maps->q, p.q, p.B, p.T, p.H, D, p.q_sb, p.q_st, p.q_sh, q_rows) &&
      make_bthd_map(&maps->k, p.k, p.B, p.Tkv, p.H, D, p.k_sb, p.k_st, p.k_sh, kv_rows) &&
      make_bthd_map(&maps->v, p.v, p.B, p.Tkv, p.H, D, p.v_sb, p.v_st, p.v_sh, kv_rows) &&
      make_bthd_map(&maps->dout, p.dout, p.B, p.T, p.H, D, p.do_sb, p.do_st, p.do_sh, q_rows);
  if (!inputs) return false;
  if (p.dq != nullptr)
    return make_bthd_map(&maps->out0, p.dq, p.B, p.T, p.H, D, p.T * hd, hd, D, 64);
  return make_bthd_map(&maps->out0, p.dk, p.B, p.Tkv, p.H, D, p.Tkv * hd, hd, D, 64) &&
         make_bthd_map(&maps->out1, p.dv, p.B, p.Tkv, p.H, D, p.Tkv * hd, hd, D, 64);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue where the driver
// refuses a TMA map.  Pointers are device pointers.  q, k, v and dO are
// read through their strides (in elements; unit stride along d_head,
// 16-byte-aligned rows and base); lse and delta are contiguous [B, H, T]
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
  return by_d_head(D, [&](auto d) -> cudaError_t {
    constexpr int DH = decltype(d)::value;
    const dim3 grid(B * H, ceil_div(T, DQ_BQ));
    if (!is_bf16) return launch_kernel(bwd_dq_f32<DH>, grid, 256, dq_f32_smem_bytes<DH>(), st, p);
    if constexpr (DH < 64) {
      return launch_kernel(bwd_dq_bf16_mma<DH>, grid, 128, dq_bf16_smem_bytes<DH>(), st, p);
    } else {
      TmaMaps maps{};
      if (!make_maps(&maps, p, DH, HQ_ROWS, HQ_KEYS)) return cudaErrorInvalidValue;
      return launch_kernel(bwd_dq_bf16_wgmma<DH>, dim3(B * H * ceil_div(T, HQ_ROWS)), HOP_THREADS,
                           dq_wgmma_smem_bytes<DH>(), st, p, maps);
    }
  });
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* pad, void* dk,
                             void* dv, int B, int T, int Tkv, int H, int D, int is_bf16,
                             const long long* strides, float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, pad, nullptr, dk, dv, B, T, Tkv, H,
                               strides, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_d_head(D, [&](auto d) -> cudaError_t {
    constexpr int DH = decltype(d)::value;
    const dim3 grid(B * H, ceil_div(Tkv, KV_BK));
    if (!is_bf16) return launch_kernel(bwd_dkv_f32<DH>, grid, 256, dkv_f32_smem_bytes<DH>(), st, p);
    if constexpr (DH < 64) {
      return launch_kernel(bwd_dkv_bf16_mma<DH>, grid, 128, dkv_bf16_smem_bytes<DH>(), st, p);
    } else {
      TmaMaps maps{};
      if (!make_maps(&maps, p, DH, HKV_ROWS, HKV_KEYS)) return cudaErrorInvalidValue;
      return launch_kernel(bwd_dkv_bf16_wgmma<DH>, dim3(B * H * ceil_div(Tkv, HKV_KEYS)),
                           HOP_THREADS, dkv_wgmma_smem_bytes<DH>(), st, p, maps);
    }
  });
}
