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
// edge of a tile is masked here.  No atomics: the same bits on every call.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//   * serving prefill (B 8, T 512, H 8, D 128, bf16, causal, the rows
//     left-padded to 128..512 live tokens): the output depends only on the
//     live q, k, v rows, 15.7 MB, plus 8.5 MB of O and LSE written, about
//     7.2 us, against 1.9 GFLOP of causal products among live tokens, about
//     2 us: bound by bytes.
//   * training (B 8, T 1024, H 8, D 128, bf16, causal, no pad, LSE
//     returned): q, k, v and O are 67.1 MB and LSE 0.26 MB, 20.1 us,
//     against 17.2 GFLOP, 17.4 us: bound by bytes, nearly balanced.  P's
//     hi + lo split (below) makes the tensor-core work 1.5x, 26 us at peak.
//
// bf16 at D 64 and 128 (every launch of the serving and training paths):
// the Hopper design.
//   * A block owns 128 query rows of one (b, h): two consumer warpgroups of
//     64 rows each (threads 0-255) compute, one producer warp (the first of
//     warpgroup 2) issues every TMA load, and setmaxnreg moves registers
//     from the producer warpgroup (24 a thread) to the consumers (240).
//   * Q comes in once by TMA.  K and V stream through a ring of FWD_STAGES
//     stages of 64 keys, K and V with a full and an empty mbarrier each, K
//     one tile ahead of V: tile j's K is needed with tile j - 1's V.  Tiles
//     arrive in 64-column boxes with 128-byte swizzle through tensor maps
//     over the [B, T, H, D] strides (encoded on the host per call); rows
//     past T or T_kv are zero-filled, which gives a score of 0, so the
//     predicate still masks the ragged edge.
//   * S = Q K^T is an SS wgmma (m64n64, Q and K K-major); P V is an RS
//     wgmma (m64nD, P from registers, V MN-major from the same tile).  P
//     enters as hi + lo bf16 parts, two products a tile into the same fp32
//     O, so it keeps ~16 bits as the reference's fp32 P does: P rounded to
//     bf16 once flipped a flagship greedy token against the fp32 plain
//     version.
//   * Tile j's S and tile j - 1's P V are issued together, so that the
//     tensor cores run P V while the warpgroup computes tile j's softmax;
//     O is rescaled, and P becomes A fragments, once P V is done (FA3's
//     intra-warpgroup overlap).  The first and last tiles are peeled, so
//     that the steady loop issues and waits without a branch: with a branch
//     between a wgmma and its wait, ptxas waits after every wgmma.
//   * Online softmax in fp32 registers in base 2: scale * log2(e) folded
//     into the scores, 2^x by ex2.approx.  A tile that no mask reaches
//     (inside T_kv, past the pad, below the diagonal for all 64 rows of the
//     warpgroup) takes a path with no predicate.
//   * Only the tiles the rows can see are read: causal blocks stop at the
//     diagonal, key tiles wholly below pad[b] are never loaded, a warpgroup
//     releases unread the tiles past its last row, and a block whose rows
//     see no key at all (inside the pad under causal) loads nothing and
//     writes O = 0 and LSE = -1e30.
//   * O leaves normalised by l through the warpgroup's own Q rows, swizzled,
//     by TMA stores that clip rows past T; LSE per row, guarded at T.  A row
//     with l = 0 gets the sentinel written, not computed through a log.
//   * Blocks run in groups of 16 (b, h) pairs, the causally longest first
//     within a group (block_coords).
//   * Why 64-key tiles: measured against 128-key tiles in one loop
//     (scripts/torch_flash_fwd_ablation.py, PERF.md), 64 keys are faster at
//     both shapes: a warpgroup skips the half of the diagonal block's keys
//     past its rows, the pad skip is finer, and the overlap keeps two
//     tiles' P in registers: O 64, S 32 and P's hi + lo A fragments 32 a
//     consumer thread at D 128.  K and V take 32 KB a stage at D 128, so two
//     stages and Q fit in 97 KB.
//   * What bounds it now (PERF.md, scripts/torch_flash_fwd_ablation.py): at
//     the training shape the products and the softmax between them, at
//     about 40% of the tensor cores' peak on the 1.5x work: with no K/V
//     tile loaded the kernel takes 96% of its time, while the tile stream
//     alone takes 59%.  At the prefill shape the stream alone takes 77%.
// bf16 at D 16 and 32: four warps of mma.sync m16n8k16 with cp.async double
//   buffering (the first port's design; their 32- and 64-byte rows would
//   need other swizzle modes, and no main path runs them).  P enters P V as
//   hi + lo bf16 parts here too.
// fp32, every D: CUDA-core FMAs in full fp32 (never TF32), four threads per
//   query row, each holding every fourth element of d_head.
// D (d_head) is a template argument: 16, 32, 64 or 128.

#include "flash_sm90.cuh"

namespace {

// Tiles of the mma.sync (bf16, D 16 and 32) and fp32 instances
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

// ------------------------------------------ bf16, D 64 and 128: Hopper

constexpr int FWD_CONSUMERS = 2;  // consumer warpgroups a block, 64 query rows each
constexpr int FWD_THREADS = (FWD_CONSUMERS + 1) * WG_THREADS;  // and the producer warpgroup
constexpr int FWD_ROWS = 64 * FWD_CONSUMERS;  // query rows a block
constexpr int FWD_KEYS = 64;                  // keys a ring stage
constexpr int FWD_STAGES = 2;                 // ring depth

// The inputs' maps (q in FWD_ROWS-row boxes, k and v in FWD_KEYS-row
// boxes) and O's, in 64-row boxes: one warpgroup's rows.
struct TmaMaps {
  CUtensorMap q, k, v, o;
};

template <int D>
constexpr int fwd_wgmma_smem_bytes() {
  // Q [FWD_ROWS, D]; per stage K and V [FWD_KEYS, D]; per stage the full
  // and empty barriers of K and of V, and Q's barrier
  return FWD_ROWS * D * 2 + FWD_STAGES * 2 * FWD_KEYS * D * 2 + 8 * (4 * FWD_STAGES + 1) + 1024;
}

// One tile's online softmax in fp32, in place of its scores sc (an m64n64
// accumulator): the base-2 scores, the row max m and this thread's share of
// the row sum l brought up to date, and alpha, the factor by which O's rows
// must be rescaled.  `whole`: no mask reaches the tile, so no predicate.
// Masked probabilities are zeroed by the predicate (the score held at
// -1e30), never left to exp.
__device__ __forceinline__ void softmax_tile(float (&sc)[FWD_KEYS / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], bool whole,
                                             const Params& p, const int (&rows)[2], int kt0,
                                             int pad, int t, float scale_log2) {
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
  if (whole) {
#pragma unroll
    for (int i = 0; i < FWD_KEYS / 2; ++i) {
      sc[i] *= scale_log2;
      mx[row_half(i)] = fmaxf(mx[row_half(i)], sc[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < FWD_KEYS / 2; ++i) {
      const int r = row_half(i);
      sc[i] = mask_ok(rows[r], kt0 + col64(i, t), p.Tkv, pad, p.causal) ? sc[i] * scale_log2
                                                                       : NEG_INF;
      mx[r] = fmaxf(mx[r], sc[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row is spread over the 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
  }
  if (whole) {
#pragma unroll
    for (int i = 0; i < FWD_KEYS / 2; ++i) sc[i] = exp2_approx(sc[i] - mx[row_half(i)]);
  } else {
#pragma unroll
    for (int i = 0; i < FWD_KEYS / 2; ++i)
      sc[i] = sc[i] <= NEG_INF ? 0.f : exp2_approx(sc[i] - mx[row_half(i)]);
  }
#pragma unroll
  for (int i = 0; i < FWD_KEYS / 2; ++i) rs[row_half(i)] += sc[i];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_bf16_wgmma(const Params p, const __grid_constant__ TmaMaps maps) {
  constexpr int NB = D / 64;         // 64-column boxes a row
  constexpr int NS = FWD_KEYS / 2;   // score accumulators a thread
  constexpr int KS = FWD_KEYS / 16;  // k-steps of P V
  constexpr uint32_t Q_TILE = FWD_ROWS * D * 2, KV_TILE = FWD_KEYS * D * 2;
  extern __shared__ unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring = sq + Q_TILE;  // stage s: K at ring + 2 s KV_TILE, V after it
  const uint32_t bars = ring + FWD_STAGES * 2 * KV_TILE;
  auto full_k = [&](int j) { return bars + 8 * (j % FWD_STAGES); };
  auto full_v = [&](int j) { return bars + 8 * (FWD_STAGES + j % FWD_STAGES); };
  auto empty_k = [&](int j) { return bars + 8 * (2 * FWD_STAGES + j % FWD_STAGES); };
  auto empty_v = [&](int j) { return bars + 8 * (3 * FWD_STAGES + j % FWD_STAGES); };
  auto k_tile = [&](int j) { return ring + 2 * (j % FWD_STAGES) * KV_TILE; };
  auto v_tile = [&](int j) { return ring + (2 * (j % FWD_STAGES) + 1) * KV_TILE; };
  // the parity of tile j's round through its stage: consumers wait for it
  // on the full barriers, the producer for its flip on the empty ones
  auto phase = [&](int j) { return static_cast<uint32_t>((j / FWD_STAGES) & 1); };
  const uint32_t q_bar = bars + 32 * FWD_STAGES;

  const int n_y = (p.T + FWD_ROWS - 1) / FWD_ROWS;
  int bh, y;
  block_coords(p.B * p.H, n_y, bh, y);
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (n_y - 1 - y) * FWD_ROWS;  // under causal the last query blocks see the most keys
  const int pad = p.pad ? max(p.pad[b], 0) : 0;
  // The rows of this block see keys [pad, kv_end) only: the tiles wholly
  // below the pad are never loaded, causal blocks stop at the diagonal, and
  // a block with no such key loads nothing.
  const int kv_end = p.causal ? min(p.Tkv, q0 + FWD_ROWS) : p.Tkv;
  const int first = pad / FWD_KEYS;
  const int n_tiles = pad < kv_end ? (kv_end + FWD_KEYS - 1) / FWD_KEYS - first : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * FWD_CONSUMERS);  // one arrival per consumer warp
      mbar_init(empty_v(s), 4 * FWD_CONSUMERS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= FWD_CONSUMERS * WG_THREADS) {
    // producer warpgroup: one thread issues every load, the others are done
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != FWD_CONSUMERS * WG_THREADS || n_tiles == 0) return;
    mbar_arrive_expect_tx(q_bar, Q_TILE);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_load_4d(sq + nb * FWD_ROWS * 128, &maps.q, q_bar, 64 * nb, h, q0, b);
    // K runs one tile ahead of V, in the order the consumers take them: S
    // of tile j, then P V of tile j - 1
    for (int j = 0; j <= n_tiles; ++j) {
      if (j < n_tiles) {
        mbar_wait(empty_k(j), phase(j) ^ 1);
        mbar_arrive_expect_tx(full_k(j), KV_TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(k_tile(j) + nb * FWD_KEYS * 128, &maps.k, full_k(j), 64 * nb, h,
                      (first + j) * FWD_KEYS, b);
      }
      if (j > 0) {
        const int i = j - 1;
        mbar_wait(empty_v(i), phase(i) ^ 1);
        mbar_arrive_expect_tx(full_v(i), KV_TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(v_tile(i) + nb * FWD_KEYS * 128, &maps.v, full_v(i), 64 * nb, h,
                      (first + i) * FWD_KEYS, b);
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + 64 * wg;  // this warpgroup's first query row
    const int rows[2] = {qw0 + 16 * warp + g, qw0 + 16 * warp + g + 8};
    const float scale_log2 = p.scale * LOG2E;
    // The tiles this warpgroup computes on: a prefix of the block's, none
    // for rows past T or (under causal) wholly inside the pad, and under
    // causal none past its last row.  It releases the others unread.
    const int n_live = qw0 >= p.T || (p.causal && pad >= qw0 + 64) ? 0
                       : p.causal ? min(n_tiles, (qw0 + 64 + FWD_KEYS - 1) / FWD_KEYS - first)
                                  : n_tiles;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);  // this warp is done with the tile
    };
    auto s_product = [&](float (&sc)[NS], int j) {  // S = Q K^T: 64 rows x FWD_KEYS keys
      wgmma_m64n64k16_ss_init(sc, kmajor_desc<FWD_ROWS>(sq, 64 * wg, 0),
                              kmajor_desc<FWD_KEYS>(k_tile(j), 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(sc, kmajor_desc<FWD_ROWS>(sq, 64 * wg, kk),
                           kmajor_desc<FWD_KEYS>(k_tile(j), 0, kk));
      wgmma_commit();
    };
    // m: the running row max of the base-2 scores; l: this thread's share
    // of the row sum (the quad's four shares meet at the end); P of the
    // tile that waits for its V, as hi + lo A fragments
    float o[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, sc[NS], alpha[2];
    uint32_t phi[KS][4], plo[KS][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    auto softmax = [&](int j) {
      const int kt0 = (first + j) * FWD_KEYS;
      // a tile that no mask reaches skips the predicate
      const bool whole = kt0 + FWD_KEYS <= p.Tkv && kt0 >= pad &&
                         (!p.causal || qw0 >= kt0 + FWD_KEYS - 1);
      softmax_tile(sc, m, l, alpha, whole, p, rows, kt0, pad, t, scale_log2);
    };
    auto p_frags = [&]() {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_a_frag_split(phi[ks], plo[ks], sc, ks);
    };
    auto pv_product = [&](int j) {  // O += P V, P as hi + lo bf16 parts
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_rs<D>(o, phi[ks], mnmajor_desc<FWD_KEYS>(v_tile(j), ks));
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_rs<D>(o, plo[ks], mnmajor_desc<FWD_KEYS>(v_tile(j), ks));
      wgmma_commit();
    };
    if (n_tiles > 0) mbar_wait(q_bar, 0);

    if (n_live > 0) {
      // tile 0
      mbar_wait(full_k(0), 0);
      wgmma_fence();
      s_product(sc, 0);
      wgmma_wait<0>();
      wgmma_fence_operand(sc);
      release(empty_k(0));
      softmax(0);
      p_frags();
      // Tile j's S and tile j - 1's P V are issued together, so that the
      // tensor cores run P V while this warpgroup computes tile j's
      // softmax; O is rescaled and P becomes A fragments once P V is done.
      // The issues and waits take no branch, so that ptxas keeps the
      // products asynchronous.
      for (int j = 1; j < n_live; ++j) {
        mbar_wait(full_k(j), phase(j));
        mbar_wait(full_v(j - 1), phase(j - 1));
        wgmma_fence();
        s_product(sc, j);
        pv_product(j - 1);
        wgmma_wait<1>();  // S done; P V may still run
        wgmma_fence_operand(sc);
        release(empty_k(j));
        softmax(j);
        wgmma_wait<0>();
        wgmma_fence_operand(o);
        wgmma_fence_operand(phi);
        wgmma_fence_operand(plo);
        release(empty_v(j - 1));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[row_half(i)];
        p_frags();
      }
      // the last tile's P V
      mbar_wait(full_v(n_live - 1), phase(n_live - 1));
      wgmma_fence();
      pv_product(n_live - 1);
      wgmma_wait<0>();
      wgmma_fence_operand(o);
      wgmma_fence_operand(phi);
      wgmma_fence_operand(plo);
      release(empty_v(n_live - 1));
    }
    for (int j = n_live; j < n_tiles; ++j) {  // tiles this warpgroup's rows cannot see
      mbar_wait(full_k(j), phase(j));
      release(empty_k(j));
      mbar_wait(full_v(j), phase(j));
      release(empty_v(j));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (qw0 >= p.T) return;
    // A fully masked row has l = 0: O = 0, and LSE = -1e30 written as such.
    const float inv[2] = {l[0] == 0.f ? 1.f : 1.f / l[0], l[1] == 0.f ? 1.f : 1.f / l[1]};
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < p.T)
          p.lse[(long long)bh * p.T + rows[r]] = l[r] == 0.f ? NEG_INF : m[r] * LN2 + logf(l[r]);
    }
    // O leaves through this warpgroup's own Q rows, which no product reads
    // any more, by TMA stores (rows past T not written)
    const uint32_t o_tile = sq + 64 * wg * 128;
    acc_to_tma_tile<D>(o_tile, FWD_ROWS * 128, o, inv, warp, g, t);
    fence_proxy_async_smem();
    named_barrier_sync(1 + wg, WG_THREADS);
    if (tid == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_store_4d(&maps.o, o_tile + nb * FWD_ROWS * 128, 64 * nb, h, qw0, b);
      tma_store_wait();
    }
  }
}

// ------------------------------------------ bf16, D 16 and 32: mma.sync

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * BK * (D + 8) * 2;
}

// Fragment layouts of m16n8k16: flash_common.cuh, mma_bf16.
//
// K/V tiles are double-buffered: the copy of tile j + 1 (cp.async) is in
// flight while the block computes on tile j.
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16_mma(const Params p) {
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

// The TMA maps of q, k and v (through their strides) and of O.
bool make_maps(TmaMaps* maps, const Params& p, int D) {
  return make_bthd_map(&maps->q, p.q, p.B, p.T, p.H, D, p.q_sb, p.q_st, p.q_sh, FWD_ROWS) &&
         make_bthd_map(&maps->k, p.k, p.B, p.Tkv, p.H, D, p.k_sb, p.k_st, p.k_sh, FWD_KEYS) &&
         make_bthd_map(&maps->v, p.v, p.B, p.Tkv, p.H, D, p.v_sb, p.v_st, p.v_sh, FWD_KEYS) &&
         make_bthd_map(&maps->o, p.o, p.B, p.T, p.H, D, p.o_sb, p.o_st, p.o_sh, 64);
}

template <int D>
cudaError_t dispatch_dtype(int is_bf16, const Params& p, cudaStream_t stream) {
  if (!is_bf16) return launch(flash_fwd_f32<D>, 256, f32_smem_bytes<D>(), p, stream);
  if constexpr (D < 64) {
    return launch(flash_fwd_bf16_mma<D>, 128, bf16_smem_bytes<D>(), p, stream);
  } else {
    TmaMaps maps{};
    if (!make_maps(&maps, p, D)) return cudaErrorInvalidValue;
    const int n_y = (p.T + FWD_ROWS - 1) / FWD_ROWS;
    return launch_kernel(flash_fwd_bf16_wgmma<D>, dim3(p.B * p.H * n_y), FWD_THREADS,
                         fwd_wgmma_smem_bytes<D>(), stream, p, maps);
  }
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue where the driver refuses
// a TMA map.  Pointers are device pointers; strides are in elements; q, k,
// v, o must have unit stride along d_head and, for bf16, 16-byte-aligned
// rows, strides and base.  The caller checks shapes, dtypes and alignment.
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
