// The Hopper flash-attention forward main loop that K1 (flash_nr_fwd.cu:
// flash_nr_fwd_bf16_kernel, and flash_nr_fwd_int8_kernel for its s_int8 mode)
// and K3 (flash_fwd.cu, flash_fwd_kernel) share.  Each kernel is a thin
// __global__ wrapper around attn_fwd_body<SEG, NORM_Q, INT8, HD>; the body is
// inlined into it, so the kernels keep their names (and their profile groups)
// and compile to the same loop.  HD is the head dim: 128 for K1 (NORM_Q, and
// its INT8 mode) and K3, 64 or 32 for K3's narrow instances; every tile and
// shared-memory offset follows from it (Layout<HD>), and the products that
// run along the head dim become m64n{HD}k16 with HD / 2 accumulator registers.
//
// Block (q tile of 128 rows, h, b), 384 threads.  Warpgroup 0 is the producer:
// its first warp keeps STAGES (k, v) tile pairs of 128 keys in flight by TMA
// (keys past Sk zero-filled), each operand on a `full` mbarrier, and writes
// the keys' segment ids beside them (keys past Sk: 0; no ids: 1); each operand
// is freed by its own `empty` mbarrier (one arrival per consumer warp): k once
// its scores and ids are read, v once its P V is done.  Warpgroups 1 and 2
// each own 64 q rows, which arrive in the swizzled layout wgmma reads:
//   * NORM_Q (K1): the consumers norm and rope their raw q rows once, with K1's
//     cast chain (norm_rope4), straight into the tile;
//   * else (K3): the producer loads the already normed and roped q tile by TMA
//     before the first k tile, on its own mbarrier.
// INT8 (K1's s_int8 mode, with NORM_Q): the consumers also quantize their
// normed q rows with the scale of the block's q tile (the prep reduced its
// amax; a 128-row block lies inside one 128- or 256-row tile) into an int8
// tile in the same swizzled layout, the producer streams the prep's int8 k
// (128 keys, 16 KB a stage) in place of bf16 kn, and S is four wgmma
// m64n128k32 s8 steps into s32 accumulators (the same registers and layout),
// converted to f32 exactly (|sum| <= 127^2 * 128 < 2^24).  The softmax then
// takes the integer score in place of the raw one, with the int8 factor
// (q_scale * k_scale) * scale (IEEE products in that order) as its scale.
// Then per K/V tile: S = q k^T (wgmma m64n128k16, both operands in shared
// memory, k K-major), the online softmax on the accumulator registers (a
// masked score is exactly -1e30 and gets p = 0; p rounded to bf16,
// unnormalised; exp in log2 units: one fused multiply-add and ex2.approx a
// score, the running max kept in raw-score units), and O += P V (m64n128k16,
// P as the register A operand, V an MN-major B); the sum is divided by l at
// the end, and a row with no key of its own segment writes 0 and lse = -1e30.
// Within a warpgroup, tile i's softmax runs while tile i - 1's P V is in the
// tensor cores.  SEG: segment ids given (q_seg [B, Sq], kv_seg [B, Sk], which
// K1 passes as one [B, S] array twice), else every key below Sk attends and
// only a tile past Sk is masked.
//
// Registers: setmaxnreg gives the consumers 240 a thread (the 64 of the score
// accumulator, the 64 of O and P's 32 fit) and the producer 24; the mbarrier
// wait's trap is out of line (hopper.cuh's mbar_timeout says why).
//
// The narrow instances (HD = 64, 32) keep the 128-key score tile (S = q k^T is
// HD / 16 steps of m64n128k16) and the intra-warpgroup overlap, and O += P V
// is m64n{HD}k16 from registers into HD / 2 accumulators.  A [rows, 64] tile is
// one 128-byte swizzle span, so each tile is one TMA box; a [rows, 32] tile has
// 64-byte rows and takes the 64-byte swizzle (hopper.cuh).  The shared memory
// they free buys K/V stages: four in flight instead of two, since the
// look-ahead below keeps three tiles live (i - 1 for its v, i, i + 1 for its k; on
// an H100 at 700 W two stages made the narrow K3 1.37-1.43x slower at D = 64
// and 32: scripts/ablate_narrow_flash_torch.py, variant stages2).  There the softmax
// weighs as much as the products (one ex2 a score against 4 HD multiply-adds),
// so the narrow instances also
//   * issue tile i + 1's scores, into a second score buffer (64 registers:
//     the narrow O leaves room for them), behind tile i - 1's P V before tile
//     i's softmax, so the tensor cores have work while the softmax runs;
//   * let the two consumer warpgroups take turns to issue their products
//     (hopper.cuh's turn_take), so one's softmax runs while the other's
//     products are in the tensor cores;
//   * skip the per-score mask on a tile whose keys all carry one nonzero id
//     that every row of the warp carries too (the producer reduces each tile's
//     ids to that id, or 0), which is every tile but the few at a segment's
//     edge: the mask then changes nothing, and the scores go straight to the
//     exponentials.
// All three leave every value as it was; the D = 128 instances keep their
// loop.  scripts/ablate_narrow_flash_torch.py times each against its absence.

#pragma once

#include <type_traits>

#include "flash_nr_common.cuh"
#include "hopper.cuh"

namespace {
namespace fwd_wg {

constexpr int BQ = 128;       // q rows of a block: 64 per consumer warpgroup
constexpr int BK = 128;       // keys of a K/V tile
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups

// the shared memory of a block at head dim HD
template <int HD>
struct Layout {
  static constexpr int STAGES = HD == 128 ? 2 : 4;  // K/V tiles in flight (the notes above)
  // bytes of one [BK, HD] bf16 tile (the int8 k fills half)
  static constexpr int TILE = BK * HD * 2;
  static constexpr int Q_OFF = 0;                            // the block's q tile
  static constexpr int K_OFF = Q_OFF + BQ * HD * 2;          // STAGES k tiles
  static constexpr int V_OFF = K_OFF + STAGES * TILE;        // STAGES v tiles
  static constexpr int SEG_OFF = V_OFF + STAGES * TILE;      // STAGES x BK key ids
  // the narrow instances: STAGES tile ids (the keys' one id, or 0)
  static constexpr int SEGU_OFF = SEG_OFF + STAGES * BK * 4;
  // 4 x STAGES ring barriers, then q's
  static constexpr int BAR_OFF = SEGU_OFF + (HD < 128 ? STAGES * 4 : 0);
  static constexpr int SMEM = BAR_OFF + (4 * STAGES + 1) * 8 + 1024;  // + slack to align to 1024
  static_assert(SMEM <= 232448, "shared memory of one block");
};
constexpr int SMEM = Layout<128>::SMEM;  // K1's
constexpr float NEG_INF = -1e30f;

// K1's raw q and what norms and ropes it (unused by K3); in the s_int8 mode
// also the prep's amax [B, H, 1 + ceil(S / q_rows)] (k's slot, then one per q
// tile of q_rows rows) that the scales come from
struct RawQ {
  const bf16* q;
  const float* q_scale2;  // [2, D]: row 0 below st, row 1 from st
  const float* cos;
  const float* sin;
  long long cs_bstride;
  int st;
  const unsigned* amax;
  int q_rows;
};

// q_map: K3's normed q over [B, Sq, H, HD] in [BQ, min(HD, 64)] boxes (unused by
// K1); k_map / v_map over [B, Sk, H, HD] in [BK, min(HD, 64)] boxes (INT8: k_map
// over the int8 k in [BK, 128] boxes).  out [B, Sq, H, HD] bf16, lse [B, H, Sq]
// f32.
template <bool SEG, bool NORM_Q, bool INT8 = false, int HD = 128>
__device__ __forceinline__ void attn_fwd_body(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                              const CUtensorMap& v_map, const RawQ& rq,
                                              const int* __restrict__ q_seg,
                                              const int* __restrict__ kv_seg,
                                              bf16* __restrict__ out, float* __restrict__ lse,
                                              int Sq, int Sk, int H, float scale) {
  using L = Layout<HD>;
  constexpr int STAGES = L::STAGES, TILE = L::TILE;
  constexpr int Q_OFF = L::Q_OFF, K_OFF = L::K_OFF, V_OFF = L::V_OFF;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  uint64_t* full_q = empty_v + STAGES;
  int* segk = reinterpret_cast<int*>(smem + L::SEG_OFF);
  int* segu = reinterpret_cast<int*>(smem + L::SEGU_OFF);
  // the narrow instances' turns and tile ids (the notes above)
  constexpr bool NARROW = HD < 128, UNIFORM = NARROW && SEG;

  static_assert(NORM_Q || !INT8, "the s_int8 mode quantizes the q rows its consumers norm");
  static_assert(!NORM_Q || HD == D, "K1 (and its s_int8 mode) takes head dim 128");
  constexpr int KBYTES = INT8 ? BK * HD : TILE;  // bytes of one k tile
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int ntiles = (Sk + BK - 1) / BK;
  const int* qsegb = q_seg ? q_seg + (size_t)b * Sq : nullptr;
  const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1 + 32);  // the expect_tx, and each producer lane's ids
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);      // one arrival per consumer warp
      mbar_init(&empty_v[s], 8);
    }
    if constexpr (!NORM_Q) mbar_init(full_q, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if constexpr (!NORM_Q) {
        if (lane == 0) {
          mbar_expect_tx(full_q, BQ * HD * 2);
          tma_load_head<HD>(smem + Q_OFF, &q_map, full_q, BQ, h, q0, b);
        }
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES, k0 = i * BK;
        const uint32_t ph = ((i / STAGES) - 1) & 1;
        // k tile i once the scores of tile i - STAGES are in, v once its p v is
        if (i >= STAGES) mbar_wait(&empty_k[s], ph);
        if (lane == 0) {
          uint8_t* kt = smem + K_OFF + s * TILE;
          mbar_expect_tx(&full_k[s], KBYTES);
          if constexpr (INT8)
            tma_load_4d(kt, &k_map, &full_k[s], 0, h, k0, b);
          else
            tma_load_head<HD>(kt, &k_map, &full_k[s], BK, h, k0, b);
        }
        int lo = 0, hi = 0;  // UNIFORM: the least and largest id of the tile
        for (int j = lane; j < BK; j += 32) {
          const int key = k0 + j;
          const int id = key < Sk ? (ksegb ? ksegb[key] : 1) : 0;
          segk[s * BK + j] = id;
          if constexpr (UNIFORM) {
            lo = j == lane ? id : min(lo, id);
            hi = j == lane ? id : max(hi, id);
          }
        }
        if constexpr (UNIFORM) {
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
          if (lane == 0) segu[s] = lo == hi ? lo : 0;
        }
        mbar_arrive(&full_k[s]);
        if (i >= STAGES) mbar_wait(&empty_v[s], ph);
        if (lane == 0) {
          uint8_t* vt = smem + V_OFF + s * TILE;
          mbar_expect_tx(&full_v[s], TILE);
          tma_load_head<HD>(vt, &v_map, &full_v[s], BK, h, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<240>();
  const int c = wg - 1, wt = threadIdx.x - 128 * wg;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int rs = H * HD;
  const size_t head_off = ((size_t)b * Sq * H + h) * HD;  // q / out rows of (b, h)
  uint8_t* qs = smem + Q_OFF;
  const int r0 = 64 * c + 16 * warp;  // this warp's first row of the q tile

  // the softmax's scale of a raw score: INT8, the int8 factor of the block's q
  // tile and k (their quantization scales times scale, in that order)
  float sscale = scale, qsc = 0.f;
  if constexpr (INT8) {
    const unsigned* am = rq.amax + ((size_t)b * H + h) * (1 + (Sq + rq.q_rows - 1) / rq.q_rows);
    qsc = int8_scale(am[1 + q0 / rq.q_rows]);
    sscale = __fmul_rn(__fmul_rn(qsc, int8_scale(am[0])), scale);
  }
  if constexpr (NORM_Q) {
    // the warp's 16 q rows, normed and roped once (INT8: and quantized), in the
    // layout wgmma reads
    const float* cb = rq.cos + (size_t)b * rq.cs_bstride;
    const float* sb = rq.sin + (size_t)b * rq.cs_bstride;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int row = q0 + r0 + i;
      uint2 y = make_uint2(0u, 0u);
      if (row < Sq) {  // warp-uniform
        float unused;
        y = norm_rope4(rq.q + head_off + (size_t)row * rs,
                       rq.q_scale2 + (row < rq.st ? 0 : D) + lane * 4, cb + (size_t)row * D,
                       sb + (size_t)row * D, lane, unused);
      }
      if constexpr (INT8)
        *reinterpret_cast<uint32_t*>(qs + swz8_offset(r0 + i, lane * 4)) = quant4w(y, qsc);
      else
        *reinterpret_cast<uint2*>(qs + swz_offset(BQ, r0 + i, lane * 4)) = y;
    }
    fence_proxy_async();
    warpgroup_sync(c);
  } else {
    mbar_wait(full_q, 0);
  }

  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    segq[i] = row < Sq ? (qsegb ? qsegb[row] : 1) : 0;
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
  const uint32_t qa = smem_u32(qs);

  // Tile `it`'s scores into sc (INT8: into the s32 si, which `softmax`
  // converts; si is declared afresh for each tile, so its registers are free
  // between the conversion and the next tile's products), issued as one wgmma
  // group: sc[4 j + 2 i + e] is row r0 + g + 8 i, key 8 j + 2 t + e.  NARROW:
  // tiles alternate between sc and sc2 (the loop below says why).
  float sc[BK / 2], sc2[NARROW ? BK / 2 : 1];
  constexpr int NSI = INT8 ? BK / 2 : 1;
  // NARROW: a wgmma.fence after each mbarrier wait, between it and the products
  // (without it ptxas serializes the narrow instances' wgmmas, C7520)
  auto issue_scores = [&](int it, float (&sc)[BK / 2], uint32_t (&si)[NSI]) {
    const int s = it % STAGES;
    const uint32_t kt = smem_u32(smem + K_OFF + s * TILE);
    mbar_wait(&full_k[s], (it / STAGES) & 1);
    if constexpr (NARROW) wgmma_fence();
    if constexpr (INT8) {
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk)
        wgmma_m64n128k32_s8(si, desc_kmajor8(qa, 64 * c, kk), desc_kmajor8(kt, 0, kk), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n128k16<0>(sc, desc_kmajor<HD>(qa, BQ, 64 * c, kk),
                            desc_kmajor<HD>(kt, BK, 0, kk), kk > 0);
    }
    wgmma_commit();
  };
  // o += p v of tile `it` (p, rounded to bf16, as the A fragments of keys 16 kk ..
  // 16 kk + 15), issued as one wgmma group
  uint32_t pf[BK / 16][4];
  auto issue_pv = [&](int it) {
    const int s = it % STAGES;
    const uint32_t vt = smem_u32(smem + V_OFF + s * TILE);
    mbar_wait(&full_v[s], (it / STAGES) & 1);
    if constexpr (NARROW) wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<HD>(o, pf[kk], desc_mnmajor<HD>(vt, BK, kk));
    wgmma_commit();
  };
  // once tile `it`'s scores are in sc: turn them into p with the online-softmax
  // rule, freeing the k tile and its ids once read (a masked score is exactly
  // NEG_INF and gets p = 0), returning the row sums of p and the factors alpha
  // for o and l
  const float sl2 = sscale * LOG2E;  // raw scores to log2 units
  float alpha[2], psum[2];
  auto softmax = [&](int it, float (&sc)[BK / 2], uint32_t (&si)[NSI]) {
    if constexpr (INT8) {
      fence_regs(si);
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) sc[x] = s32_to_f32(si[x]);
    } else {
      fence_regs(sc);
    }
    const int* sk = segk + (it % STAGES) * BK;
    float tmax[2] = {NEG_INF, NEG_INF};
    // masking by id is needed with segment ids, else only in a tile past Sk;
    // UNIFORM: not where the tile's one id is every row's of the warp
    bool masked = SEG || (it + 1) * BK > Sk;
    if constexpr (UNIFORM) {
      const int u = segu[it % STAGES];
      masked = !__all_sync(0xffffffffu, u != 0 && segq[0] == u && segq[1] == u);
    }
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int skv = sk[8 * j + 2 * t + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool ok = segq[i] != 0 && skv == segq[i];
            const float val = ok ? sc[4 * j + 2 * i + e] : NEG_INF;
            sc[4 * j + 2 * i + e] = val;
            tmax[i] = fmaxf(tmax[i], val);
          }
        }
      }
    } else {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) tmax[(x >> 1) & 1] = fmaxf(tmax[(x >> 1) & 1], sc[x]);
    }
    __syncwarp();  // the tile's ids are read
    if (lane == 0) mbar_arrive(&empty_k[it % STAGES]);
    float msc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = ex2_approx((m[i] - m_new) * sl2);
      m[i] = m_new;
      msc[i] = m_new * sl2;
      psum[i] = 0.f;
    }
    if (masked) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        const int i = (x >> 1) & 1;
        const float p = sc[x] == NEG_INF ? 0.f : ex2_approx(fmaf(sc[x], sl2, -msc[i]));
        psum[i] += p;
        sc[x] = p;
      }
    } else {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        const int i = (x >> 1) & 1;
        const float p = ex2_approx(fmaf(sc[x], sl2, -msc[i]));
        psum[i] += p;
        sc[x] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
    }
  };
  // after tile it - 1's p v: free its v tile, rescale o and l, pack tile it's p
  auto rescale_and_pack = [&](int it_done, const float (&sc)[BK / 2]) {
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pf[kk]);
    if (it_done >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_v[it_done % STAGES]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    to_a_frags(sc, pf);
  };

  // NARROW: the warpgroups' turns to issue products (hopper.cuh's turn_take)
  auto take_turn = [&]() {
    if constexpr (NARROW) turn_take(c);
  };
  auto pass_turn = [&](bool last) {
    if constexpr (NARROW) turn_pass(c, last);
  };
  if constexpr (NARROW) turns_start(c);

  // Software pipeline within the warpgroup: tile it's scores are issued with tile
  // it - 1's p v behind them, so the softmax of tile it runs while p v is in the
  // tensor cores.  The arithmetic is the plain loop's, in its order: o and l are
  // rescaled by tile it's alpha after tile it - 1's p v has been added.
  {
    uint32_t si[NSI];
    take_turn();
    wgmma_fence();
    issue_scores(0, sc, si);
    pass_turn(false);
    wgmma_wait<0>();
    softmax(0, sc, si);
    rescale_and_pack(-1, sc);
  }
  if constexpr (NARROW) {
    // One tile further ahead: tile it + 1's scores (into the other buffer) are
    // issued behind tile it - 1's p v before tile it's softmax, so the tensor
    // cores have both to work on while it runs.  Groups complete in order: with
    // S(it), PV(it - 1), S(it + 1) in flight, wait<2> is S(it) and wait<1>
    // PV(it - 1).  No branch joins while a product is in flight (ptxas would
    // move the accumulators there and serialize the wgmmas, C7515): the last
    // tile's step, which issues no scores, is apart.
    auto step = [&](int it, float (&cur)[BK / 2], float (&next)[BK / 2], auto ahead) {
      uint32_t si[NSI];
      take_turn();
      wgmma_fence();
      issue_pv(it - 1);
      if constexpr (decltype(ahead)::value) issue_scores(it + 1, next, si);
      pass_turn(false);
      if constexpr (decltype(ahead)::value) {
        wgmma_wait<2>();
        softmax(it, cur, si);
        wgmma_wait<1>();
      } else {
        wgmma_wait<1>();
        softmax(it, cur, si);
        wgmma_wait<0>();
      }
      rescale_and_pack(it - 1, cur);
    };
    if (ntiles > 1) {
      uint32_t si[NSI];
      take_turn();
      wgmma_fence();
      issue_scores(1, sc2, si);
      pass_turn(false);
      int it = 1;
#pragma unroll 1
      for (; it + 2 < ntiles; it += 2) {
        step(it, sc2, sc, std::true_type());
        step(it + 1, sc, sc2, std::true_type());
      }
      if (it + 1 < ntiles) {  // two tiles left
        step(it, sc2, sc, std::true_type());
        step(it + 1, sc, sc2, std::false_type());
      } else {
        step(it, sc2, sc, std::false_type());
      }
    }
  } else {
#pragma unroll 1
    for (int it = 1; it < ntiles; ++it) {
      uint32_t si[NSI];
      wgmma_fence();
      issue_scores(it, sc, si);
      issue_pv(it - 1);
      wgmma_wait<1>();
      softmax(it, sc, si);
      wgmma_wait<0>();
      rescale_and_pack(it - 1, sc);
    }
  }
  take_turn();
  wgmma_fence();
  issue_pv(ntiles - 1);
  pass_turn(true);
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pf[kk]);

  // epilogue: normalise, round to bf16, stage in the warp's own q rows
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  store_rows_wg<HD>(o, inv, qs, BQ, r0, out + head_off, rs, q0 + r0, Sq);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + g + 8 * i;
      if (row < Sq)
        lse[((size_t)b * H + h) * Sq + row] =
            m[i] == NEG_INF ? NEG_INF : m[i] * sscale + logf(l[i] == 0.f ? 1.f : l[i]);
    }
  }
}

}  // namespace fwd_wg
}  // namespace
