// The Hopper main loops of the flash-attention backward that K4 (flash_bwd.cu,
// flash_dkv_kernel / flash_dq_kernel) and K2's bf16 mode (flash_nr_bwd.cu,
// flash_nr_dkv_kernel / flash_nr_dq_kernel) share.  Each kernel is a thin
// __global__ wrapper around attn_dkv_body / attn_dq_body, inlined into it, so the
// kernels keep their names (and profile groups) and run the same loop; they
// differ in the epilogue, a parameter `Epi` of the body:
//   * StoreGrads (K4, below): the f32 accumulators as bf16 dk / dv and dq;
//   * K2's (flash_nr_bwd.cu): dv as bf16, then the rope transpose and RMSNorm
//     backward of each complete dkn / dqn row, and the norm-scale gradient's
//     partial sums.
// An epilogue gets the consumer warp's accumulators after the loop, the block's
// two own [BLK, 128] tiles (k and v in dkv, q and do in dq), which nothing reads
// any more in the warp's own rows r0 .. r0 + 15, and the block's coordinates:
//   void epilogue_dkv(const float (&dva)[64], const float (&dka)[64],
//                     uint8_t* k_tile, uint8_t* v_tile, int b, int h, int k0, int c,
//                     int r0, int Sk, int H)
//   void epilogue_dq(const float (&dqa)[64], uint8_t* q_tile, uint8_t* do_tile,
//                    int b, int h, int q0, int c, int r0, int Sq, int H)
// (c: the consumer warpgroup, 0 or 1; r0 = 64 c + 16 * warp).
//
// Both bodies: 384 threads, one block per SM.  Warpgroup 0's first warp is the
// producer: it loads the block's own tiles once by TMA (k and v, or q and do) and
// then keeps a ring of streamed tiles in flight (q, do and their rows' lse,
// delta and segment ids; or k, v and the keys' ids), each stage on a `full`
// mbarrier and freed by an `empty` one.  Warpgroups 1 and 2 are the consumers and
// run every product as wgmma with f32 accumulators in registers (setmaxnreg hands
// them 232 registers a thread at run time, the producer keeps 40):
//   dkv, per 64-row q tile: s^T = k q^T and dp^T = v do^T (m64n64k16, both operands
//       in shared memory, K-major), p^T and ds^T in registers (exp in log2 units:
//       lse times log2 e, one fused multiply-add and ex2.approx a score; a
//       masked pair selects p = 0 before any exponential), then dv += p^T do and
//       dk += ds^T q (m64n128k16, p^T / ds^T as the register A operand, do / q an
//       MN-major B);
//   dq, per 64-key tile: s = q k^T and dp = do v^T (m64n64k16; p is formed while dp
//       is in the tensor cores), ds in registers, then dq += ds k (register A, k an
//       MN-major B).
// Keys and rows past the tensor are zero-filled by TMA and carry segment 0.
// Inputs: lse (natural units, as the forward wrote it) and delta [B, H, Sq] f32,
// q_seg [B, Sq] / kv_seg [B, Sk] int32 or both null (every real token segment 1).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace bwd_wg {

constexpr int D = 128;         // the only head dim the kernels take
constexpr int NTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int BLK = 128;       // rows a dkv / dq block owns: 64 per consumer warpgroup
constexpr int KV_STEP = 64;    // q rows streamed per step of dkv
constexpr int STEP = 64;       // keys streamed per step of dq
constexpr int STAGES = 4;      // streamed steps in flight
constexpr int OWN = BLK * D * 2;    // bytes of one [128, 128] bf16 tile of the block's own
constexpr int STEP_T = STEP * D * 2;  // bytes of one streamed [64, 128] bf16 tile
constexpr int KV_STEP_T = KV_STEP * D * 2;

// dkv: the block's k and v; per stage the q and do tiles and the q rows' lse,
// delta and segment ids
constexpr int KV_K_OFF = 0;
constexpr int KV_V_OFF = KV_K_OFF + OWN;
constexpr int KV_Q_OFF = KV_V_OFF + OWN;
constexpr int KV_DO_OFF = KV_Q_OFF + STAGES * KV_STEP_T;
constexpr int KV_ROW_OFF = KV_DO_OFF + STAGES * KV_STEP_T;  // [STAGES][lse, delta, seg][KV_STEP]
constexpr int KV_BAR_OFF = KV_ROW_OFF + STAGES * 3 * KV_STEP * 4;
constexpr int KV_SMEM = KV_BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align to 1024
// dq: the block's q and do; per stage the k and v tiles and the keys' segment ids
constexpr int Q_Q_OFF = 0;
constexpr int Q_DO_OFF = Q_Q_OFF + OWN;
constexpr int Q_K_OFF = Q_DO_OFF + OWN;
constexpr int Q_V_OFF = Q_K_OFF + STAGES * STEP_T;
constexpr int Q_SEG_OFF = Q_V_OFF + STAGES * STEP_T;    // [STAGES][STEP]
constexpr int Q_BAR_OFF = Q_SEG_OFF + STAGES * STEP * 4;
constexpr int Q_SMEM = Q_BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448, "shared memory of one block");

__device__ __forceinline__ int seg_of(const int* __restrict__ seg, int row, int n) {
  // one validity rule: rows past n carry segment 0; without ids every real token is 1
  return row < n ? (seg ? seg[row] : 1) : 0;
}

// dk / dv: block = 128 keys of one (b, h); consumer warpgroup c owns keys 64 c ..
// 64 c + 63.  Per q tile of KV_STEP rows: s^T = k q^T and dp^T = v do^T, then p^T and
// ds^T in registers, then dv += p^T do and dk += ds^T q.
template <class Epi>
__device__ __forceinline__ void attn_dkv_body(const CUtensorMap& k_map, const CUtensorMap& v_map,
                                              const CUtensorMap& q_map, const CUtensorMap& do_map,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              const int* __restrict__ q_seg,
                                              const int* __restrict__ kv_seg, int Sq, int Sk,
                                              int H, float scale, const Epi& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + KV_BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BLK;
  const int nq = (Sq + KV_STEP - 1) / KV_STEP;

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the expect_tx, and each producer lane's rows
      mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(own, 2 * OWN);
        tma_load_4d(smem + KV_K_OFF, &k_map, own, 0, h, k0, b);
        tma_load_4d(smem + KV_K_OFF + OWN / 2, &k_map, own, 64, h, k0, b);
        tma_load_4d(smem + KV_V_OFF, &v_map, own, 0, h, k0, b);
        tma_load_4d(smem + KV_V_OFF + OWN / 2, &v_map, own, 64, h, k0, b);
      }
      const float* lse_bh = lse + ((size_t)b * H + h) * Sq;
      const float* del_bh = delta + ((size_t)b * H + h) * Sq;
      const int* qsegb = q_seg ? q_seg + (size_t)b * Sq : nullptr;
      for (int i = 0; i < nq; ++i) {
        const int s = i % STAGES, q0 = i * KV_STEP;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        if (lane == 0) {
          uint8_t* qt = smem + KV_Q_OFF + s * KV_STEP_T;
          uint8_t* dt = smem + KV_DO_OFF + s * KV_STEP_T;
          mbar_expect_tx(&full[s], 2 * KV_STEP_T);
          tma_load_4d(qt, &q_map, &full[s], 0, h, q0, b);
          tma_load_4d(qt + KV_STEP_T / 2, &q_map, &full[s], 64, h, q0, b);
          tma_load_4d(dt, &do_map, &full[s], 0, h, q0, b);
          tma_load_4d(dt + KV_STEP_T / 2, &do_map, &full[s], 64, h, q0, b);
        }
        float* rows = reinterpret_cast<float*>(smem + KV_ROW_OFF) + s * 3 * KV_STEP;
        for (int j = lane; j < KV_STEP; j += 32) {
          const int row = q0 + j;
          const bool in = row < Sq;
          rows[j] = in ? lse_bh[row] * LOG2E : 0.f;  // in log2 units
          rows[KV_STEP + j] = in ? del_bh[row] : 0.f;
          reinterpret_cast<int*>(rows)[2 * KV_STEP + j] = seg_of(qsegb, row, Sq);
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1, wt = threadIdx.x - 128 * wg;
  const float sl2 = scale * LOG2E;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * c + 16 * warp;  // this warp's first key row of the block
  const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;
  int segk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) segk[i] = seg_of(ksegb, k0 + r0 + g + 8 * i, Sk);

  float dva[64], dka[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) dva[x] = dka[x] = 0.f;
  const uint32_t kt = smem_u32(smem + KV_K_OFF), vt = smem_u32(smem + KV_V_OFF);
  mbar_wait(own, 0);

#pragma unroll 1
  for (int i = 0; i < nq; ++i) {
    const int s = i % STAGES;
    const uint32_t qt = smem_u32(smem + KV_Q_OFF + s * KV_STEP_T);
    const uint32_t dt = smem_u32(smem + KV_DO_OFF + s * KV_STEP_T);
    const float* lse_s = reinterpret_cast<const float*>(smem + KV_ROW_OFF) + s * 3 * KV_STEP;
    const float* del_s = lse_s + KV_STEP;
    const int* segq_s = reinterpret_cast<const int*>(lse_s + 2 * KV_STEP);

    // sT[4 j + 2 i + e], dpT likewise: key row r0 + g + 8 i, q column 8 j + 2 t + e
    float sT[KV_STEP / 2], dpT[KV_STEP / 2];
    mbar_wait(&full[s], (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(sT, desc_kmajor(kt, BLK, 64 * c, kk), desc_kmajor(qt, KV_STEP, 0, kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dpT, desc_kmajor(vt, BLK, 64 * c, kk), desc_kmajor(dt, KV_STEP, 0, kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
#pragma unroll
    for (int j = 0; j < KV_STEP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float ls = lse_s[col], dl = del_s[col];
        const int sq = segq_s[col];
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int x = 4 * j + 2 * i2 + e;
          const bool ok = segk[i2] != 0 && sq == segk[i2];
          const float p = ok ? ex2_approx(fmaf(sT[x], sl2, -ls)) : 0.f;
          sT[x] = p;
          dpT[x] = p * (dpT[x] - dl) * scale;
        }
      }
    }
    uint32_t pa[KV_STEP / 16][4], sa[KV_STEP / 16][4];
    to_a_frags(sT, pa);
    to_a_frags(dpT, sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV_STEP / 16; ++kk)
      wgmma_m64n128k16_rs(dva, pa[kk], desc_mnmajor(dt, KV_STEP, kk));
#pragma unroll
    for (int kk = 0; kk < KV_STEP / 16; ++kk)
      wgmma_m64n128k16_rs(dka, sa[kk], desc_mnmajor(qt, KV_STEP, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
#pragma unroll
    for (int kk = 0; kk < KV_STEP / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(sa[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  epi.epilogue_dkv(dva, dka, smem + KV_K_OFF, smem + KV_V_OFF, b, h, k0, c, r0, Sk, H);
}

// dq: block = 128 q rows of one (b, h); consumer warpgroup c owns rows 64 c .. 64 c +
// 63.  Per K tile of 64 keys: s = q k^T and dp = do v^T, p and ds in registers, then
// dq += ds k.
template <class Epi>
__device__ __forceinline__ void attn_dq_body(const CUtensorMap& q_map, const CUtensorMap& do_map,
                                             const CUtensorMap& k_map, const CUtensorMap& v_map,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             const int* __restrict__ q_seg,
                                             const int* __restrict__ kv_seg, int Sq, int Sk,
                                             int H, float scale, const Epi& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + Q_BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BLK;
  const int nk = (Sk + STEP - 1) / STEP;

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(own, 2 * OWN);
        tma_load_4d(smem + Q_Q_OFF, &q_map, own, 0, h, q0, b);
        tma_load_4d(smem + Q_Q_OFF + OWN / 2, &q_map, own, 64, h, q0, b);
        tma_load_4d(smem + Q_DO_OFF, &do_map, own, 0, h, q0, b);
        tma_load_4d(smem + Q_DO_OFF + OWN / 2, &do_map, own, 64, h, q0, b);
      }
      const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES, k0 = i * STEP;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        if (lane == 0) {
          uint8_t* kt = smem + Q_K_OFF + s * STEP_T;
          uint8_t* vt = smem + Q_V_OFF + s * STEP_T;
          mbar_expect_tx(&full[s], 2 * STEP_T);
          tma_load_4d(kt, &k_map, &full[s], 0, h, k0, b);
          tma_load_4d(kt + STEP_T / 2, &k_map, &full[s], 64, h, k0, b);
          tma_load_4d(vt, &v_map, &full[s], 0, h, k0, b);
          tma_load_4d(vt + STEP_T / 2, &v_map, &full[s], 64, h, k0, b);
        }
        int* segs = reinterpret_cast<int*>(smem + Q_SEG_OFF) + s * STEP;
        for (int j = lane; j < STEP; j += 32) segs[j] = seg_of(ksegb, k0 + j, Sk);
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1, wt = threadIdx.x - 128 * wg;
  const float sl2 = scale * LOG2E;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * c + 16 * warp;  // this warp's first q row of the block
  const int* qsegb = q_seg ? q_seg + (size_t)b * Sq : nullptr;
  float lse_r[2], del_r[2];
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const bool in = row < Sq;
    lse_r[i] = in ? lse[((size_t)b * H + h) * Sq + row] * LOG2E : 0.f;  // in log2 units
    del_r[i] = in ? delta[((size_t)b * H + h) * Sq + row] : 0.f;
    segq[i] = seg_of(qsegb, row, Sq);
  }

  float dqa[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) dqa[x] = 0.f;
  const uint32_t qt = smem_u32(smem + Q_Q_OFF), dt = smem_u32(smem + Q_DO_OFF);
  mbar_wait(own, 0);

#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t kt = smem_u32(smem + Q_K_OFF + s * STEP_T);
    const uint32_t vt = smem_u32(smem + Q_V_OFF + s * STEP_T);
    const int* segk_s = reinterpret_cast<const int*>(smem + Q_SEG_OFF) + s * STEP;

    // sc[4 j + 2 i + e], dp likewise: q row r0 + g + 8 i, key column 8 j + 2 t + e
    float sc[32], dp[32];
    mbar_wait(&full[s], (i / STAGES) & 1);
    // s, then dp as a second wgmma group: p is formed while dp runs
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(sc, desc_kmajor(qt, BLK, 64 * c, kk), desc_kmajor(kt, STEP, 0, kk),
                         kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dp, desc_kmajor(dt, BLK, 64 * c, kk), desc_kmajor(vt, STEP, 0, kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sk = segk_s[8 * j + 2 * t + e];
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int x = 4 * j + 2 * i2 + e;
          const bool ok = segq[i2] != 0 && sk == segq[i2];
          sc[x] = ok ? ex2_approx(fmaf(sc[x], sl2, -lse_r[i2])) : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // sc becomes ds
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = sc[x] * (dp[x] - del_r[(x >> 1) & 1]) * scale;

    uint32_t sa[STEP / 16][4];
    to_a_frags(sc, sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STEP / 16; ++kk)
      wgmma_m64n128k16_rs(dqa, sa[kk], desc_mnmajor(kt, STEP, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
#pragma unroll
    for (int kk = 0; kk < STEP / 16; ++kk) fence_regs(sa[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  epi.epilogue_dq(dqa, smem + Q_Q_OFF, smem + Q_DO_OFF, b, h, q0, c, r0, Sq, H);
}


// K4's epilogue: each warp's rows of the f32 accumulators as bf16, staged in its
// own rows of the block's tiles for 16-byte stores
struct StoreGrads {
  bf16* dq;
  bf16* dk;
  bf16* dv;

  __device__ __forceinline__ void epilogue_dkv(const float (&dva)[64],
                                               const float (&dka)[64], uint8_t* k_tile,
                                               uint8_t* v_tile, int b, int h, int k0, int c,
                                               int r0, int Sk, int H) const {
    const float one[2] = {1.f, 1.f};
    const size_t kh = ((size_t)b * Sk * H + h) * D;
    store_rows_wg(dva, one, v_tile, BLK, r0, dv + kh, H * D, k0 + r0, Sk);
    store_rows_wg(dka, one, k_tile, BLK, r0, dk + kh, H * D, k0 + r0, Sk);
  }

  __device__ __forceinline__ void epilogue_dq(const float (&dqa)[64], uint8_t* q_tile,
                                              uint8_t* do_tile, int b, int h, int q0, int c,
                                              int r0, int Sq, int H) const {
    const float one[2] = {1.f, 1.f};
    store_rows_wg(dqa, one, q_tile, BLK, r0, dq + ((size_t)b * Sq * H + h) * D, H * D,
                  q0 + r0, Sq);
  }
};

}  // namespace bwd_wg
}  // namespace
