// The Hopper main loops of the flash-attention backward that K4 (flash_bwd.cu,
// flash_dkv_kernel / flash_dq_kernel) and K2 (flash_nr_bwd.cu: flash_nr_dkv_kernel
// / flash_nr_dq_kernel, and flash_nr_dkv_int8_kernel / flash_nr_dq_int8_kernel for
// its s_int8 mode) share.  Each kernel is a thin __global__ wrapper around
// attn_dkv_body / attn_dq_body, inlined into it, so the kernels keep their names
// (and profile groups) and run the same loop; they differ in the epilogue, a
// parameter `Epi` of the body:
//   * StoreGrads (K4, below): the f32 accumulators as bf16 dk / dv and dq;
//   * K2's (flash_nr_bwd.cu): dv as bf16, then the rope transpose and RMSNorm
//     backward of each complete dkn / dqn row, and the norm-scale gradient's
//     partial sums.
// An epilogue gets the consumer warp's accumulators after the loop, the block's
// two own [BLK, HD] tiles (k and v in dkv, q and do in dq), which nothing reads
// any more in the warp's own rows r0 .. r0 + 15, and the block's coordinates:
//   void epilogue_dkv(const float (&dva)[HD / 2], const float (&dka)[HD / 2],
//                     uint8_t* k_tile, uint8_t* v_tile, int b, int h, int k0, int c,
//                     int r0, int Sk, int H)
//   void epilogue_dq(const float (&dqa)[HD / 2], uint8_t* q_tile, uint8_t* do_tile,
//                    int b, int h, int q0, int c, int r0, int Sq, int H)
// (c: the consumer warpgroup, 0 or 1; r0 = 64 c + 16 * warp).
//
// HD, a template parameter of both bodies, is the head dim: 128 for K2 (and its
// s_int8 mode) and K4, 64 or 32 for K4's narrow instances.  Every tile and
// shared-memory offset follows from it (KvLayout / QLayout); the score products
// keep their m64n64k16 with HD / 16 k16 steps, the products along the head dim
// (dv, dk, dq) become m64n{HD}k16 into HD / 2 accumulators, and a [rows, 64] or
// [rows, 32] tile is one TMA box (hopper.cuh's layouts).  The narrow instances
// also skip the per-score mask on a step whose streamed rows (dkv: q rows, dq:
// keys) all carry one nonzero id that every row of the warp carries too: the
// producer reduces each step's ids to that id, or 0 (dkv: the int slot after
// the ids; dq: SEGU_OFF), and the mask, which would change nothing there, is
// not evaluated.  The D = 128 instances keep their loop.
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
//       dk += ds^T q (m64n{HD}k16, p^T / ds^T as the register A operand, do / q an
//       MN-major B);
//   dq, per 64-key tile: s = q k^T and dp = do v^T (m64n64k16; p is formed while dp
//       is in the tensor cores), ds in registers, then dq += ds k (register A, k an
//       MN-major B).
// Keys and rows past the tensor are zero-filled by TMA and carry segment 0.
//
// The score product's int8 path (a parameter `I8` of the body, K2's s_int8 mode;
// NoInt8 elsewhere): the scores are recomputed from int8 q and k, s = f32(qq
// kq^T) * factor with factor = (q tile scale * k scale) * scale.  The block's
// own k (dkv) or q (dq) tile holds the int8 operand (16 KB of its 32 KB region:
// the epilogues stage in the full region), each stage streams the other int8
// operand ([64, 128], 8 KB) beside the bf16 tiles, and s^T = kq qq^T or s = qq
// kq^T is four wgmma m64n64k32 s8 steps into s32 accumulators (both operands
// K-major, as 8-bit wgmma requires and as the [rows, 128] tiles lie), converted
// to f32 exactly; the factor joins the log2-unit exponent.  Every other
// product stays bf16 on the normed copies (the gradient is straight through
// the quantization).  dkv keeps four stages in this mode by putting two stages'
// int8 q tiles in the second half of its own k region, which the int8 k leaves
// free until the epilogue stages there (the consumers meet before it); after
// the do tiles, all four would need 233,544 bytes of shared memory, 1,096 over a
// block's 232,448.
//   struct I8 {
//     static constexpr bool ON = true;
//     CUtensorMap step_map;  // dkv: qq, dq: kq, [B, S, H, 128] int8 in [64, 128] boxes
//     float factor(int b, int h, int H, int S, int q0) const;  // q rows from q0
//   };
// Inputs: lse (natural units, as the forward wrote it) and delta [B, H, Sq] f32,
// q_seg [B, Sq] / kv_seg [B, Sk] int32 or both null (every real token segment 1).

#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace bwd_wg {

constexpr int NTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int BLK = 128;       // rows a dkv / dq block owns: 64 per consumer warpgroup
constexpr int KV_STEP = 64;    // q rows streamed per step of dkv
constexpr int STEP = 64;       // keys streamed per step of dq
constexpr int OWN8 = BLK * 128;  // the int8 own tile's bytes (the first half of its region)
constexpr int STEP8 = STEP * 128;  // bytes of one streamed [64, 128] int8 tile

// dkv: the block's k and v; per stage the q and do tiles (INT8: and the int8 q
// tile, stages 0 and 1 in the own k region's second half, 2 and 3 after the do
// tiles) and the q rows' lse, delta and segment ids (INT8: and the tile's factor)
template <bool INT8, int HD = 128>
struct KvLayout {
  static constexpr int STAGES = 4;  // streamed steps in flight
  static constexpr int OWN = BLK * HD * 2;           // one [BLK, HD] bf16 tile of the block's own
  static constexpr int KV_STEP_T = KV_STEP * HD * 2;  // one streamed [KV_STEP, HD] bf16 tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + OWN;
  static constexpr int Q_OFF = V_OFF + OWN;
  static constexpr int DO_OFF = Q_OFF + STAGES * KV_STEP_T;
  static constexpr int Q8_OFF = DO_OFF + STAGES * KV_STEP_T;
  static constexpr int ROW_OFF = Q8_OFF + (INT8 ? (STAGES - 2) * STEP8 : 0);
  // the int8 q tile of stage s
  static __device__ __forceinline__ int q8_off(int s) {
    return s < 2 ? K_OFF + OWN8 + s * STEP8 : Q8_OFF + (s - 2) * STEP8;
  }
  // [STAGES][lse, delta, seg(, INT8: factor; HD < 128: the step's one id)][KV_STEP]
  static constexpr int ROWS = INT8 || HD < 128 ? 4 : 3;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * ROWS * KV_STEP * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align to 1024
};
// dq: the block's q and do; per stage the k and v tiles (INT8: and the int8 k
// tile) and the keys' segment ids
template <bool INT8, int HD = 128>
struct QLayout {
  static constexpr int STAGES = 4;
  static constexpr int OWN = BLK * HD * 2;     // one [BLK, HD] bf16 tile of the block's own
  static constexpr int STEP_T = STEP * HD * 2;  // one streamed [STEP, HD] bf16 tile
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + OWN;
  static constexpr int K_OFF = DO_OFF + OWN;
  static constexpr int V_OFF = K_OFF + STAGES * STEP_T;
  static constexpr int K8_OFF = V_OFF + STAGES * STEP_T;
  static constexpr int SEG_OFF = K8_OFF + (INT8 ? STAGES * STEP8 : 0);  // [STAGES][STEP]
  static constexpr int SEGU_OFF = SEG_OFF + STAGES * STEP * 4;  // HD < 128: [STAGES] step ids
  static constexpr int BAR_OFF = SEGU_OFF + (HD < 128 ? STAGES * 4 : 0);
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};
constexpr int KV_SMEM = KvLayout<false>::SMEM, Q_SMEM = QLayout<false>::SMEM;
constexpr int KV_SMEM8 = KvLayout<true>::SMEM, Q_SMEM8 = QLayout<true>::SMEM;
static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448 && KV_SMEM8 <= 232448 &&
                  Q_SMEM8 <= 232448,
              "shared memory of one block");

// the score product without the int8 path (K4, K2's bf16 mode)
struct NoInt8 {
  static constexpr bool ON = false;
};

__device__ __forceinline__ int seg_of(const int* __restrict__ seg, int row, int n) {
  // one validity rule: rows past n carry segment 0; without ids every real token is 1
  return row < n ? (seg ? seg[row] : 1) : 0;
}

// dk / dv: block = 128 keys of one (b, h); consumer warpgroup c owns keys 64 c ..
// 64 c + 63.  Per q tile of KV_STEP rows: s^T = k q^T and dp^T = v do^T, then p^T and
// ds^T in registers, then dv += p^T do and dk += ds^T q.  I8::ON: k_map is the int8
// k in [BLK, 128] boxes, q_map the bf16 qn, i8.step_map the int8 q.
template <class Epi, class I8 = NoInt8, int HD = 128>
__device__ __forceinline__ void attn_dkv_body(const CUtensorMap& k_map, const CUtensorMap& v_map,
                                              const CUtensorMap& q_map, const CUtensorMap& do_map,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              const int* __restrict__ q_seg,
                                              const int* __restrict__ kv_seg, int Sq, int Sk,
                                              int H, float scale, const Epi& epi,
                                              const I8& i8 = I8()) {
  static_assert(!I8::ON || HD == 128, "the s_int8 mode takes head dim 128");
  using L = KvLayout<I8::ON, HD>;
  constexpr int STAGES = L::STAGES, OWN = L::OWN, KV_STEP_T = L::KV_STEP_T;
  constexpr int KV_K_OFF = L::K_OFF, KV_V_OFF = L::V_OFF, KV_Q_OFF = L::Q_OFF;
  constexpr int KV_DO_OFF = L::DO_OFF, KV_ROW_OFF = L::ROW_OFF, ROWS = L::ROWS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
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
        mbar_expect_tx(own, (I8::ON ? OWN8 : OWN) + OWN);
        if constexpr (I8::ON)
          tma_load_4d(smem + KV_K_OFF, &k_map, own, 0, h, k0, b);
        else
          tma_load_head<HD>(smem + KV_K_OFF, &k_map, own, BLK, h, k0, b);
        tma_load_head<HD>(smem + KV_V_OFF, &v_map, own, BLK, h, k0, b);
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
          mbar_expect_tx(&full[s], 2 * KV_STEP_T + (I8::ON ? STEP8 : 0));
          tma_load_head<HD>(qt, &q_map, &full[s], KV_STEP, h, q0, b);
          tma_load_head<HD>(dt, &do_map, &full[s], KV_STEP, h, q0, b);
          if constexpr (I8::ON) {
            tma_load_4d(smem + L::q8_off(s), &i8.step_map, &full[s], 0, h, q0, b);
          }
        }
        float* rows = reinterpret_cast<float*>(smem + KV_ROW_OFF) + s * ROWS * KV_STEP;
        if constexpr (I8::ON) {
          if (lane == 0) rows[3 * KV_STEP] = i8.factor(b, h, H, Sq, q0);
        }
        int lo = 0, hi = 0;  // narrow: the least and largest id of the step
        for (int j = lane; j < KV_STEP; j += 32) {
          const int row = q0 + j;
          const bool in = row < Sq;
          rows[j] = in ? lse_bh[row] * LOG2E : 0.f;  // in log2 units
          rows[KV_STEP + j] = in ? del_bh[row] : 0.f;
          const int id = seg_of(qsegb, row, Sq);
          reinterpret_cast<int*>(rows)[2 * KV_STEP + j] = id;
          lo = j == lane ? id : min(lo, id);
          hi = j == lane ? id : max(hi, id);
        }
        if constexpr (HD < 128) {
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
          if (lane == 0) reinterpret_cast<int*>(rows)[3 * KV_STEP] = lo == hi ? lo : 0;
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

  float dva[HD / 2], dka[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dva[x] = dka[x] = 0.f;
  const uint32_t kt = smem_u32(smem + KV_K_OFF), vt = smem_u32(smem + KV_V_OFF);
  mbar_wait(own, 0);
#pragma unroll 1
  for (int i = 0; i < nq; ++i) {
    const int s = i % STAGES;
    const uint32_t qt = smem_u32(smem + KV_Q_OFF + s * KV_STEP_T);
    const uint32_t dt = smem_u32(smem + KV_DO_OFF + s * KV_STEP_T);
    const float* lse_s = reinterpret_cast<const float*>(smem + KV_ROW_OFF) + s * ROWS * KV_STEP;
    const float* del_s = lse_s + KV_STEP;
    const int* segq_s = reinterpret_cast<const int*>(lse_s + 2 * KV_STEP);

    // sT[4 j + 2 i + e], dpT likewise: key row r0 + g + 8 i, q column 8 j + 2 t + e
    float sT[KV_STEP / 2], dpT[KV_STEP / 2];
    uint32_t si[I8::ON ? KV_STEP / 2 : 1];  // s^T as s32 (the int8 path)
    mbar_wait(&full[s], (i / STAGES) & 1);
    wgmma_fence();
    if constexpr (I8::ON) {
      const uint32_t q8t = smem_u32(smem + L::q8_off(s));
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk)
        wgmma_m64n64k32_s8(si, desc_kmajor8(kt, 64 * c, kk), desc_kmajor8(q8t, 0, kk), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(sT, desc_kmajor<HD>(kt, BLK, 64 * c, kk),
                           desc_kmajor<HD>(qt, KV_STEP, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_m64n64k16_ss(dpT, desc_kmajor<HD>(vt, BLK, 64 * c, kk),
                         desc_kmajor<HD>(dt, KV_STEP, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    float sl2s = sl2;  // the scores' scale in log2 units: the int8 path's factor
    if constexpr (I8::ON) {
      fence_regs(si);
#pragma unroll
      for (int x = 0; x < KV_STEP / 2; ++x) sT[x] = s32_to_f32(si[x]);
      sl2s = lse_s[3 * KV_STEP] * LOG2E;
    } else {
      fence_regs(sT);
    }
    fence_regs(dpT);
    // p^T and ds^T; MASK: by the ids, else every pair attends
    auto probs = [&](auto mask) {
      constexpr bool MASK = decltype(mask)::value;
#pragma unroll
      for (int j = 0; j < KV_STEP / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float ls = lse_s[col], dl = del_s[col];
          const int sq = MASK ? segq_s[col] : 0;
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int x = 4 * j + 2 * i2 + e;
            const bool ok = !MASK || (segk[i2] != 0 && sq == segk[i2]);
            const float p = ok ? ex2_approx(fmaf(sT[x], sl2s, -ls)) : 0.f;
            sT[x] = p;
            dpT[x] = p * (dpT[x] - dl) * scale;
          }
        }
      }
    };
    bool masked = true;
    if constexpr (HD < 128) {
      const int u = segq_s[KV_STEP];  // the step's one id, or 0
      masked = !__all_sync(0xffffffffu, u != 0 && segk[0] == u && segk[1] == u);
    }
    if (masked)
      probs(std::true_type());
    else
      probs(std::false_type());
    uint32_t pa[KV_STEP / 16][4], sa[KV_STEP / 16][4];
    to_a_frags(sT, pa);
    to_a_frags(dpT, sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV_STEP / 16; ++kk)
      wgmma_rs<HD>(dva, pa[kk], desc_mnmajor<HD>(dt, KV_STEP, kk));
#pragma unroll
    for (int kk = 0; kk < KV_STEP / 16; ++kk)
      wgmma_rs<HD>(dka, sa[kk], desc_mnmajor<HD>(qt, KV_STEP, kk));
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

  // the int8 path's q tiles of stages 0 and 1 lie where the epilogue stages: the
  // other warpgroup may still read them
  if constexpr (I8::ON) consumers_sync();
  epi.epilogue_dkv(dva, dka, smem + KV_K_OFF, smem + KV_V_OFF, b, h, k0, c, r0, Sk, H);
}

// dq: block = 128 q rows of one (b, h); consumer warpgroup c owns rows 64 c .. 64 c +
// 63.  Per K tile of 64 keys: s = q k^T and dp = do v^T, p and ds in registers, then
// dq += ds k.  I8::ON: q_map is the int8 q in [BLK, 128] boxes, k_map the bf16 kn,
// i8.step_map the int8 k; the block's 128 rows lie in one q tile, so one factor.
template <class Epi, class I8 = NoInt8, int HD = 128>
__device__ __forceinline__ void attn_dq_body(const CUtensorMap& q_map, const CUtensorMap& do_map,
                                             const CUtensorMap& k_map, const CUtensorMap& v_map,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             const int* __restrict__ q_seg,
                                             const int* __restrict__ kv_seg, int Sq, int Sk,
                                             int H, float scale, const Epi& epi,
                                             const I8& i8 = I8()) {
  static_assert(!I8::ON || HD == 128, "the s_int8 mode takes head dim 128");
  using L = QLayout<I8::ON, HD>;
  constexpr int STAGES = L::STAGES, OWN = L::OWN, STEP_T = L::STEP_T;
  constexpr int Q_Q_OFF = L::Q_OFF, Q_DO_OFF = L::DO_OFF, Q_K_OFF = L::K_OFF;
  constexpr int Q_V_OFF = L::V_OFF, Q_SEG_OFF = L::SEG_OFF;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
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
        mbar_expect_tx(own, (I8::ON ? OWN8 : OWN) + OWN);
        if constexpr (I8::ON)
          tma_load_4d(smem + Q_Q_OFF, &q_map, own, 0, h, q0, b);
        else
          tma_load_head<HD>(smem + Q_Q_OFF, &q_map, own, BLK, h, q0, b);
        tma_load_head<HD>(smem + Q_DO_OFF, &do_map, own, BLK, h, q0, b);
      }
      const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES, k0 = i * STEP;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        if (lane == 0) {
          uint8_t* kt = smem + Q_K_OFF + s * STEP_T;
          uint8_t* vt = smem + Q_V_OFF + s * STEP_T;
          mbar_expect_tx(&full[s], 2 * STEP_T + (I8::ON ? STEP8 : 0));
          tma_load_head<HD>(kt, &k_map, &full[s], STEP, h, k0, b);
          tma_load_head<HD>(vt, &v_map, &full[s], STEP, h, k0, b);
          if constexpr (I8::ON) {
            tma_load_4d(smem + L::K8_OFF + s * STEP8, &i8.step_map, &full[s], 0, h, k0, b);
          }
        }
        int* segs = reinterpret_cast<int*>(smem + Q_SEG_OFF) + s * STEP;
        int lo = 0, hi = 0;  // narrow: the least and largest id of the step
        for (int j = lane; j < STEP; j += 32) {
          const int id = seg_of(ksegb, k0 + j, Sk);
          segs[j] = id;
          lo = j == lane ? id : min(lo, id);
          hi = j == lane ? id : max(hi, id);
        }
        if constexpr (HD < 128) {
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
          if (lane == 0) reinterpret_cast<int*>(smem + L::SEGU_OFF)[s] = lo == hi ? lo : 0;
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
  const int r0 = 64 * c + 16 * warp;  // this warp's first q row of the block
  const int* qsegb = q_seg ? q_seg + (size_t)b * Sq : nullptr;
  float sl2s = sl2;  // the scores' scale in log2 units: the int8 path's factor
  if constexpr (I8::ON) sl2s = i8.factor(b, h, H, Sq, q0) * LOG2E;
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

  float dqa[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dqa[x] = 0.f;
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
    uint32_t si[I8::ON ? 32 : 1];  // s as s32 (the int8 path)
    mbar_wait(&full[s], (i / STAGES) & 1);
    // s, then dp as a second wgmma group: p is formed while dp runs
    wgmma_fence();
    if constexpr (I8::ON) {
      const uint32_t k8t = smem_u32(smem + L::K8_OFF + s * STEP8);
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk)
        wgmma_m64n64k32_s8(si, desc_kmajor8(qt, 64 * c, kk), desc_kmajor8(k8t, 0, kk), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(sc, desc_kmajor<HD>(qt, BLK, 64 * c, kk),
                           desc_kmajor<HD>(kt, STEP, 0, kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_m64n64k16_ss(dp, desc_kmajor<HD>(dt, BLK, 64 * c, kk),
                         desc_kmajor<HD>(vt, STEP, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if constexpr (I8::ON) {
      fence_regs(si);
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = s32_to_f32(si[x]);
    } else {
      fence_regs(sc);
    }
    // p; MASK: by the ids, else every pair attends
    auto probs = [&](auto mask) {
      constexpr bool MASK = decltype(mask)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sk = MASK ? segk_s[8 * j + 2 * t + e] : 0;
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int x = 4 * j + 2 * i2 + e;
            const bool ok = !MASK || (segq[i2] != 0 && sk == segq[i2]);
            sc[x] = ok ? ex2_approx(fmaf(sc[x], sl2s, -lse_r[i2])) : 0.f;
          }
        }
      }
    };
    bool masked = true;
    if constexpr (HD < 128) {
      const int u = reinterpret_cast<const int*>(smem + L::SEGU_OFF)[s];  // the step's id, or 0
      masked = !__all_sync(0xffffffffu, u != 0 && segq[0] == u && segq[1] == u);
    }
    if (masked)
      probs(std::true_type());
    else
      probs(std::false_type());
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
      wgmma_rs<HD>(dqa, sa[kk], desc_mnmajor<HD>(kt, STEP, kk));
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


// K4's epilogue: each warp's rows of the f32 accumulators (HD / 2 a thread) as
// bf16, staged in its own rows of the block's tiles for 16-byte stores
struct StoreGrads {
  bf16* dq;
  bf16* dk;
  bf16* dv;

  template <int R>
  __device__ __forceinline__ void epilogue_dkv(const float (&dva)[R], const float (&dka)[R],
                                               uint8_t* k_tile, uint8_t* v_tile, int b, int h,
                                               int k0, int c, int r0, int Sk, int H) const {
    constexpr int HD = 2 * R;
    const float one[2] = {1.f, 1.f};
    const size_t kh = ((size_t)b * Sk * H + h) * HD;
    store_rows_wg<HD>(dva, one, v_tile, BLK, r0, dv + kh, H * HD, k0 + r0, Sk);
    store_rows_wg<HD>(dka, one, k_tile, BLK, r0, dk + kh, H * HD, k0 + r0, Sk);
  }

  template <int R>
  __device__ __forceinline__ void epilogue_dq(const float (&dqa)[R], uint8_t* q_tile,
                                              uint8_t* do_tile, int b, int h, int q0, int c,
                                              int r0, int Sq, int H) const {
    constexpr int HD = 2 * R;
    const float one[2] = {1.f, 1.f};
    store_rows_wg<HD>(dqa, one, q_tile, BLK, r0, dq + ((size_t)b * Sq * H + h) * HD, H * HD,
                      q0 + r0, Sq);
  }
};

}  // namespace bwd_wg
}  // namespace
