// Backward of the plain bidirectional flash attention, for Hopper: kernel K4 of the port.
//
// Replaces the three Pallas TPU kernels of qflux_tpu/ops/flash_attention.py's backward:
// _dqdkv_kernel (K4a, the merged backward of _bwd_merged), _dq_kernel (K4b) and
// _dkv_kernel (K4c, the split backward of _bwd).  The three compute one function and
// differ only in how the TPU's VMEM split the work and in the f32 order of the dq sum,
// so one backward serves all three.  From q, k, v (normed and roped), the segment ids,
// the out and lse of the forward (or, in a ring hop, the GLOBAL out and lse) and the
// cotangent do, it computes for every (b, h):
//
//   delta = rowsum(do * out)                                     (f32)
//   p     = exp(q k^T * scale - lse), 0 wherever the segment mask forbids (a select)
//   dv    = bf16(p)^T do
//   ds    = bf16(p * (do v^T - delta) * scale)
//   dq    = ds k,  dk = ds^T q                                   (f32, written bf16)
//
// GPU blocks run in parallel and in no order, so instead of the TPU's sequential q loop
// with dk / dv in VMEM scratch, three kernels run in order on one stream, with no
// atomics (the result is deterministic):
//
//   1. delta: one warp per (b, s, h) row;
//   2. dkv:   one block per 128-key tile of a head, 64 keys per consumer warpgroup;
//             the q tiles stream past and dv, dk accumulate in registers;
//   3. dq:    one block per 128-row q tile, 64 rows per consumer warpgroup; the K
//             tiles stream past and dq accumulates in registers.
//
// Fully masked rows (segment 0: lse = -1e30, so exp(s - lse) would be +inf) never
// evaluate exp: the mask selects p = 0 before any product, and with it ds, dv and dq of
// those rows are 0 whatever do holds there.
//
// What bounds it on an H100: five Sq x Sk x D GEMMs per head (scores, dp, dv, dq, dk),
// 10 * B * H * Sq * Sk * D operations (2.5x the forward's), against ~(5 Sq + 4 Sk) * B *
// H * D bf16 of device traffic: at the Qwen 832x576 shape 492 GFLOP, 0.497 ms at the
// 989 TFLOP/s bf16 peak, compute-bound on the tensor cores.  This design recomputes the
// scores and dp in both the dkv and the dq kernel, seven GEMMs instead of five, to keep
// the row-complete dq without atomics (an f32 atomicAdd dq would add in a different
// order on every call).
//
// What the design does about that: both kernels are warp specialised on the Hopper
// machinery of hopper.cuh (384 threads, one block per SM).  Warpgroup 0's first warp
// is the producer: it loads the block's own tiles once by TMA (k and v, or q and do)
// and then keeps a ring of streamed tiles in flight (q, do and their rows' lse,
// delta and segment ids; or k, v and the keys' ids), each stage on a `full`
// mbarrier and freed by an `empty` one.  Warpgroups 1 and 2 are the consumers and
// run every product as wgmma with f32 accumulators in registers (setmaxnreg hands
// them the registers the producer does not need at run time):
//   dkv, per 64-row q tile: s^T = k q^T and dp^T = v do^T (m64n64k16, both operands
//       in shared memory, K-major), p^T and ds^T in registers with the formula and
//       select above (exp in log2 units: lse times log2 e, one fused multiply-add
//       and ex2.approx a score), then dv += p^T do and dk += ds^T q (m64n128k16, p^T / ds^T as
//       the register A operand, do / q an MN-major B);
//   dq, per 64-key tile: s = q k^T and dp = do v^T (m64n64k16; p is formed while dp
//       is in the tensor cores), ds in registers, then dq += ds k (register A, k an
//       MN-major B).
// Keys and rows past the tensor are zero-filled by TMA and carry segment 0.  The
// epilogues stage each warp's rows in its own rows of a block tile for 16-byte
// stores.  The tile sizes are the register budget's: a dkv consumer holds two
// 64 x 128 f32 accumulators (128 registers a thread) beside the 64 x 64 s^T and
// dp^T (64) and their A fragments, which fits the 232 that setmaxnreg grants (the
// producer keeps 40: it spilled at 24).  hopper.cuh's mbar_timeout says why the
// trap is out of line: inlined, it held the consumers to 168 registers, and
// 32-row q tiles were the most that fitted.  The trap out of line, the 64-row
// tiles and then the softmax in log2 units were each a measured gain on an H100.
//
// Layouts: q/out/do/dq [B, Sq, H, D] and k/v/dk/dv [B, Sk, H, D] bf16 (row stride
// H * D), lse and delta [B, H, Sq] f32, q_seg [B, Sq] and kv_seg [B, Sk] int32, or both
// null (the unmasked case: every real token is segment 1).

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;            // the only head dim the kernels take
constexpr int DELTA_WARPS = 8;

// delta[b, h, s] = sum over d of do * out, in f32; one warp per (b, s, h) row
__global__ void __launch_bounds__(DELTA_WARPS * 32)
flash_delta_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                   float* __restrict__ delta, int rows, int Sq, int H) {
  const int row = blockIdx.x * DELTA_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  // row = (b * Sq + s) * H + h: [B, Sq, H, D] rows are contiguous D-vectors
  const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
  const size_t off = (size_t)row * D + lane * 4;
  const uint2 draw = *reinterpret_cast<const uint2*>(dout + off);
  const uint2 oraw = *reinterpret_cast<const uint2*>(out + off);
  const bf16* dp = reinterpret_cast<const bf16*>(&draw);
  const bf16* op = reinterpret_cast<const bf16*>(&oraw);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc += __bfloat162float(dp[j]) * __bfloat162float(op[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[((size_t)b * H + h) * Sq + s] = acc;
}

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
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int Sq, int Sk, int H, float scale) {
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

  // the warp's rows of dv and dk, staged in its own rows of the v and k tiles
  const float one[2] = {1.f, 1.f};
  const size_t kh = ((size_t)b * Sk * H + h) * D;
  store_rows_wg(dva, one, smem + KV_V_OFF, BLK, r0, dv + kh, H * D, k0 + r0, Sk);
  store_rows_wg(dka, one, smem + KV_K_OFF, BLK, r0, dk + kh, H * D, k0 + r0, Sk);
}

// dq: block = 128 q rows of one (b, h); consumer warpgroup c owns rows 64 c .. 64 c +
// 63.  Per K tile of 64 keys: s = q k^T and dp = do v^T, p and ds in registers, then
// dq += ds k.
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ q_seg,
                const int* __restrict__ kv_seg, bf16* __restrict__ dq, int Sq, int Sk, int H,
                float scale) {
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

  const float one[2] = {1.f, 1.f};
  store_rows_wg(dqa, one, smem + Q_Q_OFF, BLK, r0, dq + ((size_t)b * Sq * H + h) * D, H * D,
                q0 + r0, Sq);
}

}  // namespace

// Launch K4 on `stream`: delta (f32 [B, H, Sq] scratch), then dk / dv, then dq.
// q_seg [B, Sq] / kv_seg [B, Sk] int32, or both null (the unmasked case); q / k / v /
// do 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int qflux_flash_bwd(const void* q, const void* k, const void* v, const void* q_seg,
                               const void* kv_seg, const void* out, const void* lse,
                               const void* dout, void* delta, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap q_own, do_own, k_own, v_own, q_step, do_step, k_step, v_step;
  if (!encode_heads(&q_own, q, B, Sq, H, BLK) || !encode_heads(&do_own, dout, B, Sq, H, BLK) ||
      !encode_heads(&k_own, k, B, Sk, H, BLK) || !encode_heads(&v_own, v, B, Sk, H, BLK) ||
      !encode_heads(&q_step, q, B, Sq, H, KV_STEP) ||
      !encode_heads(&do_step, dout, B, Sq, H, KV_STEP) ||
      !encode_heads(&k_step, k, B, Sk, H, STEP) || !encode_heads(&v_step, v, B, Sk, H, STEP))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Q_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int rows = B * Sq * H;
  flash_delta_kernel<<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), dl, rows, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<<<dim3((Sk + BLK - 1) / BLK, H, B), NTHREADS, KV_SMEM, st>>>(
      k_own, v_own, q_step, do_step, ls, dl, qs, ks, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<<<dim3((Sq + BLK - 1) / BLK, H, B), NTHREADS, Q_SMEM, st>>>(
      q_own, do_own, k_step, v_step, ls, dl, qs, ks, static_cast<bf16*>(dq), Sq, Sk, H, scale);
  return (int)cudaGetLastError();
}
