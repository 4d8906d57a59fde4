// K6b: the W4A16 int4-dequant matmul's backward (dx), for Hopper (sm_90a).
//
// Replaces the TPU kernel qflux_tpu/ops/int4_matmul.py:_bwd_kernel (driven by
// _bwd and the vjp of int4_matmul, _int4_vjp_bwd).  It computes
//
//   dx[m, kp]       = out( sum_n g[m, n] * wl[kp, n] )        kp < K/2
//   dx[m, K/2 + kp] = out( sum_n g[m, n] * wh[kp, n] )
//   wl[kp, n] = bf16( f32(lo(q4[kp, n])) * scale[kp / 128, n] )
//   wh[kp, n] = bf16( f32(hi(q4[kp, n])) * scale[K/256 + kp / 128, n] )
//
// where g [M, N] is the cotangent in bf16 (the wrapper casts it, as
// _int4_vjp_bwd does), q4 [K/2, N] int8 the HALF-SPLIT packed int4 weight and
// scale [K/128, N] f32 its group scales (the layout of K6a, csrc/int4_fwd.cu),
// and out() the one cast of the f32 sum to dx's type (bf16 or f32, g's dtype).
// The TPU kernel writes the two f32 halves dx_lo / dx_hi and leaves the
// concatenation and the cast to XLA; here the epilogue writes both halves of
// dx in place, straight from the accumulators: one rounding, as JAX's f32 then
// astype.  The weights are exactly the plain version's
// (ops/int4_matmul.py:int4_matmul_dx_reference) and every product is exact in
// f32; only the order of the f32 sums differs.  No gradient for q4 or the
// scales (they are frozen).
//
// What bounds it: bf16 tensor-core operations.  At M = 2048, N = 12288,
// K = 3072 (the dx of the MLP up-projection of a bs=1 512^2 Qwen-Image-Edit
// train step) that is 2*M*N*K = 155 GFLOP, 0.156 ms at 989 TFLOP/s; its bytes
// (g, the K*N/2 q4 read, the scales, dx) are ~76 MB, 0.023 ms at 3.35 TB/s.
//
// Design (the pipeline of int4_common.cuh, K6a's transposed; it replaces a first
// mma.sync body):
//   * a block computes BM rows (BM = 128 MT, MT = 1 or 2 by shape, as K6a) x
//     64 packed rows of q4, which are 128 dx columns: [kp0, kp0 + 64) from the
//     low nibbles and [K/2 + kp0, ...) from the high ones, the TPU kernel's two
//     accumulators acc_e / acc_o;
//   * the contraction runs over N, 64 per step: the g tile [BM, 64] (TMA,
//     128-byte swizzle), the raw q4 tile [64 kp, 64 n] (TMA) and its two scale
//     row segments (cp.async.bulk; kp0 % 64 == 0, so one group a plane), four
//     stages in flight;
//   * B is the dequantized tile stored K-major, the ordinary layout: 128 rows
//     (64 low-plane kp, then 64 high-plane kp) of 64 n, 128-byte swizzle.  The
//     scales vary along the contraction, so each byte is dequantized with its
//     own column's scale before the product (dequant8), never applied to the
//     accumulator.  Because the two planes are consecutive rows of one B
//     tile, one wgmma.m64n128k16 per 64 rows and k16 computes both: the
//     accumulator's columns 0..63 are dx's low half, 64..127 its high half;
//   * split over N on 128-column chunks where the output tiles fill less than
//     the card (dx of the MLP up-projection at M = 256, M = 1-2), into an f32
//     workspace reduced in split order by int4_bwd_kernel_reduce:
//     deterministic;
//   * ragged M is zero-filled by TMA and masked by index in the epilogue.  The
//     entry point refuses what the route never sends
//     (ops/int4_matmul.py:supports): K % 3072, N % 128 or a group size other
//     than 128, so N and K need no masking.
//
// Built without --use_fast_math: the f32 products and the bf16 rounding must
// be IEEE.

#include "common.cuh"
#include "int4_common.cuh"

namespace {

constexpr int BKP = 64;          // packed q4 rows per block (2 * 64 dx columns)
constexpr int BN = 64;           // contraction (n) per step
constexpr int NCHUNK = 128;      // contraction a split is cut on
constexpr int GROUP = 128;       // rows per scale group
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;
constexpr int B_TILE = 2 * BKP * BN * 2;  // both planes, 128 rows of 128 bytes (16 KB)
constexpr int Q_BYTES = BKP * BN;         // raw q4 tile
constexpr int S_BYTES = 2 * BN * 4;       // the two scale row segments

template <int MT>
struct Layout {
  static constexpr int BM = 128 * MT;
  static constexpr int G_TILE = BM * BN * 2;      // 128-byte rows
  static constexpr int B_OFF = 0;                 // 3 B tiles
  static constexpr int G_OFF = B_OFF + 3 * B_TILE;
  static constexpr int Q_OFF = G_OFF + STAGES * G_TILE;
  static constexpr int S_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int BAR_OFF = S_OFF + STAGES * S_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static constexpr int SMEM = BYTES + 1024;
};

template <int MT>
__global__ void __launch_bounds__(NTHREADS, 1)
int4_bwd_kernel(const __grid_constant__ CUtensorMap g_map,
                const __grid_constant__ CUtensorMap q_map, const float* __restrict__ scale,
                void* __restrict__ dx, float* __restrict__ ws, int M, int N, int K, int splits,
                int out_f32) {
  using L = Layout<MT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int half = K >> 1;
  const int kp0 = blockIdx.x * BKP, m0 = blockIdx.y * L::BM;
  const int chunks = N / NCHUNK, z = blockIdx.z;
  const int c_begin = z * chunks / splits, c_end = (z + 1) * chunks / splits;
  const int n_begin = c_begin * NCHUNK;
  const int steps = (c_end - c_begin) * (NCHUNK / BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const float* slo = scale + (size_t)(kp0 / GROUP) * N;
      const float* shi = scale + (size_t)((half + kp0) / GROUP) * N;
      for (int s = 0; s < steps; ++s) {
        const int st = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[st], ((s / STAGES) - 1) & 1);
        const int n0 = n_begin + s * BN;
        float* ss = reinterpret_cast<float*>(smem + L::S_OFF + st * S_BYTES);
        mbar_expect_tx(&full[st], L::G_TILE + Q_BYTES + S_BYTES);
        tma_load_2d(smem + L::G_OFF + st * L::G_TILE, &g_map, &full[st], n0, m0);
        tma_load_2d(smem + L::Q_OFF + st * Q_BYTES, &q_map, &full[st], n0, kp0);
        bulk_load(ss, slo + n0, BN * 4, &full[st]);
        bulk_load(ss + BN, shi + n0, BN * 4, &full[st]);
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int ct = threadIdx.x - 128;
  const int lane = threadIdx.x & 31;
  // dequantization roles: n 8 o .. 8 o + 7 of packed rows ct / 8 + 32 i
  const int o = ct & 7, kr = ct >> 3;

  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;

  const uint32_t base = smem_u32(smem);
  for (int s = 0; s < steps; ++s) {
    const int st = s % STAGES, buf = s % 3;
    mbar_wait(&full[st], (s / STAGES) & 1);
    {
      const uint8_t* q = smem + L::Q_OFF + st * Q_BYTES;
      const float* ss = reinterpret_cast<const float*>(smem + L::S_OFF + st * S_BYTES);
      float sl[8], sh[8];
      *reinterpret_cast<float4*>(sl) = *reinterpret_cast<const float4*>(ss + 8 * o);
      *reinterpret_cast<float4*>(sl + 4) = *reinterpret_cast<const float4*>(ss + 8 * o + 4);
      *reinterpret_cast<float4*>(sh) = *reinterpret_cast<const float4*>(ss + BN + 8 * o);
      *reinterpret_cast<float4*>(sh + 4) = *reinterpret_cast<const float4*>(ss + BN + 8 * o + 4);
      uint8_t* b = smem + L::B_OFF + buf * B_TILE;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kp = kr + 32 * i;
        const uint2 w = *reinterpret_cast<const uint2*>(q + kp * BN + 8 * o);
        uint4 lo, hi;
        dequant8(w.x, w.y, sl, sh, lo, hi);
        // rows kp (low plane) and 64 + kp (high plane): 64 + kp has kp's swizzle
        const int off = kp * 128 + ((o ^ (kp & 7)) << 4);
        *reinterpret_cast<uint4*>(b + off) = lo;
        *reinterpret_cast<uint4*>(b + BKP * 128 + off) = hi;
      }
    }
    fence_proxy_async();
    consumers_sync();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db = wgmma_desc(base + L::B_OFF + buf * B_TILE + kk * 32, 16, 1024, 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t a_addr =
            base + L::G_OFF + st * L::G_TILE + (MT * c + mt) * 64 * 128 + kk * 32;
        wgmma_m64n128k16<0>(acc[mt], wgmma_desc(a_addr, 16, 1024, 1), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(s - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

  // accumulator columns 0..63 are dx's low half, 64..127 its high half
  store_tile<MT>(acc, m0 + 64 * MT * c, M, K,
                 [&](int j) { return (j < 8 ? kp0 : half + kp0 - BKP) + 8 * j; }, splits, z, ws,
                 dx, out_f32);
}

__global__ void int4_bwd_kernel_reduce(const float* __restrict__ ws, void* __restrict__ out,
                                       long long n4, int splits, int out_f32) {
  splitk_reduce_body(ws, out, n4, splits, out_f32);
}

template <int MT>
cudaError_t launch(const CUtensorMap& gm, const CUtensorMap& qm, const float* scale, void* dx,
                   float* ws, int M, int N, int K, int splits, int out_f32, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_bwd_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<MT>::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid(K / 2 / BKP, (M + Layout<MT>::BM - 1) / Layout<MT>::BM, splits);
  int4_bwd_kernel<MT><<<grid, NTHREADS, Layout<MT>::SMEM, stream>>>(gm, qm, scale, dx, ws, M, N,
                                                                   K, splits, out_f32);
  return cudaGetLastError();
}

}  // namespace

// Launch K6b on `stream`.  g [M, N] bf16, q4 [K/2, N] int8, scale [n_groups, N]
// f32, dx [M, K] bf16 (out_f32 = 0) or f32 (1), all contiguous and 16-byte
// aligned.  mt (1 or 2) picks 128 or 256 rows a block; splits (1 .. N/128)
// splits the contraction over N on 128-column chunks, with ws the workspace of
// splits * M * K f32 (unused, may be null, at splits = 1).
// Takes K % 3072 == 0, N % 128 == 0 and n_groups * 128 == K (JAX's
// `supports`).  Returns a cudaError_t (0 = launched).
extern "C" int qflux_int4_bwd(const void* g, const void* q4, const void* scale, void* dx, int M,
                              int N, int K, int n_groups, int out_f32, int mt, int splits,
                              void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 3072 || N % NCHUNK || n_groups * GROUP != K ||
      (mt != 1 && mt != 2) || splits < 1 || splits > N / NCHUNK || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  CUtensorMap gm, qm;
  if (!encode_2d_cached(&gm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g, M, N, 128 * mt, BN,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d_cached(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q4, K / 2, N, BKP, BN,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  const cudaError_t e = mt == 2 ? launch<2>(gm, qm, sc, dx, w, M, N, K, splits, out_f32, st)
                                : launch<1>(gm, qm, sc, dx, w, M, N, K, splits, out_f32, st);
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)splitk_reduce(int4_bwd_kernel_reduce, w, dx, (long long)M * K, splits, out_f32,
                            st);
}
