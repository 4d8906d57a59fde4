// K6a: the fused W4A16 int4-dequant matmul forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel qflux_tpu/ops/int4_matmul.py:_fwd_kernel (driven by
// _fwd and int4_matmul).  It computes
//
//   out[m, n] = out( sum_{kp < K/2} x[m, kp] * wl[kp, n] + x[m, K/2 + kp] * wh[kp, n] )
//   wl[kp, n] = bf16( f32(lo(q4[kp, n])) * scale[kp / 128, n] )
//   wh[kp, n] = bf16( f32(hi(q4[kp, n])) * scale[K/256 + kp / 128, n] )
//
// where x [M, K] is bf16 (the wrapper casts it, as _int4_matmul_fwd_impl
// does before the TPU kernel), q4 [K/2, N] int8 the HALF-SPLIT packed int4
// weight (byte row kp: original row kp in the low nibble, row K/2 + kp in the
// high one), scale [K/128, N] f32 the group scales (the first K/256 rows cover
// the low plane), lo / hi the sign-extended nibbles, bf16() the round to
// nearest even, and out() the one cast of the f32 sum to the output's type
// (bf16 or f32, x's dtype).  The weights are exactly the plain version's
// (ops/int4_matmul.py:int4_matmul_reference) and every bf16 x bf16 product is
// exact in f32; only the order of the f32 sums differs.  Like the TPU kernel,
// it never writes the bf16 weight to device memory.
//
// What bounds it: bf16 tensor-core operations at the model's large shapes.  At
// M = 2048, K = 3072, N = 12288 (the MLP up-projection of a bs=1 512^2
// Qwen-Image-Edit forward) that is 2*M*K*N = 155 GFLOP, 0.156 ms at 989
// TFLOP/s; its bytes (x, the K*N/2 q4 read, the scales, out) are ~82 MB,
// 0.025 ms at 3.35 TB/s.  At M = 1 or 2 (the AdaLN mods, K = 3072, N = 18432)
// the q4 read bounds it: 28 MB, 0.009 ms.
//
// Design (the pipeline of int4_common.cuh; it replaces a first mma.sync body, which
// ran at 21% of the bf16 peak with one shared buffer and two block barriers a
// step):
//   * a block computes BM x 128 outputs, BM = 128 MT: two consumer warpgroups
//     of 64 MT rows each (MT = 1 or 2, chosen by shape in
//     ops/int4_matmul.py:_int4_plan), so one dequantized weight tile feeds
//     BM rows.  The dequantization costs ~4 instructions a weight; MT = 2
//     halves its share of the step where the grid still fills the card;
//   * a step is 32 packed rows: the x tiles of columns [k0, k0 + 32) and
//     [K/2 + k0, ...) (TMA, 64-byte swizzle, ragged M zero-filled), the raw q4
//     tile [32, 128] (TMA) and its two scale rows (cp.async.bulk; 32 | 128, so
//     one group a plane), four stages in flight;
//   * each consumer thread dequantizes 2 x 8 bytes of the q4 tile (dequant8:
//     the nibbles to f32 by a byte permute into 2^23's mantissa, one IEEE
//     product with the group scale, one cvt.rn.bf16x2) into the two bf16
//     planes of B, stored MN-major (q4 is N-contiguous) with a 128-byte
//     swizzle: rows of 64 n, one row per k, 8-row atoms of 1024 bytes;
//   * per step and warpgroup, 2 planes x 2 k16 x MT wgmma.m64n128k16 (A = x
//     K-major, B = the plane MN-major), all into one f32 accumulator per 64
//     rows: the two planes are two halves of the contraction, as the TPU
//     kernel's two dots per tile;
//   * where the output tiles fill less than the card (the text stream's M =
//     256 at N = 3072, M = 1-2 at K = 12288), the contraction is split across
//     blocks on whole 128-row scale groups (blockIdx.z); each split writes its
//     f32 partial sums to a workspace and int4_fwd_kernel_reduce adds them in
//     split order and casts once: deterministic, no atomics.
//   Tried on an H100 and not kept (PERF.md, Findings): a two-block cluster that
//   multicasts the x tiles (slower), steps of one plane over 64 packed rows
//   (128-byte x rows; no faster), six stages at MT = 1 (no faster), and
//   skipping the products of a warpgroup whose rows lie past M (the branch
//   made ptxas serialize every wgmma).
//   The entry point refuses what the route never sends
//   (ops/int4_matmul.py:supports): K % 3072, N % 128 or a group size other
//   than 128.
//
// Built without --use_fast_math: the f32 products and the bf16 rounding must
// be IEEE.

#include "common.cuh"
#include "int4_common.cuh"

namespace {

constexpr int BN = 128;          // output columns per block
constexpr int BKP = 32;          // packed q4 rows per step (= k of each plane)
constexpr int GROUP = 128;       // rows per scale group
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int B_PLANE = BKP * BN * 2;   // bytes of one dequantized plane (8 KB)
constexpr int B_CHUNK = BKP * 128;      // bytes of one 64-column chunk of a plane
constexpr int Q_BYTES = BKP * BN;       // raw q4 tile
constexpr int S_BYTES = 2 * BN * 4;     // the two scale rows

template <int MT>
struct Layout {
  static constexpr int BM = 128 * MT;
  static constexpr int X_PLANE = BM * BKP * 2;          // one x tile (64-byte rows)
  static constexpr int B_OFF = 0;                       // 3 x 2 planes
  static constexpr int X_OFF = B_OFF + 3 * 2 * B_PLANE; // STAGES x 2 planes
  static constexpr int Q_OFF = X_OFF + STAGES * 2 * X_PLANE;
  static constexpr int S_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int BAR_OFF = S_OFF + STAGES * S_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static constexpr int SMEM = BYTES + 1024;  // slack to align the base to 1024
};

template <int MT>
__global__ void __launch_bounds__(NTHREADS, 1)
int4_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap q_map, const float* __restrict__ scale,
                void* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int splits,
                int out_f32) {
  using L = Layout<MT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int half = K >> 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * L::BM;
  // this split's packed rows: whole scale groups
  const int chunks = half / GROUP, z = blockIdx.z;
  const int c_begin = z * chunks / splits, c_end = (z + 1) * chunks / splits;
  const int kp_begin = c_begin * GROUP;
  const int steps = (c_end - c_begin) * (GROUP / BKP);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const float* slo = scale + n0;
      const float* shi = scale + (size_t)(half / GROUP) * N + n0;
      for (int s = 0; s < steps; ++s) {
        const int st = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[st], ((s / STAGES) - 1) & 1);
        const int kp = kp_begin + s * BKP;
        uint8_t* xs = smem + L::X_OFF + st * 2 * L::X_PLANE;
        float* ss = reinterpret_cast<float*>(smem + L::S_OFF + st * S_BYTES);
        mbar_expect_tx(&full[st], 2 * L::X_PLANE + Q_BYTES + S_BYTES);
        tma_load_2d(xs, &x_map, &full[st], kp, m0);
        tma_load_2d(xs + L::X_PLANE, &x_map, &full[st], half + kp, m0);
        tma_load_2d(smem + L::Q_OFF + st * Q_BYTES, &q_map, &full[st], n0, kp);
        const size_t g = (size_t)(kp / GROUP) * N;
        bulk_load(ss, slo + g, BN * 4, &full[st]);
        bulk_load(ss + BN, shi + g, BN * 4, &full[st]);
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1;             // consumer warpgroup: rows [64 MT c, 64 MT (c + 1))
  const int ct = threadIdx.x - 128; // 0..255 over both consumers
  const int lane = threadIdx.x & 31;
  // dequantization roles: columns 8 o .. 8 o + 7 of packed rows ct / 16 + 16 i
  const int o = ct & 15, kr = ct >> 4;

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
      uint8_t* b = smem + L::B_OFF + buf * 2 * B_PLANE;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = kr + 16 * i;
        const uint2 w = *reinterpret_cast<const uint2*>(q + k * BN + 8 * o);
        uint4 lo, hi;
        dequant8(w.x, w.y, sl, sh, lo, hi);
        const int off = (o >> 3) * B_CHUNK + k * 128 + (((o & 7) ^ (k & 7)) << 4);
        *reinterpret_cast<uint4*>(b + off) = lo;
        *reinterpret_cast<uint4*>(b + B_PLANE + off) = hi;
      }
    }
    fence_proxy_async();
    consumers_sync();
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t b_addr = base + L::B_OFF + (buf * 2 + p) * B_PLANE + kk * 2048;
        const uint64_t db = wgmma_desc(b_addr, B_CHUNK, 1024, 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a_addr = base + L::X_OFF + (st * 2 + p) * L::X_PLANE +
                                  (MT * c + mt) * 64 * 64 + kk * 32;
          wgmma_m64n128k16<1>(acc[mt], wgmma_desc(a_addr, 16, 512, 2), db);
        }
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

  store_tile<MT>(acc, m0 + 64 * MT * c, M, N, [&](int j) { return n0 + 8 * j; }, splits, z, ws,
                 out, out_f32);
}

__global__ void int4_fwd_kernel_reduce(const float* __restrict__ ws, void* __restrict__ out,
                                       long long n4, int splits, int out_f32) {
  splitk_reduce_body(ws, out, n4, splits, out_f32);
}

template <int MT>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& qm, const float* scale, void* out,
                   float* ws, int M, int N, int K, int splits, int out_f32, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_fwd_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<MT>::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid(N / BN, (M + Layout<MT>::BM - 1) / Layout<MT>::BM, splits);
  int4_fwd_kernel<MT><<<grid, NTHREADS, Layout<MT>::SMEM, stream>>>(xm, qm, scale, out, ws, M, N,
                                                                   K, splits, out_f32);
  return cudaGetLastError();
}

}  // namespace

// Launch K6a on `stream`.  x [M, K] bf16, q4 [K/2, N] int8, scale [n_groups, N]
// f32, out [M, N] bf16 (out_f32 = 0) or f32 (1), all contiguous and 16-byte
// aligned.  mt (1 or 2) picks 128 or 256 rows a block; splits (1 .. K/256)
// splits the contraction on whole scale groups, with ws the workspace of
// splits * M * N f32 (unused, may be null, at splits = 1).
// Takes K % 3072 == 0, N % 128 == 0 and n_groups * 128 == K (JAX's
// `supports`).  Returns a cudaError_t (0 = launched).
extern "C" int qflux_int4_fwd(const void* x, const void* q4, const void* scale, void* out, int M,
                              int N, int K, int n_groups, int out_f32, int mt, int splits,
                              void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 3072 || N % BN || n_groups * GROUP != K ||
      (mt != 1 && mt != 2) || splits < 1 || splits > K / 2 / GROUP || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, qm;
  if (!encode_2d_cached(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 128 * mt, BKP,
                        CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d_cached(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q4, K / 2, N, BKP, BN,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  const cudaError_t e = mt == 2 ? launch<2>(xm, qm, sc, out, w, M, N, K, splits, out_f32, st)
                                : launch<1>(xm, qm, sc, out, w, M, N, K, splits, out_f32, st);
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)splitk_reduce(int4_fwd_kernel_reduce, w, out, (long long)M * N, splits, out_f32,
                            st);
}
