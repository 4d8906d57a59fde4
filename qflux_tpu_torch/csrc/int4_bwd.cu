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
// dx in place, straight from the accumulator: one rounding, as JAX's f32 then
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
// Design (right and simple first, the shape of K5b, csrc/rq_int4_bwd.cu;
// wgmma, TMA and a pipelined ring are later work):
//   * one 256-thread block per 128 rows x 64 packed rows of q4, which are 128
//     dx columns: [kp0, kp0 + 64) from the low nibbles and [K/2 + kp0, ...)
//     from the high ones, as the TPU kernel's two accumulators acc_e / acc_o;
//     8 warps of 64 rows x 16 packed rows (32 dx columns, both planes);
//   * the contraction runs over N, 64 per step (four mma.sync.m16n8k16 bf16 x
//     bf16 -> f32 slices).  No transpose is needed: mma's B operand wants 2
//     contraction values of one output column per 32-bit register, and 2
//     consecutive n of one packed row, q4[kp, n..n+1], are neighbours in q4.
//     Each thread loads one word (4 n) of 4 packed rows, dequantizes both
//     nibble planes and packs pairs of n into words, stored as [kp][n / 2]
//     with a row pitch of 32 + 4 words, so the fragment loads are free of
//     bank conflicts;
//   * the scales scale[kp / 128, n] vary along the contraction: each byte is
//     dequantized with its own column's scale before the product, never
//     applied to the accumulator.  A thread dequantizes 4 packed rows that
//     share a group, so it loads 2 float4 of scales per step;
//   * g is read in 16-byte pieces (8 threads cover one 128-byte row segment)
//     into a row-major tile of pitch 144 bytes: the A fragment loads are free
//     of bank conflicts too;
//   * the next step's g, q4 and scale loads are issued before the current
//     step's MMAs (register prefetch), as in K6a;
//   * ragged M is masked by index.  The entry point refuses what the route
//     never sends (ops/int4_matmul.py:supports): K % 3072, N % 128 or a group
//     size other than 128, so N and K need no masking.
//
// Built without --use_fast_math: the f32 products and the bf16 rounding must
// be IEEE.

#include "common.cuh"

namespace {

constexpr int BM = 128;             // dx rows per block
constexpr int BKP = 64;             // packed q4 rows per block (2 * 64 dx columns)
constexpr int BN = 64;              // contraction (n) per step
constexpr int GROUP = 128;          // rows per scale group
constexpr int NTHREADS = 256;
constexpr int A_PITCH = BN + 8;     // bf16 per g-tile row: 64 data + 8 pad
constexpr int B_PITCH = BN / 2 + 4; // words per w-tile row (one packed row): 32 data + 4 pad

struct Smem {
  alignas(16) bf16 a[BM][A_PITCH];           // g: [m][n]
  alignas(16) uint32_t b[2][BKP][B_PITCH];   // w planes: [kp][n / 2], 2 n-values (bf16) a word
};

// one int4 value times its group scale, as dequantize_kernel_int4 (f32)
__device__ __forceinline__ float dequant(int v, float s) {
  return __fmul_rn(__int2float_rn(v), s);
}

// what one thread loads from device memory for one step
struct Fetch {
  int4 a[4];      // 16 bytes (8 bf16) of g in each of 4 rows
  uint32_t q[4];  // one word (4 n) of q4 in 4 consecutive packed rows
  float4 s[2];    // the word's 4 scales for the low / high plane's group
};

__global__ void __launch_bounds__(NTHREADS, 2)
int4_bwd_kernel(const bf16* __restrict__ gm, const int8_t* __restrict__ q4,
                const float* __restrict__ scale, void* __restrict__ dx, int M, int N, int K,
                int out_f32) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, kp0 = blockIdx.x * BKP;
  const int half = K >> 1;
  const int steps = N / BN;

  // g load roles: 16-byte piece ac of rows ar + 32 i, i = 0..3
  const int ac = tid & 7, ar = tid >> 3;
  // q4 load roles: word qw (n = 4 qw) of packed rows 4 qr .. 4 qr + 3
  const int qw = tid & 15, qr = tid >> 4;
  const int kp = kp0 + 4 * qr;  // half % 64 == 0: every packed row of the block is in
  const int8_t* qrow = q4 + (size_t)kp * N + 4 * qw;
  // GROUP % 4 == 0 and kp % 4 == 0: the four rows share one group in each plane
  const float* slo = scale + (size_t)(kp / GROUP) * N + 4 * qw;
  const float* shi = scale + (size_t)((half + kp) / GROUP) * N + 4 * qw;

  auto fetch = [&](int step, Fetch& ft) {
    const int n0 = step * BN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ar + 32 * i;
      ft.a[i] = row < M ? *reinterpret_cast<const int4*>(gm + (size_t)row * N + n0 + 8 * ac)
                        : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      ft.q[p] = *reinterpret_cast<const uint32_t*>(qrow + (size_t)p * N + n0);
    ft.s[0] = *reinterpret_cast<const float4*>(slo + n0);
    ft.s[1] = *reinterpret_cast<const float4*>(shi + n0);
  };

  auto stash = [&](const Fetch& ft) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<int4*>(&sm.a[ar + 32 * i][8 * ac]) = ft.a[i];
    const float sl[4] = {ft.s[0].x, ft.s[0].y, ft.s[0].z, ft.s[0].w};
    const float sh[4] = {ft.s[1].x, ft.s[1].y, ft.s[1].z, ft.s[1].w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // packed row 4 qr + p
      float wl[4], wh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n = 4 qw + j: byte j of the word
        const uint32_t b = ft.q[p] >> (8 * j);
        // sign-extended nibbles: low (b << 28) >> 28, high (b << 24) >> 28
        wl[j] = dequant(static_cast<int>(b << 28) >> 28, sl[j]);
        wh[j] = dequant(static_cast<int>(b << 24) >> 28, sh[j]);
      }
      *reinterpret_cast<uint2*>(&sm.b[0][4 * qr + p][2 * qw]) =
          make_uint2(pack_bf16(wl[0], wl[1]), pack_bf16(wl[2], wl[3]));
      *reinterpret_cast<uint2*>(&sm.b[1][4 * qr + p][2 * qw]) =
          make_uint2(pack_bf16(wh[0], wh[1]), pack_bf16(wh[2], wh[3]));
    }
  };

  const int wm = (warp >> 2) * 64, wk = (warp & 3) * 16;
  float acc[4][2][2][4];  // [m tile][packed-row tile][plane][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][p][r] = 0.f;

  Fetch ft;
  fetch(0, ft);
  for (int step = 0; step < steps; ++step) {
    stash(ft);
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1, ft);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 n of the step's 64
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(sm.a[wm + mt * 16 + g]);
        const uint32_t* r8 = reinterpret_cast<const uint32_t*>(sm.a[wm + mt * 16 + g + 8]);
        af[mt][0] = r0[kk * 8 + t];
        af[mt][1] = r8[kk * 8 + t];
        af[mt][2] = r0[kk * 8 + 4 + t];
        af[mt][3] = r8[kk * 8 + 4 + t];
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t* col = sm.b[p][wk + nt * 8 + g];
          const uint32_t b0 = col[kk * 8 + t], b1 = col[kk * 8 + 4 + t];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt][p], af[mt], b0, b1);
        }
    }
    __syncthreads();
  }

  // epilogue: one cast of the f32 sum; plane p writes columns p * K/2 + kp
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int kl = kp0 + wk + nt * 8 + 2 * t;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = p * half + kl;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mt * 16 + g + 8 * h;
          if (row >= M) continue;
          const float y0 = acc[mt][nt][p][2 * h], y1 = acc[mt][nt][p][2 * h + 1];
          const size_t o = (size_t)row * K + col;
          if (out_f32) {
            *reinterpret_cast<float2*>(static_cast<float*>(dx) + o) = make_float2(y0, y1);
          } else {
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dx) + o) = pack_bf16(y0, y1);
          }
        }
      }
    }
  }
}

}  // namespace

// Launch K6b on `stream`.  g [M, N] bf16, q4 [K/2, N] int8, scale [n_groups, N]
// f32, dx [M, K] bf16 (out_f32 = 0) or f32 (1), all contiguous and 16-byte
// aligned.  Takes K % 3072 == 0, N % 128 == 0 and n_groups * 128 == K (JAX's
// `supports`).  Returns a cudaError_t (0 = launched).
extern "C" int qflux_int4_bwd(const void* g, const void* q4, const void* scale, void* dx, int M,
                              int N, int K, int n_groups, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 3072 || N % 128 || n_groups * GROUP != K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(K / 2 / BKP, (M + BM - 1) / BM);
  int4_bwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const int8_t*>(q4),
      static_cast<const float*>(scale), dx, M, N, K, out_f32);
  return (int)cudaGetLastError();
}
