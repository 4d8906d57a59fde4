// K5b: the W4A8-requant matmul's backward (dx), for Hopper (sm_90a).
//
// Replaces the TPU kernel qflux_tpu/ops/int4_matmul.py:_rq_bwd_kernel (driven by
// _rq_bwd and the vjp of ops/quant.py:rq_fused_matmul).  It computes
//
//   dx[m, k]  = out( f32(acc[m, k]) * sg[m] ),
//   acc[m, k] = sum_n gq[m, n] * q8[k, n]                          (exact int32)
//   q8[k, n]  = clip(rint(f32(nibble(k, n)) * f[k / gsz, n]), -127, 127)
//
// where gq [M, N] int8 is the row-quantized cotangent (g * s_vec, quantized
// per row with the scales sg [M] f32), q4 [K/2, N] int8 the HALF-SPLIT packed
// int4 weight (byte row i: original row i in the low nibble, row i + K/2 in the
// high one) and f [K/gsz, N] f32 the requant factors; out() is the cast to the
// output's type (bf16, round to nearest even, or f32).  The TPU kernel writes
// the int32 halves acc[:, :K/2] and acc[:, K/2:] and leaves the scaling by sg
// to XLA; here the epilogue applies it, with the same single f32 product.
// Bit-identical to the plain version (ops/quant.py:requant_int4_matmul_dx):
// the same regrid (round half to even, clip), exact int32 accumulation
// (|acc| <= 127^2 * N < 2^31 for every N <= 133,000), one f32 product and one
// cast.  Like K5a it never writes q8 to device memory.
//
// What bounds it: int8 tensor-core operations.  At M = 3744, N = 12288,
// K = 3072 (the dx of the MLP up-projection of a bs=1 832x576 Qwen-Image-Edit
// train step) that is 2*M*N*K = 283 GOP, 0.143 ms at 1,979 TOPS; its bytes (gq,
// the K*N/2 q4 read, f, dx in bf16) are ~89 MB, 0.027 ms at 3.35 TB/s.
//
// Design (right and simple first, the shape of K5a; wgmma, TMA and a pipelined
// ring are later work):
//   * one 256-thread block per 128 rows x 64 packed rows of q4, which are 128
//     dx columns: [kp0, kp0 + 64) from the low nibbles and [K/2 + kp0, ...)
//     from the high ones, as the TPU kernel's two accumulators acc_e / acc_o;
//     8 warps of 64 rows x 16 packed rows (32 dx columns, both planes);
//   * the contraction runs over N, 64 per step (two mma.sync.m16n8k32 s8 x s8
//     -> s32 slices).  No transpose is needed: mma's B operand wants 4
//     contraction bytes of one output column per 32-bit register, and 4
//     consecutive n of one packed row, q4[kp, n..n+3], are one aligned word of
//     q4.  Regridding its 4 bytes gives the B words of output columns kp (low
//     nibbles) and kp + K/2 (high nibbles) directly; each goes to shared memory
//     as words [kp][n / 4], row pitch 16 + 4 words, so the fragment loads are
//     free of bank conflicts;
//   * the factors f[k / gsz, n] vary along the contraction: each byte is
//     regridded with its own column's factor before the integer product,
//     never applied to the accumulator.  A thread regrids 4 packed rows that
//     share a group (gsz % 4 == 0), so it loads 2 float4 of factors per step;
//   * gq is read in 8-byte pieces (8 threads cover one 64-byte row segment)
//     into a row-major tile of pitch 80 bytes: the A fragment loads are free
//     of bank conflicts too;
//   * the next step's gq, q4 and factor loads are issued before the current
//     step's MMAs (register prefetch), as in K5a;
//   * ragged M, N and K are masked by index.  Requirements (the wrapper checks
//     them): K % 64 == 0, N % 8 == 0, gsz % 4 == 0 and K % gsz == 0 -- the same
//     as K5a, so every int4-requant GEMM of the model qualifies, including
//     K = 64 (one group over both nibble planes, half a block of packed rows)
//     and N = 64.
//
// Built without --use_fast_math: rint and the f32 products must be IEEE.

#include "common.cuh"

namespace {

constexpr int BM = 128;             // dx rows per block
constexpr int BKP = 64;             // packed q4 rows per block (2 * 64 dx columns)
constexpr int BN = 64;              // contraction (n) per step
constexpr int NTHREADS = 256;
constexpr int A_PITCH = BN + 16;    // bytes per gq-tile row: 64 data + 16 pad
constexpr int B_PITCH = BN / 4 + 4; // words per q8-tile row (one packed row): 16 data + 4 pad

struct Smem {
  alignas(16) int8_t a[BM][A_PITCH];            // gq: [m][n]
  alignas(16) uint32_t b[2][BKP][B_PITCH];      // q8 planes: [kp][n / 4], 4 n-bytes a word
};

// one int4 value onto the per-channel int8 grid, as quant._requant_q8
__device__ __forceinline__ uint32_t regrid(int v, float f) {
  int r = __float2int_rn(__fmul_rn(__int2float_rn(v), f));
  return static_cast<uint32_t>(min(max(r, -127), 127)) & 0xFFu;
}

// what one thread loads from device memory for one step
struct Fetch {
  int2 a[4];      // 8 bytes of gq in each of 4 rows
  uint32_t q[4];  // one word (4 n) of q4 in 4 consecutive packed rows
  float4 f[2];    // the word's 4 factors for the low / high plane's group
};

__global__ void __launch_bounds__(NTHREADS, 2)
rq_int4_bwd_kernel(const int8_t* __restrict__ gq, const int8_t* __restrict__ q4,
                   const float* __restrict__ fac, const float* __restrict__ sg,
                   void* __restrict__ dx, int M, int N, int K, int gsz, int out_f32) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, kp0 = blockIdx.x * BKP;
  const int half = K >> 1;
  const int steps = (N + BN - 1) / BN;

  // gq load roles: 8-byte piece ac of rows ar + 32 i, i = 0..3
  const int ac = tid & 7, ar = tid >> 3;
  // q4 load roles: word qw (n = 4 qw) of packed rows 4 qr .. 4 qr + 3
  const int qw = tid & 15, qr = tid >> 4;
  const int kp = kp0 + 4 * qr;
  const bool kp_ok = kp < half;  // half % 4 == 0: the four rows are all in or all out
  const int8_t* qrow = q4 + (size_t)(kp_ok ? kp : 0) * N + 4 * qw;
  // gsz % 4 == 0 and kp % 4 == 0: the four rows share one group in each plane
  const float* flo = fac + (size_t)(kp_ok ? kp / gsz : 0) * N + 4 * qw;
  const float* fhi = fac + (size_t)(kp_ok ? (kp + half) / gsz : 0) * N + 4 * qw;

  auto fetch = [&](int step, Fetch& ft) {
    const int n0 = step * BN;
    const int na = n0 + 8 * ac;  // N % 8 == 0: a piece is all in or all out
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ar + 32 * i;
      ft.a[i] = (row < M && na < N)
                    ? *reinterpret_cast<const int2*>(gq + (size_t)row * N + na)
                    : make_int2(0, 0);
    }
    const bool q_ok = kp_ok && n0 + 4 * qw < N;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      ft.q[p] = q_ok ? *reinterpret_cast<const uint32_t*>(qrow + (size_t)p * N + n0) : 0u;
    const float4 zf4 = make_float4(0.f, 0.f, 0.f, 0.f);
    ft.f[0] = q_ok ? *reinterpret_cast<const float4*>(flo + n0) : zf4;
    ft.f[1] = q_ok ? *reinterpret_cast<const float4*>(fhi + n0) : zf4;
  };

  auto stash = [&](const Fetch& ft) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<int2*>(&sm.a[ar + 32 * i][8 * ac]) = ft.a[i];
    const float fl[4] = {ft.f[0].x, ft.f[0].y, ft.f[0].z, ft.f[0].w};
    const float fh[4] = {ft.f[1].x, ft.f[1].y, ft.f[1].z, ft.f[1].w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // packed row 4 qr + p
      uint32_t wl = 0, wh = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n = 4 qw + j: byte j of the word, in and out
        const uint32_t b = ft.q[p] >> (8 * j);  // the byte in bits 0..7
        wl |= regrid(static_cast<int>(b << 28) >> 28, fl[j]) << (8 * j);
        wh |= regrid(static_cast<int>(b << 24) >> 28, fh[j]) << (8 * j);
      }
      sm.b[0][4 * qr + p][qw] = wl;
      sm.b[1][4 * qr + p][qw] = wh;
    }
  };

  const int wm = (warp >> 2) * 64, wk = (warp & 3) * 16;
  int acc[4][2][2][4];  // [m tile][packed-row tile][plane][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][p][r] = 0;

  Fetch ft;
  fetch(0, ft);
  for (int step = 0; step < steps; ++step) {
    stash(ft);
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1, ft);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // 32 n of the step's 64
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
          for (int mt = 0; mt < 4; ++mt) mma_s8(acc[mt][nt][p], af[mt], b0, b1);
        }
    }
    __syncthreads();
  }

  // epilogue: f32(acc) * sg[row], one cast; plane p writes columns p * K/2 + kp
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int kl = kp0 + wk + nt * 8 + 2 * t;
    if (kl >= half) continue;  // half % 32 == 0: kl + 1 < half too
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = p * half + kl;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mt * 16 + g + 8 * h;
          if (row >= M) continue;
          const float s = sg[row];
          const float y0 = __fmul_rn(__int2float_rn(acc[mt][nt][p][2 * h]), s);
          const float y1 = __fmul_rn(__int2float_rn(acc[mt][nt][p][2 * h + 1]), s);
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

// Launch K5b on `stream`.  gq [M, N] int8, q4 [K/2, N] int8, fac [K/gsz, N] f32,
// sg [M] f32, dx [M, K] bf16 (out_f32 = 0) or f32 (1), all contiguous and
// 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int qflux_rq_int4_bwd(const void* gq, const void* q4, const void* fac, const void* sg,
                                 void* dx, int M, int N, int K, int gsz, int out_f32,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K % 64 || N % 8 || gsz <= 0 || gsz % 4 || K % gsz)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((K / 2 + BKP - 1) / BKP, (M + BM - 1) / BM);
  rq_int4_bwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(gq), static_cast<const int8_t*>(q4),
      static_cast<const float*>(fac), static_cast<const float*>(sg), dx, M, N, K, gsz, out_f32);
  return (int)cudaGetLastError();
}
