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
// (ops/int4_matmul.py:int4_matmul_reference: dequantize_kernel_int4 to bf16)
// and every bf16 x bf16 product is exact in f32; only the order of the f32
// sums differs.  Like the TPU kernel, it never writes the bf16 weight to
// device memory: each q4 tile is dequantized in registers and lands in shared
// memory in the order mma's fragments read it.
//
// What bounds it: bf16 tensor-core operations at the model's large shapes.  At
// M = 2048, K = 3072, N = 12288 (the MLP up-projection of a bs=1 512^2
// Qwen-Image-Edit forward) that is 2*M*K*N = 155 GFLOP, 0.156 ms at 989
// TFLOP/s; its bytes (x, the K*N/2 q4 read, the scales, out) are ~82 MB,
// 0.025 ms at 3.35 TB/s.  At M = 1 or 2 (the AdaLN mods, K = 3072, N = 18432)
// the q4 read bounds it: 28 MB, 0.009 ms.
//
// Design (right and simple first; wgmma, TMA and a pipelined ring are later
// work):
//   * one 256-thread block per 128 x 128 output tile, 8 warps of 64 x 32;
//   * the K loop walks 32 packed rows per step: each step multiplies the x
//     columns [k0, k0 + 32) against the low nibbles and [K/2 + k0, ...) against
//     the high nibbles (mma.sync.m16n8k16 bf16 x bf16 -> f32, two k16 slices
//     per plane), as the TPU kernel's two dots per tile;
//   * mma's B operand wants 2 consecutive k of one column per 32-bit register
//     while q4 is [K/2, N] row-major.  Each thread loads a 4 x 4 byte block of
//     q4 (4 rows, 4 columns; lanes along N, so the loads are coalesced),
//     dequantizes both nibble planes in registers (int -> f32, one IEEE product
//     with the group's scale, one round to bf16) and packs each column's pairs
//     of rows into words.  The tile is stored as words [k / 2][n] with a row
//     pitch of BN + 8 words, so the fragment loads are free of bank conflicts.
//     No transposed copy of the weight is kept anywhere;
//   * x is staged row-major with a pitch of 40 bf16 (80 bytes), so the A
//     fragment loads are free of bank conflicts too;
//   * the next step's x, q4 and scale loads are issued before the current
//     step's MMAs (register prefetch), so their latency hides behind them;
//   * ragged M is masked by index (rows past M load zeros and are not
//     written), so M = 1 and 2 need no padded copy.  The entry point refuses
//     what the route never sends (ops/int4_matmul.py:supports): K % 3072,
//     N % 128 or a group size other than 128.
//
// Built without --use_fast_math: the f32 products and the bf16 rounding must
// be IEEE.

#include "common.cuh"

namespace {

constexpr int BM = 128;             // output rows per block
constexpr int BN = 128;             // output columns per block
constexpr int BKP = 32;             // packed q4 rows per K step (= K of each plane)
constexpr int GROUP = 128;          // rows per scale group
constexpr int NTHREADS = 256;
constexpr int A_PITCH = BKP + 8;    // bf16 per x-tile row: 32 data + 8 pad
constexpr int B_PITCH = BN + 8;     // words per w-tile row of 2 k-values

struct Smem {
  alignas(16) bf16 a[2][BM][A_PITCH];          // x: plane 0 = low half, 1 = high half
  alignas(16) uint32_t b[2][BKP / 2][B_PITCH];  // w: [k / 2][n], 2 k-values (bf16) a word
};

// one int4 value times its group scale, as dequantize_kernel_int4 (f32)
__device__ __forceinline__ float dequant(int v, float s) {
  return __fmul_rn(__int2float_rn(v), s);
}

// what one thread loads from device memory for one K step
struct Fetch {
  int4 x[2][2];   // 2 x 16 bytes (16 bf16) of one x row, in each plane
  uint32_t q[4];  // 4 columns of q4 in 4 consecutive packed rows
  float4 s[2];    // the 4 columns' scales for the low / high plane's group
};

__global__ void __launch_bounds__(NTHREADS, 2)
int4_fwd_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q4,
                const float* __restrict__ scale, void* __restrict__ out, int M, int N, int K,
                int out_f32) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half = K >> 1;
  const int steps = half / BKP;
  const int hi_groups = half / GROUP;  // the high plane's first scale row

  // load roles: x row xr, 16-bf16 chunk xc; q4 columns n0 + 4 qn, packed rows 4 qk
  const int xr = tid >> 1, xc = tid & 1;
  const int qn = tid & 31, qk = tid >> 5;
  const bool x_ok = m0 + xr < M;
  const bf16* xrow = x + (size_t)(x_ok ? m0 + xr : 0) * K + xc * 16;
  const int8_t* qcol = q4 + n0 + 4 * qn;
  const float* scol = scale + n0 + 4 * qn;

  auto fetch = [&](int step, Fetch& ft) {
    const int k0 = step * BKP;
    const int4 zero4 = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int4* src = reinterpret_cast<const int4*>(xrow + p * half + k0);
      ft.x[p][0] = x_ok ? src[0] : zero4;
      ft.x[p][1] = x_ok ? src[1] : zero4;
    }
    const int kp = k0 + 4 * qk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ft.q[i] = *reinterpret_cast<const uint32_t*>(qcol + (size_t)(kp + i) * N);
    // GROUP % 4 == 0 and kp % 4 == 0: the four rows share one group in each plane
    ft.s[0] = *reinterpret_cast<const float4*>(scol + (size_t)(kp / GROUP) * N);
    ft.s[1] = *reinterpret_cast<const float4*>(scol + (size_t)(hi_groups + kp / GROUP) * N);
  };

  auto stash = [&](const Fetch& ft) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      *reinterpret_cast<int4*>(&sm.a[p][xr][xc * 16]) = ft.x[p][0];
      *reinterpret_cast<int4*>(&sm.a[p][xr][xc * 16 + 8]) = ft.x[p][1];
    }
    const float sl[4] = {ft.s[0].x, ft.s[0].y, ft.s[0].z, ft.s[0].w};
    const float sh[4] = {ft.s[1].x, ft.s[1].y, ft.s[1].z, ft.s[1].w};
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {  // packed rows 4 qk + 2 pr, 4 qk + 2 pr + 1
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // column n0 + 4 qn + j: byte j of each row's word
        const uint32_t b0 = ft.q[2 * pr] >> (8 * j), b1 = ft.q[2 * pr + 1] >> (8 * j);
        // sign-extended nibbles: low (b << 28) >> 28, high (b << 24) >> 28
        lo[j] = pack_bf16(dequant(static_cast<int>(b0 << 28) >> 28, sl[j]),
                          dequant(static_cast<int>(b1 << 28) >> 28, sl[j]));
        hi[j] = pack_bf16(dequant(static_cast<int>(b0 << 24) >> 28, sh[j]),
                          dequant(static_cast<int>(b1 << 24) >> 28, sh[j]));
      }
      *reinterpret_cast<uint4*>(&sm.b[0][2 * qk + pr][4 * qn]) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(&sm.b[1][2 * qk + pr][4 * qn]) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  };

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  Fetch ft;
  fetch(0, ft);
  for (int step = 0; step < steps; ++step) {
    stash(ft);
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1, ft);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // k16 slices of the plane's 32
        uint32_t af[4][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint32_t* r0 = reinterpret_cast<const uint32_t*>(sm.a[p][wm + mt * 16 + g]);
          const uint32_t* r8 = reinterpret_cast<const uint32_t*>(sm.a[p][wm + mt * 16 + g + 8]);
          af[mt][0] = r0[kk * 8 + t];
          af[mt][1] = r8[kk * 8 + t];
          af[mt][2] = r0[kk * 8 + 4 + t];
          af[mt][3] = r8[kk * 8 + 4 + t];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bfr[nt][0] = sm.b[p][kk * 8 + t][wn + nt * 8 + g];
          bfr[nt][1] = sm.b[p][kk * 8 + 4 + t][wn + nt * 8 + g];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
    __syncthreads();
  }

  // epilogue: one cast of the f32 sum (N % 128 == 0: every column is in)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        const float y0 = acc[mt][nt][2 * h], y1 = acc[mt][nt][2 * h + 1];
        const size_t o = (size_t)row * N + col;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + o) = pack_bf16(y0, y1);
        }
      }
    }
  }
}

}  // namespace

// Launch K6a on `stream`.  x [M, K] bf16, q4 [K/2, N] int8, scale [n_groups, N]
// f32, out [M, N] bf16 (out_f32 = 0) or f32 (1), all contiguous and 16-byte
// aligned.  Takes K % 3072 == 0, N % 128 == 0 and n_groups * 128 == K (JAX's
// `supports`).  Returns a cudaError_t (0 = launched).
extern "C" int qflux_int4_fwd(const void* x, const void* q4, const void* scale, void* out, int M,
                              int N, int K, int n_groups, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 3072 || N % BN || n_groups * GROUP != K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  int4_fwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q4),
      static_cast<const float*>(scale), out, M, N, K, out_f32);
  return (int)cudaGetLastError();
}
