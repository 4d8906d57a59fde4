// K5a: the fused W4A8-requant matmul forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel qflux_tpu/ops/int4_matmul.py:_rq_fwd_kernel (driven by
// _rq_fwd and ops/quant.py:rq_fused_matmul).  It computes
//
//   out[m, n] = bf16( (f32(acc[m, n]) * sx[m]) * sv[n] ),
//   acc[m, n] = sum_k xq[m, k] * q8[k, n]                          (exact int32)
//   q8[k, n]  = clip(rint(f32(nibble(k, n)) * f[k / gsz, n]), -127, 127)
//
// where xq [M, K] int8 is the row-quantized activation (its two halves
// [0, K/2) and [K/2, K) are the TPU kernel's xe / xo), q4 [K/2, N] int8 the
// HALF-SPLIT packed int4 weight (byte row i: original row i in the low nibble,
// row i + K/2 in the high one), f [K/gsz, N] f32 the requant factors, sx [M]
// and sv [N] f32 the row and channel scales.  Bit-identical to the plain
// version (ops/quant.py:requant_int4_matmul): the same round (half to even),
// clip and int32 accumulation, and the epilogue's two f32 products in the same
// order with one round-to-nearest-even cast.  Like the TPU kernel, it never
// writes q8 to device memory: each q4 tile is unpacked and regridded in
// registers and lands in shared memory as int8, in the order mma's fragments
// read it.
//
// What bounds it: int8 tensor-core operations.  At M = 3744, K = 3072,
// N = 12288 (the MLP up-projection of a bs=1 832x576 Qwen-Image-Edit forward)
// that is 2·M·K·N = 283 GOP, 0.143 ms at 1,979 TOPS; its bytes (the K·N/2 q4
// read, xq, out) are ~122 MB, 0.036 ms at 3.35 TB/s.
//
// Design (right and simple first; wgmma, TMA and a pipelined ring are later
// work):
//   * one 256-thread block per 128 x 128 output tile, 8 warps of 64 x 32;
//   * the K loop walks 32 packed rows per step: each step multiplies the x
//     columns [k0, k0 + 32) against the low nibbles and [K/2 + k0, ...)
//     against the high nibbles (two mma.sync.m16n8k32 s8 x s8 -> s32 chains);
//   * mma's B operand wants K-contiguous fragments (4 k-bytes of one column per
//     32-bit register) while q4 is [K/2, N] row-major.  The kernel regrids
//     into shared memory in the order the fragments want: each thread loads a
//     4 x 4 byte block of q4 (4 rows, 4 columns; lanes along N, so the loads
//     are coalesced), regrids both nibble planes in registers and transposes
//     the block as it packs it, writing for each column one word of 4
//     consecutive k.  The tile is stored as words [k/4][n] with a row pitch of
//     BN + 8 words, so both the stores (16 bytes per thread) and the fragment
//     loads are free of bank conflicts.  No transposed copy of the weight is
//     kept anywhere;
//   * nibbles are sign-extended on 32 bits: low (b << 28) >> 28, high
//     (b << 24) >> 28 of the byte b in bits 0..7 (the left shift unsigned,
//     the right shift arithmetic);
//   * the next step's x, q4 and factor loads are issued before the current
//     step's MMAs (register prefetch), so their latency hides behind them;
//   * ragged M and N are masked by index.  Requirements (the wrapper checks
//     them): K % 64 == 0, N % 8 == 0, gsz % 4 == 0 and K % gsz == 0 — every
//     int4-requant GEMM of the model qualifies, including K = 64 with one
//     group straddling the two nibble planes (img_in) and N = 64 (proj_out).
//
// Built without --use_fast_math: rint and the f32 products must be IEEE.

#include "common.cuh"

namespace {

constexpr int BM = 128;             // output rows per block
constexpr int BN = 128;             // output columns per block
constexpr int BKP = 32;             // packed q4 rows per K step (= K of each plane)
constexpr int NTHREADS = 256;
constexpr int A_PITCH = 48;         // bytes per x-tile row: 32 data + 16 pad
constexpr int B_PITCH = BN + 8;     // words per q8-tile row of 4 k-bytes

struct Smem {
  alignas(16) int8_t a[2][BM][A_PITCH];        // x: plane 0 = low half, 1 = high half
  alignas(16) uint32_t b[2][BKP / 4][B_PITCH];  // q8: [k / 4][n], 4 k-bytes a word
};

// one int4 value onto the per-channel int8 grid, as quant._requant_q8
__device__ __forceinline__ uint32_t regrid(int v, float f) {
  int r = __float2int_rn(__fmul_rn(__int2float_rn(v), f));
  return static_cast<uint32_t>(min(max(r, -127), 127)) & 0xFFu;
}

// what one thread loads from device memory for one K step
struct Fetch {
  int4 x[2];      // 16 bytes of one x row, in each plane
  uint32_t q[4];  // 4 columns of q4 in 4 consecutive packed rows
  float4 f[2];    // the 4 columns' factors for the low / high plane's group
};

__global__ void __launch_bounds__(NTHREADS, 2)
rq_int4_fwd_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ q4,
                   const float* __restrict__ fac, const float* __restrict__ sx,
                   const float* __restrict__ sv, void* __restrict__ out, int M, int N, int K,
                   int gsz, int out_f32) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half = K >> 1;
  const int steps = half / BKP;

  // load roles: x row xr, 16-byte chunk xc; q4 columns n0 + 4 * qn, packed rows 4 * qk
  const int xr = tid >> 1, xc = tid & 1;
  const int qn = tid & 31, qk = tid >> 5;
  const bool x_ok = m0 + xr < M;
  const bool q_ok = n0 + 4 * qn < N;  // N % 4 == 0: a quad is all in or all out
  const int8_t* xrow = xq + (size_t)(m0 + xr) * K + xc * 16;
  const int8_t* qcol = q4 + n0 + 4 * qn;
  const float* fcol = fac + n0 + 4 * qn;

  auto fetch = [&](int step, Fetch& ft) {
    const int k0 = step * BKP;
    const int4 zero4 = make_int4(0, 0, 0, 0);
    ft.x[0] = x_ok ? *reinterpret_cast<const int4*>(xrow + k0) : zero4;
    ft.x[1] = x_ok ? *reinterpret_cast<const int4*>(xrow + half + k0) : zero4;
    const int kp = k0 + 4 * qk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ft.q[i] = q_ok ? *reinterpret_cast<const uint32_t*>(qcol + (size_t)(kp + i) * N) : 0u;
    // gsz % 4 == 0 and kp % 4 == 0: the four rows share one group in each plane
    const float4 zf4 = make_float4(0.f, 0.f, 0.f, 0.f);
    ft.f[0] = q_ok ? *reinterpret_cast<const float4*>(fcol + (size_t)(kp / gsz) * N) : zf4;
    ft.f[1] = q_ok ? *reinterpret_cast<const float4*>(fcol + (size_t)((kp + half) / gsz) * N)
                   : zf4;
  };

  auto stash = [&](const Fetch& ft) {
    *reinterpret_cast<int4*>(&sm.a[0][xr][xc * 16]) = ft.x[0];
    *reinterpret_cast<int4*>(&sm.a[1][xr][xc * 16]) = ft.x[1];
    const float fl[4] = {ft.f[0].x, ft.f[0].y, ft.f[0].z, ft.f[0].w};
    const float fh[4] = {ft.f[1].x, ft.f[1].y, ft.f[1].z, ft.f[1].w};
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // column n0 + 4 qn + j: byte j of each row's word
      uint32_t wl = 0, wh = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // packed row 4 qk + i: byte i of the column's word
        const uint32_t b = ft.q[i] >> (8 * j);  // the byte in bits 0..7
        wl |= regrid(static_cast<int>(b << 28) >> 28, fl[j]) << (8 * i);
        wh |= regrid(static_cast<int>(b << 24) >> 28, fh[j]) << (8 * i);
      }
      lo[j] = wl;
      hi[j] = wh;
    }
    *reinterpret_cast<uint4*>(&sm.b[0][qk][4 * qn]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(&sm.b[1][qk][4 * qn]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  };

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Fetch ft;
  fetch(0, ft);
  for (int step = 0; step < steps; ++step) {
    stash(ft);
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1, ft);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(sm.a[p][wm + mt * 16 + g]);
        const uint32_t* r8 = reinterpret_cast<const uint32_t*>(sm.a[p][wm + mt * 16 + g + 8]);
        af[mt][0] = r0[t];
        af[mt][1] = r8[t];
        af[mt][2] = r0[4 + t];
        af[mt][3] = r8[4 + t];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bf[nt][0] = sm.b[p][t][wn + nt * 8 + g];
        bf[nt][1] = sm.b[p][4 + t][wn + nt * 8 + g];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();
  }

  // epilogue: (f32(acc) * sx[row]) * sv[col], one cast
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: col + 1 < N too
    const float sv0 = sv[col], sv1 = sv[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        const float s = sx[row];
        const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), s), sv0);
        const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), s), sv1);
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

// Launch K5a on `stream`.  xq [M, K] int8, q4 [K/2, N] int8, fac [K/gsz, N] f32,
// sx [M] f32, sv [N] f32, out [M, N] bf16 (out_f32 = 0) or f32 (1), all contiguous
// and 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int qflux_rq_int4_fwd(const void* xq, const void* q4, const void* fac, const void* sx,
                                 const void* sv, void* out, int M, int N, int K, int gsz,
                                 int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K % 64 || N % 8 || gsz <= 0 || gsz % 4 || K % gsz)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  rq_int4_fwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(q4),
      static_cast<const float*>(fac), static_cast<const float*>(sx),
      static_cast<const float*>(sv), out, M, N, K, gsz, out_f32);
  return (int)cudaGetLastError();
}
