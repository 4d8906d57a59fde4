// K5a: the fused W4A8-requant matmul forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel qflux_tpu/ops/int4_matmul.py:_rq_fwd_kernel (driven by
// _rq_fwd and ops/quant.py:rq_fused_matmul).  It computes
//
//   out[m, n] = out( (f32(acc[m, n]) * sx[m]) * sv[n] ),
//   acc[m, n] = sum_k xq[m, k] * q8[k, n]                          (exact int32)
//   q8[k, n]  = clip(rint(f32(nibble(k, n)) * f[k / gsz, n]), -127, 127)
//
// where xq [M, K] int8 is the row-quantized activation (csrc/rowquant.cu; its
// two halves [0, K/2) and [K/2, K) are the TPU kernel's xe / xo), q4 [K/2, N]
// int8 the HALF-SPLIT packed int4 weight (byte row i: original row i in the low
// nibble, row i + K/2 in the high one), f [K/gsz, N] f32 the requant factors,
// sx [M] and sv [N] f32 the row and channel scales, and out() the cast to the
// output's type (bf16, round to nearest even, or f32).  Bit-identical to the
// plain version (ops/quant.py:requant_int4_matmul): the same regrid (round half
// to even, clip), exact int32 accumulation, and the epilogue's two f32
// products in the same order with one cast.
//
// What bounds it: int8 tensor-core operations.  At M = 3744, K = 3072,
// N = 12288 (the MLP up-projection of a bs=1 832x576 Qwen-Image-Edit forward)
// that is 2·M·K·N = 283 GOP, 0.143 ms at 1,979 TOPS; its bytes (the K·N/2 q4
// read, xq, out) are ~122 MB, 0.036 ms at 3.35 TB/s.
//
// Design (rq_int4_common.cuh): two launches, and a third where the
// contraction is split.
//   * rq_int4_fwd_kernel_regrid writes q8 TRANSPOSED, q8t [N, K] int8, into a
//     scratch the wrapper keeps (ops/int4_matmul.py): the GEMM's B operand must
//     be K-major, and q4 is N-contiguous.  A block takes 64 packed rows x 128
//     columns: each thread loads a 4 x 4 byte block of q4 (4 packed rows of one
//     word of 4 columns; lanes along N, so the loads are coalesced) and the 4
//     columns' factors of both planes, regrids its 32 weights (rq::regrid_word:
//     no conversion unit), transposes the block with byte permutes and stores
//     each column's 4 bytes of k as one word of a [plane][n][k] tile in shared
//     memory; the block then writes the tile's rows, 64 contiguous bytes of k a
//     plane and column, in 16-byte stores.  The pass moves the K·N/2 q4 bytes
//     in and K·N out: ~57 MB at the main shape, ~17 µs at 3.35 TB/s;
//     the earlier kernel regridded the weight strip once per 128-row output tile,
//     30 times at M = 3744, through the conversion unit;
//   * rq_int4_fwd_kernel, the GEMM of rq_int4_common.cuh on A = xq [M, K] and
//     B = q8t [N, K], epilogue (f32(acc) * sx) * sv; for the narrow grids
//     (M = 256 text rows, proj_out's N = 64) the contraction is split over K on
//     whole 128-byte stages, and rq_int4_fwd_kernel_reduce adds the int32
//     partial sums and applies the epilogue;
//   * ragged M, N and K are zero-filled by TMA and masked in the epilogue.
//     Requirements (the wrapper checks them): K % 64 == 0, N % 16 == 0 (TMA's
//     16-byte row pitch), gsz % 4 == 0 and K % gsz == 0 — every int4-requant
//     GEMM of the model, including K = 64 with one group straddling the two
//     nibble planes (img_in) and N = 64 (proj_out).
//
// Built without --use_fast_math: the f32 products must be IEEE.

#include "common.cuh"
#include "rq_int4_common.cuh"

namespace {

constexpr int RG_KP = 64;   // packed rows per regrid block
constexpr int RG_N = 128;   // columns per regrid block
constexpr int RG_PITCH = RG_KP / 4 + 1;  // words per [n] row of the staged tile (+1: banks)

// q4 [K/2, N] -> q8t [N, K]: q8t[n, kp] = regrid(lo(q4[kp, n]), f[kp / gsz, n]),
// q8t[n, K/2 + kp] = regrid(hi(q4[kp, n]), f[(K/2 + kp) / gsz, n])
__global__ void __launch_bounds__(256)
rq_int4_fwd_kernel_regrid(const int8_t* __restrict__ q4, const float* __restrict__ fac,
                          int8_t* __restrict__ q8t, int N, int K, int gsz) {
  __shared__ uint32_t tile[2][RG_N][RG_PITCH];  // [plane][n][kp / 4]
  const int half = K >> 1;
  const int kp0 = blockIdx.y * RG_KP, n0 = blockIdx.x * RG_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // word column wc (columns 4 wc .. 4 wc + 3) and row quads rq, rq + 8: a warp
  // covers 8 word columns x 4 row quads, so its tile stores hit 32 banks
  const int wc = (lane >> 2) + 8 * (warp & 3);
  const int n = n0 + 4 * wc;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rq4 = (lane & 3) + 4 * (warp >> 2) + 8 * i;  // row quad 0..15
    const int kp = kp0 + 4 * rq4;
    uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
    if (n < N && kp < half) {  // N % 4 == 0, half % 4 == 0: all in or all out
      // gsz % 4 == 0 and kp % 4 == 0: the four rows share one group in each plane
      const float4 a = *reinterpret_cast<const float4*>(fac + (size_t)(kp / gsz) * N + n);
      const float4 b =
          *reinterpret_cast<const float4*>(fac + (size_t)((half + kp) / gsz) * N + n);
      const float fl[4] = {a.x, a.y, a.z, a.w}, fh[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)  // packed row kp + r: byte j is column n + j
        rq::regrid_word(*reinterpret_cast<const uint32_t*>(q4 + (size_t)(kp + r) * N + n), fl,
                        fh, lo[r], hi[r]);
    }
    // transpose the 4 x 4 bytes: word j = column n + j, byte r = packed row kp + r
    const uint32_t l01 = __byte_perm(lo[0], lo[1], 0x5140), l23 = __byte_perm(lo[2], lo[3], 0x5140);
    const uint32_t l01h = __byte_perm(lo[0], lo[1], 0x7362), l23h = __byte_perm(lo[2], lo[3], 0x7362);
    const uint32_t h01 = __byte_perm(hi[0], hi[1], 0x5140), h23 = __byte_perm(hi[2], hi[3], 0x5140);
    const uint32_t h01h = __byte_perm(hi[0], hi[1], 0x7362), h23h = __byte_perm(hi[2], hi[3], 0x7362);
    tile[0][4 * wc + 0][rq4] = __byte_perm(l01, l23, 0x5410);
    tile[0][4 * wc + 1][rq4] = __byte_perm(l01, l23, 0x7632);
    tile[0][4 * wc + 2][rq4] = __byte_perm(l01h, l23h, 0x5410);
    tile[0][4 * wc + 3][rq4] = __byte_perm(l01h, l23h, 0x7632);
    tile[1][4 * wc + 0][rq4] = __byte_perm(h01, h23, 0x5410);
    tile[1][4 * wc + 1][rq4] = __byte_perm(h01, h23, 0x7632);
    tile[1][4 * wc + 2][rq4] = __byte_perm(h01h, h23h, 0x5410);
    tile[1][4 * wc + 3][rq4] = __byte_perm(h01h, h23h, 0x7632);
  }
  __syncthreads();
  // each (plane, column) row of the tile: 64 bytes of k, 4 x 16-byte stores
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + 256 * i;  // 0..1023
    const int p = idx >> 9, nl = (idx >> 2) & (RG_N - 1), ch = idx & 3;
    const int nn = n0 + nl, kp = kp0 + 16 * ch;
    if (nn < N && kp < half) {  // half % 16 == 0: a 16-byte piece is all in or all out
      const uint32_t* w = &tile[p][nl][4 * ch];
      *reinterpret_cast<uint4*>(q8t + (size_t)nn * K + p * half + kp) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__global__ void __launch_bounds__(rq::NTHREADS, 1)
rq_int4_fwd_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map, const float* __restrict__ sx,
                   const float* __restrict__ sv, void* __restrict__ out, int* __restrict__ ws,
                   int M, int N, int K, int splits, int out_f32) {
  rq::gemm_body<true>(&a_map, &b_map, sx, sv, out, ws, M, N, K, splits, out_f32);
}

__global__ void rq_int4_fwd_kernel_reduce(const int* __restrict__ ws, const float* __restrict__ sx,
                                          const float* __restrict__ sv, void* __restrict__ out,
                                          int M, int N, int splits, int out_f32) {
  rq::reduce_body<true>(ws, sx, sv, out, M, N, splits, out_f32);
}

}  // namespace

// Launch K5a on `stream`.  xq [M, K] int8, q4 [K/2, N] int8, fac [K/gsz, N] f32,
// sx [M] f32, sv [N] f32, out [M, N] bf16 (out_f32 = 0) or f32 (1), all contiguous
// and 16-byte aligned; q8 a scratch of N * K bytes; splits (1 .. ceil(K / 128))
// splits the contraction over K on 128-wide stages, with ws a workspace of
// splits * M * N int32 (unused, may be null, at splits = 1).  Returns a
// cudaError_t (0 = launched).
extern "C" int qflux_rq_int4_fwd(const void* xq, const void* q4, const void* fac, const void* sx,
                                 const void* sv, void* out, int M, int N, int K, int gsz,
                                 int out_f32, int splits, void* q8, void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 || N % 16 || gsz <= 0 || gsz % 4 || K % gsz ||
      splits < 1 || splits > (K + rq::BK - 1) / rq::BK || (splits > 1 && !ws) || !q8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  if (!rq::gemm_maps(&am, &bm, xq, q8, M, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 rg((N + RG_N - 1) / RG_N, (K / 2 + RG_KP - 1) / RG_KP);
  rq_int4_fwd_kernel_regrid<<<rg, 256, 0, st>>>(static_cast<const int8_t*>(q4),
                                                static_cast<const float*>(fac),
                                                static_cast<int8_t*>(q8), N, K, gsz);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)rq::gemm_launch(rq_int4_fwd_kernel, rq_int4_fwd_kernel_reduce, am, bm,
                              static_cast<const float*>(sx), static_cast<const float*>(sv), out,
                              static_cast<int*>(ws), M, N, K, splits, out_f32, st);
}
