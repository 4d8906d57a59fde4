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
// per row with the scales sg [M] f32 by csrc/rowquant.cu), q4 [K/2, N] int8
// the HALF-SPLIT packed int4 weight (byte row i: original row i in the low
// nibble, row i + K/2 in the high one) and f [K/gsz, N] f32 the requant
// factors; out() is the cast to the output's type (bf16, round to nearest
// even, or f32).  The TPU kernel writes the int32 halves acc[:, :K/2] and
// acc[:, K/2:] and leaves the scaling by sg to XLA; here the epilogue applies
// it, with the same single f32 product.  Bit-identical to the plain version
// (ops/quant.py:requant_int4_matmul_dx): the same regrid (round half to even,
// clip), exact int32 accumulation (|acc| <= 127^2 * N < 2^31 for every
// N <= 133,000), one f32 product and one cast.
//
// What bounds it: int8 tensor-core operations.  At M = 3744, N = 12288,
// K = 3072 (the dx of the MLP up-projection of a bs=1 832x576 Qwen-Image-Edit
// train step) that is 2*M*N*K = 283 GOP, 0.143 ms at 1,979 TOPS; its bytes (gq,
// the K*N/2 q4 read, f, dx in bf16) are ~89 MB, 0.027 ms at 3.35 TB/s.
//
// Design (rq_int4_common.cuh), K5a's without the transpose:
//   * rq_int4_bwd_kernel_regrid writes q8 [K, N] int8 into a scratch the
//     wrapper keeps: the contraction runs over N and q4 is N-contiguous, so
//     q8's rows are already the K-major B operand.  A thread takes 16 columns of
//     one packed row: one 16-byte load of q4, the 16 columns' factors of both
//     planes (each byte is regridded with its own column's factor: the factors
//     vary along the contraction and are never applied to the accumulator),
//     and one 16-byte store to each plane's row, kp and K/2 + kp;
//   * rq_int4_bwd_kernel, the GEMM of rq_int4_common.cuh on A = gq [M, N] and
//     B = q8 [K, N], epilogue f32(acc) * sg; for the narrow grids (M = 256 text
//     rows) the contraction is split over N on whole 128-byte stages and
//     rq_int4_bwd_kernel_reduce adds the int32 partial sums;
//   * ragged M, N and K are zero-filled by TMA and masked in the epilogue.
//     Requirements (the wrapper checks them): K % 64 == 0, N % 16 == 0,
//     gsz % 4 == 0 and K % gsz == 0 — the same as K5a.
//
// Built without --use_fast_math: the f32 products must be IEEE.

#include "common.cuh"
#include "rq_int4_common.cuh"

namespace {

// q4 [K/2, N] -> q8 [K, N]: q8[kp] = regrid(lo(q4[kp]), f[kp / gsz]), q8[K/2 + kp]
// = regrid(hi(q4[kp]), f[(K/2 + kp) / gsz]); thread i takes bytes 16 i .. 16 i + 15
__global__ void __launch_bounds__(256)
rq_int4_bwd_kernel_regrid(const int8_t* __restrict__ q4, const float* __restrict__ fac,
                          int8_t* __restrict__ q8, int N, int K, int gsz) {
  const int half = K >> 1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)half * N / 16) return;
  const int kp = (int)(16 * i / N), n = (int)(16 * i % N);  // N % 16 == 0
  const uint4 w = *reinterpret_cast<const uint4*>(q4 + (size_t)kp * N + n);
  const float* fl = fac + (size_t)(kp / gsz) * N + n;
  const float* fh = fac + (size_t)((half + kp) / gsz) * N + n;
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(fl + 4 * q);
    const float4 b = *reinterpret_cast<const float4*>(fh + 4 * q);
    const float al[4] = {a.x, a.y, a.z, a.w}, bh[4] = {b.x, b.y, b.z, b.w};
    rq::regrid_word(ws[q], al, bh, lo[q], hi[q]);
  }
  *reinterpret_cast<uint4*>(q8 + (size_t)kp * N + n) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(q8 + (size_t)(half + kp) * N + n) =
      make_uint4(hi[0], hi[1], hi[2], hi[3]);
}

__global__ void __launch_bounds__(rq::NTHREADS, 1)
rq_int4_bwd_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map, const float* __restrict__ sg,
                   const float* __restrict__ unused, void* __restrict__ dx, int* __restrict__ ws,
                   int M, int K, int N, int splits, int out_f32) {
  rq::gemm_body<false>(&a_map, &b_map, sg, unused, dx, ws, M, K, N, splits, out_f32);
}

__global__ void rq_int4_bwd_kernel_reduce(const int* __restrict__ ws, const float* __restrict__ sg,
                                          const float* __restrict__ unused,
                                          void* __restrict__ dx, int M, int K, int splits,
                                          int out_f32) {
  rq::reduce_body<false>(ws, sg, unused, dx, M, K, splits, out_f32);
}

}  // namespace

// Launch K5b on `stream`.  gq [M, N] int8, q4 [K/2, N] int8, fac [K/gsz, N] f32,
// sg [M] f32, dx [M, K] bf16 (out_f32 = 0) or f32 (1), all contiguous and
// 16-byte aligned; q8 a scratch of K * N bytes; splits (1 .. ceil(N / 128))
// splits the contraction over N on 128-wide stages, with ws a workspace of
// splits * M * K int32 (unused, may be null, at splits = 1).  Returns a
// cudaError_t (0 = launched).
extern "C" int qflux_rq_int4_bwd(const void* gq, const void* q4, const void* fac, const void* sg,
                                 void* dx, int M, int N, int K, int gsz, int out_f32, int splits,
                                 void* q8, void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 || N % 16 || gsz <= 0 || gsz % 4 || K % gsz ||
      splits < 1 || splits > (N + rq::BK - 1) / rq::BK || (splits > 1 && !ws) || !q8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  if (!rq::gemm_maps(&am, &bm, gq, q8, M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n16 = (long long)(K / 2) * N / 16;
  rq_int4_bwd_kernel_regrid<<<(unsigned)((n16 + 255) / 256), 256, 0, st>>>(
      static_cast<const int8_t*>(q4), static_cast<const float*>(fac), static_cast<int8_t*>(q8),
      N, K, gsz);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)rq::gemm_launch(rq_int4_bwd_kernel, rq_int4_bwd_kernel_reduce, am, bm,
                              static_cast<const float*>(sg), nullptr, dx, static_cast<int*>(ws),
                              M, K, N, splits, out_f32, st);
}
