// The W8A8-dynamic matmul's GEMMs and the weight transpose its dx needs, for
// Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package leaves `dyn_int8_matmul` to XLA
// (qflux_tpu/ops/quant.py:157-200, the `int8_dynamic` base), and the port's
// plain versions are ops/quant.py:dyn_int8_fwd / dyn_int8_dx, which these
// kernels equal to the bit.  With the weight q [N, K] int8 (the port's Dense
// layout) and its channel scales sw [N] f32:
//
//   forward  y[m, n]  = out( (f32(acc[m, n]) * sx[m]) * sw[n] ),
//            acc[m, n] = sum_k xq[m, k] * q[n, k]                  (exact int32)
//   dx       dx[m, k] = out( f32(dacc[m, k]) * sg[m] ),
//            dacc[m, k] = sum_n gq[m, n] * qt[k, n]                (exact int32)
//
// where xq / sx is the row-quantized activation and gq / sg the row-quantized
// g * sw (csrc/rowquant.cu, launched by the wrapper), qt = q transposed, and
// out() the cast to the output's type (bf16, round to nearest even, or f32).
//
// Both are the int8 GEMM of rq_int4_common.cuh (K5a's and K5b's: a producer
// thread keeping a 4-stage TMA ring of [256, 128] A and [128, 128] B tiles,
// two consumer warpgroups issuing wgmma.m64n128k32 s8 x s8 -> s32, the
// epilogue of the plain version, split contractions for the narrow grids)
// with no regrid pass in front: the weight is already int8.  int8 wgmma
// reads both operands K-major, so:
//   * the forward's B is q itself ([N, K], K contiguous): int8_gemm_kernel
//     is gemm_body<true> on A = xq [M, K], B = q;
//   * the dx contracts over N, along which q is strided: int8_transpose_kernel
//     writes qt [K, N] into a scratch the wrapper keeps (ops/int8_matmul.py),
//     then int8_gemm_dx_kernel is gemm_body<false> on A = gq [M, N], B = qt.
//     The transpose moves 2 K N bytes (~75 MB at K = 3072, N = 12288: 22 us at
//     3.35 TB/s) each backward call; the weight is frozen, but a kept qt would
//     double the base's memory.
//
// What bounds the GEMMs: int8 tensor-core operations.  At M = 2048, K = 3072,
// N = 12288 (FLUX.1-Kontext's MLP up-projection over a 512^2 target's image
// tokens) that is 2 M K N = 155 GOP, 0.078 ms at 1,979 TOPS; their bytes (xq,
// q, out in bf16) ~94 MB, 0.028 ms at 3.35 TB/s.  The transpose is bound by
// bytes.
//
// Requirements (the wrapper checks them): the GEMM's contraction a multiple of
// 16 and its output columns of 16 (TMA's 16-byte row pitch, the epilogue's
// pairs); the transpose's N and K multiples of 16.  Ragged M and the tiles'
// edges are zero-filled by TMA and masked.
//
// Built without --use_fast_math: the f32 products must be IEEE.

#include "common.cuh"
#include "rq_int4_common.cuh"

namespace {

constexpr int TT = 64;  // the transpose's tile: 64 x 64 bytes

// q [N, K] -> qt [K, N].  A block moves one 64 x 64 tile: each thread loads 16
// bytes of one row of q (coalesced along K) into shared memory, then gathers 16
// bytes of one row of qt (along N) and stores them at once.
__global__ void __launch_bounds__(256)
int8_transpose_kernel(const int8_t* __restrict__ q, int8_t* __restrict__ qt, int N, int K) {
  __shared__ __align__(16) uint8_t tile[TT][TT + 4];  // [n][k], +4: banks
  const int n0 = blockIdx.y * TT, k0 = blockIdx.x * TT;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  {
    const int n = n0 + r, k = k0 + 16 * c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < N && k < K)  // K % 16 == 0: a 16-byte piece is all in or all out
      v = *reinterpret_cast<const uint4*>(q + (size_t)n * K + k);
    uint32_t* dst = reinterpret_cast<uint32_t*>(&tile[r][16 * c]);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  }
  __syncthreads();
  const int k = k0 + r, n = n0 + 16 * c;
  if (k >= K || n >= N) return;  // N % 16 == 0
  uint32_t o[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) word |= (uint32_t)tile[16 * c + 4 * w + j][r] << (8 * j);
    o[w] = word;
  }
  *reinterpret_cast<uint4*>(qt + (size_t)k * N + n) = make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(rq::NTHREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, const float* __restrict__ sx,
                 const float* __restrict__ sw, void* __restrict__ out, int* __restrict__ ws,
                 int M, int N, int K, int splits, int out_f32) {
  rq::gemm_body<true>(&a_map, &b_map, sx, sw, out, ws, M, N, K, splits, out_f32);
}

__global__ void int8_gemm_kernel_reduce(const int* __restrict__ ws, const float* __restrict__ sx,
                                        const float* __restrict__ sw, void* __restrict__ out,
                                        int M, int N, int splits, int out_f32) {
  rq::reduce_body<true>(ws, sx, sw, out, M, N, splits, out_f32);
}

__global__ void __launch_bounds__(rq::NTHREADS, 1)
int8_gemm_dx_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, const float* __restrict__ sg,
                    const float* __restrict__ unused, void* __restrict__ dx,
                    int* __restrict__ ws, int M, int K, int N, int splits, int out_f32) {
  rq::gemm_body<false>(&a_map, &b_map, sg, unused, dx, ws, M, K, N, splits, out_f32);
}

__global__ void int8_gemm_dx_kernel_reduce(const int* __restrict__ ws,
                                           const float* __restrict__ sg,
                                           const float* __restrict__ unused,
                                           void* __restrict__ dx, int M, int K, int splits,
                                           int out_f32) {
  rq::reduce_body<false>(ws, sg, unused, dx, M, K, splits, out_f32);
}

}  // namespace

// Launch one W8A8 GEMM on `stream`: out [M, Nout] = epilogue(a [M, Kc] . b [Nout,
// Kc]^T), a and b int8, row-major.  With scol (the forward: a = xq, b = q, scol
// = sw [Nout]) the epilogue is (f32(acc) * srow[m]) * scol[n]; with scol null
// (the dx: a = gq, b = qt) it is f32(acc) * srow[m].  out is bf16 (out_f32 = 0)
// or f32 (1); every pointer contiguous and 16-byte aligned; splits (1 ..
// ceil(Kc / 128)) splits the contraction on 128-wide stages, with ws a
// workspace of splits * M * Nout int32 (unused, may be null, at splits = 1).
// Returns a cudaError_t (0 = launched).
extern "C" int qflux_int8_gemm(const void* a, const void* b, const void* srow, const void* scol,
                               void* out, int M, int Nout, int Kc, int out_f32, int splits,
                               void* ws, void* stream) {
  if (M <= 0 || Nout <= 0 || Kc <= 0 || Kc % 16 || Nout % 16 || splits < 1 ||
      splits > (Kc + rq::BK - 1) / rq::BK || (splits > 1 && !ws) || !a || !b || !srow || !out)
    return (int)cudaErrorInvalidValue;
  // both GEMM kernels share one launcher type, so gemm_launch's own one-time
  // attribute would reach only the first of them: set both here
  static bool attrs = false;
  if (!attrs) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, rq::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(int8_gemm_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               rq::SMEM);
    if (e != cudaSuccess) return (int)e;
    attrs = true;
  }
  CUtensorMap am, bm;
  if (!rq::gemm_maps(&am, &bm, a, b, M, Nout, Kc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sr = static_cast<const float*>(srow);
  if (scol)
    return (int)rq::gemm_launch(int8_gemm_kernel, int8_gemm_kernel_reduce, am, bm, sr,
                                static_cast<const float*>(scol), out, static_cast<int*>(ws), M,
                                Nout, Kc, splits, out_f32, st);
  return (int)rq::gemm_launch(int8_gemm_dx_kernel, int8_gemm_dx_kernel_reduce, am, bm, sr,
                              nullptr, out, static_cast<int*>(ws), M, Nout, Kc, splits, out_f32,
                              st);
}

// Launch the transpose on `stream`: q [N, K] int8 -> qt [K, N], both contiguous
// and 16-byte aligned, N % 16 == 0 and K % 16 == 0.  Returns a cudaError_t.
extern "C" int qflux_int8_transpose(const void* q, void* qt, int N, int K, void* stream) {
  if (N <= 0 || K <= 0 || N % 16 || K % 16 || !q || !qt) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + TT - 1) / TT, (N + TT - 1) / TT);
  int8_transpose_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<int8_t*>(qt), N, K);
  return (int)cudaGetLastError();
}
