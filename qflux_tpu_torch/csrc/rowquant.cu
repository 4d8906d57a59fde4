// The one-pass row quantization in front of K5a and K5b, for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package leaves this step to XLA on purpose
// (qflux_tpu/ops/quant.py:_rowquant), and the port's plain version is
// ops/quant.py:_rowquant, which this kernel equals to the bit.  For each row
// of x [M, K] (bf16 or f32) it computes
//
//   v[k]  = f32(x[k])                 (K5a's activation), or
//   v[k]  = f32(x[k]) * sv[k]         (K5b's g * s_vec, one IEEE product)
//   s     = max(amax_k |v[k]| * fl32(1/127), 1e-12)
//   xq[k] = int8(rint(v[k] / s))      (IEEE division, round half to even)
//
// and writes xq [M, K] int8 and s [M] f32.  The row scale is the product with
// the f32 reciprocal, as JAX computes it under `jit` and as the plain version
// writes it; the quotient a true division (__fdiv_rn).  A max is exact in any
// order, so the block's reduction order does not matter.
//
// What bounds it: bytes.  At [3744, 3072] bf16 it reads 23.0 MB and writes
// 11.5 MB + 15 KB: 0.0103 ms at 3.35 TB/s.  The plain version runs five or
// six passes over f32 copies of the row (~450 MB at that shape).
//
// Design: one 256-thread block a row, two sweeps over it: the first loads
// pieces of 8 values (16 bytes of bf16, 32 of f32) and takes their amax,
// which goes through warp shuffles and one shared-memory step; the second
// loads (and scales) the same values again, bit for bit, mostly from L2 (a
// row is 6-36 KB), and writes them as 8-byte int8 stores.  Any K % 8 == 0
// (the wrapper checks it): the AdaLN mods' dx takes g over N = 18,432.
//
// Built without --use_fast_math: the product, the division and the rounding
// must be IEEE.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a shift: exact
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// v = x[k .. k + 8) (times sv[k .. k + 8) when SV), as f32
template <typename T, bool SV>
__device__ __forceinline__ void load_values(const T* xr, const float* sv, int k, float (&v)[8]) {
  load8(xr + k, v);
  if (SV) {
    float f[8];
    load8(sv + k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], f[i]);
  }
}

// The block's amax (every thread gets it) → the row scale
__device__ __forceinline__ float row_scale(float amax, float* part) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
  if ((tid & 31) == 0) part[tid >> 5] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, part[w]);
  return fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
}

// 8 values quantized with scale sc, stored as one 8-byte int8 write
__device__ __forceinline__ void store8(const float (&v)[8], float sc, int8_t* dst) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i >> 2] |= (static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v[i], sc))) & 0xFFu)
                 << (8 * (i & 3));
  *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

// The amax in a first sweep, the quantization in a second that loads (and
// scales) the same values again.
template <typename T, bool SV>
__global__ void __launch_bounds__(THREADS)
rowquant_kernel(const T* __restrict__ x, const float* __restrict__ sv, int8_t* __restrict__ xq,
                float* __restrict__ s, int K) {
  __shared__ float part[THREADS / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = 8 * tid; k < K; k += 8 * THREADS) {
    float v[8];
    load_values<T, SV>(xr, sv, k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  const float sc = row_scale(amax, part);
  for (int k = 8 * tid; k < K; k += 8 * THREADS) {
    float v[8];
    load_values<T, SV>(xr, sv, k, v);
    store8(v, sc, xq + (size_t)row * K + k);
  }
  if (tid == 0) s[row] = sc;
}

template <typename T>
cudaError_t launch(const void* x, const float* sv, int8_t* xq, float* s, int M, int K,
                   cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (sv)
    rowquant_kernel<T, true><<<M, THREADS, 0, st>>>(xt, sv, xq, s, K);
  else
    rowquant_kernel<T, false><<<M, THREADS, 0, st>>>(xt, sv, xq, s, K);
  return cudaGetLastError();
}

}  // namespace

// Row-quantize x [M, K] (bf16, in_f32 = 0, or f32, 1), each value first times
// sv[k] when sv (an f32 [K]) is not null, into xq [M, K] int8 and s [M] f32 on
// `stream`; all contiguous and 16-byte aligned, K % 8 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int qflux_rowquant(const void* x, const void* sv, void* xq, void* s, int M, int K,
                              int in_f32, void* stream) {
  if (M <= 0 || K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(sv);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(s);
  return (int)(in_f32 ? launch<float>(x, f, q, sc, M, K, st)
                      : launch<bf16>(x, f, q, sc, M, K, st));
}
