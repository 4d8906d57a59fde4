// What the two attention kernels (flash_nr_fwd.cu, flash_nr_bwd.cu) share: the head
// dim, the per-row norm + rope of q and k, and the prep launches that run before the
// main kernels.  Each translation unit gets its own copy (anonymous namespace).
//
// The prep (flash_nr_prep_kernel), one warp per (b, s, h) row:
//   * norms and ropes the row of q and of k with K1's exact cast chain (the same
//     operations in the same order as flash_nr_fwd.cu's norm_rope_tile, so the values
//     are K1's bit for bit) and writes them to scratch qn / kn where asked;
//   * writes delta = rowsum(do * out) where asked (K2);
//   * for the int8 score GEMM (the `s_int8` mode of qflux_tpu/ops/flash_nr.py,
//     `_quant_tile` at :119), reduces the largest |kn| of each (b, h) and the largest
//     |qn| of each (b, h, q tile of q_rows rows counted from row 0) into `amax`
//     [B, H, 1 + n_tiles] (slot 0: k, slot 1 + i: q tile i) with atomicMax on the
//     bits of non-negative floats, whose order is the floats' order.  A max does not
//     depend on the order it is taken in, so the result is deterministic.
// Then flash_nr_quant_kernel, one warp per row, quantizes kn (and qn where asked):
//   scale = max(amax / 127, 1e-6),  x8 = int8(rint(x / scale))
// with IEEE division and round-half-to-even, as `_quant_tile` does in f32.

#pragma once

#include "common.cuh"

namespace {

constexpr int D = 128;  // the only head dim the kernels take
constexpr float EPS = 1e-6f;
constexpr int PREP_WARPS = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// RMSNorm (scale row `s`, already offset to this lane's channels) then rotate-half
// rope of one row; lane holds channels 4 * lane .. + 3.  Returns the lane's four
// channels as bf16 and their largest |value| in `m`.  __fmul_rn and __fadd_rn keep
// nvcc from contracting the products into FMAs.
__device__ __forceinline__ uint2 norm_rope4(const bf16* __restrict__ x,
                                            const float* __restrict__ s,
                                            const float* __restrict__ cos,
                                            const float* __restrict__ sin, int lane, float& m) {
  const int c0 = lane * 4;
  const uint2 raw = *reinterpret_cast<const uint2*>(x + c0);
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
  const float4 c4 = *reinterpret_cast<const float4*>(cos + c0);
  const float4 s4 = *reinterpret_cast<const float4*>(sin + c0);
  const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
  float xv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) xv[j] = __bfloat162float(p[j]);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) ss += xv[j] * xv[j];
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + EPS);
  float us[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) us[j] = bf16_round(__fmul_rn(__fmul_rn(xv[j], r), s[j]));
  __align__(8) bf16 y[4];
  m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float partner = __shfl_xor_sync(0xffffffffu, us[j], 16);
    const float rot = lane < 16 ? -partner : partner;
    y[j] = __float2bfloat16(__fadd_rn(__fmul_rn(us[j], cv[j]), __fmul_rn(rot, sv[j])));
    m = fmaxf(m, fabsf(__bfloat162float(y[j])));
  }
  return *reinterpret_cast<const uint2*>(y);
}

// norm_rope4 of one row, written to `dst` unless it is null; returns the largest
// |value| of the whole row
__device__ __forceinline__ float norm_rope_row(const bf16* __restrict__ x,
                                               const float* __restrict__ s,
                                               const float* __restrict__ cos,
                                               const float* __restrict__ sin, int lane,
                                               bf16* __restrict__ dst) {
  float m;
  const uint2 y = norm_rope4(x, s, cos, sin, lane, m);
  if (dst) *reinterpret_cast<uint2*>(dst + lane * 4) = y;
  return warp_max(m);
}

// `_quant_tile`'s scale from the bits of a tile's largest |value|
__device__ __forceinline__ float int8_scale(unsigned amax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(amax_bits), 127.f), 1e-6f);
}

// four bf16 at x → four int8 at dst (one 32-bit store)
__device__ __forceinline__ void quant4(const bf16* __restrict__ x, float scale,
                                       int8_t* __restrict__ dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(x);
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qv = static_cast<int>(rintf(__fdiv_rn(__bfloat162float(p[j]), scale)));
    w |= (static_cast<uint32_t>(qv) & 0xFFu) << (8 * j);
  }
  *reinterpret_cast<uint32_t*>(dst) = w;
}

__global__ void __launch_bounds__(PREP_WARPS * 32)
flash_nr_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ dout, const bf16* __restrict__ out,
                     const float* __restrict__ q_scale2, const float* __restrict__ k_scale2,
                     const float* __restrict__ cos, const float* __restrict__ sin,
                     long long cs_bstride, bf16* __restrict__ qn, bf16* __restrict__ kn,
                     float* __restrict__ delta, unsigned* __restrict__ amax, int q_rows,
                     int rows, int S, int H, int st) {
  const int row = blockIdx.x * PREP_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  // row = (b * S + s) * H + h: [B, S, H, D] rows are contiguous D-vectors
  const int h = row % H, s = (row / H) % S, b = row / (H * S);
  const size_t off = (size_t)row * D;
  const float* cb = cos + (size_t)b * cs_bstride + (size_t)s * D;
  const float* sb = sin + (size_t)b * cs_bstride + (size_t)s * D;
  const int side = s < st ? 0 : D;
  const float mq = norm_rope_row(q + off, q_scale2 + side + lane * 4, cb, sb, lane,
                                 qn ? qn + off : nullptr);
  const float mk = norm_rope_row(k + off, k_scale2 + side + lane * 4, cb, sb, lane, kn + off);
  if (amax && lane == 0) {
    unsigned* am = amax + ((size_t)b * H + h) * (1 + (S + q_rows - 1) / q_rows);
    atomicMax(am, __float_as_uint(mk));
    atomicMax(am + 1 + s / q_rows, __float_as_uint(mq));
  }
  if (dout) {
    const uint2 draw = *reinterpret_cast<const uint2*>(dout + off + lane * 4);
    const uint2 oraw = *reinterpret_cast<const uint2*>(out + off + lane * 4);
    const bf16* dp = reinterpret_cast<const bf16*>(&draw);
    const bf16* op = reinterpret_cast<const bf16*>(&oraw);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc += __bfloat162float(dp[j]) * __bfloat162float(op[j]);
    acc = warp_sum(acc);
    if (lane == 0) delta[((size_t)b * H + h) * S + s] = acc;
  }
}

__global__ void __launch_bounds__(PREP_WARPS * 32)
flash_nr_quant_kernel(const bf16* __restrict__ qn, const bf16* __restrict__ kn,
                      const unsigned* __restrict__ amax, int8_t* __restrict__ qq,
                      int8_t* __restrict__ kq, int q_rows, int rows, int S, int H) {
  const int row = blockIdx.x * PREP_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int h = row % H, s = (row / H) % S, b = row / (H * S);
  const size_t off = (size_t)row * D + lane * 4;
  const unsigned* am = amax + ((size_t)b * H + h) * (1 + (S + q_rows - 1) / q_rows);
  quant4(kn + off, int8_scale(am[0]), kq + off);
  if (qq) quant4(qn + off, int8_scale(am[1 + s / q_rows]), qq + off);
}

// The int8 prep of both kernels on `stream`: amax (zeroed here), kn and kq always, qn
// and qq where not null (K2), delta where dout is not null (K2).  Returns a
// cudaError_t.
inline cudaError_t launch_int8_prep(const bf16* q, const bf16* k, const bf16* dout,
                                    const bf16* out, const float* qs, const float* ks,
                                    const float* cos, const float* sin, long long cs_bstride,
                                    bf16* qn, bf16* kn, float* delta, int8_t* qq, int8_t* kq,
                                    unsigned* amax, int q_rows, int B, int S, int H, int st,
                                    cudaStream_t stream) {
  if (q_rows <= 0) return cudaErrorInvalidValue;
  const size_t n_amax = (size_t)B * H * (1 + (S + q_rows - 1) / q_rows);
  cudaError_t err = cudaMemsetAsync(amax, 0, n_amax * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  const int rows = B * S * H;
  const int blocks = (rows + PREP_WARPS - 1) / PREP_WARPS;
  flash_nr_prep_kernel<<<blocks, PREP_WARPS * 32, 0, stream>>>(
      q, k, dout, out, qs, ks, cos, sin, cs_bstride, qn, kn, delta, amax, q_rows, rows, S, H, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_nr_quant_kernel<<<blocks, PREP_WARPS * 32, 0, stream>>>(qn, kn, amax, qq, kq, q_rows,
                                                                 rows, S, H);
  return cudaGetLastError();
}

}  // namespace
