// What the two attention kernels (flash_nr_fwd.cu, flash_nr_bwd.cu) share: the head
// dim, the per-row norm + rope of q and k, and the prep launches that run before the
// main kernels.  Each translation unit gets its own copy (anonymous namespace).
//
// The prep (flash_nr_prep_kernel), one warp per (b, s) position and group of
// PREP_HEADS heads (the group's loads issued together, cos / sin loaded once); with
// amax, a block per PREP_POS positions of one group:
//   * norms and ropes the row of q and of k with K1's exact cast chain
//     (norm_rope4, which K1's consumers run on their q rows too) and writes them to
//     scratch qn / kn where asked;
//   * writes delta = rowsum(do * out) where asked (K2);
//   * for the int8 score GEMM (the `s_int8` mode of qflux_tpu/ops/flash_nr.py,
//     `_quant_tile` at :119), reduces the largest |kn| of each (b, h) and the largest
//     |qn| of each (b, h, q tile of q_rows rows counted from row 0) into `amax`
//     [B, H, 1 + n_tiles] (slot 0: k, slot 1 + i: q tile i) with atomicMax on the
//     bits of non-negative floats, whose order is the floats' order: first over the
//     block's positions in shared memory, then once a block and head in device
//     memory (a q tile is a multiple of PREP_POS rows, so a block's positions lie in
//     one), which keeps the same-address atomics of a slot to S / PREP_POS.  A max
//     does not depend on the order it is taken in, so the result is deterministic.
// Then flash_nr_quant_kernel, over the same warps, quantizes kn (and qn where asked):
//   scale = max(amax / 127, 1e-6),  x8 = int8(rint(x / scale))
// with IEEE division and round-half-to-even, as `_quant_tile` does in f32.

#pragma once

#include "common.cuh"

namespace {

constexpr int D = 128;  // the only head dim the kernels take
constexpr float EPS = 1e-6f;
constexpr int PREP_WARPS = 8;
constexpr int PREP_HEADS = 4;  // heads of one position a prep warp takes
constexpr int PREP_POS = 16;   // positions of a prep block, one a warp

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
// rope of one row, from the lane's four channels `raw` (channels 4 * lane .. + 3)
// and their cos / sin.  Returns the lane's four channels as bf16 and their largest
// |value| in `m`.  __fmul_rn and __fadd_rn keep nvcc from contracting the products
// into FMAs.
__device__ __forceinline__ uint2 norm_rope4_in(uint2 raw, const float* __restrict__ s,
                                               float4 c4, float4 s4, int lane, float& m) {
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
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

// norm_rope4_in of the row at x with its cos / sin rows
__device__ __forceinline__ uint2 norm_rope4(const bf16* __restrict__ x,
                                            const float* __restrict__ s,
                                            const float* __restrict__ cos,
                                            const float* __restrict__ sin, int lane, float& m) {
  const int c0 = lane * 4;
  return norm_rope4_in(*reinterpret_cast<const uint2*>(x + c0), s,
                       *reinterpret_cast<const float4*>(cos + c0),
                       *reinterpret_cast<const float4*>(sin + c0), lane, m);
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

// The f32 modes' prep (flash_simt.cu): norm_rope4_in for an f32 row, with no
// rounding between the steps (the JAX forward's casts to the refs' dtype are the
// identity in f32).  x: the lane's four channels; s: its scale row's channels;
// returns the four normed and roped channels and their largest |value| in `m`.
__device__ __forceinline__ float4 norm_rope4_f32(float4 x, const float* __restrict__ s,
                                                 float4 c4, float4 s4, int lane, float& m) {
  const float xv[4] = {x.x, x.y, x.z, x.w};
  const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) ss += xv[j] * xv[j];
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + EPS);
  float y[4];
  m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float us = __fmul_rn(__fmul_rn(xv[j], r), s[j]);
    const float partner = __shfl_xor_sync(0xffffffffu, us, 16);
    const float rot = lane < 16 ? -partner : partner;
    y[j] = __fadd_rn(__fmul_rn(us, cv[j]), __fmul_rn(rot, sv[j]));
    m = fmaxf(m, fabsf(y[j]));
  }
  return make_float4(y[0], y[1], y[2], y[3]);
}

// four f32 → four int8 (one 32-bit word, byte j from value j), as quant4w
__device__ __forceinline__ uint32_t quant4f(float4 x, float scale) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qv = static_cast<int>(rintf(__fdiv_rn(v[j], scale)));
    w |= (static_cast<uint32_t>(qv) & 0xFFu) << (8 * j);
  }
  return w;
}

// four bf16 (one 64-bit word) → four int8 (one 32-bit word, byte j from value j)
__device__ __forceinline__ uint32_t quant4w(uint2 raw, float scale) {
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qv = static_cast<int>(rintf(__fdiv_rn(__bfloat162float(p[j]), scale)));
    w |= (static_cast<uint32_t>(qv) & 0xFFu) << (8 * j);
  }
  return w;
}

// the blocks of PREP_WARPS warps that cover B * S positions in groups of NH heads,
// a warp a group (K2's bf16 prep: NH = 1; the s_int8 quantization: PREP_HEADS)
template <int NH>
inline int prep_blocks(int B, int S, int H) {
  const long long warps = (long long)B * S * ((H + NH - 1) / NH);
  return (int)((warps + PREP_WARPS - 1) / PREP_WARPS);
}

// this warp's position (b, s) and first head h0 in prep_blocks<NH>'s grid, or false
// past the last group
template <int NH>
__device__ __forceinline__ bool prep_warp(int B, int S, int H, int& b, int& s, int& h0) {
  const int groups = (H + NH - 1) / NH;
  const long long w = (long long)blockIdx.x * PREP_WARPS + threadIdx.x / 32;
  if (w >= (long long)B * S * groups) return false;
  const long long pos = w / groups;  // b * S + s
  h0 = (int)(w % groups) * NH;
  s = (int)(pos % S);
  b = (int)(pos / S);
  return true;
}

// The prep's work for heads h0 .. h0 + NH - 1 of position (b, s), by one warp: qn /
// kn / delta where asked, and the rows' largest |qn| / |kn| into the block's maxima
// `red` where not null
template <int NH>
__device__ __forceinline__ void prep_rows(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ dout,
    const bf16* __restrict__ out, const float* __restrict__ q_scale2,
    const float* __restrict__ k_scale2, const float* __restrict__ cos,
    const float* __restrict__ sin, long long cs_bstride, bf16* __restrict__ qn,
    bf16* __restrict__ kn, float* __restrict__ delta, unsigned (*red)[PREP_HEADS], int b, int s,
    int h0, int lane, int c0, int S, int H, int st) {
  const size_t off0 = (((size_t)b * S + s) * H + h0) * D + c0;  // head h0, this lane's channels
  const size_t cs = (size_t)b * cs_bstride + (size_t)s * D + c0;
  const float4 c4 = *reinterpret_cast<const float4*>(cos + cs);
  const float4 s4 = *reinterpret_cast<const float4*>(sin + cs);
  const int side = (s < st ? 0 : D) + c0;
  // every load of the group first, then the arithmetic head by head
  uint2 xq[NH], xk[NH], xd[NH], xo[NH];
#pragma unroll
  for (int u = 0; u < NH; ++u) {
    xq[u] = xk[u] = xd[u] = xo[u] = make_uint2(0u, 0u);
    if (h0 + u < H) {  // warp-uniform
      xq[u] = *reinterpret_cast<const uint2*>(q + off0 + u * D);
      xk[u] = *reinterpret_cast<const uint2*>(k + off0 + u * D);
      if (dout) {
        xd[u] = *reinterpret_cast<const uint2*>(dout + off0 + u * D);
        xo[u] = *reinterpret_cast<const uint2*>(out + off0 + u * D);
      }
    }
  }
  float mq[NH], mk[NH];
#pragma unroll
  for (int u = 0; u < NH; ++u) {
    mq[u] = mk[u] = 0.f;
    if (h0 + u >= H) break;  // warp-uniform
    float m;
    const uint2 yq = norm_rope4_in(xq[u], q_scale2 + side, c4, s4, lane, m);
    if (qn) *reinterpret_cast<uint2*>(qn + off0 + u * D) = yq;
    mq[u] = warp_max(m);
    const uint2 yk = norm_rope4_in(xk[u], k_scale2 + side, c4, s4, lane, m);
    *reinterpret_cast<uint2*>(kn + off0 + u * D) = yk;
    mk[u] = warp_max(m);
    if (dout) {
      const bf16* dp = reinterpret_cast<const bf16*>(&xd[u]);
      const bf16* op = reinterpret_cast<const bf16*>(&xo[u]);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += __bfloat162float(dp[j]) * __bfloat162float(op[j]);
      acc = warp_sum(acc);
      if (lane == 0) delta[((size_t)b * H + h0 + u) * S + s] = acc;
    }
  }
  // lane u takes head h0 + u's two maxima (every lane holds every head's) into the
  // block's
  if (red && lane < NH && h0 + lane < H) {
    float vq = mq[0], vk = mk[0];
#pragma unroll
    for (int u = 1; u < NH; ++u)
      if (lane == u) vq = mq[u], vk = mk[u];
    atomicMax(&red[0][lane], __float_as_uint(vk));
    atomicMax(&red[1][lane], __float_as_uint(vq));
  }
}

// the s_int8 prep's grid: a block per PREP_POS positions of one sample and group
// of heads
inline int prep_pos_blocks(int B, int S, int H) {
  return B * ((S + PREP_POS - 1) / PREP_POS) * ((H + PREP_HEADS - 1) / PREP_HEADS);
}

// a row's [2, D] norm scale and cos / sin rows are shared by the heads of one
// position; [B, S, H, D] rows: head h of position (b, s) at ((b * S + s) * H + h) * D.
// AMAX (the s_int8 prep): a block per PREP_POS positions of one group of
// PREP_HEADS heads (prep_pos_blocks), whose maxima it reduces; else (K2's bf16
// prep) a warp a row, blocks of PREP_WARPS warps over consecutive rows
// (prep_blocks<1>).
template <bool AMAX>
__global__ void __launch_bounds__((AMAX ? PREP_POS : PREP_WARPS) * 32)
flash_nr_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ dout, const bf16* __restrict__ out,
                     const float* __restrict__ q_scale2, const float* __restrict__ k_scale2,
                     const float* __restrict__ cos, const float* __restrict__ sin,
                     long long cs_bstride, bf16* __restrict__ qn, bf16* __restrict__ kn,
                     float* __restrict__ delta, unsigned* __restrict__ amax, int q_rows, int B,
                     int S, int H, int st) {
  const int lane = threadIdx.x % 32, c0 = lane * 4;
  if constexpr (!AMAX) {
    int b, s, h0;
    if (!prep_warp<1>(B, S, H, b, s, h0)) return;  // warp-uniform
    prep_rows<1>(q, k, dout, out, q_scale2, k_scale2, cos, sin, cs_bstride, qn, kn, delta,
              nullptr, b, s, h0, lane, c0, S, H, st);
  } else {
    __shared__ unsigned red[2][PREP_HEADS];  // the block's k and q maxima per head
    const int groups = (H + PREP_HEADS - 1) / PREP_HEADS;
    const int sblocks = (S + PREP_POS - 1) / PREP_POS;
    const int h0 = (blockIdx.x % groups) * PREP_HEADS;
    const int s0 = (blockIdx.x / groups % sblocks) * PREP_POS, b = blockIdx.x / groups / sblocks;
    const int s = s0 + threadIdx.x / 32;
    if (threadIdx.x < 2 * PREP_HEADS)
      red[threadIdx.x / PREP_HEADS][threadIdx.x % PREP_HEADS] = 0u;
    __syncthreads();
    if (s < S)  // warp-uniform
      prep_rows<PREP_HEADS>(q, k, dout, out, q_scale2, k_scale2, cos, sin, cs_bstride, qn, kn,
                            delta, red, b, s, h0, lane, c0, S, H, st);
    __syncthreads();
    if (threadIdx.x < PREP_HEADS && h0 + threadIdx.x < H) {
      unsigned* am =
          amax + ((size_t)b * H + h0 + threadIdx.x) * (1 + (S + q_rows - 1) / q_rows);
      atomicMax(am, red[0][threadIdx.x]);
      atomicMax(am + 1 + s0 / q_rows, red[1][threadIdx.x]);
    }
  }
}

__global__ void __launch_bounds__(PREP_WARPS * 32)
flash_nr_quant_kernel(const bf16* __restrict__ qn, const bf16* __restrict__ kn,
                      const unsigned* __restrict__ amax, int8_t* __restrict__ qq,
                      int8_t* __restrict__ kq, int q_rows, int B, int S, int H) {
  int b, s, h0;
  if (!prep_warp<PREP_HEADS>(B, S, H, b, s, h0)) return;
  const int lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)b * S + s) * H + h0;  // head h0's row
  uint2 xk[PREP_HEADS], xq[PREP_HEADS];
#pragma unroll
  for (int u = 0; u < PREP_HEADS; ++u) {
    xk[u] = xq[u] = make_uint2(0u, 0u);
    if (h0 + u < H) {
      xk[u] = *reinterpret_cast<const uint2*>(kn + (row0 + u) * D + lane * 4);
      if (qq) xq[u] = *reinterpret_cast<const uint2*>(qn + (row0 + u) * D + lane * 4);
    }
  }
  const int slots = 1 + (S + q_rows - 1) / q_rows;
#pragma unroll
  for (int u = 0; u < PREP_HEADS; ++u) {
    if (h0 + u >= H) break;
    const unsigned* am = amax + ((size_t)b * H + h0 + u) * slots;
    *reinterpret_cast<uint32_t*>(kq + (row0 + u) * D + lane * 4) =
        quant4w(xk[u], int8_scale(am[0]));
    if (qq)
      *reinterpret_cast<uint32_t*>(qq + (row0 + u) * D + lane * 4) =
          quant4w(xq[u], int8_scale(am[1 + s / q_rows]));
  }
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
  if (q_rows <= 0 || q_rows % PREP_POS) return cudaErrorInvalidValue;
  const size_t n_amax = (size_t)B * H * (1 + (S + q_rows - 1) / q_rows);
  cudaError_t err = cudaMemsetAsync(amax, 0, n_amax * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  flash_nr_prep_kernel<true><<<prep_pos_blocks(B, S, H), PREP_POS * 32, 0, stream>>>(
      q, k, dout, out, qs, ks, cos, sin, cs_bstride, qn, kn, delta, amax, q_rows, B, S, H, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_nr_quant_kernel<<<prep_blocks<PREP_HEADS>(B, S, H), PREP_WARPS * 32, 0, stream>>>(
      qn, kn, amax, qq, kq, q_rows, B, S, H);
  return cudaGetLastError();
}

}  // namespace
