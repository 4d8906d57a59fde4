// What K6a (int4_fwd.cu) and K6b (int4_bwd.cu) share beyond the Hopper
// machinery of hopper.cuh (mbarriers, TMA, wgmma, setmaxnreg, tensor maps): the
// nibble dequantization and the epilogue with its split-K reduction.  Each
// translation unit gets its own copy (anonymous namespace), as with common.cuh.
//
// The pipeline both kernels run (384 threads, one block per SM):
//   * warpgroup 0 is the producer: one thread keeps STAGES stages of raw tiles
//     in flight (the activation tile by TMA, the packed q4 tile by TMA, the two
//     scale rows by cp.async.bulk), each stage tracked by a `full` mbarrier
//     (transaction bytes) and freed by an `empty` one (one arrival per consumer
//     warp); its other threads exit at once;
//   * warpgroups 1 and 2 are the consumers: at step s each waits for stage s,
//     dequantizes its half of the q4 tile into the bf16 B tile s % 3 (in the
//     layout wgmma reads), fences the generic-proxy stores for the async proxy,
//     meets the other consumer at a named barrier, and issues step s's wgmmas
//     (both operands in shared memory, f32 accumulators in registers).  It then
//     waits until step s - 1's wgmmas are done (wgmma.wait_group 1) and frees
//     stage s - 1.  So the dequantization of step s + 1 runs while step s's
//     products are in the tensor cores;
//   * three B tiles are enough for one barrier per step: B tile s % 3 was last
//     read by step s - 3, which both consumers finished before they met at step
//     s - 1's barrier.

#pragma once

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// the nibble dequantization (nibble_f32: common.cuh)

// 8 bytes of q4 (w0: bytes 0..3, w1: 4..7) -> the 8 low-nibble weights and the 8
// high-nibble weights as bf16 (16 bytes each), each bf16(f32(v) * scale) with
// one IEEE product and one round to nearest even, as dequantize_kernel_int4;
// the scale of byte j is sl[j] (low) / sh[j] (high)
__device__ __forceinline__ void dequant8(uint32_t w0, uint32_t w1, const float* sl,
                                         const float* sh, uint4& lo, uint4& hi) {
  const uint32_t nl[2] = {(w0 ^ 0x88888888u) & 0x0F0F0F0Fu, (w1 ^ 0x88888888u) & 0x0F0F0F0Fu};
  const uint32_t nh[2] = {((w0 >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu,
                          ((w1 >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu};
  uint32_t l[4], h[4];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const int w = j >> 2, b = j & 3;
    l[j >> 1] = pack_bf16(__fmul_rn(nibble_f32(nl[w], b), sl[j]),
                          __fmul_rn(nibble_f32(nl[w], b + 1), sl[j + 1]));
    h[j >> 1] = pack_bf16(__fmul_rn(nibble_f32(nh[w], b), sh[j]),
                          __fmul_rn(nibble_f32(nh[w], b + 1), sh[j + 1]));
  }
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
}

// ---------------------------------------------------------------------------
// the epilogue

// The consumers' accumulators to the output: acc[mt] holds rows
// m_base + 64 mt + 16 warp + g (+ 8) and the accumulator columns 8 j + 2 t
// (+ 1), which are output columns col0(j) + 2 t (+ 1) of a row of ld; rows past
// M are not written.  Unsplit (splits == 1) each value is cast once to bf16 or
// f32; split, the block writes its f32 partial sums to plane z of ws [splits,
// M, ld], for splitk_reduce_body.
template <int MT, typename Col0>
__device__ __forceinline__ void store_tile(float (&acc)[MT][64], int m_base, int M, int ld,
                                           Col0 col0, int splits, int z, float* ws, void* out,
                                           int out_f32) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_base + 64 * mt + 16 * warp + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float y0 = acc[mt][4 * j + 2 * h], y1 = acc[mt][4 * j + 2 * h + 1];
        const size_t idx = (size_t)row * ld + col0(j) + 2 * t;
        if (splits > 1) {
          *reinterpret_cast<float2*>(ws + (size_t)z * M * ld + idx) = make_float2(y0, y1);
        } else if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(y0, y1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + idx) = pack_bf16(y0, y1);
        }
      }
    }
}

// The split-K reduction: out[i] = cast(sum over s of ws[s][i]), s in order, so a
// call is deterministic with no atomics.  A second pass over the whole card:
// adding the splits in the tile's last block instead left that work to one
// block a tile and was slower.  Each kernel file wraps the body in a kernel of
// its own name (int4_fwd_kernel_reduce, int4_bwd_kernel_reduce), so a profile
// counts the pass with its kernel.
__device__ __forceinline__ void splitk_reduce_body(const float* __restrict__ ws,
                                                   void* __restrict__ out, long long n4,
                                                   int splits, int out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* w = reinterpret_cast<const float4*>(ws);
  float4 acc = w[i];
  for (int s = 1; s < splits; ++s) {
    const float4 v = w[(long long)s * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  if (out_f32) {
    reinterpret_cast<float4*>(out)[i] = acc;
  } else {
    reinterpret_cast<uint2*>(out)[i] = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// ws [splits, n_elems] f32 -> out [n_elems] through `kernel`; n_elems % 4 == 0
template <typename Kernel>
cudaError_t splitk_reduce(Kernel kernel, const float* ws, void* out, long long n_elems,
                          int splits, int out_f32, cudaStream_t stream) {
  const long long n4 = n_elems / 4;
  const int threads = 256;
  kernel<<<(unsigned)((n4 + threads - 1) / threads), threads, 0, stream>>>(ws, out, n4, splits,
                                                                          out_f32);
  return cudaGetLastError();
}

}  // namespace
