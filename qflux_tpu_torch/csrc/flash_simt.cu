// The f32 modes' prep and rope + norm backward of K1 / K2 (D = 128), on the CUDA cores:
// the passes every f32 mode of the fused kernels runs around its tensor-core loops
// (csrc/flash_f32_fwd.cu: K1 in f32, qflux_f32_nr_fwd, and its s_int8 mode,
// qflux_f32_nr_int8_fwd; csrc/flash_f32_bwd.cu: K2 in f32, qflux_f32_nr_bwd, and its
// s_int8 mode, qflux_f32_nr_int8_bwd).  No attention loop lives here.
//
// Part of the same Pallas TPU kernels as those loops, K1 (qflux_tpu/ops/flash_nr.py:192
// _fwd_nr_kernel) and K2 (:311 _bwd_nr_kernel), in the mode JAX runs them in without a
// dtype condition of its own (its kernels compute in f32 and cast to the refs' dtype):
//   * qflux_simt_nr_prep: the norm + rope of q and k (and, for the s_int8 modes, their
//     int8 quantization) that both kernels start with;
//   * qflux_simt_nr_rope_norm_bwd: the rope + norm backward that K2 ends with.
//
// The prep, one warp per (b, s, h) row (flash_nr_common.cuh's norm_rope4_f32:
// flash_nr_fwd.cu's flash_nr_kn_kernel widened to f32 in and out, applied to q as well
// as k, the scale row picked at st), writes f32 scratch qn / kn; at q_rows > 0 (the
// s_int8 modes) it also reduces the largest |qn| of each (b, h, q tile of q_rows rows)
// and |kn| of each (b, h) into amax (atomicMax on the bits of non-negative floats:
// order-free) and quantizes qn / kn as `_quant_tile` does into int8 qq / kq.  The rope
// + norm backward (flash_nr_bwd.cu's NormRopeGrads arithmetic in f32) gives dq / dk of
// the raw projections from dqn / dkn and one [2, D] scale-gradient partial per (b, h,
// 64-row tile), split at st, which the wrapper sums as K2's bf16 mode's.
//
// What bounds them on an H100: the bytes (the prep reads q, k and the cos / sin rows
// and writes qn, kn (and qq, kq); the backward reads dqn / dkn, q / k and writes dq /
// dk), a few hundred MB at FLUX's 512^2 shape; each is a plain streaming pass, one warp
// a row, 16-byte loads.
//
// Layouts: q / k / qn / kn / dq / dk [B, S, H, 128] f32 (the projection layout), qq /
// kq [B, S, H, 128] int8; scale pairs [2, D] f32, cos / sin [S, D] (batch stride 0) or
// [B, S, D] f32, their inputs 16-byte aligned (float4 rows).

#include "flash_nr_common.cuh"

namespace {
namespace simt {

// qn / kn of one (b, s, h) row a warp; the rows' largest |qn| / |kn| into amax where
// it is not null (the s_int8 modes)
__global__ void __launch_bounds__(PREP_WARPS * 32)
simt_nr_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ q_scale2, const float* __restrict__ k_scale2,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    long long cs_bstride, float* __restrict__ qn, float* __restrict__ kn,
                    unsigned* __restrict__ amax, int q_rows, int rows, int S, int H, int st) {
  const int row = blockIdx.x * PREP_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  const int h = row % H, s = (row / H) % S, b = row / (H * S);
  const size_t off = (size_t)row * D + lane * 4;
  const size_t cs = (size_t)b * cs_bstride + (size_t)s * D + lane * 4;
  const float4 c4 = *reinterpret_cast<const float4*>(cos + cs);
  const float4 s4 = *reinterpret_cast<const float4*>(sin + cs);
  const int side = (s < st ? 0 : D) + lane * 4;
  float mq, mk;
  *reinterpret_cast<float4*>(qn + off) =
      norm_rope4_f32(*reinterpret_cast<const float4*>(q + off), q_scale2 + side, c4, s4, lane, mq);
  *reinterpret_cast<float4*>(kn + off) =
      norm_rope4_f32(*reinterpret_cast<const float4*>(k + off), k_scale2 + side, c4, s4, lane, mk);
  if (amax) {
    mq = warp_max(mq);
    mk = warp_max(mk);
    if (lane == 0) {
      unsigned* am = amax + ((size_t)b * H + h) * (1 + (S + q_rows - 1) / q_rows);
      atomicMax(am, __float_as_uint(mk));
      atomicMax(am + 1 + s / q_rows, __float_as_uint(mq));
    }
  }
}

// qq / kq = `_quant_tile` of qn / kn with their tile's scale, one row a warp
__global__ void __launch_bounds__(PREP_WARPS * 32)
simt_nr_quant_kernel(const float* __restrict__ qn, const float* __restrict__ kn,
                     const unsigned* __restrict__ amax, int8_t* __restrict__ qq,
                     int8_t* __restrict__ kq, int q_rows, int rows, int S, int H) {
  const int row = blockIdx.x * PREP_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int h = row % H, s = (row / H) % S, b = row / (H * S);
  const size_t off = (size_t)row * D + lane * 4;
  const unsigned* am = amax + ((size_t)b * H + h) * (1 + (S + q_rows - 1) / q_rows);
  *reinterpret_cast<uint32_t*>(kq + off) =
      quant4f(*reinterpret_cast<const float4*>(kn + off), int8_scale(am[0]));
  *reinterpret_cast<uint32_t*>(qq + off) =
      quant4f(*reinterpret_cast<const float4*>(qn + off), int8_scale(am[1 + s / q_rows]));
}

// flash_nr_bwd.cu's rope_norm_bwd4 in f32: from the lane's four channels of the
// gradient w.r.t. the normed + roped row (g4), the raw row (x4), its norm scale (w4)
// and cos / sin, dx and the four dscale_row values (dsr)
__device__ __forceinline__ float4 rope_norm_bwd4_f32(float4 g4, float4 x4, float4 w4, float4 c4,
                                                     float4 s4, int lane, float (&dsr)[4]) {
  const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w};
  const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
  const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
  float dus[4], ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float partner = __shfl_xor_sync(0xffffffffu, gv[j] * sv[j], 16);
    dus[j] = gv[j] * cv[j] + (lane < 16 ? partner : -partner);
    ss += xv[j] * xv[j];
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + EPS);
  float u[4], du[4], dot = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = xv[j] * r;
    du[j] = dus[j] * wv[j];
    dot += du[j] * u[j];
    dsr[j] = dus[j] * u[j];
  }
  const float mean = warp_sum(dot) / (float)D;
  return make_float4(r * (du[0] - u[0] * mean), r * (du[1] - u[1] * mean),
                     r * (du[2] - u[2] * mean), r * (du[3] - u[3] * mean));
}

// Block = 64 rows of one (b, h): warp w takes rows 8 w .. 8 w + 7 in order, each
// row's dx from g (dqn or dkn) and the raw x; then the eight warps' scale-gradient
// sums, added in warp order, are the [2, D] partial of tile blockIdx.x (rows < st
// into row 0).  No atomics: deterministic.
__global__ void __launch_bounds__(256)
simt_nr_rope_norm_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                             const float* __restrict__ scale2, const float* __restrict__ cos,
                             const float* __restrict__ sin, long long cs_bstride,
                             float* __restrict__ dx, float* __restrict__ part, int S, int H,
                             int st, int n_tiles) {
  __shared__ float red[8][2 * D];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < 8; ++i) {
    const int s = tile * 64 + w * 8 + i;
    if (s >= S) break;  // warp-uniform
    const size_t off = (((size_t)b * S + s) * H + h) * D + lane * 4;
    const size_t cs = (size_t)b * cs_bstride + (size_t)s * D + lane * 4;
    float dsr[4];
    *reinterpret_cast<float4*>(dx + off) = rope_norm_bwd4_f32(
        *reinterpret_cast<const float4*>(g + off), *reinterpret_cast<const float4*>(x + off),
        *reinterpret_cast<const float4*>(scale2 + (s < st ? 0 : D) + lane * 4),
        *reinterpret_cast<const float4*>(cos + cs), *reinterpret_cast<const float4*>(sin + cs),
        lane, dsr);
    if (s < st) {
#pragma unroll
      for (int j = 0; j < 4; ++j) d0[j] += dsr[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d1[j] += dsr[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[w][lane * 4 + j] = d0[j];
    red[w][D + lane * 4 + j] = d1[j];
  }
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) sum += red[v][threadIdx.x];
  part[(((size_t)b * H + h) * n_tiles + tile) * 2 * D + threadIdx.x] = sum;
}

// the fused modes' prep (and the s_int8 quantization) on `stream`
cudaError_t launch_nr_prep(const float* q, const float* k, const float* qs, const float* ks,
                           const float* cos, const float* sin, long long cs_bstride, float* qn,
                           float* kn, int8_t* qq, int8_t* kq, unsigned* amax, int q_rows, int B,
                           int S, int H, int st, cudaStream_t stream) {
  const int rows = B * S * H, blocks = (rows + PREP_WARPS - 1) / PREP_WARPS;
  if (q_rows) {
    const cudaError_t e = cudaMemsetAsync(
        amax, 0, (size_t)B * H * (1 + (S + q_rows - 1) / q_rows) * sizeof(unsigned), stream);
    if (e != cudaSuccess) return e;
  }
  simt_nr_prep_kernel<<<blocks, PREP_WARPS * 32, 0, stream>>>(
      q, k, qs, ks, cos, sin, cs_bstride, qn, kn, q_rows ? amax : nullptr, q_rows, rows, S, H,
      st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !q_rows) return e;
  simt_nr_quant_kernel<<<blocks, PREP_WARPS * 32, 0, stream>>>(qn, kn, amax, qq, kq, q_rows,
                                                               rows, S, H);
  return cudaGetLastError();
}

}  // namespace simt
}  // namespace

// The f32 modes' prep on `stream` (flash_f32_fwd.cu's K1 and flash_f32_bwd.cu's K2 run
// it before their loops; tests and the smoke hold its qn / kn to the plain norm + rope
// and its qq / kq to `_quant_tile` of that qn / kn): qn, kn f32 [B, S, H, D]; at q_rows
// > 0 (a multiple of 64, as the loops take) also amax [B, H, 1 + ceil(S / q_rows)] and
// qq / kq int8.  Returns a cudaError_t.
extern "C" int qflux_simt_nr_prep(const void* q, const void* k, const void* q_scale2,
                                  const void* k_scale2, const void* cos, const void* sin,
                                  long long cs_bstride, void* qn, void* kn, void* qq, void* kq,
                                  void* amax, int q_rows, int B, int S, int H, int st,
                                  void* stream) {
  if (q_rows < 0 || q_rows % 64 || !qn || !kn || (q_rows && (!qq || !kq || !amax)) ||
      B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)simt::launch_nr_prep(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(q_scale2), static_cast<const float*>(k_scale2),
      static_cast<const float*>(cos), static_cast<const float*>(sin), cs_bstride,
      static_cast<float*>(qn), static_cast<float*>(kn), static_cast<int8_t*>(qq),
      static_cast<int8_t*>(kq), static_cast<unsigned*>(amax), q_rows, B, S, H, st,
      static_cast<cudaStream_t>(stream));
}

// The rope + norm backward of K2's f32 modes (D = 128) on `stream`, two passes: dq from
// dqn (the gradient w.r.t. the normed + roped q) and the raw q, dk from dkn and k, and
// the [B, H, n_tiles, 2, D] scale-gradient partials (n_tiles = ceil(S / 64), split at st)
// of each.  flash_f32_bwd.cu's qflux_f32_nr_bwd and qflux_f32_nr_int8_bwd end with it.
// Returns a cudaError_t.
extern "C" int qflux_simt_nr_rope_norm_bwd(const void* dqn, const void* dkn, const void* q,
                                           const void* k, const void* q_scale2,
                                           const void* k_scale2, const void* cos,
                                           const void* sin, long long cs_bstride, void* dq,
                                           void* dk, void* dqs_part, void* dks_part, int B, int S,
                                           int H, int st, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const float* cs = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  const int n_tiles = (S + 63) / 64;
  const dim3 grid(n_tiles, H, B);
  simt::simt_nr_rope_norm_bwd_kernel<<<grid, 256, 0, st_>>>(
      static_cast<const float*>(dqn), static_cast<const float*>(q),
      static_cast<const float*>(q_scale2), cs, sn, cs_bstride, static_cast<float*>(dq),
      static_cast<float*>(dqs_part), S, H, st, n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  simt::simt_nr_rope_norm_bwd_kernel<<<grid, 256, 0, st_>>>(
      static_cast<const float*>(dkn), static_cast<const float*>(k),
      static_cast<const float*>(k_scale2), cs, sn, cs_bstride, static_cast<float*>(dk),
      static_cast<float*>(dks_part), S, H, st, n_tiles);
  return (int)cudaGetLastError();
}
