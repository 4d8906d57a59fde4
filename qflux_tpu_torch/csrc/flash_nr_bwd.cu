// Backward of the fused qk-RMSNorm + rotate-half RoPE + flash attention, for Hopper.
//
// Replaces qflux_tpu/ops/flash_nr.py:_bwd_nr_kernel (the Pallas TPU kernel K2, driven
// by _bwd_nr and the custom_vjp of flash_attention_nr).  From the RAW q/k/v, the
// forward's out and lse and the output cotangent do, it computes for every (b, h):
//
//   qn, kn = the forward's normed + roped q and k, with K1's exact cast chain, so that
//            p below is the p whose row sums produced lse
//   delta  = rowsum(do * out)
//   p      = exp(qn kn^T * scale - lse), 0 wherever the segment mask forbids
//   dv     = bf16(p)^T do
//   ds     = bf16(p * (do v^T - delta) * scale)
//   dqn    = ds kn,  dkn = ds^T qn                    (f32)
//   dq_raw, dk_raw and the gradients of the [2, D] norm-scale pairs: the rope
//            transpose and the RMSNorm backward of dqn and dkn, in f32, the scale
//            gradients split at the txt/img row boundary st
//
// The TPU kernel held the whole normed K of a head in VMEM and walked the q tiles in
// order, finishing the k side at the last one.  GPU blocks run in parallel and in no
// order, and the RMSNorm backward needs each row's COMPLETE dqn or dkn (its row
// reduction mean(du * u)), so an FA2-style atomic dq cannot feed it.  So three kernels,
// launched in order on one stream:
//
//   1. prep: one warp per (b, s, h) row norms and ropes q and k into scratch qn / kn
//      (bf16, the values K1 kept in registers) and writes delta;
//   2. dkv:  one block per 128-key tile of a head, 64 keys per consumer warpgroup; the
//      qn / do tiles stream past, dv and dkn accumulate in registers, and the
//      epilogue writes dv and finishes the k side (rope and norm backward, the
//      warpgroup's scale-gradient partial);
//   3. dq:   one block per 128-row q tile, 64 rows per consumer warpgroup; the kn / v
//      tiles stream past, dqn accumulates in registers, and the epilogue finishes
//      the q side.
//
// Each consumer warpgroup writes its own [2, D] scale-gradient partial (64 rows) and
// the wrapper sums them: no atomics, so the result is deterministic.  Fully masked
// rows (segment 0, lse = -1e30) never evaluate exp: the mask selects p = 0 before any
// product, and with it ds, dv and dq of those rows are 0 whatever do holds.
//
// What bounds it on an H100: at the FLUX 512^2 shape (S = 2560, H = 24, D = 128) a
// call is seven S x S x D GEMMs per head (scores and dp in both kernels, dv, dk, dq),
// 7 * 2 * S^2 * D * H = 282 GFLOP, against ~110 MB of device traffic: compute-bound on
// the tensor cores.  What the design does about that: dkv and dq run K4's Hopper main
// loops (flash_bwd_hopper.cuh: a producer warp keeping a 4-stage TMA ring, two
// consumer warpgroups on wgmma, the softmax in log2 units, setmaxnreg budgets) over
// qn / kn in place of q / k, and differ from K4 only in their epilogue
// (NormRopeGrads below), which stages each warp's f32 rows in shared memory the
// loop no longer reads and runs the row-wise rope + norm backward there.  The norm
// + rope prologue runs once per row in `prep` instead of once per tile visit, at the
// price of writing qn / kn (2 x 15.7 MB at bs=1) once.
//
// The s_int8 mode (qflux_tpu/ops/flash_nr.py:332-335, 347-354) recomputes the scores
// from int8 q and k, as the TPU kernel does: the prep (flash_nr_common.cuh) also
// quantizes qn in tiles of q_rows rows (the TPU BACKWARD's tile, which at S = 2304 and
// 2560 is 128 rows against the forward's 256, so p is not exactly the p behind lse; JAX
// does the same) and kn per (b, h), and its dkv / dq kernels
// (flash_nr_dkv_int8_kernel / flash_nr_dq_int8_kernel) are the same loops with their
// int8 score path (flash_bwd_hopper.cuh, Int8Scores below): the block's own kq (dkv)
// or qq (dq) tile and a streamed qq or kq tile beside the bf16 ones, s^T = kq qq^T or
// s = qq kq^T as wgmma m64n64k32 s8 products, and the same epilogue; ds kn and
// ds^T qn stay bf16 on the normed copies (the gradient is straight through the
// quantization).  A dq block's 128 rows and a dkv step's 64 lie inside one q tile
// (q_rows is a multiple of 128), so each has one factor.
//
// Layouts: q/k/v/out/do/dq/dk/dv/qn/kn are [B, S, H, D] bf16 (row stride H * D), lse
// and delta [B, H, S] f32, scale pairs [2, D] f32, cos/sin [S, D] (batch stride 0) or
// [B, S, D] f32, segment ids [B, S] int32 or null, the scale-gradient partials
// [B, H, n_tiles, 2, D] f32 with n_tiles = qflux_flash_nr_bwd_tiles(S).

#include "flash_bwd_hopper.cuh"
#include "flash_nr_common.cuh"

namespace {

// rows of one scale-gradient partial (qflux_flash_nr_bwd_tiles): a consumer
// warpgroup's 64 rows
constexpr int PART_ROWS = 64;

// Rope transpose and RMSNorm backward of one row, all in f32 (the cast rounding of
// the forward is not part of the gradient chain, as in _rope_bwd / _norm_bwd):
//   d_us = g * cos + [ (g*sin)[D/2:], -(g*sin)[:D/2] ]
//   u = x * r,  du = d_us * s,  dx = r * (du - u * mean(du * u)),  dscale_row = d_us * u
// g: the row's f32 gradient w.r.t. the normed + roped output; x: the raw row; s: its
// norm scale.  Each argument is this lane's four channels (4 lane .. 4 lane + 3).
// Writes dx (bf16) to the row `dst` and returns this lane's four dscale_row values in
// `dsr`.
__device__ __forceinline__ void rope_norm_bwd4(const float4 g4, const uint2 raw, const float4 w4,
                                               const float4 c4, const float4 s4, int lane,
                                               bf16* __restrict__ dst, float (&dsr)[4]) {
  const int c0 = lane * 4;
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
  const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
  const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
  float xv[4], dus[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xv[j] = __bfloat162float(p[j]);
    // the partner channel c +- D/2 is 16 lanes away
    const float partner = __shfl_xor_sync(0xffffffffu, gv[j] * sv[j], 16);
    dus[j] = gv[j] * cv[j] + (lane < 16 ? partner : -partner);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) ss += xv[j] * xv[j];
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
  __align__(8) bf16 y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = __float2bfloat16(r * (du[j] - u[j] * mean));
  *reinterpret_cast<uint2*>(dst + c0) = *reinterpret_cast<const uint2*>(y);
}

// ---------------------------------------------------------------------------
// K4's Hopper main loops (flash_bwd_hopper.cuh) over the prep's qn / kn and delta
// (and in the s_int8 mode its qq / kq), with this epilogue.

// The rope transpose and RMSNorm backward of each complete dqn / dkn row and the
// norm-scale gradient's partial sums, after the main loop.  Each consumer warp
// stages its 16 f32 accumulator rows (one 64 x 128 tile per warpgroup) in its own
// rows of the block's two own tiles, which nothing reads any more: rows 0..3 of
// the warp in the first tile's first 64-column half, 4..7 in its second, 8..11 and
// 12..15 in the second tile's halves, 512 bytes a row, each 16-byte chunk j of row
// i at chunk j ^ (i & 7) (no bank conflicts on either side).  Then the rows go
// through rope_norm_bwd4 (a lane's four channels) in order, the loads of four rows
// in flight together, rows < st summed into the scale-gradient row 0, the others
// into row 1; then the warpgroup's four warps' sums are added in warp order into
// its [2, D] partial: warpgroup c of block x owns the 64 rows of tile 2 x + c
// (qflux_flash_nr_bwd_tiles).  No atomics:
// deterministic.  Rows past S are neither read nor written, and a tile wholly past
// S writes no partial.  A fully masked row has a zero gradient, so its dx and its
// part of the sums are 0.
struct NormRopeGrads {
  const bf16* q;
  const bf16* k;
  const float* q_scale2;
  const float* k_scale2;
  const float* cos;
  const float* sin;
  long long cs_bstride;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dqs_part;
  float* dks_part;
  int st;
  int n_tiles;

  __device__ __forceinline__ void epilogue_dkv(const float (&dva)[64],
                                               const float (&dka)[64], uint8_t* k_tile,
                                               uint8_t* v_tile, int b, int h, int k0, int c,
                                               int r0, int S, int H) const {
    const float one[2] = {1.f, 1.f};
    const size_t hoff = ((size_t)b * S * H + h) * D;
    // dv first: then only dkn's tile is live while it is staged
    store_rows_wg(dva, one, v_tile, bwd_wg::BLK, r0, dv + hoff, H * D, k0 + r0, S);
    __syncwarp();
    finish(dka, k_tile, v_tile, k, k_scale2, dk, dks_part, hoff, b, h, k0, c, r0, S, H);
  }

  __device__ __forceinline__ void epilogue_dq(const float (&dqa)[64], uint8_t* q_tile,
                                              uint8_t* do_tile, int b, int h, int q0, int c,
                                              int r0, int S, int H) const {
    const size_t hoff = ((size_t)b * S * H + h) * D;
    finish(dqa, q_tile, do_tile, q, q_scale2, dq, dqs_part, hoff, b, h, q0, c, r0, S, H);
  }

  // f32 row i (0..15) of this warp's staging
  static __device__ __forceinline__ float* staged(uint8_t* ta, uint8_t* tb, int r0, int i) {
    return reinterpret_cast<float*>((i < 8 ? ta : tb) + ((i >> 2) & 1) * bwd_wg::BLK * 128 +
                                    r0 * 128 + (i & 3) * 512);
  }

  __device__ __forceinline__ void finish(const float (&acc)[64], uint8_t* ta, uint8_t* tb,
                                         const bf16* x, const float* scale2, bf16* dx,
                                         float* part, size_t hoff, int b, int h, int row0, int c,
                                         int r0, int S, int H) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int rs = H * D;
    // accumulator element 4 j + 2 i2 + e: row g + 8 i2, column 8 j + 2 t + e, so
    // 16-byte chunk 2 j + t / 2 of the row
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
        *reinterpret_cast<float2*>(staged(ta, tb, r0, g + 8 * i2) +
                                   (((2 * j + (t >> 1)) ^ g) << 2) + (t & 1) * 2) =
            make_float2(acc[4 * j + 2 * i2], acc[4 * j + 2 * i2 + 1]);
    __syncwarp();
    const float* cb = cos + (size_t)b * cs_bstride + lane * 4;
    const float* sb = sin + (size_t)b * cs_bstride + lane * 4;
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
    // four rows at a time: their loads are in flight together
#pragma unroll 1
    for (int i0 = 0; i0 < 16 && row0 + r0 + i0 < S; i0 += 4) {  // warp-uniform
      float4 g4[4], w4[4], c4[4], s4[4];
      uint2 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u, row = row0 + r0 + i;
        g4[u] = reinterpret_cast<const float4*>(staged(ta, tb, r0, i))[lane ^ (i & 7)];
        raw[u] = make_uint2(0u, 0u);
        w4[u] = c4[u] = s4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < S) {
          raw[u] = *reinterpret_cast<const uint2*>(x + hoff + (size_t)row * rs + lane * 4);
          w4[u] = *reinterpret_cast<const float4*>(scale2 + (row < st ? 0 : D) + lane * 4);
          c4[u] = *reinterpret_cast<const float4*>(cb + (size_t)row * D);
          s4[u] = *reinterpret_cast<const float4*>(sb + (size_t)row * D);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = row0 + r0 + i0 + u;
        if (row >= S) break;  // warp-uniform
        float dsr[4];
        rope_norm_bwd4(g4[u], raw[u], w4[u], c4[u], s4[u], lane, dx + hoff + (size_t)row * rs,
                       dsr);
        if (row < st) {
#pragma unroll
          for (int j = 0; j < 4; ++j) d0[j] += dsr[j];
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) d1[j] += dsr[j];
        }
      }
    }
    // the warp's sums over its first staged rows, then the warpgroup's in warp order
    __syncwarp();
    float* red = staged(ta, tb, r0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[lane * 4 + j] = d0[j];
      red[D + lane * 4 + j] = d1[j];
    }
    warpgroup_sync(c);
    if (row0 + 64 * c < S) {  // warpgroup-uniform
      float* p = part + (((size_t)b * H + h) * n_tiles + 2 * blockIdx.x + c) * 2 * D;
      for (int idx = threadIdx.x & 127; idx < 2 * D; idx += 128) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) sum += staged(ta, tb, 64 * c + 16 * w, 0)[idx];
        p[idx] = sum;
      }
    }
  }
};

// dk / dv: block = 128 keys of one (b, h), 64 per consumer warpgroup
__global__ void __launch_bounds__(bwd_wg::NTHREADS, 1)
flash_nr_dkv_kernel(const __grid_constant__ CUtensorMap kn_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap qn_map,
                    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    const __grid_constant__ NormRopeGrads epi, int S, int H, float scale) {
  bwd_wg::attn_dkv_body(kn_map, v_map, qn_map, do_map, lse, delta, seg, seg, S, S, H, scale,
                        epi);
}

// dq: block = 128 q rows of one (b, h), 64 per consumer warpgroup
__global__ void __launch_bounds__(bwd_wg::NTHREADS, 1)
flash_nr_dq_kernel(const __grid_constant__ CUtensorMap qn_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap kn_map,
                   const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ seg,
                   const __grid_constant__ NormRopeGrads epi, int S, int H, float scale) {
  bwd_wg::attn_dq_body(qn_map, do_map, kn_map, v_map, lse, delta, seg, seg, S, S, H, scale, epi);
}

// The s_int8 mode's score product: the streamed int8 tiles' map and the factor of
// the q rows from q0, (q tile scale * k scale) * scale with IEEE products in that
// order, from the prep's amax [B, H, 1 + ceil(S / q_rows)]
struct Int8Scores {
  static constexpr bool ON = true;
  CUtensorMap step_map;  // dkv: qq, dq: kq, in [64, 128] boxes
  const unsigned* amax;
  int q_rows;
  float scale;

  __device__ __forceinline__ float factor(int b, int h, int H, int S, int q0) const {
    const unsigned* am = amax + ((size_t)b * H + h) * (1 + (S + q_rows - 1) / q_rows);
    return __fmul_rn(__fmul_rn(int8_scale(am[1 + q0 / q_rows]), int8_scale(am[0])), scale);
  }
};

// the s_int8 mode's dk / dv: the loop's int8 path, kq_map the block's int8 keys
__global__ void __launch_bounds__(bwd_wg::NTHREADS, 1)
flash_nr_dkv_int8_kernel(const __grid_constant__ CUtensorMap kq_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap qn_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, const __grid_constant__ NormRopeGrads epi,
                         const __grid_constant__ Int8Scores i8, int S, int H, float scale) {
  bwd_wg::attn_dkv_body(kq_map, v_map, qn_map, do_map, lse, delta, seg, seg, S, S, H, scale,
                        epi, i8);
}

// the s_int8 mode's dq: the loop's int8 path, qq_map the block's int8 q rows
__global__ void __launch_bounds__(bwd_wg::NTHREADS, 1)
flash_nr_dq_int8_kernel(const __grid_constant__ CUtensorMap qq_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap kn_map,
                        const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int* __restrict__ seg,
                        const __grid_constant__ NormRopeGrads epi,
                        const __grid_constant__ Int8Scores i8, int S, int H, float scale) {
  bwd_wg::attn_dq_body(qq_map, do_map, kn_map, v_map, lse, delta, seg, seg, S, S, H, scale, epi,
                       i8);
}

// The bf16 prep on `stream`: qn, kn and delta, one warp per (b, s, h) row.
cudaError_t launch_bf16_prep(const bf16* q, const bf16* k, const bf16* dout, const bf16* out,
                             const float* qs, const float* ks, const float* cos,
                             const float* sin, long long cs_bstride, bf16* qn, bf16* kn,
                             float* delta, int B, int S, int H, int st, cudaStream_t stream) {
  flash_nr_prep_kernel<false><<<prep_blocks<1>(B, S, H), PREP_WARPS * 32, 0, stream>>>(
      q, k, dout, out, qs, ks, cos, sin, cs_bstride, qn, kn, delta, nullptr, 1, B, S, H, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qflux_flash_nr_bwd_tiles(int S) { return (S + PART_ROWS - 1) / PART_ROWS; }

namespace {

// The prep (bf16: qn, kn, delta; s_int8: also amax, qq and kq), then dk / dv, then
// dq, with the bf16 kernels at q_rows = 0 and the s_int8 ones otherwise.  The own
// tiles are loaded in [BLK, *] boxes, the streamed ones in [64, *] boxes.
int launch(const bf16* qb, const bf16* kb, const bf16* vb, const float* qs, const float* ks,
           const float* cs, const float* sn, long long cs_bstride, const int* sg, const bf16* ob,
           const float* ls, const bf16* db, bf16* qnb, bf16* knb, float* dl, int8_t* qq,
           int8_t* kq, unsigned* amax, int q_rows, bf16* dq, bf16* dk, bf16* dv,
           float* dqs_part, float* dks_part, int B, int S, int H, int st, float scale,
           cudaStream_t stream) {
  using bwd_wg::BLK;
  // q_own / k_own: qn / kn (bf16) or qq / kq (s_int8)
  CUtensorMap q_own, do_own, k_own, v_own, qn_step, do_step, kn_step, v_step;
  const bool own_ok = q_rows ? encode_heads8(&q_own, qq, B, S, H, BLK) &&
                                   encode_heads8(&k_own, kq, B, S, H, BLK)
                             : encode_heads(&q_own, qnb, B, S, H, BLK) &&
                                   encode_heads(&k_own, knb, B, S, H, BLK);
  if (!own_ok || !encode_heads(&do_own, db, B, S, H, BLK) ||
      !encode_heads(&v_own, vb, B, S, H, BLK) ||
      !encode_heads(&qn_step, qnb, B, S, H, bwd_wg::KV_STEP) ||
      !encode_heads(&do_step, db, B, S, H, bwd_wg::KV_STEP) ||
      !encode_heads(&kn_step, knb, B, S, H, bwd_wg::STEP) ||
      !encode_heads(&v_step, vb, B, S, H, bwd_wg::STEP))
    return (int)cudaErrorInvalidValue;
  Int8Scores dkv8{}, dq8{};
  if (q_rows) {
    if (!encode_heads8(&dkv8.step_map, qq, B, S, H, bwd_wg::KV_STEP) ||
        !encode_heads8(&dq8.step_map, kq, B, S, H, bwd_wg::STEP))
      return (int)cudaErrorInvalidValue;
    dkv8.amax = dq8.amax = amax;
    dkv8.q_rows = dq8.q_rows = q_rows;
    dkv8.scale = dq8.scale = scale;
  }
  static bool attr[4] = {false, false, false, false};
  cudaError_t err =
      q_rows ? set_smem(attr[2], flash_nr_dkv_int8_kernel, bwd_wg::KV_SMEM8)
             : set_smem(attr[0], flash_nr_dkv_kernel, bwd_wg::KV_SMEM);
  if (err == cudaSuccess)
    err = q_rows ? set_smem(attr[3], flash_nr_dq_int8_kernel, bwd_wg::Q_SMEM8)
                 : set_smem(attr[1], flash_nr_dq_kernel, bwd_wg::Q_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = q_rows ? launch_int8_prep(qb, kb, db, ob, qs, ks, cs, sn, cs_bstride, qnb, knb, dl, qq,
                                  kq, amax, q_rows, B, S, H, st, stream)
               : launch_bf16_prep(qb, kb, db, ob, qs, ks, cs, sn, cs_bstride, qnb, knb, dl, B,
                                  S, H, st, stream);
  if (err != cudaSuccess) return (int)err;
  const NormRopeGrads epi{qb, kb, qs, ks, cs, sn, cs_bstride, dq, dk, dv, dqs_part, dks_part,
                          st, (S + PART_ROWS - 1) / PART_ROWS};
  const dim3 grid((S + BLK - 1) / BLK, H, B);
  if (q_rows)
    flash_nr_dkv_int8_kernel<<<grid, bwd_wg::NTHREADS, bwd_wg::KV_SMEM8, stream>>>(
        k_own, v_own, qn_step, do_step, ls, dl, sg, epi, dkv8, S, H, scale);
  else
    flash_nr_dkv_kernel<<<grid, bwd_wg::NTHREADS, bwd_wg::KV_SMEM, stream>>>(
        k_own, v_own, qn_step, do_step, ls, dl, sg, epi, S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (q_rows)
    flash_nr_dq_int8_kernel<<<grid, bwd_wg::NTHREADS, bwd_wg::Q_SMEM8, stream>>>(
        q_own, do_own, kn_step, v_step, ls, dl, sg, epi, dq8, S, H, scale);
  else
    flash_nr_dq_kernel<<<grid, bwd_wg::NTHREADS, bwd_wg::Q_SMEM, stream>>>(
        q_own, do_own, kn_step, v_step, ls, dl, sg, epi, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_rows = 0: the bf16 kernels.  q_rows > 0 (a multiple of 128, a dq block's rows):
// the s_int8 mode, whose scores are recomputed from q quantized in tiles of q_rows
// rows (the TPU backward's tile, which need not be the forward's) and k quantized per
// (b, h); qq / kq [B, S, H, D] int8 and amax [B, H, 1 + ceil(S / q_rows)] u32 are
// scratch, unused (may be null) at 0.
extern "C" int qflux_flash_nr_bwd(const void* q, const void* k, const void* v,
                                  const void* q_scale2, const void* k_scale2, const void* cos,
                                  const void* sin, long long cs_bstride, const void* seg,
                                  const void* out, const void* lse, const void* dout, void* qn,
                                  void* kn, void* delta, void* qq, void* kq, void* amax,
                                  int q_rows, void* dq, void* dk, void* dv, void* dqs_part,
                                  void* dks_part, int B, int S, int H, int st, float scale,
                                  void* stream) {
  if (q_rows < 0 || q_rows % bwd_wg::BLK || (q_rows && (!qq || !kq || !amax)) || B <= 0 ||
      S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const float*>(q_scale2),
                static_cast<const float*>(k_scale2), static_cast<const float*>(cos),
                static_cast<const float*>(sin), cs_bstride, static_cast<const int*>(seg),
                static_cast<const bf16*>(out), static_cast<const float*>(lse),
                static_cast<const bf16*>(dout), static_cast<bf16*>(qn), static_cast<bf16*>(kn),
                static_cast<float*>(delta), static_cast<int8_t*>(qq), static_cast<int8_t*>(kq),
                static_cast<unsigned*>(amax), q_rows, static_cast<bf16*>(dq),
                static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dqs_part),
                static_cast<float*>(dks_part), B, S, H, st, scale,
                static_cast<cudaStream_t>(stream));
}

// The bf16 mode's prep alone (qn, kn and delta), as qflux_flash_nr_bwd launches it:
// for timing the prep apart from the main kernels.  Returns a cudaError_t.
extern "C" int qflux_flash_nr_bwd_prep(const void* q, const void* k, const void* q_scale2,
                                       const void* k_scale2, const void* cos, const void* sin,
                                       long long cs_bstride, const void* out, const void* dout,
                                       void* qn, void* kn, void* delta, int B, int S, int H,
                                       int st, void* stream) {
  return (int)launch_bf16_prep(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(out), static_cast<const float*>(q_scale2),
      static_cast<const float*>(k_scale2), static_cast<const float*>(cos),
      static_cast<const float*>(sin), cs_bstride, static_cast<bf16*>(qn), static_cast<bf16*>(kn),
      static_cast<float*>(delta), B, S, H, st, static_cast<cudaStream_t>(stream));
}

// The s_int8 prep alone, as either kernel runs it (for tests and for timing it
// apart from the main kernels): kn, kq and amax [B, H, 1 + ceil(S / q_rows)]
// always; qn and qq where not null (K2's, null in K1's); delta = rowsum(dout *
// out) where dout is not null (K2's).  qn / kn bf16, qq / kq int8, all [B, S, H,
// D].  Returns a cudaError_t.
extern "C" int qflux_flash_nr_int8_prep(const void* q, const void* k, const void* q_scale2,
                                        const void* k_scale2, const void* cos, const void* sin,
                                        long long cs_bstride, const void* out, const void* dout,
                                        void* qn, void* kn, void* delta, void* qq, void* kq,
                                        void* amax, int B, int S, int H, int st, int q_rows,
                                        void* stream) {
  if (!kn || !kq || !amax || (dout && (!out || !delta))) return (int)cudaErrorInvalidValue;
  return (int)launch_int8_prep(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(out), static_cast<const float*>(q_scale2),
      static_cast<const float*>(k_scale2), static_cast<const float*>(cos),
      static_cast<const float*>(sin), cs_bstride, static_cast<bf16*>(qn), static_cast<bf16*>(kn),
      static_cast<float*>(delta), static_cast<int8_t*>(qq), static_cast<int8_t*>(kq),
      static_cast<unsigned*>(amax), q_rows, B, S, H, st, static_cast<cudaStream_t>(stream));
}
