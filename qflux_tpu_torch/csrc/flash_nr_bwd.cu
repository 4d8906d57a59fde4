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
// does the same) and kn per (b, h), and its own dkv / dq kernels (the first design:
// four warps of mma.sync m16n8k16 with ldmatrix operands, tiles loaded synchronously,
// 64-row blocks) take s from mma.sync m16n8k32 s8 products of those; ds kn and ds^T qn
// stay bf16 on the normed copies (the gradient is straight through the
// quantization).
//
// Layouts: q/k/v/out/do/dq/dk/dv/qn/kn are [B, S, H, D] bf16 (row stride H * D), lse
// and delta [B, H, S] f32, scale pairs [2, D] f32, cos/sin [S, D] (batch stride 0) or
// [B, S, D] f32, segment ids [B, S] int32 or null, the scale-gradient partials
// [B, H, n_tiles, 2, D] f32 with n_tiles = qflux_flash_nr_bwd_tiles(S).

#include "flash_bwd_hopper.cuh"
#include "flash_nr_common.cuh"

namespace {

// the s_int8 mode's dkv / dq blocks (BR is also the row tile of the scale-gradient
// partials in both modes)
constexpr int NW = 4;             // warps of a dkv / dq block
constexpr int NT = NW * 32;
constexpr int BR = 16 * NW;       // rows a dkv / dq block owns: 16 per warp
constexpr int BC_KV = 32;         // q rows streamed per step of the dkv loop
constexpr int BC_Q = 64;          // keys streamed per step of the dq loop
constexpr int LD = D + 8;         // bf16 row stride of the smem tiles: no bank conflicts
constexpr int LDF = D + 4;        // f32 row stride of the epilogue staging
constexpr int LD8 = D + 16;       // byte row stride of the int8 tiles: no bank conflicts

constexpr size_t DKV_SMEM = sizeof(bf16) * (2 * BR + 2 * BC_KV) * LD  // kn, v; qn, do tiles
                            + sizeof(float) * 3 * BC_KV;             // lse, delta, seg of q
constexpr size_t DQ_SMEM = sizeof(bf16) * (2 * BR + 2 * BC_Q) * LD    // qn, do; kn, v tiles
                           + sizeof(int) * BC_Q;                     // seg of the keys
// the epilogue stages a block's f32 gradients where the two streamed (dq) or the
// two owned (dkv) tiles were
static_assert(sizeof(float) * BR * LDF <= sizeof(bf16) * 2 * BR * LD, "dkv staging");
static_assert(sizeof(float) * BR * LDF <= sizeof(bf16) * 2 * BC_Q * LD, "dq staging");
// the s_int8 mode adds int8 tiles after those: dkv the block's keys and the streamed q
// rows, dq the block's q rows and the streamed keys
constexpr size_t DKV_SMEM_INT8 = DKV_SMEM + (BR + BC_KV) * LD8;
constexpr size_t DQ_SMEM_INT8 = DQ_SMEM + (BR + BC_Q) * LD8;
static_assert(DKV_SMEM % 16 == 0 && DQ_SMEM % 16 == 0, "int8 tiles are 16-byte aligned");

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

// ROWS rows [row0, row0 + ROWS) of one head (row stride `rs`) into a bf16 smem tile,
// 16 bytes per thread per load; rows past S become 0
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int rs, int row0, int S) {
  constexpr int ITERS = ROWS * (D / 8) / NT;
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        row < S ? *reinterpret_cast<const uint4*>(src + (size_t)row * rs + c)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the same for an int8 tile (row stride LD8 bytes)
template <int ROWS>
__device__ __forceinline__ void load_tile8(int8_t* __restrict__ dst,
                                           const int8_t* __restrict__ src, int rs, int row0,
                                           int S) {
  constexpr int ITERS = ROWS * (D / 16) / NT;
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / (D / 16), c = (i % (D / 16)) * 16;
    const int row = row0 + r;
    *reinterpret_cast<uint4*>(dst + r * LD8 + c) =
        row < S ? *reinterpret_cast<const uint4*>(src + (size_t)row * rs + c)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the m16n8k32 s8 A fragment of 16 rows of an int8 tile (row stride LD8), channels
// 32 kk .. 32 kk + 31; the B fragment of 8 rows (the columns) is its first and third
// registers at the first row
__device__ __forceinline__ void frag8(uint32_t (&a)[4], const int8_t* tile, int row0, int kk) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int8_t* r0 = tile + (row0 + g) * LD8 + kk * 32 + 4 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD8);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD8 + 16);
}

// the s_int8 scores of 16 rows (A fragments `a`, one per 32 channels) against the
// N rows of an int8 tile, as f32(sum) * factor (exact int32 sums: |sum| < 2^24)
template <int N>
__device__ __forceinline__ void scores8(float (&s)[N / 8][4], const uint32_t (&a)[D / 32][4],
                                        const int8_t* tile, float factor) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  int acc[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int8_t* r = tile + (n * 8 + g) * LD8 + kk * 32 + 4 * t;
      mma_s8(acc[n], a[kk], *reinterpret_cast<const uint32_t*>(r),
             *reinterpret_cast<const uint32_t*>(r + 16));
    }
  }
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = __fmul_rn(__int2float_rn(acc[n][c]), factor);
}

// (q tile scale * k scale) * scale of the int8 scores, q rows in q tile `qt`
__device__ __forceinline__ float int8_factor(const unsigned* amax, int b, int h, int H, int S,
                                             int q_rows, int qt, float scale) {
  const unsigned* am = amax + ((size_t)b * H + h) * (1 + (S + q_rows - 1) / q_rows);
  return __fmul_rn(__fmul_rn(int8_scale(am[1 + qt]), int8_scale(am[0])), scale);
}

// The s_int8 kernels' epilogue: this warp's 16 rows of f32 gradient w.r.t. the
// normed + roped rows, in the accumulators `acc`, go through smem `stage` (16 x LDF
// floats of its own) to the row-wise rope + norm backward; dx rows land in `dx`, and
// the block's scale-gradient partial (rows < st into row 0, the rest into row 1) in
// `part` [2, D], reduced across the warps over `red` [NW][2][D].
__device__ __forceinline__ void finish_rows(const float (&acc)[D / 8][4], float* stage, float* red,
                                            int row0, int S, int st, const bf16* x, bf16* dx,
                                            int rs, const float* scale2, const float* cos,
                                            const float* sin, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(stage + (g + 8 * i) * LDF + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
  __syncwarp();
  float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + warp * 16 + r;
    if (row >= S) break;  // warp-uniform
    float dsr[4];
    const int c0 = lane * 4;
    rope_norm_bwd4(*reinterpret_cast<const float4*>(stage + r * LDF + c0),
                   *reinterpret_cast<const uint2*>(x + (size_t)row * rs + c0),
                   *reinterpret_cast<const float4*>(scale2 + (row < st ? 0 : D) + c0),
                   *reinterpret_cast<const float4*>(cos + (size_t)row * D + c0),
                   *reinterpret_cast<const float4*>(sin + (size_t)row * D + c0), lane,
                   dx + (size_t)row * rs, dsr);
    if (row < st) {
#pragma unroll
      for (int j = 0; j < 4; ++j) d0[j] += dsr[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d1[j] += dsr[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[(warp * 2 + 0) * D + lane * 4 + j] = d0[j];
    red[(warp * 2 + 1) * D + lane * 4 + j] = d1[j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * D; idx += NT) {
    const int side = idx / D, c = idx % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum += red[(w * 2 + side) * D + c];
    part[idx] = sum;
  }
}

// The s_int8 mode's dk / dv: block = 64 keys of one (b, h); warp w owns keys 16w ..
// 16w+15.  Per step of BC_KV q rows: s^T from the int8 kq rows (A, held in registers
// for the whole loop) and the streamed int8 qq tile, whose q rows lie in one
// quantization tile of q_rows rows, and dp^T = v do^T (A = this warp's v rows, B =
// the do tile); then p^T and ds^T in registers, then dv += p^T do and dkn += ds^T qn
// (A = the accumulators, B = the tiles transposed by ldmatrix), on the bf16 normed
// qn, as in the TPU kernel.
__global__ void __launch_bounds__(NT)
flash_nr_dkv_int8_kernel(const bf16* __restrict__ qn, const int8_t* __restrict__ qq,
                         const int8_t* __restrict__ kq, const unsigned* __restrict__ amax,
                         int q_rows, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const float* __restrict__ k_scale2,
                         const float* __restrict__ cos, const float* __restrict__ sin,
                         long long cs_bstride, const int* __restrict__ seg,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ dks_part, int S, int H, int st, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Vs = reinterpret_cast<bf16*>(smem) + BR * LD;  // [BR][LD] after the staging rows
  bf16* Qs = Vs + BR * LD;                   // [BC_KV][LD] normed q tile
  bf16* Ds = Qs + BC_KV * LD;                // [BC_KV][LD] do tile
  float* lse_s = reinterpret_cast<float*>(Ds + BC_KV * LD);
  float* del_s = lse_s + BC_KV;
  int* segq_s = reinterpret_cast<int*>(del_s + BC_KV);
  int8_t* K8 = reinterpret_cast<int8_t*>(smem + DKV_SMEM);  // [BR][LD8]
  int8_t* Q8 = K8 + BR * LD8;                                 // [BC_KV][LD8]

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const size_t head_off = ((size_t)b * S * H + h) * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * S;
  const float* del_bh = delta + ((size_t)b * H + h) * S;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wrow = warp * 16;

  load_tile8<BR>(K8, kq + head_off, rs, k0, S);
  load_tile<BR>(Vs, v + head_off, rs, k0, S);
  // one validity rule: rows past S carry segment 0; without ids every real token is 1
  int segk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wrow + g + 8 * i;
    segk[i] = row < S ? (segb ? segb[row] : 1) : 0;
  }

  float dva[D / 8][4], dka[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[n][c] = dka[n][c] = 0.f;
  uint32_t ka8[D / 32][4];  // this warp's 16 int8 keys as A fragments
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) frag8(ka8[kk], K8, wrow, kk);

#pragma unroll 1
  for (int q0 = 0; q0 < S; q0 += BC_KV) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<BC_KV>(Qs, qn + head_off, rs, q0, S);
    load_tile<BC_KV>(Ds, dout + head_off, rs, q0, S);
    load_tile8<BC_KV>(Q8, qq + head_off, rs, q0, S);
    if (tid < BC_KV) {
      const int row = q0 + tid;
      const bool in = row < S;
      lse_s[tid] = in ? lse_bh[row] : 0.f;
      del_s[tid] = in ? del_bh[row] : 0.f;
      segq_s[tid] = in ? (segb ? segb[row] : 1) : 0;
    }
    __syncthreads();

    // s^T and dp^T of this warp's 16 keys against the BC_KV q rows
    float sT[BC_KV / 8][4], dpT[BC_KV / 8][4];
#pragma unroll
    for (int n = 0; n < BC_KV / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sT[n][c] = dpT[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t va[4];
      ldsm_x4(va, Vs + (wrow + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < BC_KV / 16; ++np) {
        // matrices: q rows +0/+8 (lane / 16) x channels +0/+8 ((lane / 8) % 2)
        const int off = (np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t db[4];
        ldsm_x4(db, Ds + off);
        mma_bf16(dpT[2 * np], va, db[0], db[1]);
        mma_bf16(dpT[2 * np + 1], va, db[2], db[3]);
      }
    }
    scores8<BC_KV>(sT, ka8, Q8, int8_factor(amax, b, h, H, S, q_rows, q0 / q_rows, scale));

    // element c of tile n: key row g + 8 * (c / 2), q column 8n + 2t + c % 2.  The mask
    // picks p = 0 before exp is used, so a padded row's lse = -1e30 never matters.
#pragma unroll
    for (int n = 0; n < BC_KV / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2, j = 8 * n + 2 * t + (c & 1);
        const bool ok = segk[i] != 0 && segq_s[j] == segk[i];
        const float p = ok ? __expf(sT[n][c] - lse_s[j]) : 0.f;
        sT[n][c] = p;
        dpT[n][c] = p * (dpT[n][c] - del_s[j]) * scale;
      }
    }

    // dv += p^T do, dkn += ds^T qn: the accumulators are A fragments (k = q rows)
#pragma unroll
    for (int kk = 0; kk < BC_KV / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(sT[2 * kk][0], sT[2 * kk][1]);
      pa[1] = pack_bf16(sT[2 * kk][2], sT[2 * kk][3]);
      pa[2] = pack_bf16(sT[2 * kk + 1][0], sT[2 * kk + 1][1]);
      pa[3] = pack_bf16(sT[2 * kk + 1][2], sT[2 * kk + 1][3]);
      sa[0] = pack_bf16(dpT[2 * kk][0], dpT[2 * kk][1]);
      sa[1] = pack_bf16(dpT[2 * kk][2], dpT[2 * kk][3]);
      sa[2] = pack_bf16(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]);
      sa[3] = pack_bf16(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // transposed matrices: q rows +0/+8 ((lane / 8) % 2) x channels +0/+8 (lane / 16)
        const int off = (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 + (lane / 16) * 8;
        uint32_t b4[4];
        ldsm_x4_t(b4, Ds + off);
        mma_bf16(dva[2 * dp], pa, b4[0], b4[1]);
        mma_bf16(dva[2 * dp + 1], pa, b4[2], b4[3]);
        ldsm_x4_t(b4, Qs + off);
        mma_bf16(dka[2 * dp], sa, b4[0], b4[1]);
        mma_bf16(dka[2 * dp + 1], sa, b4[2], b4[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with Vs / Qs / Ds

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + wrow + g + 8 * i;
      if (row < S)
        *reinterpret_cast<uint32_t*>(dv + head_off + (size_t)row * rs + 8 * n + 2 * t) =
            pack_bf16(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * LDF;  // over the first two tiles
  float* red = reinterpret_cast<float*>(Qs);                         // over Qs / Ds
  const float* cb = cos + (size_t)b * cs_bstride;
  const float* sb = sin + (size_t)b * cs_bstride;
  finish_rows(dka, stage, red, k0, S, st, k + head_off, dk + head_off, rs, k_scale2, cb, sb,
              dks_part + (((size_t)b * H + h) * gridDim.x + blockIdx.x) * 2 * D);
}

// The s_int8 mode's dq: block = 64 q rows of one (b, h); warp w owns rows 16w ..
// 16w+15.  s comes from the block's int8 qq rows (A fragments; the block's 64 rows
// lie in one quantization tile) and the streamed int8 kq tile, dp = do v^T; p and
// ds in registers, then dqn += ds kn (B = the bf16 kn tile transposed by ldmatrix).
__global__ void __launch_bounds__(NT)
flash_nr_dq_int8_kernel(const bf16* __restrict__ kn, const int8_t* __restrict__ qq,
                        const int8_t* __restrict__ kq, const unsigned* __restrict__ amax,
                        int q_rows, const bf16* __restrict__ q, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ q_scale2,
                        const float* __restrict__ cos, const float* __restrict__ sin,
                        long long cs_bstride, const int* __restrict__ seg, bf16* __restrict__ dq,
                        float* __restrict__ dqs_part, int S, int H, int st, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ds = reinterpret_cast<bf16*>(smem) + BR * LD;  // [BR][LD] the block's do rows
  bf16* Ks = Ds + BR * LD;                   // [BC_Q][LD] normed key tile
  bf16* Vs = Ks + BC_Q * LD;                 // [BC_Q][LD]
  int* segk_s = reinterpret_cast<int*>(Vs + BC_Q * LD);
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem + DQ_SMEM);  // [BR][LD8]
  int8_t* K8 = Q8 + BR * LD8;                                // [BC_Q][LD8]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const size_t head_off = ((size_t)b * S * H + h) * D;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wrow = warp * 16;

  load_tile8<BR>(Q8, qq + head_off, rs, q0, S);
  load_tile<BR>(Ds, dout + head_off, rs, q0, S);
  float lse_r[2], del_r[2];
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    const bool in = row < S;
    lse_r[i] = in ? lse[((size_t)b * H + h) * S + row] : 0.f;
    del_r[i] = in ? delta[((size_t)b * H + h) * S + row] : 0.f;
    segq[i] = in ? (segb ? segb[row] : 1) : 0;
  }
  __syncthreads();
  // this warp's q rows as int8 A fragments
  uint32_t qf[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) frag8(qf[kk], Q8, wrow, kk);
  const float factor = int8_factor(amax, b, h, H, S, q_rows, q0 / q_rows, scale);

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[n][c] = 0.f;

#pragma unroll 1
  for (int k0 = 0; k0 < S; k0 += BC_Q) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<BC_Q>(Ks, kn + head_off, rs, k0, S);
    load_tile<BC_Q>(Vs, v + head_off, rs, k0, S);
    load_tile8<BC_Q>(K8, kq + head_off, rs, k0, S);
    if (tid < BC_Q) {
      const int row = k0 + tid;
      segk_s[tid] = row < S ? (segb ? segb[row] : 1) : 0;
    }
    __syncthreads();

    float s[BC_Q / 8][4], dp[BC_Q / 8][4];
#pragma unroll
    for (int n = 0; n < BC_Q / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t da[4];
      ldsm_x4(da, Ds + (wrow + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < BC_Q / 16; ++np) {
        // matrices: keys +0/+8 (lane / 16) x channels +0/+8 ((lane / 8) % 2)
        const int off = (np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t vb[4];
        ldsm_x4(vb, Vs + off);
        mma_bf16(dp[2 * np], da, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    scores8<BC_Q>(s, qf, K8, factor);  // already scaled

    // element c of tile n: q row g + 8 * (c / 2), key column 8n + 2t + c % 2; s becomes ds
#pragma unroll
    for (int n = 0; n < BC_Q / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2, j = 8 * n + 2 * t + (c & 1);
        const bool ok = segq[i] != 0 && segk_s[j] == segq[i];
        const float p = ok ? __expf(s[n][c] - lse_r[i]) : 0.f;
        s[n][c] = p * (dp[n][c] - del_r[i]) * scale;
      }
    }

#pragma unroll
    for (int kk = 0; kk < BC_Q / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        // transposed matrices: keys +0/+8 ((lane / 8) % 2) x channels +0/+8 (lane / 16)
        uint32_t kb[4];
        ldsm_x4_t(kb, Ks + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dd * 16 +
                          (lane / 16) * 8);
        mma_bf16(dqa[2 * dd], sa, kb[0], kb[1]);
        mma_bf16(dqa[2 * dd + 1], sa, kb[2], kb[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with Ks / Vs

  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * LDF;  // over Ks / Vs
  float* red = reinterpret_cast<float*>(smem);                     // over the first tile (free)
  const float* cb = cos + (size_t)b * cs_bstride;
  const float* sb = sin + (size_t)b * cs_bstride;
  finish_rows(dqa, stage, red, q0, S, st, q + head_off, dq + head_off, rs, q_scale2, cb, sb,
              dqs_part + (((size_t)b * H + h) * gridDim.x + blockIdx.x) * 2 * D);
}

// ---------------------------------------------------------------------------
// The bf16 mode: K4's Hopper main loops (flash_bwd_hopper.cuh) over the prep's qn /
// kn and delta, with this epilogue.

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
// its [2, D] partial: warpgroup c of block x owns the 64 rows of tile 2 x + c, the
// partial layout of the s_int8 kernels (qflux_flash_nr_bwd_tiles).  No atomics:
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

// The bf16 prep on `stream`: qn, kn and delta, one warp per (b, s, h) row.
cudaError_t launch_bf16_prep(const bf16* q, const bf16* k, const bf16* dout, const bf16* out,
                             const float* qs, const float* ks, const float* cos,
                             const float* sin, long long cs_bstride, bf16* qn, bf16* kn,
                             float* delta, int B, int S, int H, int st, cudaStream_t stream) {
  const int rows = B * S * H;
  flash_nr_prep_kernel<<<(rows + PREP_WARPS - 1) / PREP_WARPS, PREP_WARPS * 32, 0, stream>>>(
      q, k, dout, out, qs, ks, cos, sin, cs_bstride, qn, kn, delta, nullptr, 1, rows, S, H, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qflux_flash_nr_bwd_tiles(int S) { return (S + BR - 1) / BR; }

namespace {

// the bf16 mode: the prep, then dk / dv, then dq
int launch_bf16(const bf16* qb, const bf16* kb, const bf16* vb, const float* qs, const float* ks,
                const float* cs, const float* sn, long long cs_bstride, const int* sg,
                const bf16* ob, const float* ls, const bf16* db, bf16* qnb, bf16* knb, float* dl,
                bf16* dq, bf16* dk, bf16* dv, float* dqs_part, float* dks_part, int B, int S,
                int H, int st, float scale, cudaStream_t stream) {
  using bwd_wg::BLK;
  CUtensorMap qn_own, do_own, kn_own, v_own, qn_step, do_step, kn_step, v_step;
  if (!encode_heads(&qn_own, qnb, B, S, H, BLK) || !encode_heads(&do_own, db, B, S, H, BLK) ||
      !encode_heads(&kn_own, knb, B, S, H, BLK) || !encode_heads(&v_own, vb, B, S, H, BLK) ||
      !encode_heads(&qn_step, qnb, B, S, H, bwd_wg::KV_STEP) ||
      !encode_heads(&do_step, db, B, S, H, bwd_wg::KV_STEP) ||
      !encode_heads(&kn_step, knb, B, S, H, bwd_wg::STEP) ||
      !encode_heads(&v_step, vb, B, S, H, bwd_wg::STEP))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(flash_nr_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bwd_wg::KV_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_nr_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd_wg::Q_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  cudaError_t err = launch_bf16_prep(qb, kb, db, ob, qs, ks, cs, sn, cs_bstride, qnb, knb, dl, B,
                                     S, H, st, stream);
  if (err != cudaSuccess) return (int)err;
  const NormRopeGrads epi{qb, kb, qs, ks, cs, sn, cs_bstride, dq, dk, dv, dqs_part, dks_part,
                          st, (S + BR - 1) / BR};
  const dim3 grid((S + BLK - 1) / BLK, H, B);
  flash_nr_dkv_kernel<<<grid, bwd_wg::NTHREADS, bwd_wg::KV_SMEM, stream>>>(
      kn_own, v_own, qn_step, do_step, ls, dl, sg, epi, S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_nr_dq_kernel<<<grid, bwd_wg::NTHREADS, bwd_wg::Q_SMEM, stream>>>(
      qn_own, do_own, kn_step, v_step, ls, dl, sg, epi, S, H, scale);
  return (int)cudaGetLastError();
}

// the s_int8 mode: its prep (qn / kn, the int8 operands, amax, delta), then its
// dk / dv and dq kernels
int launch_int8(const bf16* qb, const bf16* kb, const bf16* vb, const float* qs, const float* ks,
                const float* cs, const float* sn, long long cs_bstride, const int* sg,
                const bf16* ob, const float* ls, const bf16* db, bf16* qnb, bf16* knb, float* dl,
                int8_t* qq, int8_t* kq, unsigned* amax, int q_rows, bf16* dq, bf16* dk,
                bf16* dv, float* dqs_part, float* dks_part, int B, int S, int H, int st,
                float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_nr_dkv_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DKV_SMEM_INT8);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_nr_dq_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM_INT8);
  if (err != cudaSuccess) return (int)err;
  err = launch_int8_prep(qb, kb, db, ob, qs, ks, cs, sn, cs_bstride, qnb, knb, dl, qq, kq, amax,
                         q_rows, B, S, H, st, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BR - 1) / BR, H, B);
  flash_nr_dkv_int8_kernel<<<grid, NT, DKV_SMEM_INT8, stream>>>(
      qnb, qq, kq, amax, q_rows, kb, vb, db, ls, dl, ks, cs, sn, cs_bstride, sg, dk, dv,
      dks_part, S, H, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_nr_dq_int8_kernel<<<grid, NT, DQ_SMEM_INT8, stream>>>(
      knb, qq, kq, amax, q_rows, qb, vb, db, ls, dl, qs, cs, sn, cs_bstride, sg, dq, dqs_part, S,
      H, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_rows = 0: the bf16 kernel.  q_rows > 0 (a multiple of 64): the s_int8 mode, whose
// scores are recomputed from q quantized in tiles of q_rows rows (the TPU backward's
// tile, which need not be the forward's) and k quantized per (b, h); qq / kq [B, S, H, D]
// int8 and amax [B, H, 1 + ceil(S / q_rows)] u32 are scratch, unused (may be null) at 0.
extern "C" int qflux_flash_nr_bwd(const void* q, const void* k, const void* v,
                                  const void* q_scale2, const void* k_scale2, const void* cos,
                                  const void* sin, long long cs_bstride, const void* seg,
                                  const void* out, const void* lse, const void* dout, void* qn,
                                  void* kn, void* delta, void* qq, void* kq, void* amax,
                                  int q_rows, void* dq, void* dk, void* dv, void* dqs_part,
                                  void* dks_part, int B, int S, int H, int st, float scale,
                                  void* stream) {
  if (q_rows < 0 || q_rows % BR || B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(out),
             *db = static_cast<const bf16*>(dout);
  const float *qs = static_cast<const float*>(q_scale2), *ks = static_cast<const float*>(k_scale2),
              *cs = static_cast<const float*>(cos), *sn = static_cast<const float*>(sin),
              *ls = static_cast<const float*>(lse);
  const int* sg = static_cast<const int*>(seg);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (!q_rows)
    return launch_bf16(qb, kb, vb, qs, ks, cs, sn, cs_bstride, sg, ob, ls, db,
                       static_cast<bf16*>(qn), static_cast<bf16*>(kn), static_cast<float*>(delta),
                       static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                       static_cast<float*>(dqs_part), static_cast<float*>(dks_part), B, S, H, st,
                       scale, st_);
  return launch_int8(qb, kb, vb, qs, ks, cs, sn, cs_bstride, sg, ob, ls, db,
                     static_cast<bf16*>(qn), static_cast<bf16*>(kn), static_cast<float*>(delta),
                     static_cast<int8_t*>(qq), static_cast<int8_t*>(kq),
                     static_cast<unsigned*>(amax), q_rows, static_cast<bf16*>(dq),
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dqs_part),
                     static_cast<float*>(dks_part), B, S, H, st, scale, st_);
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

// The s_int8 prep alone (for tests): qn / kn bf16, qq / kq int8 [B, S, H, D] and amax
// [B, H, 1 + ceil(S / q_rows)] as the backward computes them.
extern "C" int qflux_flash_nr_int8_prep(const void* q, const void* k, const void* q_scale2,
                                        const void* k_scale2, const void* cos, const void* sin,
                                        long long cs_bstride, void* qn, void* kn, void* qq,
                                        void* kq, void* amax, int B, int S, int H, int st,
                                        int q_rows, void* stream) {
  return (int)launch_int8_prep(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), nullptr, nullptr,
      static_cast<const float*>(q_scale2), static_cast<const float*>(k_scale2),
      static_cast<const float*>(cos), static_cast<const float*>(sin), cs_bstride,
      static_cast<bf16*>(qn), static_cast<bf16*>(kn), nullptr, static_cast<int8_t*>(qq),
      static_cast<int8_t*>(kq), static_cast<unsigned*>(amax), q_rows, B, S, H, st,
      static_cast<cudaStream_t>(stream));
}
