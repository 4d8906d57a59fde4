// Backward of the plain bidirectional flash attention, for Hopper: kernel K4 of the port.
//
// Replaces the three Pallas TPU kernels of qflux_tpu/ops/flash_attention.py's backward:
// _dqdkv_kernel (K4a, the merged backward of _bwd_merged), _dq_kernel (K4b) and
// _dkv_kernel (K4c, the split backward of _bwd).  The three compute one function and
// differ only in how the TPU's VMEM split the work and in the f32 order of the dq sum,
// so one backward serves all three.  From q, k, v (normed and roped), the segment ids,
// the out and lse of the forward (or, in a ring hop, the GLOBAL out and lse) and the
// cotangent do, it computes for every (b, h):
//
//   delta = rowsum(do * out)                                     (f32)
//   p     = exp(q k^T * scale - lse), 0 wherever the segment mask forbids (a select)
//   dv    = bf16(p)^T do
//   ds    = bf16(p * (do v^T - delta) * scale)
//   dq    = ds k,  dk = ds^T q                                   (f32, written bf16)
//
// GPU blocks run in parallel and in no order, so instead of the TPU's sequential q loop
// with dk / dv in VMEM scratch, three kernels run in order on one stream, with no
// atomics (the result is deterministic):
//
//   1. delta: one warp per (b, s, h) row;
//   2. dkv:   one block per 64-key tile of a head; four warps of 16 keys loop over all
//             q tiles and accumulate dv and dk in registers;
//   3. dq:    one block per 64-row q tile; four warps of 16 rows loop over all K tiles
//             and accumulate dq in registers.
//
// Fully masked rows (segment 0: lse = -1e30, so exp(s - lse) would be +inf) never
// evaluate exp: the mask selects p = 0 before any product, and with it ds, dv and dq of
// those rows are 0 whatever do holds there.
//
// What bounds it on an H100: five Sq x Sk x D GEMMs per head (scores, dp, dv, dq, dk),
// 10 * B * H * Sq * Sk * D operations (2.5x the forward's), against ~(5 Sq + 4 Sk) * B *
// H * D bf16 of device traffic: at the Qwen 832x576 shape 492 GFLOP, 0.497 ms at the
// 989 TFLOP/s bf16 peak, compute-bound on the tensor cores.  This design recomputes the
// scores and dp in both the dkv and the dq kernel, seven GEMMs instead of five, to keep
// the row-complete dq without atomics; the products run as mma.sync m16n8k16 with
// ldmatrix operands (K2's fragments, csrc/flash_nr_bwd.cu, without its norm + rope
// epilogues), scores, probabilities and the three accumulators in registers.  Tiles are
// loaded synchronously: wgmma, TMA and pipelining are left for later work.
//
// Layouts: q/out/do/dq [B, Sq, H, D] and k/v/dk/dv [B, Sk, H, D] bf16 (row stride
// H * D), lse and delta [B, H, Sq] f32, q_seg [B, Sq] and kv_seg [B, Sk] int32, or both
// null (the unmasked case: every real token is segment 1).

#include "common.cuh"

namespace {

constexpr int D = 128;            // the only head dim the kernels take
constexpr int NW = 4;             // warps of a dkv / dq block
constexpr int NT = NW * 32;
constexpr int BR = 16 * NW;       // rows a dkv / dq block owns: 16 per warp
constexpr int BC_KV = 32;         // q rows streamed per step of the dkv loop
constexpr int BC_Q = 64;          // keys streamed per step of the dq loop
constexpr int LD = D + 8;         // bf16 row stride of the smem tiles: no bank conflicts
constexpr int DELTA_WARPS = 8;

constexpr size_t DKV_SMEM = sizeof(bf16) * (2 * BR + 2 * BC_KV) * LD  // k, v; q, do tiles
                            + sizeof(float) * 3 * BC_KV;             // lse, delta, seg of q
constexpr size_t DQ_SMEM = sizeof(bf16) * (2 * BR + 2 * BC_Q) * LD    // q, do; k, v tiles
                           + sizeof(int) * BC_Q;                     // seg of the keys

__device__ __forceinline__ int seg_of(const int* __restrict__ seg, int row, int n) {
  // one validity rule: rows past n carry segment 0; without ids every real token is 1
  return row < n ? (seg ? seg[row] : 1) : 0;
}

// ROWS rows [row0, row0 + ROWS) of one head (row stride `rs`) into a bf16 smem tile,
// 16 bytes per thread per load; rows past n become 0
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int rs, int row0, int n) {
  constexpr int ITERS = ROWS * (D / 8) / NT;
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        row < n ? *reinterpret_cast<const uint4*>(src + (size_t)row * rs + c)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// this warp's 16 rows of f32 accumulators [16][D] → bf16 rows [row0 + wrow, ...) of one
// head (rows past n skipped)
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], bf16* __restrict__ dst,
                                           int rs, int row0, int n) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row < n)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row * rs + 8 * nn + 2 * t) =
            pack_bf16(acc[nn][2 * i], acc[nn][2 * i + 1]);
    }
  }
}

// delta[b, h, s] = sum over d of do * out, in f32; one warp per (b, s, h) row
__global__ void __launch_bounds__(DELTA_WARPS * 32)
flash_delta_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                   float* __restrict__ delta, int rows, int Sq, int H) {
  const int row = blockIdx.x * DELTA_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  // row = (b * Sq + s) * H + h: [B, Sq, H, D] rows are contiguous D-vectors
  const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
  const size_t off = (size_t)row * D + lane * 4;
  const uint2 draw = *reinterpret_cast<const uint2*>(dout + off);
  const uint2 oraw = *reinterpret_cast<const uint2*>(out + off);
  const bf16* dp = reinterpret_cast<const bf16*>(&draw);
  const bf16* op = reinterpret_cast<const bf16*>(&oraw);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc += __bfloat162float(dp[j]) * __bfloat162float(op[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[((size_t)b * H + h) * Sq + s] = acc;
}

// dk / dv: block = 64 keys of one (b, h); warp w owns keys 16w .. 16w+15.  Per step of
// BC_KV q rows: s^T = k q^T and dp^T = v do^T (A = this warp's k / v rows, B = the q /
// do tile), then p^T and ds^T in registers, then dv += p^T do and dk += ds^T q (A = the
// accumulators, B = the tiles transposed by ldmatrix).
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BR][LD] this block's keys
  bf16* Vs = Ks + BR * LD;                   // [BR][LD]
  bf16* Qs = Vs + BR * LD;                   // [BC_KV][LD] q tile
  bf16* Ds = Qs + BC_KV * LD;                // [BC_KV][LD] do tile
  float* lse_s = reinterpret_cast<float*>(Ds + BC_KV * LD);
  float* del_s = lse_s + BC_KV;
  int* segq_s = reinterpret_cast<int*>(del_s + BC_KV);

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const size_t qh = ((size_t)b * Sq * H + h) * D, kh = ((size_t)b * Sk * H + h) * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * Sq;
  const float* del_bh = delta + ((size_t)b * H + h) * Sq;
  const int* qsegb = q_seg ? q_seg + (size_t)b * Sq : nullptr;
  const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;
  const int wrow = warp * 16;

  load_tile<BR>(Ks, k + kh, rs, k0, Sk);
  load_tile<BR>(Vs, v + kh, rs, k0, Sk);
  int segk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) segk[i] = seg_of(ksegb, k0 + wrow + g + 8 * i, Sk);

  float dva[D / 8][4], dka[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[n][c] = dka[n][c] = 0.f;

#pragma unroll 1
  for (int q0 = 0; q0 < Sq; q0 += BC_KV) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<BC_KV>(Qs, q + qh, rs, q0, Sq);
    load_tile<BC_KV>(Ds, dout + qh, rs, q0, Sq);
    if (tid < BC_KV) {
      const int row = q0 + tid;
      const bool in = row < Sq;
      lse_s[tid] = in ? lse_bh[row] : 0.f;
      del_s[tid] = in ? del_bh[row] : 0.f;
      segq_s[tid] = seg_of(qsegb, row, Sq);
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
      uint32_t ka[4], va[4];
      ldsm_x4(ka, Ks + (wrow + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
      ldsm_x4(va, Vs + (wrow + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < BC_KV / 16; ++np) {
        // matrices: q rows +0/+8 (lane / 16) x channels +0/+8 ((lane / 8) % 2)
        const int off = (np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t qb[4], db[4];
        ldsm_x4(qb, Qs + off);
        mma_bf16(sT[2 * np], ka, qb[0], qb[1]);
        mma_bf16(sT[2 * np + 1], ka, qb[2], qb[3]);
        ldsm_x4(db, Ds + off);
        mma_bf16(dpT[2 * np], va, db[0], db[1]);
        mma_bf16(dpT[2 * np + 1], va, db[2], db[3]);
      }
    }

    // element c of tile n: key row g + 8 * (c / 2), q column 8n + 2t + c % 2
#pragma unroll
    for (int n = 0; n < BC_KV / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2, j = 8 * n + 2 * t + (c & 1);
        const bool ok = segk[i] != 0 && segq_s[j] == segk[i];
        const float p = ok ? __expf(__fmul_rn(sT[n][c], scale) - lse_s[j]) : 0.f;
        sT[n][c] = p;
        dpT[n][c] = p * (dpT[n][c] - del_s[j]) * scale;
      }
    }

    // dv += p^T do, dk += ds^T q: the accumulators are A fragments (k = q rows)
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
  store_rows(dva, dv + kh, rs, k0 + wrow, Sk);
  store_rows(dka, dk + kh, rs, k0 + wrow, Sk);
}

// dq: block = 64 q rows of one (b, h); warp w owns rows 16w .. 16w+15 and holds their q
// as A fragments.  Per step of BC_Q keys: s = q k^T and dp = do v^T, p and ds in
// registers, then dq += ds k (B = the k tile transposed by ldmatrix).
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                bf16* __restrict__ dq, int Sq, int Sk, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BR][LD] this block's q rows
  bf16* Ds = Qs + BR * LD;                   // [BR][LD] their do rows
  bf16* Ks = Ds + BR * LD;                   // [BC_Q][LD] key tile
  bf16* Vs = Ks + BC_Q * LD;                 // [BC_Q][LD]
  int* segk_s = reinterpret_cast<int*>(Vs + BC_Q * LD);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const size_t qh = ((size_t)b * Sq * H + h) * D, kh = ((size_t)b * Sk * H + h) * D;
  const int* qsegb = q_seg ? q_seg + (size_t)b * Sq : nullptr;
  const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;
  const int wrow = warp * 16;

  load_tile<BR>(Qs, q + qh, rs, q0, Sq);
  load_tile<BR>(Ds, dout + qh, rs, q0, Sq);
  float lse_r[2], del_r[2];
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    const bool in = row < Sq;
    lse_r[i] = in ? lse[((size_t)b * H + h) * Sq + row] : 0.f;
    del_r[i] = in ? delta[((size_t)b * H + h) * Sq + row] : 0.f;
    segq[i] = seg_of(qsegb, row, Sq);
  }
  __syncthreads();
  uint32_t qf[D / 16][4];  // this warp's q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], Qs + (wrow + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[n][c] = 0.f;

#pragma unroll 1
  for (int k0 = 0; k0 < Sk; k0 += BC_Q) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<BC_Q>(Ks, k + kh, rs, k0, Sk);
    load_tile<BC_Q>(Vs, v + kh, rs, k0, Sk);
    if (tid < BC_Q) segk_s[tid] = seg_of(ksegb, k0 + tid, Sk);
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
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Ks + off);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        ldsm_x4(vb, Vs + off);
        mma_bf16(dp[2 * np], da, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }

    // element c of tile n: q row g + 8 * (c / 2), key column 8n + 2t + c % 2; s becomes ds
#pragma unroll
    for (int n = 0; n < BC_Q / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2, j = 8 * n + 2 * t + (c & 1);
        const bool ok = segq[i] != 0 && segk_s[j] == segq[i];
        const float p = ok ? __expf(__fmul_rn(s[n][c], scale) - lse_r[i]) : 0.f;
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
  store_rows(dqa, dq + qh, rs, q0 + wrow, Sq);
}

}  // namespace

// Launch K4 on `stream`: delta (f32 [B, H, Sq] scratch), then dk / dv, then dq.
// q_seg [B, Sq] / kv_seg [B, Sk] int32, or both null (the unmasked case).  Returns a
// cudaError_t (0 = launched).
extern "C" int qflux_flash_bwd(const void* q, const void* k, const void* v, const void* q_seg,
                               const void* kv_seg, const void* out, const void* lse,
                               const void* dout, void* delta, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  flash_delta_kernel<<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0, st>>>(
      db, static_cast<const bf16*>(out), dl, rows, Sq, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<<<dim3((Sk + BR - 1) / BR, H, B), NT, DKV_SMEM, st>>>(
      qb, kb, vb, db, ls, dl, qs, ks, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<<<dim3((Sq + BR - 1) / BR, H, B), NT, DQ_SMEM, st>>>(
      qb, kb, vb, db, ls, dl, qs, ks, static_cast<bf16*>(dq), Sq, Sk, H, scale);
  return (int)cudaGetLastError();
}
