// Flash attention on the CUDA cores, for the f32 modes no tensor-core kernel takes
// yet: K1 / K2 in f32 at head dim 128 in their s_int8 mode; and the f32 prep and rope
// + norm backward that every f32 mode of K1 / K2 runs (the plain f32 K1 / K3 run on the
// tensor cores as a 3xTF32 split, flash_f32_fwd.cu, and K2 / K4 likewise,
// flash_f32_bwd.cu; both call this file's prep, and K2 its rope + norm backward).
//
// Replaces the same Pallas TPU kernels as the wgmma kernels, in the mode JAX runs
// them in without a dtype condition of its own (its kernels compute in f32 and cast
// to the refs' dtype):
//   * K1 (qflux_tpu/ops/flash_nr.py:192 _fwd_nr_kernel) and K2 (:311 _bwd_nr_kernel)
//     in f32 in their s_int8 mode, at D = 128: qflux_simt_nr_fwd, qflux_simt_nr_bwd;
//   * their prep alone, qflux_simt_nr_prep (which flash_f32_fwd.cu's K1 and
//     flash_f32_bwd.cu's K2 run before their loops), and the rope + norm backward
//     alone, qflux_simt_nr_rope_norm_bwd (which K2's f32 modes end with).
//
// The function is K1's / K2's (flash_nr_fwd.cu, flash_nr_bwd.cu say it in full) over
// the int8 scores: for every (b, h), out = softmax(s + segment mask) v and lse, with
// p kept in f32 for the P V product and the sum divided by l at the end; fully
// masked rows write 0 and lse = -1e30; keys past S carry segment 0.  The backward:
// delta = rowsum(do * out), p = exp(s - lse) (0 by select where masked), dv = p^T do,
// ds = p (do v^T - delta) scale, dq = ds kn, dk = ds^T qn.
//
// The s_int8 scores.  The prep, one warp per (b, s, h) row (flash_nr_common.cuh's
// norm_rope4_f32: flash_nr_fwd.cu's flash_nr_kn_kernel widened to f32 in and out,
// applied to q as well as k, the scale row picked at st), writes f32 scratch qn / kn
// (with delta for K2), reduces the largest |qn| of each (b, h, q tile of q_rows rows)
// and |kn| of each (b, h) into amax (atomicMax on the bits of non-negative floats:
// order-free) and quantizes qn / kn as `_quant_tile` does; the scores are then __dp4a
// products of the int8 rows into int32 (exact), times (q tile scale * k scale) *
// scale.  The gradient is straight through: dq = ds kn and dk = ds^T qn on the f32
// copies.  K2 ends with a rope + norm backward pass (flash_nr_bwd.cu's NormRopeGrads
// arithmetic in f32): dq / dk of the raw projections and one [2, D] scale-gradient
// partial per (b, h, 64-row tile), split at st, which the wrapper sums as K2's bf16
// mode's.
//
// What bounds it on an H100: the int8 score products at the tensor cores' 1,979 TOPS,
// the other products f32-accurate at 495 / 3 TFLOP/s (chip_smoke.py's _f32_bound);
// these loops run the int8 scores on __dp4a and every other product as FFMA at 67
// TFLOP/s.  The bytes ((4 Sq + 4 Sk) * B * H * D * 4 backward, 252 MB at FLUX's 512^2
// shape, 0.075 ms at 3.35 TB/s) are far below: compute-bound.  The s_int8 modes are
// the next to move to the tensor cores (ROADMAP.md queue 2).
//
// What the design does about that: it is simple first.  A block of 256 threads
// (16 x 16) owns 64 rows (the forward's and dq's q rows, dkv's keys) and streams
// 64-row tiles of the other side through shared memory as f32 rows padded to D +
// 4 floats (16-byte loads, no bank conflicts; int8 rows padded likewise); thread
// (ty, tx) computes a 4 x 4 block of scores (rows 4 ty .. 4 ty + 3, columns tx + 16
// j), the online softmax's row max and sum go over the 16 threads of a row by
// shuffles, p (or ds) goes through shared memory, and the thread accumulates rows 4
// ty + i, columns tx + 16 c of the output.  The backward is K4's split: dk / dv over
// the keys of a block, then dq over its q rows, each recomputing the scores, no
// atomics, deterministic.
//
// Layouts: q/out/do/dq and k/v/dk/dv [B, S, H, 128] f32 (the projection layout), lse
// and delta [B, H, S] f32, ids [B, S] int32 or null (the unmasked case: every real
// token is segment 1); scale pairs [2, D] f32, cos / sin [S, D] (batch stride 0) or
// [B, S, D] f32, their inputs 16-byte aligned (float4 rows).

#include "flash_nr_common.cuh"

namespace {
namespace simt {

constexpr int BQ = 64;        // q rows of a block (forward, dq) or of a streamed tile (dkv)
constexpr int BK = 64;        // keys of a block (dkv) or of a streamed tile (forward, dq)
constexpr int THREADS = 256;  // 16 x 16; thread (ty, tx) owns rows 4 ty .. 4 ty + 3
constexpr float NEG = -1e30f;

// What the loops read: q / k / v in f32 (the fused modes' qn / kn), the int8 q / k and
// their amax where the scores are int8, the ids, and the backward's residuals.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int8_t* qq;      // int8 [B, Sq, H, D] / [B, Sk, H, D] (INT8)
  const int8_t* kq;
  const unsigned* amax;  // [B, H, 1 + ceil(Sq / q_rows)]: slot 0 k's, 1 + i q tile i's
  int q_rows;
  const int* q_seg;
  const int* kv_seg;
  const float* lse;      // backward
  const float* delta;    // backward
  const void* dout;      // backward, [B, Sq, H, D] f32
  int Sq, Sk, H;
  float scale;
};

// the s_int8 score factor of q row `row`: (q tile scale * k scale) * scale
__device__ __forceinline__ float int8_factor(const Args& a, int b, int h, int row) {
  const unsigned* am =
      a.amax + ((size_t)b * a.H + h) * (1 + (a.Sq + a.q_rows - 1) / a.q_rows);
  return __fmul_rn(__fmul_rn(int8_scale(am[1 + row / a.q_rows]), int8_scale(am[0])), a.scale);
}

// rows r0 .. r0 + ROWS - 1 of head h of sample b (zeros past S) as f32 rows of
// stride HD + 4 at dst
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const void* src, int b, int r0, int S,
                                          int H, int h) {
  const float* x = static_cast<const float*>(src);
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD, s = r0 + r;
    dst[r * (HD + 4) + d] =
        s < S ? x[(((size_t)b * S + s) * H + h) * HD + d] : 0.f;
  }
}

// the same for int8 rows, as words of four values, stride HD / 4 + 4 words
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile8(int* dst, const int8_t* src, int b, int r0, int S,
                                           int H, int h) {
  constexpr int W = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * W; idx += THREADS) {
    const int r = idx / W, w = idx % W, s = r0 + r;
    dst[r * (W + 4) + w] =
        s < S ? reinterpret_cast<const int*>(src + (((size_t)b * S + s) * H + h) * HD)[w] : 0;
  }
}

// acc[i][j] += A row (4 ty + i) . B row (tx + 16 j), f32 rows of stride HD + 4
template <int HD>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int ty, int tx,
                                         float (&acc)[4][4]) {
  constexpr int P = HD + 4;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * P + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, bb[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bb[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bb[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bb[j].w, acc[i][j]);
      }
  }
}

// the same over int8 rows (load_tile8), exact in int32
template <int HD>
__device__ __forceinline__ void dot_tile8(const int* A, const int* Bm, int ty, int tx,
                                          int (&acc)[4][4]) {
  constexpr int P = HD / 4 + 4;
#pragma unroll 2
  for (int w = 0; w < HD / 4; w += 4) {
    int4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const int4*>(A + (4 * ty + i) * P + w);
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = *reinterpret_cast<const int4*>(Bm + (tx + 16 * j) * P + w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = __dp4a(a[i].x, bb[j].x, acc[i][j]);
        acc[i][j] = __dp4a(a[i].y, bb[j].y, acc[i][j]);
        acc[i][j] = __dp4a(a[i].z, bb[j].z, acc[i][j]);
        acc[i][j] = __dp4a(a[i].w, bb[j].w, acc[i][j]);
      }
  }
}

// o[i][c] += sum over k of Pm[4 ty + i][k] * X[k][tx + 16 c]: Pm [64][KR] f32, X f32
// rows of stride HD + 4
template <int HD, int KR>
__device__ __forceinline__ void pv_tile(const float* Pm, const float* X, int ty, int tx,
                                        float (&o)[4][HD / 16]) {
  constexpr int P = HD + 4, NC = HD / 16;
#pragma unroll 2
  for (int k = 0; k < KR; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(Pm + (4 * ty + i) * KR + k);
      p[i][0] = t.x, p[i][1] = t.y, p[i][2] = t.z, p[i][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) x[c] = X[(k + kk) * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] = fmaf(p[i][kk], x[c], o[i][c]);
    }
  }
}

// reductions over the 16 threads (tx) of a row group: lanes 0-15 and 16-31 of a warp
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the id of token s, or 0 past the end; every real token is 1 without ids
template <bool SEG>
__device__ __forceinline__ int seg_of(const int* ids, int b, int s, int S) {
  if (s >= S) return 0;
  return SEG ? ids[(size_t)b * S + s] : 1;
}

// the scores of a 4 x 4 thread block: f32 products times scale, or the int8
// products times their factor (fac[i] of row i; all equal in the backward)
template <int HD, bool INT8>
__device__ __forceinline__ void scores(const void* A, const void* Bm, int ty, int tx,
                                       const float (&fac)[4], float (&s)[4][4]) {
  if constexpr (INT8) {
    int acc[4][4] = {};
    dot_tile8<HD>(static_cast<const int*>(A), static_cast<const int*>(Bm), ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn((float)acc[i][j], fac[i]);
  } else {
    float acc[4][4] = {};
    dot_tile<HD>(static_cast<const float*>(A), static_cast<const float*>(Bm), ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn(acc[i][j], fac[i]);
  }
}

template <int HD>
__host__ __device__ constexpr int rows_bytes(bool int8) {  // a 64-row tile in shared memory
  return 64 * (int8 ? HD / 4 + 4 : HD + 4) * 4;
}

template <int HD>
__host__ __device__ constexpr int fwd_smem() {  // V, P, key ids, Q (int8), K (int8)
  return rows_bytes<HD>(false) + BQ * BK * 4 + BK * 4 + 2 * rows_bytes<HD>(true);
}

// ---------------------------------------------------------------------------
// the s_int8 forward: block = 64 q rows of one (b, h), the keys in 64-row tiles

template <int HD, bool SEG>
__global__ void __launch_bounds__(THREADS)
simt_fwd_int8_kernel(const Args a, float* __restrict__ out, float* __restrict__ lse) {
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sV = reinterpret_cast<float*>(smem);
  float* sP = reinterpret_cast<float*>(smem + rows_bytes<HD>(false));
  int* sKseg = reinterpret_cast<int*>(sP + BQ * BK);
  int* sQ = sKseg + BK;
  int* sK = sQ + rows_bytes<HD>(true) / 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  load_tile8<HD, BQ>(sQ, a.qq, b, q0, a.Sq, a.H, h);
  int qseg[4];
  float fac[4], m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    qseg[i] = seg_of<SEG>(a.q_seg, b, r, a.Sq);
    fac[i] = int8_factor(a, b, h, min(r, a.Sq - 1));
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < a.Sk; k0 += BK) {
    __syncthreads();  // the last tile's readers are done
    load_tile8<HD, BK>(sK, a.kq, b, k0, a.Sk, a.H, h);
    load_tile<HD, BK>(sV, a.v, b, k0, a.Sk, a.H, h);
    if (threadIdx.x < BK) sKseg[threadIdx.x] = seg_of<SEG>(a.kv_seg, b, k0 + threadIdx.x, a.Sk);
    __syncthreads();
    float s[4][4];
    scores<HD, true>(sQ, sK, ty, tx, fac, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ks = sKseg[tx + 16 * j];
        ok[j] = ks != 0 && ks == qseg[i];
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ps += p;
        sP[(4 * ty + i) * BK + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<HD, BK>(sP, sV, ty, tx, o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= a.Sq) break;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    float* dst = out + (((size_t)b * a.Sq + r) * a.H + h) * HD + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[16 * c] = o[i][c] * inv;
    if (tx == 0) lse[((size_t)b * a.H + h) * a.Sq + r] = l[i] == 0.f ? NEG : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward

// K int8 (own), V (own), Q, Q int8, dO, P^T, dS^T, lse, delta, q ids
template <int HD>
__host__ __device__ constexpr int dkv_smem() {
  return rows_bytes<HD>(true) + rows_bytes<HD>(false) + rows_bytes<HD>(false) +
         rows_bytes<HD>(true) + rows_bytes<HD>(false) + 2 * BK * BQ * 4 + 3 * BQ * 4;
}

// Q int8 (own), dO (own), K, K int8, V, dS, key ids
template <int HD>
__host__ __device__ constexpr int dq_smem() {
  return rows_bytes<HD>(true) + rows_bytes<HD>(false) + rows_bytes<HD>(false) +
         rows_bytes<HD>(true) + rows_bytes<HD>(false) + BQ * BK * 4 + BK * 4;
}

// the s_int8 backward's dk / dv: block = 64 keys of one (b, h), the q rows in 64-row
// tiles.  A q tile of 64 rows lies in one quantization tile (q_rows is a multiple of
// 64), so it has one factor.
template <int HD, bool SEG>
__global__ void __launch_bounds__(THREADS)
simt_dkv_kernel(const Args a, float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;
  float* sV = reinterpret_cast<float*>(sK + rows_bytes<HD>(true));
  float* sQ = sV + rows_bytes<HD>(false) / 4;
  int* sQ8 = reinterpret_cast<int*>(sQ + rows_bytes<HD>(false) / 4);
  float* sDO = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sQ8) +
                                        rows_bytes<HD>(true));
  float* sPt = sDO + rows_bytes<HD>(false) / 4;
  float* sDSt = sPt + BK * BQ;
  float* sLse = sDSt + BK * BQ;
  float* sDelta = sLse + BQ;
  int* sQseg = reinterpret_cast<int*>(sDelta + BQ);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  load_tile8<HD, BK>(reinterpret_cast<int*>(sK), a.kq, b, k0, a.Sk, a.H, h);
  load_tile<HD, BK>(sV, a.v, b, k0, a.Sk, a.H, h);
  int kseg[4];
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kseg[i] = seg_of<SEG>(a.kv_seg, b, k0 + 4 * ty + i, a.Sk);
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  for (int q0 = 0; q0 < a.Sq; q0 += BQ) {
    __syncthreads();
    load_tile<HD, BQ>(sQ, a.q, b, q0, a.Sq, a.H, h);
    load_tile8<HD, BQ>(sQ8, a.qq, b, q0, a.Sq, a.H, h);
    load_tile<HD, BQ>(sDO, a.dout, b, q0, a.Sq, a.H, h);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      const size_t row = ((size_t)b * a.H + h) * a.Sq + r;
      sLse[threadIdx.x] = r < a.Sq ? a.lse[row] : 0.f;
      sDelta[threadIdx.x] = r < a.Sq ? a.delta[row] : 0.f;
      sQseg[threadIdx.x] = seg_of<SEG>(a.q_seg, b, r, a.Sq);
    }
    __syncthreads();
    float fac[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) fac[i] = int8_factor(a, b, h, q0);
    float s[4][4], dp[4][4];
    scores<HD, true>(sK, sQ8, ty, tx, fac, s);    // s^T: keys x q rows
    scores<HD, false>(sV, sDO, ty, tx, one, dp);  // dp^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j, qs = sQseg[qj];
        const float p = qs != 0 && qs == kseg[i] ? expf(s[i][j] - sLse[qj]) : 0.f;
        const float ds = __fmul_rn(__fmul_rn(p, dp[i][j] - sDelta[qj]), a.scale);
        sPt[(4 * ty + i) * BQ + qj] = p;
        sDSt[(4 * ty + i) * BQ + qj] = ds;
      }
    __syncthreads();
    pv_tile<HD, BQ>(sPt, sDO, ty, tx, dva);
    pv_tile<HD, BQ>(sDSt, sQ, ty, tx, dka);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    if (r >= a.Sk) break;
    const size_t off = (((size_t)b * a.Sk + r) * a.H + h) * HD + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + 16 * c] = dka[i][c];
      dv[off + 16 * c] = dva[i][c];
    }
  }
}

// the s_int8 backward's dq: block = 64 q rows of one (b, h), the keys in 64-row tiles
template <int HD, bool SEG>
__global__ void __launch_bounds__(THREADS) simt_dq_kernel(const Args a, float* __restrict__ dq) {
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sQ = smem;
  float* sDO = reinterpret_cast<float*>(sQ + rows_bytes<HD>(true));
  float* sK = sDO + rows_bytes<HD>(false) / 4;
  int* sK8 = reinterpret_cast<int*>(sK + rows_bytes<HD>(false) / 4);
  float* sV = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sK8) +
                                       rows_bytes<HD>(true));
  float* sDS = sV + rows_bytes<HD>(false) / 4;
  int* sKseg = reinterpret_cast<int*>(sDS + BQ * BK);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  load_tile8<HD, BQ>(reinterpret_cast<int*>(sQ), a.qq, b, q0, a.Sq, a.H, h);
  load_tile<HD, BQ>(sDO, a.dout, b, q0, a.Sq, a.H, h);
  int qseg[4];
  float fac[4], lse[4], delta[4], dqa[4][NC];
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    const size_t row = ((size_t)b * a.H + h) * a.Sq + min(r, a.Sq - 1);
    qseg[i] = seg_of<SEG>(a.q_seg, b, r, a.Sq);
    lse[i] = a.lse[row];
    delta[i] = a.delta[row];
    fac[i] = int8_factor(a, b, h, q0);
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < a.Sk; k0 += BK) {
    __syncthreads();
    load_tile<HD, BK>(sK, a.k, b, k0, a.Sk, a.H, h);
    load_tile8<HD, BK>(sK8, a.kq, b, k0, a.Sk, a.H, h);
    load_tile<HD, BK>(sV, a.v, b, k0, a.Sk, a.H, h);
    if (threadIdx.x < BK) sKseg[threadIdx.x] = seg_of<SEG>(a.kv_seg, b, k0 + threadIdx.x, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<HD, true>(sQ, sK8, ty, tx, fac, s);
    scores<HD, false>(sDO, sV, ty, tx, one, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j, ks = sKseg[kj];
        const float p = ks != 0 && ks == qseg[i] ? expf(s[i][j] - lse[i]) : 0.f;
        const float ds = __fmul_rn(__fmul_rn(p, dp[i][j] - delta[i]), a.scale);
        sDS[(4 * ty + i) * BK + kj] = ds;
      }
    __syncthreads();
    pv_tile<HD, BK>(sDS, sK, ty, tx, dqa);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= a.Sq) break;
    float* dst = dq + (((size_t)b * a.Sq + r) * a.H + h) * HD + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[16 * c] = dqa[i][c];
  }
}

// ---------------------------------------------------------------------------
// the fused f32 modes (K1 / K2): prep, quantization, rope + norm backward (D = 128)

// qn / kn of one (b, s, h) row a warp; delta where dout is not null (K2); the rows'
// largest |qn| / |kn| into amax where it is not null (the s_int8 mode)
__global__ void __launch_bounds__(PREP_WARPS * 32)
simt_nr_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ q_scale2, const float* __restrict__ k_scale2,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    long long cs_bstride, float* __restrict__ qn, float* __restrict__ kn,
                    const float* __restrict__ dout, const float* __restrict__ out,
                    float* __restrict__ delta, unsigned* __restrict__ amax, int q_rows, int rows,
                    int S, int H, int st) {
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
  if (dout) {
    const float4 d4 = *reinterpret_cast<const float4*>(dout + off);
    const float4 o4 = *reinterpret_cast<const float4*>(out + off);
    const float acc = warp_sum(d4.x * o4.x + d4.y * o4.y + d4.z * o4.z + d4.w * o4.w);
    if (lane == 0) delta[((size_t)b * H + h) * S + s] = acc;
  }
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

// ---------------------------------------------------------------------------
// host

template <typename K>
cudaError_t set_smem(bool& done, K kernel, int bytes) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int HD>
cudaError_t launch_fwd_int8(const Args& a, void* out, float* lse, int B, cudaStream_t st) {
  constexpr int smem = fwd_smem<HD>();
  static bool done[2] = {false, false};
  cudaError_t e = set_smem(done[0], simt_fwd_int8_kernel<HD, true>, smem);
  if (e == cudaSuccess) e = set_smem(done[1], simt_fwd_int8_kernel<HD, false>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  (a.q_seg ? simt_fwd_int8_kernel<HD, true> : simt_fwd_int8_kernel<HD, false>)<<<
      grid, THREADS, smem, st>>>(a, static_cast<float*>(out), lse);
  return cudaGetLastError();
}

// the s_int8 backward's dk / dv, then dq (the prep wrote delta)
template <int HD>
cudaError_t launch_bwd_int8(const Args& a, void* dq, void* dk, void* dv, int B, cudaStream_t st) {
  constexpr int kv_smem = dkv_smem<HD>(), q_smem = dq_smem<HD>();
  static bool done[4] = {false, false, false, false};
  cudaError_t e = set_smem(done[0], simt_dkv_kernel<HD, true>, kv_smem);
  if (e == cudaSuccess) e = set_smem(done[1], simt_dkv_kernel<HD, false>, kv_smem);
  if (e == cudaSuccess) e = set_smem(done[2], simt_dq_kernel<HD, true>, q_smem);
  if (e == cudaSuccess) e = set_smem(done[3], simt_dq_kernel<HD, false>, q_smem);
  if (e != cudaSuccess) return e;
  const bool seg = a.q_seg != nullptr;
  (seg ? simt_dkv_kernel<HD, true> : simt_dkv_kernel<HD, false>)<<<
      dim3((a.Sk + BK - 1) / BK, a.H, B), THREADS, kv_smem, st>>>(a, static_cast<float*>(dk),
                                                                  static_cast<float*>(dv));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  (seg ? simt_dq_kernel<HD, true> : simt_dq_kernel<HD, false>)<<<
      dim3((a.Sq + BQ - 1) / BQ, a.H, B), THREADS, q_smem, st>>>(a, static_cast<float*>(dq));
  return cudaGetLastError();
}

// the fused modes' prep (and the s_int8 quantization) on `stream`
cudaError_t launch_nr_prep(const float* q, const float* k, const float* qs, const float* ks,
                           const float* cos, const float* sin, long long cs_bstride, float* qn,
                           float* kn, const float* dout, const float* out, float* delta,
                           int8_t* qq, int8_t* kq, unsigned* amax, int q_rows, int B, int S,
                           int H, int st, cudaStream_t stream) {
  const int rows = B * S * H, blocks = (rows + PREP_WARPS - 1) / PREP_WARPS;
  if (q_rows) {
    const cudaError_t e = cudaMemsetAsync(
        amax, 0, (size_t)B * H * (1 + (S + q_rows - 1) / q_rows) * sizeof(unsigned), stream);
    if (e != cudaSuccess) return e;
  }
  simt_nr_prep_kernel<<<blocks, PREP_WARPS * 32, 0, stream>>>(
      q, k, qs, ks, cos, sin, cs_bstride, qn, kn, dout, out, delta, q_rows ? amax : nullptr,
      q_rows, rows, S, H, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !q_rows) return e;
  simt_nr_quant_kernel<<<blocks, PREP_WARPS * 32, 0, stream>>>(qn, kn, amax, qq, kq, q_rows,
                                                               rows, S, H);
  return cudaGetLastError();
}

}  // namespace simt
}  // namespace

extern "C" int qflux_simt_nr_rope_norm_bwd(const void* dqn, const void* dkn, const void* q,
                                           const void* k, const void* q_scale2,
                                           const void* k_scale2, const void* cos,
                                           const void* sin, long long cs_bstride, void* dq,
                                           void* dk, void* dqs_part, void* dks_part, int B, int S,
                                           int H, int st, void* stream);

// K1's s_int8 mode in f32 (D = 128): the prep (qn, kn: f32 [B, S, H, D] scratch; amax
// [B, H, 1 + ceil(S / q_rows)] u32 scratch; qq / kq int8 [B, S, H, D] scratch), then the
// forward over qq / kq / v.  q_rows > 0, a multiple of 64 (K1's plain f32 mode is
// flash_f32_fwd.cu's qflux_f32_nr_fwd).  Returns a cudaError_t.
extern "C" int qflux_simt_nr_fwd(const void* q, const void* k, const void* v,
                                 const void* q_scale2, const void* k_scale2, const void* cos,
                                 const void* sin, long long cs_bstride, const void* seg,
                                 void* qn, void* kn, void* qq, void* kq, void* amax, int q_rows,
                                 void* out, void* lse, int B, int S, int H, int st, float scale,
                                 void* stream) {
  if (q_rows <= 0 || q_rows % simt::BQ || !qn || !kn || !qq || !kq || !amax || B <= 0 ||
      S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  float* qnf = static_cast<float*>(qn);
  float* knf = static_cast<float*>(kn);
  cudaError_t e = simt::launch_nr_prep(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(q_scale2), static_cast<const float*>(k_scale2),
      static_cast<const float*>(cos), static_cast<const float*>(sin), cs_bstride, qnf, knf,
      nullptr, nullptr, nullptr, static_cast<int8_t*>(qq), static_cast<int8_t*>(kq),
      static_cast<unsigned*>(amax), q_rows, B, S, H, st, st_);
  if (e != cudaSuccess) return (int)e;
  const int* sg = static_cast<const int*>(seg);
  const simt::Args a{qnf, knf, v, static_cast<const int8_t*>(qq), static_cast<const int8_t*>(kq),
                     static_cast<const unsigned*>(amax), q_rows, sg, sg, nullptr, nullptr,
                     nullptr, S, S, H, scale};
  return (int)simt::launch_fwd_int8<D>(a, out, static_cast<float*>(lse), B, st_);
}

// The f32 modes' prep alone, as K1 runs it (flash_f32_fwd.cu's K1 runs it before its
// loop; tests and the smoke hold its qn / kn to the plain norm + rope and its qq / kq to
// `_quant_tile` of that qn / kn): qn, kn f32 [B, S, H, D]; at q_rows > 0 also amax and
// qq / kq int8.
// Returns a cudaError_t.
extern "C" int qflux_simt_nr_prep(const void* q, const void* k, const void* q_scale2,
                                  const void* k_scale2, const void* cos, const void* sin,
                                  long long cs_bstride, void* qn, void* kn, void* qq, void* kq,
                                  void* amax, int q_rows, int B, int S, int H, int st,
                                  void* stream) {
  if (q_rows < 0 || q_rows % simt::BQ || !qn || !kn || (q_rows && (!qq || !kq || !amax)) ||
      B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)simt::launch_nr_prep(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(q_scale2), static_cast<const float*>(k_scale2),
      static_cast<const float*>(cos), static_cast<const float*>(sin), cs_bstride,
      static_cast<float*>(qn), static_cast<float*>(kn), nullptr, nullptr, nullptr,
      static_cast<int8_t*>(qq), static_cast<int8_t*>(kq), static_cast<unsigned*>(amax), q_rows,
      B, S, H, st, static_cast<cudaStream_t>(stream));
}

// K2's s_int8 mode in f32 (D = 128): the prep (qn, kn, delta, amax, qq / kq), then dk /
// dv into dv and the f32 scratch dkn, dq into the f32 scratch dqn, the scores recomputed
// from qq / kq, then the rope + norm backward of dqn and dkn
// (qflux_simt_nr_rope_norm_bwd).  q_rows > 0, a multiple of 64 (K2's plain f32 mode is
// flash_f32_bwd.cu's qflux_f32_nr_bwd).  Returns a cudaError_t.
extern "C" int qflux_simt_nr_bwd(const void* q, const void* k, const void* v,
                                 const void* q_scale2, const void* k_scale2, const void* cos,
                                 const void* sin, long long cs_bstride, const void* seg,
                                 const void* out, const void* lse, const void* dout, void* qn,
                                 void* kn, void* delta, void* dqn, void* dkn, void* qq, void* kq,
                                 void* amax, int q_rows, void* dq, void* dk, void* dv,
                                 void* dqs_part, void* dks_part, int B, int S, int H, int st,
                                 float scale, void* stream) {
  if (q_rows <= 0 || q_rows % simt::BQ || !qn || !kn || !delta || !dqn || !dkn || !qq ||
      !kq || !amax || B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  float* qnf = static_cast<float*>(qn);
  float* knf = static_cast<float*>(kn);
  float* dl = static_cast<float*>(delta);
  cudaError_t e = simt::launch_nr_prep(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(q_scale2), static_cast<const float*>(k_scale2),
      static_cast<const float*>(cos), static_cast<const float*>(sin), cs_bstride, qnf, knf,
      static_cast<const float*>(dout), static_cast<const float*>(out), dl,
      static_cast<int8_t*>(qq), static_cast<int8_t*>(kq), static_cast<unsigned*>(amax), q_rows,
      B, S, H, st, st_);
  if (e != cudaSuccess) return (int)e;
  const int* sg = static_cast<const int*>(seg);
  const simt::Args a{qnf, knf, v, static_cast<const int8_t*>(qq), static_cast<const int8_t*>(kq),
                     static_cast<const unsigned*>(amax), q_rows, sg, sg,
                     static_cast<const float*>(lse), dl, dout, S, S, H, scale};
  e = simt::launch_bwd_int8<D>(a, dqn, dkn, dv, B, st_);
  if (e != cudaSuccess) return (int)e;
  return qflux_simt_nr_rope_norm_bwd(dqn, dkn, q, k, q_scale2, k_scale2, cos, sin, cs_bstride,
                                     dq, dk, dqs_part, dks_part, B, S, H, st, stream);
}

// The rope + norm backward of K2's f32 modes (D = 128) on `stream`, two passes: dq from
// dqn (the gradient w.r.t. the normed + roped q) and the raw q, dk from dkn and k, and
// the [B, H, n_tiles, 2, D] scale-gradient partials (n_tiles = ceil(S / 64), split at st)
// of each.  K2's s_int8 mode above and flash_f32_bwd.cu's qflux_f32_nr_bwd end with it.
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
