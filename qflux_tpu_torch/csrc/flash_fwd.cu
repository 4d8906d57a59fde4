// Plain bidirectional flash attention forward for Hopper: kernel K3 of the port.
//
// Replaces qflux_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU kernel K3,
// driven by _fwd, flash_attention and flash_fwd_with_lse).  Over q and k that are
// already normed and roped, it computes for every (b, h):
//
//   out = softmax(q k^T * scale + segment mask) v,   lse = logsumexp of the row
//
// with the TPU kernel's rounding: f32 scores, p rounded to bf16 unnormalised before
// the PV product, the sum divided by l at the end, and fully masked rows (segment 0,
// or no key of the same segment) writing 0 and lse = -1e30.  q_seg [B, Sq] and
// kv_seg [B, Sk] are separate (a ring hop's K/V come from another shard) and Sq may
// differ from Sk; both segment pointers null is the unmasked case, where every real
// token counts as segment 1.  The TPU kernel padded S to its blocks and gave the
// padding segment 0; here the ragged edge is masked by index instead: keys past Sk
// carry segment 0.
//
// What bounds it on an H100: 4 * B * H * Sq * Sk * D operations of QK^T and PV
// against (2 Sq + 2 Sk) * B * H * D bf16 of q, out, k and v: at the Qwen 832x576
// shape (B = 1, H = 24, S = 4000, D = 128) 197 GFLOP against 98 MB, some 2000 FLOP
// per byte, far above the card's ~295 bf16 FLOP/byte ridge.  So the kernel is
// compute-bound on the tensor cores, 0.199 ms at the 989 TFLOP/s peak.
//
// What the design does about that.  It is K1's tile loop (csrc/flash_nr_fwd.cu)
// without the norm + rope prologue: the products run on the tensor cores as mma.sync
// m16n8k16 (bf16 in, f32 accumulate) with ldmatrix operand loads, and everything of
// the softmax stays in registers (the FlashAttention-2 layout: each of the eight
// warps owns 16 of the block's 128 q rows and holds their q as A fragments, their
// scores, probabilities and output accumulator).  Shared memory carries the K and V
// tiles, double buffered, and with no prologue to compute the next tile is copied
// with cp.async while the current one is multiplied, so one barrier per tile orders
// both hand-overs.  K is tiled with an online softmax, so there is no one-K-block
// limit.  wgmma, TMA and warp specialisation are left for later work.
//
// q/out are [B, Sq, H, D] bf16 and k/v [B, Sk, H, D] bf16 (the projection layout:
// head h of row s at offset (s * H + h) * D, no transpose copies); lse is
// [B, H, Sq] f32.

#include "common.cuh"

namespace {

constexpr int D = 128;  // the only head dim the kernel takes
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BQ = 16 * NWARPS;  // q rows of a block: 16 per warp
constexpr int BK = 64;           // keys of a K/V tile
constexpr int LD = D + 8;  // bf16 row stride of the smem tiles: 16-byte rows, no bank conflicts
constexpr float NEG_INF = -1e30f;

constexpr size_t SMEM_BYTES = sizeof(bf16) * (BQ + 4 * BK) * LD  // q tile, 2 x (k, v) tiles
                              + sizeof(int) * 2 * BK;            // 2 x key segment ids

// 16 bytes global -> shared without a register round trip; valid = false writes
// zeros (src-size 0 reads nothing; src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows [row0, row0 + ROWS) of one head (row stride rs) into a bf16 smem tile
// with cp.async; rows past n become 0
template <int ROWS>
__device__ __forceinline__ void copy_tile(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int rs, int row0, int n) {
  constexpr int ITERS = ROWS * (D / 8) / NTHREADS;
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    const bool in = row < n;
    cp_async16(dst + r * LD + c, src + (in ? (size_t)row * rs + c : 0), in);
  }
}

// With the mma fragment layout (common.cuh) this thread owns rows g and g+8 of its
// warp's 16, two columns of each 8-column tile, and a row's four owners are lanes
// 4g .. 4g+3.
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + BQ * LD;                               // [2][BK][LD]
  bf16* Vb = Kb + 2 * BK * LD;                           // [2][BK][LD]
  int* segk = reinterpret_cast<int*>(Vb + 2 * BK * LD);  // [2][BK]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const bf16* qh = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kh = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vh = v + ((size_t)b * Sk * H + h) * D;
  const int* qsegb = q_seg ? q_seg + (size_t)b * Sq : nullptr;
  const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;
  const int wrow = warp * 16;

  // K/V tile k0 into buffer `buf` (cp.async), and its key segment ids; one validity
  // rule for every case: keys past Sk carry segment 0, and without segment ids every
  // real token is segment 1
  auto issue = [&](int buf, int k0) {
    copy_tile<BK>(Kb + buf * BK * LD, kh, rs, k0, Sk);
    copy_tile<BK>(Vb + buf * BK * LD, vh, rs, k0, Sk);
    if (tid < BK) {
      const int row = k0 + tid;
      segk[buf * BK + tid] = row < Sk ? (ksegb ? ksegb[row] : 1) : 0;
    }
  };

  copy_tile<BQ>(Qs, qh, rs, q0, Sq);
  issue(0, 0);
  cp_async_commit();

  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    segq[i] = row < Sq ? (qsegb ? qsegb[row] : 1) : 0;
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[D / 16][4];  // this warp's 16 q rows as A fragments, one per 16 channels

  int it = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < Sk; k0 += BK, ++it) {
    const int cur = it & 1;
    // tile `it` has landed for every thread, and every warp is done with the other
    // buffer (the previous tile), which the next copy overwrites
    cp_async_wait_all();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (wrow + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
    }
    if (k0 + BK < Sk) {
      issue(cur ^ 1, k0 + BK);
      cp_async_commit();
    }
    const bf16* Ks = Kb + cur * BK * LD;
    const bf16* Vs = Vb + cur * BK * LD;
    const int* sk_tile = segk + cur * BK;

    // scores of this warp's 16 rows against the 64 keys: s[n] is keys 8n .. 8n+7
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        // matrices: keys +0/+8 (lane / 16) x channels +0/+8 ((lane / 8) % 2)
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // online softmax; a masked score is exactly NEG_INF and gets p = 0 (a select, so
    // a fully masked row, whose every score equals the running max, stays at 0)
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sk = sk_tile[8 * n + 2 * t + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool ok = segq[i] != 0 && sk == segq[i];
          const float val = ok ? __fmul_rn(s[n][2 * i + e], scale) : NEG_INF;
          s[n][2 * i + e] = val;
          tmax[i] = fmaxf(tmax[i], val);
        }
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2;
        const float p = s[n][c] == NEG_INF ? 0.f : __expf(s[n][c] - m[i]);
        psum[i] += p;
        s[n][c] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = l[i] * alpha[i] + psum[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // out += p v: p (rounded to bf16) as A fragments straight from the score
    // accumulators; keys 16kk .. 16kk+15 are score tiles 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // transposed matrices: keys +0/+8 ((lane / 8) % 2) x channels +0/+8 (lane / 16)
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                          (lane / 16) * 8);
        mma_bf16(o[2 * dp], pf, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pf, vb[2], vb[3]);
      }
    }
  }

  // epilogue: normalise, round to bf16, and stage this warp's 16 rows in its own rows
  // of Qs (only this warp read them, at the first tile) for 16-byte coalesced stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  bf16* stage = Qs + wrow * LD;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * i) * LD + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
    }
  }
  __syncwarp();
  bf16* oh = out + ((size_t)b * Sq * H + h) * D;
#pragma unroll
  for (int j = 0; j < 16 * (D / 8) / 32; ++j) {
    const int idx = j * 32 + lane;
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = q0 + wrow + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(oh + (size_t)row * rs + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + g + 8 * i;
      if (row < Sq) lse[((size_t)b * H + h) * Sq + row] = m[i] + logf(l[i] == 0.f ? 1.f : l[i]);
    }
  }
}

}  // namespace

// Launch K3 on `stream`.  q_seg [B, Sq] / kv_seg [B, Sk] int32, or both null (the
// unmasked case).  Returns a cudaError_t (0 = launched).
extern "C" int qflux_flash_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                               const void* kv_seg, void* out, void* lse, int B, int Sq, int Sk,
                               int H, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, scale);
  return (int)cudaGetLastError();
}
