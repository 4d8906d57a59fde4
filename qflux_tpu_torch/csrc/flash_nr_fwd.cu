// Fused qk-RMSNorm + rotate-half RoPE + flash attention forward for Hopper.
//
// Replaces qflux_tpu/ops/flash_nr.py:_fwd_nr_kernel (the Pallas TPU kernel K1,
// driven by _fwd_nr and flash_attention_nr).  It computes, for every (b, h):
//
//   qn = bf16(rope(bf16(rmsnorm(q) * s_sel)))   (s_sel: row < st ? scale[0] : scale[1])
//   kn = the same for k
//   out = softmax(qn kn^T / sqrt(D) + segment mask) v,   lse = logsumexp of the row
//
// with the cast chain of the JAX forward reproduced exactly: f32 statistics,
// a bf16 round after the norm scale, rope in f32, a bf16 round after rope,
// f32 scores, p rounded to bf16 before the PV product, and fully masked rows
// (segment 0, or no key of the same segment) writing 0 and lse = -1e30.
//
// What bounds it on an H100: at the FLUX 512^2 shape (S = 2560, H = 24,
// D = 128) one call is 4 * S^2 * D * H = 80 GFLOP of QK^T and PV against
// about 47 MB of q/k/v, some 1700 FLOP per byte, far above the card's ~295
// bf16 FLOP/byte ridge: the kernel is compute-bound on the tensor cores.
//
// What the design does about that (the bf16 mode, flash_nr_fwd_bf16_kernel).
// The TPU kernel normed and roped all of K once per (b, h) in VMEM and
// reused it over a sequential q loop. GPU blocks run in parallel and in no
// order, so a prep launch (flash_nr_kn_kernel, one warp per row) norms and
// ropes k once per (b, h, row) into the bf16 scratch kn with K1's cast
// chain, and the main kernel streams kn, never k: an earlier design normed
// each 64-row K tile in every q-tile block that visited it, 20 times per row
// at S = 2560, through ~1.9 GB of k and f32 cos / sin reads a call. The main
// kernel's loop is the one K3 runs too (flash_fwd_hopper.cuh's attn_fwd_body,
// inlined into each kernel: here with q normed by the consumers, in K3 with
// q by TMA). It is warp specialised (384 threads, one block per SM; the Hopper
// machinery of hopper.cuh): a producer warp keeps a ring of two (kn, v)
// tiles of 128 keys in flight by TMA, two consumer warpgroups each own 64 q
// rows, normed and roped once in their prologue straight into the swizzled
// layout wgmma reads (q is read once per block, so a q scratch would only
// add its write and read), and run S = q kn^T as wgmma m64n128k16 from shared
// memory, the online softmax on the accumulator registers, and O += P V
// (m64n128k16) with P as the register A operand. Within a warpgroup, tile
// i's softmax runs while tile i - 1's P V is in the tensor cores; the two
// warpgroups interleave on the SM (an explicit ping-pong schedule of the two
// on named barriers, as FlashAttention-3 runs, was no faster in an A/B build
// on an H100 and is not kept). The tile is 128 keys because setmaxnreg gives
// the consumers 240 registers a thread (the 64 of the score accumulator, the
// 64 of O and P's 32 fit); held to 168 (see hopper.cuh's mbar_timeout) the
// kernel had to take 64-key tiles, which ran slower on an H100. The
// softmax is the kernel's other limit beside the products: it runs in log2
// units (one fused multiply-add and ex2.approx a score, hopper.cuh; the
// running max is kept in raw-score units, and lse converted at the end), and
// without segment ids (SEG = false) only a tile past S is masked, each a
// measured gain on an H100. K is tiled with an online softmax, so unlike the
// TPU kernel there is no one-K-block limit, and the ragged edge is masked by
// index (TMA zero-fills keys past S) instead of padded.
//
// The s_int8 mode (qflux_tpu/ops/flash_nr.py:209-225, config quantize.attention,
// flash_nr_fwd_int8_kernel: mma.sync, ldmatrix, double-buffered tiles, eight
// warps of 16 q rows) computes QK^T as int8 x int8 with one scale per q tile of q_rows rows and one per
// (b, h) for K, as the TPU kernel does.  A prep launch (flash_nr_common.cuh) norms and
// ropes K, reduces the scales' amaxes and writes the int8 K; the main kernel then
// streams int8 K tiles instead of norming K per tile, and its QK^T runs as
// mma.sync m16n8k32 s8 on half as many instructions.  The bound at S = 2304, H = 24:
// 32.6 G int8 operations at 1,979 TOP/s plus 32.6 GFLOP of PV at 989 TFLOP/s, 0.049 ms.
//
// q/k/v/out are [B, S, H, D] bf16 (the projection layout: head h of row s at
// offset (s * H + h) * D, no transpose copies), lse is [B, H, S] f32, scale
// pairs [2, D] f32, cos/sin [S, D] (batch stride 0) or [B, S, D] f32, and the
// optional segment ids [B, S] int32.

#include "flash_fwd_hopper.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BQ = 16 * NWARPS;  // q rows of a block: 16 per warp
constexpr int BK = 64;           // keys of a K/V tile
constexpr int LD = D + 8;  // bf16 row stride of the q/k/v tiles: 16-byte rows, no bank conflicts
constexpr int LD8 = D + 16;  // byte row stride of the int8 q/k tiles: 16-byte rows, no bank conflicts
constexpr float NEG_INF = -1e30f;

constexpr size_t SMEM_BYTES = sizeof(bf16) * (BQ + 4 * BK) * LD  // q tile, 2 x (k, v) tiles
                              + sizeof(int) * 2 * BK;            // 2 x key segment ids
// the s_int8 mode adds the int8 q tile; its two int8 k tiles take the place of the bf16 ones
constexpr size_t SMEM_BYTES_INT8 = SMEM_BYTES + BQ * LD8;
static_assert(2 * BK * LD8 <= sizeof(bf16) * 2 * BK * LD, "int8 k tiles");

// Norm + rope of the ROWS rows [row0, row0 + ROWS) of one head into a bf16
// smem tile (rows past S become 0).  Warp w takes rows [w, w + 1) * ROWS /
// NWARPS, loading four of them at a time; each lane holds 4 channels, so the
// rotate-half partner (channel c +- D/2) is 16 lanes away.  The loop's trip
// count is a compile-time constant: over warp-dependent bounds the same loop
// made the whole kernel 1.5x slower on an H100.  __fmul_rn and __fadd_rn keep
// nvcc from contracting the products into FMAs, which would round otherwise
// than the plain version.
template <int ROWS>
__device__ __forceinline__ void norm_rope_tile(const bf16* __restrict__ x, int row_stride,
                                               int row0, int S,
                                               const float* __restrict__ scale2,
                                               const float* __restrict__ cos,
                                               const float* __restrict__ sin, int st,
                                               bf16* __restrict__ dst) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = lane * 4;
  constexpr int PER_WARP = ROWS / NWARPS;
  constexpr int U = PER_WARP < 4 ? PER_WARP : 4;
#pragma unroll 1
  for (int i0 = 0; i0 < PER_WARP; i0 += U) {
    float xv[U][4], cv[U][4], sv[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = row0 + warp * PER_WARP + i0 + u;
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[u][j] = cv[u][j] = sv[u][j] = 0.f;
      if (row < S) {
        const uint2 raw = *reinterpret_cast<const uint2*>(x + (size_t)row * row_stride + c0);
        const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[u][j] = __bfloat162float(p[j]);
        const float4 c4 = *reinterpret_cast<const float4*>(cos + (size_t)row * D + c0);
        const float4 s4 = *reinterpret_cast<const float4*>(sin + (size_t)row * D + c0);
        cv[u][0] = c4.x; cv[u][1] = c4.y; cv[u][2] = c4.z; cv[u][3] = c4.w;
        sv[u][0] = s4.x; sv[u][1] = s4.y; sv[u][2] = s4.z; sv[u][3] = s4.w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = warp * PER_WARP + i0 + u;
      const int row = row0 + i;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ss += xv[u][j] * xv[u][j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float r = rsqrtf(ss / (float)D + EPS);
      const float* s = scale2 + (row < st ? 0 : D) + c0;
      float us[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) us[j] = bf16_round(__fmul_rn(__fmul_rn(xv[u][j], r), s[j]));
      __align__(8) bf16 y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float partner = __shfl_xor_sync(0xffffffffu, us[j], 16);
        const float rot = lane < 16 ? -partner : partner;
        y[j] = __float2bfloat16(__fadd_rn(__fmul_rn(us[j], cv[u][j]), __fmul_rn(rot, sv[u][j])));
      }
      *reinterpret_cast<uint2*>(dst + i * LD + c0) = *reinterpret_cast<const uint2*>(y);
    }
  }
}

// With the mma fragment layout (common.cuh) this thread owns rows g and g+8
// of its warp's 16, two columns of each 8-column tile, and a row's four
// owners are lanes 4g .. 4g+3.
//
// INT8 (the s_int8 mode): the prep (flash_nr_common.cuh) has written the int8 k
// `kq` ([B, S, H, D], one scale per (b, h)) and the largest |qn| of each q tile of
// `q_rows` rows into `amax`.  A block's 128 rows lie inside one such tile (tiles are
// 128 or 256 rows from row 0), so it quantizes its normed q with that tile's scale,
// streams int8 k tiles instead of norming and roping k, and takes the scores as
//   s = f32(qq kq^T) * ((q_scale * k_scale) * scale)
// with mma.sync m16n8k32 s8 x s8 -> s32 (exact: |sum| <= 127^2 * 128 < 2^24, so the
// f32 conversion is too).  From there on it is the bf16 path.
__global__ void __launch_bounds__(NTHREADS, 1)
flash_nr_fwd_int8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                         const float* __restrict__ q_scale2, const float* __restrict__ cos,
                         const float* __restrict__ sin, long long cs_bstride,
                         const int* __restrict__ seg, const int8_t* __restrict__ kq,
                         const unsigned* __restrict__ amax, int q_rows, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, int H, int st, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + BQ * LD;                               // [2][BK][LD]
  bf16* Vb = Kb + 2 * BK * LD;                           // [2][BK][LD]
  int* segk = reinterpret_cast<int*>(Vb + 2 * BK * LD);  // [2][BK]
  int8_t* K8 = reinterpret_cast<int8_t*>(Kb);            // [2][BK][LD8] over Kb
  int8_t* Q8 = reinterpret_cast<int8_t*>(segk + 2 * BK);  // [BQ][LD8]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_stride = H * D;
  const size_t head_off = ((size_t)b * S * H + h) * D;
  const float* cb = cos + (size_t)b * cs_bstride;
  const float* sb = sin + (size_t)b * cs_bstride;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wrow = warp * 16;

  // the int8 K tile k0 and the V tile into buffer `buf`, and the keys' segment
  // ids; one validity rule for every case: keys past S carry segment 0, and
  // without segment ids every real token is segment 1
  auto fill = [&](int buf, int k0) {
    constexpr int VITER = BK * (D / 8) / NTHREADS;
    uint4 vr[VITER];
#pragma unroll
    for (int j = 0; j < VITER; ++j) {  // v loads first: in flight during the k copy
      const int i = tid + j * NTHREADS;
      const int row = k0 + i / (D / 8), c = (i % (D / 8)) * 8;
      vr[j] = row < S ? *reinterpret_cast<const uint4*>(v + head_off + (size_t)row * row_stride + c)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    constexpr int KITER = BK * (D / 16) / NTHREADS;  // 16-byte chunks of the int8 tile
#pragma unroll
    for (int j = 0; j < KITER; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (D / 16), c = (i % (D / 16)) * 16;
      const int row = k0 + r;
      *reinterpret_cast<uint4*>(K8 + (buf * BK + r) * LD8 + c) =
          row < S ? *reinterpret_cast<const uint4*>(kq + head_off + (size_t)row * row_stride + c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < VITER; ++j) {
      const int i = tid + j * NTHREADS;
      *reinterpret_cast<uint4*>(Vb + buf * BK * LD + (i / (D / 8)) * LD + (i % (D / 8)) * 8) = vr[j];
    }
    if (tid < BK) {
      const int row = k0 + tid;
      segk[buf * BK + tid] = row < S ? (segb ? segb[row] : 1) : 0;
    }
  };

  norm_rope_tile<BQ>(q + head_off, row_stride, q0, S, q_scale2, cb, sb, st, Qs);
  fill(0, 0);
  // (q_scale * k_scale) * scale, in that order.  norm_rope_tile gave this warp
  // rows wrow .. wrow+15 and this lane their channels 4 lane .. 4 lane + 3: it
  // quantizes what it wrote itself
  const unsigned* am = amax + ((size_t)b * H + h) * (1 + (S + q_rows - 1) / q_rows);
  const float qsc = int8_scale(am[1 + q0 / q_rows]);
  const float factor = __fmul_rn(__fmul_rn(qsc, int8_scale(am[0])), scale);
#pragma unroll 4
  for (int r = 0; r < 16; ++r)
    quant4(Qs + (wrow + r) * LD + lane * 4, qsc, Q8 + (wrow + r) * LD8 + lane * 4);
  __syncthreads();

  // this warp's 16 normed q rows as int8 A fragments, one per 32-channel slice
  uint32_t qf[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int8_t* r0 = Q8 + (wrow + g) * LD8 + kk * 32 + 4 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD8);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD8 + 16);
  }

  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    segq[i] = row < S ? (segb ? segb[row] : 1) : 0;
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // double-buffered K/V: tile it + 1 is filled while no warp reads its buffer
  // any more, so one barrier per tile orders both hand-overs
  int it = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < S; k0 += BK, ++it) {
    const int cur = it & 1;
    const bf16* Vs = Vb + cur * BK * LD;
    const int* sk_tile = segk + cur * BK;

    // scores of this warp's 16 rows against the 64 keys: s[n] is keys 8n .. 8n+7
    float s[BK / 8][4];
    // B fragments straight from the [key][channel] int8 tile: keys are the
    // columns and each holds its channels contiguously, as .col wants
    const int8_t* K8s = K8 + cur * BK * LD8;
    int si[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int8_t* kr = K8s + (n * 8 + g) * LD8 + kk * 32 + 4 * t;
        mma_s8(si[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 16));
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = __int2float_rn(si[n][c]);

    // online softmax; a masked score is exactly NEG_INF and gets p = 0
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sk = sk_tile[8 * n + 2 * t + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool ok = segq[i] != 0 && sk == segq[i];
          const float val = ok ? __fmul_rn(s[n][2 * i + e], factor) : NEG_INF;
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
    // accumulators — keys 16kk .. 16kk+15 are score tiles 2kk and 2kk+1
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
    if (k0 + BK < S) fill(cur ^ 1, k0 + BK);
    __syncthreads();
  }

  // epilogue: normalise, round to bf16, and stage this warp's 16 rows in its
  // own rows of Qs (no other warp reads them) for 16-byte coalesced stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  bf16* stage = Qs + wrow * LD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * i) * LD + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16 * (D / 8) / 32; ++j) {
    const int idx = j * 32 + lane;
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = q0 + wrow + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + head_off + (size_t)row * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + g + 8 * i;
      if (row < S) lse[((size_t)b * H + h) * S + row] = m[i] + logf(l[i] == 0.f ? 1.f : l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 mode: a prep launch norms and ropes k once per (b, h, row) into the
// scratch kn, then the main kernel runs the warp-specialised wgmma loop that K1
// shares with K3 (flash_fwd_hopper.cuh) over a TMA ring of (kn, v) tiles, its q
// rows normed and roped by the consumers.

// kn = the normed and roped k, one warp per (b, s, h) row, with K1's cast chain
// (norm_rope_row, as the s_int8 prep)
__global__ void __launch_bounds__(PREP_WARPS * 32)
flash_nr_kn_kernel(const bf16* __restrict__ k, const float* __restrict__ k_scale2,
                   const float* __restrict__ cos, const float* __restrict__ sin,
                   long long cs_bstride, bf16* __restrict__ kn, int rows, int S, int H,
                   int st) {
  const int row = blockIdx.x * PREP_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  const int s = (row / H) % S, b = row / (H * S);
  const size_t off = (size_t)row * D;
  const size_t cs = (size_t)b * cs_bstride + (size_t)s * D;
  norm_rope_row(k + off, k_scale2 + (s < st ? 0 : D) + lane * 4, cos + cs, sin + cs, lane,
                kn + off);
}

// Block (q tile of 128 rows, h, b), 384 threads: fwd_wg::attn_fwd_body with the
// q rows normed and roped by the consumers and one [B, S] id array for q and
// keys (SEG: ids given).
template <bool SEG>
__global__ void __launch_bounds__(fwd_wg::THREADS, 1)
flash_nr_fwd_bf16_kernel(const __grid_constant__ CUtensorMap kn_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ fwd_wg::RawQ rq,
                         const int* __restrict__ seg, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, int H, float scale) {
  // kn_map stands in for the q map the body reads only when q arrives by TMA
  fwd_wg::attn_fwd_body<SEG, true>(kn_map, kn_map, v_map, rq, seg, seg, out, lse, S, S, H,
                                   scale);
}

cudaError_t launch_kn_prep(const bf16* k, const float* ks, const float* cs, const float* sn,
                           long long cs_bstride, bf16* kn, int B, int S, int H, int st,
                           cudaStream_t stream) {
  const int rows = B * S * H;
  flash_nr_kn_kernel<<<(rows + PREP_WARPS - 1) / PREP_WARPS, PREP_WARPS * 32, 0, stream>>>(
      k, ks, cs, sn, cs_bstride, kn, rows, S, H, st);
  return cudaGetLastError();
}

}  // namespace

// Launch K1 on `stream`.  kn: [B, S, H, D] bf16 scratch for the normed and roped
// k (both modes).  q_rows = 0: the bf16 mode, the kn prep then the wgmma kernel
// (kq, amax unused, may be null).  q_rows > 0 (a multiple of 128, the TPU
// forward's q quantization tile): the s_int8 mode, its prep (kn and the kq int8
// scratch, amax [B, H, 1 + ceil(S / q_rows)] u32 scratch) then its kernel.  All
// of q / k / v / kn / cos / sin 16-byte aligned.  Returns a cudaError_t (0 =
// launched).
extern "C" int qflux_flash_nr_fwd(const void* q, const void* k, const void* v,
                                  const void* q_scale2, const void* k_scale2,
                                  const void* cos, const void* sin, long long cs_bstride,
                                  const void* seg, void* kn, void* kq, void* amax, int q_rows,
                                  void* out, void* lse, int B, int S, int H, int st,
                                  float scale, void* stream) {
  if (q_rows < 0 || q_rows % BQ || !kn || B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const float* qs = static_cast<const float*>(q_scale2);
  const float* ks = static_cast<const float*>(k_scale2);
  const float* cs = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  bf16* knb = static_cast<bf16*>(kn);
  cudaError_t err;
  if (!q_rows) {
    CUtensorMap kn_map, v_map;
    if (!encode_heads(&kn_map, kn, B, S, H, fwd_wg::BK) ||
        !encode_heads(&v_map, v, B, S, H, fwd_wg::BK))
      return (int)cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      err = cudaFuncSetAttribute(flash_nr_fwd_bf16_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_wg::SMEM);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_nr_fwd_bf16_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_wg::SMEM);
      if (err != cudaSuccess) return (int)err;
      attr = true;
    }
    err = launch_kn_prep(kb, ks, cs, sn, cs_bstride, knb, B, S, H, st, st_);
    if (err != cudaSuccess) return (int)err;
    const fwd_wg::RawQ rq{qb, qs, cs, sn, cs_bstride, st};
    (seg ? flash_nr_fwd_bf16_kernel<true> : flash_nr_fwd_bf16_kernel<false>)<<<
        dim3((S + fwd_wg::BQ - 1) / fwd_wg::BQ, H, B), fwd_wg::THREADS, fwd_wg::SMEM, st_>>>(
        kn_map, v_map, rq, static_cast<const int*>(seg), static_cast<bf16*>(out),
        static_cast<float*>(lse), S, H, scale);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(flash_nr_fwd_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES_INT8);
  if (err != cudaSuccess) return (int)err;
  err = launch_int8_prep(qb, kb, nullptr, nullptr, qs, ks, cs, sn, cs_bstride, nullptr, knb,
                         nullptr, nullptr, static_cast<int8_t*>(kq), static_cast<unsigned*>(amax),
                         q_rows, B, S, H, st, st_);
  if (err != cudaSuccess) return (int)err;
  flash_nr_fwd_int8_kernel<<<dim3((S + BQ - 1) / BQ, H, B), NTHREADS, SMEM_BYTES_INT8, st_>>>(
      qb, static_cast<const bf16*>(v), qs, cs, sn, cs_bstride, static_cast<const int*>(seg),
      static_cast<const int8_t*>(kq), static_cast<const unsigned*>(amax), q_rows,
      static_cast<bf16*>(out), static_cast<float*>(lse), S, H, st, scale);
  return (int)cudaGetLastError();
}

// The bf16 mode's prep alone (kn from k), as qflux_flash_nr_fwd launches it: for
// timing the prep apart from the main kernel.  Returns a cudaError_t.
extern "C" int qflux_flash_nr_kn_prep(const void* k, const void* k_scale2, const void* cos,
                                      const void* sin, long long cs_bstride, void* kn, int B,
                                      int S, int H, int st, void* stream) {
  return (int)launch_kn_prep(static_cast<const bf16*>(k), static_cast<const float*>(k_scale2),
                             static_cast<const float*>(cos), static_cast<const float*>(sin),
                             cs_bstride, static_cast<bf16*>(kn), B, S, H, st,
                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* qflux_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
