// The f32 flash-attention forward on Hopper's tensor cores: kernels K3 and K1 of the
// port in their f32 modes, every product an f32-accurate 3xTF32 split.
//
// Replaces, in f32 (JAX's Pallas kernels compute in f32 and cast to the refs' dtype,
// and qflux_tpu/ops/flash_attention.py:542 takes any head dim):
//   * K3, qflux_tpu/ops/flash_attention.py:105 _fwd_kernel (pallas_call :183), at head
//     dim 32, 64 or 128: qflux_f32_fwd;
//   * K1, qflux_tpu/ops/flash_nr.py:192 _fwd_nr_kernel (pallas_call :276), at head dim
//     128 outside its s_int8 mode: qflux_f32_nr_fwd, which first runs
//     flash_simt.cu's prep (qflux_simt_nr_prep: RMSNorm with the scale row picked at
//     st and rotate-half rope of q and k into f32 scratch qn / kn), then this loop
//     over qn / kn / v;
//   * K1 in its s_int8 mode (the branch at flash_nr.py:209-225), at head dim 128:
//     qflux_f32_nr_int8_fwd, the same prep also quantizing qn per q tile and kn per
//     (b, h) into int8 qq / kq (`_quant_tile`), then this loop with int8 scores (I8,
//     below).
//
// The function is K3's (flash_fwd.cu says it in full): for every (b, h), out =
// softmax(q k^T * scale + segment mask) v and lse, with f32 scores, p kept in f32 for
// the P V product and the sum divided by l at the end; fully masked rows write 0 and
// lse = -1e30; separate q / kv ids, Sq != Sk; keys past Sk carry segment 0.
//
// Why a split.  A Hopper tensor core takes f32 only as TF32 (10 stored mantissa
// bits), about three digits: one TF32 product misses the f32 modes' accuracy
// (ops/layers.py require_f32) by some three orders.  Each f32 operand x is written
// x = hi + lo with hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi) (x -
// hi is exact in f32), and a b = hi_a hi_b + hi_a lo_b + lo_a hi_b, three TF32
// products into f32 accumulators: what is dropped (lo_a lo_b, lo's own rounding) is
// about 2^-21 of the product.  p is split the same way in registers before P V.
// The softmax stays f32 on the CUDA cores (log2 units: one FMA and ex2.approx a
// score, as the bf16 loop).
//
// Why wgmma.m64nNk8.tf32 (and not mma.sync.m16n8k8 or three bf16 pieces).  wgmma
// is the only way to the card's 495 TFLOP/s of dense TF32, so three products give
// 165 TFLOP/s of f32-accurate ones, 2.46x the 67 of FFMA; mma.sync (the sm80 form,
// which SDPA's f32 path runs) reaches a fraction of that on Hopper, and six bf16
// products per product cost as many instructions and more shared memory (three 2-byte
// pieces a value).  TF32 wgmma takes its shared-memory operands K-major only: S =
// q k^T fits as it is (q and k rows are d-contiguous), but O += P V contracts over
// the keys, so V must be transposed; and every split operand must sit in shared
// memory as hi and lo (B always comes from there).  So:
//   * the producer warpgroup (128 threads) does the splitting: k tiles arrive by TMA
//     and are split in place (hi over the raw tile, lo beside it, the same swizzled
//     offsets); v tiles arrive raw in a staging tile and are split into hi / lo
//     while transposed to [HD, BK] K-major tiles, the keys of each group of 8
//     permuted (below) so that P needs no shuffle;
//   * the consumers split their q rows once: hi back in place (an A operand from
//     shared memory), lo kept as register A fragments (the lo_q hi_k product);
//   * P V takes p from the score registers: the accumulator holds row g, keys 8 j + 2
//     t and 8 j + 2 t + 1, where the TF32 A fragment wants k indices t and t + 4, so
//     the transposed v tile stores key 8 j + 2 k at column 8 j + k and key 8 j + 2 k +
//     1 at column 8 j + 4 + k (a permutation of the contraction, so the sum is the
//     same), and p's hi / lo are the A fragments as they stand.
//
// What bounds it on an H100: the products, 4 * D * H operations an attending pair
// (QK^T and PV) at 495 / 3 TFLOP/s: at the Qwen 832x576 shape (B = 1, H = 24, S =
// 4000, D = 128) 1.94e11 operations, 1.176 ms; at FLUX's 512^2 (S = 2560) 0.480 ms.
// The exponentials (one an attending pair, 0.091 ms at the Qwen shape on the SFU)
// and the bytes ((2 Sq + 2 Sk) * B * H * D * 4, 197 MB, 0.059 ms) are far below.
// What holds the design below to about half of that bound at D = 128, by a count (not
// a measurement): a 64-key tile takes 6,650 clocks of tensor work an SM, while the
// wgmma operand reads (512 KB) and the producer's loads, splits and transposes (256
// KB) move ~768 KB of shared memory, ~6,000 clocks at 128 bytes a clock.
//
// What the design does about that: K3's bf16 block shape with f32 tiles.  Block (q
// tile of 128 rows, h, b), 384 threads: a producer warpgroup and two consumer
// warpgroups of 64 q rows, one block per SM.  BK = 64 keys a tile (an f32 [64, 128]
// tile is 32 KB; hi and lo of k and of the transposed v make a stage 128 KB at D =
// 128), so STAGES is 1 at D = 128 (the q tile 64 KB, the v staging tile 32 KB: 224
// KB in all), 2 at 64 and 4 at 32; k and v have their own full / empty barriers, so
// k tile i + 1 is split while tile i's softmax and P V run, and v tile i + 1 while
// tile i + 1's scores run.  Each consumer warpgroup runs per tile S = q k^T as three
// groups of HD / 8 wgmma m64n64k8 (hi hi and hi lo from shared memory, lo hi with lo_q
// from registers), waits, runs the online softmax on the 32 accumulator registers and
// splits p; then, 32 columns of O at a time, the three P V groups of eight wgmma
// m64n32k8 (A from registers, B the transposed tiles) into a fresh accumulator, which
// an FMA on the CUDA cores adds to O rescaled by alpha.  The two warpgroups' tensor
// work and softmaxes interleave; the registers (q's lo fragments HD / 2, O HD / 2, the
// scores 32, p's lo 32) leave no room at D = 128 to overlap a warpgroup's own softmax
// with its P V, as the bf16 loop does.
//
// The s_int8 mode (I8).  S = qq kq^T is exact in s32 (|sum| <= 127^2 128 < 2^21):
// four wgmma m64n64k32 s8 steps a tile from the int8 q tile (16 KB, loaded by TMA: the
// block's 128 rows lie in one of the prep's q tiles, which are multiples of 128 rows,
// so one factor) and int8 k tiles (8 KB, streamed by TMA), converted to f32 exactly
// (hopper.cuh's s32_to_f32).  The softmax takes the integer score in place of the raw
// one and the factor (q tile scale * k scale) * scale, IEEE products in that order, in
// place of the scale, as the bf16 K1's s_int8 loop (flash_fwd_hopper.cuh) folds it:
// p = ex2(s * factor * log2 e - m * factor * log2 e), lse = m * factor + log l.  P V
// stays 3xTF32 on the f32 v.  k needs no split and q no lo fragments, so the stage
// (8 KB of int8 k, 64 KB of v^T hi / lo) fits twice at D = 128 (192 KB with the q
// tile and the v staging tile), and the 64 registers q's lo fragments held take P V
// as one m64n128k8 a k8 step (a fresh accumulator of 64 registers over all of O's
// columns) in place of four m64n32k8 chunks, each waited for: the same sums, 2-3%
// faster (scripts/ablate_f32_int8_torch.py).
//
// Two choices the card forced (scripts/ablate_f32_flash_torch.py measures both):
//   * the tensor cores' f32 accumulation truncates, so P V accumulated in O across
//     the key tiles, as the bf16 loop does, drifts with the number of tiles (out
//     about 3e-5 from the plain version at Sk = 4000 against the f32 modes' 2e-5); a
//     fresh accumulator a tile, added to O in f32 on the CUDA cores, stays near 3e-6;
//   * P V at D = 64 as m64n64k8 from registers, the shape of S's lo_q hi_k product,
//     went wrong by ~1e-4 on every tile after the first; in m64n32k8 chunks it is
//     right, so P V runs 32 columns of O at a time at every head dim outside I8 (I8's
//     m64n128k8 is held to the plain version on the card like every instance).
// Tensor maps are 4-D over [B, S, H, D] f32 in [rows, 32] boxes (128 bytes, the
// 128-byte swizzle), so TMA zero-fills rows past Sq or Sk of each sample; every sum
// runs in a fixed order and nothing is atomic, so two calls give identical bits.
//
// Every f32 tile (q, k hi / lo, the v staging tile, the transposed v hi / lo) lies in
// the layout of flash_f32_common.cuh, which holds the split, the descriptors and the
// TF32 wgmma shapes this file shares with the f32 backward (flash_f32_bwd.cu).
//
// Layouts: q / out [B, Sq, H, D] and k / v [B, Sk, H, D] f32 (the projection layout),
// 16-byte aligned (TMA); lse [B, H, Sq] f32; ids [B, Sq] / [B, Sk] int32 or both null
// (every real token is segment 1).

#include "flash_f32_common.cuh"

namespace {
namespace f32fwd {

constexpr int BQ = 128;       // q rows of a block: 64 per consumer warpgroup
constexpr int BK = 64;        // keys of a k / v tile
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr float NEG_INF = -1e30f;

// I8: the s_int8 mode (int8 q and k tiles, the notes above), at D = 128 only
template <int HD, bool I8 = false>
struct Layout {
  static_assert(HD == 128 || HD == 64 || HD == 32, "head dims 32, 64 and 128");
  static_assert(!I8 || HD == 128, "the s_int8 mode is at D = 128");
  static constexpr int STAGES = I8 ? 2 : HD == 128 ? 1 : HD == 64 ? 2 : 4;
  static constexpr int QT = BQ * (I8 ? 128 : HD * 4);     // the q tile
  static constexpr int KT = BK * HD * 4;                   // one [BK, HD] or [HD, BK] tile
  static constexpr int KS = I8 ? BK * 128 : 2 * KT;       // a stage's k: int8, or hi and lo
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + QT;                 // STAGES x k
  static constexpr int V_OFF = K_OFF + STAGES * KS;        // STAGES x (v^T hi, v^T lo)
  static constexpr int RAW_OFF = V_OFF + STAGES * 2 * KT;  // the raw v tile
  static constexpr int SEG_OFF = RAW_OFF + KT;             // STAGES x BK key ids
  // full_k, full_v, empty_k, empty_v, k_raw (STAGES each), then v_raw and q
  static constexpr int BAR_OFF = SEG_OFF + STAGES * BK * 4;
  static constexpr int SMEM = BAR_OFF + (5 * STAGES + 2) * 8 + 1024;  // + slack to align
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// ---------------------------------------------------------------------------
// the P V operand layout

// the column of the transposed v tile that holds key `key` of the tile: within each
// group of 8, key 2 k at k and key 2 k + 1 at 4 + k (the notes above)
__device__ __forceinline__ int vt_col(int key) {
  return (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
}

// ---------------------------------------------------------------------------
// the kernel

// Block (q tile of 128 rows, h, b), 384 threads (SEG: ids given).  q_map over q [B,
// Sq, H, HD] in [BQ, 32] boxes, k_map / v_map over k / v [B, Sk, H, HD] in [BK, 32]
// boxes (I8: q_map / k_map over the int8 qq / kq [B, S, H, 128] in [BQ, 128] / [BK,
// 128] boxes, and amax [B, H, 1 + ceil(Sq / q_rows)], the prep's k slot and q tile
// slots, that the factor comes from); out [B, Sq, H, HD] f32, lse [B, H, Sq] f32.
template <int HD, bool SEG, bool I8>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, const unsigned* __restrict__ amax,
                     int q_rows, float* __restrict__ out, float* __restrict__ lse, int Sq,
                     int Sk, int H, float scale) {
  using L = Layout<HD, I8>;
  constexpr int STAGES = L::STAGES, KT = L::KT;
  // the columns of O a P V chunk covers (the notes above; I8: all of them)
  constexpr int PV_N = I8 ? HD : 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  uint64_t* raw_k = empty_v + STAGES;
  uint64_t* raw_v = raw_k + STAGES;
  uint64_t* full_q = raw_v + 1;
  int* segk = reinterpret_cast<int*>(smem + L::SEG_OFF);
  uint8_t* qs = smem + L::Q_OFF;
  uint8_t* vraw = smem + L::RAW_OFF;
  auto k_hi = [&](int s) { return smem + L::K_OFF + s * L::KS; };
  auto v_hi = [&](int s) { return smem + L::V_OFF + s * 2 * KT; };

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int ntiles = (Sk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // one arrival per consumer warp
      mbar_init(&empty_v[s], 8);
      mbar_init(&raw_k[s], 1);
    }
    mbar_init(raw_v, 1);
    mbar_init(full_q, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: loads, and splits every k and v tile
    setmaxnreg_dec<40>();
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(full_q, L::QT);
#pragma unroll
      for (int j = 0; j < (I8 ? 1 : HD / 32); ++j)
        tma_load_4d(qs + j * BQ * 128, &q_map, full_q, 32 * j, h, q0, b);
    }
    const int* ksegb = kv_seg ? kv_seg + (size_t)b * Sk : nullptr;
#pragma unroll 1
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES, k0 = i * BK;
      const uint32_t use = (i / STAGES) & 1, ph = use ^ 1;
      uint8_t* khi = k_hi(s);
      uint8_t* klo = khi + KT;
      uint8_t* vhi = v_hi(s);
      uint8_t* vlo = vhi + KT;
      // k tile i into its stage once tile i - STAGES's scores are in; the raw v tile
      // into the staging tile, which the last transposition freed
      if (i >= STAGES) mbar_wait(&empty_k[s], ph);
      if (tid == 0) {
        mbar_expect_tx(&raw_k[s], I8 ? L::KS : KT);
#pragma unroll
        for (int j = 0; j < (I8 ? 1 : HD / 32); ++j)
          tma_load_4d(khi + j * BK * 128, &k_map, &raw_k[s], 32 * j, h, k0, b);
        mbar_expect_tx(raw_v, KT);
#pragma unroll
        for (int j = 0; j < HD / 32; ++j)
          tma_load_4d(vraw + j * BK * 128, &v_map, raw_v, 32 * j, h, k0, b);
      }
      if (tid < BK) {
        const int key = k0 + tid;
        segk[s * BK + tid] = key < Sk ? (ksegb ? ksegb[key] : 1) : 0;
      }
      // split k in place: hi over the raw tile, lo at the same offsets beside it (I8:
      // the int8 tile as it arrived)
      mbar_wait(&raw_k[s], use);
      if constexpr (!I8) {
#pragma unroll 4
        for (int c = tid; c < KT / 16; c += 128) {
          float4 x = *reinterpret_cast<const float4*>(khi + 16 * c);
          uint4 hi, lo;
          split(x.x, hi.x, lo.x);
          split(x.y, hi.y, lo.y);
          split(x.z, hi.z, lo.z);
          split(x.w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(khi + 16 * c) = hi;
          *reinterpret_cast<uint4*>(klo + 16 * c) = lo;
        }
      }
      fence_proxy_async();
      named_bar_sync(6, 128);
      if (tid == 0) mbar_arrive(&full_k[s]);
      // split v while transposing it: thread `tid` takes keys tid % 64 and four
      // channels at a time (a warp's 32 keys and one channel a store: no conflicts)
      mbar_wait(raw_v, i & 1);
      if (i >= STAGES) mbar_wait(&empty_v[s], ph);
#pragma unroll 4
      for (int c = tid; c < KT / 16; c += 128) {
        const int key = c % BK, d0 = 4 * (c / BK), col = vt_col(key);
        const float4 x = *reinterpret_cast<const float4*>(vraw + f32_offset(BK, key, d0));
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi, lo;
          split(xv[e], hi, lo);
          const uint32_t off = f32_offset(HD, d0 + e, col);
          *reinterpret_cast<uint32_t*>(vhi + off) = hi;
          *reinterpret_cast<uint32_t*>(vlo + off) = lo;
        }
      }
      fence_proxy_async();
      named_bar_sync(6, 128);
      if (tid == 0) mbar_arrive(&full_v[s]);
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1, wt = threadIdx.x - 128 * wg;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * c + 16 * warp;  // this warp's first row of the q tile

  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    segq[i] = row < Sq ? (q_seg ? q_seg[(size_t)b * Sq + row] : 1) : 0;
  }

  // the scores' scale: I8, the int8 factor of the block's q tile and k (their
  // quantization scales times scale, in that order)
  float sscale = scale;
  if constexpr (I8) {
    const unsigned* am = amax + ((size_t)b * H + h) * (1 + (Sq + q_rows - 1) / q_rows);
    sscale = __fmul_rn(__fmul_rn(int8_scale(am[1 + q0 / q_rows]), int8_scale(am[0])), scale);
  }

  // the warpgroup's q rows split once: hi back in place, lo as A fragments (I8: the
  // int8 tile as it arrived)
  uint32_t qlo[I8 ? 1 : HD / 8][4];
  mbar_wait(full_q, 0);
  if constexpr (!I8) {
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = f32_offset(BQ, r0 + g + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1));
        uint32_t hi;
        split(*reinterpret_cast<const float*>(qs + off), hi, qlo[kk][e]);
        *reinterpret_cast<uint32_t*>(qs + off) = hi;
      }
    }
    fence_proxy_async();
    warpgroup_sync(c);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
  float sc[BK / 2];  // the scores, then p's hi; sc[4 j + 2 i + e] is row g + 8 i, key 8 j + 2 t + e
  uint32_t plo[BK / 8][4];
  const uint32_t qa = smem_u32(qs);
  const float sl2 = sscale * LOG2E;  // raw scores to log2 units

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const uint32_t use = (it / STAGES) & 1;
    const uint32_t kh = smem_u32(k_hi(s)), kl = kh + KT;
    const uint32_t vh = smem_u32(v_hi(s)), vl = vh + KT;

    // S = q_hi k_hi + q_hi k_lo + q_lo k_hi (I8: qq kq^T, exact in s32; si is declared
    // afresh for each tile, so its registers are free once converted)
    mbar_wait(&full_k[s], use);
    if constexpr (I8) {
      mbar_wait(&raw_k[s], use);  // the int8 tile's TMA, which the producer saw complete
      uint32_t si[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk)
        wgmma_s8<BK>(si, desc_kmajor8(qa, 64 * c, kk), desc_kmajor8(kh, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(si);
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) sc[x] = s32_to_f32(si[x]);
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk)
        wgmma_tf32_m64n64_ss(sc, desc_f32(qa, BQ, 64 * c, kk), desc_f32(kh, BK, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk)
        wgmma_tf32_m64n64_ss(sc, desc_f32(qa, BQ, 64 * c, kk), desc_f32(kl, BK, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk)
        wgmma_tf32_m64n64_rs(sc, qlo[kk], desc_f32(kh, BK, 0, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
    }

    // the online softmax: a masked score is exactly NEG_INF and gets p = 0
    const int* sk = segk + s * BK;
    float tmax[2] = {NEG_INF, NEG_INF};
    if (SEG || (it + 1) * BK > Sk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int skv = sk[8 * j + 2 * t + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool ok = segq[i] != 0 && skv == segq[i];
            const float val = ok ? sc[4 * j + 2 * i + e] : NEG_INF;
            sc[4 * j + 2 * i + e] = val;
            tmax[i] = fmaxf(tmax[i], val);
          }
        }
    } else {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) tmax[(x >> 1) & 1] = fmaxf(tmax[(x >> 1) & 1], sc[x]);
    }
    __syncwarp();  // the tile's ids are read and its k products done
    if (lane == 0) mbar_arrive(&empty_k[s]);
    float alpha[2], msc[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = ex2_approx((m[i] - m_new) * sl2);
      m[i] = m_new;
      msc[i] = m_new * sl2;
    }
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const int i = (x >> 1) & 1;
      const float p = sc[x] == NEG_INF ? 0.f : ex2_approx(fmaf(sc[x], sl2, -msc[i]));
      psum[i] += p;
      uint32_t hi;
      // p's A fragments: k index t is key 2 t of the group (sc[4 j], sc[4 j + 2]),
      // t + 4 key 2 t + 1 (sc[4 j + 1], sc[4 j + 3])
      split(p, hi, plo[x >> 2][((x & 1) << 1) | ((x >> 1) & 1)]);
      sc[x] = __uint_as_float(hi);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = l[i] * alpha[i] + psum[i];
    }

    // O = O alpha + p_hi v_hi + p_hi v_lo + p_lo v_hi, PV_N columns of O at a time: each
    // chunk's products into a fresh accumulator, added to O on the CUDA cores
    mbar_wait(&full_v[s], use);
    uint32_t phi[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      phi[kk][0] = __float_as_uint(sc[4 * kk]);
      phi[kk][1] = __float_as_uint(sc[4 * kk + 2]);
      phi[kk][2] = __float_as_uint(sc[4 * kk + 1]);
      phi[kk][3] = __float_as_uint(sc[4 * kk + 3]);
    }
#pragma unroll
    for (int ch = 0; ch < HD / PV_N; ++ch) {
      float pv[PV_N / 2];
      const uint32_t vhc = vh + ch * PV_N * 128, vlc = vl + ch * PV_N * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_rs<PV_N>(pv, phi[kk], desc_f32(vhc, HD, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_rs<PV_N>(pv, phi[kk], desc_f32(vlc, HD, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_rs<PV_N>(pv, plo[kk], desc_f32(vhc, HD, 0, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int x = 0; x < PV_N / 2; ++x)
        o[PV_N / 2 * ch + x] = fmaf(o[PV_N / 2 * ch + x], alpha[(x >> 1) & 1], pv[x]);
    }
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_v[s]);
  }

  // epilogue: the sum divided by l (a row with no key of its own segment: 0)
  const size_t head_off = ((size_t)b * Sq * H + h) * HD;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= Sq) continue;
    float* dst = out + head_off + (size_t)row * H * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    if (t == 0)
      lse[((size_t)b * H + h) * Sq + row] =
          m[i] == NEG_INF ? NEG_INF : m[i] * sscale + logf(l[i] == 0.f ? 1.f : l[i]);
  }
}

// ---------------------------------------------------------------------------
// host

// I8: q / k are the int8 qq / kq (the prep's, with amax and its q tile rows q_rows)
template <int HD, bool I8 = false>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_seg,
                   const int* kv_seg, float* out, float* lse, int B, int Sq, int Sk, int H,
                   float scale, cudaStream_t stream, const unsigned* amax = nullptr,
                   int q_rows = 0) {
  CUtensorMap q_map, k_map, v_map;
  const bool maps = I8 ? encode_heads8(&q_map, q, B, Sq, H, BQ) &&
                             encode_heads8(&k_map, k, B, Sk, H, BK)
                       : encode_heads_f32(&q_map, q, B, Sq, H, BQ, HD) &&
                             encode_heads_f32(&k_map, k, B, Sk, H, BK, HD);
  if (!maps || !encode_heads_f32(&v_map, v, B, Sk, H, BK, HD)) return cudaErrorInvalidValue;
  constexpr int SMEM = Layout<HD, I8>::SMEM;
  static bool attr[2] = {false, false};
  cudaError_t e = set_smem(attr[0], flash_f32_fwd_kernel<HD, true, I8>, SMEM);
  if (e == cudaSuccess) e = set_smem(attr[1], flash_f32_fwd_kernel<HD, false, I8>, SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  (q_seg ? flash_f32_fwd_kernel<HD, true, I8> : flash_f32_fwd_kernel<HD, false, I8>)<<<
      grid, THREADS, SMEM, stream>>>(q_map, k_map, v_map, q_seg, kv_seg, amax, q_rows, out, lse,
                                     Sq, Sk, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_by_dim(int HD, const void* q, const void* k, const void* v, const int* q_seg,
                          const int* kv_seg, float* out, float* lse, int B, int Sq, int Sk,
                          int H, float scale, cudaStream_t st) {
  switch (HD) {
    case 128: return launch<128>(q, k, v, q_seg, kv_seg, out, lse, B, Sq, Sk, H, scale, st);
    case 64: return launch<64>(q, k, v, q_seg, kv_seg, out, lse, B, Sq, Sk, H, scale, st);
    case 32: return launch<32>(q, k, v, q_seg, kv_seg, out, lse, B, Sq, Sk, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32fwd
}  // namespace

// flash_simt.cu's prep (the f32 norm + rope of q and k into qn / kn; the s_int8 mode's
// quantization into qq / kq and amax where q_rows > 0)
extern "C" int qflux_simt_nr_prep(const void* q, const void* k, const void* q_scale2,
                                  const void* k_scale2, const void* cos, const void* sin,
                                  long long cs_bstride, void* qn, void* kn, void* qq, void* kq,
                                  void* amax, int q_rows, int B, int S, int H, int st,
                                  void* stream);

// K3 in f32 on `stream` at head dim D (128, 64 or 32): out [B, Sq, H, D] f32, lse [B, H,
// Sq] f32.  q_seg [B, Sq] / kv_seg [B, Sk] int32, or both null (the unmasked case); q /
// k / v 16-byte aligned.  Returns a cudaError_t (cudaErrorInvalidValue also where a
// tensor map cannot be encoded or D is not taken).
extern "C" int qflux_f32_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                             const void* kv_seg, void* out, void* lse, int B, int Sq, int Sk,
                             int H, int D, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || (!q_seg != !kv_seg))
    return (int)cudaErrorInvalidValue;
  return (int)f32fwd::launch_by_dim(D, q, k, v, static_cast<const int*>(q_seg),
                                    static_cast<const int*>(kv_seg), static_cast<float*>(out),
                                    static_cast<float*>(lse), B, Sq, Sk, H, scale,
                                    static_cast<cudaStream_t>(stream));
}

// K1 in f32 (D = 128) outside its s_int8 mode on `stream`: flash_simt.cu's prep (qn, kn:
// f32 [B, S, H, 128] scratch, 16-byte aligned), then this loop over qn / kn / v with
// the one [B, S] id array (or null) for q and kv.  out [B, S, H, 128] f32, lse [B, H,
// S] f32.  Returns a cudaError_t.
extern "C" int qflux_f32_nr_fwd(const void* q, const void* k, const void* v,
                                const void* q_scale2, const void* k_scale2, const void* cos,
                                const void* sin, long long cs_bstride, const void* seg, void* qn,
                                void* kn, void* out, void* lse, int B, int S, int H, int st,
                                float scale, void* stream) {
  if (!qn || !kn || B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int e = qflux_simt_nr_prep(q, k, q_scale2, k_scale2, cos, sin, cs_bstride, qn, kn,
                                   nullptr, nullptr, nullptr, 0, B, S, H, st, stream);
  if (e != 0) return e;
  const int* sg = static_cast<const int*>(seg);
  return (int)f32fwd::launch<128>(qn, kn, v, sg, sg, static_cast<float*>(out),
                                  static_cast<float*>(lse), B, S, S, H, scale,
                                  static_cast<cudaStream_t>(stream));
}

// K1's s_int8 mode in f32 (D = 128) on `stream`: flash_simt.cu's prep (qn, kn: f32 [B, S,
// H, 128] scratch; qq / kq int8 [B, S, H, 128] scratch, q quantized in tiles of q_rows
// rows; amax [B, H, 1 + ceil(S / q_rows)] u32 scratch), then this loop over qq / kq / v
// (I8) with the one [B, S] id array (or null) for q and kv.  q_rows > 0, a multiple of
// 128 (a block's rows lie in one q tile).  out [B, S, H, 128] f32, lse [B, H, S] f32.
// Returns a cudaError_t.
extern "C" int qflux_f32_nr_int8_fwd(const void* q, const void* k, const void* v,
                                     const void* q_scale2, const void* k_scale2, const void* cos,
                                     const void* sin, long long cs_bstride, const void* seg,
                                     void* qn, void* kn, void* qq, void* kq, void* amax,
                                     int q_rows, void* out, void* lse, int B, int S, int H,
                                     int st, float scale, void* stream) {
  if (q_rows <= 0 || q_rows % f32fwd::BQ || !qn || !kn || !qq || !kq || !amax || B <= 0 ||
      S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const int e = qflux_simt_nr_prep(q, k, q_scale2, k_scale2, cos, sin, cs_bstride, qn, kn, qq,
                                   kq, amax, q_rows, B, S, H, st, stream);
  if (e != 0) return e;
  const int* sg = static_cast<const int*>(seg);
  return (int)f32fwd::launch<128, true>(qq, kq, v, sg, sg, static_cast<float*>(out),
                                        static_cast<float*>(lse), B, S, S, H, scale,
                                        static_cast<cudaStream_t>(stream),
                                        static_cast<const unsigned*>(amax), q_rows);
}
