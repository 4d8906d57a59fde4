// The f32 flash-attention backward on Hopper's tensor cores: kernels K4 and K2 of the
// port in their f32 modes, every product an f32-accurate 3xTF32 split.
//
// Replaces, in f32 (JAX's Pallas kernels compute in f32 and cast to the refs' dtype):
//   * K4, qflux_tpu/ops/flash_attention.py:288 _dqdkv_kernel (pallas_call :353), :215
//     _dq_kernel (:405) and :251 _dkv_kernel (:429), at head dim 32, 64 or 128:
//     qflux_f32_bwd;
//   * K2, qflux_tpu/ops/flash_nr.py:311 _bwd_nr_kernel (pallas_call :425), at head dim
//     128 outside its s_int8 mode: qflux_f32_nr_bwd, which runs flash_simt.cu's prep
//     (qflux_simt_nr_prep: qn / kn), delta, this file's loops over qn / kn into f32
//     dqn / dkn and dv, then flash_simt.cu's rope + norm backward
//     (qflux_simt_nr_rope_norm_bwd);
//   * K2 in its s_int8 mode (the branch at flash_nr.py:347-354), at head dim 128:
//     qflux_f32_nr_int8_bwd, the same prep also quantizing qn in the backward's q
//     tiles and kn per (b, h) into int8 qq / kq, delta, these loops with int8 scores
//     (I8, below), then the same rope + norm backward.
//
// The function is K4's (flash_bwd.cu says it in full), all in f32: delta = rowsum(do
// out); p = exp(q k^T scale - lse), 0 by a select where the pair is masked (so a fully
// masked row, lse = -1e30, gives zeros whatever do holds); dv = p^T do; ds = p (do v^T
// - delta) scale; dq = ds k; dk = ds^T q.  Separate q / kv ids, Sq != Sk; rows and
// keys past the tensor are zero-filled by TMA and carry segment 0.
//
// The split is flash_f32_fwd.cu's (flash_f32_common.cuh): hi_a hi_b + hi_a lo_b + lo_a
// hi_b, three TF32 wgmma products a product, f32 accumulators.
//
// Why this design (and not three bf16 pieces, or mma.sync).  TF32 wgmma takes its
// shared-memory operands K-major only, while the backward contracts each streamed
// tile (q and do in the dk / dv pass, k in the dq pass) once along the head dim (the
// scores) and once along its rows (the gradients).  The bf16 K4 reads such a tile
// MN-major the second time; in TF32 a second, transposed hi / lo copy would be needed,
// 256 KB a stage at D = 128 for 64-row q and do tiles, over the 227 KB of a block.
// Here every streamed tile lies once, as it arrives (hi over the raw tile, lo beside
// it), and its second use takes it as the A operand from registers, which wgmma
// accepts in any layout: a fragment is four loads from the hi tile and four from the
// lo tile, no conversion.  So every gradient product runs transposed, G^T = S^T E with
// M = the head dim, N = the block's own rows and K = the streamed rows, where E is
// the step's p or ds, written by the consumers into shared memory as their
// accumulators lie ([own rows, streamed rows], K-major, hi and lo).  Three bf16
// pieces (six bf16 products, 6 bytes a value) would have kept the bf16 loop's layouts,
// but a block's own k / v tiles alone would take 192 KB; mma.sync m16n8k8 (the sm80
// form, which SDPA's f32 path runs) loads fragments from any layout but reaches a
// fraction of wgmma's rate on Hopper.
//
// The block: OWN = 64 own rows of one (b, h) (keys in the dk / dv pass, q rows in the
// dq pass), 384 threads: a producer warpgroup and two consumer warpgroups.  The
// producer loads the two own tiles by TMA once (k and v, or q and do) and streams R
// rows a step of the other two (q and do, or k and v: R = 32 at D = 128 and in the D =
// 64 dk / dv pass, else 64; Layout says why), splitting each in place, with the step's
// lse (log2 units), delta and ids (or the keys' ids) in a row buffer.  Consumer
// warpgroup c splits own tile c once (hi back in place, lo as register A fragments, as
// the forward's q).  Per step:
//   1. scores: warpgroup 0 runs X = O1 S1^T (dk / dv: s^T = k q^T; dq: s = q k^T),
//      warpgroup 1 runs Y = O2 S2^T (dp^T = v do^T; dp = do v^T), each HD / 8 k8
//      steps of three wgmma m64nRk8 (hi hi and hi lo from shared memory, lo hi with the
//      own lo fragments);
//   2. exchange: each warpgroup stashes the half of its accumulator that the other
//      needs (columns by halves) in the exchange tiles, then computes p and ds for its
//      own half, p = 0 by select where masked, exp in log2 units (one FMA and ex2.approx
//      a score), and writes E hi / lo (dk / dv: p^T and ds^T; dq: ds);
//   3. gradients: warpgroup c runs its products G^T += S^T E (dk / dv: dv^T = do^T p^T
//      and dk^T = q^T ds^T, at D = 128 both over head-dim rows 64 c..; at 32 / 64
//      warpgroup 0 dv^T and 1 dk^T; dq: dq^T = k^T ds, at D = 128 over head-dim rows 64
//      c.., at 32 / 64 over own rows 32 c..; at D = 32 rows 32..63 of A are zero):
//      R / 8 k8 steps of three wgmma m64n{64,32}k8, A from registers.
// Three consumer barriers a step (the exchange tiles are free, stashed, written).
// The epilogue writes G^T transposed: a warp's store covers four rows of 32 bytes.
//
// Two choices the card forced (scripts/ablate_f32_bwd_torch.py measures both):
//   * the gradients sum over Sq / R (or Sk / R) steps, 125 at S = 4000; as the forward
//     found for P V, the tensor cores' f32 accumulation truncates (3e-5 from the plain
//     version there against 5e-6), so each step's products go into a fresh
//     accumulator that an FADD on the CUDA cores adds to the gradient (FRESH below);
//   * a TF32 wgmma with freshly loaded register A went wrong by ~3e-4 in some
//     instances, deterministically and with no ptxas note (the dk / dv pass at D = 64
//     with R = 64, the dq pass at D = 64 with R = 32; as the forward's P V at m64n64k8),
//     so R is picked per pass where each was right on the card.
//
// The s_int8 mode (I8, D = 128).  The scores are recomputed from int8 operands, s^T =
// kq qq^T (dk / dv) or s = qq kq^T (dq), four wgmma m64n32k32 s8 steps into s32
// (exact), times the factor (q tile scale * k scale) * scale (IEEE products in that
// order) inside the log2-unit exponent, as the bf16 K2's I8 path
// (flash_bwd_hopper.cuh); every other product stays 3xTF32 on the f32 qn / kn (the
// gradient is straight through the quantization, flash_nr.py:370-372).  So the own
// tile 1 (k, or q) lies as int8 (8 KB, no split), each stage streams the int8 rows (4
// KB) beside the f32 ones, and the dk / dv pass carries each step's factor in its row
// buffer (R divides the q tiles, multiples of 64 rows: one factor a step); a dq block's
// 64 rows lie in one q tile.
//   With int8 scores warpgroup 0's share of step 1 (four s8 wgmmas) would be a twelfth
// of warpgroup 1's (dp, 48 TF32 wgmmas), and it would idle at every barrier.  Each
// warpgroup instead runs the scores over all R rows and half of dp's contraction (head
// dims 64 c .. 64 c + 63: 24 TF32 wgmmas, own tile 2 split once in those columns, 32
// lo registers), and the exchange swaps dp's partial sums: warpgroup c stashes the
// other's R / 2 columns of its partial in one more [OWN, R] tile and adds the other's
// stash to its own columns (dp = x_0 + x_1 either way: IEEE addition commutes, so the
// bits do not depend on which warpgroup adds).  Running the scores in both warpgroups
// costs four s8 wgmmas a step (1/24 of the TF32 work) and buys three things: no
// exchange of s, no wgmma under a branch on the warpgroup (which ptxas serializes,
// C7518), and the same instruction stream in both.  (Splitting the streamed rows
// instead, s and dp over R / 2 columns each, is m64n16: its shared-memory operand A is
// read at twice the rate the tensor cores consume it, 256 B a clock against 128.)  The
// exchange tile is apart from the E tiles, so a step takes two consumer barriers
// (stashed; E written) instead of three.  The shared memory the int8 tiles free (24 KB
// at D = 128) holds that tile; a third stage would need 68 KB.
//   The step is bound by shared-memory traffic more than by its products (a count, not
// a measurement: ~476 KB a dk / dv step, ~3,700 clocks at 128 bytes a clock, against
// ~2,400 clocks of tensor work), so I8 also keeps two reads out of it, which leave
// every value as it was: S1 (q in dk / dv, k in dq), which only the gradient reads, as
// register A, stays raw (the producer splits S2 alone; the consumers split S1's
// fragments as they load them), and own tile 2's hi half sits in registers beside its
// lo, so dp's three products all take A from registers: K2 2-4% faster than with the
// producer splitting S1, and 5-6% faster than with dp's hi read from shared memory, at
// S = 2,304 / 2,560 (scripts/ablate_f32_int8_torch.py).
//
// What bounds it on an H100: the products, 10 D H operations an attending pair (five
// products) at 495 / 3 TFLOP/s: at the Qwen 832x576 shape (B = 1, S = 4000, H = 24, D
// = 128) 2.94 ms; at FLUX's 512^2 (S = 2560) 1.20 ms.  This split recomputes s and dp
// in the dq pass, seven products where the function needs five (no atomics, fixed
// summation order: two calls give identical bits), so it tops out near 5/7 of the
// bound; the three barriers a step and the exchange leave the tensor cores idle
// between a step's score and gradient products.  In I8 the score products run on the
// int8 rate (1,979 TOPS) and the bound at S = 2,304 is 0.79 ms (chip_smoke.py's
// _f32_bound); the loops still spend two barriers, the exchange and the softmax a step
// with the tensor cores idle.
//
// Layouts: q / out / do / dq [B, Sq, H, D] and k / v / dk / dv [B, Sk, H, D] f32,
// q / k / v / do 16-byte aligned (TMA); lse and delta [B, H, Sq] f32; ids [B, Sq] /
// [B, Sk] int32 or both null (every real token is segment 1).

#include "flash_f32_common.cuh"

namespace {
namespace f32bwd {

constexpr int OWN = 64;          // rows a block owns: keys (dk / dv) or q rows (dq)
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int SMEM_MAX = 232448;
constexpr int DELTA_WARPS = 8;
// each step's gradient products into a fresh accumulator added on the CUDA cores
// (true), or accumulated across the steps by the tensor cores (false)
constexpr bool FRESH = true;

// DQ: the dq pass (own q / do, streamed k / v), else the dk / dv pass (own k / v,
// streamed q / do).  Shared memory: the two own tiles, the exchange tiles (dk / dv:
// p^T hi, lo, ds^T hi, lo; dq: ds hi, lo), STAGES x (S1 hi, lo, S2 hi, lo), the rows
// (dk / dv: lse, delta, ids of the streamed q rows; dq: the streamed keys' ids), the
// barriers
// I8 (the s_int8 mode, D = 128): own tile 1 int8, STAGES x the streamed int8 tile
// after the f32 ones, the dp exchange tile after the E tiles, and (dk / dv) each step's
// factor after its ids.
template <int HD, bool DQ, bool I8 = false>
struct Layout {
  static_assert(HD == 128 || HD == 64 || HD == 32, "head dims 32, 64 and 128");
  static_assert(!I8 || HD == 128, "the s_int8 mode is at D = 128");
  // streamed rows a step: 32 at D = 128 (shared memory), 64 at D = 32 and in the dq pass
  // at D = 64; 32 in the dk / dv pass at D = 64, where 64 went wrong on the card
  // (scripts/ablate_f32_bwd_torch.py)
  static constexpr int R = HD == 128 || (HD == 64 && !DQ) ? 32 : 64;
  static constexpr int OT = OWN * HD * 4;        // an own [OWN, HD] tile
  static constexpr int OT1 = I8 ? OWN * 128 : OT;  // own tile 1 (int8 in I8)
  static constexpr int ST = R * HD * 4;          // a streamed [R, HD] tile
  static constexpr int ST8 = I8 ? R * 128 : 0;   // a streamed [R, 128] int8 tile
  static constexpr int ET = OWN * R * 4;         // an exchange [OWN, R] tile
  static constexpr int NE = DQ ? 2 : 4;
  static constexpr int NX = I8 ? 1 : 0;          // the dp exchange tile
  static constexpr int NROW = DQ ? 1 : I8 ? 4 : 3;
  static constexpr int bytes(int s) {
    return OT1 + OT + (NE + NX) * ET + s * (4 * ST + ST8 + NROW * R * 4) + (1 + 3 * s) * 8 +
           1024;
  }
  static constexpr int STAGES = bytes(4) <= SMEM_MAX ? 4 : bytes(3) <= SMEM_MAX ? 3 : 2;
  static constexpr int O2_OFF = OT1;
  static constexpr int E_OFF = OT1 + OT;
  static constexpr int S_OFF = E_OFF + (NE + NX) * ET;
  static constexpr int S8_OFF = S_OFF + STAGES * 4 * ST;
  static constexpr int ROW_OFF = S8_OFF + STAGES * ST8;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * NROW * R * 4;
  static constexpr int SMEM = bytes(STAGES);  // + slack to align to 1024
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
};

// the gradient products of consumer warpgroup c: NJ jobs, each G^T over head-dim rows
// dbase.. (64 of them) and own rows nbase.. (JN of them); prod 0: dv^T = do^T p^T
// (A = S2^T, B = exchange tiles 0 / 1), prod 1: dk^T = q^T ds^T or dq^T = k^T ds (A =
// S1^T, B = the last two exchange tiles)
template <int HD, bool DQ>
struct Jobs {
  static constexpr int NJ = !DQ && HD == 128 ? 2 : 1;
  static constexpr int JN = DQ && HD < 128 ? 32 : 64;
  static __device__ __forceinline__ int prod(int c, int j) { return DQ ? 1 : HD == 128 ? j : c; }
  static __device__ __forceinline__ int dbase(int c) { return HD == 128 ? 64 * c : 0; }
  static __device__ __forceinline__ int nbase(int c) { return DQ && HD < 128 ? 32 * c : 0; }
};

template <bool FIRST, class T>
__device__ __forceinline__ T& pick(T& a, T& b) {
  if constexpr (FIRST)
    return a;
  else
    return b;
}

// Block (own rows / OWN, h, b), 384 threads.  o1 / o2 maps in [OWN, 32] boxes, s1 / s2
// in [R, 32] boxes (dk / dv: k, v, q, do; dq: q, do, k, v).  I8: o1 over kq (dk / dv) or
// qq (dq) in [OWN, 128] boxes, s8 over the streamed qq or kq in [R, 128] boxes, and the
// prep's amax [B, H, 1 + ceil(Sq / q_rows)] (else s8 unused, amax null).  dk / dv
// writes g1 = dv, g2 = dk; dq writes g2 = dq.
template <int HD, bool DQ, bool I8>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_bwd_kernel(const __grid_constant__ CUtensorMap o1_map,
                     const __grid_constant__ CUtensorMap o2_map,
                     const __grid_constant__ CUtensorMap s1_map,
                     const __grid_constant__ CUtensorMap s2_map,
                     const __grid_constant__ CUtensorMap s8_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, const unsigned* __restrict__ amax,
                     int q_rows, float* __restrict__ g1, float* __restrict__ g2, int Sq, int Sk,
                     int H, float scale) {
  using L = Layout<HD, DQ, I8>;
  using J = Jobs<HD, DQ>;
  constexpr int R = L::R, STAGES = L::STAGES, OT = L::OT, ST = L::ST, ET = L::ET, NE = L::NE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* raw = own + 1;
  uint64_t* full = raw + STAGES;
  uint64_t* empty = full + STAGES;
  // stage s's tiles: 0 S1 hi, 1 S1 lo, 2 S2 hi, 3 S2 lo
  auto s_tile = [&](int s, int j) { return smem + L::S_OFF + (4 * s + j) * ST; };
  auto e_tile = [&](int j) { return smem + L::E_OFF + j * ET; };
  auto rows = [&](int s) { return reinterpret_cast<float*>(smem + L::ROW_OFF) + s * L::NROW * R; };
  auto s8_tile = [&](int s) { return smem + L::S8_OFF + s * L::ST8; };

  const int h = blockIdx.y, b = blockIdx.z, o0 = blockIdx.x * OWN;
  // I8: the int8 factor of q tile `row / q_rows` and k, (q_scale * k_scale) * scale
  auto factor = [&](int row) {
    const unsigned* am = amax + ((size_t)b * H + h) * (1 + (Sq + q_rows - 1) / q_rows);
    return __fmul_rn(__fmul_rn(int8_scale(am[1 + row / q_rows]), int8_scale(am[0])), scale);
  };
  const int s_own = DQ ? Sq : Sk, s_str = DQ ? Sk : Sq;
  const int nsteps = (s_str + R - 1) / R;

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&raw[s], 1);
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: the own tiles, then each step's streamed tiles split in place
    setmaxnreg_dec<40>();
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(own, L::OT1 + OT);
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) {
        if (!I8 || j == 0) tma_load_4d(smem + j * OWN * 128, &o1_map, own, 32 * j, h, o0, b);
        tma_load_4d(smem + L::O2_OFF + j * OWN * 128, &o2_map, own, 32 * j, h, o0, b);
      }
    }
    const float* lse_bh = lse + ((size_t)b * H + h) * Sq;
    const float* del_bh = delta + ((size_t)b * H + h) * Sq;
    const int* str_seg = DQ ? kv_seg : q_seg;
    const int* segb = str_seg ? str_seg + (size_t)b * s_str : nullptr;
#pragma unroll 1
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % STAGES, r0 = i * R;
      const uint32_t use = (i / STAGES) & 1;
      if (i >= STAGES) mbar_wait(&empty[s], use ^ 1);
      if (tid == 0) {
        mbar_expect_tx(&raw[s], 2 * ST + L::ST8);
#pragma unroll
        for (int j = 0; j < HD / 32; ++j) {
          tma_load_4d(s_tile(s, 0) + j * R * 128, &s1_map, &raw[s], 32 * j, h, r0, b);
          tma_load_4d(s_tile(s, 2) + j * R * 128, &s2_map, &raw[s], 32 * j, h, r0, b);
        }
        if constexpr (I8) tma_load_4d(s8_tile(s), &s8_map, &raw[s], 0, h, r0, b);
      }
      float* rw = rows(s);
      if (tid < R) {
        const int row = r0 + tid;
        const bool in = row < s_str;
        const int id = in ? (segb ? segb[row] : 1) : 0;
        if constexpr (DQ) {
          reinterpret_cast<int*>(rw)[tid] = id;
        } else {
          rw[tid] = in ? lse_bh[row] * LOG2E : 0.f;  // in log2 units
          rw[R + tid] = in ? del_bh[row] : 0.f;
          reinterpret_cast<int*>(rw)[2 * R + tid] = id;
          if (I8 && tid == 0) rw[3 * R] = factor(r0) * LOG2E;  // the step's, in log2 units
        }
      }
      mbar_wait(&raw[s], use);
      // (I8: S1 stays raw; the consumers split its A fragments as they load them)
#pragma unroll
      for (int j = I8 ? 1 : 0; j < 2; ++j) {
        uint8_t* hi = s_tile(s, 2 * j);
        uint8_t* lo = hi + ST;
#pragma unroll 4
        for (int c = tid; c < ST / 16; c += 128) {
          const float4 x = *reinterpret_cast<const float4*>(hi + 16 * c);
          uint4 xh, xl;
          split(x.x, xh.x, xl.x);
          split(x.y, xh.y, xl.y);
          split(x.z, xh.z, xl.z);
          split(x.w, xh.w, xl.w);
          *reinterpret_cast<uint4*>(hi + 16 * c) = xh;
          *reinterpret_cast<uint4*>(lo + 16 * c) = xl;
        }
      }
      fence_proxy_async();
      named_bar_sync(6, 128);
      if (tid == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1, wt = threadIdx.x - 128 * wg;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int rw0 = 16 * warp;  // this warp's first own row

  // the own rows' ids (and, in dq, their lse in log2 units and delta)
  int seg_r[2];
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
  const int* own_seg = DQ ? q_seg : kv_seg;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = o0 + rw0 + g + 8 * i;
    const bool in = row < s_own;
    seg_r[i] = in ? (own_seg ? own_seg[(size_t)b * s_own + row] : 1) : 0;
    if constexpr (DQ) {
      lse_r[i] = in ? lse[((size_t)b * H + h) * Sq + row] * LOG2E : 0.f;
      del_r[i] = in ? delta[((size_t)b * H + h) * Sq + row] : 0.f;
    }
  }

  // own tile c split once: hi back in place, lo as A fragments (I8: own tile 2, in this
  // warpgroup's half of the head dims, k8 steps kk0 .., hi and lo both as A fragments)
  constexpr int NKK = I8 ? HD / 16 : HD / 8;
  uint8_t* ot = smem + (I8 ? L::O2_OFF : c * OT);
  const int kk0 = I8 ? c * NKK : 0;
  uint32_t olo[NKK][4], ohi[I8 ? NKK : 1][4];
  mbar_wait(own, 0);
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off =
          f32_offset(OWN, rw0 + g + 8 * (e & 1), 8 * (kk0 + kk) + t + 4 * (e >> 1));
      uint32_t hi;
      split(*reinterpret_cast<const float*>(ot + off), hi, olo[kk][e]);
      if constexpr (I8)
        ohi[kk][e] = hi;
      else
        *reinterpret_cast<uint32_t*>(ot + off) = hi;
    }
  }
  if constexpr (!I8) {
    fence_proxy_async();
    warpgroup_sync(c);
  }

  constexpr int NJ = J::NJ, JN = J::JN;
  float gacc[NJ][JN / 2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < JN / 2; ++x) gacc[j][x] = 0.f;
  const float sl2 = scale * LOG2E;
  const uint32_t oh = smem_u32(ot);
  // I8 dq: the block's factor in log2 units (its rows lie in one q tile)
  float fl2 = 0.f;
  if constexpr (I8 && DQ) fl2 = factor(o0) * LOG2E;
  // the exchange tiles where warpgroup 0 stashes its half 1 (the scores) and
  // warpgroup 1 its half 0 (dp) for the other
  uint8_t* stash0 = e_tile(0);
  uint8_t* stash1 = e_tile(NE - 2);

#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % STAGES;
    const uint32_t use = (i / STAGES) & 1;
    const float* rw = rows(s);

    // 1. scores and dp: x[4 j + 2 i + e] is own row rw0 + g + 8 i, streamed row 8 j + 2 t +
    // e (I8: si the scores over all R streamed rows, as s32, and x this warpgroup's half
    // of dp's contraction; else x the scores in warpgroup 0 and dp in warpgroup 1)
    uint32_t si[I8 ? R / 2 : 1];
    float x[R / 2];
    {
      const uint32_t sh = smem_u32(s_tile(s, I8 ? 2 : 2 * c)), sl = sh + ST;
      mbar_wait(&full[s], use);
      if constexpr (I8) {
        const uint32_t s8 = smem_u32(s8_tile(s)), o1 = smem_u32(smem);
        mbar_wait(&raw[s], use);  // the int8 tile's TMA, which the producer saw complete
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk)
          wgmma_s8<R>(si, desc_kmajor8(o1, 0, kk), desc_kmajor8(s8, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < NKK; ++kk)
          wgmma_tf32_rs<R>(x, ohi[kk], desc_f32(sh, R, 0, kk0 + kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < NKK; ++kk)
          wgmma_tf32_rs<R>(x, ohi[kk], desc_f32(sl, R, 0, kk0 + kk), 1);
#pragma unroll
        for (int kk = 0; kk < NKK; ++kk)
          wgmma_tf32_rs<R>(x, olo[kk], desc_f32(sh, R, 0, kk0 + kk), 1);
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk)
          wgmma_tf32_ss<R>(x, desc_f32(oh, OWN, 0, kk), desc_f32(sh, R, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk)
          wgmma_tf32_ss<R>(x, desc_f32(oh, OWN, 0, kk), desc_f32(sl, R, 0, kk), 1);
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk)
          wgmma_tf32_rs<R>(x, olo[kk], desc_f32(sh, R, 0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (I8) fence_regs(si);
      fence_regs(x);
    }

    // 2. exchange: stash the half of x that the other warpgroup needs, then p and ds of
    // this warpgroup's half (I8 stashes apart from the E tiles, so the first barrier
    // goes: the stash itself waits for the other's last gradient products)
    if constexpr (!I8) consumers_sync();  // both warpgroups' last gradient products are done
    {
      uint8_t* mine = I8 ? e_tile(NE) : c == 0 ? stash0 : stash1;
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        if (j / (R / 16) == c) continue;  // (compile-time register indices: no j from c)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2)
          *reinterpret_cast<float2*>(mine + f32_offset(OWN, rw0 + g + 8 * i2, 8 * j + 2 * t)) =
              make_float2(x[4 * j + 2 * i2], x[4 * j + 2 * i2 + 1]);
      }
    }
    consumers_sync();
    {
      const uint8_t* other = I8 ? e_tile(NE) : c == 0 ? stash1 : stash0;
      const int* rseg = reinterpret_cast<const int*>(rw) + (DQ ? 0 : 2 * R);
      // the raw scores' scale in log2 units (I8: the int8 factor's)
      const float f2 = !I8 ? sl2 : DQ ? fl2 : rw[3 * R];
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        if (j / (R / 16) != c) continue;
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const uint32_t off = f32_offset(OWN, rw0 + g + 8 * i2, 8 * j + 2 * t);
          const float2 o = *reinterpret_cast<const float2*>(other + off);
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            const float mine = x[4 * j + 2 * i2 + e], oth = e ? o.y : o.x;
            float sv, dpv;
            if constexpr (I8) {
              sv = s32_to_f32(si[4 * j + 2 * i2 + e]);
              dpv = mine + oth;  // IEEE addition commutes: the same in both warpgroups
            } else {
              sv = c == 0 ? mine : oth;
              dpv = c == 0 ? oth : mine;
            }
            float ls, dl;
            bool ok;
            if constexpr (DQ) {
              ls = lse_r[i2];
              dl = del_r[i2];
              ok = seg_r[i2] != 0 && rseg[col] == seg_r[i2];
            } else {
              ls = rw[col];
              dl = rw[R + col];
              ok = rseg[col] != 0 && rseg[col] == seg_r[i2];
            }
            pv[e] = ok ? ex2_approx(fmaf(sv, f2, -ls)) : 0.f;
            dsv[e] = pv[e] * (dpv - dl) * scale;
          }
          uint2 h2, l2;
          split(dsv[0], h2.x, l2.x);
          split(dsv[1], h2.y, l2.y);
          *reinterpret_cast<uint2*>(e_tile(NE - 2) + off) = h2;
          *reinterpret_cast<uint2*>(e_tile(NE - 1) + off) = l2;
          if constexpr (!DQ) {
            split(pv[0], h2.x, l2.x);
            split(pv[1], h2.y, l2.y);
            *reinterpret_cast<uint2*>(e_tile(0) + off) = h2;
            *reinterpret_cast<uint2*>(e_tile(1) + off) = l2;
          }
        }
      }
    }
    fence_proxy_async();
    consumers_sync();

    // 3. gradients: G^T += S^T E, A from the streamed hi / lo tiles as they lie
#pragma unroll
    for (int jb = 0; jb < NJ; ++jb) {
      const int pr = J::prod(c, jb), dbase = J::dbase(c), nbase = J::nbase(c);
      const uint8_t* at = s_tile(s, pr == 0 ? 2 : 0);
      uint32_t ahi[R / 8][4], alo[R / 8][4];
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = dbase + rw0 + g + 8 * (e & 1);
          const uint32_t off = f32_offset(R, 8 * kk + t + 4 * (e >> 1), d);
          const bool in = HD >= 64 || d < HD;
          if (I8 && pr != 0) {  // the raw S1 tile
            split(*reinterpret_cast<const float*>(at + off), ahi[kk][e], alo[kk][e]);
          } else {
            ahi[kk][e] = in ? *reinterpret_cast<const uint32_t*>(at + off) : 0u;
            alo[kk][e] = in ? *reinterpret_cast<const uint32_t*>(at + ST + off) : 0u;
          }
        }
      const uint32_t eh = smem_u32(e_tile(pr == 0 ? 0 : NE - 2)), el = eh + ET;
      float fr[JN / 2];
      float(&acc)[JN / 2] = pick<FRESH>(fr, gacc[jb]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk)
        wgmma_tf32_rs<JN>(acc, ahi[kk], desc_f32(eh, OWN, nbase, kk), FRESH ? kk > 0 : 1);
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk)
        wgmma_tf32_rs<JN>(acc, ahi[kk], desc_f32(el, OWN, nbase, kk), 1);
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk)
        wgmma_tf32_rs<JN>(acc, alo[kk], desc_f32(eh, OWN, nbase, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // the A fragments stay live (unmoved) until the products that read them are done,
      // so that no register of theirs is reused while a wgmma may still read it
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk) {
        fence_regs(ahi[kk]);
        fence_regs(alo[kk]);
      }
      if constexpr (FRESH) {
#pragma unroll
        for (int x2 = 0; x2 < JN / 2; ++x2) gacc[jb][x2] += fr[x2];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: G^T element (head-dim row dbase + rw0 + g + 8 i, own row nbase + 8 j + 2 t +
  // e) to [b, o0 + own row, h, head-dim row]
#pragma unroll
  for (int jb = 0; jb < NJ; ++jb) {
    float* gout = J::prod(c, jb) == 0 ? g1 : g2;
    const int dbase = J::dbase(c), nbase = J::nbase(c);
#pragma unroll
    for (int x2 = 0; x2 < JN / 2; ++x2) {
      const int d = dbase + rw0 + g + 8 * ((x2 >> 1) & 1);
      const int row = o0 + nbase + 8 * (x2 >> 2) + 2 * t + (x2 & 1);
      if (d < HD && row < s_own) gout[(((size_t)b * s_own + row) * H + h) * HD + d] = gacc[jb][x2];
    }
  }
}

// delta[b, h, s] = sum over d of do * out, in f32; one warp per (b, s, h) row
template <int HD>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
flash_f32_delta_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  const int row = blockIdx.x * DELTA_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc += dout[(size_t)row * HD + d] * out[(size_t)row * HD + d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
  if (lane == 0) delta[((size_t)b * H + h) * Sq + s] = acc;
}

// ---------------------------------------------------------------------------
// host

template <int HD>
cudaError_t launch_delta(const float* dout, const float* out, float* delta, int B, int Sq, int H,
                         cudaStream_t st) {
  const int rows = B * Sq * H;
  flash_f32_delta_kernel<HD><<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0, st>>>(
      dout, out, delta, rows, Sq, H);
  return cudaGetLastError();
}

// the dk / dv pass, then the dq pass, from q / k / v / do and lse, delta; I8: the
// scores from the int8 qq / kq (the prep's, with amax and its q tile rows q_rows)
template <int HD, bool I8 = false>
cudaError_t launch_loops(const void* q, const void* k, const void* v, const void* dout,
                         const int* qs, const int* ks, const float* lse, const float* delta,
                         float* dq, float* dk, float* dv, int B, int Sq, int Sk, int H,
                         float scale, cudaStream_t st, const void* qq = nullptr,
                         const void* kq = nullptr, const unsigned* amax = nullptr,
                         int q_rows = 0) {
  using LK = Layout<HD, false, I8>;
  using LQ = Layout<HD, true, I8>;
  CUtensorMap k_own, v_own, q_str, do_str, q_own, do_own, k_str, v_str, q8_str, k8_str;
  if (!(I8 ? encode_heads8(&k_own, kq, B, Sk, H, OWN)
           : encode_heads_f32(&k_own, k, B, Sk, H, OWN, HD)) ||
      !encode_heads_f32(&v_own, v, B, Sk, H, OWN, HD) ||
      !encode_heads_f32(&q_str, q, B, Sq, H, LK::R, HD) ||
      !encode_heads_f32(&do_str, dout, B, Sq, H, LK::R, HD) ||
      !(I8 ? encode_heads8(&q_own, qq, B, Sq, H, OWN)
           : encode_heads_f32(&q_own, q, B, Sq, H, OWN, HD)) ||
      !encode_heads_f32(&do_own, dout, B, Sq, H, OWN, HD) ||
      !encode_heads_f32(&k_str, k, B, Sk, H, LQ::R, HD) ||
      !encode_heads_f32(&v_str, v, B, Sk, H, LQ::R, HD))
    return cudaErrorInvalidValue;
  if constexpr (I8) {
    if (!encode_heads8(&q8_str, qq, B, Sq, H, LK::R) ||
        !encode_heads8(&k8_str, kq, B, Sk, H, LQ::R))
      return cudaErrorInvalidValue;
  } else {
    q8_str = q_str;  // unused
    k8_str = k_str;
  }
  static bool attr[2] = {false, false};
  cudaError_t e = set_smem(attr[0], flash_f32_bwd_kernel<HD, false, I8>, LK::SMEM);
  if (e == cudaSuccess) e = set_smem(attr[1], flash_f32_bwd_kernel<HD, true, I8>, LQ::SMEM);
  if (e != cudaSuccess) return e;
  flash_f32_bwd_kernel<HD, false, I8><<<dim3((Sk + OWN - 1) / OWN, H, B), THREADS, LK::SMEM,
                                        st>>>(k_own, v_own, q_str, do_str, q8_str, lse, delta,
                                              qs, ks, amax, q_rows, dv, dk, Sq, Sk, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_f32_bwd_kernel<HD, true, I8><<<dim3((Sq + OWN - 1) / OWN, H, B), THREADS, LQ::SMEM,
                                       st>>>(q_own, do_own, k_str, v_str, k8_str, lse, delta,
                                             qs, ks, amax, q_rows, nullptr, dq, Sq, Sk, H,
                                             scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qs, const int* ks,
                   const float* out, const float* lse, const float* dout, float* delta,
                   float* dq, float* dk, float* dv, int B, int Sq, int Sk, int H, float scale,
                   cudaStream_t st) {
  const cudaError_t e = launch_delta<HD>(dout, out, delta, B, Sq, H, st);
  if (e != cudaSuccess) return e;
  return launch_loops<HD>(q, k, v, dout, qs, ks, lse, delta, dq, dk, dv, B, Sq, Sk, H, scale, st);
}

}  // namespace f32bwd
}  // namespace

// flash_simt.cu's prep (the f32 norm + rope of q and k into qn / kn; the s_int8 mode's
// quantization into qq / kq and amax where q_rows > 0) and its rope + norm backward (dq
// / dk of the raw projections and the scale-gradient partials)
extern "C" int qflux_simt_nr_prep(const void* q, const void* k, const void* q_scale2,
                                  const void* k_scale2, const void* cos, const void* sin,
                                  long long cs_bstride, void* qn, void* kn, void* qq, void* kq,
                                  void* amax, int q_rows, int B, int S, int H, int st,
                                  void* stream);
extern "C" int qflux_simt_nr_rope_norm_bwd(const void* dqn, const void* dkn, const void* q,
                                           const void* k, const void* q_scale2,
                                           const void* k_scale2, const void* cos,
                                           const void* sin, long long cs_bstride, void* dq,
                                           void* dk, void* dqs_part, void* dks_part, int B, int S,
                                           int H, int st, void* stream);

// K4 in f32 on `stream` at head dim D (128, 64 or 32): delta (f32 [B, H, Sq] scratch),
// then dk / dv, then dq, all f32.  q_seg [B, Sq] / kv_seg [B, Sk] int32, or both null;
// q / k / v / do 16-byte aligned.  Returns a cudaError_t (cudaErrorInvalidValue also
// where a tensor map cannot be encoded or D is not taken).
extern "C" int qflux_f32_bwd(const void* q, const void* k, const void* v, const void* q_seg,
                             const void* kv_seg, const void* out, const void* lse,
                             const void* dout, void* delta, void* dq, void* dk, void* dv, int B,
                             int Sq, int Sk, int H, int D, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || !delta || (!q_seg != !kv_seg))
    return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  const float* o = static_cast<const float*>(out);
  const float* ls = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dout);
  float* dl = static_cast<float*>(delta);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return (int)f32bwd::launch<128>(q, k, v, qs, ks, o, ls, d, dl, gq, gk, gv, B, Sq, Sk, H,
                                      scale, st);
    case 64:
      return (int)f32bwd::launch<64>(q, k, v, qs, ks, o, ls, d, dl, gq, gk, gv, B, Sq, Sk, H,
                                     scale, st);
    case 32:
      return (int)f32bwd::launch<32>(q, k, v, qs, ks, o, ls, d, dl, gq, gk, gv, B, Sq, Sk, H,
                                     scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2 in f32 (D = 128) outside its s_int8 mode on `stream`: flash_simt.cu's prep (qn, kn:
// f32 [B, S, H, 128] scratch), delta (f32 [B, H, S] scratch), this file's loops over
// qn / kn / v into the f32 scratch dqn / dkn and dv, then flash_simt.cu's rope + norm
// backward of dqn / dkn into dq / dk and the [B, H, n_tiles, 2, D] scale-gradient
// partials (n_tiles = qflux_flash_nr_bwd_tiles(S)).  The one [B, S] id array (or null)
// serves q and kv.  Returns a cudaError_t.
extern "C" int qflux_f32_nr_bwd(const void* q, const void* k, const void* v,
                                const void* q_scale2, const void* k_scale2, const void* cos,
                                const void* sin, long long cs_bstride, const void* seg,
                                const void* out, const void* lse, const void* dout, void* qn,
                                void* kn, void* delta, void* dqn, void* dkn, void* dq, void* dk,
                                void* dv, void* dqs_part, void* dks_part, int B, int S, int H,
                                int st, float scale, void* stream) {
  if (!qn || !kn || !delta || !dqn || !dkn || B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  int e = qflux_simt_nr_prep(q, k, q_scale2, k_scale2, cos, sin, cs_bstride, qn, kn, nullptr,
                             nullptr, nullptr, 0, B, S, H, st, stream);
  if (e != 0) return e;
  const int* sg = static_cast<const int*>(seg);
  float* dl = static_cast<float*>(delta);
  e = (int)f32bwd::launch<128>(qn, kn, v, sg, sg, static_cast<const float*>(out),
                               static_cast<const float*>(lse), static_cast<const float*>(dout),
                               dl, static_cast<float*>(dqn), static_cast<float*>(dkn),
                               static_cast<float*>(dv), B, S, S, H, scale, st_);
  if (e != 0) return e;
  return qflux_simt_nr_rope_norm_bwd(dqn, dkn, q, k, q_scale2, k_scale2, cos, sin, cs_bstride,
                                     dq, dk, dqs_part, dks_part, B, S, H, st, stream);
}

// K2's s_int8 mode in f32 (D = 128) on `stream`: flash_simt.cu's prep (qn, kn f32 [B, S,
// H, 128] scratch; qq / kq int8 [B, S, H, 128] scratch, q quantized in the backward's
// tiles of q_rows rows; amax [B, H, 1 + ceil(S / q_rows)] u32 scratch), delta (f32 [B,
// H, S] scratch), this file's loops with the scores from qq / kq (I8) into the f32
// scratch dqn / dkn and dv, then flash_simt.cu's rope + norm backward of dqn / dkn into
// dq / dk and the [B, H, n_tiles, 2, D] scale-gradient partials, as qflux_f32_nr_bwd.
// q_rows > 0, a multiple of 64 (a dq block's rows lie in one q tile).  Returns a
// cudaError_t.
extern "C" int qflux_f32_nr_int8_bwd(const void* q, const void* k, const void* v,
                                     const void* q_scale2, const void* k_scale2, const void* cos,
                                     const void* sin, long long cs_bstride, const void* seg,
                                     const void* out, const void* lse, const void* dout,
                                     void* qn, void* kn, void* delta, void* dqn, void* dkn,
                                     void* qq, void* kq, void* amax, int q_rows, void* dq,
                                     void* dk, void* dv, void* dqs_part, void* dks_part, int B,
                                     int S, int H, int st, float scale, void* stream) {
  if (q_rows <= 0 || q_rows % f32bwd::OWN || !qn || !kn || !delta || !dqn || !dkn || !qq ||
      !kq || !amax || B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  int e = qflux_simt_nr_prep(q, k, q_scale2, k_scale2, cos, sin, cs_bstride, qn, kn, qq, kq,
                             amax, q_rows, B, S, H, st, stream);
  if (e != 0) return e;
  float* dl = static_cast<float*>(delta);
  const float* o = static_cast<const float*>(out);
  const float* d = static_cast<const float*>(dout);
  e = (int)f32bwd::launch_delta<128>(d, o, dl, B, S, H, st_);
  if (e != 0) return e;
  const int* sg = static_cast<const int*>(seg);
  e = (int)f32bwd::launch_loops<128, true>(
      qn, kn, v, dout, sg, sg, static_cast<const float*>(lse), dl, static_cast<float*>(dqn),
      static_cast<float*>(dkn), static_cast<float*>(dv), B, S, S, H, scale, st_, qq, kq,
      static_cast<const unsigned*>(amax), q_rows);
  if (e != 0) return e;
  return qflux_simt_nr_rope_norm_bwd(dqn, dkn, q, k, q_scale2, k_scale2, cos, sin, cs_bstride,
                                     dq, dk, dqs_part, dks_part, B, S, H, st, stream);
}
