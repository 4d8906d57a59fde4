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
// The s_int8 mode (qflux_tpu/ops/flash_nr.py:209-225, config quantize.attention)
// computes QK^T as int8 x int8 with one scale per q tile of q_rows rows and one
// per (b, h) for K, as the TPU kernel does.  A prep launch (flash_nr_common.cuh)
// norms and ropes K, reduces the scales' amaxes and writes the int8 K (kq); the
// main kernel, flash_nr_fwd_int8_kernel, is the same wgmma loop with its INT8
// path: the consumers quantize their normed q rows with their tile's scale into
// an int8 tile, the producer streams 128-key kq tiles (16 KB a stage) in place
// of kn, and S is wgmma m64n128k32 s8 products into s32 accumulators, exact in
// f32, scaled by the int8 factor inside the log2-unit softmax.  The bound at
// S = 2304, H = 24: 32.6 G int8 operations at 1,979 TOP/s plus 32.6 GFLOP of PV
// at 989 TFLOP/s, 0.049 ms: QK^T at twice the bf16 rate, P V and the softmax
// unchanged.
//
// q/k/v/out are [B, S, H, D] bf16 (the projection layout: head h of row s at
// offset (s * H + h) * D, no transpose copies), lse is [B, H, S] f32, scale
// pairs [2, D] f32, cos/sin [S, D] (batch stride 0) or [B, S, D] f32, and the
// optional segment ids [B, S] int32.

#include "flash_fwd_hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The bf16 mode: a prep launch norms and ropes k once per (b, h, row) into the
// scratch kn, then the main kernel runs the warp-specialised wgmma loop that K1
// shares with K3 (flash_fwd_hopper.cuh) over a TMA ring of (kn, v) tiles, its q
// rows normed and roped by the consumers.

// kn = the normed and roped k, one warp per (b, s, h) row, with K1's cast chain
// (norm_rope_row: the arithmetic of the s_int8 prep, norm_rope4_in)
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

// The s_int8 mode: the same loop with the consumers quantizing their normed q
// rows and int8 kq tiles streamed (fwd_wg::attn_fwd_body's INT8 path); a kernel
// name of its own, so that profiles count it apart from the bf16 mode.
template <bool SEG>
__global__ void __launch_bounds__(fwd_wg::THREADS, 1)
flash_nr_fwd_int8_kernel(const __grid_constant__ CUtensorMap kq_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ fwd_wg::RawQ rq,
                         const int* __restrict__ seg, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, int H, float scale) {
  fwd_wg::attn_fwd_body<SEG, true, true>(kq_map, kq_map, v_map, rq, seg, seg, out, lse, S, S, H,
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
// scratch [B, S, H, D], amax [B, H, 1 + ceil(S / q_rows)] u32 scratch) then its
// kernel.  All of q / k / v / kn / kq / cos / sin 16-byte aligned.  Returns a
// cudaError_t (0 = launched).
extern "C" int qflux_flash_nr_fwd(const void* q, const void* k, const void* v,
                                  const void* q_scale2, const void* k_scale2,
                                  const void* cos, const void* sin, long long cs_bstride,
                                  const void* seg, void* kn, void* kq, void* amax, int q_rows,
                                  void* out, void* lse, int B, int S, int H, int st,
                                  float scale, void* stream) {
  if (q_rows < 0 || q_rows % fwd_wg::BQ || !kn || (q_rows && (!kq || !amax)) || B <= 0 ||
      S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const float* qs = static_cast<const float*>(q_scale2);
  const float* ks = static_cast<const float*>(k_scale2);
  const float* cs = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  bf16* knb = static_cast<bf16*>(kn);
  const dim3 grid((S + fwd_wg::BQ - 1) / fwd_wg::BQ, H, B);
  CUtensorMap k_map, v_map;  // k_map: kn (bf16) or kq (s_int8)
  if (!(q_rows ? encode_heads8(&k_map, kq, B, S, H, fwd_wg::BK)
               : encode_heads(&k_map, kn, B, S, H, fwd_wg::BK)) ||
      !encode_heads(&v_map, v, B, S, H, fwd_wg::BK))
    return (int)cudaErrorInvalidValue;
  static bool attr[4] = {false, false, false, false};  // bf16 <true, false>, s_int8 <true, false>
  cudaError_t err;
  if (!q_rows) {
    err = set_smem(attr[0], flash_nr_fwd_bf16_kernel<true>, fwd_wg::SMEM);
    if (err == cudaSuccess) err = set_smem(attr[1], flash_nr_fwd_bf16_kernel<false>, fwd_wg::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = launch_kn_prep(kb, ks, cs, sn, cs_bstride, knb, B, S, H, st, st_);
    if (err != cudaSuccess) return (int)err;
    const fwd_wg::RawQ rq{qb, qs, cs, sn, cs_bstride, st};
    (seg ? flash_nr_fwd_bf16_kernel<true> : flash_nr_fwd_bf16_kernel<false>)<<<
        grid, fwd_wg::THREADS, fwd_wg::SMEM, st_>>>(
        k_map, v_map, rq, static_cast<const int*>(seg), static_cast<bf16*>(out),
        static_cast<float*>(lse), S, H, scale);
    return (int)cudaGetLastError();
  }
  err = set_smem(attr[2], flash_nr_fwd_int8_kernel<true>, fwd_wg::SMEM);
  if (err == cudaSuccess) err = set_smem(attr[3], flash_nr_fwd_int8_kernel<false>, fwd_wg::SMEM);
  if (err != cudaSuccess) return (int)err;
  unsigned* am = static_cast<unsigned*>(amax);
  err = launch_int8_prep(qb, kb, nullptr, nullptr, qs, ks, cs, sn, cs_bstride, nullptr, knb,
                         nullptr, nullptr, static_cast<int8_t*>(kq), am, q_rows, B, S, H, st, st_);
  if (err != cudaSuccess) return (int)err;
  const fwd_wg::RawQ rq{qb, qs, cs, sn, cs_bstride, st, am, q_rows};
  (seg ? flash_nr_fwd_int8_kernel<true> : flash_nr_fwd_int8_kernel<false>)<<<
      grid, fwd_wg::THREADS, fwd_wg::SMEM, st_>>>(
      k_map, v_map, rq, static_cast<const int*>(seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, H, scale);
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
