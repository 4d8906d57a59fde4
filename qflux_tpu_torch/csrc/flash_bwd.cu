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
//   2. dkv:   one block per 128-key tile of a head, 64 keys per consumer warpgroup;
//             the q tiles stream past and dv, dk accumulate in registers;
//   3. dq:    one block per 128-row q tile, 64 rows per consumer warpgroup; the K
//             tiles stream past and dq accumulates in registers.
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
// the row-complete dq without atomics (an f32 atomicAdd dq would add in a different
// order on every call).  At the narrow head dims the exponentials weigh almost as
// much as the products: the function needs B * H * Sq * Sk ex2, at the SFU's
// 4.18e12 a second (16 a clock on each of 132 SMs at 1.98 GHz), but this design
// computes p in both kernels, twice that.  At B = 1, S = 4000, H = 48, D = 64
// that is 0.367 ms (the function's 0.184) against 0.497 ms of products; at D = 32
// the design's 0.367 ms exceeds the products' 0.249, while the function's floor
// stays the tensor cores'.
//
// What the design does about that: both kernels are warp specialised on the Hopper
// machinery of hopper.cuh (384 threads, one block per SM), with the main loops of
// flash_bwd_hopper.cuh, which K2's bf16 mode (flash_nr_bwd.cu) runs too with its
// own epilogue: a producer warp keeps a 4-stage TMA ring of streamed tiles, and
// two consumer warpgroups run every product as wgmma with f32 accumulators in
// registers (dkv: s^T and dp^T as m64n64k16, dv and dk as m64n{D}k16 with p^T /
// ds^T as the register A operand; dq the same way); the two warpgroups' softmax
// and products interleave on the SM.  The loops are templated on the head dim
// (128, 64, 32): the narrow heads run the D = 128 instructions on narrower tiles.
// Keys and rows past the tensor are zero-filled by TMA and carry segment 0.  The
// epilogues stage each warp's rows in its own rows of a block tile for 16-byte
// stores.  The tile sizes are the register budget's: a dkv consumer holds two
// 64 x D f32 accumulators (128 registers a thread at D = 128) beside the 64 x 64
// s^T and dp^T (64) and their A fragments, which fits the 232 that setmaxnreg
// grants (the producer keeps 40: it spilled at 24).  hopper.cuh's mbar_timeout
// says why the trap is out of line: inlined, it held the consumers to 168
// registers, and 32-row q tiles were the most that fitted.  The trap out of line,
// the 64-row tiles and then the softmax in log2 units were each a measured gain
// on an H100.
//
// Layouts: q/out/do/dq [B, Sq, H, D] and k/v/dk/dv [B, Sk, H, D] bf16 (row stride
// H * D), lse and delta [B, H, Sq] f32, q_seg [B, Sq] and kv_seg [B, Sk] int32, or both
// null (the unmasked case: every real token is segment 1).

#include <type_traits>

#include "flash_bwd_hopper.cuh"

namespace {

constexpr int DELTA_WARPS = 8;

// delta[b, h, s] = sum over d of do * out, in f32; one warp per (b, s, h) row, HD / 32
// channels a lane
template <int HD>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
flash_delta_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                   float* __restrict__ delta, int rows, int Sq, int H) {
  constexpr int PER = HD / 32;
  const int row = blockIdx.x * DELTA_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  // row = (b * Sq + s) * H + h: [B, Sq, H, HD] rows are contiguous HD-vectors
  const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
  const size_t off = (size_t)row * HD + lane * PER;
  // the lane's PER channels as one load
  using V = std::conditional_t<PER == 4, uint2, std::conditional_t<PER == 2, uint32_t, uint16_t>>;
  const V draw = *reinterpret_cast<const V*>(dout + off);
  const V oraw = *reinterpret_cast<const V*>(out + off);
  const bf16* dp = reinterpret_cast<const bf16*>(&draw);
  const bf16* op = reinterpret_cast<const bf16*>(&oraw);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) acc += __bfloat162float(dp[j]) * __bfloat162float(op[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[((size_t)b * H + h) * Sq + s] = acc;
}

// dk / dv: block = 128 keys of one (b, h); consumer warpgroup c owns keys 64 c ..
// 64 c + 63 (bwd_wg::attn_dkv_body at head dim HD, K4's bf16 store epilogue)
template <int HD>
__global__ void __launch_bounds__(bwd_wg::NTHREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg,
                 const __grid_constant__ bwd_wg::StoreGrads epi, int Sq, int Sk, int H,
                 float scale) {
  bwd_wg::attn_dkv_body<bwd_wg::StoreGrads, bwd_wg::NoInt8, HD>(
      k_map, v_map, q_map, do_map, lse, delta, q_seg, kv_seg, Sq, Sk, H, scale, epi);
}

// dq: block = 128 q rows of one (b, h); consumer warpgroup c owns rows 64 c .. 64 c +
// 63 (bwd_wg::attn_dq_body at head dim HD, the same epilogue)
template <int HD>
__global__ void __launch_bounds__(bwd_wg::NTHREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ q_seg,
                const int* __restrict__ kv_seg,
                const __grid_constant__ bwd_wg::StoreGrads epi, int Sq, int Sk, int H,
                float scale) {
  bwd_wg::attn_dq_body<bwd_wg::StoreGrads, bwd_wg::NoInt8, HD>(
      q_map, do_map, k_map, v_map, lse, delta, q_seg, kv_seg, Sq, Sk, H, scale, epi);
}

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const int* qs,
                       const int* ks, const bf16* out, const float* ls, const bf16* dout,
                       float* dl, const bwd_wg::StoreGrads& epi, int B, int Sq, int Sk, int H,
                       float scale, cudaStream_t st) {
  using namespace bwd_wg;
  CUtensorMap q_own, do_own, k_own, v_own, q_step, do_step, k_step, v_step;
  if (!encode_heads(&q_own, q, B, Sq, H, BLK, HD) ||
      !encode_heads(&do_own, dout, B, Sq, H, BLK, HD) ||
      !encode_heads(&k_own, k, B, Sk, H, BLK, HD) || !encode_heads(&v_own, v, B, Sk, H, BLK, HD) ||
      !encode_heads(&q_step, q, B, Sq, H, KV_STEP, HD) ||
      !encode_heads(&do_step, dout, B, Sq, H, KV_STEP, HD) ||
      !encode_heads(&k_step, k, B, Sk, H, STEP, HD) ||
      !encode_heads(&v_step, v, B, Sk, H, STEP, HD))
    return cudaErrorInvalidValue;
  constexpr int KV = KvLayout<false, HD>::SMEM, QS = QLayout<false, HD>::SMEM;
  static bool attr[2] = {false, false};
  cudaError_t err = set_smem(attr[0], flash_dkv_kernel<HD>, KV);
  if (err == cudaSuccess) err = set_smem(attr[1], flash_dq_kernel<HD>, QS);
  if (err != cudaSuccess) return err;
  const int rows = B * Sq * H;
  flash_delta_kernel<HD><<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0, st>>>(
      dout, out, dl, rows, Sq, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<HD><<<dim3((Sk + BLK - 1) / BLK, H, B), NTHREADS, KV, st>>>(
      k_own, v_own, q_step, do_step, ls, dl, qs, ks, epi, Sq, Sk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dq_kernel<HD><<<dim3((Sq + BLK - 1) / BLK, H, B), NTHREADS, QS, st>>>(
      q_own, do_own, k_step, v_step, ls, dl, qs, ks, epi, Sq, Sk, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Launch K4 on `stream` at head dim D (128, 64 or 32): delta (f32 [B, H, Sq]
// scratch), then dk / dv, then dq.  q_seg [B, Sq] / kv_seg [B, Sk] int32, or both
// null (the unmasked case); q / k / v / do 16-byte aligned.  Returns a cudaError_t
// (0 = launched).
extern "C" int qflux_flash_bwd(const void* q, const void* k, const void* v, const void* q_seg,
                               const void* kv_seg, const void* out, const void* lse,
                               const void* dout, void* delta, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, int D, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  const bf16* o = static_cast<const bf16*>(out);
  const float* ls = static_cast<const float*>(lse);
  const bf16* d = static_cast<const bf16*>(dout);
  float* dl = static_cast<float*>(delta);
  const bwd_wg::StoreGrads epi{static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                               static_cast<bf16*>(dv)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return (int)launch_bwd<128>(q, k, v, qs, ks, o, ls, d, dl, epi, B, Sq, Sk, H, scale, st);
    case 64:
      return (int)launch_bwd<64>(q, k, v, qs, ks, o, ls, d, dl, epi, B, Sq, Sk, H, scale, st);
    case 32:
      return (int)launch_bwd<32>(q, k, v, qs, ks, o, ls, d, dl, epi, B, Sq, Sk, H, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
