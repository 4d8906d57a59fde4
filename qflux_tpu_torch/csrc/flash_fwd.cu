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
// What the design does about that: it is K1's bf16 main loop without the norm +
// rope prologue (flash_fwd_hopper.cuh's attn_fwd_body, which the two kernels
// share): 384 threads, one block per SM; a producer warp loads the block's 128 q
// rows by TMA into the swizzled layout wgmma reads, then keeps a two-stage TMA
// ring of 128-key k / v tiles with the keys' ids; two consumer warpgroups of 64
// q rows run S = q k^T as wgmma m64n128k16 from shared memory, the online
// softmax in log2 units on the accumulator registers, and O += P V with P as the
// register A operand.  Tensor maps are 4-D over [B, S, H, 128], so TMA
// zero-fills rows past Sq or Sk of each sample.
//
// q/out are [B, Sq, H, D] bf16 and k/v [B, Sk, H, D] bf16 (the projection layout:
// head h of row s at offset (s * H + h) * D, no transpose copies), each 16-byte
// aligned (TMA); lse is [B, H, Sq] f32.

#include "flash_fwd_hopper.cuh"

namespace {

// Block (q tile of 128 rows, h, b), 384 threads: fwd_wg::attn_fwd_body with the
// q tile by TMA (SEG: ids given).
template <bool SEG>
__global__ void __launch_bounds__(fwd_wg::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, float scale) {
  fwd_wg::attn_fwd_body<SEG, false>(q_map, k_map, v_map, fwd_wg::RawQ{}, q_seg, kv_seg, out,
                                    lse, Sq, Sk, H, scale);
}

}  // namespace

// Launch K3 on `stream`.  q_seg [B, Sq] / kv_seg [B, Sk] int32, or both null (the
// unmasked case); q / k / v 16-byte aligned.  Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue also where a tensor map cannot be encoded).
extern "C" int qflux_flash_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                               const void* kv_seg, void* out, void* lse, int B, int Sq, int Sk,
                               int H, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_heads(&q_map, q, B, Sq, H, fwd_wg::BQ) ||
      !encode_heads(&k_map, k, B, Sk, H, fwd_wg::BK) ||
      !encode_heads(&v_map, v, B, Sk, H, fwd_wg::BK))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fwd_wg::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_wg::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((Sq + fwd_wg::BQ - 1) / fwd_wg::BQ, H, B);
  (q_seg ? flash_fwd_kernel<true> : flash_fwd_kernel<false>)<<<
      grid, fwd_wg::THREADS, fwd_wg::SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk, H, scale);
  return (int)cudaGetLastError();
}
