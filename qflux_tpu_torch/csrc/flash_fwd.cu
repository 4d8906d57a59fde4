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
// compute-bound on the tensor cores, 0.199 ms at the 989 TFLOP/s peak.  At the
// narrow head dims the softmax's exponentials weigh as much: one ex2 a score,
// B * H * Sq * Sk of them, at the SFU's 16 a clock on each of 132 SMs (4.18e12 a
// second at 1.98 GHz).  At B = 1, S = 4000, H = 48, D = 64 the products are
// 196.6 GFLOP, 0.199 ms, and the 7.68e8 exponentials 0.184 ms; at D = 32 the
// exponentials alone take 1.85 times the products.  A loop that does not
// overlap the softmax with the products cannot reach half of that bound.
//
// What the design does about that: it is K1's bf16 main loop without the norm +
// rope prologue (flash_fwd_hopper.cuh's attn_fwd_body, which the two kernels
// share): 384 threads, one block per SM; a producer warp loads the block's 128 q
// rows by TMA into the swizzled layout wgmma reads, then keeps a TMA ring of
// 128-key k / v tiles with the keys' ids (two stages at D = 128, four at 64 /
// 32); two consumer warpgroups of 64 q rows run S = q k^T as wgmma m64n128k16
// from shared memory, the online softmax in log2 units on the accumulator
// registers, and O += P V with P as the register A operand (m64n{D}k16), tile
// i's softmax running while tile i - 1's P V is in the tensor cores, so the
// exponentials of one warpgroup overlap the products of both.  The loop is
// templated on the head dim (128, 64, 32), so the narrow heads run the D = 128
// instructions on narrower tiles.  Tensor maps are 4-D over [B, S, H, D], so
// TMA zero-fills rows past Sq or Sk of each sample.
//
// q/out are [B, Sq, H, D] bf16 and k/v [B, Sk, H, D] bf16 (the projection layout:
// head h of row s at offset (s * H + h) * D, no transpose copies), each 16-byte
// aligned (TMA); lse is [B, H, Sq] f32.

#include "flash_fwd_hopper.cuh"

namespace {

// Block (q tile of 128 rows, h, b), 384 threads: fwd_wg::attn_fwd_body at head
// dim HD with the q tile by TMA (SEG: ids given).
template <int HD, bool SEG>
__global__ void __launch_bounds__(fwd_wg::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, float scale) {
  fwd_wg::attn_fwd_body<SEG, false, false, HD>(q_map, k_map, v_map, fwd_wg::RawQ{}, q_seg,
                                               kv_seg, out, lse, Sq, Sk, H, scale);
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* q_seg,
                       const int* kv_seg, bf16* out, float* lse, int B, int Sq, int Sk, int H,
                       float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_heads(&q_map, q, B, Sq, H, fwd_wg::BQ, HD) ||
      !encode_heads(&k_map, k, B, Sk, H, fwd_wg::BK, HD) ||
      !encode_heads(&v_map, v, B, Sk, H, fwd_wg::BK, HD))
    return cudaErrorInvalidValue;
  constexpr int SMEM = fwd_wg::Layout<HD>::SMEM;
  static bool attr[2] = {false, false};
  cudaError_t e = set_smem(attr[0], flash_fwd_kernel<HD, true>, SMEM);
  if (e == cudaSuccess) e = set_smem(attr[1], flash_fwd_kernel<HD, false>, SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + fwd_wg::BQ - 1) / fwd_wg::BQ, H, B);
  (q_seg ? flash_fwd_kernel<HD, true> : flash_fwd_kernel<HD, false>)<<<
      grid, fwd_wg::THREADS, SMEM, stream>>>(q_map, k_map, v_map, q_seg, kv_seg, out, lse, Sq,
                                             Sk, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Launch K3 on `stream` at head dim D (128, 64 or 32).  q_seg [B, Sq] / kv_seg [B,
// Sk] int32, or both null (the unmasked case); q / k / v 16-byte aligned.  Returns
// a cudaError_t (0 = launched; cudaErrorInvalidValue also where a tensor map
// cannot be encoded or D is not taken).
extern "C" int qflux_flash_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                               const void* kv_seg, void* out, void* lse, int B, int Sq, int Sk,
                               int H, int D, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return (int)launch_fwd<128>(q, k, v, qs, ks, o, l, B, Sq, Sk, H, scale, st);
    case 64: return (int)launch_fwd<64>(q, k, v, qs, ks, o, l, B, Sq, Sk, H, scale, st);
    case 32: return (int)launch_fwd<32>(q, k, v, qs, ks, o, l, B, Sq, Sk, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
