// Helpers shared by the port's kernels (flash_nr_fwd.cu, flash_nr_bwd.cu, flash_fwd.cu,
// flash_bwd.cu, rq_int4_fwd.cu, rq_int4_bwd.cu, rowquant.cu, int4_fwd.cu, int4_bwd.cu): bf16 rounding, the ldmatrix / mma.sync m16n8k16
// (bf16) and m16n8k32 (s8) wrappers, packing two floats into one bf16x2
// register, and an int4 nibble as an exact f32.  Each translation unit gets its own copy (anonymous namespace): the
// kernels are compiled separately and linked into one library.
//
// Fragment layout of mma m16n8k16 for lane = 4 * g + t: an accumulator c[0..1]
// holds (row g, cols 2t, 2t+1) and c[2..3] (row g+8, the same cols); an A fragment
// a[0..3] holds (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..),
// (row g+8, k 2t+8..); a B fragment b0 / b1 holds (k 2t..2t+1, col g) and
// (k 2t+8..2t+9, col g).  So two accumulator tiles side by side are one A fragment.
// m16n8k32 with s8 operands has the same accumulator layout (s32); its registers
// hold four bytes along k: a[0..3] = (row g, k 4t..4t+3), (row g+8, k 4t..),
// (row g, k 16+4t..), (row g+8, k 16+4t..), and b0 / b1 = (k 4t..4t+3, col g),
// (k 16+4t..16+4t+3, col g).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory; lane i gives the row address of
// matrix i / 8, and receives in r[j] its two elements of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// nibble j of `nib` as an exact f32: byte j of `nib` holds n ^ 8 for the nibble
// n (so its two's-complement value is v = (n ^ 8) - 8); byte_perm puts it in
// the low mantissa bits of 2^23 (0x4B000000), and 2^23 + 8 is subtracted.  A
// byte permute and an add per weight, on the integer and float pipes, where
// I2F would take the narrow conversion unit (the int4 kernels' nibbles).
__device__ __forceinline__ float nibble_f32(uint32_t nib, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 | j)), 8388616.0f);
}

// two floats → one register of two bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
