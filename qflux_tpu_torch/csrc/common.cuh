// Helpers shared by the port's kernels (flash_nr_fwd.cu, flash_nr_bwd.cu,
// flash_fwd.cu, flash_bwd.cu, rq_int4_fwd.cu, rq_int4_bwd.cu, rowquant.cu,
// int8_gemm.cu, int4_fwd.cu, int4_bwd.cu): bf16 rounding, packing two floats into one bf16x2
// register, and an int4 nibble as an exact f32.  Each translation unit gets its
// own copy (anonymous namespace): the kernels are compiled separately and linked
// into one library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
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
