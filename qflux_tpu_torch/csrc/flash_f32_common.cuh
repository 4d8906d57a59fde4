// The 3xTF32 machinery the f32 flash kernels share (flash_f32_fwd.cu: K3 / K1 in f32;
// flash_f32_bwd.cu: K4 / K2 in f32): the split of an f32 value into two TF32 pieces,
// the shared-memory layout of an f32 tile and its wgmma descriptors, the TF32 wgmma
// shapes the kernels run (and the s8 ones of K1 / K2's s_int8 modes), and the tensor
// map of an f32 head tile.
//
// The split: hi = cvt.rna.tf32.f32(x), lo = cvt.rna.tf32.f32(x - hi) (x - hi is exact
// in f32), so a b = hi_a hi_b + hi_a lo_b + lo_a hi_b to about 2^-21 of the product
// (what is dropped is lo_a lo_b and lo's own rounding).
//
// Shared-memory layout of every f32 tile: a [R, C] tile is C / 32 spans of [R, 128
// bytes] (32 floats), R * 128 bytes apart, each in the 128-byte swizzle (16-byte chunk
// c of row r at chunk c ^ (r & 7), 1024-byte atoms).  A k8 step is 32 bytes of a row,
// so the K-major descriptor of step kk is at span kk / 4, + (kk % 4) * 32 bytes, SBO =
// 1024: the bf16 k16 step's geometry (hopper.cuh).  TF32 wgmma takes its
// shared-memory operands K-major only.
//
// Accumulator layout of every shape below, as the bf16 shapes' (hopper.cuh), for
// thread 32 w + 4 g + t of the warpgroup: d[4 j + 0..1] = (row 16 w + g, cols 8 j + 2
// t, + 1), d[4 j + 2..3] = (row 16 w + g + 8, the same cols).  A TF32 A fragment from
// registers for warp w: a[0] = (row 16 w + g, k t), a[1] = (row 16 w + g + 8, k t),
// a[2] = (row 16 w + g, k t + 4), a[3] = (row 16 w + g + 8, k t + 4).

#pragma once

#include "flash_nr_common.cuh"  // int8_scale: the s_int8 modes' factors
#include "hopper.cuh"

namespace {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32 (low 13 bits zero); x - hi is exact in f32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// byte offset of element (row, col) of an f32 tile of `rows` rows (the layout above)
__device__ __forceinline__ uint32_t f32_offset(int rows, int row, int col) {
  return (col >> 5) * rows * 128 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         (col & 3) * 4;
}

// the K-major descriptor of k8 step kk over rows row0.. of an f32 tile of `rows` rows
__device__ __forceinline__ uint64_t desc_f32(uint32_t tile, int rows, int row0, int kk) {
  return wgmma_desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024, 1);
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], TF32 in, f32 accumulators, A and B K-major
// from shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                     int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// the same for N = 32
__device__ __forceinline__ void wgmma_tf32_m64n32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                     int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], A from registers (the fragment above), B
// K-major from shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db, int acc = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

// the same for N = 32
__device__ __forceinline__ void wgmma_tf32_m64n32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

// the same for N = 128 (the s_int8 forward's P V: one product over every column of O)
__device__ __forceinline__ void wgmma_tf32_m64n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

// d[64 x N] (+)= A[64 x 8] B[8 x N] for N = 64 or 32 (and 128 from registers): A from
// registers (rs) or shared memory (ss), B K-major from shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  if constexpr (N == 128) {
    wgmma_tf32_m64n128_rs(d, a, db, acc);
  } else if constexpr (N == 64) {
    wgmma_tf32_m64n64_rs(d, a, db, acc);
  } else {
    static_assert(N == 32, "N = 32, 64 or 128");
    wgmma_tf32_m64n32_rs(d, a, db, acc);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int acc) {
  if constexpr (N == 64) {
    wgmma_tf32_m64n64_ss(d, da, db, acc);
  } else {
    static_assert(N == 32, "N = 32 or 64");
    wgmma_tf32_m64n32_ss(d, da, db, acc);
  }
}

// d[64 x N] (+)= A[64 x 32] B[32 x N] for N = 64 or 32, s8 in, s32 accumulators, A
// and B K-major from shared memory (hopper.cuh's int8 tiles); acc = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[N / 2], uint64_t da, uint64_t db,
                                         int acc) {
  if constexpr (N == 64) {
    wgmma_m64n64k32_s8(d, da, db, acc);
  } else {
    static_assert(N == 32, "N = 32 or 64");
    wgmma_m64n32k32_s8(d, da, db, acc);
  }
}

// one head's rows of a [B, S, H, HD] f32 tensor, read in [box_rows, 32] boxes with
// the 128-byte swizzle (coordinates: column 32 j, h, s, b); rows past S of each
// sample are zero-filled
inline bool encode_heads_f32(CUtensorMap* map, const void* ptr, int B, int S, int H,
                             uint32_t box_rows, int HD) {
  const uint64_t row = 4ull * HD;
  const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {row, row * H, row * H * S};
  const uint32_t box[4] = {32, 1, box_rows, 1};
  return encode_cached(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
