// The Hopper machinery the port's sm_90a kernels share (K6a int4_fwd.cu, K6b
// int4_bwd.cu, K1 / K2 flash_nr_*.cu, K3 / K4 flash_*.cu, K5a / K5b
// rq_int4_*.cu): mbarriers, fences, named barriers and setmaxnreg; TMA tile
// loads and bulk copies into shared memory; wgmma descriptors, the bf16 wgmma
// shapes the kernels use (A from shared memory or from registers) and the s8
// ones (both operands from shared memory, K-major: the only form wgmma takes
// 8-bit operands in); and the tensor-map encoder (libcuda's
// cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint, so the library
// needs no -lcuda) with a cache of encoded maps.  Each translation unit gets its
// own copy (anonymous namespace), as with common.cuh.
//
// Shared-memory tile layout of every TMA load of a [R, HD] bf16 head tile (HD =
// 128, 64 or 32: the template parameter of the helpers below, 128 by default).
// HD = 128 and 64: 128-byte rows (64 bf16), 8-row swizzle atoms of 1024 bytes,
// 16-byte chunk c of row r stored at chunk c ^ (r & 7)
// (CU_TENSOR_MAP_SWIZZLE_128B; tile bases 1024-aligned); a [R, 128] tile is two
// such [R, 64] halves, R * 128 bytes apart, a [R, 64] tile one.  HD = 32: 64-byte
// rows, 8-row atoms of 512 bytes, chunk c of row r at chunk c ^ ((r >> 1) & 3)
// (CU_TENSOR_MAP_SWIZZLE_64B, the same address bits XORed).  Call SPAN the row
// bytes of one swizzle span (128, or 64 at HD = 32).  wgmma reads the tile
//   * K-major (the contraction along the HD columns: q·kᵀ's q and k):
//     descriptor at span (kk / (SPAN / 32)) + (kk % (SPAN / 32)) * 32 bytes for
//     k16 step kk, SBO = 8 * SPAN (the 8-row groups), layout 1 (128-byte
//     swizzle) or 2 (64-byte);
//   * MN-major (the contraction along the rows: p·v's v): descriptor at
//     kk * 16 * SPAN bytes (16 rows) for k16 step kk, LBO = R * SPAN (the second
//     64-column half at HD = 128), SBO = 8 * SPAN, the same layout, transposed B.
// An [R, 128] int8 tile is one [R, 128-byte] block (a row is a single
// swizzle span); wgmma reads it K-major only: descriptor at kk * 32 bytes for
// k32 step kk, SBO = 1024, layout 1 (desc_kmajor8).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// shared-memory addresses, mbarriers, fences

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Out of line on purpose: a trap inlined into the code after setmaxnreg.inc
// makes ptxas compile that code within the launch bound's share (168 registers
// a thread at 384 threads) instead of the granted budget, and it spills and
// serializes the wgmmas (ptxas C7512).
__device__ __noinline__ void mbar_timeout() { __trap(); }

// spins until the phase of parity `parity` has completed; traps (a launch
// error instead of a hung card) if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 30)) mbar_timeout();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// generic-proxy stores to shared memory become visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two consumer warpgroups (256 threads) meet; id 0 is __syncthreads'
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup c (0 or 1) meet, on named barrier 2 + c
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
}

// named barrier `id` over `n` threads: wait for the others, or arrive without waiting
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Two consumer warpgroups (c = 0, 1) taking turns to issue their products, so
// that one's softmax runs while the other's products are in the tensor cores:
// warpgroup c waits on named barrier 4 + c for its turn (turn_take), issues,
// and hands the turn to the other on its barrier (turn_pass).  Warpgroup 1
// hands warpgroup 0 its first turn (turns_start) and leaves out its last
// hand-over, which nobody would take; both take the same number of turns.
// ptxas serializes the wgmmas unless a wgmma.fence follows any wait between a
// turn and its products (C7520).  K3's narrow instances take turns; the
// backward's loops, tried with them on an H100, ran slower.
__device__ __forceinline__ void turns_start(int c) {
  if (c == 1) named_bar_arrive(4, 256);
}

__device__ __forceinline__ void turn_take(int c) { named_bar_sync(4 + c, 256); }

__device__ __forceinline__ void turn_pass(int c, bool last) {
  if (!(last && c == 1)) named_bar_arrive(4 + (c ^ 1), 256);
}

// Moves registers between warpgroups at run time; ptxas compiles the code after
// each call within its budget (ptxas -v still reports the launch bound's share,
// 65536 / 384 = 168 for a 384-thread block), provided no trap is inlined there
// (mbar_timeout).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the first 1024-byte boundary at or after p (the 128-byte swizzle's atoms
// start there)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// asynchronous copies, completed on an mbarrier by transaction bytes

// a 2-D tile of the tensor map at (c0 innermost, c1), rows past the tensor zero-filled
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a 4-D tile at (c0 innermost, c1, c2, c3); elements past any dimension zero-filled
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// A shared-memory matrix descriptor.  layout: 1 = 128-byte swizzle, 2 = 64-byte.
// The tile's swizzle atoms (8 rows of 128 or 64 bytes) must start on a multiple
// of their size (base offset 0); moving along K inside a swizzled row adds the
// byte offset to the start address, as CUTLASS's descriptor iterator does.
//   K-major (rows of the contraction): sbo = the stride between 8-row groups,
//   lbo unused (16).  MN-major, 128-byte swizzle (rows of 64 MN elements, one
//   row per k): lbo = the stride between 64-element MN chunks, sbo = the stride
//   between groups of 8 k.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], bf16 in, f32 accumulators; A K-major,
// B K-major (TRANS_B = 0) or MN-major (1); acc = 0 overwrites d (d = A * B),
// acc = 1 accumulates.  Accumulator layout for thread 32 w + 4 g + t of the
// warpgroup: d[4 j + 0..1] = (row 16 w + g, cols 8 j + 2 t, + 1), d[4 j + 2..3] =
// (row 16 w + g + 8, the same cols).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int acc = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %66;\n"
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
      : "l"(da), "l"(db), "n"(TRANS_B), "r"(acc)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major from shared memory,
// acc as above.  The accumulator layout of the 128-column shape over 8 column
// tiles
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
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

// d[64 x 128] += A[64 x 16] * B[16 x 128] with A from registers (a[0..3]: the
// m16n8k16 A fragment of rows 16 w .. 16 w + 15 for warp w of the warpgroup:
// (row g, k 2t..), (row g + 8, k 2t..), (row g, k 2t + 8..), (row g + 8,
// k 2t + 8..), bf16 pairs) and B MN-major from shared memory (transposed)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the fragment of
// wgmma_m64n128k16_rs), B MN-major from shared memory (transposed); the
// accumulator layout of the 128-column shape over 8 column tiles
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 32] += A[64 x 16] * B[16 x 32], A from registers (the fragment of
// wgmma_m64n128k16_rs), B MN-major from shared memory (transposed); the
// accumulator layout of the 128-column shape over 4 column tiles
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N] for the output width N = HD of a head
// tile (128, 64 or 32), A from registers, B MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) {
    wgmma_m64n128k16_rs(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_rs(d, a, db);
  } else {
    static_assert(N == 32, "head dims 32, 64 and 128");
    wgmma_m64n32k16_rs(d, a, db);
  }
}

// d[64 x 128] (+)= A[64 x 32] * B[32 x 128], s8 in, s32 accumulators; A and B
// K-major in shared memory; acc = 0 overwrites d.  Accumulator layout as the
// f32 shapes': d[4 j + 0..1] = (row 16 w + g, cols 8 j + 2 t, + 1), d[4 j +
// 2..3] = (row 16 w + g + 8, the same cols).
__device__ __forceinline__ void wgmma_m64n128k32_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                                    int acc = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 32] * B[32 x 64], s8 in, s32 accumulators, A and B
// K-major in shared memory, acc as above; the accumulator layout of the
// 128-column shape over 8 column tiles
__device__ __forceinline__ void wgmma_m64n64k32_s8(uint32_t (&d)[32], uint64_t da, uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// the same for N = 32 (the f32 backward's int8 scores over 32 streamed rows): the
// accumulator layout of the 128-column shape over 4 column tiles
__device__ __forceinline__ void wgmma_m64n32k32_s8(uint32_t (&d)[16], uint64_t da, uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// An s32 accumulator element as f32, exactly for |x| < 2^22 (every int8 score
// of a 128-wide head: |sum| <= 127^2 * 128 < 2^21): the integer added to the
// bits of 1.5 * 2^23 is that float plus x, and one subtraction takes the bias
// away.  An integer add and a float add, where I2F would take the narrow
// conversion unit.
__device__ __forceinline__ float s32_to_f32(uint32_t x) {
  return __fsub_rn(__uint_as_float(x + 0x4B400000u), 12582912.0f);
}

// The softmax works in log2 units: exp(x * scale - m) is 2^(x * scale * LOG2E -
// m * LOG2E), one fused multiply-add and ex2.approx (what __expf runs after its
// own multiply) per score.
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the wgmma A fragments (bf16 pairs, rounded to nearest even) of a 64 x 2R f32
// accumulator, one per 16 columns: the accumulator's columns become the
// contraction of the next product
template <int R>
__device__ __forceinline__ void to_a_frags(const float (&x)[R], uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// the bytes of one swizzle span of a [R, HD] bf16 head tile (128, or 64 at HD = 32)
// and its descriptor layout (1: the 128-byte swizzle, 2: the 64-byte one)
template <int HD>
__host__ __device__ constexpr int span_bytes() {
  static_assert(HD == 128 || HD == 64 || HD == 32, "head dims 32, 64 and 128");
  return HD == 32 ? 64 : 128;
}

template <int HD>
__host__ __device__ constexpr uint32_t span_layout() {
  return span_bytes<HD>() == 128 ? 1 : 2;
}

// descriptors of the tile layout above (base 1024-aligned, R rows)
template <int HD = 128>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int row0, int kk) {
  constexpr int SPAN = span_bytes<HD>(), KS = SPAN / 32;  // k16 steps in a span
  return wgmma_desc(tile + (kk / KS) * rows * SPAN + row0 * SPAN + (kk % KS) * 32, 16, 8 * SPAN,
                    span_layout<HD>());
}

template <int HD = 128>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kk) {
  constexpr int SPAN = span_bytes<HD>();
  return wgmma_desc(tile + kk * 16 * SPAN, rows * SPAN, 8 * SPAN, span_layout<HD>());
}

// the int8 tile's K-major descriptor at rows row0.. for k32 step kk
__device__ __forceinline__ uint64_t desc_kmajor8(uint32_t tile, int row0, int kk) {
  return wgmma_desc(tile + row0 * 128 + kk * 32, 16, 1024, 1);
}

// byte offset of byte `col` of row `row` of an [R, 128] int8 tile in that layout
__device__ __forceinline__ uint32_t swz8_offset(int row, int col) {
  return row * 128 + ((((col >> 4) ^ (row & 7)) << 4) | (col & 15));
}

// byte offset of element (row, col) of a [rows, HD] bf16 tile in that layout
template <int HD = 128>
__device__ __forceinline__ uint32_t swz_offset(int rows, int row, int col) {
  if constexpr (span_bytes<HD>() == 128)
    return (col >> 6) * rows * 128 + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
           (col & 7) * 2;
  else
    return row * 64 + ((((col >> 3) & 3) ^ ((row >> 1) & 3)) << 4) + (col & 7) * 2;
}

// this warp's 16 rows of a 64 x HD f32 accumulator (wgmma layout), each times
// mul[row half], as bf16 to rows grow0 .. grow0 + 15 of one head (row stride
// rs; rows >= n skipped), staged in the warp's own rows trow0 .. trow0 + 15 of
// the swizzled [rows, HD] smem tile `tile` for 16-byte coalesced stores
template <int HD = 128>
__device__ __forceinline__ void store_rows_wg(const float (&acc)[HD / 2], const float (&mul)[2],
                                              uint8_t* tile, int rows, int trow0,
                                              bf16* __restrict__ dst, int rs, int grow0, int n) {
  constexpr int CPR = HD / 8;  // 16-byte chunks of a row
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(tile +
                                   swz_offset<HD>(rows, trow0 + g + 8 * i, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * i] * mul[i], acc[4 * j + 2 * i + 1] * mul[i]);
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    const int idx = jj * 32 + lane, r = idx / CPR, cc = idx % CPR;
    if (grow0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(grow0 + r) * rs + cc * 8) =
          *reinterpret_cast<const uint4*>(tile + swz_offset<HD>(rows, trow0 + r, cc * 8));
  }
}

// a [rows, HD] tile of head h, rows row0.. of sample b, by TMA on `bar` (map:
// encode_heads at head dim HD); HD = 128 as its two [rows, 64] halves
template <int HD = 128>
__device__ __forceinline__ void tma_load_head(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int h, int row0, int b) {
  tma_load_4d(dst, map, bar, 0, h, row0, b);
  if constexpr (HD == 128) tma_load_4d(dst + rows * 128, map, bar, 64, h, row0, b);
}

// ---------------------------------------------------------------------------
// host

// the dynamic shared memory a kernel may take, set on its first launch (`done`:
// the caller's flag for that kernel)
template <typename K>
cudaError_t set_smem(bool& done, K kernel, int bytes) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor of `rank` (<= 4) dimensions, dims[0] innermost and contiguous,
// strides[i] the byte stride of dims[i + 1], read in boxes of box[0..rank);
// false if the encoder refuses it.  Encoded through a small direct-mapped cache
// keyed by everything the map encodes, so a call costs no more host time than
// a plain launch: a frozen weight's map is encoded once, an activation's
// whenever its buffer moves.  A map is a pure function of its key, so a hit is
// always right.
inline bool encode_cached(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                          const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                          CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* ptr;
    uint64_t dims[4], strides[3];
    uint32_t box[4];
    int rank, type, swizzle;
    bool valid;
    CUtensorMap map;
  };
  constexpr int SLOTS = 1024;
  static Entry cache[SLOTS];
  static std::mutex mu;
  Entry key{};
  key.ptr = ptr;
  key.rank = rank;
  key.type = (int)type;
  key.swizzle = (int)swizzle;
  uint64_t h = (reinterpret_cast<uint64_t>(ptr) >> 8) ^ (uint64_t)type ^ ((uint64_t)rank << 56);
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    h = h * 0x9E3779B97F4A7C15ull ^ dims[i] ^ ((uint64_t)box[i] << 40);
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  auto same = [&](const Entry& e) {
    if (!e.valid || e.ptr != ptr || e.rank != rank || e.type != key.type ||
        e.swizzle != key.swizzle)
      return false;
    for (int i = 0; i < rank; ++i)
      if (e.dims[i] != key.dims[i] || e.box[i] != key.box[i] ||
          (i + 1 < rank && e.strides[i] != key.strides[i]))
        return false;
    return true;
  };
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = cache[(h ^ (h >> 29)) % SLOTS];
  if (same(e)) {
    *map = e.map;
    return true;
  }
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return false;
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4], es[4];
  for (int i = 0; i < rank; ++i) {
    gd[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i + 1 < rank) gs[i] = strides[i];
  }
  if (fn(map, type, rank, const_cast<void*>(ptr), gd, gs, bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  key.valid = true;
  key.map = *map;
  e = key;
  return true;
}

// a row-major [rows, cols] tensor of `elem` bytes at `ptr`, read in boxes of
// box_rows x box_cols
inline bool encode_2d_cached(CUtensorMap* map, CUtensorMapDataType type, int elem,
                             const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
                             uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols * (uint64_t)elem};
  const uint32_t box[2] = {box_cols, box_rows};
  return encode_cached(map, type, ptr, 2, dims, strides, box, swizzle);
}

// one head's rows of a [B, S, H, D] bf16 tensor (D = 128, 64 or 32), read in
// [box_rows, min(D, 64)] boxes with the 128-byte swizzle (D = 32: [box_rows, 32]
// with the 64-byte one) (coordinates: column 0 or 64, h, s, b); rows past S of
// each sample are zero-filled
inline bool encode_heads(CUtensorMap* map, const void* ptr, int B, int S, int H,
                         uint32_t box_rows, int D = 128) {
  const uint64_t row = 2ull * D;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {row, row * H, row * H * S};
  const uint32_t box[4] = {(uint32_t)(D < 64 ? D : 64), 1, box_rows, 1};
  return encode_cached(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 4, dims, strides, box,
                       D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// the same for a [B, S, H, 128] int8 tensor: a row is one 128-byte swizzle span,
// read in [box_rows, 128] boxes (coordinates: 0, h, s, b)
inline bool encode_heads8(CUtensorMap* map, const void* ptr, int B, int S, int H,
                          uint32_t box_rows) {
  const uint64_t dims[4] = {128, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {128, 128ull * H, 128ull * H * S};
  const uint32_t box[4] = {128, 1, box_rows, 1};
  return encode_cached(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
