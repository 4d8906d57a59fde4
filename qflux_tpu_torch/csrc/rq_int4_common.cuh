// What K5a (rq_int4_fwd.cu) and K5b (rq_int4_bwd.cu) share beyond the Hopper
// machinery of hopper.cuh: the regrid of an int4 nibble onto the per-channel
// int8 grid without the conversion unit, and one int8 GEMM over a TMA ring with
// wgmma s8 x s8 -> s32, its scaling epilogue and its split-contraction
// reduction.  Each translation unit gets its own copy (anonymous namespace), as
// with common.cuh.
//
// The two kernels are a regrid pass, then that GEMM:
//   * the regrid pass writes the weight once per call onto the int8 grid,
//     q8 = clip(rint(f32(v) * f), -127, 127), into a transient scratch in the
//     layout the GEMM's B operand wants (K-major: wgmma takes 8-bit A and B
//     only K-major): K5a's [N, K] (the contraction K contiguous, so the pass
//     transposes), K5b's [K, N] (its contraction is N, along which q4 is
//     already contiguous).  Each weight is regridded once per call instead of
//     once per output tile: in the earlier mma.sync kernels every 128-row tile of
//     the output regridded its whole weight strip again with an I2F, an FMUL
//     and an F2I a weight (30 times over at M = 3744), and the conversion unit,
//     at an eighth of the FP32 rate, held the tensor cores back;
//   * the GEMM: C[M, Nout] = epilogue(A[M, Kc] . B[Nout, Kc]^T), A and B int8,
//     K-major, 384 threads, one block per SM.  Warpgroup 0 is the producer:
//     one thread keeps STAGES stages in flight by TMA (the A tile [256, 128]
//     and the B tile [128, 128], 128-byte swizzle, rows and contraction past
//     the tensor zero-filled), each stage on a `full` mbarrier (transaction
//     bytes) and freed by an `empty` one (one arrival per consumer warp).
//     Warpgroups 1 and 2 are the consumers, 128 rows each: per stage 4 k32
//     steps x 2 wgmma.m64n128k32 with both operands in shared memory and s32
//     accumulators in registers (128 a thread); a stage is freed once the next
//     stage's products are issued (wgmma.wait_group 1).  There is no
//     dequantization between the TMA ring and the tensor cores: the loop is a
//     plain int8 GEMM.  One block an output tile; a persistent grid whose
//     ring ran on from one tile to the next (the next tile's loads under the
//     last one's epilogue) was no faster on an H100.
//   * the epilogue keeps the plain version's cast chain: out = cast(
//     (f32(acc) * srow[m]) * scol[n]) (K5a: sx, s_vec; K5b: sg and no column
//     factor), IEEE products, one round to nearest even.  Where the output
//     tiles fill less than the card, the contraction is split into ranges of
//     whole 128-wide stages (blockIdx.z); each split writes its int32 partial
//     sums to a workspace and the reduction pass adds them (int32 addition is
//     exact, so the result is the unsplit one to the bit) and applies the same
//     epilogue.
//
// Shared memory: STAGES x (32 KB + 16 KB) = 192 KB, plus barriers.

#pragma once

#include "hopper.cuh"

namespace {

namespace rq {

constexpr int BM = 256;        // output rows per block (two consumer warpgroups of 128)
constexpr int BN = 128;        // output columns per block
constexpr int BK = 128;        // contraction bytes per stage (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024

// ---------------------------------------------------------------------------
// the regrid

// clip(rint(v * f), -127, 127) as a byte: one IEEE product (as the plain
// version's), the clip (equal before or after the rounding, the bounds being
// integers), and the round half to even by adding 1.5 * 2^23, exact for
// |x| < 2^22: the sum's low byte is the integer's two's complement (no F2I)
__device__ __forceinline__ uint32_t regrid_byte(float v, float f) {
  const float p = fminf(fmaxf(__fmul_rn(v, f), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(p, 12582912.0f)) & 0xFFu;
}

// the four bytes of `w` (four weights of one packed row, or of one column) ->
// their low-nibble and high-nibble values (common.cuh:nibble_f32) regridded
// with the factors fl[j] / fh[j] of byte j, each as a word of four int8 (byte
// j in byte j)
__device__ __forceinline__ void regrid_word(uint32_t w, const float (&fl)[4],
                                            const float (&fh)[4], uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t nl = (w ^ 0x88888888u) & 0x0F0F0F0Fu;
  const uint32_t nh = ((w >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
  lo = hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= regrid_byte(nibble_f32(nl, j), fl[j]) << (8 * j);
    hi |= regrid_byte(nibble_f32(nh, j), fh[j]) << (8 * j);
  }
}

// ---------------------------------------------------------------------------
// the int8 GEMM

// out = cast((f32(acc) * srow) * scol) with IEEE products (scol absent: one
// product), as the plain version's epilogue
template <bool COL>
__device__ __forceinline__ float scale_acc(int acc, float srow, float scol) {
  const float y = __fmul_rn(__int2float_rn(acc), srow);
  return COL ? __fmul_rn(y, scol) : y;
}

// The GEMM body (every block of the grid): A [M, Kc] and B [Nout, Kc] by their
// tensor maps (boxes [BM, BK] and [BN, BK]); block (x, y, z) computes rows
// BM x, columns BN y (row tiles fastest, so the blocks in flight share B
// tiles), contraction stages [z * chunks / splits, (z + 1) * chunks / splits)
// of the chunks = ceil(Kc / BK).  Unsplit, it writes out[M, Nout] (bf16, or
// f32 with out_f32) through the epilogue; split, its int32 partial sums to
// plane z of ws [splits, M, Nout].
template <bool COL>
__device__ __forceinline__ void gemm_body(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                          const float* __restrict__ srow,
                                          const float* __restrict__ scol, void* __restrict__ out,
                                          int* __restrict__ ws, int M, int Nout, int Kc,
                                          int splits, int out_f32) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int chunks = (Kc + BK - 1) / BK;
  const int c_begin = z * chunks / splits, c_end = (z + 1) * chunks / splits;
  const int steps = c_end - c_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[st], ((s / STAGES) - 1) & 1);
        const int k0 = (c_begin + s) * BK;
        uint8_t* a = smem + st * STAGE_BYTES;
        mbar_expect_tx(&full[st], STAGE_BYTES);
        tma_load_2d(a, a_map, &full[st], k0, m0);
        tma_load_2d(a + A_BYTES, b_map, &full[st], k0, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c computes rows m0 + 128 c .. + 127, two m64 tiles
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int lane = threadIdx.x & 31;

  uint32_t acc[2][64];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0u;

  const uint32_t base = smem_u32(smem);
  for (int s = 0; s < steps; ++s) {
    const int st = s % STAGES;
    mbar_wait(&full[st], (s / STAGES) & 1);
    const uint32_t a_addr = base + st * STAGE_BYTES + c * 128 * BK;
    const uint32_t b_addr = base + st * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint64_t db = wgmma_desc(b_addr + kk * 32, 16, 1024, 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma_m64n128k32_s8(acc[mt], wgmma_desc(a_addr + mt * 64 * BK + kk * 32, 16, 1024, 1),
                            db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0) {  // the previous stage's products are done: free it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(s - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) fence_regs(acc[mt]);

  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 128 * c + 64 * mt + 16 * warp + g + 8 * h;
      if (row >= M) continue;
      const float sr = splits > 1 ? 0.f : srow[row];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= Nout) continue;  // Nout is even: col + 1 < Nout too
        const int a0 = static_cast<int>(acc[mt][4 * j + 2 * h]);
        const int a1 = static_cast<int>(acc[mt][4 * j + 2 * h + 1]);
        const size_t idx = (size_t)row * Nout + col;
        if (splits > 1) {
          *reinterpret_cast<int2*>(ws + (size_t)z * M * Nout + idx) = make_int2(a0, a1);
          continue;
        }
        const float y0 = scale_acc<COL>(a0, sr, COL ? scol[col] : 1.f);
        const float y1 = scale_acc<COL>(a1, sr, COL ? scol[col + 1] : 1.f);
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(y0, y1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + idx) = pack_bf16(y0, y1);
        }
      }
    }
}

// The split contraction's reduction: out = epilogue(sum over s of ws[s]), four
// elements a thread (Nout % 4 == 0, so the four share a row); int32 sums, exact
// in any order.  Each kernel file wraps it in a kernel of its own name, so a
// profile counts the pass with its kernel.
template <bool COL>
__device__ __forceinline__ void reduce_body(const int* __restrict__ ws,
                                            const float* __restrict__ srow,
                                            const float* __restrict__ scol,
                                            void* __restrict__ out, int M, int Nout, int splits,
                                            int out_f32) {
  const long long n4 = (long long)M * Nout / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int4* w = reinterpret_cast<const int4*>(ws);
  int4 a = w[i];
  for (int s = 1; s < splits; ++s) {
    const int4 v = w[(long long)s * n4 + i];
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  const int row = (int)(4 * i / Nout), col = (int)(4 * i % Nout);
  const float sr = srow[row];
  const float y0 = scale_acc<COL>(a.x, sr, COL ? scol[col] : 1.f);
  const float y1 = scale_acc<COL>(a.y, sr, COL ? scol[col + 1] : 1.f);
  const float y2 = scale_acc<COL>(a.z, sr, COL ? scol[col + 2] : 1.f);
  const float y3 = scale_acc<COL>(a.w, sr, COL ? scol[col + 3] : 1.f);
  if (out_f32) {
    reinterpret_cast<float4*>(out)[i] = make_float4(y0, y1, y2, y3);
  } else {
    reinterpret_cast<uint2*>(out)[i] = make_uint2(pack_bf16(y0, y1), pack_bf16(y2, y3));
  }
}

// the tensor maps of the GEMM's operands: A [M, Kc] and B [Nout, Kc] int8,
// row-major, 128-byte swizzle
inline bool gemm_maps(CUtensorMap* am, CUtensorMap* bm, const void* a, const void* b, int M,
                      int Nout, int Kc) {
  return encode_2d_cached(am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, M, Kc, BM, BK,
                          CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_2d_cached(bm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, Nout, Kc, BN, BK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

// launches `kernel` (a gemm_body wrapper) over the grid, then, split, `reduce`
template <typename Gemm, typename Reduce>
cudaError_t gemm_launch(Gemm kernel, Reduce reduce, const CUtensorMap& am, const CUtensorMap& bm,
                        const float* srow, const float* scol, void* out, int* ws, int M,
                        int Nout, int Kc, int splits, int out_f32, cudaStream_t stream) {
  static bool attr = false;  // one GEMM kernel per translation unit
  cudaError_t e;
  if (!attr) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((M + BM - 1) / BM, (Nout + BN - 1) / BN, splits);
  kernel<<<grid, NTHREADS, SMEM, stream>>>(am, bm, srow, scol, out, ws, M, Nout, Kc, splits,
                                           out_f32);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n4 = (long long)M * Nout / 4;
  reduce<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(ws, srow, scol, out, M, Nout, splits,
                                                           out_f32);
  return cudaGetLastError();
}

}  // namespace rq

}  // namespace
