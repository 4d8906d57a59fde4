"""The W8A8-dynamic matmul on the card (`quantize.dtype: int8_dynamic`, JAX's
`kernel_q_dyn`).

Not a TPU kernel: the JAX package runs `dyn_int8_matmul`
(qflux_tpu/ops/quant.py:157-200) in XLA.  Its plain version here is
`quant.dyn_int8_matmul`, which equals JAX's under `jit` to the bit; the
card route computes the same bits with the port's own kernels:

  * forward: the row quantization of x (`int4_matmul.rowquant`,
    csrc/rowquant.cu), then the int8 `wgmma` GEMM of
    csrc/rq_int4_common.cuh on xq [M, K] and the weight q [N, K] itself
    (`qflux_int8_gemm` in csrc/int8_gemm.cu), epilogue (f32(acc) · sx) ·
    s_w, in x.dtype;
  * dx (the op's registered autograd formula): the row quantization of
    g · s_w, the weight transposed into a scratch (`qflux_int8_transpose`:
    int8 `wgmma` reads both operands K-major, and the dx contracts over N),
    then the same GEMM with the epilogue f32(acc) · sg, in g.dtype.

The split of the narrow grids' contraction is K5a's and K5b's
(`int4_matmul._rq_plan`), and so is the scratch (`_rq_buffers`: the
transposed weight at its start, the split partial sums after it).
`dyn_int8_matmul(x, q, s_vec)`: a CPU tensor takes the plain version; a
CUDA tensor calls the custom op `qflux::int8_dyn_fwd` (a remat save point,
as K5a's: `quant.kept_product`) or raises, on a shape
the GEMM does not take too (K % 64, N % 16; any length, the AdaLN mods'
N = 18,432 included: the dx row-quantizes g over N).
`INT8_GEMM_LAUNCHES` counts the forward GEMM's launches,
`INT8_GEMM_DX_LAUNCHES` the dx GEMM's, `INT8_TRANSPOSE_LAUNCHES` the
transpose's; the row quantizations count in `int4_matmul.ROWQUANT_LAUNCHES`.
"""

from __future__ import annotations

import dataclasses

import torch

from qflux_tpu_torch.ops import int4_matmul as i4
from qflux_tpu_torch.ops.quant import dyn_int8_matmul as dyn_int8_matmul_plain
from qflux_tpu_torch.ops.quant import kept_product

INT8_GEMM_LAUNCHES = 0       # the W8A8 forward GEMM, csrc/int8_gemm.cu
INT8_GEMM_DX_LAUNCHES = 0    # its dx GEMM
INT8_TRANSPOSE_LAUNCHES = 0  # the weight transpose before the dx GEMM


def check_shape(k_in: int, n_out: int) -> None:
    """Raise unless the W8A8 GEMM takes a [N, K] weight: K % 64 == 0 and
    N % 16 == 0 (the TMA tiles' rows, both directions), both positive."""
    if k_in % 64 or n_out % 16 or k_in <= 0 or n_out <= 0:
        raise ValueError(f"dyn_int8_matmul: K={k_in}, N={n_out}; the kernel takes K % 64 == 0 "
                         "and N % 16 == 0")


def _checks(what, t, q, out_dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on CUDA tensors, got {t.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: output dtype {out_dtype}; the kernel writes bfloat16 or "
                         "float32")
    n, k_in = q.shape
    check_shape(k_in, n)
    i4._check("q", q, t.device, torch.int8, (n, k_in), what)
    return n, k_in


def _launch(lib, stream, a, b, srow, scol, out, plan, ws):
    m, kc = a.shape
    code = lib.lib.qflux_int8_gemm(a.data_ptr(), b.data_ptr(), srow.data_ptr(),
                                   None if scol is None else scol.data_ptr(), out.data_ptr(), m,
                                   out.shape[1], kc, int(out.dtype == torch.float32),
                                   plan.splits, ws, stream)
    lib.check(code, "int8_gemm launch")


def int8_gemm_cuda(xq, q, sx, s_vec, out_dtype):
    """The forward GEMM on CUDA tensors: xq [M, K] int8, q [N, K] int8, sx [M]
    (or [M, 1]) f32, s_vec [N] f32 → (f32(xq · qᵀ) · sx) · s_vec [M, N] in
    out_dtype (bf16 or f32).  Raises on anything the kernel does not take and
    on a CUDA error.  Counting is the caller's."""
    what = "dyn_int8_matmul"
    n, k_in = _checks(what, xq, q, out_dtype)
    m = xq.shape[0]
    dev = xq.device
    sx = sx.reshape(m)
    i4._check("xq", xq, dev, torch.int8, (m, k_in), what)
    i4._check("sx", sx, dev, torch.float32, (m,), what)
    i4._check("s_vec", s_vec, dev, torch.float32, (n,), what)
    from qflux_tpu_torch.runtime.build import load_library

    lib = load_library()
    plan = dataclasses.replace(i4._rq_device_plan(dev.index or 0, m, n, k_in, k_in, False),
                               scratch=0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((m, n), device=dev, dtype=out_dtype)
    _launch(lib, stream, xq, q, sx, s_vec, out, plan, i4._rq_buffers(dev, stream, plan)[1])
    return out


def int8_transpose_cuda(q):
    """qᵀ [K, N] of a CUDA int8 q [N, K], written into the per-(device,
    stream) scratch (valid until the next W8A8 dx, K5a or K5b call on the
    stream).  Raises on anything the kernel does not take and on a CUDA
    error.  Counting is the caller's."""
    what = "dyn_int8_matmul backward"
    n, k_in = _checks(what, q, q, torch.float32)
    dev = q.device
    from qflux_tpu_torch.runtime.build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = i4._rq_buffers(dev, stream, i4.RqPlan(splits=1, workspace=0, scratch=k_in * n))[0]
    buf = i4._RQ_SCRATCH[(dev.index, stream)]
    lib.check(lib.lib.qflux_int8_transpose(q.data_ptr(), ptr, n, k_in, stream),
              "int8_transpose launch")
    return buf[:k_in * n].view(torch.int8).view(k_in, n)


def int8_gemm_dx_cuda(gq, qt, sg, out_dtype):
    """The dx GEMM on CUDA tensors: gq [M, N] int8 (the row-quantized g ·
    s_vec), qt [K, N] int8 (`int8_transpose_cuda`), sg [M] (or [M, 1]) f32 →
    f32(gq · qtᵀ) · sg [M, K] in out_dtype.  The split partial sums go to
    the scratch after qt.  Raises on anything the kernel does not take and
    on a CUDA error.  Counting is the caller's."""
    what = "dyn_int8_matmul backward"
    k_in, n = qt.shape
    check_shape(k_in, n)
    if gq.device.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on CUDA tensors, got {gq.device}")
    m = gq.shape[0]
    dev = gq.device
    sg = sg.reshape(m)
    i4._check("gq", gq, dev, torch.int8, (m, n), what)
    i4._check("qt", qt, dev, torch.int8, (k_in, n), what)
    i4._check("sg", sg, dev, torch.float32, (m,), what)
    from qflux_tpu_torch.runtime.build import load_library

    lib = load_library()
    plan = i4._rq_device_plan(dev.index or 0, m, n, k_in, k_in, True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dx = torch.empty((m, k_in), device=dev, dtype=out_dtype)
    _launch(lib, stream, gq, qt, sg, None, dx, plan, i4._rq_buffers(dev, stream, plan)[1])
    return dx


# The custom op runs on every device type: on a CUDA tensor it launches the
# row quantization and the GEMM, on any other `int8_gemm_cuda` raises (the
# public entry point sends CPU tensors to the plain version first).
@torch.library.custom_op("qflux::int8_dyn_fwd", mutates_args=(),
                         schema="(Tensor x, Tensor q, Tensor s_vec) -> Tensor")
def _int8_fwd_op(x, q, s_vec):
    def launch():
        global INT8_GEMM_LAUNCHES
        check_shape(q.shape[1], q.shape[0])
        xq, sx = i4.rowquant(x.reshape(-1, x.shape[-1]))
        y = int8_gemm_cuda(xq, q, sx, s_vec, x.dtype)
        INT8_GEMM_LAUNCHES += 1
        return y.reshape(*x.shape[:-1], q.shape[0])

    return kept_product(x, q.shape[0], launch)


def _int8_setup_context(ctx, inputs, output):
    # the residuals of _dyn_vjp_fwd: the frozen weight, by reference
    _, q, s_vec = inputs
    ctx.save_for_backward(q, s_vec)


def _int8_backward(ctx, g):
    """dx as `_dyn_vjp_bwd`: g · s_vec row-quantized (csrc/rowquant.cu), the
    weight transposed, the exact product scaled by the row scales, in g's
    dtype.  q and the scales get no gradient."""
    global INT8_GEMM_DX_LAUNCHES, INT8_TRANSPOSE_LAUNCHES
    q, s_vec = ctx.saved_tensors
    gq, sg = i4.rowquant(g.reshape(-1, g.shape[-1]), s_vec)
    qt = int8_transpose_cuda(q)
    INT8_TRANSPOSE_LAUNCHES += 1
    dx = int8_gemm_dx_cuda(gq, qt, sg, g.dtype)
    INT8_GEMM_DX_LAUNCHES += 1
    return dx.reshape(*g.shape[:-1], q.shape[1]), None, None


torch.library.register_autograd("qflux::int8_dyn_fwd", _int8_backward,
                                setup_context=_int8_setup_context)


def dyn_int8_matmul(x, q, s_vec):
    """W8A8-dynamic: x [..., K] float; q [N, K] int8; s_vec [N] f32 → [..., N]
    in x.dtype, differentiable in x (straight through).  CUDA tensors launch
    the row quantization and the forward GEMM (and, in the backward, the row
    quantization, the transpose and the dx GEMM) or raise; CPU tensors take
    the plain version, `quant.dyn_int8_matmul`."""
    if x.device.type == "cpu":
        return dyn_int8_matmul_plain(x, q, s_vec)
    return _int8_fwd_op(x, q, s_vec)
