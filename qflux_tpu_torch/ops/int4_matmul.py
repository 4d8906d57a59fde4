"""The fused W4A8-requant matmul: kernels K5a (forward) and K5b (backward) of the port.

Counterpart of the K5 half of qflux_tpu/ops/int4_matmul.py (`_rq_fwd_kernel`,
`_rq_fwd`, `_rq_bwd_kernel`, `_rq_bwd`) and of `quant.rq_fused_matmul` with
its vjp.  The TPU kernels regrid each packed-int4 weight tile onto the
per-channel int8 grid in VMEM and feed it to the int8 MXU, so q8 never
reaches HBM; the Hopper kernels (`csrc/rq_int4_fwd.cu`, `csrc/rq_int4_bwd.cu`)
do the same in registers and shared memory with `mma.sync` s8·s8 → s32.

`rq_fused_matmul(x, q4, g_scale)`: on a CUDA tensor it calls the custom op
`qflux::rq_int4_fwd`, which row-quantizes x with plain torch ops (as
`_rq_fused_prep` keeps that step in XLA) and launches K5a, or raises; the
op's registered autograd formula scales the cotangent by the channel scales,
row-quantizes it (plain torch again, as JAX) and launches K5b, or raises.  On
a CPU tensor it runs the plain version, `quant.requant_int4_matmul`, which
both kernels equal bit for bit.  The TPU's tiling gates (`RQ_BLOCK_*`,
`rq_supports`, `_pad_to`) are not needed: the kernels mask ragged M, N and K
and take every int4-requant shape of the model (K a multiple of 64, N of 8,
the group size of 4).  `RQ_KERNEL_LAUNCHES` counts K5a's launches,
`RQ_BWD_KERNEL_LAUNCHES` K5b's.  The forward is a custom op (not a Python
autograd.Function) so that a selective-checkpoint policy sees it, as it sees
K1.
"""

from __future__ import annotations

import torch

from qflux_tpu_torch.ops.quant import _requant_factors, _rowquant, requant_int4_matmul

RQ_KERNEL_LAUNCHES = 0      # K5a, csrc/rq_int4_fwd.cu
RQ_BWD_KERNEL_LAUNCHES = 0  # K5b, csrc/rq_int4_bwd.cu


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"rq_fused_matmul: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"rq_fused_matmul: {name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rq_fused_matmul: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"rq_fused_matmul: {name} is not contiguous and 16-byte aligned")


def kernel_group_size(k_in: int, n_out: int, n_groups: int) -> int:
    """The group size K5a and K5b use for a [K/2, N] weight with `n_groups`
    groups; raises on a shape the kernels do not take."""
    if k_in % 64 or n_out % 8 or n_groups <= 0 or k_in % n_groups or (k_in // n_groups) % 4:
        raise ValueError(f"rq_fused_matmul: K={k_in}, N={n_out}, {n_groups} groups; the "
                         "kernel takes K % 64 == 0, N % 8 == 0 and a group size that is a "
                         "multiple of 4")
    return k_in // n_groups


def _check_common(what, t, q4, f, out_dtype):
    """The rules K5a and K5b share; returns (half, N, group size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on CUDA tensors, got {t.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: output dtype {out_dtype}; the kernel writes bfloat16 or "
                         "float32")
    half, n = q4.shape
    gsz = kernel_group_size(2 * half, n, f.shape[0])
    _check("q4", q4, t.device, torch.int8, (half, n))
    _check("f", f, t.device, torch.float32, (2 * half // gsz, n))
    return half, n, gsz


def rq_int4_fwd_cuda(xq, q4, f, sx, s_vec, out_dtype):
    """Launch K5a on CUDA tensors: xq [M, K] int8, q4 [K/2, N] int8, f [K/G,
    N] f32, sx [M] (or [M, 1]) f32, s_vec [N] f32 → [M, N] in out_dtype
    (bf16 or f32).  Raises on anything the kernel does not take and on a
    CUDA error.  Counting is the caller's."""
    half, n, gsz = _check_common("rq_fused_matmul", xq, q4, f, out_dtype)
    m, k_in = xq.shape
    if 2 * half != k_in:
        raise ValueError(f"rq_fused_matmul: x has K={k_in}, q4 {tuple(q4.shape)}")
    dev = xq.device
    sx = sx.reshape(m)
    _check("xq", xq, dev, torch.int8, (m, k_in))
    _check("sx", sx, dev, torch.float32, (m,))
    _check("s_vec", s_vec, dev, torch.float32, (n,))

    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    out = torch.empty((m, n), device=dev, dtype=out_dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = kl.lib.qflux_rq_int4_fwd(xq.data_ptr(), q4.data_ptr(), f.data_ptr(), sx.data_ptr(),
                                    s_vec.data_ptr(), out.data_ptr(), m, n, k_in, gsz,
                                    int(out_dtype == torch.float32), stream)
    kl.check(code, "rq_int4_fwd launch")
    return out


def rq_int4_bwd_cuda(gq, q4, f, sg, out_dtype):
    """Launch K5b on CUDA tensors: gq [M, N] int8 (the row-quantized g ·
    s_vec), q4 [K/2, N] int8, f [K/G, N] f32, sg [M] (or [M, 1]) f32 → dx
    [M, K] in out_dtype (bf16 or f32).  Raises on anything the kernel does
    not take and on a CUDA error.  Counting is the caller's."""
    half, n, gsz = _check_common("rq_fused_matmul backward", gq, q4, f, out_dtype)
    m = gq.shape[0]
    dev = gq.device
    sg = sg.reshape(m)
    _check("gq", gq, dev, torch.int8, (m, n))
    _check("sg", sg, dev, torch.float32, (m,))

    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    dx = torch.empty((m, 2 * half), device=dev, dtype=out_dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = kl.lib.qflux_rq_int4_bwd(gq.data_ptr(), q4.data_ptr(), f.data_ptr(), sg.data_ptr(),
                                    dx.data_ptr(), m, n, 2 * half, gsz,
                                    int(out_dtype == torch.float32), stream)
    kl.check(code, "rq_int4_bwd launch")
    return dx


# The custom op runs on every device type: on a CUDA tensor it launches K5a,
# on any other `rq_int4_fwd_cuda` raises (the public entry point sends CPU
# tensors to the plain version before they reach it).
@torch.library.custom_op("qflux::rq_int4_fwd", mutates_args=(),
                         schema="(Tensor x, Tensor q4, Tensor f, Tensor s_vec) -> Tensor")
def _rq_fwd_op(x, q4, f, s_vec):
    global RQ_KERNEL_LAUNCHES
    xq, sx = _rowquant(x.reshape(-1, x.shape[-1]))
    y = rq_int4_fwd_cuda(xq, q4, f, sx, s_vec, x.dtype)
    RQ_KERNEL_LAUNCHES += 1
    return y.reshape(*x.shape[:-1], q4.shape[-1])


def _rq_setup_context(ctx, inputs, output):
    # the residuals of _rqf_vjp_fwd: the frozen weight, by reference
    _, q4, f, s_vec = inputs
    ctx.save_for_backward(q4, f, s_vec)


def _rq_backward(ctx, g):
    """dx through K5b, as `_rqf_vjp_bwd`: gs = f32(g) · s_vec row-quantized
    (plain torch), K5b's exact integer product scaled by the row scales, in
    g's dtype.  q4 and the factors get no gradient."""
    global RQ_BWD_KERNEL_LAUNCHES
    q4, f, s_vec = ctx.saved_tensors
    gq, sg = _rowquant(g.reshape(-1, g.shape[-1]).float() * s_vec)
    dx = rq_int4_bwd_cuda(gq, q4, f, sg, g.dtype)
    RQ_BWD_KERNEL_LAUNCHES += 1
    return dx.reshape(*g.shape[:-1], dx.shape[-1]), None, None, None


torch.library.register_autograd("qflux::rq_int4_fwd", _rq_backward,
                                setup_context=_rq_setup_context)


def rq_fused_matmul(x, q4, g_scale, factors=None):
    """y = x @ dequant(q4, g_scale) on the W4A8-requant grid: x [..., K]
    float; q4 [K/2, N] half-split packed int4; g_scale [K/G, N] f32 →
    [..., N] in x.dtype, differentiable in x.  `factors` = (f, s_vec) from
    `_requant_factors`, if cached.  CUDA tensors launch K5a (and K5b in the
    backward) or raise; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return requant_int4_matmul(x, q4, g_scale, factors)
    f, s_vec = factors if factors is not None else _requant_factors(g_scale)
    return _rq_fwd_op(x, q4, f, s_vec)
