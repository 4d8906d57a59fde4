"""The fused W4A8-requant matmul: kernel K5a of the port.

Counterpart of the K5 half of qflux_tpu/ops/int4_matmul.py
(`_rq_fwd_kernel`, `_rq_fwd`) and of `quant.rq_fused_matmul`.  The TPU
kernel regrids each packed-int4 weight tile onto the per-channel int8 grid
in VMEM and feeds it to the int8 MXU, so q8 never reaches HBM; the Hopper
kernel (`csrc/rq_int4_fwd.cu`) does the same in registers and shared memory
with `mma.sync` s8·s8 → s32.

`rq_fused_matmul(x, q4, g_scale)`: on a CUDA tensor it row-quantizes x with
plain torch ops (as `_rq_fused_prep` keeps that step in XLA) and launches
K5a, or raises; on a CPU tensor it runs the plain version,
`quant.requant_int4_matmul`, which it equals bit for bit.  The TPU's tiling
gates (`RQ_BLOCK_*`, `rq_supports`, `_pad_to`) are not needed: the kernel
masks ragged M and N and takes every int4-requant shape of the model (K a
multiple of 64, N of 8, the group size of 4).  `RQ_KERNEL_LAUNCHES` counts
the kernel's launches.  Only the forward is ported (K5b, the backward, comes
with the Qwen train slice): under autograd the matmul raises.
"""

from __future__ import annotations

import torch

from qflux_tpu_torch.ops.quant import (_check_no_grad, _requant_factors, _rowquant,
                                       requant_int4_matmul)

RQ_KERNEL_LAUNCHES = 0  # K5a, csrc/rq_int4_fwd.cu


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"rq_fused_matmul: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"rq_fused_matmul: {name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rq_fused_matmul: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"rq_fused_matmul: {name} is not contiguous and 16-byte aligned")


def kernel_group_size(k_in: int, n_out: int, n_groups: int) -> int:
    """The group size K5a uses for a [K/2, N] weight with `n_groups` groups;
    raises on a shape the kernel does not take."""
    if k_in % 64 or n_out % 8 or n_groups <= 0 or k_in % n_groups or (k_in // n_groups) % 4:
        raise ValueError(f"rq_fused_matmul: K={k_in}, N={n_out}, {n_groups} groups; the "
                         "kernel takes K % 64 == 0, N % 8 == 0 and a group size that is a "
                         "multiple of 4")
    return k_in // n_groups


def rq_int4_fwd_cuda(xq, q4, f, sx, s_vec, out_dtype):
    """Launch K5a on CUDA tensors: xq [M, K] int8, q4 [K/2, N] int8, f [K/G,
    N] f32, sx [M] (or [M, 1]) f32, s_vec [N] f32 → [M, N] in out_dtype
    (bf16 or f32).  Raises on anything the kernel does not take and on a
    CUDA error.  Counting is the caller's."""
    if xq.device.type != "cuda":
        raise ValueError(f"rq_fused_matmul: the kernel runs on CUDA tensors, got {xq.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rq_fused_matmul: output dtype {out_dtype}; the kernel writes "
                         "bfloat16 or float32")
    m, k_in = xq.shape
    half, n = q4.shape
    if 2 * half != k_in:
        raise ValueError(f"rq_fused_matmul: x has K={k_in}, q4 {tuple(q4.shape)}")
    gsz = kernel_group_size(k_in, n, f.shape[0])
    dev = xq.device
    sx = sx.reshape(m)
    _check("xq", xq, dev, torch.int8, (m, k_in))
    _check("q4", q4, dev, torch.int8, (half, n))
    _check("f", f, dev, torch.float32, (k_in // gsz, n))
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


def rq_fused_matmul(x, q4, g_scale, factors=None):
    """y = x @ dequant(q4, g_scale) on the W4A8-requant grid: x [..., K]
    float; q4 [K/2, N] half-split packed int4; g_scale [K/G, N] f32 →
    [..., N] in x.dtype.  `factors` = (f, s_vec) from `_requant_factors`,
    if cached.  CUDA tensors launch K5a (or raise); CPU tensors take the
    plain version."""
    global RQ_KERNEL_LAUNCHES
    if x.device.type == "cpu":
        return requant_int4_matmul(x, q4, g_scale, factors)
    _check_no_grad(x, "rq_fused_matmul")
    f, s_vec = factors if factors is not None else _requant_factors(g_scale)
    xq, sx = _rowquant(x.reshape(-1, x.shape[-1]))
    y = rq_int4_fwd_cuda(xq, q4, f, sx, s_vec, x.dtype)
    RQ_KERNEL_LAUNCHES += 1
    return y.reshape(*x.shape[:-1], q4.shape[-1])
