"""Flash attention with qk-RMSNorm + RoPE fused in: kernel K1 of the port.

Counterpart of qflux_tpu/ops/flash_nr.py.  Three parts:

  * `apply_qk_norm_rope` — the plain composition (per-head RMSNorm with the
    scale row chosen by the txt/img boundary `st`, then rotate-half rope),
    including the intermediate x.dtype casts of the JAX forward;
  * `flash_attention_nr_reference` — the plain PyTorch version of the whole
    kernel (norm + rope on q and k, then `sdpa_reference`'s math), returning out and
    lse.  CPU tensors take it; on the card it is only the comparison point;
  * `flash_attention_nr` — the wrapper of the hand-written Hopper kernel
    `csrc/flash_nr_fwd.cu`.  A CUDA tensor launches the kernel or raises;
    nothing falls back.  `KERNEL_LAUNCHES` counts the launches.

Only the forward is ported: the backward kernel (K2) and the `s_int8` score
GEMM are still to port (ROADMAP.md, "TPU kernels to port").
"""

from __future__ import annotations

import torch

from qflux_tpu_torch.ops.attention import sdpa_with_lse

EPS = 1e-6
HEAD_DIM = 128  # the only head dim the kernel takes (every FLUX/Qwen shape)

# launches of the CUDA kernel in this process; the wrapper adds one per launch
KERNEL_LAUNCHES = 0


def apply_qk_norm_rope(x, scale2, cos, sin, st, eps=EPS):
    """Per-head RMSNorm (scale2[0] for positions < st, scale2[1] after) then
    rotate-half rope.  x [B,S,H,D]; cos/sin [S,D] or [B,S,D].  Matches
    rms_norm → rope exactly, including the intermediate x.dtype casts."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    xf = x.float()
    u = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    sel = (torch.arange(x.shape[1], device=x.device) < st)[None, :, None, None]
    s_sel = torch.where(sel, scale2[0].float()[None, None, None, :],
                        scale2[1].float()[None, None, None, :])
    us = (u * s_sel).to(x.dtype).float()
    h = x.shape[-1] // 2
    rot = torch.cat([-us[..., h:], us[..., :h]], dim=-1)
    cb = cos.float()[:, :, None, :]
    sb = sin.float()[:, :, None, :]
    return (us * cb + rot * sb).to(x.dtype)


def flash_attention_nr_reference(q, k, v, q_scale2, k_scale2, cos, sin, st,
                                 segment_ids=None, scale=None):
    """Plain version of the kernel: (out [B,S,H,D] in q.dtype, lse [B,H,S]
    f32).  Fully masked rows output 0 with lse = NEG_INF, as the kernel."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qn = apply_qk_norm_rope(q, q_scale2, cos, sin, st)
    kn = apply_qk_norm_rope(k, k_scale2, cos, sin, st)
    return sdpa_with_lse(qn, kn, v, segment_ids=segment_ids, scale=scale)


def _check(name, t, device, dtype, shape=None):
    if t.device != device:
        raise ValueError(f"flash_attention_nr: {name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention_nr: {name} is {t.dtype}, the kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention_nr: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention_nr: {name} is not contiguous")


def _kernel_args(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids):
    """Check the inputs against what csrc/flash_nr_fwd.cu takes and return
    (f32 scale pairs, cos/sin batch stride, int32 segment ids or None).
    Raises on a dtype other than bf16, D != 128, cross attention, a tensor
    on another device than q, a wrong shape, or a q/k/v/cos/sin that is not
    contiguous or not 16-byte aligned."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention_nr: q must be [B, S, H, D], got {tuple(q.shape)}")
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention_nr: head dim {d}; the kernel takes {HEAD_DIM}")
    if k.shape[1] != s:
        raise ValueError(f"flash_attention_nr: sq={s} != sk={k.shape[1]}; the fused "
                         "norm+rope path is self-attention only")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev, torch.bfloat16, (b, s, h, d))
    for name, t in (("q", q), ("k", k), ("v", v), ("cos", cos), ("sin", sin)):
        if t.data_ptr() % 16:  # the kernel loads 16-byte vectors
            raise ValueError(f"flash_attention_nr: {name} is not 16-byte aligned")
    # the [2, D] scale pairs are tiny: widen to f32 (the kernel's math type)
    qs = q_scale2.to(torch.float32).contiguous()
    ks = k_scale2.to(torch.float32).contiguous()
    _check("q_scale2", qs, dev, torch.float32, (2, d))
    _check("k_scale2", ks, dev, torch.float32, (2, d))
    _check("cos", cos, dev, torch.float32)
    _check("sin", sin, dev, torch.float32, tuple(cos.shape))
    if tuple(cos.shape) == (s, d):
        cs_bstride = 0
    elif tuple(cos.shape) == (b, s, d):
        cs_bstride = s * d
    else:
        raise ValueError(f"flash_attention_nr: cos/sin {tuple(cos.shape)}, expected "
                         f"{(s, d)} or {(b, s, d)}")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
        _check("segment_ids", seg, dev, torch.int32, (b, s))
    return qs, ks, cs_bstride, seg


def _flash_nr_cuda(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale):
    """Launch csrc/flash_nr_fwd.cu on CUDA tensors; raises on anything the
    kernel does not take (`_kernel_args`) and on a CUDA error."""
    global KERNEL_LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nr: the kernel runs on CUDA tensors, got {q.device}")
    qs, ks, cs_bstride, seg = _kernel_args(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids)
    b, s, h, _ = q.shape

    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kl.lib.qflux_flash_nr_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), cs_bstride,
        seg.data_ptr() if seg is not None else None,
        out.data_ptr(), lse.data_ptr(), b, s, h, int(st), float(scale), stream)
    kl.check(code, "flash_nr_fwd launch")
    KERNEL_LAUNCHES += 1
    return out, lse


def flash_attention_nr(q, k, v, q_scale2, k_scale2, cos, sin, st,
                       segment_ids=None, scale=None, s_int8=False):
    """Fused qk-RMSNorm + RoPE + flash attention over [B, S, H, D] RAW q/k.

    q_scale2/k_scale2: [2, D] norm scales (row 0 for positions < st, row 1
    after — dual-stream txt/img; repeat the row for single-stream).
    cos/sin: [S, D] or [B, S, D] rotate-half tables (f32).
    segment_ids: optional [B, S] int (0 = padding; equal nonzero ids attend).
    Returns (out [B, S, H, D], lse [B, H, S] f32).

    CUDA tensors run the Hopper kernel (any S: K is tiled, the ragged edge
    masked by index); CPU tensors run `flash_attention_nr_reference`.
    """
    if s_int8:
        raise NotImplementedError(
            "flash_attention_nr(s_int8=True): the int8 score GEMM of K1 is not "
            "ported yet (ROADMAP.md, TPU kernels to port: K1 s_int8)")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_nr_reference(q, k, v, q_scale2, k_scale2, cos, sin,
                                            st, segment_ids=segment_ids, scale=scale)
    return _flash_nr_cuda(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale)
