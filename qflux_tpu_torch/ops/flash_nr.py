"""Flash attention with qk-RMSNorm + RoPE fused in: kernels K1 and K2 of the port.

Counterpart of qflux_tpu/ops/flash_nr.py.  The parts:

  * `apply_qk_norm_rope` — the plain composition (per-head RMSNorm with the
    scale row chosen by the txt/img boundary `st`, then rotate-half rope),
    including the intermediate x.dtype casts of the JAX forward;
  * `flash_attention_nr_reference` — the plain PyTorch version of the whole
    forward (norm + rope on q and k, then `sdpa_reference`'s math), returning
    out and lse.  CPU tensors take it (autograd differentiates it); on the
    card it is only the comparison point;
  * `flash_attention_nr_bwd_reference` — the plain version of the backward:
    f32 autograd through the plain forward;
  * `flash_attention_nr` — the wrapper of the hand-written Hopper kernels.
    On CUDA tensors it calls the custom op `qflux::flash_nr_fwd`, which
    launches K1 (`csrc/flash_nr_fwd.cu`); its registered autograd formula
    launches K2 (`csrc/flash_nr_bwd.cu`), as the JAX `custom_vjp` runs
    `_fwd_nr` / `_bwd_nr`.  Each launches its kernel or raises; nothing falls
    back.  `KERNEL_LAUNCHES` counts K1's launches, `BWD_KERNEL_LAUNCHES`
    K2's.  The forward is a `torch.library.custom_op` (not a Python
    autograd.Function) so that a selective-checkpoint policy can see it and
    save its out and lse (the "flash" remat policy,
    models/flux/transformer.py);
  * `offload_contexts` — the "flash_offload" remat policy's pair of
    checkpoint contexts: in a checkpointed region's forward the op copies
    K1's out and lse to pinned host memory; in the region's recompute it
    returns them to the device instead of launching K1 again, so backward
    runs K2 on the same residuals as under "flash" while the device holds
    none of them in between.

The `s_int8` score GEMM of K1 is still to port (ROADMAP.md, "TPU kernels to
port").
"""

from __future__ import annotations

import contextlib
import threading

import torch

from qflux_tpu_torch.ops.attention import sdpa_with_lse

EPS = 1e-6
HEAD_DIM = 128  # the only head dim the kernels take (every FLUX/Qwen shape)

# launches of the CUDA kernels in this process; the custom op and its
# backward add one per launch
KERNEL_LAUNCHES = 0      # K1, csrc/flash_nr_fwd.cu
BWD_KERNEL_LAUNCHES = 0  # K2, csrc/flash_nr_bwd.cu


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


def flash_attention_nr_bwd_reference(q, k, v, q_scale2, k_scale2, cos, sin, st, do,
                                     segment_ids=None, scale=None):
    """Plain version of K2: f32 autograd through `flash_attention_nr_reference`
    on upcast copies of the inputs.  Returns (dq, dk, dv, dq_scale2,
    dk_scale2), all f32.  In f32 the forward's intermediate casts are the
    identity, so this is the exact gradient the kernel approximates (the
    JAX kernel likewise keeps its gradients in f32 through the rope/norm
    chain).  Padded rows get zero gradients whatever `do` holds there."""
    with torch.enable_grad():
        xs = [t.detach().float().requires_grad_() for t in (q, k, v, q_scale2, k_scale2)]
        out, _ = flash_attention_nr_reference(*xs, cos.float(), sin.float(), st,
                                              segment_ids=segment_ids, scale=scale)
        return torch.autograd.grad(out, xs, do.float())


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


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:  # the kernels load 16-byte vectors
            raise ValueError(f"flash_attention_nr: {name} is not 16-byte aligned")


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
    _check_aligned(q=q, k=k, v=v, cos=cos, sin=sin)
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
    """Launch K1 (csrc/flash_nr_fwd.cu) on CUDA tensors → (out, lse); raises
    on anything the kernel does not take (`_kernel_args`) and on a CUDA
    error.  Counting is the caller's (`_flash_nr_fwd_op`)."""
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
    return out, lse


def _flash_nr_bwd_cuda(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale,
                       out, lse, do):
    """Launch K2 (csrc/flash_nr_bwd.cu) on CUDA tensors → (dq, dk, dv in
    q.dtype, dq_scale2, dk_scale2 f32 [2, D]); raises as `_flash_nr_cuda`.
    The kernel writes one [2, D] scale-gradient partial per (b, h, 64-row
    tile); they are summed here, as `_bwd_nr` sums its per-(b, h) ones."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nr backward: the kernel runs on CUDA tensors, "
                         f"got {q.device}")
    qs, ks, cs_bstride, seg = _kernel_args(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids)
    b, s, h, d = q.shape
    _check("out", out, q.device, q.dtype, q.shape)
    _check("do", do, q.device, q.dtype, q.shape)
    _check("lse", lse, q.device, torch.float32, (b, h, s))
    _check_aligned(out=out, do=do)

    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    qn, kn = torch.empty_like(q), torch.empty_like(k)  # scratch: normed + roped q / k
    delta = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_tiles = kl.lib.qflux_flash_nr_bwd_tiles(s)
    dqs_p = torch.empty((b, h, n_tiles, 2, d), device=q.device, dtype=torch.float32)
    dks_p = torch.empty_like(dqs_p)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kl.lib.qflux_flash_nr_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), cs_bstride,
        seg.data_ptr() if seg is not None else None,
        out.data_ptr(), lse.data_ptr(), do.data_ptr(), qn.data_ptr(), kn.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dqs_p.data_ptr(),
        dks_p.data_ptr(), b, s, h, int(st), float(scale), stream)
    kl.check(code, "flash_nr_bwd launch")
    return dq, dk, dv, dqs_p.sum(dim=(0, 1, 2)), dks_p.sum(dim=(0, 1, 2))


class _OffloadStore:
    """K1's (out, lse) of one checkpointed region, in host memory (pinned
    for CUDA tensors) from the region's forward to its recompute, in call
    order."""

    def __init__(self):
        self.saved = []
        self.next = 0

    def put(self, out, lse):
        pin = out.is_cuda
        self.saved.append([torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(
            t, non_blocking=pin) for t in (out, lse)])

    def take(self, device):
        out, lse = self.saved[self.next]
        self.next += 1
        if device.type == "cpu":  # the op's outputs are fresh tensors
            return out.clone(), lse.clone()
        return out.to(device, non_blocking=True), lse.to(device, non_blocking=True)


_OFFLOAD = threading.local()  # .state: (store, replaying) inside a "flash_offload" region


@contextlib.contextmanager
def _offload_mode(store: _OffloadStore, replaying: bool):
    prev = getattr(_OFFLOAD, "state", None)
    store.next = 0
    _OFFLOAD.state = (store, replaying)
    try:
        yield
    finally:
        _OFFLOAD.state = prev


def offload_contexts():
    """The `context_fn` of torch.utils.checkpoint for the "flash_offload"
    policy (JAX's save_and_offload_only_these_names("flash_out",
    "flash_lse") to pinned_host): (forward context, recompute context) over
    one fresh store.  The recompute context runs in whichever thread the
    autograd engine recomputes in, and the state is per thread."""
    store = _OffloadStore()
    return _offload_mode(store, False), _offload_mode(store, True)


# The custom op runs on every device type: on a CUDA tensor it launches K1,
# on any other `_flash_nr_cuda` raises (the public entry point sends CPU
# tensors to the plain version before they reach it).  Inside a
# "flash_offload" region it stores its outputs in host memory, and in the
# region's recompute it returns them instead of launching.
@torch.library.custom_op(
    "qflux::flash_nr_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor q_scale2, Tensor k_scale2, Tensor cos, "
           "Tensor sin, Tensor? segment_ids, int st, float scale) -> (Tensor, Tensor)")
def _flash_nr_fwd_op(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids, st, scale):
    global KERNEL_LAUNCHES
    state = getattr(_OFFLOAD, "state", None)
    if state is not None and state[1]:
        return state[0].take(q.device)
    out, lse = _flash_nr_cuda(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale)
    KERNEL_LAUNCHES += 1
    if state is not None:
        state[0].put(out, lse)
    return out, lse


def _fwd_setup_context(ctx, inputs, output):
    # the residuals of _flash_nr_fwd (qflux_tpu/ops/flash_nr.py:533-539)
    q, k, v, qs, ks, cos, sin, seg, st, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, qs, ks, cos, sin, seg, out, lse)
    ctx.st, ctx.scale = st, scale


def _fwd_backward(ctx, dout, _dlse):
    """K2 from the saved residuals; lse is a residual, not differentiated
    (as in the JAX custom_vjp, whose primal returns out alone)."""
    global BWD_KERNEL_LAUNCHES
    q, k, v, qs, ks, cos, sin, seg, out, lse = ctx.saved_tensors
    dq, dk, dv, dqs, dks = _flash_nr_bwd_cuda(q, k, v, qs, ks, cos, sin, ctx.st, seg,
                                              ctx.scale, out, lse, dout.contiguous())
    BWD_KERNEL_LAUNCHES += 1
    return (dq, dk, dv, dqs.to(qs.dtype), dks.to(ks.dtype), None, None, None, None, None)


torch.library.register_autograd("qflux::flash_nr_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)
FWD_OP = torch.ops.qflux.flash_nr_fwd.default  # what a checkpoint policy sees


def _flash_attention_nr_op(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale):
    """The kernel path: the custom op on the scale pairs widened to f32 and
    the segment ids as int32 (what the kernels take; the casts are
    differentiable, so the scale gradients come back in the scales' dtype).
    lse is returned detached."""
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    out, lse = _flash_nr_fwd_op(q, k, v, q_scale2.to(torch.float32),
                                k_scale2.to(torch.float32), cos, sin, seg, int(st),
                                float(scale))
    return out, lse.detach()


def flash_attention_nr(q, k, v, q_scale2, k_scale2, cos, sin, st,
                       segment_ids=None, scale=None, s_int8=False):
    """Fused qk-RMSNorm + RoPE + flash attention over [B, S, H, D] RAW q/k.

    q_scale2/k_scale2: [2, D] norm scales (row 0 for positions < st, row 1
    after — dual-stream txt/img; repeat the row for single-stream).
    cos/sin: [S, D] or [B, S, D] rotate-half tables (f32).
    segment_ids: optional [B, S] int (0 = padding; equal nonzero ids attend).
    Returns (out [B, S, H, D], lse [B, H, S] f32).  Differentiable in q, k,
    v and the scale pairs.

    CUDA tensors run the Hopper kernels (any S: K is tiled, the ragged edge
    masked by index), K1 forward and K2 backward; CPU tensors run
    `flash_attention_nr_reference`, which autograd differentiates.
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
    return _flash_attention_nr_op(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids,
                                  scale)
