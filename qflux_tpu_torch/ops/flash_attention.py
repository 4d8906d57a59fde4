"""Flash attention over q / k that are already normed and roped: kernels K3 and K4 of the port.

Counterpart of qflux_tpu/ops/flash_attention.py.  JAX runs it on one chip
wherever the fused K1 / K2 of ops/flash_nr.py do not apply
(`flash_nr.supports`: the whole K in one TPU block, padded S ≤ 2688 in bf16
and ≤ 2560 with the int8 score GEMM), after an XLA norm + rope: the
published Qwen 832×576 config (S = 4000) among them.  It is also the ring
hop's forward and backward.  The parts:

  * `flash_fwd_reference` — the plain K3: `ops/attention.py:sdpa_with_lse`'s
    math with separate q / kv segment ids → (out, lse).  CPU tensors take it
    (autograd differentiates it); on the card it is only the comparison
    point;
  * `flash_bwd_reference` — the plain K4, the explicit formula from the
    given residuals (not autograd through the forward: a ring hop hands the
    backward the GLOBAL out / lse, not the hop's own);
  * `flash_attention` — the model-layout entry point.  On CUDA tensors it
    calls the custom op `qflux::flash_fwd`, which launches K3
    (`csrc/flash_fwd.cu`); its registered autograd formula launches K4
    (`csrc/flash_bwd.cu`), as JAX's custom_vjp runs `_fwd` / `_bwd`.  Each
    launches its kernel or raises; nothing falls back.  `FWD_OP` is what a
    checkpoint policy sees;
  * `flash_fwd_with_lse` / `flash_bwd_from_residuals` — the ring hop's two
    entry points, without autograd, over the same kernels;
  * the op's body is a FLASH save point of ops/remat.py, shared with K1's
    op: in a checkpointed block whose policy keeps the attention outputs
    ("flash", "flash_offload", "flash_qkv", "flash_mlp"), the block's
    forward stores the op's out and lse and its recompute returns them
    instead of launching again.

The wgmma kernels take bf16 at head dims 128, 64 and 32 (their loops are
templated on the head dim; 64 and 32 are the "narrow" mode).  JAX's Pallas
kernels compute in f32 and cast to the refs' dtype, and take any head dim,
so the same route runs f32 (D = 32, 64, 128) too, chosen by `mode`: K3 and
K4 on the tensor cores as a 3xTF32 split (csrc/flash_f32_fwd.cu,
`qflux_f32_fwd`, and csrc/flash_f32_bwd.cu, `qflux_f32_bwd`: every f32
product as three TF32 products, f32-accurate).  A head dim below 128 that
no kernel takes (16, 48, 96, ...) runs at the next one they take, its
columns zero-padded in the CUDA launchers (`run_head_dim`: exact, since
zero columns add nothing to a score and the padded gradient columns are
sliced away) with the caller's scale; any other dtype, or a head dim above
128, raises.  Every mode reads q, k and v (the backward also do) by TMA, so
they must be 16-byte aligned.  `KERNEL_LAUNCHES` counts K3's
launches and `BWD_KERNEL_LAUNCHES` K4's in every mode; `F32_*` counts the
f32 mode among them and `NARROW_*` bf16 at D = 32 / 64.  The
kernels take every S and mask the ragged edge by index, so JAX's block
pickers (`_auto_block`, `BLOCK_K_CAP`, `BLOCK_K_CAP_BWD`,
`_merged_bwd_block_q`) are TPU tuners the port does not carry: K4 serves
JAX's merged (K4a) and split (K4b + K4c) backward alike.
"""

from __future__ import annotations

import torch

from qflux_tpu_torch.ops import remat
from qflux_tpu_torch.ops.attention import sdpa_with_lse, segment_mask

HEAD_DIM = 128             # the head dim of the "bf16" mode
HEAD_DIMS = (32, 64, 128)  # the head dims the kernels take, in f32 and in bf16

# launches of the CUDA kernels in this process: every K3 / K4 launch, whatever
# its mode, and apart the f32 mode (csrc/flash_f32_fwd.cu, csrc/flash_f32_bwd.cu)
# and the narrow bf16 mode among them, each under the head dim it ran at
KERNEL_LAUNCHES = 0             # K3
BWD_KERNEL_LAUNCHES = 0         # K4
F32_KERNEL_LAUNCHES = 0         # K3 in f32 (D = 32, 64, 128)
F32_BWD_KERNEL_LAUNCHES = 0     # K4 in f32
NARROW_KERNEL_LAUNCHES = 0      # K3 in bf16 at D = 32, 64 (the wgmma kernel)
NARROW_BWD_KERNEL_LAUNCHES = 0  # K4 in bf16 at D = 32, 64


def _segment_pair(q, q_seg, kv_seg):
    """JAX's `flash_attention` rule: no ids at all is the unmasked case
    (None, None); else missing q ids are all ones and missing kv ids are the
    q ids."""
    if q_seg is None and kv_seg is None:
        return None, None
    if q_seg is None:
        q_seg = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    return q_seg, (kv_seg if kv_seg is not None else q_seg)


def flash_fwd_reference(q, k, v, q_seg, kv_seg, scale):
    """Plain version of K3 over q [B, Sq, H, D] and k / v [B, Sk, H, D]:
    (out [B, Sq, H, D] in q.dtype, lse [B, H, Sq] f32).  Fully masked rows
    output 0 with lse = -1e30, as the kernel."""
    q_seg, kv_seg = _segment_pair(q, q_seg, kv_seg)
    return sdpa_with_lse(q, k, v, q_seg, kv_seg, scale)


def flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale):
    """Plain version of K4, the explicit formula of `_dqdkv_kernel` (and of
    `_dq_kernel` + `_dkv_kernel`) from the given residuals, in f32:

        p = exp(q k^T scale - lse), 0 by select where masked
        dv = bf16(p)^T do,  delta = rowsum(do out)
        ds = bf16(p (do v^T - delta) scale),  dq = ds k,  dk = ds^T q

    with p and ds rounded to do's / k's dtype as the TPU kernels do.  The
    select keeps a fully masked row (lse = -1e30, so exp gives +inf) at 0,
    whatever `do` holds there.  Returns (dq, dk, dv), all f32."""
    q_seg, kv_seg = _segment_pair(q, q_seg, kv_seg)
    qf, kf, dof = q.float(), k.float(), do.float()
    p = torch.einsum("bqhd,bkhd->bhqk", qf, kf).mul_(scale).sub_(lse[..., None]).exp_()
    if q_seg is not None:
        p = torch.where(segment_mask(q_seg, kv_seg), p, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)  # [B, H, Sq]
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, v.float()).sub_(delta[..., None])
    ds = ds.mul_(p).mul_(scale).to(k.dtype).float()
    del p
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf), torch.einsum("bhqk,bqhd->bkhd", ds, qf),
            dv)


def mode(q) -> str:
    """Which kernel takes q on the card, by its dtype and head dim: "bf16"
    (bf16 at D = 128) and "narrow" (bf16 at D = 32, 64) for the wgmma K3 /
    K4 of csrc/flash_fwd.cu / flash_bwd.cu, "f32" (D = 32, 64, 128) for the
    3xTF32 K3 / K4 of csrc/flash_f32_fwd.cu / flash_f32_bwd.cu.  Raises on
    anything else, naming what the kernels take (the launchers pad a head
    dim below 128 to one of them first: `run_head_dim`)."""
    d = q.shape[-1]
    if q.dtype in (torch.float32, torch.bfloat16) and d in HEAD_DIMS:
        if q.dtype == torch.float32:
            return "f32"
        return "bf16" if d == HEAD_DIM else "narrow"
    raise ValueError(f"flash_attention: {q.dtype} at head dim {d}; the kernels take "
                     f"torch.float32 or torch.bfloat16 at head dims {HEAD_DIMS}")


def run_head_dim(d: int) -> int | None:
    """The head dim the kernels run head dim d at: d where they take it,
    else the next of HEAD_DIMS above it (the launchers zero-pad the
    columns); None above 128, which no kernel takes."""
    return next((x for x in HEAD_DIMS if x >= d), None)


def pad_head(t, d):
    """t [..., D] with its last dim zero-padded to d (t itself at D = d)."""
    return t if t.shape[-1] == d else torch.nn.functional.pad(t, (0, d - t.shape[-1]))


def _padded_dim(q, *others):
    """The head dim to pad q and `others` to before a launch, or None: f32
    or bf16 tensors of one head dim below 128 that the kernels do not take.
    Anything else goes to the checks as it is (and raises there if no
    kernel takes it)."""
    d = q.shape[-1]
    if (q.dtype not in (torch.float32, torch.bfloat16) or d in HEAD_DIMS
            or run_head_dim(d) is None or any(t.shape[-1] != d for t in others)):
        return None
    return run_head_dim(d)


def _count(q, bwd):
    """One launch of K3 (K4 where bwd) in q's mode at the head dim it ran at
    (`run_head_dim`): the kernel's count, and the f32 or narrow mode's
    beside it."""
    name = "BWD_KERNEL_LAUNCHES" if bwd else "KERNEL_LAUNCHES"
    names = [name]
    if q.dtype == torch.float32:
        names.append("F32_" + name)
    elif run_head_dim(q.shape[-1]) != HEAD_DIM:
        names.append("NARROW_" + name)
    for n in names:
        globals()[n] += 1


def _check(name, t, device, dtype, shape, aligned=False):
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} is not contiguous")
    if aligned and t.data_ptr() % 16:  # 16-byte TMA loads
        raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def _kernel_args(q, k, v, q_seg, kv_seg):
    """Check q, k, v against what the kernels take (`mode`: bf16 or f32 at
    D = 32, 64, 128; [B, S, H, D] contiguous and 16-byte aligned, for the
    forwards' TMA tensor maps; k / v of one shape with q's B and H, all of
    q's dtype and on q's device) and return (B, Sq, Sk, H, int32 q ids,
    int32 kv ids), the ids both None (unmasked) or both set."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q / k must be [B, S, H, D], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    mode(q)  # raises on a dtype or head dim no kernel takes
    if sk < 1:
        raise ValueError("flash_attention: no keys")
    _check("q", q, q.device, q.dtype, (b, sq, h, d), True)
    _check("k", k, q.device, q.dtype, (b, sk, h, d), True)
    _check("v", v, q.device, q.dtype, (b, sk, h, d), True)
    q_seg, kv_seg = _segment_pair(q, q_seg, kv_seg)
    if q_seg is not None:
        q_seg, kv_seg = (t.to(torch.int32).contiguous() for t in (q_seg, kv_seg))
        _check("q_seg", q_seg, q.device, torch.int32, (b, sq))
        _check("kv_seg", kv_seg, q.device, torch.int32, (b, sk))
    return b, sq, sk, h, q_seg, kv_seg


def _on_cuda(what, q):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention {what}: the kernel runs on CUDA tensors, "
                         f"got {q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale):
    """Launch K3 (csrc/flash_fwd.cu; f32: csrc/flash_f32_fwd.cu) on CUDA
    tensors → (out, lse); raises on anything the kernel does not take
    (`_kernel_args`) and on a CUDA error.  A head dim below 128 that no
    kernel takes runs zero-padded (`_padded_dim`) with the caller's scale,
    out sliced back to it.  Counting is the caller's."""
    _on_cuda("forward", q)
    d, dp = q.shape[-1], _padded_dim(q, k, v)
    if dp is not None:
        out, lse = _flash_fwd_cuda(*(pad_head(t, dp) for t in (q, k, v)), q_seg, kv_seg, scale)
        return out[..., :d].contiguous(), lse
    _, _, _, _, q_seg, kv_seg = _kernel_args(q, k, v, q_seg, kv_seg)

    from qflux_tpu_torch.runtime.build import load_library

    return _launch_fwd(load_library(), torch.cuda.current_stream(q.device).cuda_stream, q, k,
                       v, q_seg, kv_seg, scale)


def _launch_fwd(kl, stream, q, k, v, q_seg, kv_seg, scale):
    """The C call of `_flash_fwd_cuda` on checked arguments (int32 ids or
    both None): allocates out [B, Sq, H, D] and lse [B, H, Sq] f32,
    launches through `kl` (a runtime.build KernelLibrary) on `stream` (K3
    with the head dim: `qflux_flash_fwd` in bf16, `qflux_f32_fwd` in f32)
    and raises on a CUDA error."""
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    entry = kl.lib.qflux_f32_fwd if mode(q) == "f32" else kl.lib.qflux_flash_fwd
    code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
                 out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], h, d, float(scale), stream)
    kl.check(code, "flash_fwd launch")
    return out, lse


def _flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale):
    """Launch K4 (csrc/flash_bwd.cu; f32: csrc/flash_f32_bwd.cu: delta,
    then dk / dv, then dq) on CUDA tensors → (dq, dk, dv) in q's dtype;
    raises as `_flash_fwd_cuda`, and pads as it does (out and do too; lse as
    it is), the gradients sliced back.  Counting is the caller's."""
    _on_cuda("backward", q)
    d, dp = q.shape[-1], _padded_dim(q, k, v, out, do)
    if dp is not None:
        q, k, v, out, do = (pad_head(t, dp) for t in (q, k, v, out, do))
        grads = _flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        return tuple(g[..., :d].contiguous() for g in grads)
    b, sq, sk, h, q_seg, kv_seg = _kernel_args(q, k, v, q_seg, kv_seg)
    # every backward reads do by TMA, and its delta pass reads out
    _check("out", out, q.device, q.dtype, q.shape, True)
    _check("do", do, q.device, q.dtype, q.shape, True)
    _check("lse", lse, q.device, torch.float32, (b, h, sq))

    from qflux_tpu_torch.runtime.build import load_library

    return _launch_bwd(load_library(), torch.cuda.current_stream(q.device).cuda_stream, q, k,
                       v, q_seg, kv_seg, out, lse, do, scale)


def _launch_bwd(kl, stream, q, k, v, q_seg, kv_seg, out, lse, do, scale):
    """The C call of `_flash_bwd_cuda` on checked arguments: allocates the
    f32 delta scratch [B, H, Sq] and dq / dk / dv (q's dtype), launches
    through `kl` (a runtime.build KernelLibrary) on `stream` (K4 with the
    head dim: `qflux_flash_bwd` in bf16, `qflux_f32_bwd` in f32) and raises
    on a CUDA error."""
    b, sq, h, d = q.shape
    delta = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, sq, k.shape[1], h, d)
    entry = kl.lib.qflux_f32_bwd if mode(q) == "f32" else kl.lib.qflux_flash_bwd
    code = entry(*args, float(scale), stream)
    kl.check(code, "flash_bwd launch")
    return dq, dk, dv


# The custom op runs on every device type: on a CUDA tensor it launches K3, on
# any other `_flash_fwd_cuda` raises (the public entry point sends CPU tensors
# to the plain version before they reach it).
@torch.library.custom_op(
    "qflux::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? q_seg, Tensor? kv_seg, float scale) "
           "-> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, q_seg, kv_seg, scale):
    def launch():
        out, lse = _flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
        _count(q, bwd=False)
        return out, lse

    return remat.keep(remat.FLASH, q.device, launch)


def _fwd_setup_context(ctx, inputs, output):
    # the residuals of _flash_fwd (qflux_tpu/ops/flash_attention.py:473-481)
    q, k, v, q_seg, kv_seg, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
    ctx.scale = scale


def _fwd_backward(ctx, dout, _dlse):
    """K4 from the saved residuals; lse is a residual, not differentiated (as
    in the JAX custom_vjp, whose primal returns out alone)."""
    q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, dout.contiguous(), ctx.scale)
    _count(q, bwd=True)
    return dq, dk, dv, None, None, None


torch.library.register_autograd("qflux::flash_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)
FWD_OP = torch.ops.qflux.flash_fwd.default  # what a checkpoint policy sees


def flash_attention(q, k, v, segment_ids=None, kv_segment_ids=None, scale=None):
    """Flash attention over [B, S, H, D] q (Sq rows) and k / v (Sk rows)
    with segment-id masking: seg 0 is padding, tokens attend iff their ids
    are equal and nonzero; no ids at all is the unmasked case.  Returns out
    [B, Sq, H, D], differentiable in q, k and v.

    CUDA tensors run the Hopper kernels, K3 forward and K4 backward; CPU
    tensors run `flash_fwd_reference`, which autograd differentiates."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    q_seg, kv_seg = _segment_pair(q, segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)[0]
    return _flash_fwd_op(q, k, v, q_seg, kv_seg, float(scale))[0]


def flash_fwd_with_lse(q, k, v, q_seg, kv_seg, scale):
    """The ring hop's forward: (out [B, Sq, H, D], lse [B, H, Sq] f32) of
    one K3 call, no autograd — pair it with `flash_bwd_from_residuals`.
    CPU tensors take `flash_fwd_reference`."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    out, lse = _flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    _count(q, bwd=False)
    return out, lse


def flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, out, lse, do, scale):
    """The ring hop's backward: (dq, dk, dv) in [B, S, H, D] and the inputs'
    dtypes from caller-supplied (global) out / lse, one K4 call.  CPU
    tensors take `flash_bwd_reference`."""
    if q.device.type == "cpu":
        g = flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        return tuple(x.to(t.dtype) for x, t in zip(g, (q, k, v)))
    grads = _flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do.contiguous(), scale)
    _count(q, bwd=True)
    return grads
