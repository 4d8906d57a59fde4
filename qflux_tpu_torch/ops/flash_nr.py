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
    K2's.  The forward is a `torch.library.custom_op` with a registered
    autograd formula, whose body a remat policy that keeps the attention
    outputs replays (below);
  * `supports` — WHERE JAX on a TPU runs this fused path at all: the whole
    K in one kernel block (padded S ≤ 2688 in bf16, ≤ 2560 with the int8
    score GEMM) and self-attention; elsewhere `ops/attention.py` takes
    JAX's other route, the plain norm + rope and then K3 / K4
    (ops/flash_attention.py).  The op's body is a FLASH save point of
    ops/remat.py, as K3's is: a block whose remat policy keeps the
    attention outputs replays K1's out and lse in its recompute.

f32 inputs (`train.weight_dtype: float32`) run K1 / K2's f32 mode: a prep
(csrc/flash_simt.cu) norms and ropes q and k into f32 scratch, then K1 runs
K3's f32 loop and K2 K4's f32 loops on the tensor cores, every product a
3xTF32 split (csrc/flash_f32_fwd.cu, `qflux_f32_nr_fwd`;
csrc/flash_f32_bwd.cu, `qflux_f32_nr_bwd`, which ends with flash_simt.cu's
rope + norm backward pass).  Their s_int8 modes run the same loops with
int8 `wgmma` scores (the prep also quantizes qn / kn):
`qflux_f32_nr_int8_fwd`, `qflux_f32_nr_int8_bwd`.  `F32_KERNEL_LAUNCHES`
and its siblings count them among all launches.

The `s_int8` mode (config `model.quantize.attention`) computes QK^T as an
int8 x int8 product with one scale per q tile and one per (b, h) for K,
as the TPU kernels' `s_int8` branches do:

  * `s_int8_tiles` — where JAX on a TPU applies it (`supports` with
    s_int8) and over which q tiles it quantizes (forward and backward pick
    their tiles independently);
  * `quant_tile` / `quant_rows` — JAX's `_quant_tile`, whole and per tile;
  * `flash_attention_nr_int8_reference` / `_bwd_reference` — the plain
    versions of the two kernels' `s_int8` branches.  The backward is
    straight-through: it recomputes the scores from q quantized in the
    BACKWARD's tiles against the forward's lse, and takes dqn / dkn from
    the bf16 normed q / k, as the TPU kernel does;
  * the same custom op with `fwd_rows` / `bwd_rows` set launches the
    kernels' int8 mode (`INT8_KERNEL_LAUNCHES`, `INT8_BWD_KERNEL_LAUNCHES`);
    CPU tensors take `_Int8Attention`, an autograd.Function over the two
    plain versions (autograd through `torch.round` would give q and k a
    zero gradient).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qflux_tpu_torch.ops.attention import masked_softmax_pv, sdpa_with_lse, segment_mask
from qflux_tpu_torch.ops import remat

EPS = 1e-6
HEAD_DIM = 128  # the only head dim the kernels take (every FLUX/Qwen shape)
DTYPES = (torch.bfloat16, torch.float32)  # bf16: the wgmma kernels; f32: the f32 modes

# launches of the CUDA kernels in this process; the custom op and its
# backward add one per launch, whatever the dtype, and the F32_ counts add
# the f32 launches among them (csrc/flash_f32_fwd.cu, csrc/flash_f32_bwd.cu)
KERNEL_LAUNCHES = 0                # K1, csrc/flash_nr_fwd.cu
BWD_KERNEL_LAUNCHES = 0            # K2, csrc/flash_nr_bwd.cu
INT8_KERNEL_LAUNCHES = 0           # K1 in its s_int8 mode
INT8_BWD_KERNEL_LAUNCHES = 0       # K2 in its s_int8 mode
F32_KERNEL_LAUNCHES = 0            # K1 in f32
F32_BWD_KERNEL_LAUNCHES = 0        # K2 in f32
F32_INT8_KERNEL_LAUNCHES = 0       # K1's s_int8 mode in f32
F32_INT8_BWD_KERNEL_LAUNCHES = 0   # K2's s_int8 mode in f32

# JAX's default VMEM estimates and tile pickers (qflux_tpu/ops/flash_nr.py
# _nr_block_q / _nr_fwd_block_q at the 13 MB budget and under the raised
# scoped-VMEM limit every qflux entry point sets; ops/flash_attention.py
# BLOCK_Q_TARGET), copied here because they decide where JAX runs this path
# and its int8 mode: the port reads no QFLUX_NR_VMEM_MB
_NR_VMEM_BUDGET = 13 * 1024 * 1024
_NR_FWD_VMEM_BUDGET = 32 * 1024 * 1024
_BLOCK_Q_TARGET = 256


def _auto_block(s, target):
    """ops/flash_attention.py:_auto_block: the smallest number of equal
    ≤ target chunks covering s, rounded up to 128."""
    n = -(-s // target)
    per = -(-s // n)
    return min((per + 127) // 128 * 128, (s + 127) // 128 * 128)


def _pad_len(s, block):
    return (block - s % block) % block


def _nr_block_q(bk, d, s_int8):
    """JAX's `_nr_block_q` at its 13 MB default: the largest block_q in
    {256, 128} whose merged-backward VMEM estimate at a K block of bk rows
    fits, or None."""
    return next((bq for bq in (256, 128)
                 if 8 * bq * bk + 16 * bk * d + 14 * bk * d + 24 * bq * d
                 + (bk * d if s_int8 else 0) <= _NR_VMEM_BUDGET), None)


def supports(sq: int, sk: int, d: int, s_int8: bool = False) -> bool:
    """JAX's `flash_nr.supports` at its defaults: WHERE JAX on a TPU runs
    the fused norm + rope path (K1 / K2) — self-attention, d a multiple of
    128, and the `_nr_block_q` estimate at the single padded K block under
    13 MB: padded S ≤ 2688 in bf16, ≤ 2560 with the int8 score GEMM.  It
    defines behaviour to mirror (`ops/attention.py` runs K3 / K4 elsewhere,
    as JAX does); it is not a tuner of this card's kernels, which take any
    S."""
    if sq != sk or d % 128:
        return False
    return _nr_block_q(_auto_block(sk, 1 << 30), d, s_int8) is not None


def s_int8_tiles(s: int, d: int):
    """(fwd_rows, bwd_rows), or None: WHERE JAX on a TPU applies the int8
    score GEMM and over which q tiles it quantizes.

    None wherever `supports(s, s, d, s_int8=True)` fails, and there JAX
    runs bf16 attention through K3 / K4; otherwise the arithmetic of
    `flash_attention_nr`'s tile choice (qflux_tpu/ops/flash_nr.py:573-584)
    with JAX's default VMEM estimates: the forward's and the backward's q
    tile rows (128 or 256, counted from row 0).  Where the two differ (S =
    2304, 2560: 256 / 128) the backward recomputes its scores from other q
    scales than the forward's, as JAX does.
    """
    if not supports(s, s, d, s_int8=True):
        return None
    pk = _auto_block(s, 1 << 30)  # the single padded K block
    target = _auto_block(s, _BLOCK_Q_TARGET)
    block_q = min(target, _nr_block_q(pk, d, True))
    bq_fwd = min(target, next((bq for bq in (256, 128)
                               if 4 * bq * pk + 16 * pk * d + 24 * bq * d + pk * d
                               <= _NR_FWD_VMEM_BUDGET), 128))
    if bq_fwd < block_q or _pad_len(s, bq_fwd) != _pad_len(s, block_q):
        bq_fwd = block_q
    return bq_fwd, block_q


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


def _int8_scale(amax):
    """max(amax / 127, 1e-6) in f32 with a true division.  The divisor is a
    tensor on amax's device: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can land one ulp off."""
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-6)


def quant_tile(x):
    """JAX's `_quant_tile`: one symmetric int8 scale for the whole tile,
    max(amax / 127, 1e-6) in f32, then round-half-to-even of x / scale.
    Returns (int8 tile, f32 scalar scale)."""
    xf = x.float()
    s = _int8_scale(xf.abs().amax())
    return torch.round(xf / s).to(torch.int8), s


def quant_rows(x, rows):
    """`quant_tile` over each (b, h) and each tile of `rows` rows counted
    from row 0 (the last one ragged) of x [B, S, H, D]: (int8 [B, S, H, D],
    f32 scales [B, S, H], each row carrying its tile's)."""
    b, s, h, _ = x.shape
    xf = x.float()
    nt = -(-s // rows)
    amax = F.pad(xf.abs().amax(-1), (0, 0, 0, nt * rows - s))
    sc = _int8_scale(amax.view(b, nt, rows, h).amax(2))
    sc_rows = sc.repeat_interleave(rows, dim=1)[:, :s]
    return torch.round(xf / sc_rows[..., None]).to(torch.int8), sc_rows


def int8_scores(qq, q_sc, kq, k_sc, scale):
    """[B, H, Sq, Sk] f32 scores of the s_int8 mode: the exact integer
    product (float64 on the int8 values: exact, and torch has no int matmul
    on CUDA), then f32(acc) * ((q_scale * k_scale) * scale) in that order.
    q_sc / k_sc: [B, S, H] as `quant_rows` gives them (k's constant per
    (b, h))."""
    acc = torch.einsum("bqhd,bkhd->bhqk", qq.double(), kq.double()).float()
    fac = (q_sc.permute(0, 2, 1) * k_sc[:, 0][:, :, None]) * scale
    return acc * fac[..., None]


def _int8_operands(q, k, q_scale2, k_scale2, cos, sin, st, q_rows, normed=None):
    """(qn, kn, quant_rows of each); `normed` = (qn, kn) given in place of
    the plain norm + rope (the f32 mode's prep, whose qn an f32 ulp away
    from the plain one can land on the other int8 step)."""
    if normed is None:
        normed = (apply_qk_norm_rope(q, q_scale2, cos, sin, st),
                  apply_qk_norm_rope(k, k_scale2, cos, sin, st))
    qn, kn = normed
    return qn, kn, quant_rows(qn, q_rows), quant_rows(kn, k.shape[1])


def flash_attention_nr_int8_reference(q, k, v, q_scale2, k_scale2, cos, sin, st, q_rows,
                                      segment_ids=None, scale=None, normed=None):
    """Plain version of K1's s_int8 mode (`_fwd_nr_kernel`'s s_int8 branch):
    q and k normed and roped, K quantized with one scale per (b, h) over all
    S rows (masked ones included), q with one per (b, h, `q_rows`-row tile),
    `int8_scores`, then the mask and softmax of the bf16 path.  Returns (out
    [B, S, H, D] in q.dtype, lse [B, H, S] f32).  `normed`: see
    `_int8_operands`."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    _, _, (qq, q_sc), (kq, k_sc) = _int8_operands(q, k, q_scale2, k_scale2, cos, sin, st,
                                                  q_rows, normed)
    return masked_softmax_pv(int8_scores(qq, q_sc, kq, k_sc, scale), v, segment_ids,
                             out_dtype=q.dtype)


def _rope_norm_bwd(g, x, scale2, cos, sin, st):
    """`_rope_bwd` then `_norm_bwd` of qflux_tpu/ops/flash_nr.py over
    [B, S, H, D], in f32: (dx, [2, D] scale-pair gradient, rows < st into
    row 0)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    h = x.shape[-1] // 2
    gs = g * sin.float()[:, :, None, :]
    d_us = g * cos.float()[:, :, None, :] + torch.cat([gs[..., h:], -gs[..., :h]], dim=-1)
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + EPS)
    u = xf * r
    sel = (torch.arange(x.shape[1], device=x.device) < st)[None, :, None, None]
    s_sel = torch.where(sel, scale2[0].float(), scale2[1].float())
    du = d_us * s_sel
    dx = r * (du - u * torch.mean(du * u, dim=-1, keepdim=True))
    dsc = d_us * u
    return dx, torch.stack([dsc[:, :st].sum((0, 1, 2)), dsc[:, st:].sum((0, 1, 2))])


def flash_attention_nr_int8_bwd_reference(q, k, v, q_scale2, k_scale2, cos, sin, st, do, out,
                                          lse, q_rows, segment_ids=None, scale=None,
                                          normed=None):
    """Plain version of K2's s_int8 mode, the explicit formula of
    `_bwd_nr_kernel`'s s_int8 branch: the scores recomputed from q
    quantized in `q_rows`-row tiles (the BACKWARD's) against the saved lse,
    p = exp(s - lse) (0 where masked), dv = bf16(p)^T do, ds = bf16(p (dp -
    delta) scale), dqn = ds kn and dkn = ds^T qn on the bf16 normed q / k
    (straight through the quantization), then the rope and norm backward.
    Returns (dq, dk, dv, dq_scale2, dk_scale2), all f32.  `normed`: see
    `_int8_operands`."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    dt = q.dtype
    qn, kn, (qq, q_sc), (kq, k_sc) = _int8_operands(q, k, q_scale2, k_scale2, cos, sin, st,
                                                    q_rows, normed)
    p = torch.exp(int8_scores(qq, q_sc, kq, k_sc, scale) - lse[..., None])
    if segment_ids is not None:
        p = torch.where(segment_mask(segment_ids, segment_ids), p, 0.0)
    dof = do.float()
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)  # [B, H, S]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = ((p * (dp - delta[..., None])) * scale).to(dt).float()
    dqn = torch.einsum("bhqk,bkhd->bqhd", ds, kn.float())
    dkn = torch.einsum("bhqk,bqhd->bkhd", ds, qn.float())
    dq, dqs = _rope_norm_bwd(dqn, q, q_scale2, cos, sin, st)
    dk, dks = _rope_norm_bwd(dkn, k, k_scale2, cos, sin, st)
    return dq, dk, dv, dqs, dks


class _Int8Attention(torch.autograd.Function):
    """The s_int8 mode on CPU tensors: the plain forward, and the plain
    straight-through backward (not autograd of the forward, which would
    differentiate `torch.round` to zero)."""

    @staticmethod
    def forward(ctx, q, k, v, q_scale2, k_scale2, cos, sin, seg, st, scale, rows):
        out, lse = flash_attention_nr_int8_reference(q, k, v, q_scale2, k_scale2, cos, sin, st,
                                                     rows[0], segment_ids=seg, scale=scale)
        ctx.save_for_backward(q, k, v, q_scale2, k_scale2, cos, sin, seg, out, lse)
        ctx.st, ctx.scale, ctx.bwd_rows = st, scale, rows[1]
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, qs, ks, cos, sin, seg, out, lse = ctx.saved_tensors
        g = flash_attention_nr_int8_bwd_reference(q, k, v, qs, ks, cos, sin, ctx.st, dout, out,
                                                  lse, ctx.bwd_rows, segment_ids=seg,
                                                  scale=ctx.scale)
        return tuple(x.to(t.dtype) for x, t in zip(g, (q, k, v, qs, ks))) + (None,) * 6


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
    """Check the inputs against what csrc/flash_nr_fwd.cu (bf16) and the f32
    modes (csrc/flash_f32_fwd.cu, csrc/flash_f32_bwd.cu, csrc/flash_simt.cu)
    take and return (f32
    scale pairs, cos/sin batch stride, int32 segment ids or None).  Raises
    on a dtype other than bf16 or f32, D != 128, cross attention, a tensor
    on another device than q, a wrong shape, or a q/k/v/cos/sin that is not
    contiguous or not 16-byte aligned."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention_nr: q must be [B, S, H, D], got {tuple(q.shape)}")
    b, s, h, d = q.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention_nr: q is {q.dtype}; the kernels take {DTYPES}")
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention_nr: head dim {d}; the kernel takes {HEAD_DIM}")
    if k.shape[1] != s:
        raise ValueError(f"flash_attention_nr: sq={s} != sk={k.shape[1]}; the fused "
                         "norm+rope path is self-attention only")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev, q.dtype, (b, s, h, d))
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


def _int8_scratch(q, q_rows):
    """The s_int8 mode's scratch on q's device: int8 [B, S, H, D] and the
    per-(b, h) amax slots, k's and each q tile's (zeroed by the launch)."""
    b, s, h, _ = q.shape
    return (torch.empty(q.shape, device=q.device, dtype=torch.int8),
            torch.empty((b, h, 1 + -(-s // q_rows)), device=q.device, dtype=torch.int32))


def _check_rows(q_rows, multiple, what):
    if q_rows < 0 or q_rows % multiple:
        raise ValueError(f"flash_attention_nr{what}: int8 q tile of {q_rows} rows; the kernel "
                         f"takes multiples of {multiple}")


def _fwd_scratch(k, q_rows):
    """K1's scratch on k's device: kn, the normed and roped k ([B, S, H, D]
    in k's dtype), which both modes' prep writes; and the s_int8 mode's kq and
    amax (`_int8_scratch`), else None."""
    if not q_rows:
        return torch.empty_like(k), None, None
    return (torch.empty_like(k), *_int8_scratch(k, q_rows))


def _flash_nr_cuda(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale, q_rows=0):
    """Launch K1 (csrc/flash_nr_fwd.cu) on CUDA tensors → (out, lse); raises
    on anything the kernel does not take (`_kernel_args`) and on a CUDA
    error.  Both modes first run a prep that norms and ropes k once per (b,
    h, row) into the scratch kn.  q_rows = 0: the bf16 mode, then the wgmma
    kernel.  q_rows > 0: the s_int8 mode, whose prep also quantizes k per
    (b, h) and reduces the largest |qn| of each `q_rows`-row tile, then its
    kernel, the same wgmma loop with int8 score products.  f32 q takes the
    f32 modes (`_launch_f32_fwd`).  Counting is the caller's
    (`_flash_nr_fwd_op`)."""
    _check_rows(q_rows, 128, "")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nr: the kernel runs on CUDA tensors, got {q.device}")
    qs, ks, cs_bstride, seg = _kernel_args(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids)

    from qflux_tpu_torch.runtime.build import load_library

    return _launch_fwd(load_library(), torch.cuda.current_stream(q.device).cuda_stream, q, k,
                       v, qs, ks, cos, sin, cs_bstride, seg, st, scale, q_rows)


def _launch_fwd(kl, stream, q, k, v, qs, ks, cos, sin, cs_bstride, seg, st, scale, q_rows):
    """The C call of `_flash_nr_cuda` on checked arguments (`_kernel_args`'
    f32 scale pairs, cos / sin batch stride and int32 ids): allocates out,
    lse and the scratch, launches through `kl` (a runtime.build
    KernelLibrary) on `stream` and raises on a CUDA error."""
    if q.dtype == torch.float32:
        return _launch_f32_fwd(kl, stream, q, k, v, qs, ks, cos, sin, cs_bstride, seg, st,
                               scale, q_rows)
    b, s, h, _ = q.shape
    kn, kq, amax = _fwd_scratch(k, q_rows)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    code = kl.lib.qflux_flash_nr_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), cs_bstride, _ptr(seg), kn.data_ptr(), _ptr(kq),
        _ptr(amax), int(q_rows), out.data_ptr(), lse.data_ptr(), b, s, h, int(st),
        float(scale), stream)
    kl.check(code, "flash_nr_fwd launch")
    return out, lse


def _simt_fwd_scratch(q, q_rows):
    """The f32 mode's scratch on q's device: qn, kn (f32 [B, S, H, D], the
    prep's normed and roped q and k); and the s_int8 mode's qq, kq (int8
    [B, S, H, D]) and amax (`_int8_scratch`), else None."""
    qn, kn = torch.empty_like(q), torch.empty_like(q)
    if not q_rows:
        return qn, kn, None, None, None
    return (qn, kn, torch.empty(q.shape, device=q.device, dtype=torch.int8),
            *_int8_scratch(q, q_rows))


def _launch_f32_fwd(kl, stream, q, k, v, qs, ks, cos, sin, cs_bstride, seg, st, scale, q_rows):
    """K1's f32 mode on checked arguments: allocates the scratch
    (`_simt_fwd_scratch`), out and lse, launches through `kl` on `stream`
    and raises on a CUDA error.  q_rows = 0: `qflux_f32_nr_fwd`
    (csrc/flash_f32_fwd.cu: the prep, then the 3xTF32 tensor-core loop over
    qn / kn); q_rows > 0, the s_int8 mode: `qflux_f32_nr_int8_fwd` (the
    same file: the prep also quantizes qn / kn, then the loop with int8
    `wgmma` scores over qq / kq)."""
    b, s, h, _ = q.shape
    qn, kn, qq, kq, amax = _simt_fwd_scratch(q, q_rows)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
              cos.data_ptr(), sin.data_ptr(), cs_bstride, _ptr(seg), qn.data_ptr(),
              kn.data_ptr())
    if q_rows:
        code = kl.lib.qflux_f32_nr_int8_fwd(
            *inputs, qq.data_ptr(), kq.data_ptr(), amax.data_ptr(), int(q_rows),
            out.data_ptr(), lse.data_ptr(), b, s, h, int(st), float(scale), stream)
    else:
        code = kl.lib.qflux_f32_nr_fwd(*inputs, out.data_ptr(), lse.data_ptr(), b, s, h, int(st),
                                       float(scale), stream)
    kl.check(code, "flash_nr_fwd f32 launch")
    return out, lse


def _kn_prep_cuda(k, k_scale2, cos, sin, st):
    """The bf16 mode's prep alone, as K1 launches it (for timing it apart
    from the main kernel in tests and the smoke): kn, the normed and roped
    k."""
    if k.device.type != "cuda":
        raise ValueError(f"flash_attention_nr: the kernel runs on CUDA tensors, got {k.device}")
    _, ks, cs_bstride, _ = _kernel_args(k, k, k, k_scale2, k_scale2, cos, sin, None)
    b, s, h, _ = k.shape

    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    kn = torch.empty_like(k)
    code = kl.lib.qflux_flash_nr_kn_prep(k.data_ptr(), ks.data_ptr(), cos.data_ptr(),
                                         sin.data_ptr(), cs_bstride, kn.data_ptr(), b, s, h,
                                         int(st), torch.cuda.current_stream(k.device).cuda_stream)
    kl.check(code, "flash_nr_kn_prep launch")
    return kn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_nr_bwd_cuda(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale,
                       out, lse, do, q_rows=0):
    """Launch K2 (csrc/flash_nr_bwd.cu) on CUDA tensors → (dq, dk, dv in
    q.dtype, dq_scale2, dk_scale2 f32 [2, D]); raises as `_flash_nr_cuda`.
    q_rows = 0: the bf16 mode, a prep (qn, kn, delta) then K4's Hopper
    loops with the rope + norm backward as their epilogue.  q_rows > 0 (a
    multiple of 128): its s_int8 mode, the same loops with int8 score
    products recomputed from q quantized in `q_rows`-row tiles (the
    backward's)."""
    _check_rows(q_rows, 128, " backward")  # a dq block's 128 rows lie in one q tile
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nr backward: the kernel runs on CUDA tensors, "
                         f"got {q.device}")
    qs, ks, cs_bstride, seg = _kernel_args(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids)
    b, s, h, _ = q.shape
    _check("out", out, q.device, q.dtype, q.shape)
    _check("do", do, q.device, q.dtype, q.shape)
    _check("lse", lse, q.device, torch.float32, (b, h, s))
    _check_aligned(out=out, do=do)

    from qflux_tpu_torch.runtime.build import load_library

    return _launch_bwd(load_library(), torch.cuda.current_stream(q.device).cuda_stream, q, k,
                       v, qs, ks, cos, sin, cs_bstride, seg, st, scale, out, lse, do, q_rows)


def _bwd_scratch(q, q_rows):
    """K2's scratch on q's device: qn, kn (the normed and roped q / k in q's
    dtype) and the f32 delta [B, H, S], which both modes' prep writes; and
    the s_int8 mode's qq, kq (int8 [B, S, H, D]) and amax (`_int8_scratch`),
    else None."""
    b, s, h, _ = q.shape
    qn, kn = torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    if not q_rows:
        return qn, kn, delta, None, None, None
    qq = torch.empty(q.shape, device=q.device, dtype=torch.int8)
    return (qn, kn, delta, qq, *_int8_scratch(q, q_rows))


def _launch_bwd(kl, stream, q, k, v, qs, ks, cos, sin, cs_bstride, seg, st, scale, out, lse,
                do, q_rows):
    """The C call of `_flash_nr_bwd_cuda` on checked arguments (`_kernel_args`'
    f32 scale pairs, cos / sin batch stride and int32 ids): allocates the
    scratch (`_bwd_scratch`), dq / dk / dv and the [2, D] scale-gradient
    partials, one per (b, h, 64-row tile) (`qflux_flash_nr_bwd_tiles`, the
    same in both modes), launches through `kl` (a runtime.build
    KernelLibrary) on `stream`, raises on a CUDA error and sums the partials,
    as `_bwd_nr` sums its per-(b, h) ones."""
    b, s, h, d = q.shape
    qn, kn, delta, qq, kq, amax = _bwd_scratch(q, q_rows)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_tiles = kl.lib.qflux_flash_nr_bwd_tiles(s)
    dqs_p = torch.empty((b, h, n_tiles, 2, d), device=q.device, dtype=torch.float32)
    dks_p = torch.empty_like(dqs_p)
    if q.dtype == torch.float32:
        # the f32 modes (csrc/flash_f32_bwd.cu): the loops write f32 dqn / dkn,
        # which the rope + norm backward pass reads; q_rows = 0 the 3xTF32 loops,
        # the s_int8 mode the same loops with int8 wgmma scores
        dqn, dkn = torch.empty_like(q), torch.empty_like(k)
        inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), cs_bstride, _ptr(seg), out.data_ptr(),
                  lse.data_ptr(), do.data_ptr(), qn.data_ptr(), kn.data_ptr(),
                  delta.data_ptr(), dqn.data_ptr(), dkn.data_ptr())
        grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dqs_p.data_ptr(),
                 dks_p.data_ptr(), b, s, h, int(st), float(scale), stream)
        if q_rows:
            code = kl.lib.qflux_f32_nr_int8_bwd(*inputs, qq.data_ptr(), kq.data_ptr(),
                                                amax.data_ptr(), int(q_rows), *grads)
        else:
            code = kl.lib.qflux_f32_nr_bwd(*inputs, *grads)
        kl.check(code, "flash_nr_bwd f32 launch")
        return dq, dk, dv, dqs_p.sum(dim=(0, 1, 2)), dks_p.sum(dim=(0, 1, 2))
    code = kl.lib.qflux_flash_nr_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), cs_bstride, _ptr(seg),
        out.data_ptr(), lse.data_ptr(), do.data_ptr(), qn.data_ptr(), kn.data_ptr(),
        delta.data_ptr(), _ptr(qq), _ptr(kq), _ptr(amax), int(q_rows), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dqs_p.data_ptr(), dks_p.data_ptr(), b, s, h, int(st),
        float(scale), stream)
    kl.check(code, "flash_nr_bwd launch")
    return dq, dk, dv, dqs_p.sum(dim=(0, 1, 2)), dks_p.sum(dim=(0, 1, 2))


def _int8_operands_cuda(q, k, q_scale2, k_scale2, cos, sin, st, q_rows):
    """The s_int8 prep alone, as K2 runs it (for tests and the smoke): (qn,
    kn in q's dtype, qq, kq int8 [B, S, H, D], q scales [B, S, H], k scales
    [B, H]) with the scales computed from the kernel's amax the way the
    kernels do; f32 q through the f32 mode's prep (`_launch_simt_prep`).
    Raises on CPU tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nr: the kernel runs on CUDA tensors, got {q.device}")
    qs, ks, cs_bstride, _ = _kernel_args(q, k, q, q_scale2, k_scale2, cos, sin, None)
    s = q.shape[1]

    from qflux_tpu_torch.runtime.build import load_library

    launch = _launch_simt_prep if q.dtype == torch.float32 else _launch_int8_prep
    qn, kn, qq, kq, amax = launch(
        load_library(), torch.cuda.current_stream(q.device).cuda_stream, q, k, qs, ks, cos, sin,
        cs_bstride, st, q_rows)
    sc = _int8_scale(amax.view(torch.float32))
    q_sc = sc[:, :, 1:].repeat_interleave(q_rows, dim=2)[:, :, :s].permute(0, 2, 1)
    return qn, kn, qq, kq, q_sc, sc[:, :, 0]


def _launch_simt_prep(kl, stream, q, k, qs, ks, cos, sin, cs_bstride, st, q_rows):
    """The f32 mode's prep alone (`qflux_simt_nr_prep`) on checked
    arguments: allocates its scratch (`_simt_fwd_scratch`), launches through
    `kl` on `stream`, raises on a CUDA error and returns (qn, kn, qq, kq,
    amax)."""
    b, s, h, _ = q.shape
    qn, kn, qq, kq, amax = _simt_fwd_scratch(q, q_rows)
    code = kl.lib.qflux_simt_nr_prep(
        q.data_ptr(), k.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), cs_bstride, qn.data_ptr(), kn.data_ptr(), _ptr(qq), _ptr(kq), _ptr(amax),
        int(q_rows), b, s, h, int(st), stream)
    kl.check(code, "flash_nr f32 prep launch")
    return qn, kn, qq, kq, amax


def _launch_int8_prep(kl, stream, q, k, qs, ks, cos, sin, cs_bstride, st, q_rows):
    """The C call of the s_int8 prep alone on checked arguments
    (`_kernel_args`' f32 scale pairs and cos / sin batch stride), as K2 runs
    it but without delta (null out / do): allocates qn, kn (q's dtype), qq,
    kq (int8) and amax ([B, H, 1 + ceil(S / q_rows)], `_int8_scratch`),
    launches through `kl` on `stream`, raises on a CUDA error and returns
    (qn, kn, qq, kq, amax)."""
    b, s, h, _ = q.shape
    qn, kn = torch.empty_like(q), torch.empty_like(k)
    qq = torch.empty(q.shape, device=q.device, dtype=torch.int8)
    kq, amax = _int8_scratch(k, q_rows)
    code = kl.lib.qflux_flash_nr_int8_prep(
        q.data_ptr(), k.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), cs_bstride, None, None, qn.data_ptr(), kn.data_ptr(), None,
        qq.data_ptr(), kq.data_ptr(), amax.data_ptr(), b, s, h, int(st), int(q_rows), stream)
    kl.check(code, "flash_nr_int8_prep launch")
    return qn, kn, qq, kq, amax


def _count(q, q_rows, bwd):
    """One launch of K1 (K2 where bwd), in its s_int8 mode where q_rows is
    set: the mode's count, and the f32 one beside it for f32 q."""
    name = ("INT8_" if q_rows else "") + ("BWD_" if bwd else "") + "KERNEL_LAUNCHES"
    names = [name] + (["F32_" + name] if q.dtype == torch.float32 else [])
    for n in names:
        globals()[n] += 1


# The custom op runs on every device type: on a CUDA tensor it launches K1,
# on any other `_flash_nr_cuda` raises (the public entry point sends CPU
# tensors to the plain version before they reach it).  In a checkpointed
# block that keeps the attention outputs, the block's forward stores them
# and its recompute returns them instead of launching (`remat.keep`).
@torch.library.custom_op(
    "qflux::flash_nr_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor q_scale2, Tensor k_scale2, Tensor cos, "
           "Tensor sin, Tensor? segment_ids, int st, float scale, int fwd_rows=0, "
           "int bwd_rows=0) -> (Tensor, Tensor)")
def _flash_nr_fwd_op(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids, st, scale,
                     fwd_rows=0, bwd_rows=0):
    """fwd_rows = bwd_rows = 0: K1; else K1's s_int8 mode over q tiles of
    fwd_rows rows, whose backward recomputes over tiles of bwd_rows."""
    def launch():
        out, lse = _flash_nr_cuda(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids,
                                  scale, fwd_rows)
        _count(q, fwd_rows, bwd=False)
        return out, lse

    return remat.keep(remat.FLASH, q.device, launch)


def _fwd_setup_context(ctx, inputs, output):
    # the residuals of _flash_nr_fwd (qflux_tpu/ops/flash_nr.py:533-539)
    q, k, v, qs, ks, cos, sin, seg, st, scale, _, bwd_rows = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, qs, ks, cos, sin, seg, out, lse)
    ctx.st, ctx.scale, ctx.bwd_rows = st, scale, bwd_rows


def _fwd_backward(ctx, dout, _dlse):
    """K2 (or its s_int8 mode) from the saved residuals; lse is a residual,
    not differentiated (as in the JAX custom_vjp, whose primal returns out
    alone)."""
    q, k, v, qs, ks, cos, sin, seg, out, lse = ctx.saved_tensors
    dq, dk, dv, dqs, dks = _flash_nr_bwd_cuda(q, k, v, qs, ks, cos, sin, ctx.st, seg, ctx.scale,
                                              out, lse, dout.contiguous(), ctx.bwd_rows)
    _count(q, ctx.bwd_rows, bwd=True)
    return (dq, dk, dv, dqs.to(qs.dtype), dks.to(ks.dtype)) + (None,) * 7


torch.library.register_autograd("qflux::flash_nr_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)
FWD_OP = torch.ops.qflux.flash_nr_fwd.default  # what a checkpoint policy sees


def _flash_attention_nr_op(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids, scale,
                           tiles=(0, 0)):
    """The kernel path: the custom op on the scale pairs widened to f32 and
    the segment ids as int32 (what the kernels take; the casts are
    differentiable, so the scale gradients come back in the scales' dtype).
    `tiles`: (0, 0) for bf16, else the s_int8 (fwd_rows, bwd_rows).  lse is
    returned detached."""
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    out, lse = _flash_nr_fwd_op(q, k, v, q_scale2.to(torch.float32),
                                k_scale2.to(torch.float32), cos, sin, seg, int(st),
                                float(scale), int(tiles[0]), int(tiles[1]))
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

    s_int8: the int8 score GEMM where JAX on a TPU applies it
    (`s_int8_tiles`): K1's and K2's s_int8 modes on CUDA tensors,
    `_Int8Attention` on CPU ones.  Where it does not apply (S past 2560, or
    D not a multiple of 128) this is the bf16 call.  Which route a model
    takes at all is `ops/attention.py:qk_norm_rope_attention`'s choice
    (`supports`).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    tiles = s_int8_tiles(q.shape[1], d) if s_int8 and k.shape[1] == q.shape[1] else None
    if q.device.type == "cpu":
        if tiles is not None:
            return _Int8Attention.apply(q, k, v, q_scale2, k_scale2, cos, sin, segment_ids,
                                        st, scale, tiles)
        return flash_attention_nr_reference(q, k, v, q_scale2, k_scale2, cos, sin,
                                            st, segment_ids=segment_ids, scale=scale)
    return _flash_attention_nr_op(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids,
                                  scale, tiles or (0, 0))
