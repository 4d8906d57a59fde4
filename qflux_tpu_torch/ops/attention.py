"""Joint text-image attention: plain reference + JAX's one-chip dispatch.

Counterpart of qflux_tpu/ops/attention.py.  `qk_norm_rope_attention` routes
as JAX on one TPU chip: the fused norm + rope kernels K1 / K2
(ops/flash_nr.py) where `flash_nr.supports` holds (the whole K in one TPU
block: padded S ≤ 2688 in bf16, ≤ 2560 with int8 scores), else the plain
norm + rope and `dot_product_attention` → kernels K3 / K4
(ops/flash_attention.py); under an active mesh whose sp axis is > 1, the
plain norm + rope and ring attention over the sp ranks
(ops/ring_attention.py), as JAX's dispatch.  Segment-id convention as
there: seg == 0 is a
padding token; tokens attend iff their segment ids are equal and nonzero; a
fully masked row outputs 0.
"""

from __future__ import annotations

import torch

from qflux_tpu_torch.ops import remat

NEG_INF = -1e30


def segment_mask(q_seg, kv_seg):
    """[B, Sq], [B, Sk] → bool [B, 1, Sq, Sk]; True = may attend."""
    m = (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] != 0)
    return m[:, None, :, :]


def sdpa_with_lse(q, k, v, segment_ids=None, kv_segment_ids=None, scale=None):
    """`sdpa_reference` that also returns lse [B, H, Sq] f32 (logsumexp of the
    scaled, masked logits; NEG_INF on fully masked rows)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return masked_softmax_pv(logits, v, segment_ids, kv_segment_ids, out_dtype=q.dtype)


def masked_softmax_pv(logits, v, segment_ids=None, kv_segment_ids=None, out_dtype=None):
    """The rest of the attention from f32 scaled logits [B, H, Sq, Sk]: the
    segment mask, softmax (probabilities cast to v.dtype before the PV
    product) → (out [B, Sq, H, D] in out_dtype, lse [B, H, Sq] f32)."""
    mask = None
    if segment_ids is not None:
        kv_segment_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
        mask = segment_mask(segment_ids, kv_segment_ids)
        logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    del logits
    if mask is not None:
        # a fully masked row softmaxes to uniform; zero it so padded rows
        # output 0, matching the flash kernel
        probs = torch.where(mask, probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(out_dtype or v.dtype), lse


def sdpa_reference(q, k, v, segment_ids=None, kv_segment_ids=None, scale=None):
    """q,k,v: [B, S, H, D] → [B, S, H, D].  f32 logits and softmax; the
    probabilities are cast to v.dtype before the PV product, as in JAX."""
    return sdpa_with_lse(q, k, v, segment_ids, kv_segment_ids, scale)[0]


def qk_norm_rope_attention(q_raw, k_raw, v, q_scale2, k_scale2, cos, sin,
                           st: int, segment_ids=None, impl: str = "auto"):
    """qk-RMSNorm + rotate-half RoPE + joint attention over RAW projections.

    impl="auto", as JAX on one TPU chip: where `flash_nr.supports` holds, the
    fused kernel K1 (ops/flash_nr.py); elsewhere the plain norm + rope on q
    and k (in x.dtype) and `dot_product_attention`, i.e. kernel K3
    (ops/flash_attention.py).  The route depends on the shape alone, as
    JAX's: f32, and head dims 32 / 64, take the kernels' CUDA-core modes.
    On CUDA tensors the Hopper kernels, which raise on a dtype or head dim
    they do not take; on CPU tensors their plain versions.
    impl="int8" (config `model.quantize.attention`): the same with the int8
    score GEMM, where JAX on a TPU applies it (`flash_nr.supports(...,
    s_int8=True)`: S up to 2560 at head dim 128) and bf16 K3 elsewhere, as
    there.  Under an active mesh whose sp axis is > 1 ("auto", "int8") or
    with impl="ring": the plain norm + rope, then ring attention over the
    sp ranks, in bf16 scores (JAX's route there).  impl="plain": the plain
    composition on any device (the
    comparison point for the kernels on the card); impl="int8_plain": the
    same for "int8" (the s_int8 mode's plain versions where it applies).
    q_scale2/k_scale2: [2, D] — row 0 norms positions < st (txt stream), row
    1 the rest; pass the same row twice for single-stream.
    """
    from qflux_tpu_torch.ops import flash_nr

    _refuse_unported(impl)
    if impl in ("auto", "int8", "ring") and (impl == "ring" or _sp_mesh() is not None):
        # sequence parallel (JAX: an active mesh with sp > 1): the plain
        # norm + rope, then the ring, never K1 / K2; int8 scores do not
        # apply there (bf16 hops, as JAX)
        qn = flash_nr.apply_qk_norm_rope(q_raw, q_scale2, cos, sin, st)
        kn = flash_nr.apply_qk_norm_rope(k_raw, k_scale2, cos, sin, st)
        return dot_product_attention(qn, kn, v, segment_ids=segment_ids, impl="ring")
    if impl in ("auto", "int8"):
        s_int8 = impl == "int8"
        if fused_route(q_raw.shape[1], k_raw.shape[1], q_raw.shape[-1], impl):
            out, _ = flash_nr.flash_attention_nr(q_raw, k_raw, v, q_scale2, k_scale2,
                                                 cos, sin, st, segment_ids=segment_ids,
                                                 s_int8=s_int8)
            return out
        # "flash_q" / "flash_k" on this route: the normed and roped q / k
        # (the recompute still runs the projections and the norm + rope,
        # whose backward needs their inputs, as JAX's does)
        qn = remat.kept(remat.QKV, flash_nr.apply_qk_norm_rope(q_raw, q_scale2, cos, sin, st))
        kn = remat.kept(remat.QKV, flash_nr.apply_qk_norm_rope(k_raw, k_scale2, cos, sin, st))
        return dot_product_attention(qn, kn, v, segment_ids=segment_ids)
    if impl == "int8_plain":
        d, s = q_raw.shape[-1], q_raw.shape[1]
        tiles = flash_nr.s_int8_tiles(s, d) if k_raw.shape[1] == s else None
        if tiles is not None:
            return flash_nr._Int8Attention.apply(q_raw, k_raw, v, q_scale2, k_scale2, cos, sin,
                                                 segment_ids, st, 1.0 / (d ** 0.5), tiles)[0]
        impl = "plain"
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(auto | int8 | ring | plain | int8_plain)")
    qn = flash_nr.apply_qk_norm_rope(q_raw, q_scale2, cos, sin, st)
    kn = flash_nr.apply_qk_norm_rope(k_raw, k_scale2, cos, sin, st)
    return sdpa_reference(qn, kn, v, segment_ids=segment_ids)


def fused_route(sq: int, sk: int, d: int, impl: str) -> bool:
    """Whether `qk_norm_rope_attention` takes the fused route (K1 / K2),
    which takes the raw q / k projections as they are, rather than the plain
    norm + rope before K3 / K4 (or the plain composition)."""
    from qflux_tpu_torch.ops import flash_nr

    return impl in ("auto", "int8") and flash_nr.supports(sq, sk, d, impl == "int8")


def _refuse_unported(impl):
    if impl == "stub":
        raise NotImplementedError(
            "attention impl='stub' (JAX's planning stub for XLA's memory analysis) is not "
            "ported: it is on ROADMAP.md's \"Do not port\" list")


def _sp_mesh():
    """The active mesh where its sp axis is > 1 (the ring's), else None."""
    from qflux_tpu_torch.parallel.mesh import active_mesh

    mesh = active_mesh()
    return mesh if mesh is not None and mesh.shape.get("sp", 1) > 1 else None


def dot_product_attention(q, k, v, segment_ids=None, impl: str = "auto"):
    """q, k, v: [B, S, H, D] (q / k already normed and roped); segment_ids:
    optional [B, S] int.  impl="auto": ring attention over the sp ranks
    (`ops/ring_attention.py`) under an active mesh whose sp axis is > 1, as
    JAX's; else `flash_attention.flash_attention` (kernels K3 / K4 on CUDA
    tensors, their plain version on CPU ones), as JAX's "pallas" on one
    chip.  impl="ring" requires such a mesh (JAX's ValueError without one);
    impl="plain": `sdpa_reference`."""
    _refuse_unported(impl)
    if impl == "auto" and _sp_mesh() is not None:
        impl = "ring"
    if impl == "ring":
        from qflux_tpu_torch.ops.ring_attention import ring_attention_sharded

        mesh = _sp_mesh()
        if mesh is None:
            raise ValueError("impl='ring' needs an active mesh with sp > 1 "
                             "(build_mesh(MeshConfig(sp=...)) first)")
        return ring_attention_sharded(q, k, v, mesh, segment_ids=segment_ids)
    if impl == "auto":
        from qflux_tpu_torch.ops import flash_attention

        return flash_attention.flash_attention(q, k, v, segment_ids=segment_ids)
    if impl == "plain":
        return sdpa_reference(q, k, v, segment_ids=segment_ids)
    raise ValueError(f"unknown attention impl {impl!r} (auto | ring | plain)")
