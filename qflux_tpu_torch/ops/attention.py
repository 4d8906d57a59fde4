"""Joint text-image attention: plain reference + dispatch to kernel K1.

Counterpart of qflux_tpu/ops/attention.py.  Segment-id convention as there:
seg == 0 is a padding token; tokens attend iff their segment ids are equal
and nonzero; a fully masked row outputs 0.
"""

from __future__ import annotations

import torch

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
    return out.to(q.dtype), lse


def sdpa_reference(q, k, v, segment_ids=None, kv_segment_ids=None, scale=None):
    """q,k,v: [B, S, H, D] → [B, S, H, D].  f32 logits and softmax; the
    probabilities are cast to v.dtype before the PV product, as in JAX."""
    return sdpa_with_lse(q, k, v, segment_ids, kv_segment_ids, scale)[0]


def qk_norm_rope_attention(q_raw, k_raw, v, q_scale2, k_scale2, cos, sin,
                           st: int, segment_ids=None, impl: str = "auto"):
    """qk-RMSNorm + rotate-half RoPE + joint attention over RAW projections.

    impl="auto": the fused kernel K1 (ops/flash_nr.py) — on CUDA tensors the
    Hopper kernel, which raises on a shape it does not take; on CPU tensors
    its plain version.  impl="plain": the plain composition on any device
    (the comparison point for the kernel on the card).
    q_scale2/k_scale2: [2, D] — row 0 norms positions < st (txt stream), row
    1 the rest; pass the same row twice for single-stream.
    """
    from qflux_tpu_torch.ops import flash_nr

    if impl in ("int8", "ring", "stub"):
        raise NotImplementedError(
            f"attention impl={impl!r} is not ported yet (ROADMAP.md: K1 s_int8, "
            "ring attention and multi-GPU come in later slices)")
    if impl == "auto":
        out, _ = flash_nr.flash_attention_nr(q_raw, k_raw, v, q_scale2, k_scale2,
                                             cos, sin, st, segment_ids=segment_ids)
        return out
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r} (auto | plain)")
    qn = flash_nr.apply_qk_norm_rope(q_raw, q_scale2, cos, sin, st)
    kn = flash_nr.apply_qk_norm_rope(k_raw, k_scale2, cos, sin, st)
    return sdpa_reference(qn, kn, v, segment_ids=segment_ids)
