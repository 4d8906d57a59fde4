"""Ring attention: sequence-parallel exact attention over the mesh's sp ranks.

Counterpart of qflux_tpu/ops/ring_attention.py, its kernel path (the one
JAX runs on a TPU): each rank holds a chunk of the sequence; k, v and the
kv segment ids rotate around the ring (to rank + 1 of the sp group), and
each hop is one flash call on the chunk that is there:

  * forward (`_ring_fwd`, JAX's `_ring_fwd`): each hop runs
    `flash_attention.flash_fwd_with_lse` (kernel K3 on CUDA tensors, its
    plain version on CPU ones) → (out, lse) normalized within the hop; the
    hops merge by log-sum-exp in f32 (torch ops, as JAX merges in XLA);
  * backward (`_ring_bwd`, JAX's `_ring_vjp_bwd`): each hop runs
    `flash_attention.flash_bwd_from_residuals` (kernel K4) against the
    GLOBAL out / lse, so each hop's probabilities are its exact share; dq
    accumulates in f32 on the rank, dk / dv accumulate in f32 with the
    chunk they belong to and travel with it, home after n hops.

Each rotation is posted (`dist.batch_isend_irecv` over the sp group) before
the hop's kernel and waited for after it, so the copy overlaps the compute,
as XLA overlaps `ppermute`; an accumulator's rotation is posted once the
hop has added to it and waited for at the next hop.  With one rank nothing
moves, and the merge with an empty accumulator (weights exp(NEG_INF − lse)
= 0 and 1) returns the one hop's out and lse to the bit.

`ring_attention_sharded` keeps JAX's contract: global [B, S, H, D] in,
global out.  Here each sp rank holds q / k / v replicated over sp (every
other op of a block runs replicated): it takes its S / sp chunk, runs the
ring and all-gathers the output.  The autograd pair is chunk ↔ all-gather
(the chunk's backward all-gathers the gradient chunks, the all-gather's
takes this rank's chunk of the replicated gradient), so gradients stay
replicated and the rest of the block is unchanged.  An S that sp does not
divide raises, as JAX's `shard_map` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from qflux_tpu_torch.ops import flash_attention

NEG_INF = -1e30


def _peers(group) -> tuple[int, int, int]:
    """(n, global rank of the next rank, of the previous one) in `group`."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    return (n, dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


def _post(tensors, group):
    """Send `tensors` to the next rank and receive as many from the previous
    one: (the tensors received, a handle for `_wait`, which also keeps the
    sent tensors alive until their sends complete)."""
    import torch.distributed as dist

    _, nxt, prv = _peers(group)
    recv = tuple(torch.empty_like(t) for t in tensors)
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    return recv, (dist.batch_isend_irecv(ops), tensors)


def _wait(handle):
    for req in handle[0] if handle else ():
        req.wait()


def _ring_fwd(q, k, v, q_seg, group, scale):
    """Online softmax over the ring's hops → (out [B, S, H, D] in q.dtype,
    lse [B, H, S] f32)."""
    n = 1 if group is None else _peers(group)[0]
    b, s_loc, h, d = q.shape
    lse = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    cur = (k, v, q_seg)
    for i in range(n):
        nxt, reqs = _post(cur, group) if i < n - 1 else (None, None)
        o_hop, lse_hop = flash_attention.flash_fwd_with_lse(q, cur[0], cur[1], q_seg, cur[2],
                                                            scale)
        lse_new = torch.logaddexp(lse, lse_hop)
        w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
        w_hop = torch.exp(lse_hop - lse_new).transpose(1, 2)[..., None]
        acc = acc * w_old + o_hop.float() * w_hop
        lse = lse_new
        _wait(reqs)
        cur = nxt
    return acc.to(q.dtype), lse


def _ring_bwd(q, k, v, q_seg, out, lse, do, group, scale):
    """The ring's backward → (dq, dk, dv) in the inputs' dtypes."""
    n = 1 if group is None else _peers(group)[0]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    cur = (k, v, q_seg)
    acc, acc_reqs = None, None
    for i in range(n):
        nxt, reqs = _post(cur, group) if i < n - 1 else (None, None)
        dq_h, dk_h, dv_h = flash_attention.flash_bwd_from_residuals(
            q, cur[0], cur[1], q_seg, cur[2], out, lse, do, scale)
        dq = dq + dq_h.float()
        _wait(acc_reqs)
        if acc is None:  # the first hop: the chunk's accumulators start at 0
            acc = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                   torch.zeros(v.shape, dtype=torch.float32, device=v.device))
        acc = (acc[0] + dk_h.float(), acc[1] + dv_h.float())
        if n > 1:  # to the chunk's next rank; home after the n-th hop
            acc, acc_reqs = _post(acc, group)
        _wait(reqs)
        cur = nxt
    _wait(acc_reqs)
    return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, group, scale):
        out, lse = _ring_fwd(q, k, v, q_seg, group, scale)
        ctx.save_for_backward(q, k, v, q_seg, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, q_seg, out, lse, do.contiguous(), ctx.group, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, group, segment_ids: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None):
    """[B, S_local, H, D] → [B, S_local, H, D], the sequence split over the
    ranks of `group` (None: one rank) in rank order; differentiable in q, k
    and v.  segment_ids [B, S_local] (0 = padding; all ones when None, as
    JAX) rotate with k / v."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if segment_ids is None:
        segment_ids = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    seg = segment_ids.to(torch.int32).contiguous()
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), seg, group, float(scale))


def _gather_seq(x, group):
    """All-gather the chunks along dim 1, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _chunk_seq(x, group):
    """This rank's chunk along dim 1, contiguous."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    c = x.shape[1] // n
    return x[:, r * c:(r + 1) * c].contiguous()


class _Chunk(torch.autograd.Function):
    """Forward: this rank's sequence chunk of a tensor replicated over the
    group; backward: the gradient chunks all-gathered (replicated again)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """Forward: the chunks all-gathered along the sequence; backward: this
    rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk_seq(g, ctx.group), None


def ring_attention_sharded(q, k, v, mesh, segment_ids: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None):
    """Global [B, S, H, D] q / k / v, replicated over the mesh's sp ranks →
    global out [B, S, H, D]: this rank's S / sp chunk through the ring over
    `mesh.sp_group`, the output all-gathered.  The batch rows are the
    rank's own (split over dp and fsdp before the model runs)."""
    sp = mesh.shape["sp"]
    s = q.shape[1]
    if s % sp:
        raise ValueError(f"ring attention: sequence length {s} is not divisible by "
                         f"mesh.sp = {sp}")
    if segment_ids is None:
        segment_ids = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    group = mesh.sp_group
    if group is None:
        return ring_attention(q, k, v, None, segment_ids, scale)
    q, k, v = (_Chunk.apply(t, group) for t in (q, k, v))
    out = ring_attention(q, k, v, group, _chunk_seq(segment_ids, group), scale)
    return _Gather.apply(out, group)
