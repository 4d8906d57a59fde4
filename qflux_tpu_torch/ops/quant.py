"""Grouped-int4 frozen bases (W4A16 and W4A8-requant) and the W4A8-requant
matmul (plain versions).

Counterpart of the int4 / W4A8-requant half of qflux_tpu/ops/quant.py, with
its layouts at every public function: packed int4 `q4 [..., K/2, N]` int8,
HALF-SPLIT (byte row i holds original row i in its low nibble and row
i + K/2 in its high one), group scales `[..., K/G, N]` f32.

The requant matmul maps each group's int4 values onto one per-output-channel
int8 grid, q8 = clip(round(q4 · s_g/S_n · 127/7), ±127) with S_n = max_g s_g,
then runs ONE int8×int8 → int32 product against the row-quantized
activation and rescales by (row scale × channel scale).  `requant_int4_matmul`
here is the plain version, bit-identical to the JAX function:

  * `round` is half-to-even (torch.round), `x / s` a true division, and
    the row scale amax · fl32(1/127) (`_rowquant`: JAX's under `jit`);
  * the int32 accumulation is exact: the int8 operands multiply in float64,
    whose products and sums of |acc| ≤ 127²·K < 2³¹ are exact integers at
    every model shape (and float64 products exist on the card, where torch
    has no int32 matmul);
  * the epilogue is (f32(acc) · sx) · s_vec, then one cast to x.dtype.

Its backward is JAX's straight-through `_rq4_vjp_bwd`, bit for bit
(`requant_int4_matmul_dx`): the cotangent scaled by the channel scales,
gs = f32(g) · s_vec, is row-quantized to (gq, sg), multiplied exactly by
the same int8 weights, dxa = gq · q8ᵀ (float64 again: |dxa| ≤ 127²·N < 2³¹),
and dx = (f32(dxa) · sg) in g's dtype.  q4 and the scales get no gradient
(they are frozen).

The kernels compute the same functions on the card: K5a the forward, K5b
the backward (ops/int4_matmul.py, csrc/rq_int4_fwd.cu and
csrc/rq_int4_bwd.cu: a regrid pass into a transient q8 scratch, then an
int8 `wgmma` GEMM), and csrc/rowquant.cu the row quantization.

The W4A16 form (`dtype: int4`, JAX's `kernel_q4`) keeps the same q4 and
scales; its product is the weight dequantized by `dequantize_kernel_int4`
(JAX's default route, ops/layers.py) or the fused W4A16 matmul
(ops/int4_matmul.py:int4_matmul, kernels K6a / K6b on the card).  The other
quantized forms (int8 / fp8 weight-only, W8A8-dynamic, W4A8 per-group) are
not ported yet: `quantize_tree` raises on them.
"""

from __future__ import annotations

import re

import torch


def quantize_kernel_int4(kernel, group_size: int = 128):
    """[…, in, out] float → (packed […, in/2, out] int8, […, in/G, out] f32),
    symmetric int4 per (group, out-channel), G = min(group_size, in)."""
    k = kernel.float()
    *lead, d_in, d_out = k.shape
    g = min(group_size, d_in)
    if d_in % g or d_in % 2:
        raise ValueError(f"in_dim {d_in} must divide group_size {g} and be even")
    grouped = k.reshape(*lead, d_in // g, g, d_out)
    amax = grouped.abs().amax(dim=-2, keepdim=True)            # [..., in/G, 1, out]
    scale = torch.clamp_min(amax / 7.0, 1e-12)
    q = torch.clamp(torch.round(grouped / scale), -8, 7).to(torch.int8)
    q = q.reshape(*lead, d_in, d_out)
    lo, hi = q[..., : d_in // 2, :], q[..., d_in // 2:, :]
    packed = torch.bitwise_or(torch.bitwise_and(lo, 0xF), torch.bitwise_left_shift(hi, 4))
    return packed, scale[..., 0, :]


def _planes(packed):
    """Sign-extended (low, high) nibble planes of packed int4, int8."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)  # arithmetic: signed high nibble
    return lo, hi


def unpack_int4(packed):
    """[…, in/2, out] packed → […, in, out] int8 values in [-8, 7] (low
    nibbles are rows [0, in/2), high nibbles the rest)."""
    return torch.cat(_planes(packed), dim=-2)


def dequantize_kernel_int4(packed, scale, dtype=torch.bfloat16):
    """Inverse of quantize_kernel_int4: [..., in, out] in `dtype` (the f32
    product of value and group scale, cast once)."""
    *lead, half_in, d_out = packed.shape
    d_in = half_in * 2
    n_groups = scale.shape[-2]
    q = unpack_int4(packed)
    grouped = q.reshape(*lead, n_groups, d_in // n_groups, d_out).float()
    return (grouped * scale[..., :, None, :]).reshape(*lead, d_in, d_out).to(dtype)


def _rowquant(x):
    """Dynamic symmetric per-row int8 quantization of the LAST axis →
    (int8 values, f32 scales [..., 1]), as JAX's `_rowquant` runs: always
    under `jit`, where XLA turns `amax / 127.0` into a product with the f32
    reciprocal.  So the scale is that product, written out: a division by a
    Python scalar would be a true division on the CPU and a product on
    CUDA.  The quotient x / s is a true division (tensor by tensor) on both,
    the round half to even.  `ops/int4_matmul.py:rowquant` (csrc/rowquant.cu
    on the card) computes the same bits."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax * (1.0 / 127.0), 1e-12)
    return torch.round(xf / s).to(torch.int8), s


def _requant_factors(g_scale):
    """g_scale [..., K/G, N] → (f [..., K/G, N], s_vec [..., N]), both f32."""
    s = torch.clamp_min(g_scale.amax(dim=-2, keepdim=True), 1e-30)
    f = (g_scale / s) * (127.0 / 7.0)
    s_vec = s[..., 0, :] * (7.0 / 127.0)
    return f.float(), s_vec.float()


def _regrid(values, f):
    """int values [..., n_g, rows, N] × f [..., n_g, N] → int8 on the
    per-channel grid.  Clip before the cast: the packed format admits -8,
    and round(-8 · 127/7) = -145 would wrap."""
    return torch.clamp(torch.round(values.float() * f[..., :, None, :]), -127, 127).to(torch.int8)


def _requant_q8(q4, f):
    """Unpack half-split int4 and regrid onto the per-channel int8 grid →
    [..., K, N] int8.  With an even group count each nibble plane is regridded
    on its own (low plane rows [0, K/2) are groups [0, n_g/2)); with an odd
    one (a group straddles the plane boundary: group_size ≥ K) the planes are
    concatenated first."""
    *lead, half_in, d_out = q4.shape
    n_g = f.shape[-2]
    if n_g % 2:
        g = unpack_int4(q4).reshape(*lead, n_g, 2 * half_in // n_g, d_out)
        return _regrid(g, f).reshape(*lead, 2 * half_in, d_out)
    gh = n_g // 2
    gsz = half_in // gh
    lo, hi = _planes(q4)

    def plane(p, fpart):
        return _regrid(p.reshape(*lead, gh, gsz, d_out), fpart).reshape(*lead, half_in, d_out)

    return torch.cat([plane(lo, f[..., :gh, :]), plane(hi, f[..., gh:, :])], dim=-2)


def _int_product(xq, q8):
    """Exact int8 [M, K] × int8 [K, N] → float64 [M, N] integers."""
    return torch.matmul(xq.to(torch.float64), q8.to(torch.float64))


def _requant_fwd(x, q4, f, s_vec):
    q8 = _requant_q8(q4, f)
    xq, sx = _rowquant(x)
    acc = _int_product(xq.reshape(-1, xq.shape[-1]), q8).reshape(*x.shape[:-1], q4.shape[-1])
    # float64 → float32 rounds the exact integer once, as int32 → float32 does
    return ((acc.to(torch.float32) * sx) * s_vec).to(x.dtype)


def requant_int4_matmul_dx(g, q4, factors):
    """The straight-through backward, plain: g [..., N] (the cotangent of
    the product) → dx [..., K] in g.dtype, as JAX's `_rq4_vjp_bwd`.
    `factors` = (f, s_vec) from `_requant_factors`."""
    f, s_vec = factors
    q8 = _requant_q8(q4, f)
    gq, sg = _rowquant(g.float() * s_vec)
    dxa = _int_product(gq.reshape(-1, gq.shape[-1]), q8.t())
    return (dxa.reshape(*g.shape[:-1], q8.shape[0]).to(torch.float32) * sg).to(g.dtype)


class _RequantInt4Matmul(torch.autograd.Function):
    """The plain forward with the plain straight-through backward; q4 and
    the factors are frozen buffers, saved by reference."""

    @staticmethod
    def forward(ctx, x, q4, f, s_vec):
        ctx.save_for_backward(q4, f, s_vec)
        return _requant_fwd(x, q4, f, s_vec)

    @staticmethod
    def backward(ctx, g):
        q4, f, s_vec = ctx.saved_tensors
        return requant_int4_matmul_dx(g, q4, (f, s_vec)), None, None, None


def requant_int4_matmul(x, q4, g_scale, factors=None):
    """x [..., K] float; q4 [K/2, N] half-split packed int4; g_scale [K/G, N]
    → [..., N] in x.dtype.  The plain version: q8 materialized, the product
    exact in float64; differentiable in x (`requant_int4_matmul_dx`).
    `factors` = (f, s_vec) from `_requant_factors`, if already computed
    (they are a function of g_scale alone)."""
    f, s_vec = factors if factors is not None else _requant_factors(g_scale)
    return _RequantInt4Matmul.apply(x, q4, f, s_vec)


def _jax_path(path: str) -> str:
    """A port module path ("blocks/3/img_mlp/lin_in") → the JAX tree path
    the skip patterns were written for ("blocks/img_mlp/in"): stacked-layer
    indices dropped, the MLP nodes renamed back."""
    names = {"lin_in": "in", "lin_out": "out"}
    return "/".join(names.get(p, p) for p in path.split("/") if not p.isdigit())


def quantize_tree(model, qcfg, prefix: str = ""):
    """Quantize every dense layer of `model` in place (and return it), as
    the JAX `quantize_tree`: layers whose path matches a skip pattern, or
    whose in-dim is odd or not a multiple of the group, stay full precision;
    biases, norms and embeddings are never touched.  A layer that is already
    quantized is left as it is.  `prefix` is `model`'s own path in a larger
    model ("blocks/3/"), for the skip patterns.  `dtype: int4` leaves the
    layers in the W4A16 form (`Dense.set_int4`, JAX's `kernel_q4`),
    `int4_requant` in the W4A8-requant one (`Dense.set_int4_requant`); the
    same q4 and scales either way.  Other dtypes raise."""
    from qflux_tpu_torch.ops.layers import iter_dense_paths

    if qcfg.dtype not in ("int4", "int4_requant"):
        raise NotImplementedError(
            f"quantize dtype {qcfg.dtype!r} is not ported yet (ROADMAP.md, queue 1: \"The "
            "rest of slice B, part 2: the quantized bases that JAX runs in XLA, not "
            "Pallas\"; ported: int4, int4_requant)")
    skip = [re.compile(p) for p in qcfg.skip_patterns]
    group_size = getattr(qcfg, "group_size", 128)
    for path, node in list(iter_dense_paths(model)):
        if node.q4 is not None or any(p.search(_jax_path(prefix + path)) for p in skip):
            continue
        d_in = node.in_dim
        if d_in % 2 or d_in % min(group_size, d_in):
            continue
        with torch.no_grad():
            q4, scale = quantize_kernel_int4(node.weight.t(), group_size)
        if qcfg.dtype == "int4":
            node.set_int4(q4, scale)
        else:
            node.set_int4_requant(q4, scale)
    return model
