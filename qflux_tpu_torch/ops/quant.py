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
(ops/int4_matmul.py:int4_matmul, kernels K6a / K6b on the card).

The other forms, which JAX leaves to XLA, are here too, each equal to its
JAX function (the W8A8 and integer products to the bit):

  * `quantize_kernel` (int8, fp8_e4m3, fp8_e5m2) → q and scales [..., 1,
    N] (JAX's `kernel_q` / `kernel_q_dyn` with `kernel_scale`);
  * `wo_matmul`: weight-only, the weight dequantized to x.dtype and an f32
    product, with JAX's backward (the scale folded into the cotangent,
    then a product with q in x.dtype), not the autograd of the forward;
  * `dyn_int8_matmul`: W8A8, the row-quantized activation against the int8
    weight, exact int32 accumulation, (f32(acc) · sx) · s_w in x.dtype;
    its straight-through dx row-quantizes g · s_w and multiplies by qᵀ
    (ops/int8_matmul.py runs it on the card's int8 GEMM);
  * `dyn_int4_matmul`: W4A8 per group, one exact int8 product per scale
    group, scaled by the group scales and summed over the groups in f32,
    then by the row scale; its dx quantizes g · s_g per (row, group).

Every quantization scale computed here (`quantize_kernel`,
`quantize_kernel_int4`) is a true division, as JAX computes it eagerly
(`Trainer.load_model` quantizes outside `jit`), on either device: the
divisor is a tensor on the input's device (`_div`), since CUDA divides a
tensor by a Python scalar, or by a 0-dim CPU tensor, as a product with the
reciprocal.  The row scales (`_rowquant`, the per-group dx scales) are the
product with fl32(1/127), as JAX computes them under `jit`.

Every product here is a dense layer's base product, and its forward is a
save point of ops/remat.py (`remat.keep`): a block under "dots" keeps its
output (under "dots_all" too the batched one of `dyn_int4_matmul`), and
a block that keeps a dense layer's whole output skips it in the recompute.
"""

from __future__ import annotations

import re

import torch

from qflux_tpu_torch.ops import remat


# the largest magnitude of each per-channel form, and its element type
QMAX = {"int8": 127.0, "fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
QDTYPE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _div(a, d: float):
    """a / d as a true division on a's device: the divisor a tensor there
    (CUDA multiplies by the reciprocal of a Python scalar or a 0-dim CPU
    tensor)."""
    return a / torch.full_like(a, d)


def quantize_kernel(kernel, dtype: str = "int8"):
    """[…, in, out] float → (q […, in, out] int8 / fp8, scale […, 1, out]
    f32), symmetric per output channel: scale = amax / QMAX[dtype] (not
    clamped: an all-zero column keeps 0), q = round(k / max(scale, 1e-12))
    (int8, half to even) or the quotient cast to fp8 (round to nearest
    even).  JAX's `quantize_kernel`, to the bit."""
    if dtype not in QMAX:
        raise ValueError(f"unknown quant dtype {dtype!r}")
    k = kernel.float()
    amax = k.abs().amax(dim=-2, keepdim=True)  # per output channel
    scale = _div(amax, QMAX[dtype])
    v = k / torch.clamp_min(scale, 1e-12)
    q = torch.round(v).to(torch.int8) if dtype == "int8" else v.to(QDTYPE[dtype])
    return q, scale


def dequantize_kernel(q, scale, dtype=torch.bfloat16):
    """(f32(q) · scale) cast once to `dtype`; q and scale broadcast as
    stored (JAX's [K, N] and [1, N], or the port's [N, K] and [N, 1])."""
    return (q.float() * scale).to(dtype)


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
    scale = torch.clamp_min(_div(amax, 7.0), 1e-12)
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


def kept_product(x, n, fn, name=remat.DOT, dtype=None):
    """`fn()`, a base product of x with n outputs, as a remat save point
    (`remat.keep`; skipped, it returns an uninitialised [..., n] in `dtype`,
    x.dtype by default); `name` None for one that no policy keeps."""
    return remat.keep(name, x.device, fn, lambda: torch.empty(
        *x.shape[:-1], n, dtype=dtype or x.dtype, device=x.device))


class _RequantInt4Matmul(torch.autograd.Function):
    """The plain forward with the plain straight-through backward; q4 and
    the factors are frozen buffers, saved by reference."""

    @staticmethod
    def forward(ctx, x, q4, f, s_vec):
        ctx.save_for_backward(q4, f, s_vec)
        return kept_product(x, q4.shape[-1], lambda: _requant_fwd(x, q4, f, s_vec))

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


# ---------------------------------------------------------------------------
# the per-output-channel forms: weight-only (int8 / fp8) and W8A8-dynamic.
# Their q is held as the port's Dense holds a weight, [N, K] (JAX's [K, N]
# transposed), with the channel scales s_vec [N].


def _mm_f32(x2, w):
    """x2 [M, in] @ w^T (w [out, in], x2's dtype) → f32 [M, out]: f32 operands
    in f32; bf16 ones accumulate in f32 and keep the f32 result (cuBLAS
    `out_dtype` on the card; widened operands on the CPU, same math)."""
    if x2.dtype == torch.float32:
        return torch.mm(x2, w.t())
    if x2.is_cuda:
        return torch.mm(x2, w.t(), out_dtype=torch.float32)
    return torch.mm(x2.float(), w.float().t())


class _MatmulF32Out(torch.autograd.Function):
    """`_mm_f32` with a remat save point, and the input gradient autograd
    takes through the same ops (the `aten::mm.dtype` overload has none of
    its own): dx = g @ W, in f32 for an f32 x; for a bf16 x g cast to bf16
    first on the card (bf16 operands, f32 accumulation), the f32 product
    cast to bf16 after it on the CPU (where the forward widened x).  W is a
    frozen base weight: no dW is computed."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(w)
        return kept_product(x2, w.shape[0], lambda: _mm_f32(x2, w), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1]:
            raise RuntimeError("_matmul_f32 differentiates x only: the base weight is frozen")
        (w,) = ctx.saved_tensors
        if w.dtype == torch.float32:
            return torch.mm(g, w), None
        if g.is_cuda:
            return torch.mm(g.to(w.dtype), w), None
        return torch.mm(g, w.float()).to(w.dtype), None


def _matmul_f32(x, w):
    """x @ w^T (w [out, in]) with an f32 result, as `jnp.dot(...,
    preferred_element_type=f32)`: the weight cast to x.dtype, as JAX.  In a
    block that keeps tensors, `_MatmulF32Out` over the rows (the save
    point); elsewhere plain autograd where it has a formula (f32 operands,
    or bf16 ones widened on the CPU: the same ops and casts as
    `_MatmulF32Out`'s backward), so inference and unkept blocks pay no
    autograd.Function per product."""
    w = w.to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if not remat.in_kept_block() and (x.dtype == torch.float32 or not x.is_cuda):
        y = _mm_f32(x2, w)
    else:
        y = _MatmulF32Out.apply(x2, w)
    return y.reshape(*x.shape[:-1], w.shape[0])


class _WoMatmul(torch.autograd.Function):
    """JAX's `wo_matmul`: y = x @ (f32(q) · s)ᵀ cast to x.dtype, in f32; its
    backward is JAX's own, not the autograd of the forward: the cotangent
    scaled by the channel scales in f32 and cast to x.dtype, times q in
    x.dtype with an f32 result, cast to x.dtype.  q and s get no gradient."""

    @staticmethod
    def forward(ctx, x, q, s_vec):
        ctx.save_for_backward(q, s_vec)
        ctx.x_dtype = x.dtype
        return kept_product(x, q.shape[0], lambda: _matmul_f32(
            x, dequantize_kernel(q, s_vec[:, None], x.dtype)), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        q, s_vec = ctx.saved_tensors
        gs = (g.float() * s_vec).to(ctx.x_dtype)
        return _matmul_f32(gs, q.to(ctx.x_dtype).t()).to(ctx.x_dtype), None, None


def wo_matmul(x, q, s_vec):
    """Weight-only product: x [..., K] float; q [N, K] int8 or fp8; s_vec [N]
    f32 → [..., N] f32 (JAX's `wo_matmul`, the int8 / fp8 weight-only
    forms and the tiny-M calls of W8A8), differentiable in x.  On either
    device the weight is dequantized to x.dtype and multiplied: XLA does
    the same in JAX."""
    return _WoMatmul.apply(x, q, s_vec)


def dyn_int8_fwd(x, q, s_vec):
    """The W8A8 forward, plain: x row-quantized (`_rowquant`), the exact
    integer product with q [N, K] (float64), then (f32(acc) · sx) · s_vec,
    one cast to x.dtype.  JAX's `_dyn_fwd_raw` under `jit`, to the bit."""
    xq, sx = _rowquant(x)
    acc = _int_product(xq.reshape(-1, xq.shape[-1]), q.t())
    acc = acc.reshape(*x.shape[:-1], q.shape[0])
    return ((acc.to(torch.float32) * sx) * s_vec).to(x.dtype)


def dyn_int8_dx(g, q, s_vec):
    """The W8A8 straight-through backward, plain: g [..., N] → dx [..., K]
    in g.dtype, as JAX's `_dyn_vjp_bwd` under `jit`: gs = f32(g) · s_vec
    row-quantized to (gq, sg), the exact product gq · q, then f32(dxa) · sg."""
    gq, sg = _rowquant(g.float() * s_vec)
    dxa = _int_product(gq.reshape(-1, gq.shape[-1]), q)
    return (dxa.reshape(*g.shape[:-1], q.shape[1]).to(torch.float32) * sg).to(g.dtype)


class _DynInt8Matmul(torch.autograd.Function):
    """The plain W8A8 forward with the plain straight-through backward."""

    @staticmethod
    def forward(ctx, x, q, s_vec):
        ctx.save_for_backward(q, s_vec)
        return kept_product(x, q.shape[0], lambda: dyn_int8_fwd(x, q, s_vec))

    @staticmethod
    def backward(ctx, g):
        q, s_vec = ctx.saved_tensors
        return dyn_int8_dx(g, q, s_vec), None, None


def dyn_int8_matmul(x, q, s_vec):
    """W8A8-dynamic, plain: x [..., K] float; q [N, K] int8; s_vec [N] f32 →
    [..., N] in x.dtype, differentiable in x (straight through).  The card
    route is ops/int8_matmul.py, which equals it to the bit."""
    return _DynInt8Matmul.apply(x, q, s_vec)


# ---------------------------------------------------------------------------
# W4A8 per group (`int4_dynamic`, JAX's `kernel_q4_dyn`): q4 and the group
# scales in the JAX layout, as the other int4 forms.

# |a| <= 127 (row-quantized) times |b| <= 8 (int4 values) over L terms is an
# exact f32 integer for L below this (127 * 8 * L < 2^24)
_BMM_EXACT_LEN = (1 << 24) // (127 * 8)
# a longer contraction goes in pieces of this many terms, each exact
_BMM_CHUNK = 8192


def _exact_bmm(a, b, f64=False):
    """One exact piece: on the card bf16 operands (int8 values are exact in
    bf16) with an f32 result; on the CPU, or with f64, float64."""
    if a.is_cuda and not f64:
        return torch.bmm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def _int_bmm(a, b, f64=False):
    """Exact batched int8 [B, M, L] × [B, L, N] → f32 [B, M, N], a row-quantized
    (|a| ≤ 127) and b int4 values (|b| ≤ 8), as JAX's int32 `dot_general`
    then its cast to f32.  Below _BMM_EXACT_LEN every partial sum is an
    integer below 2²⁴, exact in f32; a longer contraction (the AdaLN mods'
    dx contracts over N = 18,432) is split into _BMM_CHUNK-term pieces, each
    exact, converted to int32 and added in int32, and the sum cast to f32
    once (the one rounding JAX's cast makes).  `f64`: float64 products on
    the card too (`dyn_int4_fwd`)."""
    length = a.shape[-1]
    if length < _BMM_EXACT_LEN:
        return _exact_bmm(a, b, f64)
    acc = None
    for lo in range(0, length, _BMM_CHUNK):
        part = _exact_bmm(a[..., lo:lo + _BMM_CHUNK], b[..., lo:lo + _BMM_CHUNK, :], f64)
        part = part.to(torch.int32)
        acc = part if acc is None else acc + part
    return acc.to(torch.float32)


def _groups(q4, g_scale):
    """(unpacked int8 values [n_g, G, N], n_g, G) of a [K/2, N] q4."""
    n_g = g_scale.shape[-2]
    d_in = 2 * q4.shape[-2]
    return unpack_int4(q4).reshape(n_g, d_in // n_g, q4.shape[-1]), n_g, d_in // n_g


def dyn_int4_fwd(x, q4, g_scale, f64=False):
    """The W4A8 per-group forward, as JAX's `_dyn4_fwd_raw`: x row-quantized,
    one exact integer product per group (contraction G), each scaled by its
    group scales and summed over the groups in f32, then times the row
    scale, one cast to x.dtype.  The group sum's order is torch's on each
    device, not XLA's (a few f32 ulps apart).  `f64` takes the products in
    float64 on the card as well: the plain version that the card's bf16
    products equal to the bit, since both are exact."""
    q, n_g, gsz = _groups(q4, g_scale)
    xq, sx = _rowquant(x)
    xg = xq.reshape(-1, n_g, gsz).transpose(0, 1)          # [n_g, M, G]
    acc = _int_bmm(xg, q, f64)                               # [n_g, M, N]
    y = (acc * g_scale[:, None, :]).sum(dim=0)
    return (y.reshape(*x.shape[:-1], q4.shape[-1]) * sx).to(x.dtype)


def dyn_int4_dx(g, q4, g_scale, f64=False):
    """Its straight-through backward, as JAX's `_dyn4_vjp_bwd` under `jit`:
    g · s_g quantized per (row, group) with the row scale amax · fl32(1/127),
    one exact product per group with the group's values (contraction N),
    scaled back, one cast to g.dtype (no sum across groups: the same bits
    on either device).  `f64` as in `dyn_int4_fwd`."""
    q, n_g, gsz = _groups(q4, g_scale)
    n = q4.shape[-1]
    gsw = g.float().reshape(-1, 1, n) * g_scale               # [M, n_g, N]
    amax = gsw.abs().amax(dim=-1, keepdim=True)
    s_r = torch.clamp_min(amax * (1.0 / 127.0), 1e-12)        # [M, n_g, 1]
    gq = torch.round(gsw / s_r).to(torch.int8)
    dxa = _int_bmm(gq.transpose(0, 1), q.transpose(1, 2), f64)  # [n_g, M, G]
    dx = dxa.transpose(0, 1) * s_r
    return dx.reshape(*g.shape[:-1], 2 * q4.shape[-2]).to(g.dtype)


class _DynInt4Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q4, g_scale):
        ctx.save_for_backward(q4, g_scale)
        return kept_product(x, q4.shape[-1], lambda: dyn_int4_fwd(x, q4, g_scale),
                            name=remat.DOT_BATCH)

    @staticmethod
    def backward(ctx, g):
        q4, g_scale = ctx.saved_tensors
        return dyn_int4_dx(g, q4, g_scale), None, None


def dyn_int4_matmul(x, q4, g_scale):
    """W4A8 per group: x [..., K] float; q4 [K/2, N] half-split packed int4;
    g_scale [K/G, N] f32 → [..., N] in x.dtype, differentiable in x
    (straight through).  The same torch composition on either device: JAX
    leaves it to XLA, and it has no kernel of its own."""
    return _DynInt4Matmul.apply(x, q4, g_scale)


def _jax_path(path: str) -> str:
    """A port module path ("blocks/3/img_mlp/lin_in") → the JAX tree path
    the skip patterns were written for ("blocks/img_mlp/in"): stacked-layer
    indices dropped, the MLP nodes renamed back."""
    names = {"lin_in": "in", "lin_out": "out"}
    return "/".join(names.get(p, p) for p in path.split("/") if not p.isdigit())


INT4_FORMS = ("int4", "int4_requant", "int4_dynamic")
CHANNEL_FORMS = ("int8", "fp8_e4m3", "fp8_e5m2", "int8_dynamic")


def quantize_tree(model, qcfg, prefix: str = ""):
    """Quantize every dense layer of `model` in place (and return it), as
    the JAX `quantize_tree`, into the form `qcfg.dtype` names
    (`Dense.set_quantized`): layers whose path matches a skip pattern stay
    full precision, and so, for the int4 forms, do layers whose in-dim is
    odd or not a multiple of the group; biases, norms and embeddings are
    never touched.  A layer that is already quantized is left as it is.
    `prefix` is `model`'s own path in a larger model ("blocks/3/"), for the
    skip patterns.  int4, int4_requant and int4_dynamic hold the same q4
    and group scales (`quantize_kernel_int4`); int8, fp8_e4m3, fp8_e5m2
    and int8_dynamic per-channel q and scales (`quantize_kernel`, int8 for
    int8_dynamic)."""
    from qflux_tpu_torch.ops.layers import iter_dense_paths

    form = qcfg.dtype
    if form not in INT4_FORMS + CHANNEL_FORMS:
        raise ValueError(f"unknown quantize dtype {form!r}")
    skip = [re.compile(p) for p in qcfg.skip_patterns]
    group_size = getattr(qcfg, "group_size", 128)
    for path, node in list(iter_dense_paths(model)):
        if node.q_form is not None or any(p.search(_jax_path(prefix + path)) for p in skip):
            continue
        d_in = node.in_dim
        with torch.no_grad():
            if form in INT4_FORMS:
                if d_in % 2 or d_in % min(group_size, d_in):
                    continue
                q, scale = quantize_kernel_int4(node.weight.t(), group_size)
            else:
                q, scale = quantize_kernel(node.weight.t(), "int8" if form == "int8_dynamic"
                                           else form)
                q = q.t()
        node.set_quantized(q, scale, form)
    return model
