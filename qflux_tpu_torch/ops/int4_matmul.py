"""The fused int4 matmuls of the port: the W4A16 dequant matmul, kernels K6a
(forward) and K6b (backward), and the W4A8-requant matmul, kernels K5a
(forward) and K5b (backward).

Counterpart of qflux_tpu/ops/int4_matmul.py.  Both halves take the packed
half-split int4 weight `q4 [K/2, N]` int8 and its group scales `[K/G, N]`
f32 of ops/quant.py.

**W4A16 (`int4_matmul`, the `kernel_q4` form).**  The TPU kernels
`_fwd_kernel` / `_bwd_kernel` unpack each q4 tile in VMEM to bf16 weights
(the f32 product of value and group scale, cast once) and run bf16 dots with
f32 accumulation; the Hopper kernels (`csrc/int4_fwd.cu`, `csrc/int4_bwd.cu`)
do the same with `wgmma` bf16 → f32 over a ring of TMA-filled shared-memory
stages, dequantizing each q4 tile in shared memory, so the bf16 weight never
reaches device memory; `_int4_plan` picks their tiling and, for the narrow
grids, a split of the contraction whose partial sums a second pass adds in
a fixed order.  x (and, in the backward, the
cotangent g) is cast to bf16 first; the result is cast once to x.dtype (dx
to g.dtype), as `_int4_matmul_fwd_impl` / `_int4_vjp_bwd` do.  The plain
versions, `int4_matmul_reference` and `int4_matmul_dx_reference`, compute
exactly that with the weight dequantized (`quant.dequantize_kernel_int4`)
and an f32 product; `int4_matmul_plain` is their autograd.Function.
`int4_matmul(x, q4, scale)`: CPU tensors take the plain version; CUDA
tensors call the custom op `qflux::int4_fwd`, which launches K6a, and whose
registered autograd formula launches K6b, or raise.  `supports` is JAX's
gate at its defaults: it defines where JAX applies the fused W4A16 kernel
(under `QFLUX_FUSED_INT4=1`), whose rounding differs from the dequant
route's, so ops/layers.py routes by it.  `INT4_KERNEL_LAUNCHES` counts K6a's
launches, `INT4_BWD_KERNEL_LAUNCHES` K6b's.

**W4A8-requant (`rq_fused_matmul`, the `kernel_q4_rq` form).**  The TPU
kernels `_rq_fwd_kernel` / `_rq_bwd_kernel` regrid each packed-int4 weight
tile onto the per-channel int8 grid in VMEM and feed it to the int8 MXU, so
q8 never reaches HBM.  The Hopper kernels (`csrc/rq_int4_fwd.cu`,
`csrc/rq_int4_bwd.cu`, shared pieces in `csrc/rq_int4_common.cuh`) regrid
the weight once per call into a transient scratch in the layout `wgmma`'s
int8 B operand wants (K5a: q8ᵀ [N, K]; K5b: q8 [K, N]), then run an int8
GEMM over a TMA ring with `wgmma` s8·s8 → s32; `_rq_plan` picks the split
of the contraction for the narrow grids.  The row quantization in front of
both is one pass too (`rowquant`, `csrc/rowquant.cu`; JAX leaves it to
XLA), equal to `quant._rowquant` to the bit.  `rq_fused_matmul(x, q4,
g_scale)`: on a CUDA tensor it calls the custom op `qflux::rq_int4_fwd`,
which row-quantizes x and launches K5a, or raises; the op's registered
autograd formula row-quantizes the cotangent scaled by the channel scales
and launches K5b, or raises.  On a CPU tensor it runs the plain version,
`quant.requant_int4_matmul`, which both kernels equal bit for bit.  The
TPU's tiling gates (`RQ_BLOCK_*`, `rq_supports`, `_pad_to`) are not needed:
the kernels mask ragged M, N and K and take every int4-requant shape of the
model (K a multiple of 64, N of 16, the group size of 4).
`RQ_KERNEL_LAUNCHES` counts K5a's launches, `RQ_BWD_KERNEL_LAUNCHES` K5b's,
`ROWQUANT_LAUNCHES` the row quantization's.

Both forwards are custom ops with registered autograd formulas, and their
bodies are remat save points (`quant.kept_product`): a "dots" block keeps
K5a's output and replays it in the recompute (K6a's, a pallas_call in JAX,
no policy keeps), and a block that keeps a dense layer's whole output
skips either.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from qflux_tpu_torch.ops.quant import (_requant_factors, _rowquant, dequantize_kernel_int4,
                                      kept_product, requant_int4_matmul)

INT4_KERNEL_LAUNCHES = 0    # K6a, csrc/int4_fwd.cu
INT4_BWD_KERNEL_LAUNCHES = 0  # K6b, csrc/int4_bwd.cu
RQ_KERNEL_LAUNCHES = 0      # K5a, csrc/rq_int4_fwd.cu
RQ_BWD_KERNEL_LAUNCHES = 0  # K5b, csrc/rq_int4_bwd.cu
ROWQUANT_LAUNCHES = 0       # the row quantization before K5a / K5b, csrc/rowquant.cu

# JAX's defaults (qflux_tpu/ops/int4_matmul.py: BLOCK_KP, GROUP), for `supports`
BLOCK_KP = 1536  # packed rows per K tile of the TPU kernel
GROUP = 128      # quantization group size along the original K


def _check(name, t, device, dtype, shape, what="rq_fused_matmul"):
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: {name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} is not contiguous and 16-byte aligned")


# ---------------------------------------------------------------------------
# W4A16: K6a / K6b

def supports(k_in: int, n_out: int, n_groups: int | None = None) -> bool:
    """Where JAX applies the fused W4A16 kernel (qflux_tpu/ops/int4_matmul.py
    `supports` at its defaults, BLOCK_KP 1536 and GROUP 128): group size 128
    (`n_groups` = scale.shape[-2]), K a multiple of 2·BLOCK_KP = 3072, N a
    multiple of 128.  Elsewhere JAX runs the dequant route, whose rounding
    differs (x is not cast to bf16 and the result is f32), so the port
    routes by this rule too; it is behaviour, not a tile choice of the
    Hopper kernels."""
    if n_groups is not None and n_groups * GROUP != k_in:
        return False
    return (k_in % (2 * BLOCK_KP) == 0 and BLOCK_KP % GROUP == 0
            and (k_in // 2) % GROUP == 0 and n_out % 128 == 0)


def int4_matmul_reference(x, q4, scale):
    """The plain W4A16 forward, step by step `_int4_matmul_fwd_impl`: x
    [..., K] cast to bf16; the weight dequantized to bf16 (the f32 product of
    value and group scale, cast once, as `_unpack_tile`); a bf16 × bf16
    product accumulated in f32 (the operands widened, exact); one cast to
    x.dtype.  q4 [K/2, N], scale [K/128, N] → [..., N]."""
    w = dequantize_kernel_int4(q4, scale, torch.bfloat16).float()
    xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).float()
    return torch.matmul(xb, w).reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def int4_matmul_dx_reference(g, q4, scale):
    """The plain W4A16 backward, as `_int4_vjp_bwd`: g [..., N] cast to
    bf16, dx = g · Wᵀ accumulated in f32, one cast to g.dtype → [..., K]."""
    w = dequantize_kernel_int4(q4, scale, torch.bfloat16).float()
    gb = g.reshape(-1, g.shape[-1]).to(torch.bfloat16).float()
    return torch.matmul(gb, w.t()).reshape(*g.shape[:-1], w.shape[0]).to(g.dtype)


class _Int4Matmul(torch.autograd.Function):
    """The plain forward with the plain backward; q4 and the scales are
    frozen buffers, saved by reference, and get no gradient."""

    @staticmethod
    def forward(ctx, x, q4, scale):
        ctx.save_for_backward(q4, scale)
        # a save point that keeps nothing (the plain K6a, JAX's pallas_call,
        # is no dot a "dots" policy keeps), but is skipped as a base product
        return kept_product(x, q4.shape[-1], lambda: int4_matmul_reference(x, q4, scale),
                            name=None)

    @staticmethod
    def backward(ctx, g):
        q4, scale = ctx.saved_tensors
        return int4_matmul_dx_reference(g, q4, scale), None, None


def int4_matmul_plain(x, q4, scale):
    """The plain version, differentiable in x, on any device: what
    `int4_matmul` runs on CPU tensors, and the card's comparison point."""
    return _Int4Matmul.apply(x, q4, scale)


def _int4_checks(what, t, q4, scale, out_dtype):
    """The rules K6a and K6b share; returns (half, N, n_groups)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on CUDA tensors, got {t.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: output dtype {out_dtype}; the kernel writes bfloat16 or "
                         "float32")
    half, n = q4.shape
    n_groups = scale.shape[0]
    if not supports(2 * half, n, n_groups):
        raise ValueError(f"{what}: K={2 * half}, N={n}, {n_groups} groups; the kernel takes "
                         "what `supports` admits (group 128, K % 3072 == 0, N % 128 == 0)")
    _check("q4", q4, t.device, torch.int8, (half, n), what)
    _check("scale", scale, t.device, torch.float32, (n_groups, n), what)
    return half, n, n_groups


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    """How K6a or K6b covers one call: `mt` m64 tiles per consumer
    warpgroup (a block computes 128·mt rows), `splits` blocks along the
    contraction, `blocks` in the grid, and the f32 workspace of the partial
    sums (`workspace` elements, 0 when the contraction is not split)."""

    mt: int
    splits: int
    blocks: int
    workspace: int


@functools.lru_cache(maxsize=4096)
def _int4_plan(m: int, n: int, k_in: int, sms: int = 132, backward: bool = False) -> Int4Plan:
    """The tiling of K6a (x [m, k_in] · W → [m, n]) or, with `backward`, of
    K6b (g [m, n] · Wᵀ → dx [m, k_in]) on a card with `sms` SMs.

    A block computes 128·mt rows × 128 output columns (K6a: 128 of N; K6b:
    64 packed rows, both planes) and walks the contraction in 128-row chunks
    (K6a: packed rows, so a chunk is one scale group of each plane; K6b:
    columns of N).  Where the output tiles fill less than one wave, the
    contraction is split into `splits` ranges of whole chunks, as many as
    keep the grid within one wave (a block past it would start a second
    round and double the call); the partial sums go to an f32 workspace
    [splits, m, out columns] and a second pass adds them in split order, so
    a call is deterministic.  mt is 1 or 2, whichever gives
    the shorter estimate: waves × chunks a block walks × the block's time
    per chunk, which at mt = 1 is `_MT1_COST` of mt = 2's (half the rows,
    but the same weight tile to load and dequantize)."""
    cols = k_in // 128 if backward else n // 128
    chunks = n // 128 if backward else k_in // 2 // 128
    best = None
    for mt in (2, 1):
        tiles = -(-m // (128 * mt)) * cols
        splits = 1 if tiles >= sms else max(1, min(chunks, sms // tiles))
        cost = (-(-tiles * splits // sms) * -(-chunks // splits)
                * (_MT1_COST if mt == 1 else 1.0))
        if best is None or cost < best[0]:
            best = (cost, mt, splits, tiles)
    _, mt, splits, tiles = best
    ws = splits * m * (k_in if backward else n) if splits > 1 else 0
    return Int4Plan(mt=mt, splits=splits, blocks=tiles * splits, workspace=ws)


# a 128-row block's time per chunk relative to a 256-row block's (measured on
# an H100 at the Qwen shapes: 0.56-0.75)
_MT1_COST = 0.65


@functools.lru_cache(maxsize=4096)
def _device_plan(index: int, m: int, n: int, k_in: int, backward: bool) -> Int4Plan:
    """`_int4_plan` for the card `index` (its SM count)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _int4_plan(m, n, k_in, sms, backward)


# the split contractions' workspace, one per (device, stream), grown to the
# largest call's need (15.7 MB at the Qwen DiT's shapes) and reused: the
# kernels on one stream run in order, so a call never overwrites partial
# sums another is still reading, and the wrapper allocates nothing per call
_WORKSPACE: dict = {}


def _workspace(device, stream: int, numel: int):
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < numel:
        ws = _WORKSPACE[key] = torch.empty(numel, device=device, dtype=torch.float32)
    return ws


def _int4_launch(fn, what, t, q4, scale, out, m, n, half, n_groups, backward):
    """Plan, take the workspace and launch one K6 entry point."""
    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    plan = _device_plan(t.device.index or 0, m, n, 2 * half, backward)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    ws = _workspace(t.device, stream, plan.workspace).data_ptr() if plan.workspace else None
    code = getattr(kl.lib, fn)(t.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
                               m, n, 2 * half, n_groups, int(out.dtype == torch.float32),
                               plan.mt, plan.splits, ws, stream)
    kl.check(code, what)


def int4_fwd_cuda(xb, q4, scale, out_dtype):
    """Launch K6a on CUDA tensors: xb [M, K] bf16, q4 [K/2, N] int8, scale
    [K/128, N] f32 → [M, N] in out_dtype (bf16 or f32), tiled by
    `_int4_plan`.  Raises on anything the kernel does not take and on a CUDA
    error.  Counting is the caller's."""
    half, n, n_groups = _int4_checks("int4_matmul", xb, q4, scale, out_dtype)
    m = xb.shape[0]
    _check("x", xb, xb.device, torch.bfloat16, (m, 2 * half), "int4_matmul")
    out = torch.empty((m, n), device=xb.device, dtype=out_dtype)
    _int4_launch("qflux_int4_fwd", "int4_fwd launch", xb, q4, scale, out, m, n, half, n_groups,
                 False)
    return out


def int4_bwd_cuda(gb, q4, scale, out_dtype):
    """Launch K6b on CUDA tensors: gb [M, N] bf16, q4 [K/2, N] int8, scale
    [K/128, N] f32 → dx [M, K] in out_dtype (bf16 or f32), tiled by
    `_int4_plan(backward=True)`.  Raises on anything the kernel does not take
    and on a CUDA error.  Counting is the caller's."""
    half, n, n_groups = _int4_checks("int4_matmul backward", gb, q4, scale, out_dtype)
    m = gb.shape[0]
    _check("g", gb, gb.device, torch.bfloat16, (m, n), "int4_matmul backward")
    dx = torch.empty((m, 2 * half), device=gb.device, dtype=out_dtype)
    _int4_launch("qflux_int4_bwd", "int4_bwd launch", gb, q4, scale, dx, m, n, half, n_groups,
                 True)
    return dx


# The custom op runs on every device type: on a CUDA tensor it launches K6a,
# on any other `int4_fwd_cuda` raises (the public entry point sends CPU
# tensors to the plain version before they reach it).
@torch.library.custom_op("qflux::int4_fwd", mutates_args=(),
                         schema="(Tensor x, Tensor q4, Tensor scale) -> Tensor")
def _int4_fwd_op(x, q4, scale):
    def launch():
        global INT4_KERNEL_LAUNCHES
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
        y = int4_fwd_cuda(xb, q4, scale, x.dtype)
        INT4_KERNEL_LAUNCHES += 1
        return y.reshape(*x.shape[:-1], q4.shape[-1])

    # skipped as a base product, kept by no policy: JAX's K6a is a
    # pallas_call, not a dot
    return kept_product(x, q4.shape[-1], launch, name=None)


def _int4_setup_context(ctx, inputs, output):
    # the residuals of _int4_vjp_fwd: the frozen weight, by reference
    _, q4, scale = inputs
    ctx.save_for_backward(q4, scale)


def _int4_backward(ctx, g):
    """dx through K6b, as `_int4_vjp_bwd`: g cast to bf16, dx in g's dtype.
    q4 and the scales get no gradient."""
    global INT4_BWD_KERNEL_LAUNCHES
    q4, scale = ctx.saved_tensors
    gb = g.reshape(-1, g.shape[-1]).to(torch.bfloat16).contiguous()
    dx = int4_bwd_cuda(gb, q4, scale, g.dtype)
    INT4_BWD_KERNEL_LAUNCHES += 1
    return dx.reshape(*g.shape[:-1], dx.shape[-1]), None, None


torch.library.register_autograd("qflux::int4_fwd", _int4_backward,
                                setup_context=_int4_setup_context)


def int4_matmul(x, q4, scale):
    """y = x @ dequant(q4, scale) as JAX's fused W4A16 kernel computes it:
    x [..., K] float; q4 [K/2, N] half-split packed int4; scale [K/128, N]
    f32 → [..., N] in x.dtype, differentiable in x.  Takes what `supports`
    admits.  CUDA tensors launch K6a (and K6b in the backward) or raise; CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale)
    return _int4_fwd_op(x, q4, scale)


# ---------------------------------------------------------------------------
# W4A8-requant: the row quantization, K5a / K5b


def rowquant_cuda(x, s_vec=None):
    """The row quantization on the card (csrc/rowquant.cu): x [M, K] bf16 or
    f32 (times s_vec [K] f32 first, when given) → (xq [M, K] int8, s [M, 1]
    f32), equal to `quant._rowquant(x.float() * s_vec)` to the bit.  Raises on
    anything the kernel does not take and on a CUDA error.  Counting is the
    caller's."""
    if x.device.type != "cuda":
        raise ValueError(f"rowquant: the kernel runs on CUDA tensors, got {x.device}")
    _rowquant_checks(x, s_vec)
    m, k = x.shape
    xq = torch.empty((m, k), device=x.device, dtype=torch.int8)
    s = torch.empty((m, 1), device=x.device, dtype=torch.float32)
    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    _rowquant_launch(kl, torch.cuda.current_stream(x.device).cuda_stream, x, s_vec, xq, s)
    return xq, s


def _rowquant_checks(x, s_vec):
    """The row-quantization kernel's rules on x [M, K] and s_vec [K]."""
    what = "rowquant"
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: x is {x.dtype} of shape {tuple(x.shape)}; the kernel takes "
                         "[M, K] bfloat16 or float32")
    m, k = x.shape
    if m == 0 or k % 8:
        raise ValueError(f"{what}: M={m}, K={k}; the kernel takes M > 0 and K % 8 == 0")
    _check("x", x, x.device, x.dtype, (m, k), what)
    if s_vec is not None:
        _check("s_vec", s_vec, x.device, torch.float32, (k,), what)


def _rowquant_launch(kl, stream, x, s_vec, xq, s):
    code = kl.lib.qflux_rowquant(x.data_ptr(), None if s_vec is None else s_vec.data_ptr(),
                                 xq.data_ptr(), s.data_ptr(), x.shape[0], x.shape[1],
                                 int(x.dtype == torch.float32), stream)
    kl.check(code, "rowquant launch")


def rowquant(x, s_vec=None):
    """Row-quantize x [M, K] (times s_vec [K] first, when given: K5b's
    g · s_vec) → (xq int8, s [M, 1] f32).  A CUDA tensor launches the kernel
    (counted in ROWQUANT_LAUNCHES) or raises; a CPU tensor takes the plain
    version, `quant._rowquant`."""
    global ROWQUANT_LAUNCHES
    if x.device.type == "cpu":
        return _rowquant(x if s_vec is None else x.float() * s_vec)
    out = rowquant_cuda(x.contiguous(), s_vec)
    ROWQUANT_LAUNCHES += 1
    return out


def kernel_group_size(k_in: int, n_out: int, n_groups: int) -> int:
    """The group size K5a and K5b use for a [K/2, N] weight with `n_groups`
    groups; raises on a shape the kernels do not take."""
    if k_in % 64 or n_out % 16 or n_groups <= 0 or k_in % n_groups or (k_in // n_groups) % 4:
        raise ValueError(f"rq_fused_matmul: K={k_in}, N={n_out}, {n_groups} groups; the "
                         "kernel takes K % 64 == 0, N % 16 == 0 and a group size that is a "
                         "multiple of 4")
    return k_in // n_groups


@dataclasses.dataclass(frozen=True)
class RqPlan:
    """How K5a or K5b covers one call: `splits` ranges of the contraction
    (the GEMM's grid is output tiles × splits), the int32 workspace of the
    split partial sums (`workspace` elements, 0 when the contraction is not
    split) and the bytes of the regridded weight q8 (`scratch`)."""

    splits: int
    workspace: int
    scratch: int


# the GEMM's tile (csrc/rq_int4_common.cuh): BM rows x BN output columns, the
# contraction in stages of BK bytes
RQ_BM, RQ_BN, RQ_BK = 256, 128, 128


@functools.lru_cache(maxsize=4096)
def _rq_plan(m: int, n: int, k_in: int, gsz: int, sms: int = 132,
             backward: bool = False) -> RqPlan:
    """The tiling of K5a (xq [m, k_in] · q8 → [m, n]) or, with `backward`, of
    K5b (gq [m, n] · q8ᵀ → dx [m, k_in]) on a card with `sms` SMs; raises on
    a shape the kernels do not take (`kernel_group_size`).

    A block computes RQ_BM rows × RQ_BN output columns (K5a: of N; K5b: of K)
    and walks the contraction (K5a: K; K5b: N) in stages of RQ_BK.  Where the
    output tiles fill less than one wave, the contraction is split into
    `splits` ranges of whole stages, as many as keep the grid within one wave;
    the int32 partial sums go to a workspace [splits, m, out columns] and a
    second pass adds them (exact, so the result is the unsplit one to the
    bit).  The weight is regridded once per call into a K·N-byte scratch."""
    kernel_group_size(k_in, n, k_in // gsz if gsz and k_in % gsz == 0 else 0)
    out_cols, contraction = (k_in, n) if backward else (n, k_in)
    tiles = -(-m // RQ_BM) * -(-out_cols // RQ_BN)
    chunks = -(-contraction // RQ_BK)
    splits = 1 if tiles >= sms else max(1, min(chunks, sms // tiles))
    ws = splits * m * out_cols if splits > 1 else 0
    return RqPlan(splits=splits, workspace=ws, scratch=k_in * n)


@functools.lru_cache(maxsize=4096)
def _rq_device_plan(index: int, m: int, n: int, k_in: int, gsz: int, backward: bool) -> RqPlan:
    """`_rq_plan` for the card `index` (its SM count)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _rq_plan(m, n, k_in, gsz, sms, backward)


# K5a's and K5b's scratch, one byte buffer per (device, stream): the
# regridded weight q8 at its start, the split partial sums after it; grown to
# the largest call's need (~53 MB at the Qwen DiT's shapes) and reused, as
# the K6 workspace is (the kernels on one stream run in order)
_RQ_SCRATCH: dict = {}


def _rq_buffers(device, stream: int, plan: RqPlan):
    """(q8 scratch pointer, workspace pointer or None) for `plan`."""
    q8_bytes = -(-plan.scratch // 256) * 256
    need = q8_bytes + 4 * plan.workspace
    key = (device.index, stream)
    buf = _RQ_SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = _RQ_SCRATCH[key] = torch.empty(need, device=device, dtype=torch.uint8)
    ptr = buf.data_ptr()
    return ptr, (ptr + q8_bytes if plan.workspace else None)


def _check_common(what, t, q4, f, out_dtype):
    """The rules K5a and K5b share; returns (half, N, group size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on CUDA tensors, got {t.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: output dtype {out_dtype}; the kernel writes bfloat16 or "
                         "float32")
    half, n = q4.shape
    gsz = kernel_group_size(2 * half, n, f.shape[0])
    _check("q4", q4, t.device, torch.int8, (half, n))
    _check("f", f, t.device, torch.float32, (2 * half // gsz, n))
    return half, n, gsz


def _rq_fwd_launch(kl, stream, xq, q4, f, sx, s_vec, out, gsz, plan, q8, ws):
    m, k_in = xq.shape
    code = kl.lib.qflux_rq_int4_fwd(xq.data_ptr(), q4.data_ptr(), f.data_ptr(), sx.data_ptr(),
                                    s_vec.data_ptr(), out.data_ptr(), m, q4.shape[1], k_in, gsz,
                                    int(out.dtype == torch.float32), plan.splits, q8, ws, stream)
    kl.check(code, "rq_int4_fwd launch")


def _rq_bwd_launch(kl, stream, gq, q4, f, sg, dx, gsz, plan, q8, ws):
    m, n = gq.shape
    code = kl.lib.qflux_rq_int4_bwd(gq.data_ptr(), q4.data_ptr(), f.data_ptr(), sg.data_ptr(),
                                    dx.data_ptr(), m, n, dx.shape[1], gsz,
                                    int(dx.dtype == torch.float32), plan.splits, q8, ws, stream)
    kl.check(code, "rq_int4_bwd launch")


def rq_int4_fwd_cuda(xq, q4, f, sx, s_vec, out_dtype):
    """Launch K5a on CUDA tensors: xq [M, K] int8, q4 [K/2, N] int8, f [K/G,
    N] f32, sx [M] (or [M, 1]) f32, s_vec [N] f32 → [M, N] in out_dtype
    (bf16 or f32), tiled by `_rq_plan`.  Raises on anything the kernel does
    not take and on a CUDA error.  Counting is the caller's."""
    half, n, gsz = _check_common("rq_fused_matmul", xq, q4, f, out_dtype)
    m, k_in = xq.shape
    if 2 * half != k_in:
        raise ValueError(f"rq_fused_matmul: x has K={k_in}, q4 {tuple(q4.shape)}")
    dev = xq.device
    sx = sx.reshape(m)
    _check("xq", xq, dev, torch.int8, (m, k_in))
    _check("sx", sx, dev, torch.float32, (m,))
    _check("s_vec", s_vec, dev, torch.float32, (n,))

    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    plan = _rq_device_plan(dev.index or 0, m, n, k_in, gsz, False)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((m, n), device=dev, dtype=out_dtype)
    _rq_fwd_launch(kl, stream, xq, q4, f, sx, s_vec, out, gsz, plan,
                   *_rq_buffers(dev, stream, plan))
    return out


def rq_int4_bwd_cuda(gq, q4, f, sg, out_dtype):
    """Launch K5b on CUDA tensors: gq [M, N] int8 (the row-quantized g ·
    s_vec), q4 [K/2, N] int8, f [K/G, N] f32, sg [M] (or [M, 1]) f32 → dx
    [M, K] in out_dtype (bf16 or f32), tiled by `_rq_plan(backward=True)`.
    Raises on anything the kernel does not take and on a CUDA error.
    Counting is the caller's."""
    half, n, gsz = _check_common("rq_fused_matmul backward", gq, q4, f, out_dtype)
    m = gq.shape[0]
    dev = gq.device
    sg = sg.reshape(m)
    _check("gq", gq, dev, torch.int8, (m, n))
    _check("sg", sg, dev, torch.float32, (m,))

    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    plan = _rq_device_plan(dev.index or 0, m, n, 2 * half, gsz, True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dx = torch.empty((m, 2 * half), device=dev, dtype=out_dtype)
    _rq_bwd_launch(kl, stream, gq, q4, f, sg, dx, gsz, plan, *_rq_buffers(dev, stream, plan))
    return dx


# The custom op runs on every device type: on a CUDA tensor it launches the
# row quantization and K5a, on any other `rq_int4_fwd_cuda` raises (the
# public entry point sends CPU tensors to the plain version before they
# reach it).
@torch.library.custom_op("qflux::rq_int4_fwd", mutates_args=(),
                         schema="(Tensor x, Tensor q4, Tensor f, Tensor s_vec) -> Tensor")
def _rq_fwd_op(x, q4, f, s_vec):
    def launch():
        global RQ_KERNEL_LAUNCHES
        xq, sx = rowquant(x.reshape(-1, x.shape[-1]))
        y = rq_int4_fwd_cuda(xq, q4, f, sx, s_vec, x.dtype)
        RQ_KERNEL_LAUNCHES += 1
        return y.reshape(*x.shape[:-1], q4.shape[-1])

    # a "dots" policy keeps it: JAX's route is XLA's requant dot
    return kept_product(x, q4.shape[-1], launch)


def _rq_setup_context(ctx, inputs, output):
    # the residuals of _rqf_vjp_fwd: the frozen weight, by reference
    _, q4, f, s_vec = inputs
    ctx.save_for_backward(q4, f, s_vec)


def _rq_backward(ctx, g):
    """dx through K5b, as `_rqf_vjp_bwd`: gs = f32(g) · s_vec row-quantized
    (one pass, csrc/rowquant.cu), K5b's exact integer product scaled by the
    row scales, in g's dtype.  q4 and the factors get no gradient."""
    global RQ_BWD_KERNEL_LAUNCHES
    q4, f, s_vec = ctx.saved_tensors
    gq, sg = rowquant(g.reshape(-1, g.shape[-1]), s_vec)
    dx = rq_int4_bwd_cuda(gq, q4, f, sg, g.dtype)
    RQ_BWD_KERNEL_LAUNCHES += 1
    return dx.reshape(*g.shape[:-1], dx.shape[-1]), None, None, None


torch.library.register_autograd("qflux::rq_int4_fwd", _rq_backward,
                                setup_context=_rq_setup_context)


def rq_fused_matmul(x, q4, g_scale, factors=None):
    """y = x @ dequant(q4, g_scale) on the W4A8-requant grid: x [..., K]
    float; q4 [K/2, N] half-split packed int4; g_scale [K/G, N] f32 →
    [..., N] in x.dtype, differentiable in x.  `factors` = (f, s_vec) from
    `_requant_factors`, if cached.  CUDA tensors launch the row quantization
    and K5a (and the row quantization and K5b in the backward) or raise; CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return requant_int4_matmul(x, q4, g_scale, factors)
    f, s_vec = factors if factors is not None else _requant_factors(g_scale)
    return _rq_fwd_op(x, q4, f, s_vec)
