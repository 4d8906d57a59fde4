"""The port's W4A16 int4 base (`quantize.dtype: int4`, JAX's `kernel_q4`):
the plain versions of kernels K6a / K6b (qflux_tpu_torch/ops/int4_matmul.py),
the `kernel_q4` route of `dense` (ops/layers.py), `quantize_tree`, the
bridge and the tiny Qwen DiT, against the JAX package's, on the CPU.

The JAX side runs the Pallas kernels in interpret mode, as
tests/ops/test_int4_matmul_kernel.py does (K = 3072, N = 640), and reads
`QFLUX_FUSED_INT4` at call time, as the port does.  Tolerances, stated at
each test, follow from one fact: both sides multiply the same bf16 weights
(dequantized to the bit, tests/test_torch_quant.py) by the same bf16
activations, and every product is exact in f32, so only the order of the
f32 sums differs (the Pallas kernel sums each nibble plane's tile, then
adds them; the plain version one product over K).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.models.qwen import transformer as jqwen
from qflux_tpu.ops import int4_matmul as ji4
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops import quant as jquant
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.ops import int4_matmul as ti4
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import quant as tquant
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_qwen import (BF16_TOL, F32_TOL, GH, GW, JCFG, TCFG, _inputs, _jax_dit,
                                   _lora, _np_tree, _port, _segments)

K, N = 3072, 640
INT4 = config_from_dict({"model": {"quantize": {"enabled": True, "dtype": "int4"}}}
                        ).model.quantize
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(j):
    return np.asarray(jnp.asarray(j).astype(jnp.float32))


def _close(t, j, dtype):
    """f32: within 1e-6 of max |ref| (measured 2.5e-7: f32 sums over K =
    3072 in another order).  bf16: every element within one bf16 ulp of
    itself (2^-7 relative): the f32 sums differ by that order only, and a
    sum that lands on the other side of a rounding boundary moves one ulp
    (measured 3 of 13,440 elements)."""
    t, j = t.detach().float().numpy(), _np(j)
    assert t.shape == j.shape
    if dtype == "f32":
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6 * np.abs(j).max())
    else:
        np.testing.assert_allclose(t, j, rtol=2 ** -7, atol=1e-30)


@pytest.fixture(scope="module")
def qw():
    """A [K, N] weight quantized by JAX, as numpy, and as torch tensors."""
    w = (np.random.default_rng(0).standard_normal((K, N)) * 0.05).astype(np.float32)
    q4, s = jquant.quantize_kernel_int4(jnp.asarray(w), 128)
    return q4, s, torch.from_numpy(np.array(q4)), torch.from_numpy(np.array(s))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("lead", [(3, 7), (1,)], ids=["lead_3x7", "m1"])
def test_plain_fwd_matches_pallas_kernel(qw, lead, dtype):
    """(a) int4_matmul_reference against JAX `int4_matmul` (the Pallas
    `_fwd_kernel` in interpret mode): x in bf16 and f32, leading dims (3, 7)
    and one row; the result in x.dtype.  Tolerance: `_close`."""
    q4, s, tq, ts = qw
    jdt, tdt = _DT[dtype]
    x = np.random.default_rng(1).standard_normal(lead + (K,)).astype(np.float32)
    j = ji4.int4_matmul(jnp.asarray(x).astype(jdt), q4, s)
    t = ti4.int4_matmul_reference(torch.from_numpy(x).to(tdt), tq, ts)
    assert t.dtype == tdt and j.dtype == jdt
    _close(t, j, dtype)
    # the entry point takes the plain version on CPU tensors
    assert torch.equal(ti4.int4_matmul(torch.from_numpy(x).to(tdt), tq, ts), t)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("lead", [(3, 7), (1,)], ids=["lead_3x7", "m1"])
def test_plain_dx_matches_pallas_vjp(qw, lead, dtype):
    """(b) int4_matmul_dx_reference, and the backward of the CPU entry
    point, against `jax.vjp` of `int4_matmul` (the Pallas `_bwd_kernel` in
    interpret mode): dx in g's dtype, no gradient for q4 or the scales.
    Tolerance: `_close` (measured 1.5e-7 of max in f32, 5 of 64,512
    elements one ulp apart in bf16)."""
    q4, s, tq, ts = qw
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    g = rng.standard_normal(lead + (N,)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: ji4.int4_matmul(a, q4, s), jnp.asarray(x).astype(jdt))
    (jdx,) = vjp(jnp.asarray(g).astype(jdt))
    tg = torch.from_numpy(g).to(tdt)
    dx = ti4.int4_matmul_dx_reference(tg, tq, ts)
    assert dx.dtype == tdt and dx.shape == tuple(lead) + (K,)
    _close(dx, jdx, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ti4.int4_matmul(tx, tq, ts).backward(tg)
    assert torch.equal(tx.grad, dx)
    assert tq.grad is None and ts.grad is None


# every dense (K, N) of the Qwen DiT, with whether JAX's fused kernel takes it
QWEN_SHAPES = [((3072, 3072), True), ((3072, 12288), True), ((12288, 3072), True),
               ((3072, 18432), True), ((3584, 3072), False), ((64, 3072), False),
               ((256, 3072), False), ((3072, 64), False)]


@pytest.mark.parametrize("kn,fused", QWEN_SHAPES, ids=[f"{k}x{n}" for (k, n), _ in QWEN_SHAPES])
def test_supports_matches_jax(kn, fused):
    """(c) The port's `supports` is JAX's at its defaults, at every dense
    shape of the Qwen DiT with group 128 (K / 128 groups), and refuses the
    same shapes with another group size."""
    k_in, n = kn
    for n_groups in (None, max(k_in // 128, 1), max(k_in // 64, 1), 1):
        assert ti4.supports(k_in, n, n_groups) == ji4.supports(k_in, n, n_groups), n_groups
    assert ti4.supports(k_in, n, k_in // 128) == fused
    assert not ti4.supports(k_in, n, k_in // 64)


PLAN_M = [1, 2, 256, 512, 2048, 4096]
PLAN_KN = [kn for kn, fused in QWEN_SHAPES if fused]


@pytest.mark.parametrize("backward", [False, True], ids=["k6a", "k6b"])
@pytest.mark.parametrize("kn", PLAN_KN, ids=[f"{k}x{n}" for k, n in PLAN_KN])
@pytest.mark.parametrize("m", PLAN_M)
def test_int4_plan_splits_on_whole_groups(m, kn, backward):
    """(h) `_int4_plan`, the tiling K6a / K6b launch with, at every row count
    of path C (M = 1-2: the AdaLN mods; 256: the text stream; 2048 / 4096:
    the image stream at bs=1 / 2; 512 between) and every (K, N) of the Qwen
    DiT that `supports` admits, on a 132-SM card.  The kernels cut split z's
    chunks as [z·chunks / splits, (z + 1)·chunks / splits): those ranges
    cover the contraction exactly, none is empty, and each is whole 128-row
    chunks: for K6a packed rows, so each split holds whole scale groups of
    both nibble planes (rows kp and K/2 + kp); for K6b columns of N.  Grids
    that fill a wave are not split; narrower ones are split into as many
    ranges as keep the grid within one wave (one more would start a second
    round of blocks: on the card 144 blocks of 8 chunks took longer than 72
    of 16), and into at least two wherever two fit.  The workspace is
    splits × M × (output columns) f32, none without a split."""
    k_in, n = kn
    sms = 132
    plan = ti4._int4_plan(m, n, k_in, sms, backward)
    cols = k_in // 128 if backward else n // 128
    chunks = n // 128 if backward else k_in // 2 // 128
    tiles = -(-m // (128 * plan.mt)) * cols
    assert plan.mt in (1, 2) and 1 <= plan.splits <= chunks
    assert plan.blocks == tiles * plan.splits
    ranges = [(z * chunks // plan.splits, (z + 1) * chunks // plan.splits)
              for z in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    if not backward:
        half, group = k_in // 2, 128
        for a, b in ranges:  # packed rows [128 a, 128 b): whole groups in both planes
            assert (128 * a) % group == 0 and (128 * (b - a)) % group == 0
            assert (half + 128 * a) % group == 0
    if tiles >= sms:
        assert plan.splits == 1
    else:
        assert plan.blocks <= sms
        assert plan.splits == chunks or plan.blocks + tiles > sms
        assert plan.splits >= 2 or 2 * tiles > sms
    out_cols = k_in if backward else n
    assert plan.workspace == (plan.splits * m * out_cols if plan.splits > 1 else 0)


def test_int4_plan_at_the_narrow_shapes():
    """(h) The shapes the split is for, stated: the text stream's M = 256
    against the MLP down-projection (K = 12288, N = 3072) runs 256-row
    blocks, 24 column tiles split five ways (120 blocks, 15.7 MB of f32
    partial sums), and its dx (K6b, the MLP up-projection's dx at M = 256)
    likewise; an AdaLN mod's dx (M = 1, N = 18432) is split over N five
    ways; the mods' forward (M = 1, K = 3072, N = 18432) fills 144 blocks
    unsplit; the image stream's MLP up-projection at bs=1 (the main shape)
    is unsplit, 256-row blocks."""
    p = ti4._int4_plan(256, 3072, 12288, 132)
    assert (p.mt, p.splits, p.blocks, p.workspace) == (2, 5, 120, 5 * 256 * 3072)
    p = ti4._int4_plan(256, 12288, 3072, 132, backward=True)
    assert (p.mt, p.splits, p.blocks) == (2, 5, 120)
    p = ti4._int4_plan(1, 18432, 3072, 132, backward=True)
    assert (p.mt, p.splits, p.blocks, p.workspace) == (1, 5, 120, 5 * 3072)
    p = ti4._int4_plan(1, 18432, 3072, 132)
    assert (p.mt, p.splits, p.blocks, p.workspace) == (1, 1, 144, 0)
    p = ti4._int4_plan(2048, 12288, 3072, 132)
    assert (p.mt, p.splits, p.blocks, p.workspace) == (2, 1, 768, 0)


def _q4_node(rng, k_in, n):
    jq, js = jquant.quantize_kernel_int4(
        jnp.asarray((rng.uniform(-1, 1, (k_in, n)) / np.sqrt(k_in)).astype(np.float32)), 128)
    return {"kernel_q4": np.asarray(jq), "kernel_scale": np.asarray(js),
            "bias": (rng.standard_normal(n) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("fused", [True, False], ids=["fused_opt_in", "dequant_default"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 40])
def test_dense_kernel_q4_matches_jax(monkeypatch, m, dtype, fused):
    """(d) `dense` over a bridged `kernel_q4` node (K = 3072, N = 256) with a
    LoRA and a bias, against JAX `dense`, with QFLUX_FUSED_INT4 set for both
    packages (the fused route: the base product in x.dtype, so the delta and
    the bias add in x.dtype) and unset (JAX's default: the weight
    dequantized to x.dtype, an f32 base product).  No tiny-M rule: M = 1
    takes the same route.  Tolerance, against the largest |output|: float
    GEMMs over K = 3072 summed in another order (the base product, the
    LoRA dots): f32 to 1e-5 (measured 5.3e-7), bf16 to 2^-8, one bf16 ulp
    at the output's scale (measured one ulp on 3 of 10,240 elements)."""
    if fused:
        monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
    else:
        monkeypatch.delenv("QFLUX_FUSED_INT4", raising=False)
    rng = np.random.default_rng(10 + m)
    node = _q4_node(rng, K, 256)
    a = rng.standard_normal((K, 4)).astype(np.float32) / 4
    b = rng.standard_normal((4, 256)).astype(np.float32) * 0.1
    mod = bridge.load_params(tlayers.Dense(K, 256), node)
    assert mod.weight is None and mod.q_form == "int4" and mod.rq_f is None
    jdt, tdt = _DT[dtype]
    x = rng.standard_normal((m, K)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    # the base product alone: its dtype tells the route
    base_j = jlayers._base_matmul({k: jnp.asarray(v) for k, v in node.items()}, jx)
    base_t = tlayers._base_matmul(mod, tx)
    assert base_t.dtype == (tdt if fused else torch.float32)
    assert base_j.dtype == (jdt if fused else jnp.float32)
    jnode = {**{k: jnp.asarray(v) for k, v in node.items()},
             "lora": {"a": jnp.asarray(a), "b": jnp.asarray(b), "scaling": 2.0}}
    mod.lora = {"a": torch.from_numpy(a), "b": torch.from_numpy(b), "scaling": 2.0}
    j = jlayers.dense(jnode, jx)
    t = tlayers.dense(mod, tx)
    assert t.dtype == tdt
    tol = 1e-5 if dtype == "f32" else 2 ** -8
    np.testing.assert_allclose(t.float().numpy(), _np(j), rtol=0,
                               atol=tol * np.abs(_np(j)).max())


def test_dense_kernel_q4_vjp_matches_jax(monkeypatch):
    """`jax.vjp` of `dense` over a `kernel_q4` node on the fused route, in x
    and in the LoRA's a and b (bf16, M = 40): the base part of dx is K6b's
    plain version.  Tolerance: bf16 rounding of GEMMs summed in another
    order, 2^-8 relative L2, as test_torch_quant.py's requant vjp."""
    monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
    rng = np.random.default_rng(31)
    node = _q4_node(rng, K, 256)
    lora = {"a": rng.standard_normal((K, 4)).astype(np.float32) / 4,
            "b": rng.standard_normal((4, 256)).astype(np.float32) * 0.1}
    x = rng.standard_normal((40, K)).astype(np.float32)
    g = rng.standard_normal((40, 256)).astype(np.float32)
    jn = {k: jnp.asarray(v) for k, v in node.items()}
    _, vjp = jax.vjp(lambda xx, lo: jlayers.dense({**jn, "lora": {**lo, "scaling": 2.0}}, xx),
                     jnp.asarray(x).astype(jnp.bfloat16),
                     {k: jnp.asarray(v) for k, v in lora.items()})
    jdx, jgl = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    mod = bridge.load_params(tlayers.Dense(K, 256), node)
    leaves = {k: torch.tensor(v).requires_grad_() for k, v in lora.items()}
    mod.lora = {**leaves, "scaling": 2.0}
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tlayers.dense(mod, tx).backward(torch.from_numpy(g).to(torch.bfloat16))
    rel = lambda t, j: np.linalg.norm(t.float().numpy() - _np(j)) / np.linalg.norm(_np(j))
    assert tx.grad.dtype == torch.bfloat16 and rel(tx.grad, jdx) < 2 ** -8
    for key in ("a", "b"):
        assert rel(leaves[key].grad, jgl[key]) < 2 ** -8, key
    assert mod.q4.grad is None and mod.scale.grad is None


def test_set_int4_impl_plain_takes_the_plain_w4a16_matmul(monkeypatch):
    """With the opt-in, "auto" sends a CPU tensor to `int4_matmul` (whose CPU
    path is the plain version) and "plain" to `int4_matmul_plain` directly;
    both give the same numbers, and neither launches a kernel."""
    monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
    mod = bridge.load_params(tlayers.Dense(K, 128), _q4_node(np.random.default_rng(4), K, 128))
    x = torch.randn(5, K, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    calls = []
    for name in ("int4_matmul", "int4_matmul_plain"):
        orig = getattr(ti4, name)
        monkeypatch.setattr(ti4, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    before = (ti4.INT4_KERNEL_LAUNCHES, ti4.INT4_BWD_KERNEL_LAUNCHES)
    y_auto = tlayers._base_matmul(mod, x)
    assert calls[0] == "int4_matmul"
    calls.clear()
    tlayers.set_int4_impl(mod, "plain")
    y_plain = tlayers._base_matmul(mod, x)
    tlayers.set_int4_impl(mod, "auto")
    assert calls == ["int4_matmul_plain"]
    assert y_auto.dtype == torch.bfloat16 and torch.equal(y_auto, y_plain)
    assert (ti4.INT4_KERNEL_LAUNCHES, ti4.INT4_BWD_KERNEL_LAUNCHES) == before


@pytest.fixture(scope="module")
def jax_int4():
    """The JAX tiny Qwen DiT (f32) and JAX's `quantize_tree` of it to
    `kernel_q4` (eager, as the JAX package runs it)."""
    jtree = _jax_dit(seed=3)
    return jtree, jquant.quantize_tree(jtree, INT4)


def test_quantize_tree_int4_matches_jax(jax_int4):
    """(e) quantize_tree(dtype="int4") over the tiny Qwen DiT: the same
    layers as JAX's (norm_out skipped by the default patterns), in the W4A16
    form with q4 and scales equal to JAX's `kernel_q4` / `kernel_scale` to
    the bit; the bridge loads JAX's tree into the same buffers; odd and
    ragged in-dims stay full precision, as in JAX."""
    jtree, jq = jax_int4
    jq = _np_tree(jq)
    model = tquant.quantize_tree(_port(jtree), INT4)
    from_jax = _port(jq)
    n_quant = 0
    for (path, node), (_, other) in zip(tlayers.iter_dense_paths(model),
                                        tlayers.iter_dense_paths(from_jax)):
        jnode = jq
        for p in path.split("/"):  # the port's path → the stacked JAX node
            jnode = (bridge._index(jnode, int(p)) if p.isdigit()
                     else jnode[{"lin_in": "in", "lin_out": "out"}.get(p, p)])
        if "kernel_q4" in jnode:
            n_quant += 1
            assert node.q_form == other.q_form == "int4" and node.weight is None
            np.testing.assert_array_equal(node.q4.numpy(), jnode["kernel_q4"])
            np.testing.assert_array_equal(node.scale.numpy(), jnode["kernel_scale"])
            assert torch.equal(node.q4, other.q4) and torch.equal(node.scale, other.scale)
            assert node.rq_f is None and other.rq_f is None
        else:
            assert node.q4 is None and other.q4 is None, path
    assert n_quant == 2 * 14 + 5  # 2 blocks × 14 denses + img_in, txt_in, time_in × 2, proj_out

    # odd (7) and ragged (200: not a multiple of the group) in-dims stay full precision
    rng = np.random.default_rng(5)
    dims = {"odd": 7, "ragged": 200, "whole": 256}
    jsmall = {k: {"kernel": jnp.asarray(rng.standard_normal((d, 8)).astype(np.float32))}
              for k, d in dims.items()}
    jsq = jquant.quantize_tree(jsmall, INT4)
    small = torch.nn.ModuleDict({k: tlayers.Dense(d, 8, bias=False) for k, d in dims.items()})
    bridge.load_params(small, _np_tree(jsmall))
    tquant.quantize_tree(small, INT4)
    for k in dims:
        assert ("kernel_q4" in jsq[k]) == (small[k].q4 is not None) == (k == "whole"), k
    np.testing.assert_array_equal(small["whole"].q4.numpy(), np.asarray(jsq["whole"]["kernel_q4"]))


@pytest.fixture(scope="module")
def tiny_int4_dits(jax_int4):
    """{dtype: (the JAX tiny Qwen DiT quantized to kernel_q4 by JAX, the
    port's model holding the same numbers)} for f32 and bf16: the bf16 tree
    is the f32 one with its float leaves other than the scales cast to
    bf16 (the int4 base is the same)."""
    _, jq = jax_int4

    def cast(path, leaf):
        if path[-1].key == "kernel_scale" or not jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf
        return leaf.astype(jnp.bfloat16)

    out = {}
    for dtype, (_, tdt) in _DT.items():
        tree = jq if dtype == "f32" else jax.tree_util.tree_map_with_path(cast, jq)
        out[dtype] = (tree, _port(tree, tdt))
    return out


def _forward_and_grads(monkeypatch, jq, model, dtype, opt_in):
    """The tiny DiT's output and the LoRA's a / b gradients of mean(out²),
    through JAX (no remat) and the port (remat "flash"), on the same
    weights, inputs and LoRA."""
    if opt_in:
        monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
    else:
        monkeypatch.delenv("QFLUX_FUSED_INT4", raising=False)
    jdt, tdt = _DT[dtype]
    inputs, seg = _inputs(21), _segments()
    jl = _lora(jq, 22)
    shapes = [(1, GH, GW), (1, GH, GW)]
    args = ("hidden_states", "encoder_hidden_states", "timestep")

    def jloss(lora):
        y = jqwen.forward(jlayers.merge_lora(jq, lora), JCFG,
                          *[jnp.asarray(inputs[k]).astype(jdt) for k in args], shapes,
                          segment_ids=jnp.asarray(seg), remat=False)
        return jnp.mean(jnp.square(y.astype(jnp.float32))), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jl)
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, _np_tree(jl)))
    tlayers.merge_lora(model, lora)
    try:
        ty = tqwen.forward(model, TCFG, *[torch.from_numpy(inputs[k]).to(tdt) for k in args],
                           shapes, segment_ids=torch.from_numpy(seg), remat_policy="flash")
        ty.float().square().mean().backward()
    finally:
        tlayers.merge_lora(model, None)
    want = bridge.lora_from_tree(model, _np_tree(jg))
    grads = {p: {k: (np.zeros(leaf[k].shape, np.float32) if leaf[k].grad is None
                     else leaf[k].grad.float().numpy(), want[p][k].numpy()) for k in ("a", "b")}
             for p, leaf in lora.items()}
    return ty.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)), grads


@pytest.mark.parametrize("opt_in", [True, False], ids=["opt_in", "default"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_qwen_dit_over_int4_matches_jax(monkeypatch, tiny_int4_dits, dtype, opt_in):
    """(f) The tiny Qwen DiT over the `int4` base, forward and LoRA
    gradients, against JAX, with QFLUX_FUSED_INT4 set and unset.  At tiny
    widths `supports` fails at every shape, in both packages, so both runs
    take the dequant route: the weights are the dequantized bf16 / f32
    values on both sides, and the tolerances are the full-precision DiT's
    (tests/test_torch_qwen.py): F32_TOL (2e-5) in f32 and BF16_TOL (1e-2) in
    bf16, on the output and per LoRA gradient tensor (relative L2).  The
    last block's add_q / add_out LoRA get zero gradients on both sides."""
    jq, model = tiny_int4_dits[dtype]
    assert not any(ti4.supports(2 * m.q4.shape[0], m.q4.shape[1], m.scale.shape[0])
                   for _, m in tlayers.iter_dense_paths(model) if m.q4 is not None)
    calls = []
    orig = ti4.int4_matmul
    monkeypatch.setattr(ti4, "int4_matmul", lambda *a: calls.append(1) or orig(*a))
    ty, jy, grads = _forward_and_grads(monkeypatch, jq, model, dtype, opt_in)
    assert not calls
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    assert _rel_err(ty, jy) < tol
    zero = {f"blocks/{TCFG.num_layers - 1}/attn/{n}" for n in ("add_q", "add_out")}
    for path, leaf in grads.items():
        for key, (got, want) in leaf.items():
            if path in zero:
                assert not want.any() and not got.any(), (path, key)
            else:
                assert np.abs(want).sum() > 0 and _rel_err(got, want) < tol, (path, key)


def test_qwen_dit_at_full_width_routes_like_jax(monkeypatch):
    """One Qwen block at full width (dim 3072, 24 heads × 128; MLP hidden
    3072 and a tiny text / latent width to keep it small), bf16, over the
    `int4` base: with the opt-in, one forward sends exactly 14 GEMMs a block
    (the eight attention projections, the four MLP ones, the two AdaLN mods
    at M = B rows) and time_in's second linear to `int4_matmul`, each at a
    shape `supports` admits, and every other dense (img_in, txt_in, time_in's
    first linear, proj_out) to the dequant route; without the opt-in none
    does.  The two forwards round differently (x cast to bf16 and a bf16
    result on the fused route), so they differ, within the bf16 bound of
    tests/test_torch_qwen.py; on CPU tensors nothing launches."""
    cfg = dataclasses.replace(tqwen.QwenImageConfig(), num_layers=1, mlp_ratio=1.0,
                              joint_attention_dim=48, in_channels=16, out_channels=4)
    model = tqwen.init(torch.Generator().manual_seed(0), cfg, "cpu", torch.bfloat16,
                       quantize=INT4)
    model = tquant.quantize_tree(model, INT4)
    calls = []
    orig = ti4.int4_matmul
    monkeypatch.setattr(ti4, "int4_matmul", lambda *a: calls.append(a) or orig(*a))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 32, 16)).astype(np.float32)).bfloat16()
    txt = torch.from_numpy(rng.standard_normal((1, 8, 48)).astype(np.float32)).bfloat16()
    t = torch.full((1,), 0.5, dtype=torch.bfloat16)
    before = (ti4.INT4_KERNEL_LAUNCHES, ti4.INT4_BWD_KERNEL_LAUNCHES)
    with torch.inference_mode():
        monkeypatch.delenv("QFLUX_FUSED_INT4", raising=False)
        y0 = tqwen.forward(model, cfg, x, txt, t, [(1, 4, 4), (1, 4, 4)])
        assert not calls
        monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
        y1 = tqwen.forward(model, cfg, x, txt, t, [(1, 4, 4), (1, 4, 4)])
    assert len(calls) == 14 * cfg.num_layers + 1
    assert all(ti4.supports(2 * q4.shape[0], q4.shape[1], s.shape[0]) for _, q4, s in calls)
    # the mods: f32 input (SiLU(temb) in f32), one row, an f32 result
    mods = [a for a in calls if a[1].shape[1] == 6 * cfg.dim]
    assert len(mods) == 2 and all(a[0].dtype == torch.float32 and a[0].shape[0] == 1
                                  for a in mods)
    assert y1.dtype == torch.bfloat16 and bool(torch.isfinite(y1.float()).all())
    assert not torch.equal(y0, y1) and _rel_err(y0.float().numpy(), y1.float().numpy()) < BF16_TOL
    assert (ti4.INT4_KERNEL_LAUNCHES, ti4.INT4_BWD_KERNEL_LAUNCHES) == before


def test_cpu_tensors_never_reach_the_launchers(monkeypatch, qw):
    """(g) On CPU tensors `int4_matmul` (forward and backward) and `dense`
    over a `kernel_q4` layer with the opt-in run the plain version: the
    ctypes launchers are never called and no launch is counted.  The custom
    op itself refuses CPU tensors (the entry point never hands it any)."""
    _, _, tq, ts = qw

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a K6 launcher")

    monkeypatch.setattr(ti4, "int4_fwd_cuda", refuse)
    monkeypatch.setattr(ti4, "int4_bwd_cuda", refuse)
    monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
    before = (ti4.INT4_KERNEL_LAUNCHES, ti4.INT4_BWD_KERNEL_LAUNCHES)
    x = torch.randn(4, K, requires_grad=True)
    ti4.int4_matmul(x, tq, ts).sum().backward()
    mod = tlayers.Dense(K, N, bias=False)
    mod.set_quantized(tq, ts, "int4")
    tlayers.dense(mod, x.detach().bfloat16().requires_grad_()).float().sum().backward()
    assert (ti4.INT4_KERNEL_LAUNCHES, ti4.INT4_BWD_KERNEL_LAUNCHES) == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ti4._int4_fwd_op(x.detach(), tq, ts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ti4.int4_bwd_cuda(torch.zeros(4, N, dtype=torch.bfloat16), tq, ts, torch.bfloat16)
