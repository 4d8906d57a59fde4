"""The quantized bases that JAX runs in XLA, in the port (qflux_tpu_torch/ops/
quant.py, ops/layers.py, ops/int8_matmul.py, models/bridge.py), against the
JAX package on the CPU, on the same numpy inputs: int8 / fp8 weight-only
(`kernel_q`, `wo_matmul`), W8A8-dynamic (`kernel_q_dyn`, `dyn_int8_matmul`),
W4A8 per group (`kernel_q4_dyn`, `dyn_int4_matmul`), and `fuse_lora` over
every form.

Bounds, each with its reason:
  * to the bit: quantization (against eager JAX, as `Trainer.load_model`
    runs it), dequantization, the W8A8 forward and dx and the W4A8
    per-group dx (against `jax.jit`, as the train step runs them: JAX's
    row scales are then a product with fl32(1/127)), and every exact
    integer product;
  * rel 1e-6 of the output's largest element in f32: the weight-only
    product and the W4A8 per-group sum over the groups, float sums that
    XLA and torch order differently; where the result is bf16 the same
    sums are held to one bf16 ulp (2^-8) relative;
  * the tiny DiT over int8_dynamic, forward and train step: relative L2
    INT_ACT_TOL = 2e-3, the bound tests/test_torch_qwen.py gives models over
    int8 activations.  Each W8A8 product is exact given the same activation,
    but the two packages' f32 GEMMs and norms sum in other orders, and an
    activation one f32 ulp apart can round to the neighbouring int8 step,
    which moves one element by 1/127 of its row's largest value (a
    full-precision base stays within 2e-5, tests/test_torch_flux.py;
    measured here 1.16e-3); a wrong scale or cast gives O(1e-2).  The LoRA
    gradients pass twice as many row quantizations (the dx of each W8A8
    product quantizes g · s_w): each within INT_GRAD_TOL = 5e-3 (measured
    up to 3.5e-3, median 2.2e-3).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops import quant as jquant
from qflux_tpu.utils import model_summary as jsummary
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.ops import int4_matmul as ti4
from qflux_tpu_torch.ops import int8_matmul as ti8
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import quant as tquant
from qflux_tpu_torch.utils import model_summary as tsummary
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

CHANNEL = ["int8", "fp8_e4m3", "fp8_e5m2"]
ALL_FORMS = ["int8", "fp8_e4m3", "fp8_e5m2", "int8_dynamic", "int4", "int4_requant",
             "int4_dynamic"]
LEAF = {"int8": "kernel_q", "fp8_e4m3": "kernel_q", "fp8_e5m2": "kernel_q",
        "int8_dynamic": "kernel_q_dyn", "int4": "kernel_q4", "int4_requant": "kernel_q4_rq",
        "int4_dynamic": "kernel_q4_dyn"}
_TORCH_DTYPE = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
_JAX_DTYPE = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}
INT_ACT_TOL = 2e-3
INT_GRAD_TOL = 5e-3


def _weight(rng, *shape):
    return (rng.uniform(-1, 1, shape) / np.sqrt(shape[-2])).astype(np.float32)


def _np(t):
    """A torch tensor as numpy, fp8 as its bytes, bf16 as f32 (exact)."""
    t = t.detach()
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(j):
    j = np.asarray(j)
    if j.dtype.name.startswith("float8"):
        return j.view(np.uint8)
    return j.astype(np.float32) if j.dtype.name == "bfloat16" else j


def _eq(t, j):
    t, j = _np(t), _jnp(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def _close(t, j, tol):
    """|t - j| ≤ tol · max|j| elementwise (sums in another order)."""
    t, j = _np(t).astype(np.float64), _jnp(j).astype(np.float64)
    assert t.shape == j.shape
    assert np.max(np.abs(t - j)) <= tol * np.max(np.abs(j)), np.max(np.abs(t - j))


_JAX_ROWQUANT = jquant._rowquant  # the unpatched function; jitted where JAX runs it so


def _qcfg(dtype, group_size=128, skip=(r".*norm.*", r".*embed.*")):
    return types.SimpleNamespace(dtype=dtype, skip_patterns=list(skip), group_size=group_size)


def _hard_weight(rng, k_in, n):
    """A weight with an all-zero column (scale 0, the divisor clamped at
    1e-12), a column whose every value is ±amax (saturating: each quotient
    is ±QMAX exactly, or one ulp off it) and a column of large values."""
    w = _weight(rng, k_in, n)
    w[:, 1] = 0.0
    w[:, 2] = np.where(rng.uniform(size=k_in) > 0.5, 0.37, -0.37)
    w[:, 3] *= 1e4
    return w


# ---------------------------------------------------------------------------
# quantization and dequantization

@pytest.mark.parametrize("dtype", CHANNEL)
def test_quantize_kernel_matches_eager_jax(dtype):
    """q and the unclamped scale to the bit against eager JAX (the scale a
    true division), at a stacked [L, K, N] weight too; the dequantized
    weight to the bit in f32 and bf16."""
    rng = np.random.default_rng(0)
    for w in (_hard_weight(rng, 256, 40), _weight(rng, 3, 96, 24)):
        jq, js = jquant.quantize_kernel(jnp.asarray(w), dtype)
        tq, ts = tquant.quantize_kernel(torch.from_numpy(w), dtype)
        assert tq.dtype == tquant.QDTYPE[dtype] and ts.dtype == torch.float32
        _eq(tq, jq)
        _eq(ts, js)
        for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            _eq(tquant.dequantize_kernel(tq, ts, td), jquant.dequantize_kernel(jq, js, jd))
    q0, s0 = tquant.quantize_kernel(torch.from_numpy(_hard_weight(rng, 64, 8)), dtype)
    assert float(s0[0, 1]) == 0.0 and not q0[:, 1].float().any()


def test_scales_are_true_divisions():
    """The repair: every quantization scale is a true division (JAX's eager
    result), not a product with the reciprocal, which differs in thousands
    of int4 group scales at a 1024 × 1024 weight and in some channel
    scales."""
    rng = np.random.default_rng(1)
    w = _weight(rng, 1024, 1024)
    jq4, js4 = jquant.quantize_kernel_int4(jnp.asarray(w), 128)
    tq4, ts4 = tquant.quantize_kernel_int4(torch.from_numpy(w), 128)
    _eq(tq4, jq4)
    _eq(ts4, js4)
    amax = torch.from_numpy(w).reshape(8, 128, 1024).abs().amax(dim=1)
    assert int((amax * (1.0 / 7.0) != ts4).sum()) > 1000
    assert torch.equal(tquant._div(amax, 7.0), ts4)
    amax_c = torch.from_numpy(w).abs().amax(dim=0)
    assert int((amax_c * (1.0 / 127.0) != amax_c / 127.0).sum()) > 0


# ---------------------------------------------------------------------------
# the matmuls

def _jit_vjp(fn, x, g, *args):
    """(y, dx) of `fn` (a JAX function of x and `args`) under `jit`."""
    def f(a, gg, *r):
        y, vjp = jax.vjp(lambda xx: fn(xx, *r), a)
        return y, vjp(gg)[0]
    return jax.jit(f)(x, g, *args)


def _port_vjp(fn, x, g, dtype, *args):
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype]).requires_grad_()
    y = fn(tx, *args)
    y.backward(torch.from_numpy(g).to(y.dtype))
    return y, tx.grad


def _case(seed, m, k_in, n, dtype, form):
    rng = np.random.default_rng(seed)
    w = _weight(rng, k_in, n)
    x = rng.standard_normal((m, k_in)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    jx = jnp.asarray(x).astype(_JAX_DTYPE[dtype])
    x = np.array(jx.astype(jnp.float32))  # the same (bf16-rounded) values on both sides
    return w, x, g, jx


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [3, 40])
@pytest.mark.parametrize("form", CHANNEL)
def test_wo_matmul_matches_jax(form, m, dtype):
    """Weight-only: the f32 forward at rel 1e-6 (float sums), dx in x.dtype
    (JAX's backward: the scale folded into the cotangent) at rel 1e-6 in
    f32, one bf16 ulp in bf16."""
    w, x, g, jx = _case(2, m, 192, 48, dtype, form)
    jq, js = jquant.quantize_kernel(jnp.asarray(w), form)
    jy, jdx = _jit_vjp(jquant.wo_matmul, jx, jnp.asarray(g), jq, js[0])
    tq, ts = tquant.quantize_kernel(torch.from_numpy(w), form)
    ty, tdx = _port_vjp(tquant.wo_matmul, x, g, dtype, tq.t().contiguous(), ts[0])
    assert ty.dtype == torch.float32 and tdx.dtype == _TORCH_DTYPE[dtype]
    _close(ty, jy, 1e-6)
    _close(tdx, jdx, 1e-6 if dtype == np.float32 else 2 ** -8)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [3, 40])
def test_dyn_int8_matmul_bit_exact(m, dtype):
    """W8A8 forward and dx to the bit against jitted JAX (exact int32
    products, the same cast chain)."""
    w, x, g, jx = _case(3, m, 256, 48, dtype, "int8")
    jq, js = jquant.quantize_kernel(jnp.asarray(w), "int8")
    jy, jdx = _jit_vjp(jquant.dyn_int8_matmul, jx, jnp.asarray(g).astype(jx.dtype), jq, js[0])
    tq, ts = tquant.quantize_kernel(torch.from_numpy(w), "int8")
    g_in = np.asarray(jnp.asarray(g).astype(jx.dtype).astype(jnp.float32))
    ty, tdx = _port_vjp(ti8.dyn_int8_matmul, x, g_in, dtype, tq.t().contiguous(), ts[0])
    assert ty.dtype == tdx.dtype == _TORCH_DTYPE[dtype]
    _eq(ty, jy)
    _eq(tdx, jdx)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [3, 40])
@pytest.mark.parametrize("group", [32, 128])
def test_dyn_int4_matmul_matches_jax(group, m, dtype):
    """W4A8 per group: the per-group integer products to the bit; the
    forward's f32 group sum at rel 1e-6 (one bf16 ulp after a bf16 cast);
    dx to the bit (no sum across groups: one product per element)."""
    w, x, g, jx = _case(4, m, 256, 48, dtype, "int4_dynamic")
    jq4, js = jquant.quantize_kernel_int4(jnp.asarray(w), group)
    jg = jnp.asarray(g).astype(jx.dtype)
    jy, jdx = _jit_vjp(jquant.dyn_int4_matmul, jx, jg, jq4, js)
    tq4, ts = torch.from_numpy(np.array(jq4)), torch.from_numpy(np.array(js))
    ty, tdx = _port_vjp(tquant.dyn_int4_matmul, x, np.asarray(jg.astype(jnp.float32)), dtype,
                        tq4, ts)
    _close(ty, jy, 1e-6 if dtype == np.float32 else 2 ** -8)
    _eq(tdx, jdx)
    # the integer products alone
    q, n_g, gsz = tquant._groups(tq4, ts)
    xq, _ = tquant._rowquant(torch.from_numpy(x))
    acc = tquant._int_bmm(xq.reshape(m, n_g, gsz).transpose(0, 1), q)
    jxq, _ = jax.jit(_JAX_ROWQUANT)(jnp.asarray(x))
    jacc = jnp.einsum("mgk,gko->gmo", jxq.reshape(m, n_g, gsz),
                      jquant.unpack_int4(jq4).reshape(n_g, gsz, 48),
                      preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc).astype(np.float32))


# ---------------------------------------------------------------------------
# dense over every form

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [3, 40], ids=["tiny_m", "m40"])
@pytest.mark.parametrize("form", ["int8", "fp8_e4m3", "fp8_e5m2", "int8_dynamic",
                                  "int4_dynamic"])
def test_dense_over_each_form(form, m, dtype, monkeypatch):
    """`dense` over a bridged quantized node with a LoRA and a bias, against
    JAX's `dense` with its row quantization as JAX runs it (under `jit`): ≤ 32
    rows of int8_dynamic and int4_dynamic take the weight-only / dequantized
    f32 product, more rows the int8 ones (x.dtype).  The base product alone
    is held as its matmul test holds it (the W8A8 one to the bit); with the
    LoRA (float GEMMs in another order) to 1e-5 relative in f32 and one bf16
    ulp in bf16, as tests/test_torch_quant.py holds the int4 forms."""
    rng = np.random.default_rng(5)
    k_in, n = 256, 40
    w = _weight(rng, k_in, n)
    jtree = jquant.quantize_tree({"lin": {"kernel": jnp.asarray(w),
                                          "bias": jnp.asarray(rng.standard_normal(n) * 0.1,
                                                              jnp.float32)}},
                                 _qcfg(form, group_size=64))["lin"]
    assert LEAF[form] in jtree
    node = jax.tree.map(np.asarray, jtree)
    mod = bridge.load_params(tlayers.Dense(k_in, n), node)
    assert mod.weight is None and mod.q_form == form
    x = rng.standard_normal((m, k_in)).astype(np.float32)
    jdt = _JAX_DTYPE[dtype]
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    monkeypatch.setattr(jquant, "_rowquant", jax.jit(_JAX_ROWQUANT))
    j0 = jlayers.dense(jtree, jx)
    t0 = tlayers.dense(mod, tx)
    if form == "int8_dynamic" and m > 32:
        _eq(t0, j0)
    else:
        _close(t0, j0, 1e-6 if dtype == np.float32 else 2 ** -8)
    a = rng.standard_normal((k_in, 4)).astype(np.float32) / 4
    b = rng.standard_normal((4, n)).astype(np.float32) * 0.1
    j = jlayers.dense({**jtree, "lora": {"a": jnp.asarray(a), "b": jnp.asarray(b),
                                         "scaling": 2.0}}, jx)
    mod.lora = {"a": torch.from_numpy(a), "b": torch.from_numpy(b), "scaling": 2.0}
    t = tlayers.dense(mod, tx)
    assert t.dtype == tx.dtype
    tol = 1e-5 if dtype == np.float32 else 2 ** -8
    np.testing.assert_allclose(_np(t), _jnp(j), rtol=tol, atol=tol)
    assert not np.array_equal(np.asarray(j), np.asarray(j0))


# ---------------------------------------------------------------------------
# quantize_tree, the bridge, the model summary, fuse_lora

@pytest.fixture(scope="module")
def tiny_flux():
    jcfg = jflux.FluxConfig.tiny()
    jp = _random_tree(lambda: jflux.init(jax.random.PRNGKey(0), jcfg, jnp.float32), 0)
    return jcfg, jp


def _port_flux(jtree):
    return bridge.load_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32),
                              jax.tree.map(np.asarray, jtree))


def _jnode(tree, path):
    """The port's path ("dual/1/img_mlp/lin_in") → JAX's stacked node, indexed."""
    node = tree
    for p in path.split("/"):
        node = (bridge._index(node, int(p)) if p.isdigit()
                else node[{"lin_in": "in", "lin_out": "out"}.get(p, p)])
    return node


@pytest.mark.parametrize("form", ALL_FORMS)
def test_quantize_tree_and_bridge_match_jax(tiny_flux, form):
    """Over the tiny FLUX DiT (group 32): the port quantizes the same layers
    as JAX's `quantize_tree` (the default skip patterns leave the embedders
    and norms in full precision), to the same bits; the bridge loads JAX's
    quantized tree into the same buffers; the model summary counts the
    same parameters and bytes as JAX's."""
    jcfg, jp = tiny_flux
    qcfg = _qcfg(form, group_size=32)
    jq = jax.tree.map(np.asarray, jquant.quantize_tree(jp, qcfg))
    model = tquant.quantize_tree(_port_flux(jp), qcfg)
    from_jax = _port_flux(jq)
    n_quant = 0
    for (path, node), (_, other) in zip(tlayers.iter_dense_paths(model),
                                        tlayers.iter_dense_paths(from_jax)):
        jn = _jnode(jq, path)
        if LEAF[form] not in jn:
            assert node.q_form is None and other.q_form is None, path
            continue
        n_quant += 1
        assert node.q_form == other.q_form == form and node.weight is None
        if form.startswith("int4"):
            _eq(node.q4, jn[LEAF[form]])
            assert torch.equal(node.q4, other.q4)
        else:
            _eq(node.q.t(), jn[LEAF[form]])
            assert torch.equal(node.q.view(torch.uint8), other.q.view(torch.uint8))
        _eq(node.scale, jn["kernel_scale"])
        assert torch.equal(node.scale, other.scale)
    assert n_quant > 0
    assert not any("embed" in p and n.q_form for p, n in tlayers.iter_dense_paths(model))
    rows = {r["component"]: r for r in tsummary.model_summary_rows(model)}
    j_n, j_b, j_dt = jsummary._leaf_stats(jq)
    assert rows["base TOTAL"]["params"] == f"{j_n:,}"
    assert rows["base TOTAL"]["memory"] == tsummary._fmt_bytes(j_b)
    t_dt = {}
    for r in tsummary.model_summary_rows(model)[:-1]:
        for part in r["dtypes"].split(", "):
            k, v = part.split(":")
            t_dt[k] = t_dt.get(k, 0) + int(v.replace(",", ""))
    assert t_dt == j_dt


def test_bridge_refuses_a_quantized_leaf_that_does_not_fit():
    """A `kernel_q` of another shape, a `kernel_q_dyn` that is not int8, a
    scale of another width: each raises."""
    def node(**kw):
        return {"kernel_scale": np.ones((1, 4), np.float32), "bias": np.zeros(4, np.float32),
                **kw}

    with pytest.raises(ValueError, match="does not fit"):
        bridge.load_params(tlayers.Dense(8, 4), node(kernel_q=np.zeros((4, 4), np.int8)))
    with pytest.raises(ValueError, match="int8_dynamic"):
        f8 = np.asarray(jnp.zeros((8, 4), jnp.float8_e4m3fn))
        bridge.load_params(tlayers.Dense(8, 4), node(kernel_q_dyn=f8))
    with pytest.raises(ValueError, match="does not fit"):
        bridge.load_params(tlayers.Dense(8, 4), {"kernel_q": np.zeros((8, 4), np.int8),
                                                 "kernel_scale": np.ones((1, 5), np.float32)})


@pytest.mark.parametrize("form", [None] + ALL_FORMS)
def test_fuse_lora_matches_jax(form):
    """`fuse_lora` (scale 0.7, scaling 2) over every form, as
    tests/ops/test_fuse_lora_quant.py builds it (a 64 → 48 node, group 32,
    rank 4): the fused quantized leaves equal JAX's `fuse_lora` to the bit,
    the storage form is kept, and the requant factors are recomputed; a
    full-precision weight within 1e-6 (the rank-4 a@b sums in another
    order)."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    a = (0.1 * rng.standard_normal((64, 4))).astype(np.float32)
    b = (0.1 * rng.standard_normal((4, 48))).astype(np.float32)
    jnode = {"kernel": jnp.asarray(w), "bias": jnp.zeros(48, jnp.float32)}
    if form is not None:
        jnode = jquant.quantize_tree({"m": jnode}, _qcfg(form, 32, skip=()))["m"]
    jl = {"a": jnp.asarray(a), "b": jnp.asarray(b), "scaling": jnp.asarray(2.0)}
    jf = jlayers.fuse_lora({"m": jnode}, {"m": jl}, scale=0.7)["m"]
    mod = tlayers.Dense(64, 48)
    mod.weight.data.copy_(torch.from_numpy(w).t())
    mod.bias.data.zero_()
    if form is not None:
        tquant.quantize_tree(mod, _qcfg(form, 32, skip=()))
    model = torch.nn.Sequential()
    model.add_module("m", mod)
    tlayers.fuse_lora(model, {"m": {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
                                    "scaling": torch.tensor(2.0)}}, scale=0.7)
    assert mod.q_form == form
    if form is None:  # a@b summed in another order: an f32 ulp or two of |w| ~ 1
        np.testing.assert_allclose(_np(mod.weight.t()), _jnp(jf["kernel"]), rtol=0, atol=1e-6)
        return
    assert "kernel" not in jf
    if form.startswith("int4"):
        _eq(mod.q4, jf[LEAF[form]])
    else:
        _eq(mod.q.t(), jf[LEAF[form]])
    _eq(mod.scale, jf["kernel_scale"])
    if form == "int4_requant":
        jf_, jsv = jquant._requant_factors(jf["kernel_scale"])
        _eq(mod.rq_f, jf_)
        _eq(mod.rq_s_vec, jsv)


# ---------------------------------------------------------------------------
# the tiny DiT over int8_dynamic


def _flux_inputs(seed, b=2, gh=4, gw=4, s_txt=8):
    from tests.test_torch_flux import _dit_inputs

    return _dit_inputs(seed, b, gh, gw, s_txt)


def test_tiny_flux_forward_over_int8_dynamic(tiny_flux, monkeypatch):
    """The tiny FLUX DiT over JAX's int8_dynamic tree, bridged: the forward
    against JAX's (row quantization as under `jit`) at relative L2
    INT_ACT_TOL (module docstring; measured 1.16e-3)."""
    jcfg, jp = tiny_flux
    jq = jquant.quantize_tree(jp, _qcfg("int8_dynamic", 32))
    model = _port_flux(jax.tree.map(np.asarray, jq))
    monkeypatch.setattr(jquant, "_rowquant", jax.jit(_JAX_ROWQUANT))
    inputs = _flux_inputs(7)
    keys = ("hidden_states", "encoder_hidden_states", "pooled_projections", "timestep",
            "img_ids", "txt_ids")
    j = jflux.forward(jq, jcfg, *[jnp.asarray(inputs[k]) for k in keys],
                      guidance=jnp.asarray(inputs["guidance"]), remat=False)
    before = ti8.INT8_GEMM_LAUNCHES
    with torch.inference_mode():
        t = tflux.forward(model, model.cfg, *[torch.from_numpy(inputs[k]) for k in keys],
                          guidance=torch.from_numpy(inputs["guidance"]))
    assert ti8.INT8_GEMM_LAUNCHES == before  # CPU tensors launch nothing
    assert _rel_err(t.numpy(), np.asarray(j)) < INT_ACT_TOL


def test_train_step_over_int8_dynamic(tiny_flux, monkeypatch):
    """One Trainer train step (MseLoss, injected noise and σ) over the
    int8_dynamic base, against JAX's step with its row quantization as under
    `jit`: the loss at rel INT_ACT_TOL and every LoRA gradient at relative
    L2 INT_GRAD_TOL (module docstring)."""
    from qflux_tpu.losses import losses as jlosses
    from qflux_tpu_torch import losses as tlosses
    from qflux_tpu_torch.trainer import flux_kontext as tfk
    from qflux_tpu_torch.trainer import train_step as tts
    from qflux_tpu_torch.trainer.base import Trainer, train_config
    from tests.test_torch_train import _batch, _jax_step

    import optax

    jcfg, jp = tiny_flux
    jq = jquant.quantize_tree(jp, _qcfg("int8_dynamic", 32))
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), jq, [r"attn/(to_q|to_k|to_v|to_out)"],
                                 rank=4, alpha=4.0)
    rng = np.random.default_rng(3)
    for stack in ("dual", "single"):
        for leaf in jl[stack]["attn"].values():
            leaf["b"] = jnp.asarray(rng.standard_normal(leaf["b"].shape).astype(np.float32) * 0.05)
    model = _port_flux(jax.tree.map(np.asarray, jq))
    monkeypatch.setattr(jquant, "_rowquant", jax.jit(_JAX_ROWQUANT))
    batch = _batch(41, 2)
    noise = rng.standard_normal(batch["image_latents"].shape).astype(np.float32)
    sigma = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    j_loss, j_grads, _, _ = _jax_step(jcfg, jq, jl, batch, noise, sigma, jlosses.MseLoss(), 1,
                                      1e9, optax.adamw(1e-4))
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, jax.tree.map(np.asarray, jl)))
    opt, schedule = Trainer(train_config(), "cpu").build_optimizer(tts.lora_leaves(lora)[0])
    step = tts.make_train_step(tfk.FluxKontextAdapter(model.cfg).predict_velocity,
                               tlosses.MseLoss(), opt, schedule,
                               tts.TrainStepConfig(max_grad_norm=1e9))
    grads_seen = {}
    orig_step = opt.step

    def spy_step():
        grads_seen.update(bridge.lora_to_numpy(lora, grads=True))
        orig_step()

    opt.step = spy_step
    m = step(model, lora, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
             noise=torch.from_numpy(noise), sigma=torch.from_numpy(sigma))
    assert float(m["loss"]) == pytest.approx(j_loss, rel=INT_ACT_TOL)
    j_np = bridge.lora_to_numpy(bridge.lora_from_tree(model, jax.tree.map(np.asarray, j_grads)))
    for path, want in j_np.items():
        for key in ("a", "b"):
            assert _rel_err(grads_seen[path][key], want[key]) < INT_GRAD_TOL, (path, key)


# ---------------------------------------------------------------------------
# the card route's host side

def test_cpu_tensor_launches_nothing():
    """On CPU tensors the W8A8 entry point is the plain version and counts
    no launch, forward or backward."""
    rng = np.random.default_rng(8)
    tq, ts = tquant.quantize_kernel(torch.from_numpy(_weight(rng, 128, 32)), "int8")
    x = torch.from_numpy(rng.standard_normal((40, 128)).astype(np.float32)).requires_grad_()
    counts = (ti8.INT8_GEMM_LAUNCHES, ti8.INT8_GEMM_DX_LAUNCHES, ti8.INT8_TRANSPOSE_LAUNCHES,
              ti4.ROWQUANT_LAUNCHES)
    y = ti8.dyn_int8_matmul(x, tq.t().contiguous(), ts[0])
    y.sum().backward()
    assert (ti8.INT8_GEMM_LAUNCHES, ti8.INT8_GEMM_DX_LAUNCHES, ti8.INT8_TRANSPOSE_LAUNCHES,
            ti4.ROWQUANT_LAUNCHES) == counts
    assert torch.equal(y, tquant.dyn_int8_fwd(x.detach(), tq.t(), ts[0]))


def test_kernel_launchers_refuse_what_they_do_not_take():
    """The GEMM, dx and transpose launchers take CUDA tensors only (no path
    to the plain version), and the shape rule (K % 64, N % 16, any length
    since the row quantization takes any row) is checked before a launch;
    every W8A8 GEMM of FLUX.1-Kontext-dev is taken, the AdaLN mods'
    3072 → 18432 included."""
    xq = torch.zeros(40, 128, dtype=torch.int8)
    q = torch.zeros(32, 128, dtype=torch.int8)
    before = (ti8.INT8_GEMM_LAUNCHES, ti8.INT8_GEMM_DX_LAUNCHES, ti8.INT8_TRANSPOSE_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ti8.int8_gemm_cuda(xq, q, torch.ones(40), torch.ones(32), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ti8.int8_transpose_cuda(q)
    with pytest.raises(ValueError, match="CUDA"):
        ti8.int8_gemm_dx_cuda(torch.zeros(40, 32, dtype=torch.int8), q.t().contiguous(),
                              torch.ones(40), torch.bfloat16)
    assert (ti8.INT8_GEMM_LAUNCHES, ti8.INT8_GEMM_DX_LAUNCHES,
            ti8.INT8_TRANSPOSE_LAUNCHES) == before
    for k_in, n in ((3072, 3072), (3072, 12288), (12288, 3072), (3072, 64), (256, 3072),
                    (3072, 18432), (18432, 3072), (12352, 64), (3072, 12304)):
        ti8.check_shape(k_in, n)
    for k_in, n in ((96, 32), (128, 24), (12384, 64), (3072, 12296), (0, 16)):
        with pytest.raises(ValueError, match="kernel takes"):
            ti8.check_shape(k_in, n)
    with pytest.raises(ValueError, match="K % 8"):
        ti4._rowquant_checks(torch.zeros(2, 18436, dtype=torch.bfloat16), None)
    ti4._rowquant_checks(torch.zeros(2, 18432, dtype=torch.bfloat16), None)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dyn_int4_dx_past_the_exact_length(dtype):
    """int4_dynamic's dx at a contraction past _BMM_EXACT_LEN (16,513): 33
    rows × K = 256 → N = 20,480, where the port adds exact 8,192-term pieces
    in int32.  Rows 0-15 are built to reach the largest sums (g constant, so
    g · s_g quantizes to 127 everywhere in group 0, whose weights quantize to
    7: 127 · 7 · 20,480 ≈ 1.8e7 > 2^24, so one f32 product would round); dx
    equal to jitted JAX's int32 `dot_general` path to the bit, and the
    integer products alone against numpy's int64 sums."""
    m, k_in, n = 33, 256, 20480
    assert n >= tquant._BMM_EXACT_LEN
    w, x, g, jx = _case(9, m, k_in, n, dtype, "int4_dynamic")
    w[:64] = 0.37  # group 0 (rows 0-127): these rows hold the group's amax
    g[:16] = 1.0
    jq4, js = jquant.quantize_kernel_int4(jnp.asarray(w), 128)
    jg = jnp.asarray(g).astype(jx.dtype)
    _, jdx = _jit_vjp(jquant.dyn_int4_matmul, jx, jg, jq4, js)
    tq4, ts = torch.from_numpy(np.array(jq4)), torch.from_numpy(np.array(js))
    _, tdx = _port_vjp(tquant.dyn_int4_matmul, x, np.array(jg.astype(jnp.float32)), dtype,
                       tq4, ts)
    _eq(tdx, jdx)
    q, n_g, gsz = tquant._groups(tq4, ts)
    gq = torch.full((n_g, m, n), 127, dtype=torch.int8)
    gq[:, 16:] = torch.from_numpy(np.random.default_rng(2).integers(-127, 128, (m - 16, n),
                                                                    dtype=np.int8))
    got = tquant._int_bmm(gq, q.transpose(1, 2))
    want = np.einsum("gmo,gko->gmk", gq.numpy().astype(np.int64),
                     q.numpy().astype(np.int64)).astype(np.float32)
    assert float(np.abs(want).max()) > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)


class _Recorder:
    """A stand-in kernel library: records each C entry's arguments."""

    def __init__(self):
        self.calls = []
        self.lib = self

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry

    def check(self, code, what):
        assert code == 0, what


def test_gemm_launch_arguments():
    """`_launch` passes qflux_int8_gemm its twelve arguments in order: a, b,
    srow, scol (None for the dx), out, M, Nout, Kc, out_f32, splits, ws,
    stream; the dx plan splits its contraction over N as K5b's does."""
    rec = _Recorder()
    a = torch.zeros(256, 3072, dtype=torch.int8)
    b = torch.zeros(3072, 3072, dtype=torch.int8)
    srow, scol = torch.ones(256), torch.ones(3072)
    out = torch.empty(256, 3072, dtype=torch.bfloat16)
    plan = ti4._rq_plan(256, 3072, 3072, 3072, 132, True)
    assert plan.splits > 1 and plan.workspace == plan.splits * 256 * 3072
    ti8._launch(rec, 7, a, b, srow, None, out, plan, 1234)
    name, args = rec.calls[0]
    assert name == "qflux_int8_gemm" and len(args) == 12
    assert args[0] == a.data_ptr() and args[1] == b.data_ptr() and args[2] == srow.data_ptr()
    assert args[3] is None and args[4] == out.data_ptr()
    assert args[5:] == (256, 3072, 3072, 0, plan.splits, 1234, 7)
    ti8._launch(rec, 7, a, b, srow, scol, out.float(), ti4._rq_plan(4096, 3072, 3072, 3072), None)
    assert rec.calls[1][1][3] == scol.data_ptr() and rec.calls[1][1][8:10] == (1, 1)


def _plain_w8_launchers(monkeypatch):
    """Test doubles: the W8A8 launchers and the row quantization replaced by
    plain math that counts as the real launches would, and the dispatch
    sending CPU tensors to the custom op, so that the op, its autograd
    formula and the checkpoint policies run here."""
    def rowquant(x, s_vec=None):
        ti4.ROWQUANT_LAUNCHES += 1
        return tquant._rowquant(x if s_vec is None else x.float() * s_vec)

    def gemm(xq, q, sx, s_vec, out_dtype):
        acc = (xq.double() @ q.double().t()).float()
        return ((acc * sx.reshape(-1, 1)) * s_vec).to(out_dtype)

    def dx(gq, qt, sg, out_dtype):
        return ((gq.double() @ qt.double().t()).float() * sg.reshape(-1, 1)).to(out_dtype)

    monkeypatch.setattr(ti4, "rowquant", rowquant)
    monkeypatch.setattr(ti8, "int8_gemm_cuda", gemm)
    monkeypatch.setattr(ti8, "int8_transpose_cuda", lambda q: q.t().contiguous())
    monkeypatch.setattr(ti8, "int8_gemm_dx_cuda", dx)
    monkeypatch.setattr(ti8, "dyn_int8_matmul", lambda x, q, s: ti8._int8_fwd_op(x, q, s))


@pytest.mark.parametrize("policy", ["full", "flash"])
def test_w8a8_launch_counts_per_step(tiny_flux, monkeypatch, policy):
    """One train step over the tiny FLUX's int8_dynamic base through the
    custom op (launcher doubles): the W8A8 launches equal chip_smoke.py's
    derivation from the model and the batch's shape (`_flux_w8_counts`:
    every W8A8 product, a layer called with more than 32 rows, once in
    the forward and once more in the checkpointed blocks' recompute, a dx
    wherever the input carries a gradient, a transpose before each dx, a
    row quantization before each GEMM), and the LoRA gradients equal the
    plain route's to the bit."""
    import chip_smoke
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.trainer import flux_kontext as tfk
    from qflux_tpu_torch.trainer.train_step import TrainStepConfig, _loss_for_microbatch
    from tests.test_torch_train import _batch

    jcfg, jp = tiny_flux
    jq = jquant.quantize_tree(jp, _qcfg("int8_dynamic", 32))
    model = _port_flux(jax.tree.map(np.asarray, jq))
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), jq, [r"attn/(to_q|to_k|to_v|to_out)"],
                                 rank=4, alpha=4.0)
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, jax.tree.map(np.asarray, jl)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(43, 2).items()}
    rng = np.random.default_rng(9)
    noise = torch.from_numpy(rng.standard_normal(batch["image_latents"].shape)
                             .astype(np.float32))
    sigma = torch.tensor([0.3, 0.7])
    grads = {}
    for name in ("plain", "op"):
        if name == "op":
            _plain_w8_launchers(monkeypatch)
        counts = (ti8.INT8_GEMM_LAUNCHES, ti8.INT8_GEMM_DX_LAUNCHES,
                  ti8.INT8_TRANSPOSE_LAUNCHES, ti4.ROWQUANT_LAUNCHES)
        adapter = tfk.FluxKontextAdapter(model.cfg, remat=True, remat_policy=policy)
        for leaf in lora.values():
            for t in leaf.values():
                t.grad = None
        _loss_for_microbatch(model, lora, batch, noise, sigma, adapter.predict_velocity,
                             MseLoss(), TrainStepConfig()).backward()
        launched = tuple(b - a for a, b in zip(counts, (
            ti8.INT8_GEMM_LAUNCHES, ti8.INT8_GEMM_DX_LAUNCHES, ti8.INT8_TRANSPOSE_LAUNCHES,
            ti4.ROWQUANT_LAUNCHES)))
        grads[name] = bridge.lora_to_numpy(lora, grads=True)
    n_img = batch["image_latents"].shape[1] + batch["control_latents"].shape[1]
    per_fwd, in_blocks, no_grad = chip_smoke._flux_w8_counts(model, 2, n_img,
                                                             batch["prompt_embeds"].shape[1])
    fwd, dxs = per_fwd + in_blocks, per_fwd - no_grad
    # 2 × 8 text rows take the weight-only route: block 0's q / k / v alone have no dx
    assert no_grad == 3 and per_fwd > in_blocks > 0
    assert launched == (fwd, dxs, dxs, fwd + dxs)
    for path, leaf in grads["plain"].items():
        for key in ("a", "b"):
            np.testing.assert_array_equal(grads["op"][path][key], leaf[key])
