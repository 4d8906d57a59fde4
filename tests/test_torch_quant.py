"""The port's int4 frozen bases and the W4A8-requant matmul
(qflux_tpu_torch/ops/{quant,int4_matmul,layers}.py, models/bridge.py)
against the JAX package's, on the CPU.

Tolerance: zero wherever the computation is integer or a fixed chain of
IEEE float32 operations: packing, unpacking, the requant factors, the
regridded int8 weights, the row quantization and the requant matmul itself
(exact int32 accumulation, then two f32 products and one cast) are compared
with `assert_array_equal`.  The row quantization and everything built on it
are held to `jax.jit` of the JAX function, because the JAX package runs
them only under `jit` (the train step and the sampler), where XLA turns the
row scale's `amax / 127.0` into a product with the f32 reciprocal: eager
JAX divides, and differs in a few percent of the rows.  Only `dense`'s LoRA dots and bias add, which
are float GEMMs summed in another order by XLA and PyTorch, carry a
tolerance, stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.ops import int4_matmul as ji4
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops import quant as jquant
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.ops import int4_matmul as ti4
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import quant as tquant

_TORCH_DTYPE = {np.float32: torch.float32, "bfloat16": torch.bfloat16}


def _weight(rng, *shape):
    return (rng.uniform(-1, 1, shape) / np.sqrt(shape[-2])).astype(np.float32)


def _eq(t, j):
    """Bit equality of a torch tensor and a JAX array (bf16 compared as f32,
    which is exact)."""
    t = t.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    j = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), j)


def _t(j):
    """A JAX array → a torch tensor (copied: JAX hands out read-only views)."""
    return torch.from_numpy(np.array(j))


def _qcfg(**kw):
    return config_from_dict({"model": {"quantize": {"enabled": True, "dtype": "int4_requant",
                                                    **kw}}}).model.quantize


# ---------------------------------------------------------------------------
# packing, factors, regrid, row quantization

@pytest.mark.parametrize("shape,group", [((256, 40), 128), ((64, 24), 128), ((3, 96, 16), 32)],
                         ids=["two_groups", "one_group", "stacked"])
def test_quantize_unpack_dequantize_match_jax(shape, group):
    w = _weight(np.random.default_rng(0), *shape)
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(w), group)
    tq, ts = tquant.quantize_kernel_int4(torch.from_numpy(w), group)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tq, jq)
    _eq(ts, js)
    _eq(tquant.unpack_int4(tq), jquant.unpack_int4(jq))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        _eq(tquant.dequantize_kernel_int4(tq, ts, tdt),
            jquant.dequantize_kernel_int4(jq, js, jdt))


def test_unpack_sign_extends_every_nibble():
    """All 256 byte values: both nibble planes sign-extend as the JAX
    shift pair does (-8 included, which quantize_kernel_int4 never emits)."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    _eq(tquant.unpack_int4(torch.from_numpy(packed)), jquant.unpack_int4(jnp.asarray(packed)))


@pytest.mark.parametrize("k_in,group", [(256, 64), (512, 128), (64, 128), (384, 128)],
                         ids=["even_4", "even_4_g128", "odd_1_straddles", "odd_3"])
def test_requant_factors_and_q8_match_jax(k_in, group):
    rng = np.random.default_rng(1)
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(_weight(rng, k_in, 24)), group)
    # one column of all-zero scales (a dead output channel): S is clamped
    js = js.at[:, 5].set(0.0)
    jq = jq.at[:, 7].set(jnp.int8(-120))  # high nibble -8, low 8 → -8: the clip matters
    tq, ts = _t(jq), _t(js)
    jf, jsv = jquant._requant_factors(js)
    tf, tsv = tquant._requant_factors(ts)
    _eq(tf, jf)
    _eq(tsv, jsv)
    _eq(tquant._requant_q8(tq, tf), jquant._requant_q8(jq, jf))


_jit_rowquant = jax.jit(jquant._rowquant)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rowquant_matches_jax(dtype):
    x = np.random.default_rng(2).standard_normal((3, 5, 96)).astype(np.float32) * 3
    x[1, 2] = 0.0  # an all-zero row: the scale is clamped, the values are 0
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    jv, js = _jit_rowquant(jx)
    tv, ts = tquant._rowquant(tx)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tv, jv)
    _eq(ts, js)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rowquant_matches_jax_under_jit(dtype):
    """At 4,096 rows, enough to hit the rows where a true division by 127
    and the product with fl32(1/127) round apart (about 4% of them), the
    port's row quantization equals `jax.jit(_rowquant)`, the form the JAX
    package runs, in every scale and value.  The case is a real test: eager
    JAX (a true division) differs from the jitted one in some rows."""
    x = np.random.default_rng(24).standard_normal((4096, 96)).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    jv, js = _jit_rowquant(jx)
    assert (np.asarray(jquant._rowquant(jx)[1]) != np.asarray(js)).sum() > 100
    tv, ts = tquant._rowquant(tx)
    _eq(ts, js)
    _eq(tv, jv)


# ---------------------------------------------------------------------------
# the requant matmul

def _rq_case(seed, m, k_in, n, group=128, lead=()):
    rng = np.random.default_rng(seed)
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(_weight(rng, k_in, n)), group)
    x = rng.standard_normal(lead + (m, k_in)).astype(np.float32)
    return x, jq, js


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 40, 1024])
def test_requant_int4_matmul_bit_exact(m, dtype):
    """The plain version equals JAX's requant_int4_matmul under `jit` bit
    for bit (at 2 × 1024 rows, rows where eager JAX's row scale differs are
    among them)."""
    x, jq, js = _rq_case(3 + m, m, 256, 48, lead=(2,))
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    j = jax.jit(jquant.requant_int4_matmul)(jx, jq, js)
    t = tquant.requant_int4_matmul(tx, _t(jq), _t(js))
    assert t.dtype == tx.dtype
    _eq(t, j)


@pytest.mark.parametrize("m", [5, 40])
def test_plain_matches_jax_fused_pallas_kernel(m):
    """The first test K5 has: JAX's rq_fused_matmul (the Pallas kernel
    _rq_fwd_kernel, run in interpret mode on the CPU) under `jit`, at a
    shape rq_supports takes, against the port's plain version and against
    the XLA path."""
    x, jq, js = _rq_case(7, m, 3072, 128)
    assert ji4.rq_supports(3072, 128, js.shape[-2])
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    j_fused = jax.jit(jquant.rq_fused_matmul)(jx, jq, js)
    tq, ts = _t(jq), _t(js)
    t = ti4.rq_fused_matmul(torch.from_numpy(x).to(torch.bfloat16), tq, ts)
    _eq(t, j_fused)
    _eq(t, jax.jit(jquant.requant_int4_matmul)(jx, jq, js))


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    x, jq, js = _rq_case(8, 37, 192, 16, group=64)
    tq, ts = _t(jq), _t(js)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    before = ti4.RQ_KERNEL_LAUNCHES
    factors = tquant._requant_factors(ts)
    a = ti4.rq_fused_matmul(tx, tq, ts, factors)
    assert ti4.RQ_KERNEL_LAUNCHES == before
    assert torch.equal(a, tquant.requant_int4_matmul(tx, tq, ts))


def test_kernel_launcher_refuses_what_it_does_not_take():
    """The K5a launcher takes CUDA tensors only (no path to the plain
    version), and every shape rule is checked before a launch."""
    xq = torch.zeros(40, 128, dtype=torch.int8)
    q4 = torch.zeros(64, 16, dtype=torch.int8)
    f = torch.ones(1, 16)
    sx, sv = torch.ones(40, 1), torch.ones(16)
    before = ti4.RQ_KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ti4.rq_int4_fwd_cuda(xq, q4, f, sx, sv, torch.bfloat16)
    assert ti4.RQ_KERNEL_LAUNCHES == before
    # every int4-requant GEMM of the 20B Qwen DiT is taken: (K, N, groups)
    for k_in, n in ((3072, 3072), (3072, 12288), (12288, 3072), (3584, 3072), (64, 3072),
                    (3072, 64)):
        assert ti4.kernel_group_size(k_in, n, k_in // min(128, k_in)) == min(128, k_in)
    for k_in, n, groups in ((96, 16, 1), (128, 12, 1), (128, 16, 3), (128, 16, 64)):
        with pytest.raises(ValueError, match="kernel takes"):
            ti4.kernel_group_size(k_in, n, groups)


# ---------------------------------------------------------------------------
# the requant matmul's backward (K5b's plain version)

def _jit_vjp(fn, x, g, *args):
    """dx of `fn` (a JAX function of x and `args`) under `jit`, as the JAX
    train step takes it."""
    return jax.jit(lambda a, gg, *r: jax.vjp(lambda xx: fn(xx, *r), a)[1](gg)[0])(x, g, *args)


def _port_vjp(fn, x, g, dtype, *args):
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype]).requires_grad_()
    y = fn(tx, *args)
    y.backward(torch.from_numpy(g).to(y.dtype))
    return y, tx.grad


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [5, 40, 1024])
def test_requant_backward_bit_exact(m, dtype):
    """The plain straight-through backward equals jax.vjp of JAX's
    requant_int4_matmul under `jit` bit for bit (lead dims, both dtypes),
    and gives q4 and the scales no gradient."""
    x, jq, js = _rq_case(12 + m, m, 256, 48, lead=(2,))
    g = np.random.default_rng(m).standard_normal((2, m, 48)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jdx = _jit_vjp(jquant.requant_int4_matmul, jnp.asarray(x).astype(jdt),
                   jnp.asarray(g).astype(jdt), jq, js)
    tq, ts = _t(jq), _t(js)
    _, tdx = _port_vjp(tquant.requant_int4_matmul, x, g, dtype, tq, ts)
    assert tdx.dtype == _TORCH_DTYPE[dtype]
    _eq(tdx, jdx)
    _eq(tquant.requant_int4_matmul_dx(torch.from_numpy(g).to(_TORCH_DTYPE[dtype]), tq,
                                      tquant._requant_factors(ts)), jdx)
    assert not tq.requires_grad and ts.grad is None


@pytest.mark.parametrize("m", [5, 40])
def test_plain_backward_matches_jax_fused_pallas_vjp(m):
    """The first test K5b has: the vjp of JAX's rq_fused_matmul (the Pallas
    kernel _rq_bwd_kernel, run in interpret mode on the CPU) under `jit`, at
    a shape rq_supports takes, against the port's plain backward, through
    the port's rq_fused_matmul on CPU tensors."""
    x, jq, js = _rq_case(17, m, 3072, 128)
    assert ji4.rq_supports(3072, 128, js.shape[-2])
    g = np.random.default_rng(18).standard_normal((m, 128)).astype(np.float32)
    jx, jg = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    j_fused = _jit_vjp(jquant.rq_fused_matmul, jx, jg, jq, js)
    _, tdx = _port_vjp(ti4.rq_fused_matmul, x, g, "bfloat16", _t(jq), _t(js))
    _eq(tdx, j_fused)
    _eq(tdx, _jit_vjp(jquant.requant_int4_matmul, jx, jg, jq, js))


def test_cpu_backward_is_the_plain_version_and_launches_nothing():
    x, jq, js = _rq_case(19, 37, 192, 16, group=64)
    g = np.random.default_rng(20).standard_normal((37, 16)).astype(np.float32)
    tq, ts = _t(jq), _t(js)
    before = (ti4.RQ_KERNEL_LAUNCHES, ti4.RQ_BWD_KERNEL_LAUNCHES)
    _, a = _port_vjp(ti4.rq_fused_matmul, x, g, "bfloat16", tq, ts, tquant._requant_factors(ts))
    assert (ti4.RQ_KERNEL_LAUNCHES, ti4.RQ_BWD_KERNEL_LAUNCHES) == before
    _, b = _port_vjp(tquant.requant_int4_matmul, x, g, "bfloat16", tq, ts)
    assert torch.equal(a, b)


def _plain_rq_launchers(monkeypatch):
    """Test doubles: K5a's and K5b's launchers replaced by plain math (the
    same exact integer products), and rq_fused_matmul sending CPU tensors to
    the custom op instead of the plain version, so the op and its autograd
    formula run here.  The counts move as the real launches would."""
    def fwd(xq, q4, f, sx, s_vec, out_dtype):
        acc = tquant._int_product(xq, tquant._requant_q8(q4, f))
        return ((acc.to(torch.float32) * sx.reshape(-1, 1)) * s_vec).to(out_dtype)

    def bwd(gq, q4, f, sg, out_dtype):
        acc = tquant._int_product(gq, tquant._requant_q8(q4, f).t())
        return (acc.to(torch.float32) * sg.reshape(-1, 1)).to(out_dtype)

    def dispatch(x, q4, g_scale, factors=None):
        f, s_vec = factors if factors is not None else tquant._requant_factors(g_scale)
        return ti4._rq_fwd_op(x, q4, f, s_vec)

    monkeypatch.setattr(ti4, "rq_int4_fwd_cuda", fwd)
    monkeypatch.setattr(ti4, "rq_int4_bwd_cuda", bwd)
    monkeypatch.setattr(ti4, "rq_fused_matmul", dispatch)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_custom_op_autograd_counts_and_equals_plain(monkeypatch, dtype):
    """The custom op qflux::rq_int4_fwd with its registered autograd (the
    kernels' launchers as plain-math doubles): one forward launches K5a
    once, its backward K5b once, and both results equal the plain version
    to the bit."""
    x, jq, js = _rq_case(21, 3, 192, 24, group=64, lead=(2,))
    g = np.random.default_rng(22).standard_normal((2, 3, 24)).astype(np.float32)
    tq, ts = _t(jq), _t(js)
    want_y, want_dx = _port_vjp(tquant.requant_int4_matmul, x, g, dtype, tq, ts)
    _plain_rq_launchers(monkeypatch)
    monkeypatch.setattr(ti4, "RQ_KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(ti4, "RQ_BWD_KERNEL_LAUNCHES", 0)
    y, dx = _port_vjp(ti4.rq_fused_matmul, x, g, dtype, tq, ts)
    assert (ti4.RQ_KERNEL_LAUNCHES, ti4.RQ_BWD_KERNEL_LAUNCHES) == (1, 1)
    assert torch.equal(y, want_y) and torch.equal(dx, want_dx)


def test_bwd_kernel_launcher_refuses_what_it_does_not_take():
    """The K5b launcher takes CUDA tensors only (no path to the plain
    version); it shares K5a's shape rules (kernel_group_size, tested above),
    and its operand check refuses a wrong dtype, shape or layout."""
    gq = torch.zeros(40, 16, dtype=torch.int8)
    q4 = torch.zeros(64, 16, dtype=torch.int8)
    f, sg = torch.ones(1, 16), torch.ones(40, 1)
    before = ti4.RQ_BWD_KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ti4.rq_int4_bwd_cuda(gq, q4, f, sg, torch.bfloat16)
    cpu = torch.device("cpu")
    for t, shape, what in ((gq.float(), (40, 16), "is torch.float32"),
                           (gq[:, :8], (40, 16), "has shape"),
                           (gq.t(), (16, 40), "contiguous")):
        with pytest.raises(ValueError, match=what):
            ti4._check("gq", t, cpu, torch.int8, shape)
    assert ti4.RQ_BWD_KERNEL_LAUNCHES == before


# ---------------------------------------------------------------------------
# quantize_tree, the bridge, dense

def _tiny_qwen_tree(seed=0):
    from qflux_tpu.models.qwen import transformer as jqwen
    from tests.test_torch_ops import random_tree

    cfg = jqwen.QwenImageConfig.tiny()
    return cfg, random_tree(lambda: jqwen.init(jax.random.PRNGKey(0), cfg, jnp.float32), seed)


def test_quantize_tree_matches_jax():
    """int4_requant over the tiny Qwen DiT: the same layers quantized (the
    skip patterns leave norm_out full precision), to the same bits; the
    bridge loads JAX's quantized tree into the same buffers."""
    from qflux_tpu_torch.models.qwen import transformer as tqwen

    cfg, jtree = _tiny_qwen_tree()
    qcfg = _qcfg()
    jq = jax.tree.map(np.asarray, jquant.quantize_tree(jtree, qcfg))
    model = bridge.load_params(tqwen.QwenImageTransformer(tqwen.QwenImageConfig.tiny(),
                                                          dtype=torch.float32),
                               jax.tree.map(np.asarray, jtree))
    tquant.quantize_tree(model, qcfg)
    from_jax = bridge.load_params(tqwen.QwenImageTransformer(tqwen.QwenImageConfig.tiny(),
                                                             dtype=torch.float32), jq)
    n_quant = 0
    for (path, node), (_, other) in zip(tlayers.iter_dense_paths(model),
                                        tlayers.iter_dense_paths(from_jax)):
        jnode = jq
        for p in path.split("/"):  # the port's path → the stacked JAX node
            jnode = (bridge._index(jnode, int(p)) if p.isdigit()
                     else jnode[{"lin_in": "in", "lin_out": "out"}.get(p, p)])
        if "kernel_q4_rq" in jnode:
            n_quant += 1
            assert node.weight is None and other.weight is None
            _eq(node.q4, jnode["kernel_q4_rq"])
            _eq(node.scale, jnode["kernel_scale"])
            assert torch.equal(node.q4, other.q4) and torch.equal(node.rq_f, other.rq_f)
            jf, jsv = jquant._requant_factors(jnp.asarray(jnode["kernel_scale"]))
            _eq(node.rq_f, jf)
            _eq(node.rq_s_vec, jsv)
        else:
            assert node.q4 is None and other.q4 is None, path
    # 2 blocks × 14 denses + img_in, txt_in, time_in × 2, proj_out; norm_out skipped
    assert n_quant == 2 * 14 + 5
    # quantizing again leaves every layer as it is
    q4_before = model.blocks[0].attn.to_q.q4.clone()
    tquant.quantize_tree(model, qcfg)
    assert torch.equal(model.blocks[0].attn.to_q.q4, q4_before)


def test_bridge_refuses_other_quantized_forms():
    """Every quantized leaf of JAX's `quantize_tree` loads (each into its
    form), and a q that does not fit the layer is refused in every form."""
    rng = np.random.default_rng(12)
    w = jnp.asarray(_weight(rng, 8, 4))
    forms = {"kernel_q4_rq": "int4_requant", "kernel_q4": "int4", "kernel_q4_dyn": "int4_dynamic",
             "kernel_q_dyn": "int8_dynamic", "kernel_q": "int8"}
    for key, form in forms.items():
        q, scale = (jquant.quantize_kernel_int4(w, 8) if key.startswith("kernel_q4")
                    else jquant.quantize_kernel(w, "int8"))
        mod = bridge.load_params(tlayers.Dense(8, 4), {key: np.asarray(q),
                                                       "kernel_scale": np.asarray(scale),
                                                       "bias": np.zeros(4, np.float32)})
        assert mod.q_form == form and mod.weight is None
        with pytest.raises(ValueError, match="does not fit"):
            bridge.load_params(tlayers.Dense(8, 4), {key: np.zeros((3, 4), np.int8),
                                                     "kernel_scale": np.ones((1, 4), np.float32),
                                                     "bias": np.zeros(4, np.float32)})


def test_bridge_loads_kernel_q4():
    """A JAX `kernel_q4` leaf (the W4A16 form of quantize.dtype int4) loads
    through `Dense.set_quantized` (form "int4"): the weight dropped, q4 and the scales in the
    JAX layout to the bit, no requant factors; the layer's dequantized
    weight is JAX's."""
    rng = np.random.default_rng(9)
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(_weight(rng, 256, 24)), 128)
    mod = bridge.load_params(tlayers.Dense(256, 24), {"kernel_q4": np.asarray(jq),
                                                      "kernel_scale": np.asarray(js),
                                                      "bias": np.zeros(24, np.float32)})
    assert mod.weight is None and mod.q_form == "int4"
    assert mod.rq_f is None and mod.rq_s_vec is None
    _eq(mod.q4, jq)
    _eq(mod.scale, js)
    _eq(tquant.dequantize_kernel_int4(mod.q4, mod.scale, torch.bfloat16),
        jquant.dequantize_kernel_int4(jq, js, jnp.bfloat16))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [3, 40], ids=["tiny_m_dequant", "requant"])
def test_dense_int4_requant_with_lora_and_bias(m, dtype, monkeypatch):
    """`dense` over a bridged int4-requant node with a LoRA and a bias:
    M ≤ 32 rows take the dequantized product (f32 result, the delta and bias
    added in f32), more rows the requant matmul (x.dtype result, the delta
    and bias added in x.dtype), as JAX's _base_matmul routes.  The requant
    route's base product is an integer product, exact on both sides: held
    to the bit, with JAX's row quantization as JAX runs it, under `jit`
    (the rest of `dense` runs eagerly: under `jit` XLA's CPU backend fuses
    the bias add into the epilogue's product, one rounding fewer than
    either package's separate operations).  The dequantized route's base product is a float GEMM over
    the dequantized weight, which XLA's and torch's CPU dots sum in other
    orders: in f32 it is held to 1e-5 relative with 1e-6 absolute (measured
    1.1e-5 relative on an element near zero, 2.4e-7 absolute); in bf16 the
    result's rounding hides the order and it is held to the bit.  The LoRA
    dots are float GEMMs summed in another order: f32 to 1e-5 relative,
    bf16 to one bf16 ulp (2^-8) of the output, as
    tests/test_torch_ops.py:test_dense_bf16_cast_points."""
    rng = np.random.default_rng(10)
    k_in, n = 256, 40
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(_weight(rng, k_in, n)), 128)
    bias = rng.standard_normal(n).astype(np.float32) * 0.1
    a = rng.standard_normal((k_in, 4)).astype(np.float32) / 4
    b = rng.standard_normal((4, n)).astype(np.float32) * 0.1
    node = {"kernel_q4_rq": np.asarray(jq), "kernel_scale": np.asarray(js), "bias": bias}
    mod = bridge.load_params(tlayers.Dense(k_in, n), node)
    assert mod.weight is None and mod.q4.dtype == torch.int8
    x = rng.standard_normal((m, k_in)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    monkeypatch.setattr(jquant, "_rowquant", _jit_rowquant)
    # without LoRA: the base product and the bias add
    j0 = jlayers.dense({k: jnp.asarray(v) for k, v in node.items()}, jx)
    t0 = tlayers.dense(mod, tx)
    if m <= 32 and dtype == np.float32:
        np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=1e-5, atol=1e-6)
    else:
        _eq(t0, j0)
    jnode = {**{k: jnp.asarray(v) for k, v in node.items()},
             "lora": {"a": jnp.asarray(a), "b": jnp.asarray(b), "scaling": 2.0}}
    mod.lora = {"a": torch.from_numpy(a), "b": torch.from_numpy(b), "scaling": 2.0}
    j = jlayers.dense(jnode, jx)
    t = tlayers.dense(mod, tx)
    assert t.dtype == tx.dtype
    tol = 1e-5 if dtype == np.float32 else 2 ** -8
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert not np.array_equal(np.asarray(j), np.asarray(j0))  # the adapter does something


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [3, 40], ids=["tiny_m_dequant", "requant"])
def test_dense_int4_vjp_matches_jax(m, dtype):
    """jax.vjp of `dense` over an int4-requant node with a LoRA and a bias,
    in x and in the LoRA's a, b and scaling, on both routes.  Through the
    requant route the base part of dx is K5b's plain version (exact); the
    rest of dx and the LoRA gradients are float GEMMs summed in another
    order, as is the dequantized route's base part: f32 to 1e-5 relative L2,
    bf16 to 2^-8 (one bf16 ulp of the gradient's scale; the bf16 casts sit
    at the same points on both sides).  The bf16 scaling gradient is one
    scalar, Σ g · ((x·a)·b) reduced from bf16 terms with cancellation
    (measured 1.0391 against 1.0 on the dequantized route, -35.75 against
    -35.5 on the requant one): it is held to 2^-8 of Σ |terms|, the
    rounding a bf16 sum of those terms may carry."""
    rng = np.random.default_rng(23)
    k_in, n = 256, 40
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(_weight(rng, k_in, n)), 128)
    node = {"kernel_q4_rq": jq, "kernel_scale": js,
            "bias": jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.1)}
    lora = {"a": rng.standard_normal((k_in, 4)).astype(np.float32) / 4,
            "b": rng.standard_normal((4, n)).astype(np.float32) * 0.1,
            "scaling": np.float32(2.0)}
    x = rng.standard_normal((m, k_in)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(lambda xx, lo: jlayers.dense({**node, "lora": lo}, xx),
                     jnp.asarray(x).astype(jdt), {k: jnp.asarray(v) for k, v in lora.items()})
    jdx, jgl = vjp(jnp.asarray(g).astype(jdt))

    mod = bridge.load_params(tlayers.Dense(k_in, n), {k: np.asarray(v) for k, v in node.items()})
    leaves = {k: torch.tensor(v).requires_grad_() for k, v in lora.items()}
    mod.lora = leaves
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype]).requires_grad_()
    y = tlayers.dense(mod, tx)
    y.backward(torch.from_numpy(g).to(y.dtype))
    tol = 1e-5 if dtype == np.float32 else 2 ** -8

    def rel(t, j):
        t, j = t.detach().float().numpy(), np.asarray(jnp.asarray(j).astype(jnp.float32))
        return np.linalg.norm(t - j) / np.linalg.norm(j)

    assert tx.grad.dtype == tx.dtype and rel(tx.grad, jdx) < tol
    for key in ("a", "b"):
        assert rel(leaves[key].grad, jgl[key]) < tol, key
    if dtype == np.float32:
        assert rel(leaves["scaling"].grad, jgl["scaling"]) < tol
    else:
        l1 = np.abs(g * ((x @ lora["a"]) @ lora["b"])).sum()
        assert abs(leaves["scaling"].grad.item() - float(jgl["scaling"])) <= 2 ** -8 * l1
    assert mod.q4.grad is None and mod.scale.grad is None


def test_lora_tree_and_merge_over_int4_base():
    """build_lora_tree sizes the adapter from the quantized form (in-dim 2·K/2,
    as JAX), merge_lora and the plain/auto switch take quantized layers."""
    rng = np.random.default_rng(11)
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(_weight(rng, 128, 24)), 64)
    mod = bridge.load_params(tlayers.Dense(128, 24), {
        "kernel_q4_rq": np.asarray(jq), "kernel_scale": np.asarray(js),
        "bias": np.zeros(24, np.float32)})
    holder = torch.nn.Module()
    holder.proj = mod
    lora = tlayers.build_lora_tree(torch.Generator().manual_seed(0), holder, ["proj"], 4, 4.0)
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(0), {"proj": {"kernel_q4_rq": jq,
                                                                  "kernel_scale": js}},
                                 ["proj"], rank=4, alpha=4.0)
    assert tuple(lora["proj"]["a"].shape) == jl["proj"]["a"].shape == (128, 4)
    tlayers.merge_lora(holder, lora)
    assert mod.lora is lora["proj"]
    tlayers.set_int4_impl(holder, "plain")
    assert mod.impl == "plain"
    x = torch.from_numpy(rng.standard_normal((40, 128)).astype(np.float32))
    y_plain = tlayers.dense(mod, x)
    tlayers.set_int4_impl(holder, "auto")
    assert torch.equal(y_plain, tlayers.dense(mod, x))  # on the CPU both are the plain version
    with pytest.raises(ValueError):
        tlayers.set_int4_impl(holder, "fast")
