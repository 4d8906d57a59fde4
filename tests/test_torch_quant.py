"""The port's int4 frozen bases and the W4A8-requant matmul
(qflux_tpu_torch/ops/{quant,int4_matmul,layers}.py, models/bridge.py)
against the JAX package's, on the CPU.

Tolerance: zero wherever the computation is integer or a fixed chain of
IEEE float32 operations: packing, unpacking, the requant factors, the
regridded int8 weights, the row quantization and the requant matmul itself
(exact int32 accumulation, then two f32 products and one cast) are compared
with `assert_array_equal`.  Only `dense`'s LoRA dots and bias add, which
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


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rowquant_matches_jax(dtype):
    x = np.random.default_rng(2).standard_normal((3, 5, 96)).astype(np.float32) * 3
    x[1, 2] = 0.0  # an all-zero row: the scale is clamped, the values are 0
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    jv, js = jquant._rowquant(jx)
    tv, ts = tquant._rowquant(tx)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tv, jv)
    _eq(ts, js)


# ---------------------------------------------------------------------------
# the requant matmul

def _rq_case(seed, m, k_in, n, group=128, lead=()):
    rng = np.random.default_rng(seed)
    jq, js = jquant.quantize_kernel_int4(jnp.asarray(_weight(rng, k_in, n)), group)
    x = rng.standard_normal(lead + (m, k_in)).astype(np.float32)
    return x, jq, js


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 40])
def test_requant_int4_matmul_bit_exact(m, dtype):
    """The plain version equals JAX's requant_int4_matmul bit for bit."""
    x, jq, js = _rq_case(3 + m, m, 256, 48, lead=(2,))
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    j = jquant.requant_int4_matmul(jx, jq, js)
    t = tquant.requant_int4_matmul(tx, _t(jq), _t(js))
    assert t.dtype == tx.dtype
    _eq(t, j)


@pytest.mark.parametrize("m", [5, 40])
def test_plain_matches_jax_fused_pallas_kernel(m):
    """The first test K5 has: JAX's rq_fused_matmul (the Pallas kernel
    _rq_fwd_kernel, run in interpret mode on the CPU) at a shape rq_supports
    takes, against the port's plain version and against the XLA path."""
    x, jq, js = _rq_case(7, m, 3072, 128)
    assert ji4.rq_supports(3072, 128, js.shape[-2])
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    j_fused = jquant.rq_fused_matmul(jx, jq, js)
    tq, ts = _t(jq), _t(js)
    t = ti4.rq_fused_matmul(torch.from_numpy(x).to(torch.bfloat16), tq, ts)
    _eq(t, j_fused)
    _eq(t, jquant.requant_int4_matmul(jx, jq, js))


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


def test_requant_matmul_raises_under_autograd():
    """The backward (K5b) is the Qwen train slice: a requant matmul whose
    input needs a gradient raises instead of returning a result without
    one."""
    x, jq, js = _rq_case(9, 40, 128, 16)
    tq, ts = _t(jq), _t(js)
    tx = torch.from_numpy(x).requires_grad_()
    for fn in (tquant.requant_int4_matmul, ti4.rq_fused_matmul):
        with pytest.raises(NotImplementedError, match="K5b"):
            fn(tx, tq, ts)
    with torch.no_grad():
        assert tquant.requant_int4_matmul(tx, tq, ts).shape == (40, 16)


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


@pytest.mark.parametrize("dtype", ["int8", "int8_dynamic", "int4", "int4_dynamic", "fp8_e4m3"])
def test_quantize_tree_other_dtypes_raise(dtype):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tquant.quantize_tree(tlayers.Dense(128, 8), _qcfg(dtype=dtype))


def test_bridge_refuses_other_quantized_forms():
    """Only kernel_q4_rq loads; every other quantized leaf raises, and a
    q4 that does not fit the layer is refused."""
    for key in ("kernel_q", "kernel_q_dyn", "kernel_q4", "kernel_q4_dyn"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bridge.load_params(tlayers.Dense(8, 4), {key: np.zeros((4, 4), np.int8),
                                                     "kernel_scale": np.ones((1, 4), np.float32),
                                                     "bias": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="does not fit"):
        bridge.load_params(tlayers.Dense(8, 4), {"kernel_q4_rq": np.zeros((3, 4), np.int8),
                                                 "kernel_scale": np.ones((1, 4), np.float32),
                                                 "bias": np.zeros(4, np.float32)})


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [3, 40], ids=["tiny_m_dequant", "requant"])
def test_dense_int4_requant_with_lora_and_bias(m, dtype):
    """`dense` over a bridged int4-requant node with a LoRA and a bias:
    M ≤ 32 rows take the dequantized product (f32 result, the delta and bias
    added in f32), more rows the requant matmul (x.dtype result, the delta
    and bias added in x.dtype), as JAX's _base_matmul routes.  The base
    products are exact on both routes; the LoRA dots are float GEMMs summed
    in another order: f32 to 1e-5 relative, bf16 to one bf16 ulp (2^-8) of
    the output, as tests/test_torch_ops.py:test_dense_bf16_cast_points."""
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
    # without LoRA the route's base product and bias add are exact
    j0 = jlayers.dense({k: jnp.asarray(v) for k, v in node.items()}, jx)
    t0 = tlayers.dense(mod, tx)
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
