"""Parity of the PyTorch port's ops (qflux_tpu_torch.ops / models.common)
against the JAX package's, on the CPU, in float32.

Every input is drawn once with numpy and handed to both packages; weights
go through the port's bridge (models/bridge.py), so both compute on the same
numbers.  Tolerance: 1e-5 relative (with a 1e-6 absolute floor for values
near 0).  Both sides are float32 throughout, so the only differences are
the order of the f32 sums in XLA's and PyTorch's CPU kernels (a few ulps,
~1e-7 relative); 1e-5 leaves room for that and nothing else.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.models.common import embeddings as jemb
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops import norms as jnorms
from qflux_tpu.ops import packing as jpacking
from qflux_tpu.ops import rope as jrope
from qflux_tpu_torch.models.bridge import load_params, lora_from_tree
from qflux_tpu_torch.models.common import embeddings as temb
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import norms as tnorms
from qflux_tpu_torch.ops import packing as tpacking
from qflux_tpu_torch.ops import rope as trope

RTOL, ATOL = 1e-5, 1e-6

# Under pytest-xdist each worker process has its own torch, whose CPU ops
# take one OpenMP thread per core by default: six workers on eight cores
# then run 48 threads, and the port's many small ops spin waiting for each
# other (a tiny FLUX predict took 0.55 s alone and 208 s in a six-worker
# run).  Every worker collects this module (the port's tests import its
# helpers), so each gets its share of the cores here.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def _close(t_out, j_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=rtol, atol=atol)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _dense_pair(rng, din, dout, bias=True):
    """One dense layer as a JAX {"kernel", "bias"} node and the bridged port
    `Dense` holding the same numbers."""
    p = {"kernel": _randn(rng, din, dout) / np.sqrt(din)}
    if bias:
        p["bias"] = _randn(rng, dout)
    mod = load_params(tlayers.Dense(din, dout, bias=bias), p)
    return p, mod


def rel_err(a, b):
    """Symmetric relative L2 error (also used by the other test_torch_* files)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(a) + np.linalg.norm(b) + 1e-12)


def random_tree(init, seed):
    """`init`'s parameter tree, filled from numpy instead of JAX's random
    draws (which dominate the CPU time at this size): the structure and
    shapes come from jax.eval_shape; kernels U(±1/sqrt(fan_in)) as
    dense_init/_conv_init, norm scales 1 + 0.1·N, biases 0.05·N.  Also used
    by the other test_torch_* files."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":  # conv HWIO, or dense [in, out] / stacked [L, in, out]
            fan_in = np.prod(shape[:-1]) if len(shape) == 4 else shape[-2]
            x = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        elif name == "scale":
            x = 1 + 0.1 * rng.standard_normal(shape)
        else:
            x = 0.05 * rng.standard_normal(shape)
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


# ---------------------------------------------------------------------------
# norms

@pytest.mark.parametrize("with_scale", [False, True])
def test_rms_norm(with_scale):
    rng = np.random.default_rng(0)
    x = _randn(rng, 2, 7, 32) * 3
    s = 1 + 0.1 * _randn(rng, 32) if with_scale else None
    j = jnorms.rms_norm(jnp.asarray(x), None if s is None else jnp.asarray(s))
    t = tnorms.rms_norm(torch.from_numpy(x), None if s is None else torch.from_numpy(s))
    _close(t, j)


def test_layer_norm_and_modulate():
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 9, 48) * 2 + 0.5
    shift, scale = _randn(rng, 2, 48), _randn(rng, 2, 48)
    _close(tnorms.layer_norm(torch.from_numpy(x)), jnorms.layer_norm(jnp.asarray(x)))
    _close(tnorms.modulate(torch.from_numpy(x), torch.from_numpy(shift), torch.from_numpy(scale)),
           jnorms.modulate(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale)))


@pytest.mark.parametrize("n_mods", [2, 3, 6])
def test_ada_ln_mods(n_mods):
    rng = np.random.default_rng(2)
    d = 16
    p, mod = _dense_pair(rng, d, n_mods * d)
    t_in = _randn(rng, 2, d)
    j = jnorms.ada_ln_mods({"proj": p}, jnp.asarray(t_in), n_mods)
    t = tnorms.ada_ln_mods(mod, torch.from_numpy(t_in), n_mods)
    assert len(t) == len(j) == n_mods
    for a, b in zip(t, j):
        assert a.dtype == torch.float32 and a.shape == b.shape
        _close(a, b)


# ---------------------------------------------------------------------------
# rope tables and ids

@pytest.mark.parametrize("axes,batched", [((16, 56, 56), False), ((8, 12, 12), True)])
def test_rope_from_coords(axes, batched):
    rng = np.random.default_rng(3)
    ids = np.concatenate([jrope.flux_text_ids(5), jrope.flux_image_ids(3, 4, 1)])
    if batched:  # per-sample ids [B, S, 3], offsets differ per sample
        ids = np.stack([ids, ids + rng.integers(0, 5, ids.shape).astype(np.float32)])
    jc, js = jrope.rope_from_coords(jnp.asarray(ids), axes)
    tc, ts = trope.rope_from_coords(torch.from_numpy(ids), axes)
    assert tc.dtype == torch.float32 and tc.shape[-1] == sum(axes)
    _close(tc, jc)
    _close(ts, js)


def test_flux_ids_match():
    for args in [(4, 6), (4, 6, 1), (3, 5, 2, 7, 9)]:
        np.testing.assert_array_equal(trope.flux_image_ids(*args), jrope.flux_image_ids(*args))
    np.testing.assert_array_equal(trope.flux_text_ids(11), jrope.flux_text_ids(11))


# ---------------------------------------------------------------------------
# packing

def test_pack_unpack_latents():
    rng = np.random.default_rng(4)
    lat = _randn(rng, 2, 6, 8, 16)
    jp = jpacking.pack_latents(jnp.asarray(lat))
    tp = tpacking.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    back = tpacking.unpack_latents(tp, 6, 8)
    np.testing.assert_array_equal(back.numpy(), lat)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jpacking.unpack_latents(jp, 6, 8)))


# ---------------------------------------------------------------------------
# embeddings

def test_sinusoidal_embedding_and_mlp_silu():
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 1, 3).astype(np.float32)
    # the arguments t·1000·f reach ~1000, where one f32 ulp is 6.1e-5: XLA
    # may fold the frequency arithmetic in another order and land one ulp
    # away, which moves cos/sin by up to that much — so 2 such ulps, absolute
    _close(temb.sinusoidal_embedding(torch.from_numpy(t)),
           jemb.sinusoidal_embedding(jnp.asarray(t)), atol=2 * 6.1e-5)
    p_in, m_in = _dense_pair(rng, 256, 32)
    p_out, m_out = _dense_pair(rng, 32, 32)
    mlp = tlayers.MLP(256, 32)
    mlp.lin_in, mlp.lin_out = m_in, m_out
    x = _randn(rng, 3, 256)
    _close(temb.mlp_silu(mlp, torch.from_numpy(x)),
           jemb.mlp_silu({"in": p_in, "out": p_out}, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# dense + LoRA

@pytest.mark.parametrize("bias,lora_scale", [(True, 1.0), (False, 1.0), (True, 0.5)])
def test_dense_with_lora(bias, lora_scale):
    rng = np.random.default_rng(6)
    p, mod = _dense_pair(rng, 24, 40, bias=bias)
    x = _randn(rng, 2, 5, 24)
    # plain
    _close(tlayers.dense(mod, torch.from_numpy(x)), jlayers.dense(p, jnp.asarray(x)))
    # with a nonzero adapter
    a, b = _randn(rng, 24, 4) / 4, _randn(rng, 4, 40) * 0.1
    jp = {**p, "lora": {"a": jnp.asarray(a), "b": jnp.asarray(b), "scaling": 2.0}}
    mod.lora = {"a": torch.from_numpy(a), "b": torch.from_numpy(b), "scaling": 2.0}
    _close(tlayers.dense(mod, torch.from_numpy(x), lora_scale=lora_scale),
           jlayers.dense(jp, jnp.asarray(x), lora_scale=lora_scale))


def test_dense_bf16_cast_points():
    """bf16 activations: f32 base accumulation, bf16 LoRA dots, bias added in
    f32, one final round to bf16 — the same points as JAX, so the two agree
    to one bf16 ulp (2^-8 relative) of the output."""
    rng = np.random.default_rng(7)
    p, mod = _dense_pair(rng, 64, 32)
    a, b = _randn(rng, 64, 8) / 8, _randn(rng, 8, 32) * 0.1
    mod.lora = {"a": torch.from_numpy(a), "b": torch.from_numpy(b), "scaling": 1.0}
    jp = {**p, "lora": {"a": jnp.asarray(a), "b": jnp.asarray(b), "scaling": 1.0}}
    x = _randn(rng, 3, 64)
    t = tlayers.dense(mod, torch.from_numpy(x).to(torch.bfloat16))
    j = jlayers.dense(jp, jnp.asarray(x).astype(jnp.bfloat16))
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)


def _tiny_jax_flux(seed=0):
    from qflux_tpu.models.flux import transformer as jflux

    cfg = jflux.FluxConfig.tiny()
    return cfg, random_tree(lambda: jflux.init(jax.random.PRNGKey(0), cfg, jnp.float32), seed)


def test_merge_lora_matches_jax_per_layer():
    """JAX build_lora_tree (stacked [L, ...]) → bridge → port merge_lora: the
    adapted projection of every dual/single layer matches JAX's merged tree
    sliced at that layer."""
    from qflux_tpu_torch.models.flux import transformer as tflux

    cfg, jp = _tiny_jax_flux()
    rng = np.random.default_rng(8)
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(1), jp, [r"attn/(to_q|to_out)"],
                                 rank=4, alpha=8.0)
    for stack in ("dual", "single"):
        for leaf in jl[stack]["attn"].values():
            leaf["b"] = jnp.asarray(_randn(rng, *leaf["b"].shape) * 0.1)
    model = load_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32),
                        jax.tree.map(np.asarray, jp))
    tl = lora_from_tree(model, jax.tree.map(np.asarray, jl))
    assert len(tl) == 2 * cfg.num_layers + cfg.num_single_layers  # single: no to_out
    tlayers.merge_lora(model, tl)
    merged = jlayers.merge_lora(jp, jl)
    x = _randn(rng, 2, 3, cfg.dim)
    for stack, n in (("dual", cfg.num_layers), ("single", cfg.num_single_layers)):
        for i in range(n):
            node = jax.tree.map(lambda a: a[i], merged[stack]["attn"]["to_q"])
            mod = getattr(model, stack)[i].attn.to_q
            assert mod.lora is not None and mod.lora["scaling"] == 2.0
            _close(tlayers.dense(mod, torch.from_numpy(x)), jlayers.dense(node, jnp.asarray(x)))
    # a Dense the adapter does not target stays plain
    assert model.dual[0].attn.to_k.lora is None
    # merging None clears every adapter (no stale LoRA across requests)
    tlayers.merge_lora(model, None)
    assert all(m.lora is None for _, m in tlayers.iter_dense_paths(model))


def test_merge_lora_rejects_bad_trees():
    from qflux_tpu_torch.models.flux import transformer as tflux

    model = tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32)
    d = model.cfg.dim
    with pytest.raises(KeyError):
        tlayers.merge_lora(model, {"dual/0/attn/nope": {"a": torch.zeros(d, 2),
                                                        "b": torch.zeros(2, d)}})
    with pytest.raises(ValueError):
        tlayers.merge_lora(model, {"dual/0/attn/to_q": {"a": torch.zeros(d + 1, 2),
                                                        "b": torch.zeros(2, d)}})


def test_build_lora_tree_targets_and_init():
    """Same targets, shapes, zero b and alpha/r scaling as the JAX tree (the
    RNG streams differ, so a is checked by its statistics)."""
    from qflux_tpu_torch.models.flux import transformer as tflux

    cfg, jp = _tiny_jax_flux()
    targets = [r"attn/(to_q|to_k|to_v|to_out)"]
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(1), jp, targets, rank=4, alpha=16.0)
    model = tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32)
    tl = tlayers.build_lora_tree(torch.Generator().manual_seed(0), model, targets,
                                 rank=4, alpha=16.0)
    n_jax = sum(leaf["a"].shape[0] for stack in ("dual", "single")
                for leaf in jl[stack]["attn"].values())
    assert len(tl) == n_jax == 4 * cfg.num_layers + 3 * cfg.num_single_layers
    for path, leaf in tl.items():
        stack, i, _, name = path.split("/")
        ja = jl[stack]["attn"][name]["a"][int(i)]
        assert tuple(leaf["a"].shape) == ja.shape and leaf["scaling"] == 4.0
        assert not leaf["b"].any()
    a = torch.cat([leaf["a"].flatten() for leaf in tl.values()])
    assert abs(a.std().item() - 1.0 / 4) < 0.01  # gaussian · 1/rank


def test_quantized_forms_raise():
    """A `kernel_q` leaf loads into the int8 weight-only form (transposed to
    the weight's [out, in]); one that does not fit the layer raises."""
    q = np.arange(32, dtype=np.int8).reshape(8, 4)
    mod = load_params(tlayers.Dense(8, 4), {"kernel_q": q,
                                            "kernel_scale": np.ones((1, 4), np.float32),
                                            "bias": np.zeros(4, np.float32)})
    assert mod.q_form == "int8" and mod.weight is None
    np.testing.assert_array_equal(mod.q.numpy(), q.T)
    with pytest.raises(ValueError, match="does not fit"):
        load_params(tlayers.Dense(4, 4), {"kernel_q": np.zeros((8, 4), np.int8),
                                          "kernel_scale": np.ones((1, 4), np.float32)})
