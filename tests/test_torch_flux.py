"""The port's FLUX DiT and VAE decoder (qflux_tpu_torch/models/flux) against
the JAX package's, on the CPU, in float32, on the same weights (bridged
with qflux_tpu_torch/models/bridge.py).

Tolerance: relative L2 error < 2e-5, the bound the JAX package holds its own
DiT to against the torch oracle (tests/models/test_dit_goldens.py).  Both
sides are float32 end to end; what differs is the order of the f32 sums in
each GEMM and softmax, ~1e-7 per op, compounded over the 6 blocks.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.models.flux import vae as jvae
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops.rope import flux_image_ids, flux_text_ids
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.models.flux import vae as tvae
from qflux_tpu_torch.ops import layers as tlayers
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

FIXTURES = Path(__file__).parent / "fixtures" / "dit_goldens"
REL_TOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_dit(jparams):
    model = tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32)
    return bridge.load_params(model, _np_tree(jparams))


def _dit_inputs(seed, b=2, gh=4, gw=4, s_txt=8, per_sample_ids=False):
    cfg = jflux.FluxConfig.tiny()
    rng = np.random.default_rng(seed)
    f32 = np.float32
    s_img = 2 * gh * gw  # target + one control image
    img_ids = np.concatenate([flux_image_ids(gh, gw, 0), flux_image_ids(gh, gw, 1)])
    if per_sample_ids:
        img_ids = np.stack([img_ids, img_ids + np.array([0, 1, 2], f32)])
    return {
        "hidden_states": rng.standard_normal((b, s_img, cfg.in_channels)).astype(f32),
        "encoder_hidden_states": rng.standard_normal((b, s_txt, cfg.joint_attention_dim)).astype(f32),
        "pooled_projections": rng.standard_normal((b, cfg.pooled_projection_dim)).astype(f32),
        "timestep": rng.uniform(0.05, 1, b).astype(f32),
        "img_ids": img_ids,
        "txt_ids": flux_text_ids(s_txt),
        "guidance": np.full((b,), 2.5, f32),
    }


def _forward_both(jparams, model, inputs, segment_ids=None):
    cfg = jflux.FluxConfig.tiny()
    j = jflux.forward(jparams, cfg, *[jnp.asarray(inputs[k]) for k in (
        "hidden_states", "encoder_hidden_states", "pooled_projections", "timestep",
        "img_ids", "txt_ids")], guidance=jnp.asarray(inputs["guidance"]),
        segment_ids=None if segment_ids is None else jnp.asarray(segment_ids), remat=False)
    with torch.inference_mode():
        t = tflux.forward(model, model.cfg, *[torch.from_numpy(inputs[k]) for k in (
            "hidden_states", "encoder_hidden_states", "pooled_projections", "timestep",
            "img_ids", "txt_ids")], guidance=torch.from_numpy(inputs["guidance"]),
            segment_ids=None if segment_ids is None else torch.from_numpy(segment_ids))
    return t, j


@pytest.fixture(scope="module")
def tiny_dit():
    jparams = _random_tree(lambda: jflux.init(jax.random.PRNGKey(0), jflux.FluxConfig.tiny(),
                                              jnp.float32), 0)
    return jparams, _port_dit(jparams)


@pytest.mark.parametrize("segments,per_sample_ids", [(False, False), (True, False),
                                                     (True, True)],
                         ids=["plain", "segment_ids", "segment_ids_per_sample_ids"])
def test_dit_forward_matches_jax(tiny_dit, segments, per_sample_ids):
    jparams, model = tiny_dit
    inputs = _dit_inputs(0, per_sample_ids=per_sample_ids)
    seg = None
    if segments:
        s = 8 + inputs["hidden_states"].shape[1]
        seg = np.ones((2, s), np.int32)
        seg[1, 8 + 12:8 + 16] = 0    # sample 1: last target tokens are padding
        seg[1, s - 3:] = 0           # and the last control tokens
    t, j = _forward_both(jparams, model, inputs, seg)
    assert t.shape == j.shape == inputs["hidden_states"].shape[:2] + (16,)
    err = _rel_err(t.numpy(), j)
    assert err < REL_TOL, f"port DiT diverges from the JAX forward: rel err {err:.2e}"


def test_dit_forward_with_lora_matches_jax(tiny_dit):
    """A LoRA with nonzero b on to_q/k/v/out: JAX merges it into its tree,
    the port attaches the bridged tree to its modules."""
    jparams, model = tiny_dit
    rng = np.random.default_rng(1)
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(3), jparams,
                                 [r"attn/(to_q|to_k|to_v|to_out)"], rank=4, alpha=4.0)
    for stack in ("dual", "single"):
        for leaf in jl[stack]["attn"].values():
            leaf["b"] = jnp.asarray(rng.standard_normal(leaf["b"].shape).astype(np.float32) * 0.05)
    tlayers.merge_lora(model, bridge.lora_from_tree(model, _np_tree(jl)))
    try:
        inputs = _dit_inputs(2)
        t, j = _forward_both(jlayers.merge_lora(jparams, jl), model, inputs)
        t0, j0 = _forward_both(jparams, tlayers.merge_lora(model, None), inputs)
    finally:
        tlayers.merge_lora(model, None)
    assert _rel_err(t.numpy(), j) < REL_TOL
    assert _rel_err(j, j0) > 1e-3  # the adapter really changes the output


def test_dit_forward_matches_torch_oracle_fixture():
    """The torch-oracle golden of tests/models/test_dit_goldens.py: the same
    state_dict through the JAX converter, then the bridge, then the port's
    forward, reproduces the oracle's output."""
    from qflux_tpu.models.porting import convert_flux_transformer, convert_with_coverage

    z = np.load(FIXTURES / "flux_tiny.npz")
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
    inputs = {k[3:]: z[k] for k in z.files if k.startswith("in.")}
    cfg = tflux.FluxConfig.tiny()
    params, unconsumed = convert_with_coverage(
        convert_flux_transformer, sd, num_layers=cfg.num_layers,
        num_single_layers=cfg.num_single_layers, head_dim=cfg.attention_head_dim, strict=True)
    assert not unconsumed
    model = _port_dit(params)
    with torch.inference_mode():
        out = tflux.forward(model, cfg, *[torch.from_numpy(np.asarray(inputs[k], np.float32))
                                          for k in ("hidden_states", "encoder_hidden_states",
                                                    "pooled_projections", "timestep",
                                                    "img_ids", "txt_ids")],
                            guidance=torch.from_numpy(np.asarray(inputs["guidance"], np.float32)))
    assert out.shape == z["out"].shape
    err = _rel_err(out.numpy(), z["out"])
    assert err < REL_TOL, f"port DiT diverges from the torch oracle: rel err {err:.2e}"


def test_bridge_rejects_mismatched_trees(tiny_dit):
    jparams, _ = tiny_dit
    tree = _np_tree(jparams)
    model = tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32)
    short = {k: v for k, v in tree.items() if k != "proj_out"}
    with pytest.raises(KeyError, match="proj_out"):
        bridge.load_params(model, short)
    extra = {**tree, "bogus": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="bogus"):
        bridge.load_params(model, extra)
    wrong = {**tree, "proj_out": {"kernel": np.zeros((3, 3), np.float32),
                                  "bias": tree["proj_out"]["bias"]}}
    with pytest.raises(ValueError, match="proj_out"):
        bridge.load_params(model, wrong)


def test_init_uses_dense_init_bounds():
    """`init` draws every dense kernel and bias from U(±1/sqrt(in)), as
    `dense_init`, and leaves the norm scales at 1."""
    model = tflux.init(torch.Generator().manual_seed(0), tflux.FluxConfig.tiny(),
                       dtype=torch.float32)
    for _, mod in tlayers.iter_dense_paths(model):
        bound = 1.0 / mod.in_dim ** 0.5
        assert mod.weight.abs().max() <= bound and mod.weight.std() > 0.4 * bound
        if mod.bias is not None:
            assert mod.bias.abs().max() <= bound
    assert torch.equal(model.dual[0].attn.norm_q.scale, torch.ones(32))


# ---------------------------------------------------------------------------
# VAE decoder

@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "query_chunked"])
def test_vae_decode_matches_jax(chunk, monkeypatch):
    cfg = jvae.VAEConfig.tiny()
    jparams = _random_tree(lambda: jvae.init(jax.random.PRNGKey(0), cfg), 1)
    vae = bridge.load_vae_params(tvae.VAE(tvae.VAEConfig.tiny()), _np_tree(jparams))
    if chunk:  # the mid-block attention's query chunking, on both sides
        monkeypatch.setattr(jvae, "ATTN_CHUNK", chunk)
        monkeypatch.setattr(tvae, "ATTN_CHUNK", chunk)
    lat = np.random.default_rng(4).standard_normal((2, 4, 6, cfg.latent_channels)).astype(np.float32)
    j = jvae.decode(jparams, cfg, jnp.asarray(lat))
    with torch.inference_mode():
        t = tvae.decode(vae, vae.cfg, torch.from_numpy(lat))
    assert t.shape == j.shape == (2, 8, 12, 3)
    err = _rel_err(t.numpy(), j)
    assert err < REL_TOL, f"port VAE decode diverges from JAX: rel err {err:.2e}"


def test_vae_init_uses_conv_init_bounds():
    vae = tvae.init(torch.Generator().manual_seed(0), tvae.VAEConfig.tiny())
    conv = vae.decoder.conv_in
    cout, cin, kh, kw = conv.weight.shape
    bound = (1.0 / (kh * kw * cin)) ** 0.5
    assert conv.weight.abs().max() <= bound and conv.bias.abs().max() <= bound
    assert torch.equal(vae.decoder.norm_out.scale, torch.ones(8))
