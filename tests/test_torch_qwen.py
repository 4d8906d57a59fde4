"""The port's Qwen-Image-Edit predict slice (qflux_tpu_torch/models/qwen,
trainer/qwen_edit.py, ops/rope.qwen_rope, the config loader) against the
JAX package's, on the CPU at tiny width.

The same numpy inputs and the same weights (bridged with
qflux_tpu_torch/models/bridge.py, the int4-requant ones quantized by JAX's
`quantize_tree`) go through both packages.  Tolerances (relative L2 error):

  * float32 on a full-precision base: 2e-5, the bound the JAX package holds
    its own DiT to against the torch oracle (tests/models/test_dit_goldens.py);
  * float32 on an int4-requant base: 2e-3.  Each requant product is exact
    on both sides given the same activation (tests/test_torch_quant.py), but
    an activation that differs by an f32 ulp (the norms, GEMMs and softmax
    sum in other orders) can round to the neighbouring int8 step in the row
    quantization: one element of one row moves by 1/127 of the row's
    largest value.  Measured up to 1.4e-4 over twelve forwards and 2.8e-4
    over a 3-step sampler; a wrong group, plane or factor gives O(1);
  * bfloat16 (full-precision or int4-requant base): 1e-2.  The two packages
    round to bf16 at the same points, but their GEMMs and softmax sum in
    other orders, so an output can land one bf16 ulp (2^-8 = 3.9e-3
    relative) apart, and the residual stream carries those differences
    through the blocks; measured up to 1.3e-3 (full) and 2.6e-3 (int4) over
    twelve forwards, and a wrong cast point or a missing term gives O(1e-1).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.models.qwen import transformer as jqwen
from qflux_tpu.models.qwen import vae as jqvae
from qflux_tpu.models.flux import vae as jflux_vae
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops import quant as jquant
from qflux_tpu.ops import rope as jrope
from qflux_tpu.scheduler import flow_match as jfm
from qflux_tpu.trainer import qwen_edit as jqe
from qflux_tpu.trainer import sampling as jsampling
from qflux_tpu_torch.config import config_from_dict, load_config_from_yaml
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import vae as tflux_vae
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.models.qwen import vae as tqvae
from qflux_tpu_torch.ops import flash_nr, int4_matmul
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import rope as trope
from qflux_tpu_torch.scheduler import flow_match as tfm
from qflux_tpu_torch.trainer import qwen_edit as tqe
from qflux_tpu_torch.trainer import sampling as tsampling
from qflux_tpu_torch.trainer.base import Trainer
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "dit_goldens"
F32_TOL = 2e-5
INT4_F32_TOL = 2e-3
BF16_TOL = 1e-2
GH = GW = 4          # target and control planes of 4x4 packed tokens
S_TXT = 8
H = W = 16           # tiny VAE: /2, then 2x2 packing → a 4x4 grid
JCFG = jqwen.QwenImageConfig.tiny()
TCFG = tqwen.QwenImageConfig.tiny()
QCFG = config_from_dict({"model": {"quantize": {"enabled": True, "dtype": "int4_requant"}}}
                        ).model.quantize


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_dit(dtype=jnp.float32, seed=0):
    return _random_tree(lambda: jqwen.init(jax.random.PRNGKey(0), JCFG, dtype), seed)


def _port(jtree, dtype=torch.float32):
    return bridge.load_params(tqwen.QwenImageTransformer(TCFG, dtype=dtype), _np_tree(jtree))


def _lora(jtree, seed):
    """A JAX LoRA on the eight attention projections with nonzero b."""
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(seed), jtree,
                                 list(tqe.QwenImageEditAdapter.default_lora_targets),
                                 rank=4, alpha=4.0)
    rng = np.random.default_rng(seed)
    for leaf in jl["blocks"]["attn"].values():
        leaf["b"] = jnp.asarray(rng.standard_normal(leaf["b"].shape).astype(np.float32) * 0.05)
    return jl


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "hidden_states": rng.standard_normal((b, 2 * GH * GW, JCFG.in_channels)).astype(f32),
        "encoder_hidden_states": rng.standard_normal((b, S_TXT, JCFG.joint_attention_dim)
                                                     ).astype(f32),
        "timestep": rng.uniform(0.05, 1, b).astype(f32),
    }


def _segments(b=2):
    seg = np.ones((b, S_TXT + 2 * GH * GW), np.int32)
    seg[1, 5:S_TXT] = 0          # sample 1: three padded text tokens
    return seg


# ---------------------------------------------------------------------------
# rope

@pytest.mark.parametrize("scale_rope", [True, False])
def test_qwen_rope_matches_jax(scale_rope):
    shapes = [(1, 4, 6), (1, 5, 3), (2, 2, 2)]
    for fhw in shapes:
        np.testing.assert_array_equal(trope.qwen_video_coords(*fhw, idx=1, scale_rope=scale_rope),
                                      jrope.qwen_video_coords(*fhw, idx=1, scale_rope=scale_rope))
    j = jrope.qwen_rope(shapes, 7, (8, 12, 12), scale_rope=scale_rope)
    t = trope.qwen_rope(shapes, 7, (8, 12, 12), scale_rope=scale_rope)
    for a, b in zip(t, j):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the DiT

def _forward_both(jtree, model, inputs, seg=None, dtype=np.float32, lora=None):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    shapes = [(1, GH, GW), (1, GH, GW)]
    jparams = jtree if lora is None else jlayers.merge_lora(jtree, lora)
    j = jqwen.forward(jparams, JCFG, *[jnp.asarray(inputs[k]).astype(jdt) for k in (
        "hidden_states", "encoder_hidden_states")], jnp.asarray(inputs["timestep"]).astype(jdt),
        shapes, segment_ids=None if seg is None else jnp.asarray(seg), remat=False)
    tlayers.merge_lora(model, None if lora is None else bridge.lora_from_tree(model,
                                                                              _np_tree(lora)))
    try:
        with torch.inference_mode():
            t = tqwen.forward(model, TCFG, *[torch.from_numpy(inputs[k]).to(tdt) for k in (
                "hidden_states", "encoder_hidden_states", "timestep")], shapes,
                segment_ids=None if seg is None else torch.from_numpy(seg))
    finally:
        tlayers.merge_lora(model, None)
    assert t.dtype == tdt and t.shape == j.shape == inputs["hidden_states"].shape[:2] + (16,)
    return t.float().numpy(), np.asarray(j.astype(jnp.float32))


@pytest.fixture(scope="module")
def tiny_dits():
    """{(dtype, base): (JAX tree, port model)} for f32/bf16 × full/int4."""
    out = {}
    for dtype, jdt, tdt in (("f32", jnp.float32, torch.float32),
                            ("bf16", jnp.bfloat16, torch.bfloat16)):
        jtree = _jax_dit(jdt)
        out[dtype, "full"] = (jtree, _port(jtree, tdt))
        jq = jquant.quantize_tree(jtree, QCFG)
        out[dtype, "int4"] = (jq, _port(jq, tdt))
    return out


@pytest.mark.parametrize("dtype,base,segments,with_lora", [
    ("f32", "full", False, False), ("f32", "full", True, False), ("f32", "full", True, True),
    ("f32", "int4", False, False), ("f32", "int4", True, True),
    ("bf16", "full", True, True), ("bf16", "int4", False, False), ("bf16", "int4", True, True)])
def test_dit_forward_matches_jax(tiny_dits, dtype, base, segments, with_lora):
    jtree, model = tiny_dits[dtype, base]
    lora = _lora(jtree, 5) if with_lora else None
    t, j = _forward_both(jtree, model, _inputs(1), _segments() if segments else None,
                         "bfloat16" if dtype == "bf16" else np.float32, lora)
    err = _rel_err(t, j)
    tol = BF16_TOL if dtype == "bf16" else (F32_TOL if base == "full" else INT4_F32_TOL)
    assert err < tol, f"port Qwen DiT diverges from JAX ({dtype}, {base}): rel err {err:.2e}"
    if with_lora:  # the adapter really changes the output
        t0, _ = _forward_both(jtree, model, _inputs(1), _segments() if segments else None,
                              "bfloat16" if dtype == "bf16" else np.float32)
        assert _rel_err(t, t0) > 1e-3


def test_int4_base_runs_both_routes_and_counts_no_launch(tiny_dits):
    """On the int4 base the image-stream GEMMs (2·32 rows) take the requant
    matmul and the text-stream ones (2·8 rows), the mods and time_in the
    dequantized product; on CPU tensors neither launches a kernel."""
    jtree, model = tiny_dits["f32", "int4"]
    calls = {"rq": 0}
    orig = int4_matmul.rq_fused_matmul

    def counting(*a, **k):
        calls["rq"] += 1
        return orig(*a, **k)

    int4_matmul.rq_fused_matmul = counting
    before = (int4_matmul.RQ_KERNEL_LAUNCHES, flash_nr.KERNEL_LAUNCHES)
    try:
        _forward_both(jtree, model, _inputs(2), _segments())
    finally:
        int4_matmul.rq_fused_matmul = orig
    # per block: to_q/k/v, to_out, img_mlp in/out; then img_in and proj_out
    assert calls["rq"] == TCFG.num_layers * 6 + 2
    assert (int4_matmul.RQ_KERNEL_LAUNCHES, flash_nr.KERNEL_LAUNCHES) == before


def test_dit_forward_matches_torch_oracle_fixture():
    """The torch-oracle golden of tests/models/test_dit_goldens.py: the
    state_dict through the JAX converter, then the bridge, then the port's
    forward, reproduces the oracle's output."""
    from qflux_tpu.models.porting import convert_with_coverage
    from qflux_tpu.models.qwen.porting import convert_qwen_image_transformer

    z = np.load(FIXTURES / "qwen_tiny.npz")
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
    inputs = {k[3:]: z[k] for k in z.files if k.startswith("in.")}
    params, unconsumed = convert_with_coverage(
        convert_qwen_image_transformer, sd, num_layers=TCFG.num_layers,
        head_dim=TCFG.attention_head_dim, strict=True)
    assert not unconsumed
    model = _port(params)
    shapes = [tuple(int(v) for v in row) for row in inputs["img_shapes"]]
    with torch.inference_mode():
        out = tqwen.forward(model, TCFG, *[torch.from_numpy(np.asarray(inputs[k], np.float32))
                                           for k in ("hidden_states", "encoder_hidden_states",
                                                     "timestep")], shapes)
    assert out.shape == z["out"].shape
    err = _rel_err(out.numpy(), z["out"])
    assert err < F32_TOL, f"port Qwen DiT diverges from the torch oracle: rel err {err:.2e}"


def test_init_quantizes_block_by_block_as_quantize_tree_would():
    """`init(quantize=...)` (each block quantized as it is drawn), then
    quantize_tree over the rest, gives the model that drawing everything
    first and quantizing afterwards gives;
    every dense kernel and bias is U(±1/sqrt(in)), the norm scales are 1."""
    cfg = dataclasses.replace(TCFG, num_layers=3)
    whole = tqwen.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)
    for _, mod in tlayers.iter_dense_paths(whole):
        bound = 1.0 / mod.in_dim ** 0.5
        assert mod.weight.abs().max() <= bound and mod.weight.std() > 0.4 * bound
        assert mod.bias.abs().max() <= bound
    assert torch.equal(whole.blocks[1].attn.norm_added_k.scale, torch.ones(32))
    from qflux_tpu_torch.ops.quant import quantize_tree

    quantize_tree(whole, QCFG)
    drawn = tqwen.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32,
                       quantize=QCFG)
    assert drawn.blocks[0].attn.to_q.q4 is not None and drawn.img_in.q4 is None
    quantize_tree(drawn, QCFG)  # the rest, as Trainer.load_model does
    pairs = list(zip(tlayers.iter_dense_paths(whole), tlayers.iter_dense_paths(drawn)))
    assert len(pairs) == len(list(tlayers.iter_dense_paths(drawn)))
    for (path, a), (other, b) in pairs:
        assert path == other and (a.q4 is None) == (b.q4 is None), path
        if a.q4 is None:
            assert torch.equal(a.weight, b.weight), path
        else:
            assert torch.equal(a.q4, b.q4) and torch.equal(a.scale, b.scale), path
    assert drawn.norm_out.proj.q4 is None and drawn.blocks[2].img_mlp.lin_out.q4 is not None


def test_remat_policies_apply_only_under_autograd(tiny_dits):
    """Predict never applies a remat policy: flash_mlp runs in inference as
    remat=False does; under autograd it trains, with the LoRA gradients of
    "full"; an unknown name always raises."""
    jtree, model = tiny_dits["f32", "full"]
    x = _inputs(3)
    args = [torch.from_numpy(x[k]) for k in ("hidden_states", "encoder_hidden_states",
                                             "timestep")]
    shapes = [(1, GH, GW), (1, GH, GW)]
    with torch.inference_mode():
        a = tqwen.forward(model, TCFG, *args, shapes, remat_policy="flash_mlp")
        b = tqwen.forward(model, TCFG, *args, shapes, remat=False)
    assert torch.equal(a, b)
    lora = tlayers.mark_trainable(tlayers.build_lora_tree(
        torch.Generator().manual_seed(0), model, ["attn/to_q", "img_mlp"], 4, 4.0))
    tlayers.merge_lora(model, lora)
    try:
        grads = {}
        for policy in ("flash_mlp", "full"):
            for leaf in lora.values():
                leaf["a"].grad = leaf["b"].grad = None
            y = tqwen.forward(model, TCFG, *args, shapes, remat_policy=policy)
            y.square().mean().backward()
            grads[policy] = [leaf[k].grad.clone() for leaf in lora.values() for k in "ab"]
        assert lora["blocks/0/attn/to_q"]["b"].grad.abs().sum() > 0
        assert all(torch.equal(g, f) for g, f in zip(grads["flash_mlp"], grads["full"]))
        with pytest.raises(ValueError, match="remat_policy"):
            tqwen.forward(model, TCFG, *args, shapes, remat_policy="bogus")
    finally:
        tlayers.merge_lora(model, None)
    with pytest.raises(ValueError, match="remat_policy"):
        with torch.inference_mode():
            tqwen.forward(model, TCFG, *args, shapes, remat_policy="bogus")


# ---------------------------------------------------------------------------
# the VAE decoder

@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "query_chunked"])
def test_vae_decode_matches_jax(chunk, monkeypatch):
    cfg = jqvae.QwenVAEConfig.tiny()
    jparams = _random_tree(lambda: jqvae.init(jax.random.PRNGKey(0), cfg), 1)
    vae = bridge.load_vae_params(tqvae.QwenVAE(tqvae.QwenVAEConfig.tiny()), _np_tree(jparams))
    if chunk:  # the mid-block attention's query chunking, on both sides
        monkeypatch.setattr(jflux_vae, "ATTN_CHUNK", chunk)
        monkeypatch.setattr(tflux_vae, "ATTN_CHUNK", chunk)
    lat = np.random.default_rng(4).standard_normal((2, 4, 6, cfg.z_dim)).astype(np.float32)
    j = jqvae.decode(jparams, cfg, jnp.asarray(lat))
    with torch.inference_mode():
        t = tqvae.decode(vae, vae.cfg, torch.from_numpy(lat))
    assert t.shape == j.shape == (2, 8, 12, 3)
    err = _rel_err(t.numpy(), j)
    assert err < F32_TOL, f"port Qwen VAE decode diverges from JAX: rel err {err:.2e}"


def test_vae_full_config_and_init_bounds():
    cfg = tqvae.QwenVAEConfig()
    assert cfg.downscale == 8 and cfg.latents_mean == jqvae.LATENTS_MEAN
    assert cfg.latents_std == jqvae.LATENTS_STD
    vae = tqvae.init(torch.Generator().manual_seed(0), tqvae.QwenVAEConfig.tiny())
    conv = vae.decoder.conv_in
    cout, cin, kt, kh, kw = conv.weight.shape
    bound = (1.0 / (kt * kh * kw * cin)) ** 0.5
    assert conv.weight.abs().max() <= bound and conv.bias.abs().max() <= bound
    assert torch.equal(vae.decoder.norm_out.gamma, torch.ones(8))


# ---------------------------------------------------------------------------
# cached embeddings, the adapter, the slice end to end

def _request(seed, b, neg=False, plane=(1, GH, GW)):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = np.ones((b, S_TXT), np.int64)
    mask[-1, 6:] = 0
    emb = {
        "control_latents": rng.standard_normal((b, GH * GW, JCFG.in_channels)).astype(f32),
        "prompt_embeds": rng.standard_normal((b, S_TXT, JCFG.joint_attention_dim)).astype(f32),
        "prompt_embeds_mask": mask,
        "img_shapes_arr": np.asarray([plane, (1, GH, GW)], np.int32),
    }
    if neg:
        emb["neg_prompt_embeds"] = rng.standard_normal(emb["prompt_embeds"].shape).astype(f32)
        nm = np.ones((b, S_TXT), np.int64)
        nm[:, 3:] = 0
        emb["neg_prompt_embeds_mask"] = nm
    return emb


def test_prepare_cached_embeddings_matches_jax():
    jad = jqe.QwenImageEditAdapter(JCFG)
    tad = tqe.QwenImageEditAdapter(TCFG)
    one = _request(0, 1)
    collated = dict(one, img_shapes_arr=np.stack([one["img_shapes_arr"]] * 2))
    mixed = dict(collated, image_latents=np.zeros((2, GH * GW, 16), np.float32))
    # sample 1: a 2x4 target and a 4x2 control, padded to the 4x4 sections;
    # sample 0 has one plane only (a zero row, as collation pads it)
    mixed["img_shapes_arr"] = np.asarray([[[1, GH, GW], [0, 0, 0]],
                                          [[1, 2, GW], [1, GH, 2]]], np.int32)
    for emb in (one, collated, mixed):
        j = jad.prepare_cached_embeddings(emb)
        t = tad.prepare_cached_embeddings(emb)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]), rtol=1e-5, atol=1e-6)
    assert np.asarray(t["rope_vid_cos"]).shape == (2, 2 * GH * GW, 32)


@pytest.fixture(scope="module")
def tiny_bundles():
    """JAX and port bundles over the same tiny DiT (full and int4-requant)
    and VAE."""
    vcfg = jqvae.QwenVAEConfig.tiny()
    jtree = _jax_dit(seed=6)
    jv = _random_tree(lambda: jqvae.init(jax.random.PRNGKey(0), vcfg), 7)
    vae = bridge.load_vae_params(tqvae.QwenVAE(tqvae.QwenVAEConfig.tiny()), _np_tree(jv))
    out = {}
    for base, tree in (("full", jtree), ("int4", jquant.quantize_tree(jtree, QCFG))):
        out[base] = (jqe.ModelBundle(dit_cfg=JCFG, dit_params=tree, vae_cfg=vcfg, vae_params=jv),
                     tqe.ModelBundle(dit_cfg=TCFG, dit_params=_port(tree), vae_cfg=vae.cfg,
                                     vae_params=vae))
    return out, _lora(jtree, 8)


@pytest.mark.parametrize("base,b,cfg_scale", [("full", 2, 1.0), ("full", 1, 4.0),
                                              ("int4", 2, 1.0), ("int4", 1, 4.0)],
                         ids=["bs2", "true_cfg", "int4_bs2", "int4_true_cfg"])
def test_slice_matches_jax_sampler_and_decode(tiny_bundles, base, b, cfg_scale):
    """Sampler + VAE decode, f32, the same numpy initial latents on both
    sides; true-CFG runs the negative embeddings (and their mask) through a
    second forward.  Latents to F32_TOL (full base) or INT4_F32_TOL relative."""
    bundles, jl = tiny_bundles
    jbundle, tbundle = bundles[base]
    steps = 3
    emb = _request(10 + b, b, neg=cfg_scale > 1)
    lat0 = np.random.default_rng(20).standard_normal((b, GH * GW, 16)).astype(np.float32)

    jad = jqe.QwenImageEditAdapter(JCFG, remat=False, vae_scale=2)
    jplan = jfm.FlowMatchScheduler().sampling_plan(steps, image_seq_len=GH * GW)
    jsample = jsampling.make_sampler(jad.predict_velocity, jsampling.SamplingConfig(
        steps, true_cfg_scale=cfg_scale))
    jbatch = {k: jnp.asarray(v) for k, v in jad.prepare_cached_embeddings(emb).items()}
    jlat = jsample(jlayers.merge_lora(jbundle.dit_params, jl), jbatch, jnp.asarray(lat0),
                   jnp.asarray(jplan.sigmas))
    jimg = jad.decode_latents(jbundle, jlat, H, W)

    tad = tqe.QwenImageEditAdapter(TCFG, vae_scale=2)
    tplan = tfm.FlowMatchScheduler().sampling_plan(steps, image_seq_len=GH * GW)
    tsample = tsampling.make_sampler(tad.predict_velocity, tsampling.SamplingConfig(
        steps, true_cfg_scale=cfg_scale))
    tbatch = {k: torch.as_tensor(v) for k, v in tad.prepare_cached_embeddings(emb).items()}
    model = tbundle.dit_params
    tlayers.merge_lora(model, bridge.lora_from_tree(model, _np_tree(jl)))
    try:
        tlat = tsample(model, tbatch, torch.from_numpy(lat0), tplan.sigmas)
    finally:
        tlayers.merge_lora(model, None)
    timg = tad.decode_latents(tbundle, tlat, H, W)

    assert tlat.shape == jlat.shape and torch.isfinite(tlat).all()
    err = _rel_err(tlat.numpy(), jlat)
    tol = F32_TOL if base == "full" else INT4_F32_TOL
    assert err < tol, f"sampled latents diverge from JAX: rel err {err:.2e}"
    assert timg.dtype == np.uint8 and timg.shape == jimg.shape == (b, H, W, 3)
    # a few ulps from a .5 boundary a level may round either way; on the
    # int4 base a row-quantization flip moves the latents by up to 2e-3
    # relative, which the decoder can turn into a few levels
    levels = np.abs(timg.astype(int) - jimg.astype(int))
    assert levels.max() <= (1 if base == "full" else 4) and levels.mean() < 0.05


def test_predict_velocity_masks_padded_text(tiny_bundles):
    """Without explicit segment ids the padded text (prompt_embeds_mask 0)
    is masked out of the joint attention: its values do not matter."""
    bundles, _ = tiny_bundles
    tbundle = bundles["full"][1]
    tad = tqe.QwenImageEditAdapter(TCFG, vae_scale=2)
    emb = _request(30, 2)
    batch = {k: torch.as_tensor(v) for k, v in tad.prepare_cached_embeddings(emb).items()}
    lat = torch.from_numpy(np.random.default_rng(31).standard_normal((2, GH * GW, 16))
                           .astype(np.float32))
    t = torch.full((2,), 0.7)
    with torch.inference_mode():
        v = tad.predict_velocity(tbundle.dit_params, batch, lat, t)
        batch["prompt_embeds"] = batch["prompt_embeds"].clone()
        batch["prompt_embeds"][1, 6:] = 100.0
        v2 = tad.predict_velocity(tbundle.dit_params, batch, lat, t)
        batch["prompt_embeds"][1, 2] = 100.0  # a real token does matter
        v3 = tad.predict_velocity(tbundle.dit_params, batch, lat, t)
    assert torch.allclose(v, v2, atol=1e-6)
    assert not torch.allclose(v[1], v3[1], atol=1e-3)


# ---------------------------------------------------------------------------
# the Trainer entry point

@pytest.mark.parametrize("quantize", [False, True], ids=["bf16_base", "int4_requant_base"])
def test_trainer_predict_from_embeddings(quantize):
    """Trainer(config).load_model() → predict_from_embeddings on the tiny
    Qwen model: uint8 images, finite latents, the seed decides, a LoRA with
    nonzero b changes the images, nothing launches a kernel on the CPU."""
    raw = {"trainer": "QwenImageEditTrainer",
           "model": {"variant": "test", "quantize": {"enabled": quantize,
                                                     "dtype": "int4_requant"}},
           "predict": {"num_inference_steps": 3}}
    tr = Trainer(config_from_dict(raw), device="cpu")
    tr.load_model()
    model = tr.bundle.dit_params
    assert isinstance(model, tqwen.QwenImageTransformer) and tr.dtype == torch.bfloat16
    assert (model.blocks[0].attn.to_q.q4 is not None) == quantize
    assert tr.adapter.attn_impl == "auto" and tr.adapter.remat_policy == "flash"
    lora = tr.build_lora()
    assert len(lora) == 8 * TCFG.num_layers
    before = (int4_matmul.RQ_KERNEL_LAUNCHES, flash_nr.KERNEL_LAUNCHES)
    emb = _request(40, 2)
    img = tr.predict_from_embeddings(emb, H, W, lora=lora)
    assert img.dtype == np.uint8 and img.shape == (2, H, W, 3)
    assert tr.last_predict["steps"] == 3 and tr.last_predict["latents_finite"]
    assert (int4_matmul.RQ_KERNEL_LAUNCHES, flash_nr.KERNEL_LAUNCHES) == before
    np.testing.assert_array_equal(img, tr.predict_from_embeddings(emb, H, W, lora=lora))
    assert not np.array_equal(img, tr.predict_from_embeddings(emb, H, W, lora=lora, seed=7))
    gen = torch.Generator().manual_seed(5)
    for leaf in lora.values():
        leaf["b"].normal_(0.0, 0.5, generator=gen)
    assert not np.array_equal(img, tr.predict_from_embeddings(emb, H, W, lora=lora))


def test_trainer_refusals(tmp_path):
    """A checkpoint path with no DiT raises FileNotFoundError at load (for
    predict and fit alike), as the JAX adapter does.  The int8 weight-only
    base (the Plus example config's dtype) now loads, predicts and fits.
    int8 attention (quantize.attention) now runs, in predict and in fit,
    through the s_int8 mode's plain version on CPU tensors, and launches
    nothing.  mesh.remat: flash_mlp, refused before, now fits."""
    base = {"trainer": "QwenImageEditTrainer", "model": {"variant": "test"},
            "logging": {"output_dir": str(tmp_path)}}
    q = {"enabled": True, "dtype": "int4_requant"}
    raw = {**base, "model": {"variant": "full", "dit_path": "/nowhere"}}
    with pytest.raises(FileNotFoundError, match="nowhere"):
        Trainer(config_from_dict(raw), device="cpu").load_model()
    with pytest.raises(FileNotFoundError, match="nowhere"):
        Trainer(config_from_dict(raw), device="cpu").fit([])
    tr = Trainer(config_from_dict({**base, "model": {"variant": "test",
                                                     "quantize": {**q, "dtype": "int8"}}}),
                 device="cpu")
    tr.load_model()
    assert tr.bundle.dit_params.blocks[0].attn.to_q.q_form == "int8"
    img = tr.predict_from_embeddings(_request(41, 1), H, W, num_inference_steps=1)
    assert img.dtype == np.uint8 and img.shape == (1, H, W, 3)
    batch = dict(_request(41, 1), image_latents=np.zeros((1, GH * GW, 16), np.float32))
    tr = Trainer(config_from_dict({**base, "model": {"variant": "test",
                                                     "quantize": {**q, "attention": True}}}),
                 device="cpu")
    tr.load_model()
    assert tr.adapter.attn_impl == "int8"
    launches = (flash_nr.INT8_KERNEL_LAUNCHES, flash_nr.INT8_BWD_KERNEL_LAUNCHES)
    img = tr.predict_from_embeddings(_request(41, 1), H, W, num_inference_steps=1)
    assert img.dtype == np.uint8 and img.shape == (1, H, W, 3)
    tr.config.train.max_train_steps = 1
    tr.fit([batch])
    assert len(tr.history) == 1 and np.isfinite(tr.history[0]["loss"])
    assert (flash_nr.INT8_KERNEL_LAUNCHES, flash_nr.INT8_BWD_KERNEL_LAUNCHES) == launches
    tr = Trainer(config_from_dict({**base, "mesh": {"remat": "flash_mlp"},
                                   "model": {"variant": "test", "quantize": q},
                                   "train": {"max_train_steps": 1}}), device="cpu")
    tr.fit([batch])
    assert tr.adapter.remat_policy == "flash_mlp"
    assert len(tr.history) == 1 and np.isfinite(tr.history[0]["loss"])


def test_trainer_defaults_to_the_card():
    """Trainer and Trainer.from_yaml take the card unless the caller asks for
    the CPU."""
    import inspect

    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert inspect.signature(Trainer.from_yaml).parameters["device"].default == "cuda"
    assert Trainer(config_from_dict({"model": {"variant": "test"}})).device.type == "cuda"


# ---------------------------------------------------------------------------
# the config loader and the weighting table

def _fields(cfg):
    """The fields the port reads, from a JAX Config or the port's namespaces."""
    m, t, q = cfg.model, cfg.train, cfg.model.quantize
    if isinstance(q, bool):  # JAX keeps a default `quantize: false` as the bool
        q = type("Q", (), {"enabled": q, "dtype": "int8", "group_size": 128,
                           "attention": False, "skip_patterns": [r".*norm.*", r".*embed.*"]})
    trainer = cfg.trainer.value
    return {
        "trainer": trainer, "mesh.remat": cfg.mesh.remat,
        "resume": cfg.resume,
        **{f"model.{k}": getattr(m, k) for k in ("pretrained_model_name_or_path", "dit_path",
                                                 "vae_path", "variant")},
        **{f"model.lora.{k}": getattr(m.lora, k) for k in (
            "r", "lora_alpha", "init_lora_weights", "target_modules", "pretrained_weight")},
        **{f"model.quantize.{k}": getattr(q, k) for k in (
            "enabled", "dtype", "group_size", "attention", "skip_patterns")},
        **{f"train.{k}": getattr(t, k) for k in (
            "gradient_accumulation_steps", "max_train_steps", "max_grad_norm",
            "timestep_sampling", "logit_mean", "logit_std", "weighting_scheme",
            "weighting_table", "seed", "weight_dtype", "low_memory", "num_epochs",
            "checkpointing_steps", "async_checkpointing")},
        **{f"optimizer.{k}": getattr(cfg.optimizer, k) for k in (
            "class_path", "init_args", "learning_rate")},
        **{f"lr_scheduler.{k}": getattr(cfg.lr_scheduler, k) for k in (
            "scheduler_type", "warmup_steps")},
        **{f"logging.{k}": getattr(cfg.logging, k) for k in (
            "output_dir", "project", "sampling_seed", "push_to_hub")},
        **{f"predict.{k}": getattr(cfg.predict, k) for k in (
            "num_inference_steps", "guidance", "true_cfg_scale", "max_sequence_length")},
        **{f"loss.{k}": getattr(cfg.loss, k) for k in ("class_path", "init_args")},
    }


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yaml")), ids=lambda p: p.stem)
def test_config_loader_matches_jax(path):
    """Every shipped config, field by field for the fields the port reads."""
    from qflux_tpu.config import load_config_from_yaml as jload

    assert _fields(load_config_from_yaml(path)) == _fields(jload(path))


def test_config_loader_defaults_and_validators(tmp_path):
    from qflux_tpu.config import load_config_from_yaml as jload

    cases = ["trainer: QwenImageEditTrainer\nmodel: {quantize: true}\n",
             "train: {timestep_sampling: weighted, low_memory: true}\n",
             "mesh: {remat: flash_mlp}\ntrain: {low_memory: true}\n"
             "optimizer: {init_args: {b1: 0.8}}\n",
             "{}\n"]
    for i, text in enumerate(cases):
        p = tmp_path / f"c{i}.yaml"
        p.write_text(text)
        assert _fields(load_config_from_yaml(p)) == _fields(jload(p)), text


def test_default_weighting_table_is_the_jax_packages_copy():
    from qflux_tpu_torch.scheduler import weighting

    ours = weighting.DEFAULT_TABLE
    assert ours.parent == REPO / "qflux_tpu_torch" / "scheduler"
    assert ours.read_bytes() == (REPO / "qflux_tpu" / "scheduler"
                                 / "default_weighting_table.npy").read_bytes()


def test_chip_smoke_runs_the_shipped_832x576_config():
    """chip_smoke.py writes configs/example_qwen_single_chip_832x576.yaml out
    in code (the card's machine has no PyYAML); it differs from the file in
    the checkpoint path only (the weights are synthetic), quantize.attention
    included."""
    import chip_smoke

    ours = _fields(config_from_dict(chip_smoke.QWEN_832X576))
    theirs = _fields(load_config_from_yaml(REPO / "configs"
                                           / "example_qwen_single_chip_832x576.yaml"))
    diff = {k for k in ours if ours[k] != theirs[k]}
    assert diff == {"model.pretrained_model_name_or_path"}
    assert ours["model.pretrained_model_name_or_path"] is None
    assert ours["model.quantize.attention"] is True
