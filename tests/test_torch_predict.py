"""The port's predict slice (scheduler, sampler, FLUX.1-Kontext adapter,
Trainer.predict_from_embeddings) against the JAX package's, on the CPU at
tiny width.

The two packages draw their initial latents from different generators, so
the parity test injects the same numpy latents into both and compares the
sampler's output and the decoded images.  Tolerances: the latents agree to
relative L2 error 2e-5 (float32 on both sides, as tests/test_torch_flux.py),
and the uint8 images to 1 level, since a float a few ulps from a .5 boundary
may round either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.models.flux import vae as jvae
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops.rope import flux_image_ids, flux_text_ids
from qflux_tpu.scheduler import flow_match as jfm
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu.trainer import sampling as jsampling
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.models.flux import vae as tvae
from qflux_tpu_torch.ops import flash_nr
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.scheduler import flow_match as tfm
from qflux_tpu_torch.trainer import flux_kontext as tfk
from qflux_tpu_torch.trainer import sampling as tsampling
from qflux_tpu_torch.trainer.base import Trainer, predict_config
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

H = W = 32  # tiny VAE: /2, then 2×2 packing → an 8×8 grid, 64 tokens
REL_TOL = 2e-5


def _request(seed, b, gh=8, gw=8, s_txt=8, neg=False):
    """A cached-embedding request in the JAX package's cache format."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    emb = {
        "control_latents": rng.standard_normal((b, gh * gw, 16)).astype(f32),
        "prompt_embeds": rng.standard_normal((b, s_txt, 64)).astype(f32),
        "pooled_prompt_embeds": rng.standard_normal((b, 32)).astype(f32),
        "tgt_ids": flux_image_ids(gh, gw, 0),
        "ctl_ids": flux_image_ids(gh, gw, 1),
        "txt_ids": flux_text_ids(s_txt),
    }
    if neg:
        emb["neg_prompt_embeds"] = rng.standard_normal((b, s_txt, 64)).astype(f32)
        emb["neg_pooled_prompt_embeds"] = rng.standard_normal((b, 32)).astype(f32)
    return emb


# ---------------------------------------------------------------------------
# scheduler

@pytest.mark.parametrize("kw,steps,seq", [({}, 20, 1024), ({}, 4, 64),
                                          ({"use_dynamic_shifting": False}, 10, None),
                                          ({"shift_terminal": 0.02}, 8, 4096)])
def test_sampling_plan_matches_jax(kw, steps, seq):
    jp = jfm.FlowMatchScheduler(**kw).sampling_plan(steps, image_seq_len=seq)
    tp = tfm.FlowMatchScheduler(**kw).sampling_plan(steps, image_seq_len=seq)
    np.testing.assert_array_equal(tp.sigmas, np.asarray(jp.sigmas))
    np.testing.assert_array_equal(tp.timesteps, np.asarray(jp.timesteps))
    assert tp.num_steps == steps
    assert tfm.calculate_shift(seq or 256) == jfm.calculate_shift(seq or 256)


def test_scheduler_step_matches_jax():
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 5, 3)).astype(np.float32)
    v = rng.standard_normal((2, 5, 3)).astype(np.float32)
    s0, s1 = np.float32(0.8371), np.float32(0.6012)
    j = jfm.FlowMatchScheduler.step(jnp.asarray(lat), jnp.asarray(v), jnp.asarray(s0),
                                    jnp.asarray(s1))
    t = tfm.FlowMatchScheduler.step(torch.from_numpy(lat), torch.from_numpy(v), s0, s1)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# the slice: sampler + decode against JAX

@pytest.fixture(scope="module")
def tiny_models():
    """JAX tiny DiT (+ a LoRA with nonzero b) and VAE, and the port's
    modules holding the same numbers."""
    jcfg, vcfg = jflux.FluxConfig.tiny(), jvae.VAEConfig.tiny()
    jp = _random_tree(lambda: jflux.init(jax.random.PRNGKey(0), jcfg, jnp.float32), 0)
    jv = _random_tree(lambda: jvae.init(jax.random.PRNGKey(0), vcfg), 1)
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), jp, [r"attn/(to_q|to_k|to_v|to_out)"],
                                 rank=4, alpha=4.0)
    rng = np.random.default_rng(3)
    for stack in ("dual", "single"):
        for leaf in jl[stack]["attn"].values():
            leaf["b"] = jnp.asarray(rng.standard_normal(leaf["b"].shape).astype(np.float32) * 0.05)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    dit = bridge.load_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32),
                             np_tree(jp))
    vae = bridge.load_vae_params(tvae.VAE(tvae.VAEConfig.tiny()), np_tree(jv))
    lora = bridge.lora_from_tree(dit, np_tree(jl))
    jbundle = jfk.ModelBundle(dit_cfg=jcfg, dit_params=jp, vae_cfg=vcfg, vae_params=jv)
    tbundle = tfk.ModelBundle(dit_cfg=dit.cfg, dit_params=dit, vae_cfg=vae.cfg, vae_params=vae)
    return jbundle, jlayers.merge_lora(jp, jl), tbundle, lora


@pytest.mark.parametrize("b,cfg_scale,rescale", [(2, 1.0, False), (1, 3.0, False),
                                                 (1, 3.0, True)],
                         ids=["bs2", "true_cfg", "true_cfg_rescale"])
def test_slice_matches_jax_sampler_and_decode(tiny_models, b, cfg_scale, rescale):
    jbundle, jmerged, tbundle, lora = tiny_models
    steps = 4
    emb = _request(10 + b, b, neg=cfg_scale > 1)
    emb["guidance"] = np.full((b,), 2.5, np.float32)
    lat0 = np.random.default_rng(20).standard_normal((b, 64, 16)).astype(np.float32)

    jad = jfk.FluxKontextAdapter(jbundle.dit_cfg, remat=False, vae_scale=2)
    jplan = jfm.FlowMatchScheduler().sampling_plan(steps, image_seq_len=64)
    jsample = jsampling.make_sampler(jad.predict_velocity, jsampling.SamplingConfig(
        steps, true_cfg_scale=cfg_scale, guidance_rescale=rescale))
    jbatch = {k: jnp.asarray(v) for k, v in jad.prepare_cached_embeddings(emb).items()}
    jlat = jsample(jmerged, jbatch, jnp.asarray(lat0), jnp.asarray(jplan.sigmas))
    jimg = jad.decode_latents(jbundle, jlat, H, W)

    tad = tfk.FluxKontextAdapter(tbundle.dit_cfg, vae_scale=2)
    tplan = tfm.FlowMatchScheduler().sampling_plan(steps, image_seq_len=64)
    tsample = tsampling.make_sampler(tad.predict_velocity, tsampling.SamplingConfig(
        steps, true_cfg_scale=cfg_scale, guidance_rescale=rescale))
    tbatch = {k: torch.as_tensor(v) for k, v in tad.prepare_cached_embeddings(emb).items()}
    params = tlayers.merge_lora(tbundle.dit_params, lora)
    try:
        tlat = tsample(params, tbatch, torch.from_numpy(lat0), tplan.sigmas)
    finally:
        tlayers.merge_lora(tbundle.dit_params, None)
    timg = tad.decode_latents(tbundle, tlat, H, W)

    assert tlat.shape == jlat.shape and torch.isfinite(tlat).all()
    err = _rel_err(tlat.numpy(), jlat)
    assert err < REL_TOL, f"sampled latents diverge from JAX: rel err {err:.2e}"
    assert timg.dtype == np.uint8 and timg.shape == jimg.shape == (b, H, W, 3)
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


def test_prepare_cached_embeddings_matches_jax():
    jad = jfk.FluxKontextAdapter(jflux.FluxConfig.tiny())
    tad = tfk.FluxKontextAdapter(tflux.FluxConfig.tiny())
    one = _request(0, 1)
    collated = {k: (np.stack([v, v]) if k.endswith("_ids") else v) for k, v in one.items()}
    mixed = dict(collated)
    mixed["tgt_ids"] = collated["tgt_ids"].copy()
    mixed["tgt_ids"][1, :, 1] += 1  # per-sample ids differ → stay [B, S, 3]
    for emb in (one, collated, mixed):
        j = jad.prepare_cached_embeddings(emb)
        t = tad.prepare_cached_embeddings(emb)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))


# ---------------------------------------------------------------------------
# Trainer.predict_from_embeddings end to end

@pytest.fixture(scope="module")
def tiny_trainer():
    tr = Trainer(predict_config(variant="test", num_inference_steps=3), device="cpu")
    tr.load_model()
    return tr


def test_trainer_predict_from_embeddings(tiny_trainer):
    tr = tiny_trainer
    assert tr.dtype == torch.bfloat16 and tr.bundle.dit_cfg == tflux.FluxConfig.tiny()
    lora = tr.build_lora()
    assert len(lora) == 4 * 2 + 3 * 4 and all(not leaf["b"].any() for leaf in lora.values())
    before = flash_nr.KERNEL_LAUNCHES
    emb = _request(0, 2)
    img = tr.predict_from_embeddings(emb, H, W, lora=lora)
    assert img.dtype == np.uint8 and img.shape == (2, H, W, 3)
    assert tr.last_predict["steps"] == 3 and tr.last_predict["latents_finite"]
    # on CPU tensors nothing launches the CUDA kernel
    assert flash_nr.KERNEL_LAUNCHES == before
    # the initial latents come from a generator seeded by `seed`
    again = tr.predict_from_embeddings(emb, H, W, lora=lora)
    other = tr.predict_from_embeddings(emb, H, W, lora=lora, seed=7)
    np.testing.assert_array_equal(img, again)
    assert not np.array_equal(img, other)
    # a LoRA with nonzero b changes the images; b = 0 leaves them as the base
    base = tr.predict_from_embeddings(emb, H, W)
    np.testing.assert_array_equal(base, img)
    gen = torch.Generator().manual_seed(5)
    for leaf in lora.values():
        leaf["b"].normal_(0.0, 0.5, generator=gen)
    adapted = tr.predict_from_embeddings(emb, H, W, lora=lora)
    assert not np.array_equal(adapted, img)


def test_trainer_from_yaml_and_refusals(tmp_path):
    """The YAML entry point goes through the port's own loader
    (qflux_tpu_torch/config.py), over a full-precision and an int8
    weight-only base; a trainer of JAX's TrainerKind that the first slices
    lacked (QwenImageEditPlusTrainer) builds, and a name outside
    TrainerKind raises."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("trainer: FluxKontextLoraTrainer\nmodel:\n  variant: test\n"
                   "predict:\n  num_inference_steps: 2\n")
    tr = Trainer.from_yaml(str(cfg), device="cpu")
    tr.load_model()
    img = tr.predict_from_embeddings(_request(1, 1), H, W)
    assert img.shape == (1, H, W, 3) and tr.last_predict["steps"] == 2

    cfg.write_text("trainer: FluxKontextLoraTrainer\nmodel:\n  variant: test\n"
                   "  quantize: {enabled: true, dtype: int8}\n")
    tr = Trainer.from_yaml(str(cfg), device="cpu")
    tr.load_model()  # JAX's default quantized dtype loads: int8 weight-only
    assert tr.bundle.dit_params.dual[0].attn.to_q.q_form == "int8"
    assert tr.bundle.dit_params.x_embedder.q_form is None  # the skip patterns
    img = tr.predict_from_embeddings(_request(1, 1), H, W)
    assert img.shape == (1, H, W, 3)
    cfg.write_text("trainer: QwenImageEditPlusTrainer\nmodel:\n  variant: test\n")
    tr = Trainer.from_yaml(str(cfg), device="cpu")  # every trainer of JAX's TrainerKind builds
    tr.load_model()
    assert type(tr.adapter).__name__ == "QwenImageEditPlusAdapter"
    cfg.write_text("trainer: QwenImageEditPlus2Trainer\n")  # not a TrainerKind
    with pytest.raises(ValueError, match="unknown trainer"):
        Trainer.from_yaml(str(cfg), device="cpu")
