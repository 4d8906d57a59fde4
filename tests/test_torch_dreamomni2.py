"""DreamOmni2 in the port (qflux_tpu_torch/trainer/dreamomni2.py, the
cumulative control ids of ops/rope.py, the KV-cached decoding of
models/qwen/vl_encoder.py, porting.convert_vl_lm_head) against the JAX
package on the CPU, at tiny width, on one set of weights (JAX's tiny FLUX
and Qwen2.5-VL trees and an LM head filled from numpy, bridged into the
port).

Bounds: the ids, the LM head's conversion and the fused base weights equal
JAX's exactly (the same f32 a @ b added in the same order); the cached
prefill and decode steps' hidden states within relative L2 2e-5 of JAX's
(the same f32 layers summed in other orders) and within JAX's own bound of
the uncached forward (rtol 2e-4, atol 2e-5,
tests/trainer/test_vlm_enhancer.py); the greedy logits within relative L2
1e-4 of JAX's at every step, the ids equal wherever JAX's top two logits
are more than twice the step's largest logit difference apart (closer, the
argmax may flip; the comparison then ends), and where no step comes that
close, the whole rewritten prompt equal; the pixel batch's embeddings
within 2e-5.
"""

from __future__ import annotations

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu import config as jconfig
from qflux_tpu.models.qwen import porting as jporting
from qflux_tpu.models.qwen import vl_encoder as jvl
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops import rope as jrope
from qflux_tpu.trainer import dreamomni2 as jd2
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu_torch.config import config_from_dict, load_config_from_yaml
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.qwen import porting as tporting
from qflux_tpu_torch.models.qwen import vl_encoder as tvl
from qflux_tpu_torch.ops import rope as trope
from qflux_tpu_torch.trainer import dreamomni2 as td2
from qflux_tpu_torch.trainer import flux_kontext as tfk
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.utils.lora_io import save_lora_safetensors
from tests.test_torch_cache_pass import _config, _write_folder, run_example_config
from tests.test_torch_cache_pass import weights  # noqa: F401  (a fixture)
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_qwen_encoders import vl_trees

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 2e-5
LOGIT_TOL = 1e-4
GREEDY_MARGIN = 2.0  # × the step's largest logit difference: below it an argmax may flip
MSL = 24
NEW_TOKENS = 8


def test_cumulative_control_ids_match_jax():
    """Three reference images of three grids: set ids 1-3 and row and
    column offsets summed over the images before, as JAX's (the row offset
    is JAX's own, tests/ops/test_rope.py pins it there)."""
    shapes = [(2, 3), (4, 1), (3, 3)]
    got, want = trope.dreamomni2_control_ids(shapes), jrope.dreamomni2_control_ids(shapes)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6 + 4 + 9, 3)
    np.testing.assert_array_equal(got[6], [2, 2, 3])   # image 2 starts at (h 2, w 3)
    np.testing.assert_array_equal(got[10], [3, 6, 4])  # image 3 at (h 2 + 4, w 3 + 1)


@pytest.fixture(scope="module")
def d2(weights):  # noqa: F811  (the FLUX fixture)
    """JAX's DreamOmni2 with the enhancer on: the tiny FLUX set of
    tests/test_torch_cache_pass.py, the tiny VL trees and an LM head
    0.05 · N(0, 1) from numpy, as a JAX adapter + bundle; the numpy
    trees."""
    fadapter, fbundle, ftrees = weights
    vision, text = vl_trees(60)
    head = (0.05 * np.random.default_rng(61).standard_normal(
        (jvl.VLTextConfig.tiny().hidden_size, jvl.VLTextConfig.tiny().vocab_size))
    ).astype(np.float32)
    trees = dict(ftrees, vision=vision, text=text, lm_head={"kernel": head})
    bundle = jd2.ModelBundle(
        dit_cfg=fbundle.dit_cfg, dit_params=fbundle.dit_params, vae_cfg=fbundle.vae_cfg,
        vae_params=fbundle.vae_params,
        text_cfgs=dict(fbundle.text_cfgs, vision=jvl.VLVisionConfig.tiny(),
                       text=jvl.VLTextConfig.tiny(),
                       tokens=jvl.VLSpecialTokens(500, 502, 503, (1,))),
        text_params=dict(fbundle.text_params, vision=vision, text=text,
                         lm_head={"kernel": jnp.asarray(head)}),
        tokenizers=dict(fbundle.tokenizers,
                        vl=jfk.SimpleTokenizer(jvl.VLTextConfig.tiny().vocab_size, 512)))
    adapter = jd2.DreamOmni2Adapter(fadapter.cfg, remat=False, vae_scale=fadapter.vae_scale,
                                    use_vlm_prompt_enhancer=True)
    return adapter, bundle, trees


def _port(tmp_path, trees, enhancer=True, bridge_dit=True, **model):
    """The port's Trainer (variant test, the enhancer as asked) with every
    JAX tree bridged in (the DiT's, unless the load put it in itself)."""
    data = _write_folder(tmp_path, 1)
    raw = {"use_vlm_prompt_enhancer": enhancer, **model}
    path = _config(tmp_path, data, trainer="DreamOmni2Trainer", model=raw)
    tr = Trainer(load_config_from_yaml(path), device="cpu")
    tr.load_model()
    b = tr.bundle
    if bridge_dit:
        bridge.load_params(b.dit_params, trees["dit"])
    bridge.load_vae_params(b.vae_params, trees["vae"])
    enc = tfk.text_encoders(b)
    bridge.load_text_params(enc["clip"], trees["clip"])
    bridge.load_text_params(enc["t5"], trees["t5"])
    if enhancer:
        bridge.load_params(enc["vision"], trees["vision"])
        bridge.load_params(enc["text"], trees["text"])
        bridge.load_params(enc["lm_head"], trees["lm_head"])
    return tr, path, data


# ---------------------------------------------------------------------------
# the fused edit-LoRA

def _edit_lora(trees, tmp_path) -> Path:
    """A rank-4 LoRA over every FLUX attention projection (b nonzero) in a
    diffusers LoRA file, written by the port."""
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(5), trees["dit"],
                                 [r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)"],
                                 rank=4, alpha=8.0)
    rng = np.random.default_rng(62)
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        if p[-1].key == "b" else np.asarray(x), jl)
    model = bridge.load_params(tfk.flux.FluxTransformer(tfk.flux.FluxConfig.tiny(),
                                                        dtype=torch.float32), trees["dit"])
    return save_lora_safetensors(bridge.lora_from_tree(model, jl), tmp_path / "edit")


def test_fused_edit_lora_equals_jax(tmp_path, d2, caplog, monkeypatch):
    """model.pretrained_embeddings: the port's load (variant test, the JAX
    base bridged in before the fuse) reads the LoRA file and folds it in;
    every base weight equals JAX's load on the same base (its `fuse_lora`
    over its own read of the file, at its default head dim), and the LoRA
    changed them.  A file that cannot be read only warns, in both packages,
    and leaves the base as it was."""
    trees = d2[2]
    lora_file = _edit_lora(trees, tmp_path)
    real = tfk.FluxKontextAdapter.load.__func__

    def load(cls, config, device, dtype=torch.bfloat16, mesh=None):
        adapter, bundle = real(cls, config, device, dtype, mesh)
        bridge.load_params(bundle.dit_params, trees["dit"])
        return adapter, bundle

    def jload(cls, config, dtype=jnp.float32):  # JAX's FLUX load: the same tiny base
        return d2[0], jd2.ModelBundle(d2[1].dit_cfg, jax.tree.map(jnp.asarray, trees["dit"]))

    monkeypatch.setattr(tfk.FluxKontextAdapter, "load", classmethod(load))
    monkeypatch.setattr(jfk.FluxKontextAdapter, "load", classmethod(jload))

    def jax_load(lora):
        cfg = jconfig.Config.model_validate({"trainer": "DreamOmni2Trainer", "model": {
            "variant": "test", "pretrained_embeddings": lora}})
        return jd2.DreamOmni2Adapter.load(cfg, dtype=jnp.float32)[1].dit_params

    def module(tree):
        return bridge.load_params(tfk.flux.FluxTransformer(tfk.flux.FluxConfig.tiny(),
                                                           dtype=torch.float32),
                                  jax.tree.map(np.asarray, tree))

    tr, _, _ = _port(tmp_path, trees, enhancer=False, bridge_dit=False,
                     pretrained_embeddings=str(lora_file))
    want, base = module(jax_load(str(lora_file))), module(trees["dit"])
    moved = 0
    for (name, p), (_, w), (_, b0) in zip(tr.bundle.dit_params.named_parameters(),
                                          want.named_parameters(), base.named_parameters()):
        assert torch.equal(p, w), name
        moved += not torch.equal(p, b0)
    assert moved == 2 * 8 + 4 * 3  # dual: 8 projections, single: q, k, v
    missing = str(tmp_path / "missing.safetensors")
    for package in ("port", "jax"):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            got = (_port(tmp_path / "bad", trees, enhancer=False, bridge_dit=False,
                         pretrained_embeddings=missing)[0].bundle.dit_params
                   if package == "port" else module(jax_load(missing)))
        assert "edit-LoRA fuse failed" in caplog.text, package
        for (name, p), (_, b0) in zip(got.named_parameters(), base.named_parameters()):
            assert torch.equal(p, b0), (package, name)


# ---------------------------------------------------------------------------
# the KV cache and greedy decoding

def test_lm_head_conversion_matches_jax():
    """convert_vl_lm_head: `lm_head.weight` transposed, else the tied
    embedding's, as JAX's (both prefix forms)."""
    rng = np.random.default_rng(63)
    w, e = rng.standard_normal((7, 5)).astype(np.float32), rng.standard_normal((7, 5))
    for sd in ({"lm_head.weight": w, "model.embed_tokens.weight": e.astype(np.float32)},
               {"model.language_model.embed_tokens.weight": w},
               {"model.embed_tokens.weight": w}):
        got = tporting.convert_vl_lm_head({k: torch.from_numpy(v) for k, v in sd.items()})
        np.testing.assert_array_equal(got["kernel"].numpy(),
                                      jporting.convert_vl_lm_head(sd)["kernel"])


def test_prefill_and_decode_match_jax_and_the_full_forward(d2):
    """text_prefill over the first 3 of 7 positions (M-RoPE positions of an
    image grid in t / h / w) and four cached text_decode_steps: each step's
    hidden state within REL_TOL of JAX's text_prefill / text_decode_step
    on the same cache, and within JAX's bound of the port's uncached
    text_forward over all 7; the caches' filled slots within REL_TOL of
    JAX's, the slots past them zero."""
    tcfg, jtcfg = tvl.VLTextConfig.tiny(), jvl.VLTextConfig.tiny()
    lm = bridge.load_params(tvl.TextModel(tcfg), d2[2]["text"])
    rng = np.random.default_rng(64)
    s, split = 7, 3
    embeds = rng.standard_normal((1, s, tcfg.hidden_size)).astype(np.float32)
    pos = np.stack([np.arange(s), np.arange(s) // 2, np.arange(s) % 3])[:, None].astype(np.int64)
    full = tvl.text_forward(lm, tcfg, torch.from_numpy(embeds), pos)
    cache = tvl.make_kv_cache(tcfg, 1, s + 2)
    jcache = jvl.make_kv_cache(jtcfg, 1, s + 2, jnp.float32)
    h, cache = tvl.text_prefill(lm, tcfg, torch.from_numpy(embeds[:, :split]), pos[:, :, :split],
                                cache)
    jh, jcache = jvl.text_prefill(d2[2]["text"], jtcfg, jnp.asarray(embeds[:, :split]),
                                  pos[:, :, :split], jcache)
    assert _rel_err(h.numpy(), np.asarray(jh)) < REL_TOL
    np.testing.assert_allclose(h.numpy(), full[:, :split].numpy(), rtol=2e-4, atol=2e-5)
    for i in range(split, s):
        h, cache = tvl.text_decode_step(lm, tcfg, torch.from_numpy(embeds[:, i:i + 1]),
                                        pos[:, :, i:i + 1], cache, i)
        jh, jcache = jvl.text_decode_step(d2[2]["text"], jtcfg, jnp.asarray(embeds[:, i:i + 1]),
                                          pos[:, :, i:i + 1], jcache, jnp.asarray(i, jnp.int32))
        assert h.shape == (1, tcfg.hidden_size)
        assert _rel_err(h.numpy(), np.asarray(jh)) < REL_TOL, i
        np.testing.assert_allclose(h.numpy(), full[:, i].numpy(), rtol=2e-4, atol=2e-5)
    for k in ("k", "v"):
        assert _rel_err(cache[k][:, :, :s].numpy(), np.asarray(jcache[k])[:, :, :s]) < REL_TOL
        assert not cache[k][:, :, s:].any()


def _record_greedy(monkeypatch):
    """Wrap both packages' prefill and decode steps to record each hidden
    state the greedy loop reads its next id from."""
    seen = {"port": [], "jax": []}
    real_tp, real_td = tvl.text_prefill, tvl.text_decode_step
    real_jp, real_jd = jvl.text_prefill_jit, jvl.text_decode_step_jit

    def tp(params, cfg, embeds, pos, cache):
        h, cache = real_tp(params, cfg, embeds, pos, cache)
        seen["port"].append(h[0, -1].numpy())
        return h, cache

    def td(*a):
        h, cache = real_td(*a)
        seen["port"].append(h[0].numpy())
        return h, cache

    def jp(params, cfg, embeds, pos, cache):
        h, cache = real_jp(params, cfg, embeds, pos, cache)
        seen["jax"].append(np.asarray(h[0, -1]))
        return h, cache

    def jd(*a):
        h, cache = real_jd(*a)
        seen["jax"].append(np.asarray(h[0]))
        return h, cache

    monkeypatch.setattr(tvl, "text_prefill", tp)
    monkeypatch.setattr(tvl, "text_decode_step", td)
    monkeypatch.setattr(jvl, "text_prefill_jit", jp)
    monkeypatch.setattr(jvl, "text_decode_step_jit", jd)
    return seen


def test_greedy_ids_match_jax(tmp_path, d2, monkeypatch):
    """enhance_prompt on two reference images, NEW_TOKENS greedy steps, in
    both packages: the logits of every step within LOGIT_TOL of JAX's, the
    ids equal at every step whose top-two margin exceeds GREEDY_MARGIN ×
    the largest logit difference (up to the first step where they may
    flip), and, where none may, the whole rewritten prompt (the hash
    tokenizer writes the ids) equal."""
    tr, _, _ = _port(tmp_path, d2[2])
    seen = _record_greedy(monkeypatch)
    rng = np.random.default_rng(65)
    images = [rng.integers(0, 256, (56, 56, 3), dtype=np.uint8),
              rng.integers(0, 256, (28, 56, 3), dtype=np.uint8)]
    got = tr.adapter.enhance_prompt(tr.bundle, "put the cat on the sofa", images,
                                    max_new_tokens=NEW_TOKENS)
    want = d2[0].enhance_prompt(d2[1], "put the cat on the sofa", images,
                                max_new_tokens=NEW_TOKENS)
    head = d2[2]["lm_head"]["kernel"]
    assert len(seen["port"]) >= 2 and seen["port"][0].shape == seen["jax"][0].shape
    flipped, compared = False, 0
    for hp, hj in zip(seen["port"], seen["jax"]):
        lp, lj = hp @ head, hj @ head
        assert _rel_err(lp, lj) < LOGIT_TOL
        top2 = np.sort(lj)[-2:]
        if top2[1] - top2[0] <= GREEDY_MARGIN * np.abs(lp - lj).max():
            flipped = True
            break
        assert int(np.argmax(lp)) == int(np.argmax(lj))
        compared += 1
    print(f"greedy: {compared} of {len(seen['jax'])} steps compared, flipped {flipped}")
    assert compared >= 2
    if not flipped:
        assert len(seen["port"]) == len(seen["jax"]) and got == want
    assert got.startswith("tok") and got != "put the cat on the sofa"


def test_rewrite_keeps_empty_prompts_and_embeds_as_jax(tmp_path, d2):
    """A bs=2 pixel batch with two controls, prompts ["", an instruction]:
    the empty prompt stays empty (conditioning dropout chose it), the other
    is rewritten as JAX rewrites it; prepare_embeddings then equals JAX's
    (within REL_TOL) with the controls' cumulative ids."""
    tr, _, _ = _port(tmp_path, d2[2])
    rng = np.random.default_rng(66)
    batch = {"image": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             "control": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             "control_1": rng.integers(0, 256, (2, 16, 32, 3), dtype=np.uint8),
             "prompt": ["", "add a red hat"]}
    got = tr.adapter._rewrite_batch_prompts(tr.bundle, batch)["prompt"]
    want = d2[0]._rewrite_batch_prompts(d2[1], batch)["prompt"]
    assert got[0] == want[0] == "" and got[1] == want[1] != "add a red hat"
    e_t = tr.adapter.prepare_embeddings(tr.bundle, batch, MSL)
    e_j = d2[0].prepare_embeddings(d2[1], batch, MSL)
    np.testing.assert_array_equal(e_t["img_ids"], np.asarray(e_j["img_ids"]))
    assert e_t["img_ids"][64 + 64, 1] == 8  # control_1 starts below control (h offset 8)
    for k in ("image_latents", "control_latents", "prompt_embeds", "pooled_prompt_embeds"):
        assert _rel_err(e_t[k].numpy(), np.asarray(e_j[k])) < REL_TOL, k


def test_without_vlm_path_prompts_pass_through(caplog):
    """use_vlm_prompt_enhancer with no model.vlm_path (a full-width
    config): both packages load no VL and warn, and enhance_prompt hands
    the prompt back unchanged."""
    raw = {"trainer": "DreamOmni2Trainer", "model": {"use_vlm_prompt_enhancer": True}}
    with caplog.at_level(logging.WARNING):
        assert td2.vlm_factory(config_from_dict(raw), "cpu") is None
    assert "vlm_path missing" in caplog.text
    jb, tb = jd2.ModelBundle(None, None), tfk.ModelBundle(None, None)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jd2.DreamOmni2Adapter._load_vlm(jconfig.Config.model_validate(raw), jb)
    assert "vlm_path" in caplog.text and "vision" not in jb.text_params
    img = np.zeros((56, 56, 3), np.uint8)
    cfg = tfk.flux.FluxConfig.tiny()
    assert td2.DreamOmni2Adapter(cfg, use_vlm_prompt_enhancer=True).enhance_prompt(
        tb, "keep me", [img]) == "keep me"
    assert jd2.DreamOmni2Adapter(cfg, use_vlm_prompt_enhancer=True).enhance_prompt(
        jb, "keep me", [img]) == "keep me"


@pytest.mark.parametrize("mode", ["--cache", "fit", "--predict"])
def test_example_config_runs_every_cli_mode(tmp_path, d2, mode):
    """configs/example_dreamomni2.yaml at variant test through every CLI
    mode (`run_example_config`; pretrained_embeddings a LoRA file written
    here): `--cache` fuses the edit-LoRA and writes JAX's nine keys with
    the controls' cumulative ids, a fit from that cache takes two finite
    steps, `--predict` with two --control images writes a PNG."""
    lora = str(_edit_lora(d2[2], tmp_path))
    cached, _, _ = run_example_config(tmp_path, "example_dreamomni2.yaml", mode,
                                      model={"pretrained_embeddings": lora}, controls=2)
    assert type(cached.adapter) is td2.DreamOmni2Adapter
    ids = [np.load(p)["data"] for p in (tmp_path / "out" / "cache" / "ctl_ids").glob("*.npz")]
    two = next(i for i in ids if len(i) == 2 * 64)  # sample 1: control and control_1
    np.testing.assert_array_equal(two[64], [2, 8, 8])  # control_1 after control's 8 × 8
