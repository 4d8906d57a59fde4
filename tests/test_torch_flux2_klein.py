"""FLUX.2-Klein in the port (qflux_tpu_torch/trainer/flux2_klein.py and its
Qwen3 encoder, models/flux2/text_encoder.py) against the JAX package on the
CPU, at tiny width, on one set of weights (JAX's tiny trees filled from
numpy, bridged into the port's modules).

Bounds: the config reader, the 4-axis ids, the converters and the
checkpoint loads equal JAX's exactly; Qwen3's picked hidden states within
relative L2 1e-5 of JAX's `encode` (the same f32 layers summed in other
orders; against transformers' Qwen3 in tests/test_torch_encoders.py); the pixel batch's embeddings within 2e-5
(the cache-pass tests' bound); a fit step's loss and a predict request's
final latents within the DiT goldens' relative error 2e-5 in f32, the
step's LoRA gradients within the train slice's 1e-4 per tensor
(tests/test_torch_train.py says why), the images within one uint8 level.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu import config as jconfig
from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.models.flux import vae as jvae
from qflux_tpu.models.flux2 import text_encoder as jq3
from qflux_tpu.models.porting import convert_flux_transformer as jconvert_flux
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.trainer import base as jbase
from qflux_tpu.trainer import flux2_klein as jklein
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu_torch.config import load_config_from_yaml
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux2 import text_encoder as tq3
from qflux_tpu_torch.trainer import flux2_klein as tklein
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.utils import png
from qflux_tpu_torch.utils.safetensors import SafeTensors, save_file
from tests.test_torch_cache_pass import _config, _write_folder, run_example_config
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_qwen_cache_pass import assert_images_close, same_noise
from tests.test_torch_train import assert_step_matches_jax

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 2e-5
Q3_TOL = 1e-5
MSL = 24
LAYERS = (1, 2, 3)


def _tiny_dit(flux2_config, hidden: int):
    return flux2_config(num_layers=2, num_single_layers=2, attention_head_dim=32,
                        num_attention_heads=4, joint_attention_dim=3 * hidden, in_channels=16,
                        out_channels=16, axes_dims_rope=(8, 8, 8, 8))


@pytest.fixture(scope="module")
def klein():
    """JAX's tiny Klein set (DiT, VAE, Qwen3, BatchNorm statistics away from
    0 / 1) filled from numpy, as a JAX adapter + bundle, and the numpy
    trees."""
    tcfg, vcfg = jq3.Qwen3Config.tiny(), jvae.VAEConfig.tiny()
    dit_cfg = _tiny_dit(jklein.flux2_config, tcfg.hidden_size)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(23)
    trees = jax.tree.map(lambda x: np.asarray(x, np.float32), {
        "dit": _random_tree(lambda: jflux.init(key, dit_cfg, jnp.float32), 20),
        "vae": _random_tree(lambda: jvae.init(key, vcfg), 21),
        "qwen3": _random_tree(lambda: jq3.init(key, tcfg), 22)})
    bn = {"bn_mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
          "bn_std": (0.5 + rng.uniform(size=16)).astype(np.float32)}
    bundle = jfk.ModelBundle(
        dit_cfg=dit_cfg, dit_params=trees["dit"], vae_cfg=vcfg, vae_params=trees["vae"],
        text_cfgs={"qwen3": tcfg, "hidden_states_layers": LAYERS, **bn},
        text_params={"qwen3": trees["qwen3"]},
        tokenizers={"qwen3": jfk.SimpleTokenizer(tcfg.vocab_size - 2, 64)})
    adapter = jklein.Flux2KleinAdapter(dit_cfg, remat=False, vae_scale=vcfg.downscale,
                                       hidden_states_layers=LAYERS)
    return adapter, bundle, trees, bn


def bridge_klein(bundle, trees, bn) -> None:
    bridge.load_params(bundle.dit_params, trees["dit"])
    bridge.load_vae_params(bundle.vae_params, trees["vae"])
    bridge.load_text_params(tklein.qwen3_encoder(bundle), trees["qwen3"])
    bundle.text_cfgs.update(bn)


def _paths(tmp_path, n=1):
    data = _write_folder(tmp_path, n)
    return data, _config(tmp_path, data, trainer="Flux2KleinLoraTrainer")


def _trainers(path, klein):
    tr = Trainer(load_config_from_yaml(path), device="cpu")
    tr.load_model()
    bridge_klein(tr.bundle, klein[2], klein[3])
    jtr = jbase.Trainer(jconfig.load_config_from_yaml(path))
    jtr.adapter, jtr.bundle = klein[0], klein[1]
    return tr, jtr


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the config reader and the ids

@pytest.mark.parametrize("case", ["known", "unknown", "unknown_allowed"])
def test_flux2_config_from_json_matches_jax(tmp_path, monkeypatch, case):
    """A diffusers config.json: its architecture keys read into the same
    FluxConfig as JAX's; a key neither consumes refuses to load in both
    packages, unless QFLUX_FLUX2_ALLOW_UNKNOWN=1 (then both warn and read
    the rest)."""
    raw = {"_class_name": "Flux2Transformer2DModel", "num_layers": 3, "num_single_layers": 5,
           "attention_head_dim": 64, "num_attention_heads": 6, "joint_attention_dim": 960,
           "in_channels": 32, "out_channels": None, "patch_size": 1, "guidance_embeds": True,
           "axes_dims_rope": [16, 16, 16, 16], "pooled_projection_dim": 0, "mlp_ratio": 3.0}
    if case != "known":
        raw["parallel_blocks"] = True
    if case == "unknown_allowed":
        monkeypatch.setenv("QFLUX_FLUX2_ALLOW_UNKNOWN", "1")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    if case == "unknown":
        for fn in (jklein.flux2_config_from_json, tklein.flux2_config_from_json):
            with pytest.raises(ValueError, match="parallel_blocks"):
                fn(path)
        return
    got, want = tklein.flux2_config_from_json(path), jklein.flux2_config_from_json(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_layers == 3 and got.axes_dims_rope == (16, 16, 16, 16)
    assert got.mlp_ratio == 3.0 and got.pooled_projection_dim == 0


def test_4d_ids_and_defaults_match_jax():
    for args in ((3, 5, 0), (4, 2, 2)):
        np.testing.assert_array_equal(tklein.latent_ids_4d(*args), jklein.latent_ids_4d(*args))
    np.testing.assert_array_equal(tklein.text_ids_4d(7), jklein.text_ids_4d(7))
    assert dataclasses.asdict(tklein.flux2_config()) == dataclasses.asdict(jklein.flux2_config())
    assert dataclasses.asdict(tq3.Qwen3Config()) == dataclasses.asdict(jq3.Qwen3Config())


# ---------------------------------------------------------------------------
# Qwen3

def _qwen3(klein):
    tcfg = tq3.Qwen3Config.tiny()
    return bridge.load_text_params(tq3.Qwen3Encoder(tcfg), klein[2]["qwen3"]), tcfg


@pytest.mark.parametrize("layers", [(1, 2, 3), (0, 4), (2,)])
def test_qwen3_encode_matches_jax(klein, layers):
    """A bs=2 batch with a padded sample: the picked states within Q3_TOL
    of JAX's (4 = num_layers is the final-normed state); the port stops
    after the highest layer it picks, and that changes no bit of the
    states it returns (against a run through every layer)."""
    enc, tcfg = _qwen3(klein)
    rng = np.random.default_rng(30)
    ids = rng.integers(1, tcfg.vocab_size, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 6:] = 0
    want = np.asarray(jq3.encode(klein[2]["qwen3"], jq3.Qwen3Config.tiny(), jnp.asarray(ids),
                                 attention_mask=jnp.asarray(mask), hidden_states_layers=layers))
    got = tq3.encode(enc, tcfg, ids, attention_mask=mask, hidden_states_layers=layers)
    assert got.shape == want.shape == (2, 10, len(layers) * tcfg.hidden_size)
    assert _rel_err(got.numpy(), want) < Q3_TOL
    full = tq3.encode(enc, tcfg, ids, attention_mask=mask, hidden_states_layers=layers + (4,))
    assert torch.equal(full[..., :got.shape[-1]], got)


def test_tiny_checkpoint_directory_loads_as_jax_converts_it(tmp_path, klein):
    """A diffusers directory written here: transformer/ (config.json and the
    DiT in two shards), vae/ (with bn.running_mean / running_var) and
    text_encoder/ (transformers' Qwen3 names).  `convert_qwen3` is leaf for
    leaf JAX's; Trainer.load_model (variant test, the directory as
    model.pretrained_model_name_or_path) reads the DiT block by block at
    the config.json's topology, equal to JAX's `convert_flux_transformer`
    tree bridged, the BatchNorm statistics as JAX's loader derives them,
    and Qwen3 one layer at a time, equal to JAX's `convert_qwen3` tree."""
    import chip_smoke

    tcfg = tq3.Qwen3Config.tiny()
    dit_cfg = _tiny_dit(tklein.flux2_config, tcfg.hidden_size)
    root = tmp_path / "klein"
    dit_sd = chip_smoke.flux_state_dict(dit_cfg, 40, torch.float32, device="cpu")
    vcfg = tklein.flux_vae.VAEConfig.tiny()
    vae_sd = chip_smoke.flux_vae_state_dict(vcfg, 41, device="cpu")
    rng = np.random.default_rng(42)
    vae_sd["bn.running_mean"] = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    vae_sd["bn.running_var"] = torch.from_numpy(rng.uniform(0.5, 2, 64).astype(np.float32))
    chip_smoke.write_checkpoint(root, dit_sd, vae_sd, shards=2)
    keys = ("num_layers", "num_single_layers", "attention_head_dim", "num_attention_heads",
            "joint_attention_dim", "in_channels", "out_channels", "guidance_embeds")
    (root / "transformer" / "config.json").write_text(json.dumps(
        {"_class_name": "Flux2Transformer2DModel",
         "axes_dims_rope": list(dit_cfg.axes_dims_rope), "pooled_projection_dim": 0,
         **{k: getattr(dit_cfg, k) for k in keys}}))
    q3_tree = jax.tree.map(np.asarray, klein[2]["qwen3"])
    q3_sd = {"model.embed_tokens.weight": q3_tree["embed_tokens"],
             "model.norm.weight": q3_tree["norm"]["scale"],
             "lm_head.weight": q3_tree["embed_tokens"]}
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i, lp in enumerate(q3_tree["layers"]):
        b = f"model.layers.{i}"
        for sub in ("attn", "mlp"):
            for k, v in lp[sub].items():
                if k in names:
                    q3_sd[f"{b}.{names[k]}.weight"] = np.ascontiguousarray(v["kernel"].T)
        for k in ("q_norm", "k_norm"):
            q3_sd[f"{b}.self_attn.{k}.weight"] = lp["attn"][k]["scale"]
        for k in ("input_layernorm", "post_attention_layernorm"):
            q3_sd[f"{b}.{k}.weight"] = lp[k]["scale"]
    (root / "text_encoder").mkdir()
    save_file(q3_sd, root / "text_encoder" / "model.safetensors")

    te = SafeTensors(root / "text_encoder")
    got_tree = tq3.convert_qwen3(te, tcfg.num_layers)
    want_tree = jq3.convert_qwen3({k: np.asarray(te[k]) for k in te}, tcfg.num_layers)
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, got_tree))
    flat_want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))

    raw = json.loads(_config(tmp_path, tmp_path, trainer="Flux2KleinLoraTrainer").read_text())
    raw["model"]["pretrained_model_name_or_path"] = str(root)
    path = tmp_path / "dir.json"
    path.write_text(json.dumps(raw))
    tr = Trainer(load_config_from_yaml(path), device="cpu")
    tr.load_model()
    b = tr.bundle
    assert b.dit_cfg.num_single_layers == 2 and b.dit_cfg.axes_dims_rope == (8, 8, 8, 8)
    want_dit = bridge.load_params(tklein.flux.FluxTransformer(b.dit_cfg, dtype=torch.float32),
                                  jconvert_flux({k: np.asarray(v) for k, v in dit_sd.items()},
                                                2, 2, head_dim=32))
    for (name, p), (_, q) in zip(b.dit_params.named_parameters(), want_dit.named_parameters()):
        assert torch.equal(p, q), name
    np.testing.assert_array_equal(b.text_cfgs["bn_mean"], vae_sd["bn.running_mean"].numpy())
    np.testing.assert_array_equal(b.text_cfgs["bn_std"],
                                  np.sqrt(vae_sd["bn.running_var"].numpy() + 1e-5))
    enc = tklein.qwen3_encoder(b)
    want_enc = bridge.load_text_params(tq3.Qwen3Encoder(tcfg), want_tree)
    for (name, p), (_, q) in zip(enc.named_parameters(), want_enc.named_parameters()):
        assert torch.equal(p, q), name


# ---------------------------------------------------------------------------
# encoding, fit and predict

def test_vae_normalization_and_decode_match_jax(tmp_path, klein):
    """encode_vae_image ((packed − bn_mean) / bn_std) within REL_TOL of
    JAX's; decode_latents (the normalization undone, the VAE decoder) of
    those latents within one uint8 level."""
    _, path = _paths(tmp_path)
    tr, jtr = _trainers(path, klein)
    images = np.random.default_rng(31).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    want = np.asarray(klein[0].encode_vae_image(klein[1], images))
    got = tr.adapter.encode_vae_image(tr.bundle, images)
    assert got.shape == want.shape == (2, 96, 16)
    assert _rel_err(got.numpy(), want) < REL_TOL
    assert abs(float(want.mean())) > 0.05  # the statistics moved the latents
    assert_images_close(tr.adapter.decode_latents(tr.bundle, got, 32, 48),
                        klein[0].decode_latents(klein[1], jnp.asarray(want), 32, 48))


def test_prepare_and_cache_embeddings_match_jax(tmp_path, klein):
    """A pixel batch with two controls (prompt padded to MSL): every
    embedding within REL_TOL (pooled = the sequence mean over all MSL
    positions), the 4-axis ids equal (controls set 1, 2); the negative
    prompt's; cache_embeddings, JAX's eight keys and their hash names."""
    _, path = _paths(tmp_path)
    tr, _ = _trainers(path, klein)
    rng = np.random.default_rng(32)
    batch = {"image": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
             "control": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
             "control_1": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
             "prompt": ["turn the sky red"]}
    adapter, bundle = klein[0], klein[1]
    want = adapter.prepare_embeddings(bundle, batch, MSL)
    got = tr.adapter.prepare_embeddings(tr.bundle, batch, MSL)
    assert sorted(got) == sorted(want)
    for k in ("image_latents", "control_latents", "prompt_embeds", "pooled_prompt_embeds"):
        assert got[k].shape == want[k].shape and _rel_err(_np(got[k]), want[k]) < REL_TOL, k
    for k in ("img_ids", "txt_ids"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert sorted(set(got["img_ids"][:, 0])) == [0, 1, 2] and got["txt_ids"].shape == (MSL, 4)
    neg_t = tr.adapter.negative_embeddings(tr.bundle, "blurry", batch, MSL)
    neg_j = adapter.negative_embeddings(bundle, "blurry", batch, MSL)
    for k in neg_j:
        assert _rel_err(_np(neg_t[k]), neg_j[k]) < REL_TOL, k
    item = dict(batch)
    item["file_hashes"] = [{"image_hash": "i", "prompt_hash": "p", "empty_prompt_hash": "e",
                            "main_hash": "m", "controls_sum_hash": "c"}]
    (arr_t, keys_t), (arr_j, keys_j) = (tr.adapter.cache_embeddings(tr.bundle, item, MSL),
                                        adapter.cache_embeddings(bundle, item, MSL))
    assert keys_t == keys_j and sorted(arr_t) == sorted(arr_j) and len(arr_t) == 8
    for k, w in arr_j.items():
        assert arr_t[k].dtype == w.dtype and arr_t[k].shape == w.shape, k
        assert _rel_err(arr_t[k], w) < REL_TOL, k


def test_fit_step_matches_jax(klein):
    """One LoRA step on a cached Klein batch (4-axis ids, guidance) at
    injected noise and σ (`assert_step_matches_jax`): the loss and
    grad_norm within REL_TOL of JAX's step, every LoRA gradient (all
    nonzero) within 1e-4."""
    adapter, bundle, trees, _ = klein
    cfg = tklein.flux2_config(**{f.name: getattr(adapter.cfg, f.name)
                                 for f in dataclasses.fields(adapter.cfg)})
    model = bridge.load_params(tklein.flux.FluxTransformer(cfg, dtype=torch.float32),
                               trees["dit"])
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), trees["dit"],
                                 [r"attn/(to_q|to_k|to_v|to_out)"], rank=4, alpha=4.0)
    rng = np.random.default_rng(33)
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, jl)
    b, gh, gw, s_txt = 1, 4, 4, 6
    f32 = np.float32
    batch = {"image_latents": rng.standard_normal((b, gh * gw, 16)).astype(f32),
             "control_latents": rng.standard_normal((b, gh * gw, 16)).astype(f32),
             "prompt_embeds": rng.standard_normal((b, s_txt, 144)).astype(f32),
             "guidance": np.full((b,), 2.5, f32),
             "img_ids": np.concatenate([jklein.latent_ids_4d(gh, gw, 0),
                                        jklein.latent_ids_4d(gh, gw, 1)]),
             "txt_ids": jklein.text_ids_4d(s_txt)}
    noise = rng.standard_normal(batch["image_latents"].shape).astype(f32)
    sigma = rng.uniform(0.05, 0.95, b).astype(f32)
    grads = assert_step_matches_jax(
        adapter, trees["dit"], jl, {k: jnp.asarray(v) for k, v in batch.items()},
        tklein.Flux2KleinAdapter(cfg, remat=False), model,
        {k: torch.from_numpy(v) for k, v in batch.items()}, noise, sigma)
    assert len(grads) == 2 * 4 + 2 * 3  # the single blocks have no to_out
    assert all(np.abs(g["a"]).max() > 0 for g in grads.values())


def test_predict_request_matches_jax(tmp_path, klein, monkeypatch):
    """Trainer.predict on a raw control PNG, two steps from the same numpy
    noise: the final latents within REL_TOL of JAX's Trainer.predict, the
    image within one uint8 level."""
    data, path = _paths(tmp_path)
    tr, jtr = _trainers(path, klein)
    same_noise(monkeypatch)
    seen = {}
    for name, cls in (("port", tklein.Flux2KleinAdapter), ("jax", jklein.Flux2KleinAdapter)):
        real = cls.decode_latents

        def record(self, bundle, packed, h, w, _real=real, _name=name):
            seen[_name] = _np(packed)
            return _real(self, bundle, packed, h, w)

        monkeypatch.setattr(cls, "decode_latents", record)
    ctl = png.read_png(data / "control_images" / "sample_000.png")
    got = tr.predict(ctl, "make it blue", num_inference_steps=2)
    want = jtr.predict(ctl, "make it blue", num_inference_steps=2)
    assert seen["port"].shape == seen["jax"].shape == (1, 64, 16)
    assert _rel_err(seen["port"], seen["jax"]) < REL_TOL
    assert_images_close(got, want)


@pytest.mark.parametrize("mode", ["--cache", "fit", "--predict"])
def test_example_config_runs_every_cli_mode(tmp_path, mode):
    """configs/example_flux2_klein.yaml at variant test through every CLI
    mode (`run_example_config`): `--cache` writes JAX's eight keys, a fit
    from that cache takes two finite steps, `--predict` writes a PNG of the
    control's size; like JAX's adapter this one has no mixed-size predict
    path."""
    cached, tr, out = run_example_config(tmp_path, "example_flux2_klein.yaml", mode)
    assert type(cached.adapter) is tklein.Flux2KleinAdapter
    keys = sorted(p.name for p in (tmp_path / "out" / "cache").iterdir() if p.name != "metadata")
    assert keys == sorted(["image_latents", "control_latents", "prompt_embeds",
                           "pooled_prompt_embeds", "empty_prompt_embeds",
                           "empty_pooled_prompt_embeds", "img_ids", "txt_ids"])
    if out is not None:
        assert png.read_png(out).shape == (32, 32, 3)
        with pytest.raises(NotImplementedError, match="no multi-res predict path"):
            tr.predict_multires([{"prompt": "p", "images": [png.read_png(out)]}])  # as JAX
