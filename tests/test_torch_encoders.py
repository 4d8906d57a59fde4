"""The FLUX.1-Kontext encoders in the port (qflux_tpu_torch/models/flux/vae.py's
encoder, models/flux/text_encoders.py, the CLIP / T5 converters of
models/porting.py, models/bridge.py's loaders) against the JAX package on
the CPU, on the same numpy inputs and weights, at tiny widths; and against
transformers' CLIPTextModel / T5EncoderModel on the state dicts of those
models, through both packages' converters; FLUX.2-Klein's Qwen3
(qflux_tpu_torch/models/flux2/text_encoder.py) against transformers'
Qwen3ForCausalLM too (its JAX parity is tests/test_torch_flux2_klein.py).

Bounds: relative L2 error < 2e-5 against JAX (the same f32 math, summed in
other orders), < 1e-5 against transformers (the bound
tests/models/test_text_encoder_parity.py holds JAX to); the converters'
leaves equal JAX's to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.models import porting as jporting
from qflux_tpu.models.flux import text_encoders as jte
from qflux_tpu.models.flux import vae as jvae
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models import porting as tporting
from qflux_tpu_torch.models.flux import text_encoders as tte
from qflux_tpu_torch.models.flux import vae as tvae
from qflux_tpu_torch.models.flux2 import text_encoder as tq3
from qflux_tpu_torch.utils.safetensors import SafeTensors, save_file
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

REL_TOL = 2e-5
HF_TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _leaves_equal(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        t = a[k].numpy() if torch.is_tensor(a[k]) else np.asarray(a[k])
        np.testing.assert_array_equal(t, np.asarray(b[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the VAE encoder

@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "query_chunked"])
def test_vae_encode_matches_jax(chunk, monkeypatch):
    """encode_moments and encode (JAX's shift / scale factors, at FLUX's
    0.1159 / 0.3611 in place of the tiny config's identity) at a 16×24
    image, the mid-block attention whole and query-chunked."""
    cfg = jvae.VAEConfig.tiny()
    jparams = _random_tree(lambda: jvae.init(jax.random.PRNGKey(0), cfg), 2)
    vae = bridge.load_vae_params(tvae.VAE(tvae.VAEConfig.tiny()), _np_tree(jparams))
    if chunk:
        monkeypatch.setattr(jvae, "ATTN_CHUNK", chunk)
        monkeypatch.setattr(tvae, "ATTN_CHUNK", chunk)
    img = np.random.default_rng(5).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    jm = jvae.encode_moments(jparams, cfg, jnp.asarray(img))
    with torch.no_grad():
        tm = tvae.encode_moments(vae, vae.cfg, torch.from_numpy(img))
    assert tm.shape == jm.shape == (2, 8, 12, 2 * cfg.latent_channels)
    assert _rel_err(tm.numpy(), jm) < REL_TOL
    scaled = jvae.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                            latent_channels=4, norm_num_groups=4)
    tscaled = tvae.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                             latent_channels=4, norm_num_groups=4)
    jz = jvae.encode(jparams, scaled, jnp.asarray(img))
    with torch.no_grad():
        tz = tvae.encode(vae, tscaled, torch.from_numpy(img))
    assert tz.shape == jz.shape == (2, 8, 12, 4)
    assert _rel_err(tz.numpy(), jz) < REL_TOL


def test_vae_encoder_from_diffusers_names(tmp_path):
    """A diffusers-named VAE state dict (the decoder and encoder keys that
    JAX's convert_flux_vae reads), written as safetensors and read back
    lazily: the port's conversion equals JAX's leaf for leaf, and the
    loaded encoder computes what JAX's does."""
    cfg = jvae.VAEConfig.tiny()
    jtree = _np_tree(_random_tree(lambda: jvae.init(jax.random.PRNGKey(0), cfg), 3))
    sd = _vae_state_dict(jtree)
    save_file({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
              tmp_path / "vae.safetensors")
    ours = tporting.convert_flux_vae(SafeTensors(tmp_path / "vae.safetensors"), num_blocks=2,
                                     layers_per_block=1)
    theirs = jporting.convert_flux_vae(sd, num_blocks=2, layers_per_block=1)
    _leaves_equal(ours, theirs)
    vae = bridge.load_vae_params(tvae.VAE(tvae.VAEConfig.tiny()), ours)
    img = np.random.default_rng(6).uniform(-1, 1, (1, 8, 8, 3)).astype(np.float32)
    with torch.no_grad():
        t = tvae.encode(vae, vae.cfg, torch.from_numpy(img))
    assert _rel_err(t.numpy(), jvae.encode(theirs, cfg, jnp.asarray(img))) < REL_TOL


def _vae_state_dict(tree):
    """The JAX VAE tree → diffusers AutoencoderKL names (HWIO → OIHW,
    [in, out] → [out, in]): the inverse of convert_flux_vae."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = np.ascontiguousarray(p["kernel"].transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = p["bias"]

    def gn(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]

    def resnet(name, p):
        gn(f"{name}.norm1", p["norm1"])
        conv(f"{name}.conv1", p["conv1"])
        gn(f"{name}.norm2", p["norm2"])
        conv(f"{name}.conv2", p["conv2"])
        if "conv_shortcut" in p:
            conv(f"{name}.conv_shortcut", p["conv_shortcut"])

    def mid(name, p):
        resnet(f"{name}.resnets.0", p["resnets_0"])
        resnet(f"{name}.resnets.1", p["resnets_1"])
        a = p["attentions_0"]
        gn(f"{name}.attentions.0.group_norm", a["group_norm"])
        for ours, theirs in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                             ("to_out", "to_out.0")):
            sd[f"{name}.attentions.0.{theirs}.weight"] = np.ascontiguousarray(a[ours]["kernel"].T)
            sd[f"{name}.attentions.0.{theirs}.bias"] = a[ours]["bias"]

    for half, blocks, sampler in (("encoder", "down", "downsamplers"),
                                  ("decoder", "up", "upsamplers")):
        t = tree[half]
        conv(f"{half}.conv_in", t["conv_in"])
        conv(f"{half}.conv_out", t["conv_out"])
        gn(f"{half}.conv_norm_out", t["norm_out"])
        mid(f"{half}.mid_block", t["mid"])
        for i in range(2):
            blk = t[f"{blocks}_{i}"]
            for j in range(3):
                if f"resnets_{j}" in blk:
                    resnet(f"{half}.{blocks}_blocks.{i}.resnets.{j}", blk[f"resnets_{j}"])
            key = "downsample" if half == "encoder" else "upsample"
            if key in blk:
                conv(f"{half}.{blocks}_blocks.{i}.{sampler}.0.conv", blk[key])
    return sd


# ---------------------------------------------------------------------------
# CLIP-L and T5, against JAX

def _ids(rng, b, s, vocab, eos=None):
    ids = rng.integers(1, vocab - 2, size=(b, s))
    if eos is not None:
        ids[0, -1] = eos
        ids[1, s // 2] = eos  # EOS inside the sequence: the pooler takes the first
        ids[1, -1] = eos
    return ids


def test_clip_encode_matches_jax():
    cfg = jte.CLIPTextConfig.tiny()
    jparams = _random_tree(lambda: jte.clip_init(jax.random.PRNGKey(0), cfg), 7)
    model = bridge.load_text_params(tte.CLIPText(tte.CLIPTextConfig.tiny()), _np_tree(jparams))
    ids = _ids(np.random.default_rng(0), 2, cfg.max_position_embeddings, cfg.vocab_size,
               cfg.eos_token_id)
    jh, jp = jte.clip_encode(jparams, cfg, jnp.asarray(ids))
    th, tp = tte.clip_encode(model, model.cfg, ids)
    assert th.shape == jh.shape and tp.shape == jp.shape == (2, cfg.hidden_size)
    assert _rel_err(th.numpy(), jh) < REL_TOL
    assert _rel_err(tp.numpy(), jp) < REL_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_t5_encode_matches_jax(masked):
    """t5_encode with and without an attention mask; the position bias
    (computed once a call) against JAX's, and the bucket map."""
    cfg = jte.T5Config.tiny()
    jparams = _random_tree(lambda: jte.t5_init(jax.random.PRNGKey(0), cfg), 8)
    model = bridge.load_text_params(tte.T5Encoder(tte.T5Config.tiny()), _np_tree(jparams))
    s = 150  # past max_distance 128: the log-spaced and the clamped buckets
    ids = _ids(np.random.default_rng(1), 2, s, cfg.vocab_size)
    mask = None
    if masked:
        mask = np.ones((2, s), np.int64)
        mask[1, 100:] = 0
    j = jte.t5_encode(jparams, cfg, jnp.asarray(ids),
                      attention_mask=None if mask is None else jnp.asarray(mask))
    t = tte.t5_encode(model, model.cfg, ids, attention_mask=mask)
    assert t.shape == j.shape == (2, s, cfg.d_model)
    assert _rel_err(t.numpy(), j) < REL_TOL
    rel = np.arange(-300, 300)
    np.testing.assert_array_equal(tte._relative_position_bucket(rel),
                                  jte._relative_position_bucket(rel))
    np.testing.assert_array_equal(tte.t5_position_bias(model, cfg, 40).numpy(),
                                  np.asarray(jte.t5_position_bias(jparams, cfg, 40)))


def test_init_distributions():
    """The port's random CLIP / T5 weights follow clip_init / t5_init."""
    clip = tte.clip_init(torch.Generator().manual_seed(0), tte.CLIPTextConfig.tiny())
    assert 0.015 < clip.token_embedding.std() < 0.025
    fc1 = clip.layers[0].mlp.fc1
    assert fc1.weight.abs().max() <= fc1.in_dim ** -0.5
    assert torch.equal(clip.final_layer_norm.scale, torch.ones(32))
    t5 = tte.t5_init(torch.Generator().manual_seed(0), tte.T5Config.tiny())
    assert 0.9 < t5.shared.std() < 1.1 and 0.07 < t5.relative_attention_bias.std() < 0.13
    wi = t5.layers[1].ff.wi_0
    assert wi.bias is None and abs(float(wi.weight.std()) * wi.in_dim ** 0.5 - 1) < 0.1


# ---------------------------------------------------------------------------
# against transformers, through both packages' converters

def _hf_clip():
    from transformers import CLIPTextConfig as HFCfg, CLIPTextModel

    torch.manual_seed(0)
    return CLIPTextModel(HFCfg(
        vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=16, eos_token_id=99, bos_token_id=98,
        hidden_act="quick_gelu")).eval()


def _hf_t5():
    from transformers import T5Config as HFT5Cfg, T5EncoderModel

    torch.manual_seed(0)
    return T5EncoderModel(HFT5Cfg(
        vocab_size=100, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        feed_forward_proj="gated-gelu", dense_act_fn="gelu_new")).eval()


@pytest.mark.parametrize("family", ["clip", "t5"])
def test_converters_match_jax_leaf_for_leaf(family, tmp_path):
    """convert_clip_text / convert_t5_encoder on a transformers state dict
    (read lazily from a safetensors file, as a checkpoint loads): every
    leaf equal to JAX's converter's, and the same unconsumed keys under
    convert_with_coverage."""
    hf = _hf_clip() if family == "clip" else _hf_t5()
    sd = {k: v.detach().contiguous() for k, v in hf.state_dict().items()}
    save_file(sd, tmp_path / "te.safetensors")
    np_sd = jporting.load_torch_state_dict(sd)
    ours_fn = tporting.convert_clip_text if family == "clip" else tporting.convert_t5_encoder
    theirs_fn = (jporting.convert_clip_text if family == "clip"
                 else jporting.convert_t5_encoder)
    ours, ours_left = tporting.convert_with_coverage(
        ours_fn, SafeTensors(tmp_path / "te.safetensors"), num_layers=2)
    theirs, theirs_left = jporting.convert_with_coverage(theirs_fn, np_sd, num_layers=2)
    _leaves_equal(ours, theirs)
    assert ours_left == theirs_left


def test_clip_matches_transformers():
    hf = _hf_clip()
    cfg = tte.CLIPTextConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
                             intermediate_size=64, max_position_embeddings=16, eos_token_id=99)
    tree = tporting.convert_clip_text(hf.state_dict(), num_layers=2)
    model = bridge.load_text_params(tte.CLIPText(cfg), tree)
    ids = np.random.default_rng(0).integers(0, 98, size=(2, 12))
    ids[:, -1] = 99
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids))
        hidden, pooled = tte.clip_encode(model, cfg, ids)
    assert _rel_err(hidden.numpy(), out.last_hidden_state.numpy()) < HF_TOL
    assert _rel_err(pooled.numpy(), out.pooler_output.numpy()) < HF_TOL


def test_t5_matches_transformers():
    hf = _hf_t5()
    cfg = tte.T5Config(vocab_size=100, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)
    tree = tporting.convert_t5_encoder(hf.state_dict(), num_layers=2)
    model = bridge.load_text_params(tte.T5Encoder(cfg), tree)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100, size=(2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, 15:] = 0
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask)).last_hidden_state
        mine = tte.t5_encode(model, cfg, ids, attention_mask=mask)
    assert _rel_err(mine.numpy(), out.numpy()) < HF_TOL


def test_bridge_refuses_a_tree_that_does_not_fit():
    cfg = jte.T5Config.tiny()
    jparams = _np_tree(_random_tree(lambda: jte.t5_init(jax.random.PRNGKey(0), cfg), 8))
    with pytest.raises(ValueError, match="tree"):
        bridge.load_text_params(tte.T5Encoder(tte.T5Config(vocab_size=1000, d_model=64, d_kv=8,
                                                           d_ff=128, num_layers=2,
                                                           num_heads=4)), jparams)
    del jparams["layers"][1]
    with pytest.raises((KeyError, IndexError)):
        bridge.load_text_params(tte.T5Encoder(tte.T5Config.tiny()), jparams)


def test_checkpoint_text_encoders_are_read_on_first_use(tmp_path):
    """A diffusers root with transformer/, text_encoder/ and text_encoder_2/:
    Trainer.load_model reads the DiT and leaves both text encoders unread
    (a fit from the cache never holds them); the first `text_encoders`
    call reads both, equal to their converters' output loaded by the
    bridge; a root without text_encoder_2/ raises there, naming it."""
    from transformers import CLIPTextConfig as HFCfg, CLIPTextModel
    from transformers import T5Config as HFT5Cfg, T5EncoderModel

    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.trainer.flux_kontext import text_encoders
    from tests.test_torch_files import _fixture

    ccfg, tcfg = tte.CLIPTextConfig.tiny(), tte.T5Config.tiny()
    torch.manual_seed(0)
    hf = {"clip": CLIPTextModel(HFCfg(
              vocab_size=ccfg.vocab_size, hidden_size=ccfg.hidden_size,
              intermediate_size=ccfg.intermediate_size, num_hidden_layers=ccfg.num_layers,
              num_attention_heads=ccfg.num_heads,
              max_position_embeddings=ccfg.max_position_embeddings,
              eos_token_id=ccfg.eos_token_id, bos_token_id=ccfg.eos_token_id - 1,
              hidden_act="quick_gelu")),
          "t5": T5EncoderModel(HFT5Cfg(
              vocab_size=tcfg.vocab_size, d_model=tcfg.d_model, d_kv=tcfg.d_kv,
              d_ff=tcfg.d_ff, num_layers=tcfg.num_layers, num_heads=tcfg.num_heads,
              feed_forward_proj="gated-gelu", dense_act_fn="gelu_new"))}
    sds = {k: {n: v.detach().contiguous() for n, v in m.state_dict().items()}
           for k, m in hf.items()}
    for sub, sd in (("transformer", {k: torch.from_numpy(np.ascontiguousarray(v))
                                     for k, v in _fixture("flux")[0].items()}),
                    ("text_encoder", sds["clip"]), ("text_encoder_2", sds["t5"])):
        (tmp_path / sub).mkdir()
        save_file(sd, tmp_path / sub / "model.safetensors")
    tr = Trainer(config_from_dict({"model": {"variant": "test",
                                             "pretrained_model_name_or_path": str(tmp_path)}}),
                 device="cpu")
    tr.load_model()
    assert tr.bundle.text_params == {}
    enc = text_encoders(tr.bundle)
    for name, module, conv, cfg in (("clip", tte.CLIPText, tporting.convert_clip_text, ccfg),
                                    ("t5", tte.T5Encoder, tporting.convert_t5_encoder, tcfg)):
        want = bridge.load_text_params(module(cfg), conv(sds[name], num_layers=cfg.num_layers))
        got = dict(enc[name].named_parameters())
        for n, p in want.named_parameters():
            assert torch.equal(got[n], p), (name, n)
    assert text_encoders(tr.bundle) is enc
    for f in (tmp_path / "text_encoder_2").iterdir():
        f.unlink()
    (tmp_path / "text_encoder_2").rmdir()
    tr = Trainer(config_from_dict({"model": {"variant": "test",
                                             "pretrained_model_name_or_path": str(tmp_path)}}),
                 device="cpu")
    tr.load_model()
    with pytest.raises(FileNotFoundError, match="t5"):
        text_encoders(tr.bundle)


def test_qwen3_matches_transformers():
    """transformers' Qwen3ForCausalLM (tiny, random, the config of
    tests/models/test_qwen3_parity.py) through the port's `convert_qwen3`:
    hidden_states (1, 2, 3) at the valid positions within HF_TOL
    (transformers lets padded positions attend to padded inputs)."""
    from transformers import Qwen3Config as HFConfig, Qwen3ForCausalLM

    torch.manual_seed(0)
    hf = Qwen3ForCausalLM(HFConfig(
        hidden_size=48, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=12, intermediate_size=96, vocab_size=512, rope_theta=1_000_000.0,
        rms_norm_eps=1e-6, max_position_embeddings=2048, tie_word_embeddings=False)).eval()
    tcfg = tq3.Qwen3Config.tiny()
    enc = bridge.load_text_params(tq3.Qwen3Encoder(tcfg),
                                  tq3.convert_qwen3(hf.state_dict(), tcfg.num_layers))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, size=(2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 7:] = 0
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                 output_hidden_states=True, use_cache=False)
    ref = torch.cat([out.hidden_states[k] for k in (1, 2, 3)], dim=-1).numpy()
    got = tq3.encode(enc, tcfg, ids, attention_mask=mask, hidden_states_layers=(1, 2, 3)).numpy()
    valid = mask.astype(bool)
    assert _rel_err(got[valid], ref[valid]) < HF_TOL
