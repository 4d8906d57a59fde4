"""The port's Qwen-Image-Edit encoders against the JAX package on the CPU:
PIL's resampler written in numpy (`utils/resample.py`), the Qwen2.5-VL
host helpers and modules (`models/qwen/vl_encoder.py`), their converters
(`models/qwen/porting.py`), the Qwen VAE encoder (`models/qwen/vae.py`) and
the perceptual hash (`utils/hashing.py:phash_image`).

Bounds: the resampler, `preprocess_image`, the host index helpers, the
converters and the hash equal their references exactly (PIL, JAX's numpy,
JAX's converters); the f32 modules (vision tower, LM, VAE encoder) within
relative L2 2e-5 of JAX's on the same bridged weights (the same f32
arithmetic, summed in other orders), and of transformers' Qwen2.5-VL on
the weights of its tiny random model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from qflux_tpu.models.qwen import porting as jporting
from qflux_tpu.models.qwen import vae as jqvae
from qflux_tpu.models.qwen import vl_encoder as jvl
from qflux_tpu.utils import hashing as jhashing
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import vae as tflux_vae
from qflux_tpu_torch.models.qwen import porting as tporting
from qflux_tpu_torch.models.qwen import vae as tqvae
from qflux_tpu_torch.models.qwen import vl_encoder as tvl
from qflux_tpu_torch.utils import hashing as thashing
from qflux_tpu_torch.utils import resample
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

REL_TOL = 2e-5
TOKENS = jvl.VLSpecialTokens(500, 502, 503)
TTOKENS = tvl.VLSpecialTokens(500, 502, 503)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def vl_trees(seed: int = 0):
    """JAX's tiny VL vision and text trees (stacked), filled from numpy."""
    vcfg, tcfg = jvl.VLVisionConfig.tiny(), jvl.VLTextConfig.tiny()
    key = jax.random.PRNGKey(0)
    return (_np(_random_tree(lambda: jvl.vision_init(key, vcfg), seed)),
            _np(_random_tree(lambda: jvl.text_init(key, tcfg), seed + 1)))


def qwen_vae_tree(cfg, seed: int):
    """JAX's Qwen VAE tree filled from numpy, the RMS gammas 1 + 0.1·N (not
    random_tree's bias-like 0.05·N)."""
    rng = np.random.default_rng(seed + 100)
    tree = _random_tree(lambda: jqvae.init(jax.random.PRNGKey(0), cfg), seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "gamma" else np.asarray(x, np.float32), tree)


# ---------------------------------------------------------------------------
# the resampler against PIL

RESIZE_CASES = [((37, 53), (60, 90)), ((60, 90), (37, 53)), ((576, 832), (588, 840)),
                ((100, 1), (7, 1)), ((1, 100), (1, 33)), ((64, 64), (8, 8)),
                ((513, 255), (32, 32)), ((40, 40), (40, 17)), ((17, 40), (90, 40)),
                ((3, 5), (200, 300))]


@pytest.mark.parametrize("method", ["bicubic", "lanczos"])
@pytest.mark.parametrize("src,dst", RESIZE_CASES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in RESIZE_CASES])
def test_resize_equals_pil(src, dst, method):
    """Up- and downscales, odd sizes, ratios past 2 (the support widens), an
    axis of one pixel and an axis left as it is: equal to PIL's
    `Image.resize` to the bit, RGB and L."""
    rng = np.random.default_rng(hash((src, dst)) % 2**32)
    pil = {"bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}[method]
    for shape in (src + (3,), src):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize(dst[::-1], pil))
        got = resample.resize(img, dst, method)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_luma_equals_pil():
    img = np.random.default_rng(1).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resample.to_luma(img),
                                  np.asarray(Image.fromarray(img).convert("L")))


# ---------------------------------------------------------------------------
# the host helpers against JAX's

@pytest.mark.parametrize("hw", [(61, 93), (56, 84), (576, 832), (30, 500), (1200, 1600)])
def test_preprocess_image_equals_jax(hw):
    """smart_resize, PIL's bicubic, the float64 normalisation and the patch
    order: the patches equal JAX's to the bit, the grid the same."""
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    vcfg = jvl.VLVisionConfig()
    want, wgrid = jvl.preprocess_image(img, vcfg)
    got, grid = tvl.preprocess_image(img, tvl.VLVisionConfig())
    assert grid == wgrid and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_host_index_helpers_equal_jax():
    """smart_resize over sizes at both pixel bounds; window_index and
    vision_rot_pos_ids over one and two images (the full config's window
    and the tiny one's); get_rope_index over a padded batch with images
    in either sample."""
    for h, w in [(56, 84), (20, 20), (4000, 3000), (576, 832), (832, 576), (3, 500)]:
        assert tvl.smart_resize(h, w) == jvl.smart_resize(h, w)
    for cfg_j, cfg_t in ((jvl.VLVisionConfig(), tvl.VLVisionConfig()),
                         (jvl.VLVisionConfig.tiny(), tvl.VLVisionConfig.tiny())):
        for grids in ([(1, 42, 60)], [(1, 4, 6), (1, 8, 2)], [(2, 6, 10)]):
            for a, b in zip(tvl.window_index(grids, cfg_t), jvl.window_index(grids, cfg_j)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tvl.vision_rot_pos_ids(grids, 2),
                                          jvl.vision_rot_pos_ids(grids, 2))
    n1, n2 = (4 // 2) * (6 // 2), (8 // 2) * (2 // 2)
    ids = np.zeros((2, 20), np.int64)
    row0 = [5, 502] + [500] * n1 + [503, 6, 7]
    row1 = [9, 502] + [500] * n2 + [503, 8]
    ids[0, :len(row0)], ids[1, :len(row1)] = row0, row1
    mask = (np.arange(20)[None] < np.array([[len(row0)], [len(row1)]])).astype(np.int64)
    grids = [(1, 4, 6), (1, 8, 2)]
    np.testing.assert_array_equal(tvl.get_rope_index(ids, grids, 2, TTOKENS, mask),
                                  jvl.get_rope_index(ids, grids, 2, TOKENS, mask))
    np.testing.assert_array_equal(tvl.get_rope_index(ids[:1], grids[:1], 2, TTOKENS),
                                  jvl.get_rope_index(ids[:1], grids[:1], 2, TOKENS))


def test_mrope_tables_match_jax():
    cfg = jvl.VLTextConfig()
    pos = np.random.default_rng(3).integers(0, 800, (3, 2, 40))
    for got, want in zip(tvl.mrope_cos_sin(pos, tvl.VLTextConfig()),
                         jvl.mrope_cos_sin(pos, cfg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# the modules against JAX's

def test_vision_tower_matches_jax():
    """Two images of different grids through the tiny tower (window and full
    attention blocks), on the same weights."""
    vtree, _ = vl_trees()
    tower = bridge.load_params(tvl.VisionTower(tvl.VLVisionConfig.tiny()), vtree)
    rng = np.random.default_rng(4)
    pre = [jvl.preprocess_image(rng.integers(0, 256, hw + (3,), dtype=np.uint8),
                                jvl.VLVisionConfig.tiny()) for hw in ((61, 93), (56, 140))]
    patches = np.concatenate([p for p, _ in pre])
    grids = [g for _, g in pre]
    want = jvl.vision_forward(vtree, jvl.VLVisionConfig.tiny(), jnp.asarray(patches), grids)
    got = tvl.vision_forward(tower, tvl.VLVisionConfig.tiny(), patches, grids)
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) < REL_TOL


def test_language_model_matches_jax():
    """A batch of two with padding (the causal mask ANDed with it) through
    the tiny LM: the real positions within REL_TOL of JAX's."""
    _, ttree = vl_trees()
    lm = bridge.load_params(tvl.TextModel(tvl.VLTextConfig.tiny()), ttree)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 480, (2, 24))
    mask = np.ones((2, 24), np.int64)
    mask[1, 17:] = 0
    pos = jvl.get_rope_index(ids, [], 2, TOKENS, attention_mask=mask)
    emb = ttree["embed_tokens"][ids]
    want = np.asarray(jvl.text_forward(ttree, jvl.VLTextConfig.tiny(), jnp.asarray(emb), pos,
                                       attention_mask=jnp.asarray(mask)))
    got = tvl.text_forward(lm, tvl.VLTextConfig.tiny(), torch.from_numpy(emb), pos,
                           attention_mask=mask).numpy()
    keep = mask.astype(bool)
    assert _rel_err(got[keep], want[keep]) < REL_TOL


@pytest.mark.parametrize("chunk", [None, 16])
def test_vae_encoder_matches_jax(chunk, monkeypatch):
    """The tiny Qwen VAE encoder (moments and normalized latents) at 40×56,
    its mid-block attention whole and query-chunked (chunk 16 over 35
    tokens halves to 1, the arithmetic per row unchanged)."""
    if chunk:
        from qflux_tpu.models.flux import vae as jflux_vae

        monkeypatch.setattr(jflux_vae, "ATTN_CHUNK", chunk)
        monkeypatch.setattr(tflux_vae, "ATTN_CHUNK", chunk)
    cfg = jqvae.QwenVAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
                              latents_mean=(0.1, -0.2, 0.3, 0.0), latents_std=(1.5, 0.5, 2, 1))
    tree = qwen_vae_tree(cfg, 6)
    tcfg = tqvae.QwenVAEConfig(**{f: getattr(cfg, f) for f in (
        "base_dim", "z_dim", "dim_mult", "num_res_blocks", "latents_mean", "latents_std")})
    vae = bridge.load_vae_params(tqvae.QwenVAE(tcfg), tree)
    x = np.random.default_rng(7).uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
    want_m = np.asarray(jqvae.encode_moments(tree, cfg, jnp.asarray(x)))
    got_m = tqvae.encode_moments(vae, tcfg, torch.from_numpy(x)).numpy()
    assert got_m.shape == want_m.shape == (2, 10, 14, 8)
    assert _rel_err(got_m, want_m) < REL_TOL
    want = np.asarray(jqvae.encode(tree, cfg, jnp.asarray(x)))
    assert _rel_err(tqvae.encode(vae, tcfg, torch.from_numpy(x)).numpy(), want) < REL_TOL


def _hf_vl_state_dict(rng, new_layout: bool) -> dict:
    """A random Qwen2.5-VL state dict at the tiny widths, in either
    transformers layout (model.visual. / model.language_model., or visual. /
    model.), with an lm_head."""
    v, t = jvl.VLVisionConfig.tiny(), jvl.VLTextConfig.tiny()
    vp, tp = ("model.visual.", "model.language_model.") if new_layout else ("visual.", "model.")
    sd = {}

    def lin(name, cin, cout, bias=True):
        sd[f"{name}.weight"] = rng.standard_normal((cout, cin)).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.standard_normal(cout).astype(np.float32)

    def norm(name, c):
        sd[f"{name}.weight"] = rng.standard_normal(c).astype(np.float32)

    d, dm = v.hidden_size, v.hidden_size * 4
    sd[f"{vp}patch_embed.proj.weight"] = rng.standard_normal((d, 3, 2, 14, 14)).astype(np.float32)
    norm(f"{vp}merger.ln_q", d)
    lin(f"{vp}merger.mlp.0", dm, dm)
    lin(f"{vp}merger.mlp.2", dm, v.out_hidden_size)
    for i in range(v.depth):
        b = f"{vp}blocks.{i}"
        norm(f"{b}.norm1", d), norm(f"{b}.norm2", d)
        lin(f"{b}.attn.qkv", d, 3 * d), lin(f"{b}.attn.proj", d, d)
        for n, ci, co in (("gate_proj", d, v.intermediate_size), ("up_proj", d, v.intermediate_size),
                          ("down_proj", v.intermediate_size, d)):
            lin(f"{b}.mlp.{n}", ci, co)
    h, kv = t.hidden_size, t.num_kv_heads * t.head_dim
    sd[f"{tp}embed_tokens.weight"] = rng.standard_normal((t.vocab_size, h)).astype(np.float32)
    norm(f"{tp}norm", h)
    for i in range(t.num_layers):
        b = f"{tp}layers.{i}"
        norm(f"{b}.input_layernorm", h), norm(f"{b}.post_attention_layernorm", h)
        lin(f"{b}.self_attn.q_proj", h, h), lin(f"{b}.self_attn.k_proj", h, kv)
        lin(f"{b}.self_attn.v_proj", h, kv), lin(f"{b}.self_attn.o_proj", h, h, bias=False)
        for n, ci, co in (("gate_proj", h, t.intermediate_size), ("up_proj", h, t.intermediate_size),
                          ("down_proj", t.intermediate_size, h)):
            lin(f"{b}.mlp.{n}", ci, co, bias=False)
    sd["lm_head.weight"] = rng.standard_normal((t.vocab_size, h)).astype(np.float32)
    return sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.numpy() if torch.is_tensor(v) else v)
    return out


@pytest.mark.parametrize("new_layout", [True, False], ids=["model.visual", "visual"])
def test_vl_converters_equal_jax(new_layout, caplog):
    """convert_vl_vision / convert_vl_text leaf for leaf equal to JAX's for
    both prefix forms; `load_from_state_dict`, one block and layer at a
    time, loads the same numbers and reports the one tensor no converter
    reads (lm_head.weight)."""
    sd = _hf_vl_state_dict(np.random.default_rng(8), new_layout)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for conv_t, conv_j, n in ((tporting.convert_vl_vision, jporting.convert_vl_vision, 2),
                              (tporting.convert_vl_text, jporting.convert_vl_text, 2)):
        got, want = _flat(conv_t(tsd, n)), _flat(conv_j(sd, n))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with caplog.at_level("WARNING"):
        vision, text = tvl.load_from_state_dict(tsd, tvl.VLVisionConfig.tiny(),
                                                tvl.VLTextConfig.tiny())
    assert "1/" in caplog.text and "lm_head.weight" in caplog.text
    want_v = bridge.load_params(tvl.VisionTower(tvl.VLVisionConfig.tiny()),
                                jporting.convert_vl_vision(sd, 2))
    want_t = bridge.load_params(tvl.TextModel(tvl.VLTextConfig.tiny()),
                                jporting.convert_vl_text(sd, 2))
    for got_m, want_m in ((vision, want_v), (text, want_t)):
        for (name, a), (_, b) in zip(got_m.state_dict().items(), want_m.state_dict().items()):
            assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def hf_vl():
    """transformers' tiny random Qwen2.5-VL, as
    tests/models/test_qwen_vl_parity.py builds it."""
    from transformers import Qwen2_5_VLConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VLForConditionalGeneration)

    torch.manual_seed(0)
    cfg = Qwen2_5_VLConfig(
        text_config=dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, intermediate_size=96, vocab_size=512,
                         rope_theta=1_000_000.0, max_position_embeddings=4096,
                         rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
                         rms_norm_eps=1e-6),
        vision_config=dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
                           patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
                           window_size=28, fullatt_block_indexes=[1], out_hidden_size=48,
                           in_channels=3),
        image_token_id=500, video_token_id=501, vision_start_token_id=502,
        vision_end_token_id=503, vocab_size=512)
    return Qwen2_5_VLForConditionalGeneration(cfg).eval()


def test_vl_matches_transformers(hf_vl):
    """The port's VL read from transformers' state dict
    (`load_from_state_dict`): the vision tower's features and the LM's
    hidden_states[-1] over a prompt with an embedded image within REL_TOL
    of transformers'."""
    vision, text = tvl.load_from_state_dict(hf_vl.state_dict(), tvl.VLVisionConfig.tiny(),
                                            tvl.VLTextConfig.tiny())
    vcfg, tcfg = tvl.VLVisionConfig.tiny(), tvl.VLTextConfig.tiny()
    img = np.random.default_rng(9).integers(0, 256, (56, 84, 3), dtype=np.uint8)
    patches, grid = tvl.preprocess_image(img, vcfg)
    n_img = (grid[1] // 2) * (grid[2] // 2)
    ids = np.asarray([[7, 8, 9, 502] + [500] * n_img + [503, 10, 11, 12]])
    with torch.no_grad():
        ref_vis = hf_vl.model.visual(torch.from_numpy(patches), grid_thw=torch.tensor([grid]))
        out = hf_vl(input_ids=torch.from_numpy(ids), attention_mask=torch.ones_like(
            torch.from_numpy(ids)), pixel_values=torch.from_numpy(patches),
            image_grid_thw=torch.tensor([grid]), output_hidden_states=True)
        vis = tvl.vision_forward(vision, vcfg, patches, [grid])
        embeds = text.embed_tokens[torch.from_numpy(ids)].clone()
        embeds[torch.from_numpy(ids == 500)] = vis
        pos = tvl.get_rope_index(ids, [grid], 2, TTOKENS)
        hidden = tvl.text_forward(text, tcfg, embeds, pos)
    assert _rel_err(vis.numpy(), ref_vis.numpy()) < REL_TOL
    assert _rel_err(hidden.numpy(), out.hidden_states[-1].numpy()) < REL_TOL


# ---------------------------------------------------------------------------
# the perceptual hash

@pytest.mark.parametrize("shape", [(64, 64, 3), (97, 41, 3), (200, 300), (32, 32, 3), (8, 640, 4)])
def test_phash_equals_jax(shape):
    """RGB, RGBA and L images, shrunk past the Lanczos support and grown:
    the same hex string as JAX's (PIL) phash_image."""
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img = (img // 2 + np.linspace(0, 120, shape[1], dtype=np.uint8)[None, :, None]
           if img.ndim == 3 else img)
    assert thashing.phash_image(img) == jhashing.phash_image(img)
    assert thashing.phash_image(img, hash_size=4, highfreq_factor=2) == jhashing.phash_image(
        img, hash_size=4, highfreq_factor=2)
