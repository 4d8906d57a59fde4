"""Qwen-Image-Edit-Plus in the port (qflux_tpu_torch/trainer/qwen_edit_plus.py)
against the JAX package on the CPU, at tiny width, on the tiny Qwen weights
of tests/test_torch_qwen_cache_pass.py (JAX's trees filled from numpy,
bridged into the port's modules).

Bounds: the template and the condition copies (cv2's INTER_AREA in JAX, the
port's numpy resampler) equal JAX's exactly; the prompt embeddings and a
pixel batch's embeddings within relative L2 2e-5 (the cache-pass tests'
bound), masks and image planes equal; a fit step's loss and a predict
request's final latents within the DiT goldens' relative error 2e-5 in
f32, the step's LoRA gradients within the train slice's 1e-4 per tensor
(tests/test_torch_train.py says why), the images within one uint8 level.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu import config as jconfig
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.trainer import base as jbase
from qflux_tpu.trainer import qwen_edit_plus as jqp
from qflux_tpu_torch.config import load_config_from_yaml
from qflux_tpu_torch.models.qwen import transformer as tqdit
from qflux_tpu_torch.trainer import qwen_edit_plus as tqp
from qflux_tpu_torch.trainer.base import Trainer
from tests.test_torch_cache_pass import run_example_config
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_qwen_cache_pass import (assert_embeddings_match, assert_images_close,
                                              bridge_qwen, make_qwen_weights, qwen_config,
                                              same_noise, write_qwen_folder)
from tests.test_torch_train import assert_step_matches_jax

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 2e-5
MSL = 64
TRAINER = "QwenImageEditPlusTrainer"


@pytest.fixture(scope="module")
def plus():
    """JAX's Plus adapter over the tiny Qwen set, its bundle and the numpy
    trees."""
    adapter, bundle, trees = make_qwen_weights()
    return (jqp.QwenImageEditPlusAdapter(adapter.cfg, remat=False, vae_scale=adapter.vae_scale),
            bundle, trees)


def _trainers(tmp_path, plus):
    path = qwen_config(tmp_path, write_qwen_folder(tmp_path, 1))
    raw = json.loads(path.read_text())
    raw["trainer"] = TRAINER
    path.write_text(json.dumps(raw))
    tr = Trainer(load_config_from_yaml(path), device="cpu")
    tr.load_model()
    bridge_qwen(tr.bundle, plus[2])
    jtr = jbase.Trainer(jconfig.load_config_from_yaml(path))
    jtr.adapter, jtr.bundle = plus[0], plus[1]
    return tr, jtr


def test_format_prompt_and_condition_images_match_jax():
    """"Picture i: …" for 1-3 images in the Plus template; the ≤ 384²
    condition copies (32-divisible sides) of 512², 1024×640, 100×70 and
    20×20 images equal JAX's cv2 INTER_AREA to the bit."""
    cfg = tqdit.QwenImageConfig.tiny()
    for n in (1, 2, 3):
        assert (tqp.QwenImageEditPlusAdapter(cfg).format_prompt("add a hat", n)
                == jqp.QwenImageEditPlusAdapter(cfg).format_prompt("add a hat", n))
    assert tqp.PLUS_TEMPLATE == jqp.PLUS_TEMPLATE and tqp.PLUS_DROP_IDX == jqp.PLUS_DROP_IDX
    rng = np.random.default_rng(70)
    for h, w in ((512, 512), (1024, 640), (100, 70), (20, 20)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, want = tqp.resize_condition_image(img), jqp.resize_condition_image(img)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tqp.resize_condition_image(np.zeros((512, 512, 3), np.uint8)).shape == (384, 384, 3)


def test_encode_prompt_with_two_controls_matches_jax(tmp_path, plus):
    """Two samples, two control images each (one of 512², which the
    condition copy shrinks to 384²): the embeddings within REL_TOL of
    JAX's, the masks equal, at a max_sequence_length past both samples and
    at one that cuts them."""
    tr, _ = _trainers(tmp_path, plus)
    rng = np.random.default_rng(71)
    images = [[rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
               rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)],
              [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
               rng.integers(0, 256, (32, 96, 3), dtype=np.uint8)]]
    prompts = ["put the hat from picture 2 on picture 1", "swap them"]
    for msl in (1024, 8):
        pe_j, pm_j = plus[0].encode_prompt(plus[1], prompts, images, msl)
        pe, pm = tr.adapter.encode_prompt(tr.bundle, prompts, images, msl)
        assert pe.shape == pe_j.shape and (msl == 8) == (pe.shape[1] == 8)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_j))
        assert _rel_err(pe.numpy(), pe_j) < REL_TOL


def test_prepare_and_cache_embeddings_match_jax(tmp_path, plus):
    """A pixel batch with a target and two controls: every embedding and
    RoPE table within REL_TOL of JAX's, the three image planes equal; the
    cache arrays of the sample (JAX's seven keys, its hash names)."""
    tr, _ = _trainers(tmp_path, plus)
    rng = np.random.default_rng(72)
    batch = {"image": rng.integers(0, 256, (1, 32, 48, 3), dtype=np.uint8),
             "control": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
             "control_1": rng.integers(0, 256, (1, 16, 32, 3), dtype=np.uint8),
             "prompt": ["combine the two pictures"]}
    want = plus[0].prepare_embeddings(plus[1], batch, MSL)
    got = tr.adapter.prepare_embeddings(tr.bundle, batch, MSL)
    assert_embeddings_match(got, want)
    np.testing.assert_array_equal(got["img_shapes_arr"], [(1, 8, 12), (1, 8, 8), (1, 4, 8)])
    item = dict(batch, file_hashes=[{"image_hash": "i", "prompt_hash": "p",
                                     "empty_prompt_hash": "e", "main_hash": "m",
                                     "controls_sum_hash": "c"}])
    (arr_t, keys_t), (arr_j, keys_j) = (tr.adapter.cache_embeddings(tr.bundle, item, MSL),
                                        plus[0].cache_embeddings(plus[1], item, MSL))
    assert keys_t == keys_j and sorted(arr_t) == sorted(arr_j) and len(arr_t) == 7
    for k in arr_j:
        assert arr_t[k].dtype == arr_j[k].dtype and arr_t[k].shape == arr_j[k].shape, k
    assert_embeddings_match(arr_t, arr_j)


def test_fit_step_matches_jax(tmp_path, plus):
    """One LoRA step on the embeddings of a pixel batch with two controls
    (S = text + 3 image planes) at injected noise and σ: the loss and
    grad_norm within REL_TOL of JAX's step, every LoRA gradient within
    1e-4 (`assert_step_matches_jax`; the last block's text-only LoRA gets
    none in either package, ROADMAP.md queue 3)."""
    tr, _ = _trainers(tmp_path, plus)
    rng = np.random.default_rng(73)
    batch = {"image": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
             "control": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
             "control_1": rng.integers(0, 256, (1, 16, 32, 3), dtype=np.uint8),
             "prompt": ["combine the two pictures"]}
    emb = {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
           for k, v in tr.adapter.prepare_embeddings(tr.bundle, batch, MSL).items()}
    adapter, trees = plus[0], plus[2]
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), trees["dit"],
                                 [r"attn/(to_q|to_k|to_v|to_out)"], rank=4, alpha=4.0)
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, jl)
    noise = rng.standard_normal(emb["image_latents"].shape).astype(np.float32)
    sigma = rng.uniform(0.05, 0.95, 1).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in adapter.prepare_cached_embeddings(
        {k: v for k, v in emb.items() if not k.startswith("rope_")}).items()}
    tbatch = {k: torch.as_tensor(v) for k, v in tr.adapter.prepare_cached_embeddings(emb).items()}
    assert_step_matches_jax(adapter, trees["dit"], jl, jbatch,
                            tqp.QwenImageEditPlusAdapter(tr.adapter.cfg, remat=False),
                            tr.bundle.dit_params, tbatch, noise, sigma)


def test_predict_request_matches_jax(tmp_path, plus, monkeypatch):
    """Trainer.predict on two raw control images, two steps from the same
    numpy noise: the final latents within REL_TOL of JAX's Trainer.predict,
    the image within one uint8 level."""
    tr, jtr = _trainers(tmp_path, plus)
    same_noise(monkeypatch)
    seen = {}
    for name, cls in (("port", tqp.QwenImageEditPlusAdapter),
                      ("jax", jqp.QwenImageEditPlusAdapter)):
        real = cls.decode_latents

        def record(self, bundle, packed, h, w, _real=real, _name=name):
            seen[_name] = np.asarray(packed.float() if torch.is_tensor(packed) else packed)
            return _real(self, bundle, packed, h, w)

        monkeypatch.setattr(cls, "decode_latents", record)
    rng = np.random.default_rng(74)
    controls = [rng.integers(0, 256, (40, 40, 3), dtype=np.uint8),
                rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)]
    got = tr.predict(controls, "put picture 2 into picture 1", num_inference_steps=2)
    want = jtr.predict(controls, "put picture 2 into picture 1", num_inference_steps=2)
    assert seen["port"].shape == seen["jax"].shape
    assert _rel_err(seen["port"], seen["jax"]) < REL_TOL
    assert_images_close(got, want)


@pytest.mark.parametrize("mode", ["--cache", "fit", "--predict"])
def test_example_config_runs_every_cli_mode(tmp_path, mode):
    """configs/example_qwen_image_edit_plus_multicontrol.yaml at variant
    test over its int8 weight-only base through every CLI mode
    (`run_example_config`; its fixed_pixels budget cut from 512·512 to
    32·32): `--cache` writes JAX's seven keys (the second sample three
    image planes), a fit from that cache takes two finite steps,
    `--predict` with two --control images writes a PNG."""
    cached, _, _ = run_example_config(
        tmp_path, "example_qwen_image_edit_plus_multicontrol.yaml", mode,
        processor={"target_pixels": "32*32"}, controls=2)
    assert type(cached.adapter) is tqp.QwenImageEditPlusAdapter
    assert cached.bundle.dit_params.blocks[0].attn.to_q.q_form == "int8"
    planes = sorted(np.load(p)["data"].shape[0]
                    for p in (tmp_path / "out" / "cache" / "img_shapes_arr").glob("*.npz"))
    assert planes == [2, 3]
