"""The Qwen-Image-Edit cache pass and raw-image entry points of the port
(qflux_tpu_torch/trainer/qwen_edit.py's encoding half, trainer/base.py's
`cache`, pixel batches, `predict`, `predict_multires` and validation,
main.py's --cache / --fit-no-cache / --predict) against the JAX package on
the CPU, on one tiny folder of PNGs and the same weights (JAX's tiny trees
filled from numpy, bridged into the port's modules); `predict_multires` for
FLUX.1-Kontext too.

Bounds: the embeddings of a pixel batch within relative L2 2e-5 of JAX's
(the same f32 encoders summed in other orders), masks, image planes and
segment ids equal; the two caches hold the same files under the same
content-hash names with the same metadata, their fp16 arrays within
relative L2 1e-3 (one fp16 rounding of values 2e-5 apart can land one fp16
ulp, 2^-11 relative, apart), masks and planes equal; images sampled from
the same numpy noise within one uint8 level of JAX's (the same f32 Euler
loop; a value near a rounding boundary can round either way).  Also: the
CLI's Qwen modes run with jax, qflux_tpu, PIL, cv2 and transformers made
unimportable.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu import config as jconfig
from qflux_tpu.data import dataset as jdataset
from qflux_tpu.data import loader as jloader
from qflux_tpu.models.qwen import transformer as jqdit
from qflux_tpu.models.qwen import vae as jqvae
from qflux_tpu.models.qwen import vl_encoder as jvl
from qflux_tpu.trainer import base as jbase
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu.trainer import qwen_edit as jqe
from qflux_tpu_torch import main as cli
from qflux_tpu_torch.config import load_config_from_yaml
from qflux_tpu_torch.data import dataset as tdataset
from qflux_tpu_torch.data import loader as tloader
from qflux_tpu_torch.data.preprocess import ImageProcessor
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.trainer import qwen_edit as tqe
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.utils import png
from qflux_tpu_torch.utils.logger import NullLogger
from tests.test_torch_cache_pass import _config as _flux_config
from tests.test_torch_cache_pass import _jax_trainer as _flux_jax_trainer
from tests.test_torch_cache_pass import _port_trainer as _flux_port_trainer
from tests.test_torch_cache_pass import _write_folder as _flux_folder
from tests.test_torch_cache_pass import weights  # noqa: F401  (a fixture)
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_qwen_encoders import qwen_vae_tree, vl_trees

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 2e-5
CACHE_TOL = 1e-3
MSL = 64  # predict.max_sequence_length: past every tiny prompt


def write_qwen_folder(root: Path, n: int = 3) -> Path:
    """n samples: a 40×56 target and a 48×48 control PNG each, and a prompt;
    resampled to 32×32 by `qwen_config`'s processor."""
    rng = np.random.default_rng(10)
    data = root / "data"
    for d in ("training_images", "control_images"):
        (data / d).mkdir(parents=True)
    for i in range(n):
        stem = f"sample_{i:03d}"
        (data / "training_images" / f"{stem}.png").write_bytes(
            png.encode_png(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)))
        (data / "control_images" / f"{stem}.png").write_bytes(
            png.encode_png(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)))
        (data / "training_images" / f"{stem}.txt").write_text(f"put edit {i} on it " * (i + 1))
    return data


def qwen_config(root: Path, data_dir: Path, **over) -> Path:
    """A tiny Qwen-Image-Edit config (variant test, f32) over `data_dir`;
    `over` updates its sections."""
    path = _flux_config(root, data_dir, trainer="QwenImageEditTrainer")
    raw = json.loads(path.read_text())
    raw["predict"]["max_sequence_length"] = MSL
    for section, values in over.items():
        raw.setdefault(section, {}).update(values)
    path.write_text(json.dumps(raw))
    return path



_WEIGHTS: dict = {}


def make_qwen_weights():
    """JAX's tiny Qwen-Image-Edit model set (DiT, VAE, VL vision and text)
    filled from numpy, as a JAX adapter + bundle, and the numpy trees; made
    once a process (other test files call it too)."""
    if not _WEIGHTS:
        _WEIGHTS["w"] = _make_qwen_weights()
    return _WEIGHTS["w"]


@pytest.fixture(scope="module")
def qwen_weights():
    return make_qwen_weights()


def _make_qwen_weights():
    dit_cfg = dataclasses.replace(jqdit.QwenImageConfig.tiny(), joint_attention_dim=48,
                                  in_channels=16, out_channels=4)
    vae_cfg = jqvae.QwenVAEConfig.tiny()
    key = jax.random.PRNGKey(0)
    vision, text = vl_trees(11)
    trees = {"dit": jax.tree.map(lambda x: np.asarray(x, np.float32), _random_tree(
                 lambda: jqdit.init(key, dit_cfg, jnp.float32), 12)),
             "vae": qwen_vae_tree(vae_cfg, 13), "vision": vision, "text": text}
    bundle = jfk.ModelBundle(
        dit_cfg=dit_cfg, dit_params=trees["dit"], vae_cfg=vae_cfg, vae_params=trees["vae"],
        text_cfgs={"vision": jvl.VLVisionConfig.tiny(), "text": jvl.VLTextConfig.tiny(),
                   "tokens": jvl.VLSpecialTokens(500, 502, 503)},
        text_params={"vision": vision, "text": text},
        tokenizers={"vl": jfk.SimpleTokenizer(480, 512)})
    adapter = jqe.QwenImageEditAdapter(dit_cfg, remat=False, vae_scale=vae_cfg.downscale)
    return adapter, bundle, trees


def bridge_qwen(bundle, trees) -> None:
    """The numpy trees into a port bundle (the VL built first, on first use)."""
    bridge.load_params(bundle.dit_params, trees["dit"])
    bridge.load_vae_params(bundle.vae_params, trees["vae"])
    enc = tqe.vl_encoder(bundle)
    bridge.load_params(enc["vision"], trees["vision"])
    bridge.load_params(enc["text"], trees["text"])


def qwen_port_trainer(path, trees) -> Trainer:
    tr = Trainer(load_config_from_yaml(path), device="cpu")
    tr.load_model()
    bridge_qwen(tr.bundle, trees)
    return tr


def qwen_jax_trainer(path, weights) -> jbase.Trainer:
    tr = jbase.Trainer(jconfig.load_config_from_yaml(path))
    tr.adapter, tr.bundle = weights[0], weights[1]
    return tr


def patch_qwen_load(monkeypatch, trees) -> None:
    """Trainer.load_model bridges the JAX weights in (for the CLI)."""
    real_load = Trainer.load_model

    def load_model(self):
        real_load(self)
        bridge_qwen(self.bundle, trees)

    monkeypatch.setattr(Trainer, "load_model", load_model)


def same_noise(monkeypatch) -> dict:
    """Both packages draw their initial latents from one numpy stream (JAX's
    `jax.random.normal` and the port's `Trainer._initial_latents`
    replaced): returns the record of the shapes drawn."""
    drawn = {"shapes": []}

    def draw(shape):
        drawn["shapes"].append(tuple(shape))
        return np.random.default_rng(0).standard_normal(shape).astype(np.float32)

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(draw(shape), dtype))
    monkeypatch.setattr(Trainer, "_initial_latents",
                        lambda self, shape, seed: torch.from_numpy(draw(shape)).to(self.dtype))
    return drawn


def assert_images_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def assert_embeddings_match(got: dict, want: dict, exact=("img_shapes_arr",)):
    """Every key of JAX's embeddings: floats within REL_TOL, masks and
    integer arrays equal."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        if k in exact or k.endswith("mask") or w.dtype.kind in "iu":
            np.testing.assert_array_equal(np.asarray(g.numpy() if torch.is_tensor(g) else g),
                                          w, err_msg=k)
        else:
            assert np.shape(g) == w.shape, k
            assert _rel_err(_np(g), w) < REL_TOL, k


def run_qwen_cli_mode(tmp_path: Path, monkeypatch, flag: str, weights) -> None:
    """`flag` (--cache, --fit-no-cache or --predict) through the port's CLI
    on a one-sample Qwen folder, the JAX weights bridged in, held to JAX's:
    the cache file for file (`assert_caches_equal`); the fit's pixel batch
    encoded as JAX encodes it, two finite steps; the edited PNG within one
    uint8 level of JAX's `Trainer.predict` from the same noise."""
    data = write_qwen_folder(tmp_path, 1)
    path = qwen_config(tmp_path, data)
    patch_qwen_load(monkeypatch, weights[2])
    jtr = qwen_jax_trainer(path, weights)
    if flag == "--cache":
        tr = cli.main(["--config", str(path), "--device", "cpu", "--cache"])
        assert tr.last_cache["samples"] == 1
        (tmp_path / "j").mkdir()
        jtr = qwen_jax_trainer(qwen_config(tmp_path / "j", data, cache={
            "use_cache": True, "cache_dir": str(tmp_path / "jax_cache")}), weights)
        ds = jdataset.ImageDataset(str(data), processor=jdataset.ImageProcessor(
            jtr.config.data.processor))
        assert jtr.cache(jloader.DataLoader(ds, batch_size=1, shuffle=False, drop_last=False,
                                            bucket_by_shape=False)) == 1
        assert_caches_equal(tmp_path / "cache", tmp_path / "jax_cache")
    elif flag == "--fit-no-cache":
        seen = []
        real = Trainer._embeddings_for_batch

        def record(self, batch):
            seen.append((batch, real(self, batch)))
            return seen[-1][1]

        monkeypatch.setattr(Trainer, "_embeddings_for_batch", record)
        tr = cli.main(["--config", str(path), "--device", "cpu", "--fit-no-cache"])
        assert tr.global_step == 2 and np.isfinite([h["loss"] for h in tr.history]).all()
        batch, emb = seen[0]
        assert "image_latents" not in batch
        assert_embeddings_match(emb, jtr._embeddings_for_batch(batch))
    else:
        same_noise(monkeypatch)
        ctl = data / "control_images" / "sample_000.png"
        out = tmp_path / "edit.png"
        tr = cli.main(["--config", str(path), "--device", "cpu", "--predict", "--control",
                       str(ctl), "--prompt", "make it blue", "--output", str(out),
                       "--steps", "2"])
        assert tr.last_outputs == [str(out)] and tr.last_predict["latents_finite"]
        want = jtr.predict(png.read_png(ctl), "make it blue", num_inference_steps=2)
        assert_images_close(png.read_png(out), want[0])


def hold_validation_to_jax(tr: Trainer, path: Path, weights, monkeypatch) -> None:
    """Every validation embedding the port's fit set up equals JAX's
    adapter on the same resampled pixels, and its image sampled again
    (`run_validation`) is within one uint8 level of JAX's
    `predict_from_embeddings` from the same noise."""
    jad, jb = weights[0], weights[1]
    proc = ImageProcessor(tr.config.data.processor)
    msl = tr.config.predict.max_sequence_length
    vcfg = tr.config.validation
    jtr = qwen_jax_trainer(path, weights)
    same_noise(monkeypatch)
    tr.logger = NullLogger()  # fit closed its events file
    images = dict(tr.run_validation())
    for s, rec in zip(tr._load_validation_samples(), tr._validation_embeddings):
        batch = {"image": np.zeros((1, rec["height"], rec["width"], 3), np.uint8),
                 "prompt": [s["prompt"]]}
        for i, im in enumerate(s["images"]):
            batch["control" if i == 0 else f"control_{i}"] = proc.process_image(
                np.asarray(im), f"control_{i}")[None]
        want = jad.prepare_embeddings(jb, batch, msl)
        want.pop("image_latents")
        assert_embeddings_match(rec["emb"], want)
        img = jtr.predict_from_embeddings(want, rec["height"], rec["width"],
                                          num_inference_steps=vcfg.num_inference_steps,
                                          guidance=vcfg.guidance,
                                          true_cfg_scale=vcfg.true_cfg_scale)
        assert_images_close(images[rec["index"]], img)


# ---------------------------------------------------------------------------
# encoding

def test_encode_prompt_matches_jax(tmp_path, qwen_weights):
    """A bs=2 batch whose controls differ in size (so the samples' token
    counts differ and the shorter is padded), at a max_sequence_length past
    both and at one that cuts them."""
    data = write_qwen_folder(tmp_path, 1)
    tr = qwen_port_trainer(qwen_config(tmp_path, data), qwen_weights[2])
    rng = np.random.default_rng(14)
    images = [[rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)],
              [rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)]]
    prompts = ["turn the sky red", "add a small boat near the shore please"]
    lengths = []
    for msl in (MSL, 6):
        pe_j, pm_j = qwen_weights[0].encode_prompt(qwen_weights[1], prompts, images, msl)
        pe, pm = tr.adapter.encode_prompt(tr.bundle, prompts, images, msl)
        assert pe.shape == pe_j.shape and pe.dtype == torch.float32
        assert pm.dtype == torch.int32 and np.asarray(pm_j).dtype == np.int32
        np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_j))
        assert _rel_err(pe.numpy(), pe_j) < REL_TOL
        lengths.append((pe.shape[1], pm.numpy().sum(1).tolist()))
    (long, counts), (short, _) = lengths
    assert short == 6 < long == max(counts) and counts[0] < counts[1]


def test_prepare_embeddings_matches_jax(tmp_path, qwen_weights):
    """A bs=2 pixel batch (a 32×48 target, a 32×32 control, an edit mask):
    every embedding and the RoPE tables within REL_TOL of JAX's, masks and
    image planes equal; the negative prompt's embeddings; one sample's
    `cache_embeddings` (its seven f32 / int arrays before the cache's fp16
    cast, and the hash name of each); the Trainer's pixel branch zeroing
    the control latents of a drop_context sample as JAX's does."""
    data = write_qwen_folder(tmp_path, 1)
    path = qwen_config(tmp_path, data)
    tr = qwen_port_trainer(path, qwen_weights[2])
    rng = np.random.default_rng(15)
    batch = {"image": rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8),
             "control": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             "prompt": ["turn the sky red", ""], "drop_context": np.array([False, True]),
             "edit_mask": rng.uniform(0, 1, (2, 96)).astype(np.float32)}
    adapter, bundle = qwen_weights[0], qwen_weights[1]
    want = adapter.prepare_embeddings(bundle, batch, MSL)
    got = tr.adapter.prepare_embeddings(tr.bundle, batch, MSL)
    assert_embeddings_match(got, want)
    np.testing.assert_array_equal(got["img_shapes_arr"], [(1, 8, 12), (1, 8, 8)])
    neg_t = tr.adapter.negative_embeddings(tr.bundle, "blurry", batch, MSL)
    assert_embeddings_match(neg_t, adapter.negative_embeddings(bundle, "blurry", batch, MSL))
    item = {"image": batch["image"][:1], "control": batch["control"][:1],
            "prompt": ["turn the sky red"],
            "file_hashes": [{"image_hash": "i", "prompt_hash": "p", "empty_prompt_hash": "e",
                             "main_hash": "m", "controls_sum_hash": "c"}]}
    (arr_t, keys_t), (arr_j, keys_j) = (tr.adapter.cache_embeddings(tr.bundle, item, MSL),
                                        adapter.cache_embeddings(bundle, item, MSL))
    assert keys_t == keys_j
    for k in arr_j:
        assert arr_t[k].dtype == arr_j[k].dtype and arr_t[k].shape == arr_j[k].shape, k
    assert_embeddings_match(arr_t, arr_j)
    emb_t = tr._embeddings_for_batch(batch)
    emb_j = qwen_jax_trainer(path, qwen_weights)._embeddings_for_batch(batch)
    assert not _np(emb_t["control_latents"])[1].any()
    assert _rel_err(_np(emb_t["control_latents"]), emb_j["control_latents"]) < REL_TOL


def _listing(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def qwen_caches(tmp_path_factory, qwen_weights):
    """The tiny folder cached by each package's Trainer.cache."""
    root = tmp_path_factory.mktemp("qwen_caches")
    data = write_qwen_folder(root)
    out = {"data": data}
    for name in ("port", "jax"):
        d = root / name
        d.mkdir()
        path = qwen_config(d, data)
        if name == "port":
            tr = qwen_port_trainer(path, qwen_weights[2])
            ds = tdataset.ImageDataset(str(data), processor=ImageProcessor(target_size=[32, 32]))
            n = tr.cache(tloader.DataLoader(ds, batch_size=1, shuffle=False, drop_last=False,
                                            bucket_by_shape=False))
        else:
            jcfg = jconfig.load_config_from_yaml(path)
            ds = jdataset.ImageDataset(str(data), processor=jdataset.ImageProcessor(
                jcfg.data.processor))
            n = qwen_jax_trainer(path, qwen_weights).cache(jloader.DataLoader(
                ds, batch_size=1, shuffle=False, drop_last=False, bucket_by_shape=False))
        assert n == 3
        out[name] = d / "cache"
    return out


def assert_caches_equal(ours: Path, theirs: Path) -> dict:
    """The same files, metadata equal, fp16 arrays within CACHE_TOL, the
    integer arrays equal; returns {key: shape}."""
    ours, theirs = _listing(ours), _listing(theirs)
    assert sorted(ours) == sorted(theirs)
    shapes = {}
    for rel, path in ours.items():
        if rel.startswith("metadata"):
            assert json.loads(path.read_text()) == json.loads(theirs[rel].read_text())
            continue
        a, b = np.load(path)["data"], np.load(theirs[rel])["data"]
        assert a.dtype == b.dtype and a.shape == b.shape, rel
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=rel)
        else:
            assert a.dtype == np.float16 and _rel_err(a, b) < CACHE_TOL, rel
        shapes.setdefault(rel.split("/")[0], a.shape)
    return shapes


def test_cache_matches_jax(qwen_caches):
    """JAX's seven keys under the same hash names, at JAX's shapes: latents
    [64, 16] (a 32² image in 2×2-packed tokens of the tiny VAE), the prompt
    and empty-prompt embeds [L, 48] with int32 masks, img_shapes_arr [2, 3]."""
    shapes = assert_caches_equal(qwen_caches["port"], qwen_caches["jax"])
    assert set(shapes) == {"image_latents", "control_latents", "prompt_embeds",
                           "prompt_embeds_mask", "empty_prompt_embeds",
                           "empty_prompt_embeds_mask", "img_shapes_arr"}
    assert shapes["image_latents"] == shapes["control_latents"] == (64, 16)
    assert shapes["img_shapes_arr"] == (2, 3) and shapes["prompt_embeds"][1] == 48


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_trains_from_the_others_cache(qwen_caches, qwen_weights, reader, tmp_path):
    """The port's fit from the JAX package's Qwen cache, and JAX's fit from
    the port's, two steps each, every batch served from the cache, finite
    losses; the port's losses from either cache within 1e-3 of each other."""
    writer = "jax" if reader == "port" else "port"
    over = {"cache": {"use_cache": True, "cache_dir": str(qwen_caches[writer])},
            "logging": {"output_dir": str(tmp_path / "out"), "project": "p"}}
    path = qwen_config(tmp_path, qwen_caches["data"], **over)
    if reader == "jax":
        jtr = qwen_jax_trainer(path, qwen_weights)
        ds = jdataset.ImageDataset(str(qwen_caches["data"]), cache_dir=str(qwen_caches[writer]),
                                   use_cache=True, processor=jdataset.ImageProcessor(
                                       jtr.config.data.processor))
        assert all(ds[i]["cached"] for i in range(len(ds)))
        assert int(jtr.fit(jloader.DataLoader(ds, batch_size=1, shuffle=False)).step) == 2
        return
    losses = {}
    for src in ("jax", "port"):
        over["cache"]["cache_dir"] = str(qwen_caches[src])
        tr = qwen_port_trainer(qwen_config(tmp_path, qwen_caches["data"], **over),
                               qwen_weights[2])
        ds = tdataset.ImageDataset(str(qwen_caches["data"]), cache_dir=str(qwen_caches[src]),
                                   use_cache=True)
        assert all(ds[i]["cached"] for i in range(len(ds)))
        tr.fit(tloader.DataLoader(ds, batch_size=1, shuffle=False))
        losses[src] = [h["loss"] for h in tr.history]
        assert len(losses[src]) == 2 and np.isfinite(losses[src]).all()
    np.testing.assert_allclose(losses["jax"], losses["port"], rtol=1e-3)


# ---------------------------------------------------------------------------
# mixed-size predict, both families



def _family(request, tmp_path, family):
    """(port trainer, JAX trainer) of `family` on the same weights (the
    processor resamples every control to 32²)."""
    if family == "qwen":
        w = request.getfixturevalue("qwen_weights")
        path = qwen_config(tmp_path, write_qwen_folder(tmp_path, 1))
        return qwen_port_trainer(path, w[2]), qwen_jax_trainer(path, w)
    w = request.getfixturevalue("weights")
    path = _flux_config(tmp_path, _flux_folder(tmp_path, 1))
    return _flux_port_trainer(path, w[2]), _flux_jax_trainer(path, w)


@pytest.mark.parametrize("family", ["qwen", "flux"])
def test_prepare_multires_embeddings_matches_jax(request, tmp_path, family):
    """Two items of different sizes: the padded embeddings, RoPE tables
    (Qwen) or per-sample ids (FLUX), segment ids, token mask and sample
    grids as JAX's."""
    tr, jtr = _family(request, tmp_path, family)
    rng = np.random.default_rng(16)
    items = [{"image": np.zeros((32, 32, 3), np.uint8), "prompt": "add a hat",
              "control": rng.integers(0, 256, (32, 32, 3), np.uint8)},
             {"image": np.zeros((16, 48, 3), np.uint8), "prompt": "make it night and rainy",
              "control": rng.integers(0, 256, (48, 16, 3), np.uint8)}]
    msl = tr.config.predict.max_sequence_length
    want = jtr.adapter.prepare_multires_embeddings(jtr.bundle, items, msl)
    got = tr.adapter.prepare_multires_embeddings(tr.bundle, items, msl)
    assert got.pop("sample_grids") == want.pop("sample_grids") == [(8, 8), (4, 12)]
    assert_embeddings_match(got, want, exact=("img_shapes_arr", "img_ids", "txt_ids",
                                              "segment_ids"))


@pytest.mark.parametrize("family", ["qwen", "flux"])
def test_predict_multires_matches_jax(request, tmp_path, family, monkeypatch):
    """Two items, one at its control's size (32², the processor's), one at
    an explicit 16×48, two steps from the same numpy noise: each output
    image within one uint8 level of JAX's, at its own size."""
    tr, jtr = _family(request, tmp_path, family)
    drawn = same_noise(monkeypatch)
    rng = np.random.default_rng(17)
    items = [{"prompt": "add a hat", "images": [rng.integers(0, 256, (40, 40, 3), np.uint8)]},
             {"prompt": "make it night", "images": [rng.integers(0, 256, (48, 16, 3), np.uint8)],
              "height": 16, "width": 48}]
    got = tr.predict_multires(items, num_inference_steps=2)
    want = jtr.predict_multires(items, num_inference_steps=2)
    assert drawn["shapes"][0] == drawn["shapes"][1]
    assert [g.shape for g in got] == [(32, 32, 3), (16, 48, 3)]
    for g, w in zip(got, want):
        assert_images_close(g, w)


@pytest.mark.parametrize("family", ["qwen", "flux"])
@pytest.mark.parametrize("source", ["cache", "pixels"])
def test_fit_holds_the_text_encoders_only_where_it_needs_them(tmp_path, monkeypatch, family,
                                                              source):
    """A fit of two steps with a validation sample at every step, on the
    family's drawn tiny weights: from the embedding cache, the text
    encoders are built once, for the validation set-up after step 1, and
    freed before step 2 (no step holds them); from pixels
    (--fit-no-cache), they are built once, for the first batch, and held
    by both steps.  Either way the validation image is logged at both
    steps."""
    if family == "qwen":
        data = write_qwen_folder(tmp_path, 2)
        make = qwen_config
    else:
        data = _flux_folder(tmp_path, 2)
        make = _flux_config
    ctl = str(data / "control_images" / "sample_000.png")
    path = make(tmp_path, data, validation={
        "enabled": True, "steps": 1, "num_inference_steps": 2,
        "samples": [{"prompt": "add a hat", "images": [ctl]}]})
    if source == "cache":
        cli.main(["--config", str(path), "--device", "cpu", "--cache"])
    record = {"builds": 0, "held": []}
    real_load = Trainer.load_model

    def load_model(self):
        real_load(self)
        factory = self.bundle.text_factory

        def counted():
            record["builds"] += 1
            return factory()

        self.bundle.text_factory = counted
        record["trainer"] = self

    monkeypatch.setattr(Trainer, "load_model", load_model)
    from qflux_tpu_torch.trainer import base as tbase

    real_make = tbase.make_train_step

    def make_step(*args, **kwargs):
        inner = real_make(*args, **kwargs)

        def step(*a, **kw):
            record["held"].append(bool(record["trainer"].bundle.text_params))
            return inner(*a, **kw)

        return step

    monkeypatch.setattr(tbase, "make_train_step", make_step)
    flags = ["--fit-no-cache"] if source == "pixels" else []
    tr = cli.main(["--config", str(path), "--device", "cpu", *flags])
    assert tr.global_step == 2 and record["builds"] == 1
    if source == "cache":
        assert record["held"] == [False, False] and tr.bundle.text_params == {}
    else:
        assert record["held"] == [True, True] and tr.bundle.text_params
    assert len(tr._validation_embeddings) == 1
    events = next((tr.output_dir / "logs").glob("events.out.tfevents.*")).read_bytes()
    assert events.count(b"validation/sample_0") == 2


# ---------------------------------------------------------------------------
# the card's machine: no jax, PIL, cv2 or transformers

_BLOCKED_RUN = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "qflux_tpu", "PIL", "cv2", "transformers", "tokenizers", "yaml")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not importable here")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from qflux_tpu_torch import main as cli
cfg, ctl, out = sys.argv[2:5]
tr = cli.main(["--config", cfg, "--device", "cpu", "--cache"])
assert tr.last_cache["samples"] == 2, tr.last_cache
tr = cli.main(["--config", cfg, "--device", "cpu", "--fit-no-cache"])
assert tr.global_step == 2
tr = cli.main(["--config", cfg, "--device", "cpu", "--predict", "--control", ctl,
               "--prompt", "make it blue", "--output", out, "--steps", "2"])
from pathlib import Path
from qflux_tpu_torch.trainer import flux2_klein, flux_kontext, qwen_edit
flux_root, qwen_root, klein_root = map(Path, sys.argv[5:8])
toks = flux_kontext.load_tokenizers(flux_root)
clip = toks["clip"](["a photo of a cat"], padding="max_length", truncation=True, max_length=77,
                    return_tensors="np")
t5 = toks["t5"](["a photo, ＡＢＣ"], padding="max_length", truncation=True, max_length=512,
                return_tensors="np")
assert clip["input_ids"].shape == (1, 77) and t5["input_ids"].shape == (1, 512)
assert clip["attention_mask"].sum() > 2 and t5["attention_mask"].sum() > 1
vl = qwen_edit.load_vl_tokenizer(qwen_root)
assert len(vl("a red hat", add_special_tokens=False)["input_ids"]) > 1
q3 = flux2_klein.load_qwen3_tokenizer(klein_root)
text = q3.apply_chat_template([{"role": "user", "content": "hi"}], tokenize=False,
                              add_generation_prompt=True, enable_thinking=False)
assert text.endswith("</think>\n\n") and q3.decode(q3(text)["input_ids"]) == text
loaded = sorted(m.split(".")[0] for m in sys.modules)
assert not set(BLOCKED) & set(loaded), loaded
print("OK", tr.last_predict["latents_finite"])
"""


def test_card_path_imports_nothing_it_may_not(tmp_path):
    """In a fresh interpreter where jax, qflux_tpu, PIL, cv2, transformers,
    tokenizers and yaml cannot be imported (as on the card's machine): the
    Qwen `--cache`, `--fit-no-cache` and `--predict` of a variant-test JSON
    config run (variant test has no tokenizer files: the hash fallback, as
    in JAX), and the adapters' loaders read tokenizer directories written
    here (FLUX's CLIP and T5, Qwen2.5-VL's, Klein's Qwen3 with its chat
    template) into the first-party tokenizers, which tokenize."""
    from tests.test_torch_tokenizers import QWEN3_TEMPLATE, _write_clip, _write_qwen, _write_t5

    data = write_qwen_folder(tmp_path, 2)
    cfg = qwen_config(tmp_path, data)
    out = tmp_path / "edit.png"
    roots = [tmp_path / name for name in ("flux", "qwen", "klein")]
    _write_clip(roots[0] / "tokenizer")
    _write_t5(roots[0] / "tokenizer_2")
    _write_qwen(roots[1] / "tokenizer", True)
    _write_qwen(roots[2] / "tokenizer", True, QWEN3_TEMPLATE)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(REPO), str(cfg),
                          str(data / "control_images" / "sample_000.png"), str(out),
                          *map(str, roots)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK True")
    assert png.read_png(out).shape == (32, 32, 3)
