"""The FLUX.1-Kontext cache pass and raw-image entry points of the port
(qflux_tpu_torch/trainer/flux_kontext.py's encoding half, trainer/base.py's
`cache`, pixel batches, `predict` and validation, main.py's --cache /
--fit-no-cache / --predict) against the JAX package on the CPU, on one tiny
folder of PNGs and the same weights (the JAX trees filled from numpy,
bridged into the port's modules).

Bounds: the embeddings of one pixel batch within relative L2 2e-5 of JAX's
(the same f32 encoders summed in other orders) and the ids equal; the two
caches hold the same files under the same content-hash names with the same
metadata, their fp16 arrays within relative L2 1e-3 (one fp16 rounding of
values 2e-5 apart can land one fp16 ulp, 2^-11 relative, apart) and their
ids equal.  The same paths for Qwen-Image-Edit, held to JAX's
(`test_qwen_still_refuses_naming_5b`, which kept its name from when they
refused; the Qwen tests proper are tests/test_torch_qwen_cache_pass.py).
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
from qflux_tpu.data import dataset as jdataset
from qflux_tpu.data import loader as jloader
from qflux_tpu.models.flux import text_encoders as jte
from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.models.flux import vae as jvae
from qflux_tpu.trainer import base as jbase
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu_torch import main as cli
from qflux_tpu_torch.config import load_config_from_yaml
from qflux_tpu_torch.data import dataset as tdataset
from qflux_tpu_torch.data import loader as tloader
from qflux_tpu_torch.data.preprocess import ImageProcessor
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.trainer.flux_kontext import text_encoders
from qflux_tpu_torch.utils import png
from tests.test_torch_cli import _event_accumulator
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

REL_TOL = 2e-5
CACHE_TOL = 1e-3
MSL = 24  # predict.max_sequence_length: the tiny T5's sequence


def _write_folder(root: Path, n: int = 3) -> Path:
    """n samples: a 40×56 target and a 48×48 control PNG each (sample 1
    with a second control, sample_001_control_1), prompts; resampled to
    32×32 by the config's processor."""
    rng = np.random.default_rng(0)
    data = root / "data"
    for d in ("training_images", "control_images"):
        (data / d).mkdir(parents=True)
    for i in range(n):
        stem = f"sample_{i:03d}"
        (data / "training_images" / f"{stem}.png").write_bytes(
            png.encode_png(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)))
        (data / "control_images" / f"{stem}.png").write_bytes(
            png.encode_png(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)))
        (data / "training_images" / f"{stem}.txt").write_text(f"make edit {i} happen")
    (data / "control_images" / "sample_001_control_1.png").write_bytes(
        png.encode_png(rng.integers(0, 256, (64, 32, 3), dtype=np.uint8)))
    return data


def _config(root: Path, data: Path, trainer="FluxKontextLoraTrainer", **over) -> Path:
    raw = {"trainer": trainer, "mesh": {"dp": 1, "fsdp": 1, "tp": 1},
           "model": {"variant": "test", "lora": {"r": 4, "lora_alpha": 4}},
           "data": {"init_args": {"dataset_path": str(data)},
                    "processor": {"target_size": [32, 32]}, "batch_size": 1,
                    "shuffle": False},
           "cache": {"use_cache": True, "cache_dir": str(root / "cache")},
           "predict": {"max_sequence_length": MSL, "num_inference_steps": 2},
           "train": {"max_train_steps": 2, "weight_dtype": "float32",
                     "checkpointing_steps": 100},
           "logging": {"output_dir": str(root / "out"), "project": "p"}}
    for section, values in over.items():
        raw.setdefault(section, {}).update(values)
    path = root / "cfg.json"
    path.write_text(json.dumps(raw))
    return path


def run_example_config(tmp_path: Path, name: str, mode: str, model=None, processor=None,
                       controls: int = 1):
    """configs/<name> at variant test through the port's CLI on the CPU:
    its checkpoint path dropped, `model` / `processor` merged into its
    sections, its data a tiny folder of two samples (`_write_folder`; the
    second has a second control), f32, bs 1, two steps, the text at MSL
    positions.  `--cache` first, then the `mode`'s run: a fit from that
    cache ("fit") or `--predict` on `controls` copies of a control PNG
    ("--predict"; "--cache": nothing more).  Returns (the cache pass's trainer, the mode's trainer, the PNG written
    or None)."""
    import yaml

    from qflux_tpu_torch import main as cli

    data = _write_folder(tmp_path, 2)
    raw = yaml.safe_load((Path(__file__).resolve().parents[1] / "configs" / name).read_text())
    raw["model"].update(variant="test", pretrained_model_name_or_path=None, **(model or {}))
    raw["data"]["init_args"]["dataset_path"] = str(data)
    raw["data"]["processor"].update(processor or {"target_size": [32, 32]})
    raw["data"]["batch_size"] = 1
    raw["train"].update(max_train_steps=2, weight_dtype="float32")
    raw["logging"]["output_dir"] = str(tmp_path / "out")
    raw["predict"] = {"max_sequence_length": MSL}
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    assert Trainer.from_yaml(str(path), device="cpu").adapter_cls.__name__.endswith("Adapter")
    base = ["--config", str(path), "--device", "cpu"]
    cached = cli.main(base + ["--cache"])
    assert cached.last_cache["samples"] == 2
    tr, out = cached, None
    if mode == "fit":
        tr = cli.main(base)
        assert tr.global_step == 2 and np.isfinite([h["loss"] for h in tr.history]).all()
    elif mode == "--predict":
        out = tmp_path / "edit.png"
        ctl = str(data / "control_images" / "sample_000.png")
        tr = cli.main(base + ["--predict", *(["--control", ctl] * controls), "--prompt",
                              "make it blue", "--output", str(out), "--steps", "2"])
        assert png.read_png(out).ndim == 3 and tr.last_predict["latents_finite"]
    return cached, tr, out


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny FLUX model set (DiT, VAE, CLIP, T5) filled from numpy,
    as a JAX adapter + bundle, and the same numbers as numpy trees."""
    cfg = jflux.FluxConfig.tiny()
    vcfg = jvae.VAEConfig.tiny()
    ccfg, tcfg = jte.CLIPTextConfig.tiny(), jte.T5Config.tiny()
    key = jax.random.PRNGKey(0)
    trees = {"dit": _random_tree(lambda: jflux.init(key, cfg, jnp.float32), 0),
             "vae": _random_tree(lambda: jvae.init(key, vcfg), 1),
             "clip": _random_tree(lambda: jte.clip_init(key, ccfg), 2),
             "t5": _random_tree(lambda: jte.t5_init(key, tcfg), 3)}
    bundle = jfk.ModelBundle(
        dit_cfg=cfg, dit_params=trees["dit"], vae_cfg=vcfg, vae_params=trees["vae"],
        text_cfgs={"clip": ccfg, "t5": tcfg},
        text_params={"clip": trees["clip"], "t5": trees["t5"]},
        tokenizers={"clip": jfk.SimpleTokenizer(ccfg.vocab_size, ccfg.max_position_embeddings,
                                                ccfg.eos_token_id),
                    "t5": jfk.SimpleTokenizer(tcfg.vocab_size, 64)})
    adapter = jfk.FluxKontextAdapter(cfg, remat=False, vae_scale=vcfg.downscale)
    return adapter, bundle, jax.tree.map(lambda x: np.asarray(x, np.float32), trees)


def _port_trainer(path, np_trees) -> Trainer:
    """The port's Trainer for `path` with the JAX weights bridged in."""
    tr = Trainer(load_config_from_yaml(path), device="cpu")
    tr.load_model()
    b = tr.bundle
    bridge.load_params(b.dit_params, np_trees["dit"])
    bridge.load_vae_params(b.vae_params, np_trees["vae"])
    bridge.load_text_params(text_encoders(b)["clip"], np_trees["clip"])
    bridge.load_text_params(text_encoders(b)["t5"], np_trees["t5"])
    return tr


def _jax_trainer(path, weights) -> jbase.Trainer:
    tr = jbase.Trainer(jconfig.load_config_from_yaml(path))
    tr.adapter, tr.bundle = weights[0], weights[1]
    return tr


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def test_prepare_embeddings_matches_jax(tmp_path, weights):
    """A bs=2 pixel batch with three control images of three sizes: every
    embedding within REL_TOL of JAX's, img_ids (control set ids 1-3) and
    txt_ids equal; the negative prompt's embeddings; and the Trainer's
    pixel branch zeroing the control latents of a drop_context sample as
    JAX's does."""
    data = _write_folder(tmp_path)
    tr = _port_trainer(_config(tmp_path, data), weights[2])
    rng = np.random.default_rng(1)
    batch = {"image": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             "control": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             "control_1": rng.integers(0, 256, (2, 16, 32, 3), dtype=np.uint8),
             "control_2": rng.integers(0, 256, (2, 48, 16, 3), dtype=np.uint8),
             "prompt": ["turn the sky red", ""], "drop_context": np.array([False, True])}
    adapter, bundle = weights[0], weights[1]
    want = adapter.prepare_embeddings(bundle, batch, MSL)
    got = tr.adapter.prepare_embeddings(tr.bundle, batch, MSL)
    assert sorted(got) == sorted(want)
    for k in ("image_latents", "control_latents", "prompt_embeds", "pooled_prompt_embeds"):
        assert got[k].shape == want[k].shape, k
        assert _rel_err(_np(got[k]), want[k]) < REL_TOL, k
    for k in ("img_ids", "txt_ids"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert sorted(set(np.asarray(got["img_ids"])[:, 0])) == [0, 1, 2, 3]
    neg_t = tr.adapter.negative_embeddings(tr.bundle, "blurry", batch, MSL)
    neg_j = adapter.negative_embeddings(bundle, "blurry", batch, MSL)
    for k in neg_j:
        assert _rel_err(_np(neg_t[k]), neg_j[k]) < REL_TOL
    jtr = _jax_trainer(_config(tmp_path, data), weights)
    emb_t, emb_j = tr._embeddings_for_batch(batch), jtr._embeddings_for_batch(batch)
    assert not _np(emb_t["control_latents"])[1].any()
    assert _rel_err(_np(emb_t["control_latents"]), emb_j["control_latents"]) < REL_TOL


def _listing(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def caches(tmp_path_factory, weights):
    """The tiny folder cached by each package's Trainer.cache: (config path,
    port cache dir, JAX cache dir, the port's trainer)."""
    root = tmp_path_factory.mktemp("caches")
    data = _write_folder(root)
    out = {}
    for name in ("port", "jax"):
        d = root / name
        d.mkdir()
        path = _config(d, data)
        if name == "port":
            tr = _port_trainer(path, weights[2])
            ds = tdataset.ImageDataset(str(data), processor=ImageProcessor(target_size=[32, 32]))
            n = tr.cache(tloader.DataLoader(ds, batch_size=1, shuffle=False, drop_last=False,
                                            bucket_by_shape=False))
            out["trainer"] = tr
        else:
            jcfg = jconfig.load_config_from_yaml(path)
            ds = jdataset.ImageDataset(str(data), processor=jdataset.ImageProcessor(
                jcfg.data.processor))
            n = _jax_trainer(path, weights).cache(jloader.DataLoader(
                ds, batch_size=1, shuffle=False, drop_last=False, bucket_by_shape=False))
        assert n == 3
        out[name] = d / "cache"
    out["data"] = data
    return out


def test_cache_matches_jax(caches):
    """The same files (embedding key / content hash .npz, metadata/<main
    hash>.json) in both caches, the metadata equal, the nine keys at their
    shapes, arrays within CACHE_TOL, ids equal."""
    ours, theirs = _listing(caches["port"]), _listing(caches["jax"])
    assert sorted(ours) == sorted(theirs)
    keys = {p.split("/")[0] for p in ours} - {"metadata"}
    assert keys == {"image_latents", "control_latents", "prompt_embeds",
                    "pooled_prompt_embeds", "empty_prompt_embeds",
                    "empty_pooled_prompt_embeds", "tgt_ids", "ctl_ids", "txt_ids"}
    for rel, path in ours.items():
        if rel.startswith("metadata"):
            assert json.loads(path.read_text()) == json.loads(theirs[rel].read_text())
            continue
        a, b = np.load(path)["data"], np.load(theirs[rel])["data"]
        assert a.dtype == b.dtype and a.shape == b.shape, rel
        if rel.endswith("ids"):
            np.testing.assert_array_equal(a, b, err_msg=rel)
        else:
            assert a.dtype == np.float16 and _rel_err(a, b) < CACHE_TOL, rel
    shapes = {rel.split("/")[0]: np.load(p)["data"].shape for rel, p in ours.items()
              if not rel.startswith("metadata")}
    assert shapes["image_latents"] == (64, 16) and shapes["prompt_embeds"] == (MSL, 64)
    assert shapes["pooled_prompt_embeds"] == (32,)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_trains_from_the_others_cache(caches, weights, reader, tmp_path):
    """The port's fit from the JAX package's cache, and JAX's fit from the
    port's, two steps each: every batch served from the cache, finite
    losses; the port's losses from either cache within 1e-3 of each other."""
    writer = "jax" if reader == "port" else "port"
    over = {"cache": {"use_cache": True, "cache_dir": str(caches[writer])},
            "logging": {"output_dir": str(tmp_path / "out"), "project": "p"}}
    path = _config(tmp_path, caches["data"], **over)
    if reader == "jax":
        jtr = _jax_trainer(path, weights)
        jcfg = jtr.config
        ds = jdataset.ImageDataset(str(caches["data"]), cache_dir=str(caches[writer]),
                                   use_cache=True,
                                   processor=jdataset.ImageProcessor(jcfg.data.processor))
        assert all(ds[i]["cached"] for i in range(len(ds)))
        state = jtr.fit(jloader.DataLoader(ds, batch_size=1, shuffle=False))
        assert int(state.step) == 2
        return
    losses = {}
    for src in ("jax", "port"):
        over["cache"]["cache_dir"] = str(caches[src])
        tr = _port_trainer(_config(tmp_path, caches["data"], **over), weights[2])
        ds = tdataset.ImageDataset(str(caches["data"]), cache_dir=str(caches[src]),
                                   use_cache=True)
        assert all(ds[i]["cached"] for i in range(len(ds)))
        tr.fit(tloader.DataLoader(ds, batch_size=1, shuffle=False))
        losses[src] = [h["loss"] for h in tr.history]
        assert len(losses[src]) == 2 and np.isfinite(losses[src]).all()
    np.testing.assert_allclose(losses["jax"], losses["port"], rtol=1e-3)


def test_cli_cache_fit_no_cache_and_predict(tmp_path, weights, monkeypatch):
    """`--cache` writes the folder's cache (then fit reads every batch from
    it), `--fit-no-cache` trains from pixels (a batch without
    image_latents reaches the step as the encoders' output), and
    `--predict --control … --prompt … --output …` writes a PNG of the
    control's size that decodes to uint8 RGB."""
    data = _write_folder(tmp_path)
    path = _config(tmp_path, data)
    real_load = Trainer.load_model

    def load_model(self):
        real_load(self)
        b = self.bundle
        bridge.load_params(b.dit_params, weights[2]["dit"])
        bridge.load_vae_params(b.vae_params, weights[2]["vae"])
        bridge.load_text_params(text_encoders(b)["clip"], weights[2]["clip"])
        bridge.load_text_params(text_encoders(b)["t5"], weights[2]["t5"])

    monkeypatch.setattr(Trainer, "load_model", load_model)
    tr = cli.main(["--config", str(path), "--device", "cpu", "--cache"])
    assert tr.last_cache["samples"] == 3
    assert len(list((tmp_path / "cache" / "metadata").iterdir())) == 3
    seen = []
    real_emb = Trainer._embeddings_for_batch

    def record(self, batch):
        seen.append("image_latents" in batch)
        return real_emb(self, batch)

    monkeypatch.setattr(Trainer, "_embeddings_for_batch", record)
    fit = cli.main(["--config", str(path), "--device", "cpu"])
    assert seen == [True] * 3 and fit.global_step == 2  # the third batch staged ahead
    seen.clear()
    nocache = cli.main(["--config", str(path), "--device", "cpu", "--fit-no-cache"])
    assert seen == [False] * 3 and nocache.global_step == 2
    assert np.isfinite([h["loss"] for h in nocache.history]).all()
    ctl = data / "control_images" / "sample_000.png"
    out = tmp_path / "edit.png"
    pred = cli.main(["--config", str(path), "--device", "cpu", "--predict", "--control",
                     str(ctl), "--prompt", "make it blue", "--output", str(out), "--steps", "2"])
    assert pred.last_outputs == [str(out)] and pred.last_predict["steps"] == 2
    img = png.read_png(out)
    assert img.dtype == np.uint8 and img.shape == (32, 32, 3)
    assert pred.last_predict["latents_finite"]


def test_run_validation_logs_images(tmp_path, weights, monkeypatch):
    """A fit with validation.samples (one with a control image, one with
    none and an explicit size) samples at steps 1 and 2 and logs
    validation/sample_i images and validation/prompt_i texts to the events
    file; setup encodes the samples once."""
    EventAccumulator = _event_accumulator(monkeypatch)
    rng = np.random.default_rng(4)
    data = _write_folder(tmp_path)
    (tmp_path / "v.png").write_bytes(png.encode_png(rng.integers(0, 256, (40, 40, 3),
                                                                 dtype=np.uint8)))
    over = {"validation": {"enabled": True, "steps": 1, "num_inference_steps": 2, "samples": [
        {"prompt": "add a hat", "images": [str(tmp_path / "v.png")]},
        {"prompt": "a cat", "images": [], "height": 16, "width": 32}]}}
    tr = _port_trainer(_config(tmp_path, data, **over), weights[2])
    calls = []
    real_setup = Trainer.setup_validation
    monkeypatch.setattr(Trainer, "setup_validation",
                        lambda self: calls.append(1) or real_setup(self))
    ds = tdataset.ImageDataset(str(data), processor=ImageProcessor(target_size=[32, 32]))
    tr.fit(tloader.DataLoader(ds, batch_size=1, shuffle=False))
    assert calls == [1] and tr.global_step == 2
    shapes = [(r["height"], r["width"]) for r in tr._validation_embeddings]
    assert shapes == [(32, 32), (16, 32)]
    ea = EventAccumulator(str(tr.output_dir / "logs"), size_guidance={"images": 0,
                                                                       "tensors": 0})
    ea.Reload()
    assert {"validation/sample_0", "validation/sample_1"} <= set(ea.Tags()["images"])
    assert [e.step for e in ea.Images("validation/sample_0")] == [1, 2]
    assert {"validation/prompt_0/text_summary",
            "validation/prompt_1/text_summary"} <= set(ea.Tags()["tensors"])


def test_tokenizer_fallback_matches_jax(caplog):
    """Without tokenizer files the port falls back to the JAX package's
    hash tokenizer with its warning ("using hash fallback"): the same
    ids for the same prompts, at CLIP's 77 positions (EOS 49407) and T5's
    512 (no EOS), long prompts cut."""
    from qflux_tpu_torch.trainer import flux_kontext as tfk

    with caplog.at_level("WARNING"):
        toks = tfk.load_tokenizers(None)
    assert "using hash fallback" in caplog.text
    prompts = ["turn the sky red", "", " ".join(f"w{i}" for i in range(600)), "é ü"]
    for name, want in (("clip", jfk.SimpleTokenizer(49408, 77, 49407)),
                       ("t5", jfk.SimpleTokenizer(32128, 512))):
        got = toks[name](prompts)
        assert got.dtype == np.int32 and got.shape == (4, want.max_length)
        np.testing.assert_array_equal(got, want(prompts))
        np.testing.assert_array_equal(toks[name](prompts, max_length=24),
                                      want(prompts, max_length=24))


@pytest.mark.parametrize("case", ["--cache", "--fit-no-cache", "--predict", "validation",
                                  "pixel_batch", "predict_multires"])
def test_qwen_still_refuses_naming_5b(tmp_path, case, monkeypatch):
    """The name dates from when these Qwen-Image-Edit paths refused (naming
    item 5b); they now run.  Qwen-Image-Edit's encoders are ported: each
    path that refused for it now runs and is held to JAX's on the same weights
    (tests/test_torch_qwen_cache_pass.py's helpers): the CLI's --cache
    (the cache file for file), --fit-no-cache (the pixel batch's
    embeddings) and --predict (the image from the same noise); validation
    inside fit (its embeddings and images); a batch of pixels handed to
    fit (finite steps, its embeddings); predict_multires (each image
    from the same noise)."""
    from tests import test_torch_qwen_cache_pass as q

    w = q.make_qwen_weights()
    if case.startswith("--"):
        q.run_qwen_cli_mode(tmp_path, monkeypatch, case, w)
        return
    data = q.write_qwen_folder(tmp_path, 1)
    ctl = data / "control_images" / "sample_000.png"
    if case == "validation":
        over = {"validation": {"enabled": True, "steps": 2, "num_inference_steps": 2,
                               "samples": [{"prompt": "add a hat", "images": [str(ctl)]}]}}
        path = q.qwen_config(tmp_path, data, **over)
        q.patch_qwen_load(monkeypatch, w[2])
        tr = cli.main(["--config", str(path), "--device", "cpu"])
        assert tr.global_step == 2
        assert b"validation/sample_0" in next((tr.output_dir / "logs").iterdir()).read_bytes()
        q.hold_validation_to_jax(tr, path, w, monkeypatch)
        return
    path = q.qwen_config(tmp_path, data)
    tr = q.qwen_port_trainer(path, w[2])
    jtr = q.qwen_jax_trainer(path, w)
    rng = np.random.default_rng(18)
    if case == "pixel_batch":
        batch = {"image": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
                 "control": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
                 "prompt": ["edit it"]}
        tr.fit([batch])  # one batch an epoch, max_train_steps 2
        assert tr.global_step == 2 and np.isfinite([h["loss"] for h in tr.history]).all()
        q.assert_embeddings_match(tr._embeddings_for_batch(batch),
                                  jtr._embeddings_for_batch(batch))
        return
    q.same_noise(monkeypatch)
    items = [{"prompt": "p", "images": [png.read_png(ctl)]},
             {"prompt": "a longer prompt here", "images": [png.read_png(ctl)[:20]],
              "height": 16, "width": 32}]
    got = tr.predict_multires(items, num_inference_steps=2)
    want = jtr.predict_multires(items, num_inference_steps=2)
    assert [g.shape for g in got] == [(32, 32, 3), (16, 32, 3)]
    for g, wnt in zip(got, want):
        q.assert_images_close(g, wnt)
