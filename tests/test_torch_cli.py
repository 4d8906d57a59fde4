"""The port's training CLI and what it drives, against the JAX package's, on
the CPU at tiny width: the config loader's data / cache / validation /
logging sections (interpolation, pixel budgets, the cache wiring, JSON
configs where PyYAML is absent), `Trainer._embeddings_for_batch` on
collated cached batches (bucketed and mixed-resolution, FLUX and Qwen:
segment ids, token loss mask and ids exactly, RoPE tables to torch's and
XLA's cos / sin), the
mixed-batch train-step loss (relative 1e-5, the loss tolerance of
tests/test_torch_train.py: the same f32 weights, batch, noise and σ, only
XLA's and PyTorch's CPU sums in other orders), the TensorBoard event file
against tensorboardX's for the same calls, the model summary and the
throughput logger; then `python -m qflux_tpu_torch.main` end to end on a
cached folder dataset, and the modes it refuses with their ROADMAP.md
queue-1 items.
"""

from __future__ import annotations

import io
import json
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from qflux_tpu import config as jconfig
from qflux_tpu.data.collate import collate as jcollate
from qflux_tpu.losses import losses as jlosses
from qflux_tpu.ops import quant as jquant
from qflux_tpu.trainer import base as jbase
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu.trainer import qwen_edit as jqe
from qflux_tpu.utils import fps as jfps
from qflux_tpu.utils import logger as jlogger
from qflux_tpu.utils.model_summary import model_summary_rows as jsummary
from qflux_tpu_torch import losses as tlosses
from qflux_tpu_torch import main as cli
from qflux_tpu_torch.config import config_from_dict, load_config_from_yaml
from qflux_tpu_torch.data.collate import collate
from qflux_tpu_torch.data.dataset import ImageDataset
from qflux_tpu_torch.data.loader import DataLoader
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops.quant import quantize_tree
from qflux_tpu_torch.trainer import flux_kontext as tfk
from qflux_tpu_torch.trainer import qwen_edit as tqe
from qflux_tpu_torch.trainer import train_step as tts
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.utils import fps as tfps
from qflux_tpu_torch.utils.logger import LoggerManager, read_event_scalars
from qflux_tpu_torch.utils.model_summary import model_summary_rows
from tests.test_torch_data import GRIDS, TINY, assert_same
from tests.test_torch_qwen import JCFG, QCFG, TCFG, _jax_dit, _lora, _np_tree, _port
from tests.test_torch_train import tiny_pair  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parents[1]
ITEM_5 = "queue 1 item 5b"
LOSS_REL = 1e-5


# ---------------------------------------------------------------------------
# the config loader

def _sections(cfg) -> dict:
    """The data / cache / validation / logging fields the port reads, from
    a JAX Config or the port's namespaces."""
    d, p = cfg.data, cfg.data.processor
    mode = cfg.mode.value if hasattr(cfg.mode, "value") else cfg.mode
    return {
        "mode": mode,
        **{f"data.{k}": getattr(d, k) for k in (
            "class_path", "init_args", "batch_size", "shuffle", "drop_last", "num_workers",
            "caption_dropout_rate", "use_edit_mask", "bucket_by_shape")},
        **{f"data.processor.{k}": getattr(p, k) for k in (
            "process_type", "resize_mode", "target_size", "controls_size", "target_pixels",
            "controls_pixels", "multi_resolutions", "max_aspect_ratio", "divisible_by")},
        **{f"cache.{k}": getattr(cfg.cache, k) for k in ("use_cache", "cache_dir")},
        **{f"validation.{k}": getattr(cfg.validation, k) for k in (
            "enabled", "steps", "num_inference_steps", "true_cfg_scale", "guidance", "samples",
            "dataset", "max_samples", "fail_on_error")},
        **{f"logging.{k}": getattr(cfg.logging, k) for k in (
            "output_dir", "project", "report_to", "tracker_project_name", "profile_dir")},
    }


CONFIG_CASES = [
    "logging: {output_dir: /o}\ncache: {use_cache: true, cache_dir: '${logging.output_dir}/c'}\n"
    "data: {init_args: {dataset_path: /d, use_cache: false}}\n",
    "data: {processor: {target_pixels: '512*512', controls_pixels: [null, '768*512']},\n"
    "       batch_size: 4}\nvalidation: {enabled: true, steps: 7}\n"
    "train: {seed: 9}\nlogging: {project: p, tracker_project_name: '${logging.project}'}\n",
    "data: {batch_size: '${train.gradient_accumulation_steps}'}\n"
    "train: {gradient_accumulation_steps: 2}\nmode: fit\n",
    "{}\n",
]


@pytest.mark.parametrize("src", [*sorted((REPO / "configs").glob("*.yaml")),
                                 *range(len(CONFIG_CASES))],
                         ids=lambda s: s.stem if isinstance(s, Path) else f"case{s}")
def test_config_sections_match_jax(src, tmp_path):
    """Every shipped config and four edge cases: the new sections field by
    field against qflux_tpu.config.load_config_from_yaml (interpolation,
    a whole-string reference keeping its int, pixel budgets, the cache
    wired into data.init_args where absent)."""
    if not isinstance(src, Path):
        path = tmp_path / "c.yaml"
        path.write_text(CONFIG_CASES[src])
        src = path
    assert _sections(load_config_from_yaml(src)) == _sections(jconfig.load_config_from_yaml(src))


def test_json_config_without_pyyaml(tmp_path, monkeypatch):
    """Where PyYAML is absent, a config in JSON syntax loads through `json`
    into the namespaces the YAML route gives, interpolation resolved; a
    circular reference raises in both packages."""
    raw = chip_smoke.multires_config("/data", "/out", False, variant="test")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    with_yaml = load_config_from_yaml(path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    without = load_config_from_yaml(path)
    assert vars(without.data.processor) == vars(with_yaml.data.processor)
    assert _sections(without) == _sections(with_yaml)
    assert without.cache.cache_dir == "/out/cache" == without.data.init_args["cache_dir"]
    monkeypatch.undo()
    assert _sections(without) == _sections(jconfig.load_config_from_yaml(path))
    loop = tmp_path / "loop.yaml"
    loop.write_text("logging: {output_dir: '${logging.project}', project: '${logging.output_dir}'}\n")
    for load in (load_config_from_yaml, jconfig.load_config_from_yaml):
        with pytest.raises(ValueError, match="circular"):
            load(loop)


# ---------------------------------------------------------------------------
# _embeddings_for_batch and the mixed-batch step

def _jax_trainer(adapter, loss="AttentionMaskMseLoss"):
    jt = object.__new__(jbase.Trainer)
    jt.adapter = adapter
    jt.config = SimpleNamespace(loss=SimpleNamespace(class_path=f"qflux_tpu.losses.{loss}"))
    jt._criterion = getattr(jlosses, loss)()
    return jt


def _port_trainer(family, adapter, tmp_path=None, loss="AttentionMaskMseLoss"):
    raw = {"trainer": {"flux": "FluxKontextLoraTrainer", "qwen": "QwenImageEditTrainer"}[family],
           "model": {"variant": "test"}, "train": {"weight_dtype": "float32"},
           "loss": {"class_path": f"qflux_tpu.losses.{loss}"}}
    if tmp_path is not None:
        raw["logging"] = {"output_dir": str(tmp_path)}
    t = Trainer(config_from_dict(raw), device="cpu")
    t.adapter = adapter
    return t


def _qwen_items(rng, grids, txt_lens):
    return [chip_smoke.qwen_cache_item(rng, TCFG, gh, gw, s_txt=s, pad=2)
            for (gh, gw), s in zip(grids, txt_lens)]


def _items(family, kind):
    """Per-sample cached items (as the dataset yields them) of one batch:
    one shape ("bucketed": FLUX 6×4 and 4×6, the same latent shape, so
    per-sample ids) or two ("mixed": padded)."""
    rng = np.random.default_rng(4)
    grids = [(6, 4), (4, 6)] if kind == "bucketed" else [(4, 4), (6, 4)]
    if family == "flux":
        items = [chip_smoke.flux_cache_item(rng, TINY, gh, gw, s_txt=8) for gh, gw in grids]
        for it in items:
            for k in ("empty_prompt_embeds", "empty_pooled_prompt_embeds"):
                it.pop(k)
    else:
        txt = [8, 8] if kind == "bucketed" else [8, 6]  # text padded too when mixed
        items = _qwen_items(rng, grids if kind == "mixed" else [(4, 4), (4, 4)], txt)
        for it in items:
            for k in ("empty_prompt_embeds", "empty_prompt_embeds_mask"):
                it.pop(k)
    for i, it in enumerate(items):
        it.update({"prompt": f"p{i}", "file_hashes": {"main_hash": f"m{i}"}, "cached": True})
    return items


def _numpy(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


@pytest.mark.parametrize("family", ["flux", "qwen"])
@pytest.mark.parametrize("kind", ["bucketed", "mixed"])
def test_embeddings_for_batch_matches_jax(family, kind):
    """The same collated batch through the JAX Trainer's and the port's
    `_embeddings_for_batch`: the same keys and every array equal to the bit
    (segment ids [txt, target, control] and the token loss mask where the
    latents were padded; per-sample FLUX ids), but the values of Qwen's
    RoPE tables, which torch's and XLA's cos / sin give one f32 ulp apart:
    their layout and their padding with identity rotations are exact."""
    from qflux_tpu.models.flux import transformer as jflux

    jad = (jfk.FluxKontextAdapter(jflux.FluxConfig.tiny(), remat=False) if family == "flux"
           else jqe.QwenImageEditAdapter(JCFG, remat=False))
    tad = (tfk.FluxKontextAdapter(TINY, remat=False) if family == "flux"
           else tqe.QwenImageEditAdapter(TCFG, remat=False))
    items = _items(family, kind)
    want = _jax_trainer(jad)._embeddings_for_batch(jcollate(items))
    got = _port_trainer(family, tad)._embeddings_for_batch(collate(items))
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _numpy(got[k]), np.asarray(want[k])
        if k.startswith("rope_"):
            # cos / sin of the same f32 angles by torch and by XLA: one f32
            # ulp apart (tests/test_torch_qwen.py::test_qwen_rope_matches_jax
            # holds qwen_rope to rtol 1e-5); the layout and the padded
            # identity rows are exact
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
            assert np.array_equal(g == 1, w == 1) and np.array_equal(g == 0, w == 0), k
        else:
            assert_same(g, w, k)
    assert ("segment_ids" in got) == (kind == "mixed")
    if kind == "mixed":
        assert got["segment_ids"].dtype == np.int32 and not got["attention_mask"].all()
    elif family == "flux":
        assert got["img_ids"].ndim == 3  # 6×4 and 4×6: per-sample ids


def _jax_loss(adapter, jtree, jl, batch, noise, sigma) -> float:
    """The JAX train step's loss (`_loss_for_microbatch`'s body) at
    injected noise / σ, jitted: the step's update does not change it."""
    from qflux_tpu.ops import layers as jlayers
    from qflux_tpu.scheduler import flow_match as jfm

    def loss(lora, batch, noise, sigma):
        lat = batch["image_latents"]
        noisy = jfm.FlowMatchScheduler.add_noise(lat, noise, sigma)
        target = jfm.FlowMatchScheduler.training_target(lat, noise)
        pred = adapter.predict_velocity(jlayers.merge_lora(jtree, lora), batch, noisy, sigma)
        return jlosses.AttentionMaskMseLoss()(pred, target,
                                              attention_mask=batch["attention_mask"])

    arrays = {k: jnp.asarray(v) for k, v in batch.items()}
    return float(jax.jit(loss)(jl, arrays, jnp.asarray(noise), jnp.asarray(sigma)))


def _loss_pair(family, jtree, jl, model, items, tmp_path):
    """(JAX loss, port loss) of one AttentionMaskMseLoss step on the mixed
    batch at injected noise / σ, and the port's batch."""
    from qflux_tpu.models.flux import transformer as jflux

    jad = (jfk.FluxKontextAdapter(jflux.FluxConfig.tiny(), remat=False) if family == "flux"
           else jqe.QwenImageEditAdapter(JCFG, remat=False))
    tad = (tfk.FluxKontextAdapter(model.cfg, remat=False) if family == "flux"
           else tqe.QwenImageEditAdapter(model.cfg, remat=False))
    jemb = _jax_trainer(jad)._embeddings_for_batch(jcollate(items))
    tt = _port_trainer(family, tad, tmp_path)
    temb = tt._device_batch(tt._embeddings_for_batch(collate(items)))
    rng = np.random.default_rng(9)
    noise = rng.standard_normal(np.shape(jemb["image_latents"])).astype(np.float32)
    sigma = rng.uniform(0.1, 0.9, noise.shape[0]).astype(np.float32)
    j_loss = _jax_loss(jad, jtree, jl, jemb, noise, sigma)
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, _np_tree(jl)))
    opt, schedule = tt.build_optimizer(tts.lora_leaves(lora)[0])
    step = tts.make_train_step(tad.predict_velocity, tlosses.AttentionMaskMseLoss(), opt,
                               schedule, tts.TrainStepConfig())
    t_loss = float(step(model, lora, temb, None, noise=torch.from_numpy(noise),
                        sigma=torch.from_numpy(sigma))["loss"])
    return j_loss, t_loss, temb, tad, lora


@pytest.mark.parametrize("family", ["flux", "qwen"])
def test_mixed_batch_step_matches_jax_and_each_sample(family, tiny_pair, tmp_path):
    """A padded mixed-resolution batch (4×4 and 6×4 latents; Qwen's text
    padded too): the train step's AttentionMaskMseLoss equals JAX's step on
    the same weights, batch, noise and σ (relative 1e-5), and the port's
    padded forward equals each sample run alone on its valid tokens
    (relative L2 2e-5, the f32 DiT bound of tests/test_torch_qwen.py)."""
    if family == "flux":
        _, jtree, jl, model = tiny_pair
    else:
        jtree = _jax_dit()
        jl, model = _lora(jtree, 5), _port(jtree)
    items = _items(family, "mixed")
    j_loss, t_loss, temb, tad, lora = _loss_pair(family, jtree, jl, model, items, tmp_path)
    assert t_loss == pytest.approx(j_loss, rel=LOSS_REL)
    tt = _port_trainer(family, tad, tmp_path)
    params = tlayers.merge_lora(model, lora)
    lat = 0.5 * temb["image_latents"]
    sigma = torch.full((2,), 0.5)
    with torch.no_grad():
        padded = tad.predict_velocity(params, temb, lat, sigma)
        for i, item in enumerate(items):
            one = tt._device_batch(tt._embeddings_for_batch(collate([item])))
            n = one["image_latents"].shape[1]
            alone = tad.predict_velocity(params, one, lat[i:i + 1, :n], sigma[:1])
            rel = ((padded[i:i + 1, :n] - alone).norm() / alone.norm()).item()
            assert rel < 2e-5, (i, rel)


def test_lr_and_batch_items_match_jax():
    jt = object.__new__(jbase.Trainer)
    jt.config = jconfig.Config.model_validate({
        "optimizer": {"learning_rate": 3e-4},
        "lr_scheduler": {"scheduler_type": "cosine", "warmup_steps": 3},
        "train": {"max_train_steps": 20}})
    tt = Trainer(config_from_dict({"optimizer": {"learning_rate": 3e-4},
                                   "lr_scheduler": {"scheduler_type": "cosine",
                                                    "warmup_steps": 3},
                                   "train": {"max_train_steps": 20}}), device="cpu")
    for step in range(0, 25, 2):
        assert tt._lr_value(step) == pytest.approx(jt._lr_value(step), rel=1e-6)
    batch = collate(_items("flux", "mixed"))
    assert tt._batch_items(batch) == jt._batch_items(batch) == 2


# ---------------------------------------------------------------------------
# logging, the model summary, throughput

def _event_accumulator(monkeypatch):
    """TensorBoard's EventAccumulator over its own file reader: the stand-in
    module `tensorboard.compat.notf` keeps TensorBoard from importing
    TensorFlow, which only slows the read."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    return EventAccumulator


def test_event_file_matches_tensorboardx(tmp_path, monkeypatch):
    """The same calls through the port's LoggerManager and the JAX package's
    (tensorboardX) read back through TensorBoard's EventAccumulator with the
    same scalars, texts (hparams, a table, unicode) and decoded images; the
    port's own reader gives the same scalars."""
    from PIL import Image

    EventAccumulator = _event_accumulator(monkeypatch)

    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (6, 9, 3), dtype=np.uint8) for _ in range(5)]
    hparams = {"model": {"lora": {"r": 4}}, "lr": 1e-4, "name": "run"}
    logs = {}
    for who, mk in (("port", LoggerManager), ("jax", jlogger.LoggerManager)):
        lm = mk(report_to="tensorboard", log_dir=str(tmp_path / who), config=hparams)
        lm.log_table("model_summary", [{"component": "a", "params": "1,000"}], 0)
        for step in range(1, 4):
            lm.log_metrics({"loss": 1.0 / step, "lr": 1e-4 * step, "epoch": 0}, step)
        lm.log_text("note", "naïve ✓", 2)
        lm.log_images("samples", images, 3, ncols=2)
        lm.close()
        ea = EventAccumulator(str(tmp_path / who),
                              size_guidance={"scalars": 0, "tensors": 0, "images": 0})
        ea.Reload()
        logs[who] = {
            "tags": {k: sorted(v) for k, v in ea.Tags().items() if isinstance(v, list)},
            "scalars": {t: [(e.step, e.value) for e in ea.Scalars(t)]
                        for t in ea.Tags()["scalars"]},
            "texts": {t: [(e.step, list(e.tensor_proto.string_val)) for e in ea.Tensors(t)]
                      for t in ea.Tags()["tensors"]},
            "images": {t: [(e.step, e.width, e.height,
                            np.asarray(Image.open(io.BytesIO(e.encoded_image_string))))
                           for e in ea.Images(t)] for t in ea.Tags()["images"]},
        }
    assert_same(logs["port"], logs["jax"])
    assert logs["port"]["images"]["samples"][0][1:3] == (2 * 9 + 2, 3 * 6 + 4)
    ours = next((tmp_path / "port").glob("events.out.tfevents.*"))
    assert read_event_scalars(ours) == logs["port"]["scalars"]


def test_missing_backend_degrades_to_null_logger(tmp_path, caplog):
    lm = LoggerManager(report_to="wandb", log_dir=str(tmp_path), config={"a": 1})
    lm.log_metrics({"loss": 1.0}, 1)
    lm.close()
    assert type(lm.backend).__name__ == "NullLogger" and "unavailable" in caplog.text
    assert type(LoggerManager(report_to="none").backend).__name__ == "NullLogger"


def test_model_summary_matches_jax(tiny_pair):
    """The fit's step-0 table over the tiny FLUX DiT (f32, with a LoRA) and
    the tiny Qwen DiT over the int4-requant base (packed int4 counted two a
    byte, the port's cached requant factors not counted)."""
    _, jp, jl, model = tiny_pair
    assert model_summary_rows(model, bridge.lora_from_tree(model, _np_tree(jl))) == jsummary(
        jp, jl)
    jtree = _jax_dit()
    jq = jax.jit(lambda t: jquant.quantize_tree(t, QCFG))(jtree)  # the table reads shapes only
    assert model_summary_rows(quantize_tree(_port(jtree), QCFG)) == jsummary(jq)


def test_fps_logger_matches_jax(monkeypatch):
    """Warm-up, window mean, EMA and pause / resume on one fake clock."""
    now = [0.0]
    for mod in (jfps, tfps):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    a, b = jfps.FpsLogger(warmup_steps=2, window=3), tfps.FpsLogger(warmup_steps=2, window=3)
    for x in (a, b):
        x.start()
    for i, dt in enumerate([1.0, 0.5, 0.25, 2.0, 0.5, 1.5]):
        now[0] += dt
        if i == 3:
            for x in (a, b):
                x.pause()
            now[0] += 10.0
            for x in (a, b):
                x.resume()
        assert b.step(n_items=2) == a.step(n_items=2)
        assert (b.fps, b.smoothed_fps) == (a.fps, a.smoothed_fps)


# ---------------------------------------------------------------------------
# the CLI

def _cli_config(tmp_path, bucket=False, steps=4, **over):
    rng = np.random.default_rng(0)
    items = [chip_smoke.flux_cache_item(rng, TINY, gh, gw, s_txt=8) for gh, gw in GRIDS[:4]]
    data, _ = chip_smoke.write_cached_dataset(tmp_path, items, chip_smoke.FLUX_HASH_KEYS)
    raw = chip_smoke.multires_config(data, tmp_path, bucket, variant="test", steps=steps)
    raw["train"].update(weight_dtype="float32", checkpointing_steps=2)
    for section, values in over.items():
        raw.setdefault(section, {}).update(values)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(raw))
    return path


def test_cli_fits_a_cached_folder(tmp_path, monkeypatch):
    """main(["--config", cfg.json, "--device", "cpu"]) on a tiny cached
    folder (padded mixed batches, 4 steps over 2 epochs): checkpoints 2, 4
    and last-4, an events file whose loss scalars are the history's, the
    model summary and hparams texts, a profiler trace of steps 2-4 under
    --profile; then --resume from checkpoint-2 runs steps 3-4 with the same
    losses."""
    EventAccumulator = _event_accumulator(monkeypatch)
    path = _cli_config(tmp_path)
    tr = cli.main(["--config", str(path), "--device", "cpu", "--profile",
                   str(tmp_path / "prof")])
    run = tr.output_dir
    assert run == tmp_path / "flux_multires" / "v0"
    assert sorted(p.name for p in run.iterdir()) == [
        "checkpoint-2", "checkpoint-4", "checkpoint-last-4", "logs", "train_config.yaml"]
    assert [h["step"] for h in tr.history] == [1, 2, 3, 4] and tr.epoch == 1
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    ea = EventAccumulator(str(run / "logs"), size_guidance={"scalars": 0, "tensors": 0})
    ea.Reload()
    assert [(e.step, e.value) for e in ea.Scalars("loss")] == [
        (h["step"], float(np.float32(h["loss"]))) for h in tr.history]
    assert [e.step for e in ea.Scalars("compile_s")] == [1]
    assert {"smooth_loss", "epoch", "lr", "fps"} <= set(ea.Tags()["scalars"])
    assert {"hparams/text_summary", "model_summary/text_summary"} <= set(ea.Tags()["tensors"])
    assert [p.name for p in (tmp_path / "prof").iterdir()] == ["fit_steps_2-4.trace.json"]
    res = cli.main(["--config", str(path), "--device", "cpu",
                    "--resume", str(run / "checkpoint-2")])
    assert [h["step"] for h in res.history] == [3, 4]
    assert [h["loss"] for h in res.history] == [h["loss"] for h in tr.history[2:]]


def _qwen_cli_config(tmp_path, **over):
    """A tiny Qwen-Image-Edit config over `_cli_config`'s folder (cached FLUX
    embeddings: what reads them first refuses)."""
    raw = json.loads(_cli_config(tmp_path, **over).read_text())
    raw["trainer"] = "QwenImageEditTrainer"
    path = tmp_path / "qwen.json"
    path.write_text(json.dumps(raw))
    return path


@pytest.mark.parametrize("flag,match", [("--cache", ITEM_5), ("--fit-no-cache", ITEM_5),
                                        ("--predict", ITEM_5), ("--distributed", "item 8"),
                                        ("--plan", "Do not port")])
def test_cli_refuses_unported_modes(tmp_path, flag, match, monkeypatch):
    """The name dates from when --cache, --fit-no-cache and --predict
    refused a Qwen config; they now run.  --plan is not ported.
    --distributed runs (tests/test_torch_distributed.py); what it still
    refuses is a mesh with tp > 1, naming item 8b (here a world of one
    from torchrun's variables, over gloo with --device cpu).  --cache,
    --fit-no-cache and
    --predict run for FLUX.1-Kontext (tests/test_torch_cache_pass.py) and,
    since item 5b's Qwen half, for Qwen-Image-Edit: each held to JAX's on
    the same weights (`run_qwen_cli_mode`: the cache file for file, the
    pixel batch's embeddings, the edited image from the same noise)."""
    if flag == "--distributed":
        import socket

        import torch.distributed as dist

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
            monkeypatch.setenv(k, v)
        path = _cli_config(tmp_path, mesh={"tp": 2, "fsdp": 1})
        try:
            with pytest.raises(NotImplementedError, match=match):
                cli.main(["--config", str(path), flag, "--device", "cpu"])
            assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        finally:
            dist.destroy_process_group()
        return
    if flag == "--plan":
        with pytest.raises(NotImplementedError, match=match):
            cli.main(["--config", str(tmp_path / "never-read.json"), flag])
        return
    from tests import test_torch_qwen_cache_pass as q

    q.run_qwen_cli_mode(tmp_path, monkeypatch, flag, q.make_qwen_weights())


@pytest.mark.parametrize("flags", [["--steps", "30"], ["--image", "x.png"],
                                   ["--prompt", "edit"], ["--output", "y.png"],
                                   ["--plan-devices", "4"]])
def test_cli_rejects_flags_it_does_not_act_on(tmp_path, flags, capsys):
    """A fit given a predict option (--steps, --image / --control, --prompt,
    --output act only with --predict) or the JAX CLI's --plan-devices (not
    parsed) stops with argparse's usage error instead of ignoring it."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", str(tmp_path / "never-read.json"), *flags])
    err = capsys.readouterr().err
    if flags[0] == "--plan-devices":
        assert e.value.code == 2 and "unrecognized arguments" in err
    else:
        name = "--control" if flags[0] == "--image" else flags[0]
        assert e.value.code == 2 and f"{name} act only with --predict" in err


@pytest.mark.parametrize("case", ["validation_samples", "validation_dataset", "hf_dataset",
                                  "pixel_batch"])
def test_fit_refuses_what_needs_the_encoders(tmp_path, case, monkeypatch):
    """The name dates from when these paths refused for Qwen-Image-Edit;
    they now run.  With both families' encoders ported: validation sampling (from
    validation.samples and from validation.dataset) runs inside fit and
    logs its images, and a batch of pixels trains, for FLUX.1-Kontext and
    for Qwen-Image-Edit (its validation embeddings and images, and the
    pixel batch's embeddings, held to JAX's on the same weights).  An HF
    Hub dataset still raises (item 5b) for either."""
    from tests import test_torch_qwen_cache_pass as q

    data = tmp_path / "data"
    qdata = q.write_qwen_folder(tmp_path / "qp", 1)
    ctl = str(qdata / "control_images" / "sample_000.png")
    over, qover = {}, {}
    if case == "validation_samples":
        over["validation"] = {"enabled": True, "steps": 1, "num_inference_steps": 2,
                              "samples": [{"prompt": "x", "images": [], "height": 16,
                                           "width": 16}]}
        qover["validation"] = dict(over["validation"], samples=[
            {"prompt": "x", "images": [ctl]}])
    elif case == "validation_dataset":
        dataset = {"class_path": "qflux_tpu.data.dataset.ImageDataset",
                   "init_args": {"dataset_path": str(data)}}
        over["validation"] = {"enabled": True, "steps": 1, "num_inference_steps": 2,
                              "max_samples": 1, "dataset": dataset}
        over["data"] = {"processor": {"target_size": [16, 16]}}
        qover["validation"] = dict(over["validation"], dataset={
            **dataset, "init_args": {"dataset_path": str(qdata)}})
    elif case == "hf_dataset":
        over["data"] = {"init_args": {"dataset_path": "someone/edit-pairs"}}
    path = _cli_config(tmp_path, steps=1, **over)
    w = q.make_qwen_weights()
    if case == "hf_dataset":
        for p in (path, _qwen_cli_config(tmp_path / "q", **over)):
            with pytest.raises(NotImplementedError, match=ITEM_5):
                cli.main(["--config", str(p), "--device", "cpu"])
        return
    qpath = q.qwen_config(tmp_path / "qp", qdata, train={"max_train_steps": 1}, **qover)
    if case == "pixel_batch":
        tr = Trainer(load_config_from_yaml(path), device="cpu")
        rng = np.random.default_rng(0)
        batch = {"image": rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8),
                 "control": rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8),
                 "prompt": ["edit"]}
        tr.fit([batch])
        assert tr.global_step == 1 and np.isfinite(tr.history[0]["loss"])
        qtr = q.qwen_port_trainer(qpath, w[2])
        qtr.fit([batch])
        assert qtr.global_step == 1 and np.isfinite(qtr.history[0]["loss"])
        q.assert_embeddings_match(qtr._embeddings_for_batch(batch),
                                  q.qwen_jax_trainer(qpath, w)._embeddings_for_batch(batch))
        return
    EventAccumulator = _event_accumulator(monkeypatch)
    tr = cli.main(["--config", str(path), "--device", "cpu"])
    assert tr.global_step == 1
    ea = EventAccumulator(str(tr.output_dir / "logs"), size_guidance={"images": 0})
    ea.Reload()
    assert [e.step for e in ea.Images("validation/sample_0")] == [1]
    # enabled without samples or a dataset does nothing, as in JAX
    ok = _cli_config(tmp_path / "ok", steps=1, validation={"enabled": True, "steps": 1})
    assert cli.main(["--config", str(ok), "--device", "cpu"]).global_step == 1
    q.patch_qwen_load(monkeypatch, w[2])
    qtr = cli.main(["--config", str(qpath), "--device", "cpu"])
    assert qtr.global_step == 1
    ea = EventAccumulator(str(qtr.output_dir / "logs"), size_guidance={"images": 0})
    ea.Reload()
    assert [e.step for e in ea.Images("validation/sample_0")] == [1]
    q.hold_validation_to_jax(qtr, qpath, w, monkeypatch)


def test_dataloader_feeds_fit_as_the_cli_does(tmp_path):
    """Trainer.fit over a DataLoader (bucketed, 3 worker threads) trains as
    over the same batches handed in as a list per epoch."""
    path = _cli_config(tmp_path, bucket=True, steps=3)
    cfg = load_config_from_yaml(path)
    data = cfg.data.init_args

    def loader():
        return DataLoader(ImageDataset(data["dataset_path"], cache_dir=data["cache_dir"],
                                       use_cache=True), batch_size=2, seed=cfg.train.seed,
                          num_workers=3)

    a = Trainer(cfg, device="cpu")
    a.fit(loader())
    dl = loader()
    epochs = iter([list(dl), list(dl)])

    class Epochs:
        def __iter__(self):
            return iter(next(epochs))

    b = Trainer(load_config_from_yaml(path), device="cpu")
    b.adapter, b.bundle = a.adapter, a.bundle
    b.fit(Epochs())
    assert [h["loss"] for h in b.history] == [h["loss"] for h in a.history]
    assert len(a.history) == 3
