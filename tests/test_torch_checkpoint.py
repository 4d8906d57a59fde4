"""Checkpoints and resume of the port's Trainer against the JAX trainer's
files: a resumed run repeats the uninterrupted one to the bit; the file set,
state.json and optimizer_state.npz are the JAX trainer's (found by running
its `save_checkpoint` here); JAX's `_load_train_state` restores the port's
checkpoint and the port resumes JAX's; versioned run dirs, the save on
SIGINT and a user weighting table."""

from __future__ import annotations

import json
import os
import signal
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qflux_tpu.scheduler import weighting as jweighting
from qflux_tpu.trainer import base as jbase
from qflux_tpu.trainer.flux_kontext import FluxKontextAdapter as JFluxAdapter
from qflux_tpu.trainer.train_step import TrainState
from qflux_tpu.utils.lora_io import load_lora_safetensors as jload_lora
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.ops.layers import mark_trainable
from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids
from qflux_tpu_torch.scheduler import weighting
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.trainer.train_step import lora_leaves
from qflux_tpu_torch.utils import checkpoint
from qflux_tpu_torch.utils.lora_io import LORA_FILE_BASE_NAME, jax_location

GH = GW = 4  # tiny latent grid: 16 target + 16 control tokens


def _flux_batch(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"control_latents": rng.standard_normal((1, GH * GW, 16)).astype(f32),
            "prompt_embeds": rng.standard_normal((1, 8, 64)).astype(f32),
            "pooled_prompt_embeds": rng.standard_normal((1, 32)).astype(f32),
            "tgt_ids": flux_image_ids(GH, GW, 0), "ctl_ids": flux_image_ids(GH, GW, 1),
            "txt_ids": flux_text_ids(8),
            "image_latents": rng.standard_normal((1, GH * GW, 16)).astype(f32)}


def _qwen_batch(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"control_latents": rng.standard_normal((1, GH * GW, 16)).astype(f32),
            "prompt_embeds": rng.standard_normal((1, 8, 48)).astype(f32),
            "prompt_embeds_mask": np.array([[1] * 6 + [0] * 2]),
            "img_shapes_arr": np.array([[1, GH, GW], [1, GH, GW]], np.int32),
            "image_latents": rng.standard_normal((1, GH * GW, 16)).astype(f32)}


FAMILIES = {"flux": ("FluxKontextLoraTrainer", _flux_batch),
            "qwen": ("QwenImageEditTrainer", _qwen_batch)}


def _config(tmp_path, family="flux", **train):
    trainer, _ = FAMILIES[family]
    return config_from_dict({
        "trainer": trainer, "model": {"variant": "test"},
        "optimizer": {"learning_rate": 1e-2},
        "lr_scheduler": {"scheduler_type": "cosine", "warmup_steps": 1},
        "logging": {"output_dir": str(tmp_path / "out"), "project": "p"},
        "train": {"max_train_steps": 4, "checkpointing_steps": 2, "weight_dtype": "float32",
                  "timestep_sampling": "logit_normal", **train}})


def _moments(trainer):
    """{(path, a|b, exp_avg|exp_avg_sq): tensor} and the update count of the
    trainer's optax.adamw (`trainer/optimizers.py:Adam`)."""
    out = {}
    for path, leaf in trainer.lora.items():
        for k in ("a", "b"):
            st = trainer.optimizer.state[leaf[k]]
            for m in ("exp_avg", "exp_avg_sq"):
                out[(path, k, m)] = st[m]
    return out, float(trainer.optimizer.count)


@pytest.mark.parametrize("family", ["flux", "qwen"])
def test_resume_equals_the_uninterrupted_run(tmp_path, family):
    """Four steps with a checkpoint at 2; a second Trainer resumed from
    checkpoint-2 runs steps 3–4 and ends with the LoRA, the AdamW moments
    and the losses of the uninterrupted run, to the bit (cosine lr with
    warmup and logit-normal σ, so the lr count and the generator matter)."""
    _, batch = FAMILIES[family]
    batches = [batch(i) for i in range(4)]
    t1 = Trainer(_config(tmp_path, family), device="cpu")
    lora1 = t1.fit(batches)
    run = t1.output_dir
    assert run == tmp_path / "out" / "p" / "v0"
    assert sorted(p.name for p in run.iterdir()) == [
        "checkpoint-2", "checkpoint-4", "checkpoint-last-4", "logs", "train_config.yaml"]
    cfg2 = _config(tmp_path, family)
    cfg2.resume = str(run / "checkpoint-2")
    t2 = Trainer(cfg2, device="cpu")
    t2.adapter, t2.bundle = t1.adapter, t1.bundle
    lora2 = t2.fit(batches[2:])
    assert t2.output_dir == tmp_path / "out" / "p" / "v1"
    assert [h["step"] for h in t2.history] == [3, 4] and t2.global_step == 4
    assert [h["loss"] for h in t2.history] == [h["loss"] for h in t1.history[2:]]
    assert [h["lr"] for h in t2.history] == [h["lr"] for h in t1.history[2:]]
    assert list(lora2) == list(lora1)
    for p in lora1:
        for k in ("a", "b", "scaling"):
            assert torch.equal(lora1[p][k], lora2[p][k]), (p, k)
    m1, s1 = _moments(t1)
    m2, s2 = _moments(t2)
    assert s1 == s2 == 4.0
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert (t2.output_dir / "checkpoint-last-4" / LORA_FILE_BASE_NAME).read_bytes() == (
        run / "checkpoint-last-4" / LORA_FILE_BASE_NAME).read_bytes()


def _jax_trainer(port_trainer, ckpt_lora_file, jax_cfg_overrides=None):
    """The JAX Trainer, without its mesh, holding the port trainer's LoRA
    (read by the JAX package from the port's file) and a fresh optax.adamw
    state of the same config."""
    from qflux_tpu.config import Config

    cfg = port_trainer.config
    jcfg = Config.model_validate({
        "optimizer": {"learning_rate": cfg.optimizer.learning_rate},
        "lr_scheduler": {"scheduler_type": cfg.lr_scheduler.scheduler_type,
                         "warmup_steps": cfg.lr_scheduler.warmup_steps},
        "train": {"max_train_steps": cfg.train.max_train_steps},
        **(jax_cfg_overrides or {})})
    jt = object.__new__(jbase.Trainer)
    jt.config = jcfg
    jt.adapter = JFluxAdapter
    jt.bundle = SimpleNamespace(dit_cfg=SimpleNamespace(attention_head_dim=32))
    jt.global_step, jt.epoch = 0, 0
    lora = jax.tree.map(jnp.asarray, jload_lora(ckpt_lora_file, JFluxAdapter.lora_tree_path_fn,
                                                head_dim=32))
    optimizer = jt.build_optimizer()
    jt.state = TrainState.create(lora, optimizer)
    return jt, optimizer


def _jax_leaf(tree, path, k, layer):
    node = tree
    for part in path:
        node = node[part]
    arr = np.asarray(node[k])
    return arr if layer is None else arr[layer]


def test_checkpoint_files_are_the_jax_trainers(tmp_path):
    """The file set, state.json's keys and optimizer_state.npz's keys,
    shapes and dtypes are what the JAX trainer's `save_checkpoint` writes
    (run here on the JAX package), plus the port's generator_state.npy; and
    JAX's `_load_train_state` restores mu / nu / count from the port's npz
    equal to the port's exp_avg / exp_avg_sq / step."""
    t = Trainer(_config(tmp_path, max_train_steps=3), device="cpu")
    t.fit([_flux_batch(i) for i in range(3)])
    ours = t.output_dir / "checkpoint-2"
    jt, optimizer = _jax_trainer(t, ours / LORA_FILE_BASE_NAME)
    jt.output_dir = tmp_path / "jax"
    jt.global_step, jt.epoch = 2, 0
    theirs = jt.save_checkpoint()
    assert theirs.name == ours.name
    assert sorted(p.name for p in ours.iterdir()) == sorted(
        [p.name for p in theirs.iterdir()] + [checkpoint.GENERATOR_FILE])
    st_ours = json.loads((ours / "state.json").read_text())
    st_theirs = json.loads((theirs / "state.json").read_text())
    assert sorted(st_ours) == sorted(st_theirs) == ["epoch", "git", "global_step", "is_last"]
    assert sorted(st_ours["git"]) == sorted(st_theirs["git"])
    assert (st_ours["global_step"], st_ours["epoch"], st_ours["is_last"]) == (2, 0, False)
    with np.load(ours / checkpoint.OPTIMIZER_FILE) as a, \
            np.load(theirs / checkpoint.OPTIMIZER_FILE) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "2/count" in a.files  # the cosine schedule's count
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    last = t.output_dir / "checkpoint-last-3"
    assert json.loads((last / "state.json").read_text())["is_last"] is True

    # JAX restores the port's checkpoint-last-3
    jt2, optimizer2 = _jax_trainer(t, last / LORA_FILE_BASE_NAME)
    jt2._load_train_state(last, optimizer2)
    assert jt2.global_step == 3 and int(jt2.state.step) == 3
    adam, sched = jt2.state.opt_state[0], jt2.state.opt_state[2]
    assert int(adam.count) == 3 and int(sched.count) == 3
    moments, step = _moments(t)
    assert step == 3.0
    for (path, k, m), v in moments.items():
        jpath, layer = jax_location(path)
        want = _jax_leaf(adam.mu if m == "exp_avg" else adam.nu, jpath, k, layer)
        np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{path}/{k}/{m}")


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX trainer wrote (its LoRA file, npz and
    state.json, with moments from three optax updates): the port restores
    its global_step and its mu / nu / count, then trains on from there."""
    t = Trainer(_config(tmp_path, max_train_steps=1), device="cpu")
    t.fit([_flux_batch(0)])
    jt, optimizer = _jax_trainer(t, t.output_dir / "checkpoint-last-1" / LORA_FILE_BASE_NAME)
    rng = np.random.default_rng(5)
    state = jt.state
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
                             state.lora)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.lora)
        state = TrainState(lora=optax.apply_updates(state.lora, updates), opt_state=opt_state,
                           step=state.step + 1)
    jt.state = state
    jt.output_dir = tmp_path / "jax"
    jt.global_step, jt.epoch = 3, 0
    ckpt = jt.save_checkpoint()
    assert not (ckpt / checkpoint.GENERATOR_FILE).exists()

    cfg = _config(tmp_path, max_train_steps=4)
    cfg.resume = str(ckpt)
    tr = Trainer(cfg, device="cpu")
    tr.adapter, tr.bundle = t.adapter, t.bundle
    cfg.model.lora.pretrained_weight = cfg.resume
    tr.lora = mark_trainable(tr.build_lora())
    tr.optimizer, _ = tr.build_optimizer(lora_leaves(tr.lora)[0])
    tr.generator = torch.Generator().manual_seed(cfg.train.seed)
    tr._load_train_state(ckpt)
    assert tr.global_step == 3
    moments, step = _moments(tr)
    assert step == 3.0
    adam = state.opt_state[0]
    for (path, k, m), v in moments.items():
        jpath, layer = jax_location(path)
        want = _jax_leaf(adam.mu if m == "exp_avg" else adam.nu, jpath, k, layer)
        np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{path}/{k}/{m}")
    for path, leaf in tr.lora.items():
        jpath, layer = jax_location(path)
        np.testing.assert_array_equal(leaf["a"].detach().numpy(),
                                      _jax_leaf(state.lora, jpath, "a", layer))
    cfg.model.lora.pretrained_weight = None
    tr.fit([_flux_batch(1)])
    assert [h["step"] for h in tr.history] == [4]
    assert (tr.output_dir / "checkpoint-last-4").is_dir()


def _runs(root: Path):
    """A run root in every state the version rule tells apart."""
    def run(name, step=None, safetensors=False, raw=None):
        d = root / name
        d.mkdir(parents=True)
        if step is not None or raw is not None:
            (d / "state.json").write_text(raw if raw is not None
                                          else json.dumps({"global_step": step}))
        if safetensors:
            (d / "checkpoint-last-1").mkdir()
            (d / "checkpoint-last-1" / LORA_FILE_BASE_NAME).write_bytes(b"")
    run("v0", step=2)                      # invalid: collected
    run("v1", step=10)                     # kept
    run("v2", step=1, safetensors=True)    # kept: it holds a LoRA
    run("v3")                              # no state.json: collected
    run("v6", raw="not json")              # unreadable state.json: collected
    run("notes")                           # not a run dir
    (root / "v9").write_text("a file, not a run dir")


def test_versioned_dirs_match_jax(tmp_path):
    """setup_versioned_dir collects and numbers run dirs as JAX's does, on
    the same trees (an empty root, then one with runs of every kind)."""
    def listing(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))

    for case in ("empty", "runs"):
        roots = {}
        for who in ("jax", "port"):
            out = tmp_path / case / who
            if case == "runs":
                _runs(out / "proj")
            roots[who] = out
        jt = object.__new__(jbase.Trainer)
        jt.config = SimpleNamespace(logging=SimpleNamespace(output_dir=str(roots["jax"]),
                                                            project="proj"))
        tr = Trainer(config_from_dict({"model": {"variant": "test"},
                                       "logging": {"output_dir": str(roots["port"]),
                                                   "project": "proj"}}), device="cpu")
        got, want = tr.setup_versioned_dir(), jt.setup_versioned_dir()
        assert got.name == want.name == ("v0" if case == "empty" else "v3")
        assert listing(roots["port"]) == listing(roots["jax"])


def test_sigint_after_step_one_saves_checkpoint_last_1(tmp_path):
    """A SIGINT that arrives during step 1 (here: while the loop fetches the
    next batch) ends the run after that step with checkpoint-last-1, and
    the handlers before fit are back afterwards."""
    def batches():
        yield _flux_batch(0)
        os.kill(os.getpid(), signal.SIGINT)
        yield _flux_batch(1)
        yield _flux_batch(2)

    before = signal.getsignal(signal.SIGINT)
    t = Trainer(_config(tmp_path, checkpointing_steps=100), device="cpu")
    t.fit(batches())
    assert t.global_step == 1 and len(t.history) == 1
    assert sorted(p.name for p in t.output_dir.iterdir()) == ["checkpoint-last-1", "logs",
                                                              "train_config.yaml"]
    assert signal.getsignal(signal.SIGINT) is before
    # the config file is JSON, which YAML reads, and holds the run's config
    import yaml

    saved = yaml.safe_load((t.output_dir / "train_config.yaml").read_text())
    assert saved == json.loads((t.output_dir / "train_config.yaml").read_text())
    assert saved["trainer"] == "FluxKontextLoraTrainer"
    assert saved["train"]["checkpointing_steps"] == 100


@pytest.mark.parametrize("suffix", [".npy", ".json"])
def test_user_weighting_table_loads(tmp_path, suffix):
    """train.weighting_table (.npy, or JSON with one float per entry) loads
    as JAX loads it and becomes the step's table."""
    table = np.linspace(0.5, 1.5, 1000, dtype=np.float32)
    path = tmp_path / f"table{suffix}"
    if suffix == ".npy":
        np.save(path, table)
    else:
        path.write_text(json.dumps(table.tolist()))
    ours = weighting.load_weighting_table(str(path))
    np.testing.assert_array_equal(ours, jweighting.load_weighting_table(str(path)))
    tr = Trainer(config_from_dict({"model": {"variant": "test"},
                                   "train": {"weighting_scheme": "weighted",
                                             "weighting_table": str(path)}}), device="cpu")
    sc = tr._build_step_config()
    assert sc.weighting_scheme == "table"
    np.testing.assert_array_equal(sc.weighting_table, ours)


@pytest.mark.parametrize("setting", ["async_checkpointing", "push_to_hub"])
def test_fit_refuses_what_is_not_ported(tmp_path, monkeypatch, caplog, setting):
    """train.async_checkpointing and logging.push_to_hub, once refused, now
    run: a fit over no batch writes checkpoint-last-0 through the async
    writer and returns with it landed; with push_to_hub (and no
    huggingface_hub) it warns that the push failed and does not raise
    (tests/test_torch_tooling.py holds both to the JAX package's)."""
    import logging

    raw = {"model": {"variant": "test"}, "logging": {"output_dir": str(tmp_path)}}
    if setting == "async_checkpointing":
        raw["train"] = {"async_checkpointing": True}
    else:
        raw["logging"]["push_to_hub"] = "user/repo"
        monkeypatch.setitem(__import__("sys").modules, "huggingface_hub", None)
    tr = Trainer(config_from_dict(raw), device="cpu")
    with caplog.at_level(logging.WARNING):
        tr.fit([])
    last = tr.output_dir / "checkpoint-last-0"
    assert sorted(p.name for p in last.iterdir()) == [
        "generator_state.npy", "optimizer_state.npz", LORA_FILE_BASE_NAME, "state.json"]
    pushed = [r for r in caplog.records if "hub push failed" in r.getMessage()]
    assert len(pushed) == (setting == "push_to_hub")
