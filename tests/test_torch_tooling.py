"""The port's checkpoint and tooling modules against the JAX package's, on
the CPU at tiny width: `train.async_checkpointing` (utils/checkpoint.py:
AsyncWriter), the orbax warning on resume, `utils/get_model_config.py`,
`utils/model_compare.py` with scripts/compare_lora_weights_torch.py,
`utils/hub.py` offline and `logging.push_to_hub`, `utils/seed.py`.

No test reaches a network: `huggingface_hub` and `datasets` are replaced in
sys.modules by None, so importing either raises, as on a machine that has
neither."""

from __future__ import annotations

import logging
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qflux_tpu.utils import get_model_config as jgmc
from qflux_tpu.utils import hub as jhub
from qflux_tpu.utils import model_compare as jmc
from qflux_tpu.utils import seed as jseed
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.utils import checkpoint, get_model_config, hub, model_compare, seed
from qflux_tpu_torch.utils.lora_io import LORA_FILE_BASE_NAME, save_lora_safetensors
from tests.test_torch_checkpoint import _flux_batch

REPO = Path(__file__).resolve().parents[1]


def _config(out, **train):
    return config_from_dict({
        "trainer": "FluxKontextLoraTrainer", "model": {"variant": "test"},
        "optimizer": {"learning_rate": 1e-2},
        "lr_scheduler": {"scheduler_type": "cosine", "warmup_steps": 1},
        "logging": {"output_dir": str(out), "project": "p"},
        "train": {"max_train_steps": 4, "checkpointing_steps": 2, "weight_dtype": "float32",
                  "timestep_sampling": "logit_normal", **train}})


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(adapter, bundle) of the tiny FLUX trainer, shared by the fits."""
    tr = Trainer(_config(tmp_path_factory.mktemp("m")), "cpu")
    tr.load_model()
    return tr.adapter, tr.bundle


def _fit(model, out, batches, **train):
    tr = Trainer(_config(out, **train), "cpu")
    tr.adapter, tr.bundle = model
    tr.fit(batches)
    return tr


@pytest.fixture
def offline(monkeypatch):
    """huggingface_hub and datasets absent (importing either raises)."""
    for name in ("huggingface_hub", "datasets"):
        monkeypatch.setitem(sys.modules, name, None)


# ---------------------------------------------------------------------------
# async checkpointing

def test_async_checkpoints_equal_the_synchronous_ones(model, tmp_path):
    """Four steps, a checkpoint every two, once synchronously and once with
    train.async_checkpointing: every file of every checkpoint is equal byte
    for byte; fit returns with the last save landed; a run resumed from the
    async checkpoint-2 ends with the uninterrupted run's LoRA and losses to
    the bit."""
    batches = [_flux_batch(i) for i in range(4)]
    sync = _fit(model, tmp_path / "sync", batches)
    run = _fit(model, tmp_path / "async", batches, async_checkpointing=True)
    assert run._ckpt_writer is None and len(run.save_blocked_s) == 3
    names = ["checkpoint-2", "checkpoint-4", "checkpoint-last-4"]
    for name in names:
        a, b = sync.output_dir / name, run.output_dir / name
        files = sorted(p.name for p in a.iterdir())
        assert files == sorted(p.name for p in b.iterdir())
        assert files == ["generator_state.npy", "optimizer_state.npz",
                         "pytorch_lora_weights.safetensors", "state.json"]
        for f in files:
            assert (a / f).read_bytes() == (b / f).read_bytes(), (name, f)
    cfg = _config(tmp_path / "resumed", async_checkpointing=True)
    cfg.resume = str(run.output_dir / "checkpoint-2")
    tr = Trainer(cfg, "cpu")
    tr.adapter, tr.bundle = model
    lora = tr.fit(batches[2:])
    assert [h["loss"] for h in tr.history] == [h["loss"] for h in sync.history[2:]]
    for path, leaf in sync.lora.items():
        for k in ("a", "b"):
            assert torch.equal(lora[path][k], leaf[k]), (path, k)


def test_npz_bytes_depend_on_the_arrays_alone(tmp_path, monkeypatch):
    """`save_npz` writes what np.load reads as np.savez's, and two saves of
    the same arrays at different times are equal byte for byte."""
    import time as _time

    arrays = {"0/count": np.asarray(3, np.int32), "0/mu/x/a": np.arange(6, dtype=np.float32),
              "b": np.zeros((2, 3), np.float32).view(np.dtype("V4"))}
    checkpoint.save_npz(tmp_path / "a.npz", arrays)
    later = _time.time() + 3600
    monkeypatch.setattr(_time, "time", lambda: later)
    checkpoint.save_npz(tmp_path / "b.npz", arrays)
    assert (tmp_path / "a.npz").read_bytes() == (tmp_path / "b.npz").read_bytes()
    np.savez(tmp_path / "c.npz", **arrays)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "c.npz") as c:
        assert a.files == c.files
        for k in a.files:
            assert a[k].dtype == c[k].dtype and a[k].tobytes() == c[k].tobytes()


def test_writer_error_is_raised_at_the_next_wait(model, tmp_path, monkeypatch):
    """A writer thread that fails: `AsyncWriter.wait` raises its exception
    (once), and a fit whose checkpoint-2 write fails raises it at the next
    save, not later and not never."""
    writer = checkpoint.AsyncWriter("cpu")

    def boom(*_):
        raise OSError("disk full")

    writer.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.wait()  # raised once

    calls = []
    orig = Trainer._write_checkpoint

    def write(self, ckpt_dir, *args):
        calls.append(ckpt_dir.name)
        if ckpt_dir.name == "checkpoint-2":
            raise OSError("disk full")
        return orig(self, ckpt_dir, *args)

    monkeypatch.setattr(Trainer, "_write_checkpoint", write)
    tr = Trainer(_config(tmp_path, async_checkpointing=True), "cpu")
    tr.adapter, tr.bundle = model
    with pytest.raises(OSError, match="disk full"):
        tr.fit([_flux_batch(i) for i in range(4)])
    assert calls == ["checkpoint-2"] and tr.global_step == 4
    assert tr._ckpt_writer is None


def test_resume_beside_an_orbax_dir_warns(model, tmp_path, caplog):
    """A JAX run written under its async route keeps the optimizer state in
    output_dir/orbax, beside checkpoint-N/ without an npz: the port warns,
    naming that directory, and its moments start fresh (optax's zeros);
    where the npz is there too it restores it, and still warns."""
    run = _fit(model, tmp_path / "run", [_flux_batch(i) for i in range(2)],
               max_train_steps=2).output_dir
    ckpt = run / "checkpoint-2"
    (run / "orbax" / "2").mkdir(parents=True)
    for has_npz in (True, False):
        if not has_npz:
            (ckpt / checkpoint.OPTIMIZER_FILE).unlink()
        cfg = _config(tmp_path / f"resumed{has_npz}")
        cfg.resume = str(ckpt)
        tr = Trainer(cfg, "cpu")
        tr.adapter, tr.bundle = model
        tr.lora = tr.build_lora()
        tr.optimizer, _ = tr.build_optimizer([t.requires_grad_() for leaf in tr.lora.values()
                                              for t in (leaf["a"], leaf["b"])])
        tr.generator = torch.Generator().manual_seed(0)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            tr._load_train_state(ckpt)
        warned = [r.getMessage() for r in caplog.records if "orbax" in r.getMessage()]
        assert len(warned) == 1 and str(run / "orbax") in warned[0]
        assert tr.global_step == 2
        moments = [st["exp_avg"] for st in tr.optimizer.state.values()]
        assert len(moments) == (2 * len(tr.lora) if has_npz else 0)
        assert any(m.abs().sum() > 0 for m in moments) == has_npz


# ---------------------------------------------------------------------------
# get_model_config, model_compare, the compare script

@pytest.mark.parametrize("name", sorted(jgmc.KNOWN_CONFIGS))
def test_dump_model_config_equals_jax(name):
    assert sorted(get_model_config.KNOWN_CONFIGS) == sorted(jgmc.KNOWN_CONFIGS)
    assert get_model_config.dump_model_config(name) == jgmc.dump_model_config(name)


def test_compare_model_configs_and_unknown_name_as_jax():
    for a, b in [("flux-kontext", "qwen-image"), ("flux-vae", "qwen-vae"),
                 ("qwen-vl-text", "qwen3"), ("t5", "t5")]:
        assert get_model_config.compare_model_configs(a, b) == jgmc.compare_model_configs(a, b)
    with pytest.raises(KeyError, match="unknown model config"):
        get_model_config.get_model_config("nope")


def _lora_files(tmp_path):
    """Two LoRA files of the tiny FLUX layout written by the port: the
    second with one module perturbed, one rescaled (alpha), one missing
    and one of another rank."""
    rng = np.random.default_rng(0)

    def leaf(r=4, scale=1.0):
        return {"a": rng.standard_normal((64, r)).astype(np.float32),
                "b": rng.standard_normal((r, 64)).astype(np.float32),
                "scaling": np.asarray(scale, np.float32)}

    a = {f"dual/{i}/attn/{m}": leaf() for i in range(2) for m in ("to_q", "to_v")}
    a.update({f"single/{i}/attn/to_q": leaf() for i in range(2)})
    b = {k: {kk: vv.copy() for kk, vv in v.items()} for k, v in a.items()}
    b["dual/1/attn/to_v"]["b"] += 1e-3
    b["dual/0/attn/to_q"]["scaling"] = np.asarray(2.0, np.float32)
    del b["single/1/attn/to_q"], b["single/0/attn/to_q"]
    b["single/0/attn/to_q"] = leaf(r=8)
    b["single/1/attn/to_q"] = leaf(r=8)
    paths = []
    for name, tree in (("a", a), ("b", b)):
        paths.append(save_lora_safetensors(tree, tmp_path / name / LORA_FILE_BASE_NAME,
                                           head_dim=32))
    return paths


def test_compare_lora_files_and_report_equal_jax(tmp_path, capsys):
    """`compare_lora_files` gives JAX's diffs (paths, statuses, shapes,
    errors) on two files, the same file against itself all matches, and
    `print_report` prints JAX's report."""
    fa, fb = _lora_files(tmp_path)
    for x, y in ((fa, fb), (fa, fa)):
        got, want = model_compare.compare_lora_files(x, y), jmc.compare_lora_files(x, y)
        assert [dataclass_tuple(d) for d in got] == [dataclass_tuple(d) for d in want]
        assert model_compare.summarize(got) == jmc.summarize(want)
        capsys.readouterr()
        report = model_compare.print_report(got, max_rows=3)
        printed = capsys.readouterr().out
        assert report == jmc.print_report(want, max_rows=3) and printed == report + "\n"
    assert set(model_compare.summarize(model_compare.compare_lora_files(fa, fb))) == {
        "match", "value_mismatch", "shape_mismatch"}


def dataclass_tuple(d):
    return (d.path, d.status, d.shape_a, d.shape_b, d.max_abs, d.rel_err)


def test_compare_params_over_tensors_and_lists():
    """compare_params takes torch tensors (bf16 too), nested dicts and lists,
    and gives what JAX's gives on the same numbers as numpy."""
    rng = np.random.default_rng(1)
    a = {"x": [rng.standard_normal(5).astype(np.float32), np.zeros(3, np.float32)],
         "y": {"z": rng.standard_normal((2, 2)).astype(np.float32)}}
    b = {"x": [a["x"][0] * (1 + 1e-3), np.zeros(4, np.float32)], "w": np.ones(1)}
    tensors = {"x": [torch.from_numpy(b["x"][0]).bfloat16(), torch.zeros(4)],
               "w": torch.ones(1, dtype=torch.float64)}
    as_np = {"x": [tensors["x"][0].float().numpy(), np.zeros(4, np.float32)], "w": np.ones(1)}
    got = model_compare.compare_params(a, tensors, rtol=1e-2)
    assert [dataclass_tuple(d) for d in got] == [
        dataclass_tuple(d) for d in jmc.compare_params(a, as_np, rtol=1e-2)]
    assert model_compare.rel_err(a["x"][0], b["x"][0]) == jmc.rel_err(a["x"][0], b["x"][0])


def test_compare_script_exit_code_as_jax(tmp_path, capsys):
    """scripts/compare_lora_weights_torch.py: JAX's script's report and exit
    code (1 on any difference, 0 on none), without JAX in its imports."""
    import importlib.util

    def load(name):
        spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    ours, theirs = load("compare_lora_weights_torch"), load("compare_lora_weights")
    fa, fb = _lora_files(tmp_path)
    for argv in ([str(fa), str(fb)], [str(fa), str(fa)], [str(fa), str(fb), "--rtol", "1"]):
        capsys.readouterr()
        code = ours.main(argv)
        out = capsys.readouterr().out
        assert code == theirs.main(argv) and out == capsys.readouterr().out, argv
    assert "jax" not in (REPO / "scripts" / "compare_lora_weights_torch.py").read_text()


# ---------------------------------------------------------------------------
# hub, push_to_hub, seed

def _folder(root: Path) -> Path:
    from qflux_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(2)
    for sub in ("images", "control_images"):
        (root / sub).mkdir(parents=True)
    for stem in ("a", "b"):
        img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        (root / "images" / f"{stem}.png").write_bytes(encode_png(img))
        (root / "images" / f"{stem}.txt").write_text(f"edit {stem}")
        (root / "control_images" / f"{stem}.png").write_bytes(encode_png(img))
        (root / "control_images" / f"{stem}_1.png").write_bytes(encode_png(img))
    return root


def test_hub_helpers_offline_as_jax(tmp_path, offline):
    """The schema, the repo-id rule, the records of a folder dataset, a
    local download and an upload's content-hash name (in the RuntimeError
    it raises with no huggingface_hub) equal JAX's; a hub download raises
    RuntimeError too."""
    assert hub.EDITING_DATASET_FEATURES == jhub.EDITING_DATASET_FEATURES
    for p in ("org/name", "./org/name", "/abs/x", "a/b/c", str(tmp_path), "plain"):
        assert hub.is_huggingface_repo(p) == jhub.is_huggingface_repo(p), p
    root = _folder(tmp_path / "data")
    assert hub.build_editing_records(root) == jhub.build_editing_records(root)
    lora = tmp_path / "ckpt" / LORA_FILE_BASE_NAME
    lora.parent.mkdir()
    lora.write_bytes(b"lora bytes")
    assert hub.download_lora(str(lora)) == jhub.download_lora(str(lora)) == lora
    assert hub.download_lora(str(lora.parent)) == lora
    errors = []
    for mod in (hub, jhub):
        with pytest.raises(RuntimeError, match="hub upload unavailable") as err:
            mod.upload_lora_safetensors(lora, "org/repo")
        errors.append(str(err.value).split("would upload to ")[1])
    assert errors[0] == errors[1] and errors[0].startswith("loras/")
    with pytest.raises(RuntimeError):
        hub.download_lora("org/repo")


def test_push_to_hub_warns_and_the_fit_finishes(model, tmp_path, offline, caplog):
    """logging.push_to_hub with no hub: the fit trains, saves its last
    checkpoint and warns once that the push failed, naming the file's
    content-hash destination."""
    cfg = _config(tmp_path, max_train_steps=1)
    cfg.logging.push_to_hub = "org/repo"
    tr = Trainer(cfg, "cpu")
    tr.adapter, tr.bundle = model
    with caplog.at_level(logging.WARNING):
        tr.fit([_flux_batch(0)])
    assert tr.global_step == 1 and (tr.output_dir / "checkpoint-last-1").is_dir()
    warned = [r.getMessage() for r in caplog.records if "hub push failed" in r.getMessage()]
    assert len(warned) == 1 and "loras/" in warned[0]


def test_seed_everything_as_jax(monkeypatch):
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    draws = []
    for mod in (seed, jseed):
        assert mod.seed_everything(7) == 7
        draws.append((random.random(), float(np.random.rand())))
        assert __import__("os").environ["PYTHONHASHSEED"] == "7"
    assert draws[0] == draws[1]
