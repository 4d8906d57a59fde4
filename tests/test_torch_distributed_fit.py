"""`Trainer.fit` and the CLI on two ranks, over gloo on the CPU.

  * JAX's `test_two_process_fit` (tests/parallel/test_multiprocess.py) on
    the port: a dp = 2 fit from pixels with validation, through
    tests/torch_dist_worker.py;
  * an out-of-memory error planted on one rank of a dp = 2 fit: both
    ranks retry under "full";
  * `python -m qflux_tpu_torch.main --distributed --device cpu` on two
    ranks with torchrun's variables.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from tests.test_torch_distributed import TIMEOUT, _env, _spawn


def _image_folder(root: Path, n: int = 4) -> Path:
    from qflux_tpu_torch.utils.png import encode_png

    img_dir = root / "data"
    (img_dir / "training_images").mkdir(parents=True)
    (img_dir / "control_images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        stem = f"img_{i:03d}"
        for sub in ("training_images", "control_images"):
            (img_dir / sub / f"{stem}.png").write_bytes(
                encode_png(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)))
        (img_dir / "training_images" / f"{stem}.txt").write_text(f"prompt {i}")
    return img_dir


def test_two_process_fit(tmp_path):
    """JAX's `test_two_process_fit` on the port: a dp = 2 `Trainer.fit` of
    variant test, 2 steps from pixels with validation at step 2 — one run
    dir v0, one checkpoint set written by rank 0 with global_step 2, one
    events file holding both validation samples (gathered to rank 0); both
    ranks report the same losses and the same LoRA."""
    img_dir = _image_folder(tmp_path)
    cfg = {
        "trainer": "FluxKontextLoraTrainer",
        "mesh": {"dp": 2, "fsdp": 1},
        "model": {"variant": "test", "lora": {"r": 2, "lora_alpha": 2}},
        "data": {"init_args": {"dataset_path": str(img_dir)},
                 "processor": {"process_type": "resize", "target_size": [32, 32]}},
        "train": {"max_train_steps": 2, "checkpointing_steps": 1000,
                  "weight_dtype": "float32", "num_epochs": 10},
        "validation": {"enabled": True, "steps": 2, "num_inference_steps": 2,
                       "samples": [{"images": [str(img_dir / "control_images" / "img_000.png")],
                                    "prompt": "a"},
                                   {"images": [str(img_dir / "control_images" / "img_001.png")],
                                    "prompt": "b"}]},
        "logging": {"output_dir": str(tmp_path / "out"), "project": "mp",
                    "report_to": "tensorboard"},
    }
    (tmp_path / "fit.json").write_text(json.dumps(cfg))
    _spawn("fit", 2, tmp_path)
    runs = sorted((tmp_path / "out" / "mp").glob("v*"))
    assert [r.name for r in runs] == ["v0"], runs
    ckpts = sorted(runs[0].glob("checkpoint*"))
    assert [c.name for c in ckpts] == ["checkpoint-last-2"]
    assert json.loads((ckpts[0] / "state.json").read_text())["global_step"] == 2
    events = list((runs[0] / "logs").rglob("events*"))
    assert len(events) == 1, events
    data = events[0].read_bytes()
    assert b"validation/sample_0" in data and b"validation/sample_1" in data
    assert b"validation/prompt_1" in data
    fits = [json.loads((tmp_path / f"fit-{r}.json").read_text()) for r in range(2)]
    assert all(f["global_step"] == 2 and f["output_dir"] == str(runs[0]) for f in fits)
    assert fits[0]["losses"] == fits[1]["losses"] and fits[0]["lora"] == fits[1]["lora"]


def test_oom_on_one_rank_retries_on_both(tmp_path):
    """A dp = 2 fit under mesh.remat "minimal" whose forward runs out of
    device memory on rank 1 alone: the step raises on both ranks, both
    degrade to "full" and run the same batch again, and the fit equals the
    one under "full" from the start (losses and LoRA to the bit, the same
    on both ranks)."""
    img_dir = _image_folder(tmp_path)
    cfg = {
        "trainer": "FluxKontextLoraTrainer",
        "mesh": {"dp": 2, "fsdp": 1},
        "model": {"variant": "test", "lora": {"r": 2, "lora_alpha": 2}},
        "data": {"init_args": {"dataset_path": str(img_dir)},
                 "processor": {"process_type": "resize", "target_size": [32, 32]}},
        "train": {"max_train_steps": 2, "checkpointing_steps": 1000,
                  "weight_dtype": "float32", "num_epochs": 10},
        "logging": {"project": "oom"},
    }
    (tmp_path / "fit.json").write_text(json.dumps(cfg))
    _spawn("fit_oom", 2, tmp_path)
    fits = [json.loads((tmp_path / f"fit_oom-{r}.json").read_text()) for r in range(2)]
    for f in fits:
        assert f["planted"]["policy"] == f["full"]["policy"] == "full"
        assert f["planted"]["steps"] == f["full"]["steps"] == [1, 2]
        assert f["planted"]["losses"] == f["full"]["losses"] == fits[0]["full"]["losses"]
        assert f["planted"]["lora"] == f["full"]["lora"] == fits[0]["full"]["lora"]


def test_cli_distributed_on_cpu(tmp_path):
    """`python -m qflux_tpu_torch.main --distributed --device cpu` on two
    ranks with torchrun's variables (gloo): a dp = 2 fit from a cached
    folder, one run dir, its checkpoints written once."""
    import chip_smoke
    from tests.test_torch_data import GRIDS, TINY

    rng = np.random.default_rng(0)
    items = [chip_smoke.flux_cache_item(rng, TINY, gh, gw, s_txt=8) for gh, gw in GRIDS[:4]]
    data, _ = chip_smoke.write_cached_dataset(tmp_path, items, chip_smoke.FLUX_HASH_KEYS)
    raw = chip_smoke.multires_config(data, tmp_path, True, variant="test", steps=2)
    raw["mesh"] = {"dp": 2, "fsdp": 1}
    raw["train"].update(weight_dtype="float32", checkpointing_steps=1)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(raw))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {**_env(), "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "qflux_tpu_torch.main", "--config", str(path),
             "--distributed", "--device", "cpu"], cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    runs = sorted((tmp_path / "flux_multires").glob("v*"))
    assert [r.name for r in runs] == ["v0"]
    assert sorted(c.name for c in runs[0].glob("checkpoint*")) == [
        "checkpoint-1", "checkpoint-2", "checkpoint-last-2"]
    assert len(list((runs[0] / "logs").glob("events*"))) == 1
