"""The port's configuration: a YAML file (or a dict) → plain namespaces.

Counterpart of qflux_tpu/config.py for the fields the port reads.  The JAX
package validates its YAML with pydantic; the port only needs the values, so
it merges the file over the JAX `Config`'s defaults and returns nested
`SimpleNamespace`s, read by attribute exactly as the JAX `Config` is
(`config.model.lora.r`, `config.trainer.value`).  Sections and keys the port
does not read are carried over as they are; the defaults below are those of
qflux_tpu/config.py for every field the port reads, and two of its
validators are mirrored: a bare bool `model.quantize` becomes
`{enabled: <bool>}` (`ModelSection._coerce_quant`), and
`train.timestep_sampling: weighted` with `weighting_scheme: none` turns the
scheme to "weighted" (`TrainSection._weighted_sampling_implies_weighting`),
as does `train.low_memory` the "flash*" remat policies to "full"
(`Config._low_memory_remat`).

`yaml` is imported inside `load_config_from_yaml` only: a machine without
PyYAML builds the same namespaces with `config_from_dict`.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Any, Mapping

# qflux_tpu/config.py's defaults for the fields the port reads
DEFAULTS: dict = {
    "trainer": "FluxKontextLoraTrainer",
    "resume": None,
    "mesh": {"remat": "flash"},
    "model": {
        "pretrained_model_name_or_path": None,
        "dit_path": None,
        "vae_path": None,
        "variant": "full",
        "lora": {"r": 16, "lora_alpha": 16, "init_lora_weights": "gaussian",
                 "target_modules": ["to_q", "to_k", "to_v", "to_out",
                                    "add_q", "add_k", "add_v", "add_out"],
                 "pretrained_weight": None},
        "quantize": False,
    },
    "train": {"gradient_accumulation_steps": 1, "max_train_steps": 1000, "num_epochs": 10000,
              "checkpointing_steps": 500, "async_checkpointing": False, "max_grad_norm": 1.0, "timestep_sampling": "uniform", "logit_mean": 0.0,
              "logit_std": 1.0, "weighting_scheme": "none", "weighting_table": None,
              "seed": 1234, "weight_dtype": "bfloat16", "low_memory": False},
    "optimizer": {"class_path": "optax.adamw",
                  "init_args": {"b1": 0.9, "b2": 0.999, "weight_decay": 1e-2},
                  "learning_rate": 1e-4},
    "lr_scheduler": {"scheduler_type": "constant", "warmup_steps": 0},
    "logging": {"output_dir": "output", "project": "qflux_tpu", "sampling_seed": 42,
                "push_to_hub": None},
    "predict": {"num_inference_steps": 20, "guidance": 2.5, "true_cfg_scale": 1.0,
                "max_sequence_length": 512},
    "loss": {"class_path": "qflux_tpu.losses.MseLoss", "init_args": {}},
}

# QuantizeSection's defaults (qflux_tpu/config.py:159-170)
QUANTIZE_DEFAULTS: dict = {"enabled": False, "dtype": "int8", "group_size": 128,
                           "attention": False, "skip_patterns": [r".*norm.*", r".*embed.*"]}

# dict-valued fields: their value is kept as a dict, not turned into a namespace
_DICT_FIELDS = {("optimizer", "init_args"), ("loss", "init_args")}


def _merge(base: dict, over: Mapping, path: tuple = ()) -> dict:
    out = copy.deepcopy(base)
    for key, val in over.items():
        if (isinstance(val, Mapping) and isinstance(out.get(key), Mapping)
                and path + (key,) not in _DICT_FIELDS):
            out[key] = _merge(out[key], val, path + (key,))
        else:
            out[key] = copy.deepcopy(val)
    return out


def _namespace(node: Any, path: tuple = ()) -> Any:
    if isinstance(node, Mapping) and path not in _DICT_FIELDS:
        return SimpleNamespace(**{k: _namespace(v, path + (k,)) for k, v in node.items()})
    return node


def config_from_dict(raw: Mapping) -> SimpleNamespace:
    """A config dict (as a YAML file holds it) merged over the JAX defaults
    → namespaces.  `trainer` becomes `trainer.value`, as the JAX enum."""
    tree = _merge(DEFAULTS, raw or {})
    qz = tree["model"]["quantize"]
    if isinstance(qz, bool) or qz is None:
        qz = {"enabled": bool(qz)}
    tree["model"]["quantize"] = _merge(QUANTIZE_DEFAULTS, qz)
    train = tree["train"]
    if train["timestep_sampling"] == "weighted" and train["weighting_scheme"] == "none":
        train["weighting_scheme"] = "weighted"
    if train["low_memory"] and tree["mesh"]["remat"] in ("flash", "flash_mlp", "flash_single"):
        tree["mesh"]["remat"] = "full"
    trainer = tree.pop("trainer")
    cfg = _namespace(tree)
    cfg.trainer = SimpleNamespace(value=trainer)
    return cfg


def config_to_dict(cfg: SimpleNamespace) -> dict:
    """The inverse of `config_from_dict`: namespaces → plain dicts (what
    `Trainer.fit` writes as train_config.yaml, in JSON, which YAML reads)."""
    def rec(node):
        if isinstance(node, SimpleNamespace):
            return {k: rec(v) for k, v in vars(node).items()}
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return node

    out = rec(cfg)
    out["trainer"] = cfg.trainer.value
    return out


def load_config_from_yaml(path) -> SimpleNamespace:
    """Read a YAML config file of the JAX package's format (imports `yaml`
    here, not at module import)."""
    import yaml

    with open(path) as f:
        return config_from_dict(yaml.safe_load(f))
