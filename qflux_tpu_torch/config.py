"""The port's configuration: a YAML or JSON file (or a dict) → plain namespaces.

Counterpart of qflux_tpu/config.py.  The JAX package validates its YAML
with pydantic; the port merges the file over the JAX `Config`'s defaults
and returns nested `SimpleNamespace`s, read by attribute exactly as the
JAX `Config` is (`config.model.lora.r`, `config.trainer.value`,
`config.data.processor.target_size`).  Before that it refuses what the JAX
`Config` refuses by its schema (`SCHEMA`, a table of every section's keys
and every `Literal`'s choices, kept here because the port imports no
pydantic): a key no section of that schema has, a value outside a
`Literal` or enum, a section given as something other than a mapping, and a
validation sample with keys other than prompt / images / height / width.
Keys that JAX accepts and the port does not read (`mesh.dcn_axes`,
`train.auto_entry_layouts`, …) are carried over as they are; the values of
the dict-valued fields (`_DICT_FIELDS`) are free.  The defaults below are
those of qflux_tpu/config.py for every field the port reads.  Its
validators are mirrored:

  * `${a.b}` references resolve against the file's own document before
    anything else (`resolve_interpolations`; a whole-string reference
    keeps the referenced value's type);
  * a bare bool `model.quantize` becomes `{enabled: <bool>}`
    (`ModelSection._coerce_quant`);
  * `train.timestep_sampling: weighted` with `weighting_scheme: none`
    turns the scheme to "weighted", and `train.low_memory` the "flash*"
    remat policies to "full";
  * pixel budgets such as "512*512" become ints (`parse_pixels`, in
    data.processor.target_pixels / controls_pixels);
  * `cache.use_cache` with a `cache_dir` puts both into data.init_args
    where those keys are absent (`Config._wire_cache_into_data`).

`yaml` is imported inside `load_config_from_yaml` only, and a file in JSON
syntax (a subset of YAML) loads with the stdlib `json` where PyYAML is
absent: that is how configs are read on a machine without it.
"""

from __future__ import annotations

import ast
import copy
import json
import re
from types import SimpleNamespace
from typing import Any, Mapping, Optional, Union

# qflux_tpu/config.py's defaults for the fields the port reads
DEFAULTS: dict = {
    "trainer": "FluxKontextLoraTrainer",
    "mode": "fit",
    "resume": None,
    "mesh": {"dp": 1, "fsdp": -1, "tp": 1, "sp": 1, "dcn_axes": [], "remat": "flash"},
    "model": {
        "pretrained_model_name_or_path": None,
        "dit_path": None,
        "vae_path": None,
        "text_encoder_path": None,
        "text_encoder_2_path": None,
        "tokenizer_path": None,
        "variant": "full",
        "lora": {"r": 16, "lora_alpha": 16, "init_lora_weights": "gaussian",
                 "target_modules": ["to_q", "to_k", "to_v", "to_out",
                                    "add_q", "add_k", "add_v", "add_out"],
                 "pretrained_weight": None},
        "quantize": False,
        "pretrained_embeddings": None,
        "use_vlm_prompt_enhancer": False,
        "vlm_path": None,
    },
    "train": {"gradient_accumulation_steps": 1, "max_train_steps": 1000, "num_epochs": 10000,
              "checkpointing_steps": 500, "async_checkpointing": False, "max_grad_norm": 1.0, "timestep_sampling": "uniform", "logit_mean": 0.0,
              "logit_std": 1.0, "weighting_scheme": "none", "weighting_table": None,
              "seed": 1234, "weight_dtype": "bfloat16", "low_memory": False},
    "optimizer": {"class_path": "optax.adamw",
                  "init_args": {"b1": 0.9, "b2": 0.999, "weight_decay": 1e-2},
                  "learning_rate": 1e-4},
    "lr_scheduler": {"scheduler_type": "constant", "warmup_steps": 0},
    "data": {"class_path": "qflux_tpu.data.dataset.ImageDataset", "init_args": {},
             "processor": {"process_type": "resize", "resize_mode": "bilinear",
                           "target_size": None, "controls_size": None, "target_pixels": None,
                           "controls_pixels": None, "multi_resolutions": None,
                           "max_aspect_ratio": 4.0, "divisible_by": 16},
             "batch_size": 1, "shuffle": True, "drop_last": True, "num_workers": 0,
             "caption_dropout_rate": 0.0, "use_edit_mask": False, "bucket_by_shape": True},
    "cache": {"use_cache": False, "cache_dir": None},
    "validation": {"enabled": False, "steps": 500, "num_inference_steps": 20,
                   "true_cfg_scale": 1.0, "guidance": 2.5, "samples": [], "dataset": None,
                   "max_samples": 4, "fail_on_error": True},
    "logging": {"output_dir": "output", "project": "qflux_tpu", "report_to": "tensorboard",
                "tracker_project_name": None, "sampling_seed": 42, "profile_dir": None,
                "push_to_hub": None},
    "predict": {"num_inference_steps": 20, "guidance": 2.5, "true_cfg_scale": 1.0,
                "max_sequence_length": 512},
    "loss": {"class_path": "qflux_tpu.losses.MseLoss", "init_args": {}},
}

# QuantizeSection's defaults (qflux_tpu/config.py:159-170)
QUANTIZE_DEFAULTS: dict = {"enabled": False, "dtype": "int8", "group_size": 128,
                           "attention": False, "skip_patterns": [r".*norm.*", r".*embed.*"]}

# dict-valued fields: their value is kept as a dict, not turned into a namespace
_DICT_FIELDS = {("optimizer", "init_args"), ("loss", "init_args"), ("data", "init_args"),
                ("data", "processor", "multi_resolutions"), ("validation", "dataset")}

_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")

# qflux_tpu/config.py's Config schema, section by section: a dict is a
# section (a StrictModel: no other keys), a tuple a Literal's (or an enum's)
# choices, None a value the schema types otherwise (the port leaves those to
# the code that reads them)
_REMAT = ("none", "minimal", "full", "flash", "flash_mlp", "flash_single", "flash_offload")
_QUANT_DTYPES = ("int8", "int8_dynamic", "int4", "int4_dynamic", "int4_requant", "fp8_e4m3",
                 "fp8_e5m2")
SCHEMA: dict = {
    "trainer": ("FluxKontextLoraTrainer", "QwenImageEditTrainer", "QwenImageEditPlusTrainer",
                "DreamOmni2Trainer", "Flux2KleinLoraTrainer"),
    "mode": ("fit", "cache", "predict"),
    "resume": None,
    "mesh": {"dp": None, "fsdp": None, "tp": None, "sp": None, "dcn_axes": None,
             "remat": _REMAT},
    "model": {
        "pretrained_model_name_or_path": None, "dit_path": None, "vae_path": None,
        "text_encoder_path": None, "text_encoder_2_path": None, "tokenizer_path": None,
        "lora": {"r": None, "lora_alpha": None, "init_lora_weights": None,
                 "target_modules": None, "pretrained_weight": None},
        "quantize": {"enabled": None, "dtype": _QUANT_DTYPES, "group_size": None,
                     "attention": None, "skip_patterns": None},
        "pretrained_embeddings": None, "use_vlm_prompt_enhancer": None, "vlm_path": None,
        "variant": None},
    "data": {"class_path": None, "init_args": None,
             "processor": {"process_type": ("resize", "center_crop", "center_padding",
                                            "right_padding", "fixed_pixels"),
                           "resize_mode": None, "target_size": None, "controls_size": None,
                           "target_pixels": None, "controls_pixels": None,
                           "multi_resolutions": None, "max_aspect_ratio": None,
                           "divisible_by": None},
             "batch_size": None, "shuffle": None, "drop_last": None, "num_workers": None,
             "caption_dropout_rate": None, "use_edit_mask": None, "bucket_by_shape": None},
    "cache": {"use_cache": None, "cache_dir": None},
    "train": {"gradient_accumulation_steps": None, "max_train_steps": None, "num_epochs": None,
              "checkpointing_steps": None, "max_grad_norm": None,
              "timestep_sampling": ("uniform", "logit_normal", "shift", "weighted"),
              "logit_mean": None, "logit_std": None,
              "weighting_scheme": ("none", "bell", "half_bell", "weighted"),
              "weighting_table": None, "seed": None, "weight_dtype": ("bfloat16", "float32"),
              "low_memory": None, "async_checkpointing": None, "auto_entry_layouts": None},
    "optimizer": {"class_path": None, "init_args": None, "learning_rate": None},
    "lr_scheduler": {"scheduler_type": ("constant", "cosine", "linear", "constant_with_warmup"),
                     "warmup_steps": None},
    "validation": {"enabled": None, "steps": None, "num_inference_steps": None,
                   "true_cfg_scale": None, "guidance": None, "samples": None, "dataset": None,
                   "max_samples": None, "fail_on_error": None},
    "logging": {"output_dir": None, "project": None,
                "report_to": ("tensorboard", "wandb", "swanlab", "none"),
                "tracker_project_name": None, "sampling_seed": None, "profile_dir": None,
                "push_to_hub": None},
    "predict": {"num_inference_steps": None, "guidance": None, "true_cfg_scale": None,
                "max_sequence_length": None},
    "loss": {"class_path": None, "init_args": None},
}
# sections that may also be given as a bare bool (ModelSection.quantize)
_BOOL_SECTIONS = {("model", "quantize")}
# ValidationSection._check_sample_keys
_SAMPLE_KEYS = ("height", "images", "prompt", "width")


def check_schema(raw: Mapping, schema: Mapping = SCHEMA, path: tuple = ()) -> None:
    """Refuse what qflux_tpu/config.py's Config refuses by its schema (see
    the module docstring); ValueError naming the key and what it allows."""
    for key, val in raw.items():
        where = ".".join(path + (str(key),))
        if key not in schema:
            raise ValueError(f"config: unknown key {where!r}; "
                             f"{'.'.join(path) or 'the top level'} takes {sorted(schema)}")
        rule = schema[key]
        if isinstance(rule, dict):
            if isinstance(val, bool) and path + (key,) in _BOOL_SECTIONS:
                continue
            if not isinstance(val, Mapping):
                raise ValueError(f"config: {where} must be a mapping of {sorted(rule)}, "
                                 f"got {val!r}")
            check_schema(val, rule, path + (key,))
        elif isinstance(rule, tuple) and not any(val == c and type(val) is type(c)
                                                 for c in rule):
            raise ValueError(f"config: unknown {where} {val!r}; {where} is one of {list(rule)}")
    for i, sample in enumerate((raw.get("samples") or []) if path == ("validation",) else []):
        unknown = sorted(set(sample) - set(_SAMPLE_KEYS)) if isinstance(sample, Mapping) else []
        if unknown:
            raise ValueError(f"config: validation.samples[{i}]: unknown keys {unknown}; "
                             f"allowed keys are {list(_SAMPLE_KEYS)}")


def _lookup(tree: Any, dotted: str) -> Any:
    node = tree
    for part in dotted.split("."):
        if isinstance(node, dict):
            node = node[part]
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            raise KeyError(dotted)
    return node


def resolve_interpolations(tree: Any) -> Any:
    """Resolve ${a.b.c} references against the document root, as
    qflux_tpu/config.py:resolve_interpolations (omegaconf-style): a
    whole-string reference keeps the referenced value's type, one inside a
    longer string is substituted as text; a cycle raises ValueError."""

    def resolve(node: Any, seen: tuple[str, ...] = ()) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v, seen) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, seen) for v in node]
        if isinstance(node, str):
            def ref(key):
                if key in seen:
                    raise ValueError(f"circular interpolation: {' -> '.join(seen + (key,))}")
                return resolve(_lookup(tree, key), seen + (key,))

            m = _INTERP.fullmatch(node)
            if m:
                return ref(m.group(1))
            return _INTERP.sub(lambda mm: str(ref(mm.group(1))), node)
        return node

    return resolve(tree)


_PIXEL_OPS = {ast.Mult: lambda a, b: a * b, ast.Add: lambda a, b: a + b,
              ast.Sub: lambda a, b: a - b, ast.FloorDiv: lambda a, b: a // b,
              ast.Div: lambda a, b: a / b, ast.Pow: lambda a, b: a ** b}


def parse_pixels(value: Union[int, str, None]) -> Optional[int]:
    """Pixel budgets: 262144 or "512*512" (arithmetic on numbers only)."""
    if value is None or isinstance(value, int):
        return value

    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return n.value
        if isinstance(n, ast.BinOp) and type(n.op) in _PIXEL_OPS:
            return _PIXEL_OPS[type(n.op)](ev(n.left), ev(n.right))
        raise ValueError(f"unsupported pixel expression: {value!r}")

    return int(ev(ast.parse(str(value), mode="eval").body))


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
    """A config dict (as a YAML file holds it), checked against `SCHEMA` and
    merged over the JAX defaults → namespaces.  `trainer` becomes
    `trainer.value`, as the JAX enum."""
    check_schema(raw or {})
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
    proc = tree["data"]["processor"]
    proc["target_pixels"] = parse_pixels(proc["target_pixels"])
    if proc["controls_pixels"] is not None:
        proc["controls_pixels"] = [parse_pixels(x) for x in proc["controls_pixels"]]
    if tree["cache"]["use_cache"] and tree["cache"]["cache_dir"]:
        tree["data"]["init_args"].setdefault("cache_dir", tree["cache"]["cache_dir"])
        tree["data"]["init_args"].setdefault("use_cache", True)
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
    """Read a config file of the JAX package's format: YAML through `yaml`
    (imported here, not at module import), or, where PyYAML is absent, a
    file in JSON syntax through `json`.  Interpolations resolve first."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        raw = json.loads(text)
    else:
        raw = yaml.safe_load(text)
    return config_from_dict(resolve_interpolations(raw or {}))
