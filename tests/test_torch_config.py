"""The port's config loader (qflux_tpu_torch/config.py) refuses what the JAX
package's pydantic `Config` refuses by its schema: its table of sections,
keys and Literal choices (`SCHEMA`) equals `Config.model_fields` walked
recursively, every config file in configs/ loads in both packages, and
every dict of a list of bad ones raises in both."""

from __future__ import annotations

import enum
import glob
import typing

import pydantic
import pytest

from qflux_tpu import config as jconfig
from qflux_tpu_torch import config as tconfig

CONFIGS = sorted(glob.glob("configs/*.yaml"))


def _kind(annotation):
    """A field's entry in the port's table: a section's own table, a
    Literal's or an enum's choices, or None."""
    if isinstance(annotation, type) and issubclass(annotation, pydantic.BaseModel):
        return _table(annotation)
    if isinstance(annotation, type) and issubclass(annotation, enum.Enum):
        return tuple(m.value for m in annotation)
    origin, args = typing.get_origin(annotation), typing.get_args(annotation)
    if origin is typing.Literal:
        return args
    if origin is typing.Union:
        models = [a for a in args if isinstance(a, type) and issubclass(a, pydantic.BaseModel)]
        if models:
            return _table(models[0])
    return None


def _table(model) -> dict:
    return {name: _kind(field.annotation) for name, field in model.model_fields.items()}


def _bool_sections(model, path=()) -> set:
    out = set()
    for name, field in model.model_fields.items():
        args = typing.get_args(field.annotation)
        if bool in args and any(isinstance(a, type) and issubclass(a, pydantic.BaseModel)
                                for a in args):
            out.add(path + (name,))
        if isinstance(field.annotation, type) and issubclass(field.annotation, pydantic.BaseModel):
            out |= _bool_sections(field.annotation, path + (name,))
    return out


def test_schema_equals_jax_model_fields():
    assert tconfig.SCHEMA == _table(jconfig.Config)
    assert tconfig._BOOL_SECTIONS == _bool_sections(jconfig.Config)
    allowed = jconfig.ValidationSection(samples=[{k: None for k in tconfig._SAMPLE_KEYS}])
    assert allowed.samples


def test_defaults_lie_inside_the_schema():
    """Every key the port fills in by default is one JAX's schema has, so a
    config the port writes back (`config_to_dict`) loads again."""
    cfg = tconfig.config_from_dict({})
    tconfig.check_schema(tconfig.config_to_dict(cfg))


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_loads_in_both(path):
    jcfg = jconfig.load_config_from_yaml(path)
    tcfg = tconfig.load_config_from_yaml(path)
    assert tcfg.trainer.value == jcfg.trainer.value
    assert tcfg.mesh.remat == jcfg.mesh.remat
    assert tcfg.train.weight_dtype == jcfg.train.weight_dtype


BAD = [
    ("unknown train key", {"train": {"max_grad_nrom": 0.5}}),
    ("timestep_sampling", {"train": {"timestep_sampling": "unifrom"}}),
    ("weight_dtype", {"train": {"weight_dtype": "float16"}}),
    ("remat", {"mesh": {"remat": "flashh"}}),
    ("unknown top-level key", {"trainr": "FluxKontextLoraTrainer"}),
    ("unknown section key", {"model": {"lora": {"rank": 8}}}),
    ("quantize dtype", {"model": {"quantize": {"enabled": True, "dtype": "int3"}}}),
    ("quantize key", {"model": {"quantize": {"enabled": True, "bits": 4}}}),
    ("scheduler_type", {"lr_scheduler": {"scheduler_type": "cosin"}}),
    ("weighting_scheme", {"train": {"weighting_scheme": "bel"}}),
    ("report_to", {"logging": {"report_to": "tensorbord"}}),
    ("process_type", {"data": {"processor": {"process_type": "crop"}}}),
    ("trainer", {"trainer": "FluxTrainer"}),
    ("mode", {"mode": "train"}),
    ("section as a list", {"train": [1, 2]}),
    ("section as null", {"mesh": None}),
    ("a Literal given a bool", {"train": {"weight_dtype": True}}),
    ("validation sample key", {"validation": {"samples": [{"prompt": "p", "control": "x"}]}}),
]


@pytest.mark.parametrize("what,raw", BAD, ids=[b[0] for b in BAD])
def test_bad_dicts_raise_in_both(what, raw):
    with pytest.raises(ValueError):
        jconfig.Config.model_validate(raw)
    with pytest.raises(ValueError, match="config: "):
        tconfig.config_from_dict(raw)


GOOD = [
    {"model": {"quantize": True}},
    {"model": {"quantize": {"enabled": True, "dtype": "int4_requant", "attention": True}}},
    {"mesh": {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1, "dcn_axes": [], "remat": "flash_offload"}},
    {"train": {"auto_entry_layouts": False, "timestep_sampling": "weighted"}},
    {"optimizer": {"init_args": {"anything": 1, "nested": {"free": True}}}},
    {"data": {"init_args": {"csv_path": "x.csv", "extra": 1},
              "processor": {"multi_resolutions": {"target": [[512, 512]], "x": 1}}}},
    {"validation": {"dataset": {"class_path": "a.b", "init_args": {"z": 1}},
                    "samples": [{"prompt": "p", "images": [], "height": 64, "width": 64}]}},
]


@pytest.mark.parametrize("raw", GOOD)
def test_good_dicts_load_in_both(raw):
    jconfig.Config.model_validate(raw)
    tconfig.config_from_dict(raw)


def test_error_names_the_key_and_the_choices():
    with pytest.raises(ValueError, match=r"unknown train\.weight_dtype 'float16'; "
                                         r"train\.weight_dtype is one of \['bfloat16', 'float32'\]"):
        tconfig.config_from_dict({"train": {"weight_dtype": "float16"}})
    with pytest.raises(ValueError, match=r"unknown key 'train\.max_grad_nrom'.*'max_grad_norm'"):
        tconfig.config_from_dict({"train": {"max_grad_nrom": 0.5}})
