"""class_path / init_args instantiation for the sections that name a class:
data.class_path and validation.dataset.class_path.

Counterpart of qflux_tpu/utils/instantiate.py.  Configs carry the JAX
package's class paths; the port maps each one it has ported to its own
class (the pattern of trainer/base.py:CRITERIA for loss.class_path) and
refuses any other, since importing a module of the JAX package is not an
option for the port.
"""

from __future__ import annotations

import importlib
from typing import Any

# a config's class path → the port's class, as "module:attribute"
CLASSES = {
    "qflux_tpu.data.dataset.ImageDataset": "qflux_tpu_torch.data.dataset:ImageDataset",
    "qflux_tpu_torch.data.dataset.ImageDataset": "qflux_tpu_torch.data.dataset:ImageDataset",
}


def resolve_symbol(class_path: str) -> Any:
    """The port's class for a config's class path; NotImplementedError for
    one the port has not ported."""
    if class_path not in CLASSES:
        raise NotImplementedError(
            f"class_path {class_path!r} is not ported (ported: {sorted(CLASSES)})")
    module_name, attr = CLASSES[class_path].split(":")
    return getattr(importlib.import_module(module_name), attr)


def instantiate_class(class_path: str, *args, **kwargs) -> Any:
    return resolve_symbol(class_path)(*args, **kwargs)
