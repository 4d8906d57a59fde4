"""The train state of a checkpoint: AdamW's moments in the JAX package's
file, and the port's noise generator.

The JAX trainer writes optax.adamw's state as `optimizer_state.npz`
(qflux_tpu/trainer/base.py:save_checkpoint), one array per leaf of the
state tree, keyed by the leaf's path joined with "/":

    0/count                     int32 []      updates so far (ScaleByAdamState)
    0/mu/<lora path>/{a,b,scaling}            first moments
    0/nu/<lora path>/{a,b,scaling}            second moments
    2/count                     int32 []      the lr schedule's count (only
                                              when the lr is a schedule)

where <lora path> is the JAX LoRA tree's ("dual/attn/to_q",
"blocks/img_mlp/in") and block leaves are stacked [L, …].  The port's
`torch.optim.AdamW` keeps `step` / `exp_avg` / `exp_avg_sq` per tensor of
its flat LoRA tree; these functions map one onto the other.  The scaling
leaves are differentiated but never stepped: JAX keeps moments for them,
the port has none, so the port writes zeros there and ignores them on
reading.

The port's noise comes from one stateful `torch.Generator` (JAX folds the
step into a fixed key), so a checkpoint also holds the generator's state
as a uint8 `generator_state.npy`, which the JAX loader does not read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from qflux_tpu_torch.utils.lora_io import jax_location

OPTIMIZER_FILE = "optimizer_state.npz"
GENERATOR_FILE = "generator_state.npy"
STATE_FILE = "state.json"


def _stacks(lora: Mapping) -> dict[tuple, dict[Optional[int], dict]]:
    """The port's flat LoRA tree grouped as the JAX tree stacks it:
    {JAX path: {layer (None for a top-level module): leaf}}."""
    grouped: dict[tuple, dict] = {}
    for path, leaf in lora.items():
        jpath, layer = jax_location(path)
        grouped.setdefault(jpath, {})[layer] = leaf
    for jpath, by_layer in grouped.items():
        if None not in by_layer and sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"LoRA layers of {'/'.join(jpath)} are not 0..L-1: "
                             f"{sorted(by_layer)}")
    return grouped


def adamw_state_arrays(lora: Mapping, optimizer: torch.optim.Optimizer, count: int,
                       schedule_count: bool) -> dict[str, np.ndarray]:
    """{key: array} of optax.adamw's state as the JAX trainer writes it,
    from the AdamW over `lora`'s a / b tensors (a tensor with no state yet
    has zero moments).  `schedule_count`: whether the lr is a schedule
    (optax then keeps its count too)."""
    out = {"0/count": np.asarray(count, np.int32)}
    for jpath, by_layer in _stacks(lora).items():
        layers = [None] if None in by_layer else sorted(by_layer)
        prefix = "/".join(jpath)
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for name in ("a", "b"):
                arrs = []
                for layer in layers:
                    p = by_layer[layer][name]
                    t = optimizer.state.get(p, {}).get(key)
                    arrs.append(np.zeros(tuple(p.shape), np.float32) if t is None
                                else t.detach().to("cpu", torch.float32).numpy())
                out[f"0/{moment}/{prefix}/{name}"] = (arrs[0] if layers == [None]
                                                      else np.stack(arrs))
            out[f"0/{moment}/{prefix}/scaling"] = np.zeros(
                () if layers == [None] else (len(layers),), np.float32)
    if schedule_count:
        out["2/count"] = np.asarray(count, np.int32)
    return out


def restore_adamw_state(arrays: Mapping[str, np.ndarray], lora: Mapping,
                        optimizer: torch.optim.Optimizer) -> int:
    """Set the AdamW state over `lora`'s a / b tensors from the JAX
    layout's arrays (a key that is missing leaves that tensor's moments at
    zero, as the JAX loader keeps the fresh leaf); the scaling moments are
    ignored.  Returns the update count ("0/count", 0 if absent)."""
    from torch.optim.optimizer import _get_scalar_dtype

    count = int(arrays["0/count"]) if "0/count" in arrays else 0
    for jpath, by_layer in _stacks(lora).items():
        prefix = "/".join(jpath)
        for layer, leaf in by_layer.items():
            for name in ("a", "b"):
                p = leaf[name]
                state = {"step": torch.tensor(float(count), dtype=_get_scalar_dtype())}
                for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                    arr = arrays.get(f"0/{moment}/{prefix}/{name}")
                    if arr is not None and layer is not None:
                        arr = arr[layer]
                    state[key] = (torch.zeros_like(p, memory_format=torch.preserve_format)
                                  if arr is None else
                                  torch.as_tensor(np.asarray(arr)).to(p.device, p.dtype))
                optimizer.state[p] = state
    return count


def save_train_state(ckpt_dir, lora: Mapping, optimizer: torch.optim.Optimizer, count: int,
                     schedule_count: bool, generator: torch.Generator) -> None:
    ckpt_dir = Path(ckpt_dir)
    np.savez(ckpt_dir / OPTIMIZER_FILE,
             **adamw_state_arrays(lora, optimizer, count, schedule_count))
    np.save(ckpt_dir / GENERATOR_FILE, generator.get_state().numpy())


def load_generator_state(ckpt_dir, generator: torch.Generator) -> None:
    """Restore the generator from a checkpoint that holds its state (one the
    JAX package wrote does not: the generator then keeps its seed)."""
    path = Path(ckpt_dir) / GENERATOR_FILE
    if path.exists():
        generator.set_state(torch.from_numpy(np.load(path)))
