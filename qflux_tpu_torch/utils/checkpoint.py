"""The train state of a checkpoint: the optimizer's moments in the JAX
package's file, and the port's noise generator.

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

`adamw8bit` (qflux_tpu/ops/adam8bit.py, the port's ops/adam8bit.py) keeps
its moments as fp8 codes and block scales over each JAX leaf flattened, a
stacked leaf across its layers:

    0/count                                   int32 []
    0/moments/<lora path>/{a,b,scaling}/{m,v}/q      float8_e4m3fn codes,
                                              [n_blocks · block_size]
    0/moments/<lora path>/{a,b,scaling}/{m,v}/scale  f32 [n_blocks]
    2/count                                   (as adamw's)

`np.savez` writes JAX's float8 codes as raw bytes (`|V1`); the port reads
and writes them so, as bytes viewed as float8_e4m3fn.  The scaling leaves'
moments are written as quantized zeros (what JAX's `init` holds) and
ignored on reading, as adamw's.

The port's noise comes from one stateful `torch.Generator` (JAX folds the
step into a fixed key), so a checkpoint also holds the generator's state
as a uint8 `generator_state.npy`, which the JAX loader does not read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from qflux_tpu_torch.ops.adam8bit import AdamW8bit, quantize
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


def lora_stacks(lora: Mapping) -> list[list[torch.Tensor]]:
    """The a / b tensors of `lora` grouped as the JAX tree stacks them (one
    list per JAX leaf, in layer order): `AdamW8bit`'s `stacks`."""
    out = []
    for by_layer in _stacks(lora).values():
        layers = [None] if None in by_layer else sorted(by_layer)
        out += [[by_layer[layer][name] for layer in layers] for name in ("a", "b")]
    return out


def _codes_to_npz(q: torch.Tensor) -> np.ndarray:
    return q.detach().view(torch.uint8).cpu().numpy().view(np.dtype("V1"))


def _codes_from_npz(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).view(np.uint8)
    return torch.from_numpy(arr.copy()).to(device).view(torch.float8_e4m3fn)


def adam8bit_state_arrays(lora: Mapping, optimizer: AdamW8bit, count: int,
                          schedule_count: bool) -> dict[str, np.ndarray]:
    """{key: array} of `adamw8bit`'s state as the JAX trainer writes it,
    from the AdamW8bit over `lora_stacks(lora)` (a stack with no state yet
    has quantized zeros)."""
    bs = optimizer.param_groups[0]["block_size"]
    out = {"0/count": np.asarray(count, np.int32)}
    for jpath, by_layer in _stacks(lora).items():
        layers = [None] if None in by_layer else sorted(by_layer)
        prefix = "0/moments/" + "/".join(jpath)
        for name in ("a", "b"):
            stack = [by_layer[layer][name] for layer in layers]
            state = optimizer.state.get(stack[0]) or optimizer.init_state(stack)
            for moment in ("m", "v"):
                q, scale = state[moment]
                out[f"{prefix}/{name}/{moment}/q"] = _codes_to_npz(q)
                out[f"{prefix}/{name}/{moment}/scale"] = scale.detach().cpu().numpy()
        q, scale = quantize(torch.zeros(len(layers)), bs)
        for moment in ("m", "v"):
            out[f"{prefix}/scaling/{moment}/q"] = _codes_to_npz(q)
            out[f"{prefix}/scaling/{moment}/scale"] = scale.numpy()
    if schedule_count:
        out["2/count"] = np.asarray(count, np.int32)
    return out


def restore_adam8bit_state(arrays: Mapping[str, np.ndarray], lora: Mapping,
                           optimizer: AdamW8bit) -> int:
    """Set the AdamW8bit state over `lora_stacks(lora)` from the JAX layout's
    arrays (a stack whose keys are missing keeps quantized zeros); the
    scaling moments are ignored.  Returns the update count."""
    count = int(arrays["0/count"]) if "0/count" in arrays else 0
    for jpath, by_layer in _stacks(lora).items():
        layers = [None] if None in by_layer else sorted(by_layer)
        prefix = "0/moments/" + "/".join(jpath)
        for name in ("a", "b"):
            stack = [by_layer[layer][name] for layer in layers]
            state = optimizer.init_state(stack)
            state["count"] = count
            dev = stack[0].device
            for moment in ("m", "v"):
                q = arrays.get(f"{prefix}/{name}/{moment}/q")
                if q is not None:
                    scale = np.asarray(arrays[f"{prefix}/{name}/{moment}/scale"], np.float32)
                    state[moment] = (_codes_from_npz(q, dev), torch.from_numpy(scale).to(dev))
            optimizer.state[stack[0]] = state
    return count


def optimizer_state_arrays(lora: Mapping, optimizer: torch.optim.Optimizer, count: int,
                           schedule_count: bool) -> dict[str, np.ndarray]:
    """The optimizer's state in the JAX trainer's keys, adamw's or
    adamw8bit's."""
    if isinstance(optimizer, AdamW8bit):
        return adam8bit_state_arrays(lora, optimizer, count, schedule_count)
    return adamw_state_arrays(lora, optimizer, count, schedule_count)


def restore_optimizer_state(arrays: Mapping[str, np.ndarray], lora: Mapping,
                            optimizer: torch.optim.Optimizer) -> int:
    if isinstance(optimizer, AdamW8bit):
        return restore_adam8bit_state(arrays, lora, optimizer)
    return restore_adamw_state(arrays, lora, optimizer)


def save_train_state(ckpt_dir, lora: Mapping, optimizer: torch.optim.Optimizer, count: int,
                     schedule_count: bool, generator: torch.Generator) -> None:
    ckpt_dir = Path(ckpt_dir)
    np.savez(ckpt_dir / OPTIMIZER_FILE,
             **optimizer_state_arrays(lora, optimizer, count, schedule_count))
    np.save(ckpt_dir / GENERATOR_FILE, generator.get_state().numpy())


def load_generator_state(ckpt_dir, generator: torch.Generator) -> None:
    """Restore the generator from a checkpoint that holds its state (one the
    JAX package wrote does not: the generator then keeps its seed)."""
    path = Path(ckpt_dir) / GENERATOR_FILE
    if path.exists():
        generator.set_state(torch.from_numpy(np.load(path)))
