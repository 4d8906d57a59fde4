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
"blocks/img_mlp/in") and block leaves are stacked [L, …].  Every optax
optimizer of the port (trainer/optimizers.py) keeps its moments per tensor
of the flat LoRA tree and names, in its `optax_layout`, where each sits in
optax's state tree: adam's mu / nu as above ("1/count" for the schedule,
no decay step in its chain), lion's "0/mu", sgd's "0/trace" (no count of
its own), prodigy's unchained "exp_avg", "exp_avg_sq", "grad_sum",
"params0", "estim_lr", "numerator_weighted" and "count"; these functions
map one onto the other.  The scaling leaves are differentiated but never
stepped: JAX keeps moments for them, the elementwise optimizers hold none,
so the port writes optax's zeros there and ignores them on reading;
Prodigy, whose sums run over the whole tree, holds them.  A bf16 moment
(`mu_dtype`) is written as raw bytes (`|V2`), as `np.savez` writes JAX's.
The npz's members carry a fixed date (`save_npz`), so a file's bytes
depend on its arrays alone.

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

import logging
import threading
import zipfile
from pathlib import Path
from typing import Callable, Mapping, Optional

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


def _host(t) -> np.ndarray:
    """A tensor (on any device) or array → numpy, as `np.savez` writes JAX's:
    bf16 as its raw bytes (`|V2`), float8 as `|V1`."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(np.dtype("V1"))
    return t.numpy()


def _tensor(arr, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An npz array → a tensor of `dtype` on `like`'s device (`|V2` / a
    bfloat16 array as bf16 bytes)."""
    arr = np.asarray(arr)
    if dtype == torch.bfloat16 and (arr.dtype.kind == "V" or arr.dtype.name == "bfloat16"):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(dtype)
    else:
        t = torch.as_tensor(arr).to(dtype)
    return t.to(like.device)


def optax_state_tensors(lora: Mapping, optimizer, count: int,
                        schedule_count: bool) -> dict[str, object]:
    """{npz key: tensor, or list of per-layer tensors to stack} of an
    optimizer of `trainer/optimizers.py` in optax's keys (its
    `optax_layout`): a tensor with no state (a scaling leaf the optimizer
    does not hold, or no update yet) has the moment's zeros, as optax's
    `init`.  `schedule_count`: whether the lr is a schedule (optax then
    keeps its count too)."""
    layout = optimizer.optax_layout(schedule_count)
    out: dict[str, object] = {}
    for name, key, dtype in layout.moments:
        for jpath, by_layer in _stacks(lora).items():
            layers = [None] if None in by_layer else sorted(by_layer)
            for leaf in ("a", "b", "scaling"):
                arrs = []
                for layer in layers:
                    p = by_layer[layer][leaf]
                    t = optimizer.state.get(p, {}).get(key)
                    arrs.append(torch.zeros(tuple(p.shape), dtype=dtype) if t is None else t)
                out[f"{layout.prefix}{name}/{'/'.join(jpath)}/{leaf}"] = (
                    arrs[0] if layers == [None] else arrs)
    out.update(layout.scalars)
    if layout.count_key:
        out[layout.count_key] = np.asarray(count, np.int32)
    if layout.schedule_key:
        out[layout.schedule_key] = np.asarray(count, np.int32)
    return out


def restore_optax_state(arrays: Mapping[str, np.ndarray], lora: Mapping, optimizer) -> int:
    """Set the state of an optimizer of `trainer/optimizers.py` from the JAX
    layout's arrays: each tensor it holds gets its moments (a key that is
    missing keeps optax's zeros), the tree-wide scalars and the count.
    The moments of the scaling leaves the optimizer does not hold are
    ignored.  Returns the update count (the layout's count key, 0 if
    absent, else the schedule's)."""
    layout = optimizer.optax_layout(True)
    keys = [k for k in (layout.count_key, layout.schedule_key) if k in arrays]
    count = int(arrays[keys[0]]) if keys else 0
    held = {id(p) for p in optimizer.param_groups[0]["params"]}
    for jpath, by_layer in _stacks(lora).items():
        prefix = "/".join(jpath)
        for layer, node in by_layer.items():
            for leaf in ("a", "b", "scaling"):
                p = node[leaf]
                if id(p) not in held:
                    continue
                state = optimizer.state[p]
                for name, key, dtype in layout.moments:
                    arr = arrays.get(f"{layout.prefix}{name}/{prefix}/{leaf}")
                    if arr is not None and layer is not None:
                        arr = arr[layer]
                    state[key] = (torch.zeros_like(p, dtype=dtype) if arr is None
                                  else _tensor(arr, p, dtype).reshape(p.shape))
    group = optimizer.param_groups[0]
    for name, value in layout.scalars.items():
        if name in arrays:
            group[name] = _tensor(arrays[name], value, value.dtype)
    optimizer.set_count(count)
    return count


def lora_stacks(lora: Mapping) -> list[list[torch.Tensor]]:
    """The a / b tensors of `lora` grouped as the JAX tree stacks them (one
    list per JAX leaf, in layer order): `AdamW8bit`'s `stacks`."""
    out = []
    for by_layer in _stacks(lora).values():
        layers = [None] if None in by_layer else sorted(by_layer)
        out += [[by_layer[layer][name] for layer in layers] for name in ("a", "b")]
    return out


def _codes_from_npz(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).view(np.uint8)
    return torch.from_numpy(arr.copy()).to(device).view(torch.float8_e4m3fn)


def adam8bit_state_tensors(lora: Mapping, optimizer: AdamW8bit, count: int,
                           schedule_count: bool) -> dict[str, object]:
    """{key: tensor} of `adamw8bit`'s state as the JAX trainer writes it,
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
                out[f"{prefix}/{name}/{moment}/q"] = q
                out[f"{prefix}/{name}/{moment}/scale"] = scale
        q, scale = quantize(torch.zeros(len(layers)), bs)
        for moment in ("m", "v"):
            out[f"{prefix}/scaling/{moment}/q"] = q
            out[f"{prefix}/scaling/{moment}/scale"] = scale
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


def optimizer_state_tensors(lora: Mapping, optimizer: torch.optim.Optimizer, count: int,
                            schedule_count: bool) -> dict[str, object]:
    """The optimizer's state in the JAX trainer's keys, still on its device:
    {key: tensor, list of per-layer tensors to stack, or array}."""
    if isinstance(optimizer, AdamW8bit):
        return adam8bit_state_tensors(lora, optimizer, count, schedule_count)
    return optax_state_tensors(lora, optimizer, count, schedule_count)


def host_arrays(tensors: Mapping[str, object]) -> dict[str, np.ndarray]:
    """`optimizer_state_tensors`' values (tensors on any device) → the npz
    arrays, a per-layer list stacked."""
    return {k: np.stack([_host(t) for t in v]) if isinstance(v, list) else _host(v)
            for k, v in tensors.items()}


def optimizer_state_arrays(lora: Mapping, optimizer: torch.optim.Optimizer, count: int,
                           schedule_count: bool) -> dict[str, np.ndarray]:
    """The optimizer's state as the JAX trainer writes it: {key: array}."""
    return host_arrays(optimizer_state_tensors(lora, optimizer, count, schedule_count))


def restore_optimizer_state(arrays: Mapping[str, np.ndarray], lora: Mapping,
                            optimizer: torch.optim.Optimizer) -> int:
    if isinstance(optimizer, AdamW8bit):
        return restore_adam8bit_state(arrays, lora, optimizer)
    return restore_optax_state(arrays, lora, optimizer)


def save_npz(path, arrays: Mapping[str, np.ndarray]) -> None:
    """`np.savez(path, **arrays)` with every member dated 1980-01-01 (the
    zip format's first date) instead of the time of writing, so a file's
    bytes depend on its arrays alone: two saves of one state are equal
    byte for byte.  `np.load` reads it as it reads `np.savez`'s."""
    from numpy.lib import format as npformat

    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, val in arrays.items():
            info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as fid:
                npformat.write_array(fid, np.asanyarray(val), allow_pickle=True)


def write_train_state(ckpt_dir, arrays: Mapping[str, np.ndarray], generator_state) -> None:
    """optimizer_state.npz and generator_state.npy from host values."""
    ckpt_dir = Path(ckpt_dir)
    save_npz(ckpt_dir / OPTIMIZER_FILE, arrays)
    np.save(ckpt_dir / GENERATOR_FILE, np.asarray(generator_state))


def load_generator_state(ckpt_dir, generator: torch.Generator) -> None:
    """Restore the generator from a checkpoint that holds its state (one the
    JAX package wrote does not: the generator then keeps its seed)."""
    path = Path(ckpt_dir) / GENERATOR_FILE
    if path.exists():
        generator.set_state(torch.from_numpy(np.load(path)))


class AsyncWriter:
    """`train.async_checkpointing`: one save in flight at a time.  The train
    thread takes host copies of a save's tensors (`snapshot`: on a CUDA
    device into pinned buffers, reused from save to save, on a side stream
    that first waits for the compute stream; the train thread then waits
    for that copy's event and for nothing else), and a writer thread writes
    the files from them (`submit`).  `wait` blocks until the save in flight
    has landed and raises the writer's exception there, if it had one."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._buffers: dict[int, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _copy(self, t, index: int) -> torch.Tensor:
        t = t.detach()
        if self._stream is None or t.device.type != "cuda":
            return t.to("cpu", copy=True)
        buf = self._buffers.get(index)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._buffers[index] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def snapshot(self, tree):
        """`tree` (dicts and lists of tensors and arrays) with every tensor
        copied to the host and every array copied."""
        count = [0]

        def walk(node):
            if isinstance(node, Mapping):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            if torch.is_tensor(node):
                count[0] += 1
                return self._copy(node, count[0])
            return np.array(node)

        if self._stream is None:
            return walk(tree)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            out = walk(tree)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return out

    def submit(self, write: Callable, *args) -> None:
        """Run `write(*args)` on the writer thread, after the save in flight."""
        self.wait()

        def run():
            try:
                write(*args)
            except Exception as err:  # raised at the next wait
                self._error = err

        self._thread = threading.Thread(target=run, name="checkpoint-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Wait for the save in flight where an error is already on its way
        (the writer's own error is logged, not raised over it)."""
        try:
            self.wait()
        except Exception as err:
            logging.error("checkpoint writer failed: %s", err)
