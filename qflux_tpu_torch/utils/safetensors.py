"""A first-party safetensors reader and writer (torch, numpy and the stdlib).

The JAX package reads and writes checkpoints and LoRA files with the
`safetensors` package (qflux_tpu/models/porting.py:load_safetensors,
qflux_tpu/utils/lora_io.py:save_lora_safetensors); the port keeps its own
copy of the format, so it runs where that package is not installed.

The format: an 8-byte little-endian header length N, then N bytes of JSON
(`{"__metadata__": {str: str}, name: {"dtype", "shape", "data_offsets"},
...}`, padded with spaces to a multiple of 8), then the tensors' raw
little-endian bytes, each at its `data_offsets` [begin, end) past the
header.

`save_file` writes the bytes the `safetensors` package (0.8) writes for the
same tensors: compact JSON with `__metadata__` first when given, then the
tensors sorted by dtype (widest first, in the package's dtype order) and
name, their data in that order.  (With more than one metadata key the
package orders them by a hash; this writer writes them sorted.)

`SafeTensors` reads a file or a directory of `*.safetensors` shards lazily:
the headers are parsed once into one name → (file, dtype, shape, offsets)
map, and each tensor is read when asked, by `seek` + `readinto` into a CPU
tensor.  A file that holds bitsandbytes 4-bit weights is read as the JAX
package reads it: every 4-bit weight comes out dequantized
(`models/nf4.py:import_bnb_4bit`) and its auxiliary tensors are hidden.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path
from typing import Iterator, Mapping, NamedTuple, Optional

import numpy as np
import torch

# safetensors dtype name → torch dtype (the package's torch table)
DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "F8_E4M3FNUZ": torch.float8_e4m3fnuz, "F8_E5M2FNUZ": torch.float8_e5m2fnuz,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# numpy dtype name → safetensors name (bfloat16 is ml_dtypes' numpy type)
_NP_NAMES = {"float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
             "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8",
             "bool": "BOOL"}
# the writer's data order: dtypes from the last of this list to the first
# (the package's Dtype enum, of which these are the ones torch has)
_ORDER = ("BOOL", "U8", "I8", "F8_E5M2", "F8_E4M3", "F8_E4M3FNUZ", "F8_E5M2FNUZ", "I16",
          "F16", "BF16", "I32", "F32", "F64", "I64")

if sys.byteorder != "little":  # pragma: no cover
    raise ImportError("qflux_tpu_torch.utils.safetensors reads and writes little-endian "
                      "buffers in place")


def _raw(value) -> tuple[str, tuple[int, ...], memoryview]:
    """(dtype name, shape, raw bytes) of a torch tensor or a numpy array."""
    if torch.is_tensor(value):
        t = value.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"dtype {t.dtype} has no safetensors name")
        data = t.reshape(-1).view(torch.uint8).numpy()
        return _NAMES[t.dtype], tuple(t.shape), memoryview(data).cast("B")
    a = np.asarray(value)
    name = _NP_NAMES.get(a.dtype.name)
    if name is None or a.dtype.byteorder == ">":
        raise ValueError(f"dtype {a.dtype} has no safetensors name")
    # (np.ascontiguousarray would make a 0-d array 1-d)
    return name, a.shape, memoryview(np.ascontiguousarray(a.reshape(-1)).view(np.uint8))


def save_file(tensors: Mapping[str, object], path, metadata: Optional[Mapping[str, str]] = None):
    """Write `tensors` (torch tensors on any device, or numpy arrays) to
    `path` in the safetensors format, byte for byte as
    `safetensors.torch.save_file` / `safetensors.numpy.save_file` write it."""
    raws = {name: _raw(v) for name, v in tensors.items()}
    names = sorted(raws, key=lambda n: (-_ORDER.index(raws[n][0]), n))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in sorted(metadata.items())}
    offset = 0
    for n in names:
        dtype, shape, data = raws[n]
        header[n] = {"dtype": dtype, "shape": list(shape),
                     "data_offsets": [offset, offset + data.nbytes]}
        offset += data.nbytes
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for n in names:
            f.write(raws[n][2])
    return path


class _Entry(NamedTuple):
    file: Path
    dtype: str
    shape: tuple[int, ...]
    begin: int  # absolute byte offset in the file
    end: int


def read_header(path) -> tuple[dict, dict[str, _Entry]]:
    """(metadata, name → entry) of one safetensors file."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} exceeds the file")
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    base = 8 + n
    entries = {}
    for name, info in header.items():
        dtype = info["dtype"]
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, which the reader "
                             f"does not handle (handled: {sorted(DTYPES)})")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        want = int(np.prod(shape, dtype=np.int64)) * DTYPES[dtype].itemsize
        if end - begin != want or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} offsets {begin, end} do not fit "
                             f"{dtype} {list(shape)} in the file")
        entries[name] = _Entry(path, dtype, shape, base + begin, base + end)
    return meta, entries


def _read(entry: _Entry) -> torch.Tensor:
    buf = torch.empty(entry.end - entry.begin, dtype=torch.uint8)
    with open(entry.file, "rb") as f:
        f.seek(entry.begin)
        got = f.readinto(memoryview(buf.numpy()))
    if got != entry.end - entry.begin:
        raise ValueError(f"{entry.file}: short read at offset {entry.begin}")
    return buf.view(DTYPES[entry.dtype]).reshape(entry.shape)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class SafeTensors(Mapping):
    """A read-only mapping name → CPU tensor over one safetensors file or a
    directory of them (every `*.safetensors` in sorted order, as the JAX
    adapters' `_load_dir`; a name in two files raises).  Tensors are read
    on access; `metadata` is the first file's."""

    def __init__(self, path):
        path = Path(path)
        files = sorted(path.glob("*.safetensors")) if path.is_dir() else [path]
        if not files or not files[0].exists():
            raise FileNotFoundError(f"no safetensors under {path}")
        self.files = files
        self.metadata: dict = {}
        self._entries: dict[str, _Entry] = {}
        self._bnb: dict[str, dict[str, _Entry]] = {}  # 4-bit weight → its tensors
        for i, f in enumerate(files):
            meta, entries = read_header(f)
            if i == 0:
                self.metadata = meta
            self._add_file(entries)

    def _add_file(self, entries: dict[str, _Entry]) -> None:
        from qflux_tpu_torch.models.nf4 import bnb_4bit_groups

        groups = bnb_4bit_groups(entries)
        hidden = {k for group in groups.values() for k in group}
        for name, entry in entries.items():
            if name in hidden and name not in groups:
                continue
            if name in self._entries:
                raise ValueError(f"tensor {name!r} is in both {self._entries[name].file} and "
                                 f"{entry.file}")
            self._entries[name] = entry
        self._bnb.update({w: {k: entries[k] for k in group} for w, group in groups.items()})

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._bnb:
            from qflux_tpu_torch.models.nf4 import import_bnb_4bit

            group = {k: _numpy(_read(e)) for k, e in self._bnb[name].items()}
            return torch.from_numpy(np.ascontiguousarray(import_bnb_4bit(group)[name]))
        return _read(self._entries[name])

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name) -> bool:
        return name in self._entries


def load_file(path) -> dict[str, torch.Tensor]:
    """Every tensor of a file or directory, read now."""
    st = SafeTensors(path)
    return {k: st[k] for k in st}
