"""Content-addressed embedding cache, in the JAX package's format.

Counterpart of qflux_tpu/data/cache.py, file for file:

  cache_root/<embedding_key>/<hash>.npz          one array per file (member
                                                 `data.npy`), floats as fp16
  cache_root/metadata/<main_hash>.json           {"version": "2.0-tpu",
                                                  "keys": {embedding_key: hash}}

so a cache written by either package loads in the other.  Caption dropout:
`empty_*`-keyed embeddings are cached beside the others and substituted at
load time.  Files of 64 MiB and more are keyed by XXH64 ("x" + 16 hex
digits), smaller ones by md5, as in JAX.
"""

from __future__ import annotations

import io
import json
import math
import zipfile
from pathlib import Path
from typing import Mapping, Optional

import numpy as np

from qflux_tpu_torch.utils.hashing import combine_hashes, md5_file, md5_string, xxh64_file

CACHE_VERSION = "2.0-tpu"


def read_npz_data(path: Path) -> np.ndarray:
    """The `data.npy` member of an npz file, as `np.load(path)["data"]`
    gives it (read-only here): the file read in one call and the member
    inflated in one call (np.load reads a member in 256 KiB pieces).  The
    loader's thread runs this beside a host-bound step, and every read and
    every inflate hands the interpreter lock to the other thread and back."""
    with zipfile.ZipFile(io.BytesIO(path.read_bytes())) as z:
        raw = z.read("data.npy")
    f = io.BytesIO(raw)
    version = np.lib.format.read_magic(f)
    reader = (np.lib.format.read_array_header_1_0 if version == (1, 0)
              else np.lib.format.read_array_header_2_0)
    shape, fortran_order, dtype = reader(f)
    if dtype.hasobject:
        raise ValueError(f"{path}: object arrays are not cached embeddings")
    arr = np.frombuffer(raw, dtype, count=math.prod(shape), offset=f.tell())
    return arr.reshape(shape, order="F" if fortran_order else "C")


class EmbeddingCacheManager:
    # files at or above this size hash with XXH64; smaller ones with md5
    BIG_FILE_THRESHOLD = 64 << 20

    def __init__(self, cache_root: str | Path):
        self.root = Path(cache_root)
        self.meta_dir = self.root / "metadata"

    # -- hashing ------------------------------------------------------------

    @staticmethod
    def _file_hash(path) -> str:
        try:
            if Path(str(path)).stat().st_size >= EmbeddingCacheManager.BIG_FILE_THRESHOLD:
                return f"x{xxh64_file(path)}"
        except OSError:
            pass
        return md5_file(path)

    @staticmethod
    def get_hash(*items) -> str:
        """Hash files (by content) and strings (by value), combined."""
        parts = []
        for item in items:
            if isinstance(item, (list, tuple)):
                parts.extend(EmbeddingCacheManager.get_hash(x) for x in item)
            elif isinstance(item, (str, Path)) and Path(str(item)).is_file():
                parts.append(EmbeddingCacheManager._file_hash(item))
            else:
                parts.append(md5_string(str(item)))
        return combine_hashes(*parts) if len(parts) > 1 else parts[0]

    # -- save / load ---------------------------------------------------------

    def save(self, main_hash: str, embeddings: Mapping[str, np.ndarray],
             hashes: Mapping[str, str]) -> None:
        """Save each embedding under its content hash (`hashes[key]`, else
        `main_hash`) unless that file exists; write the metadata map."""
        meta = {}
        for key, arr in embeddings.items():
            if arr is None:
                continue
            h = hashes.get(key, main_hash)
            d = self.root / key
            d.mkdir(parents=True, exist_ok=True)
            path = d / f"{h}.npz"
            if not path.exists():
                arr = np.asarray(arr)
                store = arr.astype(np.float16) if arr.dtype in (np.float32, np.float64) else arr
                np.savez_compressed(path, data=store)
            meta[key] = h
        self.meta_dir.mkdir(parents=True, exist_ok=True)
        (self.meta_dir / f"{main_hash}.json").write_text(
            json.dumps({"version": CACHE_VERSION, "keys": meta}))

    def exists(self, main_hash: str) -> bool:
        return (self.meta_dir / f"{main_hash}.json").is_file()

    def _meta(self, main_hash: str) -> Optional[dict]:
        try:
            return json.loads((self.meta_dir / f"{main_hash}.json").read_text())["keys"]
        except FileNotFoundError:
            return None

    def array_shape(self, main_hash: str, key: str) -> Optional[tuple]:
        """Shape of one cached embedding from the npz member's header: no
        array data is read or decompressed."""
        meta = self._meta(main_hash)
        if meta is None or key not in meta:
            return None
        path = self.root / key / f"{meta[key]}.npz"
        if not path.is_file():
            return None
        try:
            with zipfile.ZipFile(path) as z, z.open("data.npy") as f:
                version = np.lib.format.read_magic(f)
                reader = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                          else np.lib.format.read_array_header_2_0)
                shape, _, _ = reader(f)
                return tuple(shape)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            return None

    def load(self, main_hash: str, use_empty_prompt: bool = False,
             dtype=np.float32) -> Optional[dict[str, np.ndarray]]:
        """Every non-`empty_*` embedding, fp16 widened to `dtype`.  With
        use_empty_prompt, each `empty_<key>` replaces `<key>` (caption
        dropout).  None when the metadata or a file is missing."""
        meta = self._meta(main_hash)
        if meta is None:
            return None
        out = {}
        for key, h in meta.items():
            if key.startswith("empty_"):
                continue
            use_key = key
            if use_empty_prompt and f"empty_{key}" in meta:
                use_key, h = f"empty_{key}", meta[f"empty_{key}"]
            try:
                arr = read_npz_data(self.root / use_key / f"{h}.npz")
            except FileNotFoundError:
                return None  # cache invalidated
            out[key] = arr.astype(dtype) if arr.dtype == np.float16 else arr.copy()
        return out
