"""Content hashing for the embedding cache and dataset identity.

Counterpart of qflux_tpu/utils/hashing.py (`md5_file`, `md5_string`,
`sha256_file`, `combine_hashes`) and of the streaming XXH64 of
qflux_tpu/runtime/native.py, which the cache keys files of 64 MiB and more
by.  The JAX package computes XXH64 in a g++ library when one builds and
in Python otherwise; both give the same digest, and so does `xxh64_file`
here (pure Python, streamed in 8 MiB chunks).  `phash_image` is JAX's
perceptual hash on the port's copy of PIL's resampler
(`utils/resample.py`): luma, Lanczos to 32², the float64 DCT.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from qflux_tpu_torch.utils.resample import resize, to_luma

_M = (1 << 64) - 1
_P1, _P2, _P3, _P4, _P5 = (11400714785074694791, 14029467366897019727,
                           1609587929392839161, 9650029242287828579, 2870177450012600261)


def md5_file(path: str | Path, chunk_size: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while chunk := f.read(chunk_size):
            h.update(chunk)
    return h.hexdigest()


def md5_string(s: str) -> str:
    return hashlib.md5(s.encode("utf-8")).hexdigest()


def sha256_file(path: str | Path, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(chunk_size):
            h.update(chunk)
    return h.hexdigest()


def phash_image(image, hash_size: int = 8, highfreq_factor: int = 4) -> str:
    """Perceptual hash of a uint8 HxW(xC) image, as JAX's: PIL's "L"
    (ITU-R 601-2 luma), PIL's Lanczos to (hash_size · highfreq_factor)²,
    a float64 DCT-II over both axes, the top-left hash_size² block
    thresholded at its median, as hex."""
    size = hash_size * highfreq_factor
    img = resize(to_luma(np.asarray(image).astype(np.uint8)), (size, size),
                 "lanczos").astype(np.float64)

    def dct_1d(x):
        n = x.shape[-1]
        k = np.arange(n)
        basis = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
        return x @ basis.T

    d = dct_1d(dct_1d(img).T).T
    low = d[:hash_size, :hash_size]
    bits = (low > np.median(low)).flatten()
    return "".join("%x" % int("".join("1" if b else "0" for b in bits[i:i + 4]), 2)
                   for i in range(0, len(bits), 4))


def combine_hashes(*hashes: str) -> str:
    return md5_string("|".join(hashes))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, inp: int) -> int:
    return (_rotl((acc + inp * _P2) & _M, 31) * _P1) & _M


def xxh64_stream(chunks, seed: int = 0) -> int:
    """XXH64 over an iterable of byte chunks: the four 8-byte lanes and the
    tail of fewer than 32 bytes are carried across chunks, so the digest is
    that of the concatenation."""
    v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M, (seed - _P1) & _M]
    total, striped, buf = 0, False, b""
    for chunk in chunks:
        buf += chunk
        total += len(chunk)
        usable = len(buf) - (len(buf) % 32)
        for i in range(0, usable, 32):
            for j in range(4):
                v[j] = _round(v[j], int.from_bytes(buf[i + 8 * j:i + 8 * j + 8], "little"))
            striped = True
        buf = buf[usable:]
    if striped:
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M
        for j in range(4):
            h = ((h ^ _round(0, v[j])) * _P1 + _P4) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + total) & _M
    i, n = 0, len(buf)
    while i + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(buf[i:i + 8], "little")), 27) * _P1 + _P4) & _M
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(buf[i:i + 4], "little") * _P1) & _M, 23) * _P2
             + _P3) & _M
        i += 4
    while i < n:
        h = (_rotl(h ^ (buf[i] * _P5) & _M, 11) * _P1) & _M
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


def xxh64_file(path: str | Path, seed: int = 0) -> str:
    """Hex digest (16 digits) of a file's contents, streamed."""
    def chunks():
        with open(path, "rb") as f:
            while c := f.read(8 << 20):
                yield c

    return f"{xxh64_stream(chunks(), seed):016x}"
