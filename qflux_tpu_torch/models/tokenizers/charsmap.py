"""SentencePiece's precompiled normalization charsmap: the reader the T5
tokenizer's `Precompiled` normalizer runs, and a writer for tests and the
smoke."""

from __future__ import annotations

import struct
from typing import Optional

from qflux_tpu_torch.models.tokenizers.text import _graphemes

# ---------------------------------------------------------------------------
# SentencePiece's precompiled charsmap


class Charsmap:
    """SentencePiece's normalization table: a uint32 trie size (bytes),
    that many bytes of darts-clone double-array units, then the
    NUL-terminated replacement strings the leaves index."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.normalized = blob[4 + size:]

    def _prefixes(self, key: bytes) -> list:
        """The leaf values of every prefix of `key` that is a key, shortest
        first (darts-clone's commonPrefixSearch)."""
        units, found = self.units, []
        unit = units[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for byte in key:
            pos ^= byte
            if pos >= len(units):
                break
            unit = units[pos]
            if (unit & ((1 << 31) | 0xFF)) != byte:
                break
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                found.append(units[pos] & 0x7FFFFFFF)
        return found

    def transform(self, chunk: str) -> Optional[str]:
        found = self._prefixes(chunk.encode())
        if not found:
            return None
        end = self.normalized.index(b"\0", found[0])
        return self.normalized[found[0]:end].decode()

    def normalize(self, text: str) -> str:
        out = []
        for g in _graphemes(text):
            if len(g.encode()) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def build_precompiled_charsmap(mapping: dict) -> bytes:
    """The charsmap `Charsmap` reads, from {source text: replacement}: each
    trie node's children in a 256-unit block of its own (the offset to it
    in bits 10.., below 2^21), a leaf at label 0 holding the replacement's
    byte offset."""
    blob, root = b"", {}
    for src, dst in sorted(mapping.items()):
        node = root
        for byte in src.encode():
            node = node.setdefault(byte, {})
        node[None] = len(blob)
        blob += dst.encode() + b"\0"
    units = [0] * 256

    def place(node, pos):
        base = len(units)
        units.extend([0] * 256)
        if base ^ pos >= 1 << 21:
            raise ValueError("charsmap too large for build_precompiled_charsmap")
        units[pos] |= (base ^ pos) << 10
        if None in node:
            units[pos] |= 1 << 8
            units[base] = node[None] | (1 << 31)
        for label, child in node.items():
            if label is not None:
                units[base ^ label] = label
                place(child, base ^ label)

    place(root, 0)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + blob
