"""The parts of a tokenizer.json pipeline, interpreted as the `tokenizers`
library does for the component types the supported checkpoints use:
normalizers, pre-tokenizers, the BPE and Unigram models, post-processors
and decoders."""

from __future__ import annotations

import base64
import re
import unicodedata
from typing import Optional

from qflux_tpu_torch.models.tokenizers.charsmap import Charsmap
from qflux_tpu_torch.models.tokenizers.text import _GPT2_RE, _compile, _is_white, bytes_to_unicode

# ---------------------------------------------------------------------------
# the pipeline's parts, from their tokenizer.json descriptions


def _pattern(spec) -> re.Pattern:
    if "Regex" in spec:
        return _compile(spec["Regex"])
    return re.compile(re.escape(spec["String"]))


def _normalizer(spec):
    """A tokenizer.json normalizer → a function of the text."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(s):
            for p in parts:
                s = p(s)
            return s
        return run
    if kind in ("NFC", "NFKC", "NFD", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda _: content, s)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s):
            i, j = 0, len(s)
            while left and i < j and _is_white(s[i]):
                i += 1
            while right and j > i and _is_white(s[j - 1]):
                j -= 1
            return s[i:j]
        return strip
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap") or ""
        if not blob:
            return lambda s: s
        return Charsmap(base64.b64decode(blob)).normalize
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r} is not ported")


def _split(text: str, pat: re.Pattern, behavior: str, invert: bool) -> list:
    """tokenizers' Split: the matches are the delimiters (or, inverted, the
    content); `isolated` keeps both as pieces, `removed` drops the
    delimiters."""
    pieces, last = [], 0
    for m in pat.finditer(text):
        if m.start() == m.end():
            continue
        if m.start() > last:
            pieces.append((text[last:m.start()], invert))
        pieces.append((m.group(), not invert))
        last = m.end()
    if last < len(text):
        pieces.append((text[last:], invert))
    if behavior == "isolated":
        return [p for p, _ in pieces]
    if behavior == "removed":
        return [p for p, delim in pieces if not delim]
    raise NotImplementedError(f"Split behavior {behavior!r} is not ported")


def _pre_tokenizer(spec):
    """A tokenizer.json pre-tokenizer → a function of one piece → pieces."""
    if spec is None:
        return lambda s: [s]
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(s):
            pieces = [s]
            for p in parts:
                pieces = [q for piece in pieces for q in p(piece)]
            return pieces
        return run
    if kind == "Split":
        pat = _pattern(spec["pattern"])
        behavior, invert = spec["behavior"].lower(), spec.get("invert", False)
        return lambda s: _split(s, pat, behavior, invert)
    if kind == "ByteLevel":
        table = bytes_to_unicode()
        regex = _compile(_GPT2_RE) if spec.get("use_regex", True) else None
        prefix = spec.get("add_prefix_space", False)

        def byte_level(s):
            if prefix and not s.startswith(" "):
                s = " " + s
            pieces = _split(s, regex, "isolated", False) if regex is not None else [s]
            return ["".join(table[b] for b in p.encode()) for p in pieces]
        return byte_level
    if kind == "WhitespaceSplit":
        return lambda s: "".join(" " if _is_white(c) else c for c in s).split()
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r} is not ported")
        split = spec.get("split", True)

        def metaspace(s):
            s = s.replace(" ", rep)
            if scheme == "always" and not s.startswith(rep):
                s = rep + s
            if not split:
                return [s]
            pieces = [p for p in re.split(f"(?={re.escape(rep)})", s) if p]
            return pieces
        return metaspace
    raise NotImplementedError(f"tokenizer.json pre-tokenizer {kind!r} is not ported")


class BPE:
    """Byte-pair encoding over merge ranks (GPT-2's loop: merge the
    lowest-ranked adjacent pair everywhere, until none is ranked), with the
    end-of-word suffix CLIP's vocabulary uses, a cache per piece, and the
    ids of the vocabulary (unknown symbols → unk_token, where there is
    one)."""

    def __init__(self, vocab: dict, merges: list, unk_token=None, end_of_word_suffix="",
                 continuing_subword_prefix="", ignore_merges=False):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.unk = unk_token
        self.suffix = end_of_word_suffix or ""
        self.prefix = continuing_subword_prefix or ""
        self.ignore_merges = ignore_merges
        self.cache = {}

    def tokenize(self, piece: str) -> list:
        if piece in self.cache:
            return self.cache[piece]
        if self.ignore_merges and piece in self.vocab:
            return [self.vocab[piece]]
        word = [c if i == 0 else self.prefix + c for i, c in enumerate(piece)]
        if word:
            word[-1] += self.suffix
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1][len(self.prefix):])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = []
        for sym in word:
            if sym in self.vocab:
                ids.append(self.vocab[sym])
            elif self.unk is not None and self.unk in self.vocab:
                ids.append(self.vocab[self.unk])
        self.cache[piece] = ids
        return ids


class Unigram:
    """SentencePiece's Unigram model: the Viterbi segmentation of a piece
    maximizing the sum of the pieces' scores, a character no piece covers
    scored min(score) - 10 as the unknown piece, consecutive unknowns fused
    into one, ties kept by the earlier (longer) piece."""

    UNK_PENALTY = 10.0

    def __init__(self, vocab: list, unk_id: Optional[int], byte_fallback: bool = False):
        if byte_fallback:
            raise NotImplementedError("Unigram byte_fallback is not ported")
        self.pieces = {}
        for i, (piece, score) in enumerate(vocab):
            self.pieces.setdefault(piece, (i, float(score)))
        self.unk_id = unk_id
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self.unk_score = min((s for _, s in vocab), default=0.0) - self.UNK_PENALTY
        self.cache = {}

    def tokenize(self, piece: str) -> list:
        if piece in self.cache:
            return self.cache[piece]
        n = len(piece)
        best = [(-float("inf"), None, None)] * (n + 1)  # (score, begin, id)
        best[0] = (0.0, None, None)
        for begin in range(n):
            base = best[begin][0]
            if base == -float("inf"):
                continue
            single = False
            for length in range(1, min(self.max_len, n - begin) + 1):
                hit = self.pieces.get(piece[begin:begin + length])
                if hit is None:
                    continue
                single = single or length == 1
                end, score = begin + length, base + hit[1]
                if score > best[end][0]:
                    best[end] = (score, begin, hit[0])
            if not single:
                end, score = begin + 1, base + self.unk_score
                if score > best[end][0]:
                    best[end] = (score, begin, None)
        path, end = [], n
        while end > 0:
            _, begin, pid = best[end]
            if pid is None and path and path[-1] is None:
                pass  # consecutive unknowns fuse into one
            else:
                path.append(pid)
            end = begin
        ids = [self.unk_id if pid is None else pid for pid in reversed(path)]
        self.cache[piece] = ids
        return ids


def _model(spec):
    kind = spec["type"]
    if kind == "BPE":
        if spec.get("dropout"):
            raise NotImplementedError("BPE dropout is not ported")
        merges = [m.split(" ") if isinstance(m, str) else m for m in spec["merges"]]
        return BPE(spec["vocab"], merges, spec.get("unk_token"),
                   spec.get("end_of_word_suffix") or "", spec.get("continuing_subword_prefix")
                   or "", spec.get("ignore_merges", False))
    if kind == "Unigram":
        return Unigram(spec["vocab"], spec.get("unk_id"), spec.get("byte_fallback", False))
    raise NotImplementedError(f"tokenizer.json model {kind!r} is not ported")


def _post_processor(spec):
    """A tokenizer.json post-processor → (ids with the special tokens a
    single sequence gets, the number it adds)."""
    if spec is None:
        return (lambda ids: ids), 0
    kind = spec["type"]
    if kind == "ByteLevel":
        return (lambda ids: ids), 0
    if kind == "RobertaProcessing":
        cls, sep = spec["cls"][1], spec["sep"][1]
        return (lambda ids: [cls] + ids + [sep]), 2
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        parts = []
        for item in spec["single"]:
            if "Sequence" in item:
                parts.append(None)
            else:
                parts.append(list(specials[item["SpecialToken"]["id"]]["ids"]))
        added = sum(len(p) for p in parts if p is not None)

        def template(ids):
            out = []
            for p in parts:
                out.extend(ids if p is None else p)
            return out
        return template, added
    if kind == "Sequence":
        steps = [_post_processor(s) for s in spec["processors"]]

        def run(ids):
            for fn, _ in steps:
                ids = fn(ids)
            return ids
        return run, sum(n for _, n in steps)
    raise NotImplementedError(f"tokenizer.json post-processor {kind!r} is not ported")


def _decoder(spec):
    """A tokenizer.json decoder → a function of the token strings."""
    if spec is None:
        return "".join
    kind = spec["type"]
    if kind == "ByteLevel":
        inverse = {c: b for b, c in bytes_to_unicode().items()}

        def byte_level(tokens):
            raw = bytearray()
            for tok in tokens:
                if all(c in inverse for c in tok):
                    raw.extend(inverse[c] for c in tok)
                else:
                    raw.extend(tok.encode())
            return raw.decode("utf-8", errors="replace")
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or ("always" if spec.get("add_prefix_space", True)
                                                else "never")

        def metaspace(tokens):
            text = "".join(tokens).replace(rep, " ")
            return text[1:] if scheme != "never" and text.startswith(" ") else text
        return metaspace
    if kind == "Sequence":
        raise NotImplementedError("tokenizer.json decoder Sequence is not ported")
    raise NotImplementedError(f"tokenizer.json decoder {kind!r} is not ported")
