"""First-party tokenizers: CLIP's and Qwen2's byte-level BPE, T5's SentencePiece Unigram.

The JAX package has no counterpart module: its adapters call
`transformers.AutoTokenizer.from_pretrained` on a checkpoint's tokenizer
directory (qflux_tpu/trainer/flux_kontext.py:209-213, qwen_edit.py:183-185,
flux2_klein.py:206-208, dreamomni2.py:108-110).  This module gives the same
ids from the same files with the standard library alone, so that the card's
machine, which has neither `transformers` nor `tokenizers`, tokenizes a real
checkpoint's prompts into its vocabulary.  `load_tokenizer(dir)` reads:

  * `tokenizer.json` (the `tokenizers` library's file: Qwen2.5-VL's and
    Qwen3's BPE, FLUX's T5 Unigram): its normalizer, pre-tokenizer, model,
    post-processor, decoder and added tokens, interpreted as that library
    does, for the component types those files use;
  * else `vocab.json` + `merges.txt` (FLUX's CLIP tokenizer, or a Qwen2
    tokenizer without `tokenizer.json`), with the pipeline transformers
    builds from them (`CLIPConverter` / `Qwen2Converter` of
    transformers/convert_slow_tokenizer.py) and the added tokens of
    `tokenizer_config.json`'s `added_tokens_decoder`;
  * `tokenizer_config.json` / `special_tokens_map.json` for BOS / EOS / pad,
    `padding_side`, `model_max_length` and the chat template (or
    `chat_template.jinja` / `chat_template.json`).

A directory with a SentencePiece `spiece.model` and no `tokenizer.json` is
refused: reading its protobuf is not ported, and the checkpoints the port
supports ship `tokenizer.json` beside it.

The call surface is the one the adapters use: `tok(texts, padding=
"max_length", truncation=True, max_length=n, return_tensors="np")` →
{"input_ids", "attention_mask"}, `tok(text, add_special_tokens=False)`,
`decode(ids, skip_special_tokens=True)` and one chat-template rendering,
`apply_chat_template(messages, tokenize=False, add_generation_prompt=True,
...)`, through jinja2 (a dependency of torch) in the environment
transformers renders in.

Regex patterns in the files use Oniguruma's `\\p{L}` / `\\p{N}` and its
Unicode `\\s`, which Python's `re` lacks: `_compile` rewrites them into
explicit character classes built from `unicodedata`'s categories once per
process (`_category_ranges`), and `re` (a backtracking, leftmost-first
engine, as Oniguruma) runs the result.  T5's `Precompiled` normalizer is
SentencePiece's: a darts-clone double-array trie over UTF-8 keys and their
NUL-terminated replacements, applied to each extended grapheme cluster
shorter than six bytes (the shortest matching prefix replaces the whole
cluster, as the `tokenizers` library does), else to each character; the
clusters are cut by `_graphemes`, which follows UAX #29 with
`unicodedata`'s categories in place of the Grapheme_Cluster_Break table.
`build_precompiled_charsmap` writes such a charsmap from a mapping (tests
and chip_smoke.py write their tokenizer directories with it).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

import numpy as np

from qflux_tpu_torch.models.tokenizers.charsmap import Charsmap, build_precompiled_charsmap
from qflux_tpu_torch.models.tokenizers.pipeline import (BPE, Unigram, _decoder, _model,
                                                        _normalizer, _post_processor,
                                                        _pre_tokenizer)
from qflux_tpu_torch.models.tokenizers.text import (_CLIP_RE, _QWEN2_RE, _is_white,
                                                    bytes_to_unicode)

__all__ = ["BPE", "Charsmap", "Tokenizer", "Unigram", "build_precompiled_charsmap",
           "bytes_to_unicode", "load_tokenizer"]

# ---------------------------------------------------------------------------
# the pipelines transformers builds from vocab.json + merges.txt


def _clip_spec(vocab: dict, merges: list, unk: str, bos: str, eos: str) -> dict:
    """transformers' CLIPConverter as a tokenizer.json description."""
    return {
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFC"}, {"type": "Replace", "pattern": {"Regex": r"\s+"}, "content": " "},
            {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": _CLIP_RE}, "behavior": "Removed",
             "invert": True},
            {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True}]},
        "model": {"type": "BPE", "vocab": vocab, "merges": merges, "unk_token": unk,
                  "end_of_word_suffix": "</w>", "continuing_subword_prefix": ""},
        "post_processor": {"type": "RobertaProcessing", "sep": [eos, vocab[eos]],
                           "cls": [bos, vocab[bos]]},
        "decoder": {"type": "ByteLevel"},
    }


def _qwen2_spec(vocab: dict, merges: list) -> dict:
    """transformers' Qwen2Converter as a tokenizer.json description."""
    return {
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": _QWEN2_RE}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]},
        "model": {"type": "BPE", "vocab": vocab, "merges": merges, "unk_token": None},
        "post_processor": {"type": "ByteLevel"},
        "decoder": {"type": "ByteLevel"},
    }


def _read_merges(path: Path, limit: Optional[int] = None) -> list:
    """merges.txt without its "#version" line and blank lines (CLIP's slow
    tokenizer reads the first 49152 - 256 - 2 merges only)."""
    lines = path.read_text(encoding="utf-8").split("\n")
    merges = [ln.split() for i, ln in enumerate(lines)
              if ln.strip() and not (i == 0 and ln.startswith("#version"))]
    return merges[:limit] if limit is not None else merges


def _token_text(tok) -> Optional[str]:
    if tok is None or isinstance(tok, str):
        return tok
    return tok.get("content")


# ---------------------------------------------------------------------------
# the tokenizer


class Tokenizer:
    """A tokenizer.json pipeline with its added tokens and the settings of
    tokenizer_config.json; built by `load_tokenizer`."""

    def __init__(self, spec: dict, config: dict):
        self.config = config
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.post_process, self.n_special = _post_processor(spec.get("post_processor"))
        self._decode = _decoder(spec.get("decoder"))
        vocab = (spec["model"]["vocab"] if spec["model"]["type"] == "BPE"
                 else {p: i for i, (p, _) in enumerate(spec["model"]["vocab"])})
        self.added = {}  # content → the added token's description
        for tok in spec.get("added_tokens", []):
            self.added[tok["content"]] = tok
        self.id_to_token = {i: t for t, i in vocab.items()}
        for tok in self.added.values():
            self.id_to_token[tok["id"]] = tok["content"]
        self.token_to_id = {t: i for i, t in self.id_to_token.items()}
        self.special_ids = {t["id"] for t in self.added.values() if t.get("special")}
        self._added_re = (re.compile("|".join(re.escape(t) for t in sorted(
            self.added, key=len, reverse=True))) if self.added else None)
        self.padding_side = config.get("padding_side", "right")
        self.truncation_side = config.get("truncation_side", "right")
        self.model_max_length = config.get("model_max_length")
        self.chat_template = config.get("chat_template")
        self._template = None  # compiled on first use
        self.pad_token = _token_text(config.get("pad_token"))
        self.pad_token_id = self.token_to_id.get(self.pad_token) if self.pad_token else None
        self.clean_up_tokenization_spaces = config.get("clean_up_tokenization_spaces", False)

    # -- encoding

    def _segments(self, text: str) -> list:
        """`text` cut at the added tokens (longest first), as (piece, id):
        id None for the text between them; lstrip / rstrip tokens take the
        whitespace beside them, single_word ones match whole words only."""
        if self._added_re is None:
            return [(text, None)] if text else []
        out, last = [], 0
        for m in self._added_re.finditer(text):
            tok = self.added[m.group()]
            start, end = m.start(), m.end()
            if start < last:
                continue
            if tok.get("single_word") and (
                    (start > 0 and not _is_white(text[start - 1]))
                    or (end < len(text) and not _is_white(text[end]))):
                continue
            if tok.get("lstrip"):
                while start > last and _is_white(text[start - 1]):
                    start -= 1
            if tok.get("rstrip"):
                while end < len(text) and _is_white(text[end]):
                    end += 1
            if start > last:
                out.append((text[last:start], None))
            out.append((m.group(), tok["id"]))
            last = end
        if last < len(text):
            out.append((text[last:], None))
        return out

    def _ids(self, text: str) -> list:
        ids = []
        for piece, tid in self._segments(text):
            if tid is not None:
                ids.append(tid)
                continue
            for p in self.pre_tokenize(self.normalize(piece)):
                ids.extend(self.model.tokenize(p))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True, max_length: Optional[int] = None,
               truncation: bool = False) -> list:
        ids = self._ids(text)
        n_special = self.n_special if add_special_tokens else 0
        if truncation:
            limit = max_length if max_length is not None else self.model_max_length
            if limit is not None:
                keep = max(limit - n_special, 0)
                if len(ids) > keep:
                    ids = ids[:keep] if self.truncation_side == "right" else ids[len(ids) - keep:]
        return self.post_process(ids) if add_special_tokens else ids

    def __call__(self, texts, padding=False, truncation=False, max_length: Optional[int] = None,
                 return_tensors: Optional[str] = None, add_special_tokens: bool = True) -> dict:
        """transformers' call for the arguments the adapters pass: a string
        or a list of them → {"input_ids", "attention_mask"} (lists, or int64
        numpy arrays with return_tensors="np"); padding="max_length" pads to
        max_length on `padding_side`."""
        single = isinstance(texts, str)
        batch = [self.encode(t, add_special_tokens, max_length, truncation)
                 for t in ([texts] if single else texts)]
        masks = [[1] * len(ids) for ids in batch]
        if padding:
            if padding != "max_length" or max_length is None:
                raise NotImplementedError("only padding='max_length' with max_length is ported")
            width = max_length
            if self.pad_token_id is None:
                raise ValueError("this tokenizer has no pad token")
            for ids, mask in zip(batch, masks):
                fill = width - len(ids)
                if fill > 0:
                    pads, zeros = [self.pad_token_id] * fill, [0] * fill
                    if self.padding_side == "left":
                        ids[:0], mask[:0] = pads, zeros
                    else:
                        ids.extend(pads)
                        mask.extend(zeros)
        if return_tensors == "np":
            return {"input_ids": np.asarray(batch, np.int64),
                    "attention_mask": np.asarray(masks, np.int64)}
        if return_tensors is not None:
            raise NotImplementedError(f"return_tensors={return_tensors!r}")
        if single:
            return {"input_ids": batch[0], "attention_mask": masks[0]}
        return {"input_ids": batch, "attention_mask": masks}

    # -- decoding

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        tokens = [self.id_to_token[int(i)] for i in ids
                  if int(i) in self.id_to_token
                  and not (skip_special_tokens and int(i) in self.special_ids)]
        text = self._decode(tokens)
        if self.clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return text

    # -- the chat template

    def apply_chat_template(self, conversation: list, tokenize: bool = False,
                            add_generation_prompt: bool = False, **kwargs) -> str:
        """The checkpoint's Jinja chat template rendered as transformers
        renders it (trim_blocks, lstrip_blocks, the loop controls, its
        `raise_exception` / `strftime_now` globals and `tojson` filter, the
        special tokens as variables); only tokenize=False is ported."""
        if tokenize:
            raise NotImplementedError("apply_chat_template(tokenize=True) is not ported")
        if not self.chat_template:
            raise ValueError("this tokenizer has no chat template")
        if self._template is None:
            self._template = self._compile_template()
        specials = {k: _token_text(self.config.get(k)) for k in (
            "bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
            "mask_token") if self.config.get(k) is not None}
        return self._template.render(messages=conversation, tools=None, documents=None,
                                     add_generation_prompt=add_generation_prompt,
                                     **{**specials, **kwargs})

    def _compile_template(self):
        from datetime import datetime

        import jinja2
        import jinja2.ext
        from jinja2.sandbox import ImmutableSandboxedEnvironment

        def raise_exception(message):
            raise jinja2.exceptions.TemplateError(message)

        def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
            return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                              sort_keys=sort_keys)

        env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                            extensions=[jinja2.ext.loopcontrols])
        env.filters["tojson"] = tojson
        env.globals["raise_exception"] = raise_exception
        env.globals["strftime_now"] = lambda fmt: datetime.now().strftime(fmt)
        return env.from_string(self.chat_template)


def _read_config(root: Path) -> dict:
    """tokenizer_config.json over special_tokens_map.json, with the chat
    template from chat_template.jinja / chat_template.json where present."""
    config = {}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        if (root / name).exists():
            config.update(json.loads((root / name).read_text(encoding="utf-8")))
    if (root / "chat_template.jinja").exists():
        config["chat_template"] = (root / "chat_template.jinja").read_text(encoding="utf-8")
    elif (root / "chat_template.json").exists():
        config["chat_template"] = json.loads(
            (root / "chat_template.json").read_text(encoding="utf-8"))["chat_template"]
    return config


def load_tokenizer(path) -> Tokenizer:
    """The tokenizer of a checkpoint's tokenizer directory (see the module
    docstring for the files read).  Raises FileNotFoundError where there is
    no directory or no tokenizer file in it (the adapters then fall back to
    the hash tokenizer, as JAX's do), ValueError where the directory holds
    only `spiece.model`."""
    root = Path(path)
    if not root.is_dir():
        raise FileNotFoundError(f"no tokenizer directory at {root}")
    config = _read_config(root)
    if (root / "tokenizer.json").exists():
        spec = json.loads((root / "tokenizer.json").read_text(encoding="utf-8"))
        return Tokenizer(spec, config)
    if (root / "vocab.json").exists() and (root / "merges.txt").exists():
        vocab = json.loads((root / "vocab.json").read_text(encoding="utf-8"))
        kind = config.get("tokenizer_class", "")
        if kind.startswith("CLIPTokenizer"):
            bos, eos, unk = (_token_text(config.get(k)) for k in ("bos_token", "eos_token",
                                                                  "unk_token"))
            spec = _clip_spec(vocab, _read_merges(root / "merges.txt", 49152 - 256 - 2),
                              unk, bos, eos)
        elif kind.startswith("Qwen2Tokenizer"):
            spec = _qwen2_spec(vocab, _read_merges(root / "merges.txt"))
        else:
            raise NotImplementedError(f"{root}: vocab.json + merges.txt of tokenizer_class "
                                      f"{kind!r} (CLIPTokenizer and Qwen2Tokenizer are ported)")
        spec["added_tokens"] = [
            {"id": int(i), **tok} for i, tok in config.get("added_tokens_decoder", {}).items()]
        if kind.startswith("CLIPTokenizer"):
            known = {t["content"] for t in spec["added_tokens"]}
            for name in ("bos_token", "eos_token", "unk_token", "pad_token"):
                tok = _token_text(config.get(name))
                if tok and tok in vocab and tok not in known:
                    spec["added_tokens"].append({"id": vocab[tok], "content": tok,
                                                 "special": True})
                    known.add(tok)
        return Tokenizer(spec, config)
    if (root / "spiece.model").exists():
        raise ValueError(
            f"{root} holds spiece.model but no tokenizer.json: the port reads SentencePiece "
            "models from tokenizer.json only (write it with transformers' T5TokenizerFast "
            "save_pretrained)")
    raise FileNotFoundError(f"{root}: no tokenizer.json, and no vocab.json + merges.txt")
