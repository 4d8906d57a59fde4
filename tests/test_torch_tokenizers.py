"""The port's first-party tokenizers (qflux_tpu_torch/models/tokenizers.py)
against `transformers.AutoTokenizer.from_pretrained` on the same files, the
tokenizers the JAX package's adapters load.

Every vocabulary is written here: `tokenizers` trains a byte-level BPE (and
a Unigram model) on a small corpus, and the test writes the directories the
checkpoints ship: CLIP's vocab.json + merges.txt with its tokenizer_config
and special_tokens_map (FLUX's tokenizer/), Qwen2's tokenizer.json (and
vocab.json + merges.txt with added_tokens_decoder) with the chat-template
special tokens (Qwen2.5-VL, Qwen3), and T5's Unigram tokenizer.json with a
Precompiled charsmap that the test builds itself (a full-width fold,
ligatures, compatibility forms and one composition), as FLUX's
tokenizer_2/.  Ids and attention masks must be equal, at the adapters'
exact calls: CLIP at 77 positions, T5 at 512 and 24, Qwen without special
tokens in the parts around the vision markers (EDIT_TEMPLATE,
Qwen-Image-Edit-Plus's "Picture i", DreamOmni2's enhancer turn), Klein's
rendered chat template at 512; and Qwen's decode.  No real T5 charsmap is
in the repository: the Precompiled normalizer is held to `tokenizers` on
the synthetic one only.
"""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)
from transformers import AutoTokenizer

from qflux_tpu_torch.models import tokenizers as ttok

REPO = Path(__file__).resolve().parent.parent

CORPUS = ["a photo of a cat sitting on the mat", "turn the sky orange at sunset",
          "add a red hat to the person", "Picture 1: the quick brown fox jumps over the lazy dog",
          "it's what they're doing, we'll see 12345 and 2024", "café naïve résumé 東京 タワー 😀",
          "Describe the key features of the input image (color, shape, size, texture)",
          "You are an expert in image editing. Rewrite the instruction."] * 30
LONG = " ".join(CORPUS[:8] * 12)
TEXTS = ["", "a photo of a cat", "It's what they're doing, we'll see; I'VE done it, DON'T",
         "numbers 12345 and 3.14159 in 2024!", "  runs   of spaces\n\nand\nnewlines\t\ttabs  \r\n",
         "café naïve résumé Ångström Ａｂｃ", "東京タワーと富士山、きれい。", "emoji 😀👍🏽 👨‍👩‍👧 🇫🇷 done",
         LONG]
QWEN_RE = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+"""
           r"""[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""")
QWEN_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|vision_start|>",
                 "<|vision_end|>", "<|image_pad|>"]
# a Qwen3-style chat template: block tags with and without whitespace control
# (trim_blocks / lstrip_blocks), loop controls, tojson and raise_exception
QWEN3_TEMPLATE = """{%- if messages[0].role not in ['system', 'user'] %}
    {{- raise_exception('the first message must be a system or user turn') }}
{%- endif %}
{%- for message in messages %}
    {%- if message.role == 'tool' %}{% continue %}{% endif %}
    {% if message.role == 'system' %}
<|im_start|>system
{{ message.content }}<|im_end|>
    {% else %}
{{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>\\n' }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}
{%- if tools %}{{ tools | tojson }}{% endif %}"""
# FLUX's T5 charsmap stand-in: a full-width fold, ligatures, compatibility
# forms, spaces, and one composition (a key of two characters)
CHARSMAP = {"Ａ": "A", "Ｂ": "B", "Ｃ": "C", "ｂ": "b", "ｃ": "c", "ｆ": "f", "ｕ": "u",
            "ｌ": "l", "ﬁ": "fi", "ﬀ": "ff", "①": "1", "②": "2", "㎏": "kg", "™": "TM",
            "　": " ", " ": " ", "é": "é"}
T5_TEXTS = TEXTS + ["ＡＢＣ ｆｕｌｌ width, ﬁne ﬀ ① ② 5㎏ Brand™", "Ａ́ é x y　z",
                    "tabs\tand\r\nbreaks   many    spaces", "unknown ∮ ∯ ☃☃ symbols"]


def _train(model, trainer, normalizer, pre_tokenizer):
    tok = Tokenizer(model)
    tok.normalizer, tok.pre_tokenizer = normalizer, pre_tokenizer
    tok.train_from_iterator(CORPUS, trainer)
    return json.loads(tok.to_str())["model"]


def _qwen_pipeline(tok):
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN_RE), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return tok


def _write_qwen(root: Path, json_form: bool, chat_template=None, padding_side="right") -> Path:
    """A Qwen2-style tokenizer directory: tokenizer.json (or vocab.json +
    merges.txt with added_tokens_decoder), the chat-template special tokens
    as special added tokens, <think> / </think> as plain added tokens."""
    root.mkdir(parents=True, exist_ok=True)
    probe = _qwen_pipeline(Tokenizer(models.BPE()))
    spec = _train(models.BPE(), trainers.BpeTrainer(
        vocab_size=420, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False), probe.normalizer, probe.pre_tokenizer)
    vocab, merges = spec["vocab"], [tuple(m) for m in spec["merges"]]
    added = [(t, True) for t in QWEN_SPECIALS] + [("<think>", False), ("</think>", False)]
    config = {"tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
              "pad_token": "<|endoftext|>", "unk_token": None, "bos_token": None,
              "padding_side": padding_side, "model_max_length": 32768,
              "clean_up_tokenization_spaces": False, "errors": "replace"}
    if chat_template:
        config["chat_template"] = chat_template
    if json_form:
        tok = _qwen_pipeline(Tokenizer(models.BPE(vocab, merges)))
        tok.add_tokens([AddedToken(t, special=s, normalized=False) for t, s in added])
        tok.save(str(root / "tokenizer.json"))
    else:
        (root / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
        (root / "merges.txt").write_text(
            "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
        config["added_tokens_decoder"] = {
            str(len(vocab) + i): {"content": t, "special": s, "lstrip": False, "rstrip": False,
                                  "normalized": False, "single_word": False}
            for i, (t, s) in enumerate(added)}
    (root / "tokenizer_config.json").write_text(json.dumps(config))
    return root


def _write_clip(root: Path) -> Path:
    """FLUX's tokenizer/ layout: vocab.json (the 256 byte symbols, the same
    with </w>, the merges' results, then <|startoftext|> and <|endoftext|>),
    merges.txt, tokenizer_config.json and special_tokens_map.json."""
    root.mkdir(parents=True, exist_ok=True)
    norm = normalizers.Sequence([normalizers.NFC(), normalizers.Replace(Regex(r"\s+"), " "),
                                 normalizers.Lowercase()])
    pre = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"""
                                   r"""[^\s\p{L}\p{N}]+"""), behavior="removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False)])
    spec = _train(models.BPE(end_of_word_suffix="</w>"), trainers.BpeTrainer(
        vocab_size=700, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        end_of_word_suffix="</w>", show_progress=False), norm, pre)
    base = sorted(ttok.bytes_to_unicode().values())
    vocab = {}
    for sym in base + [s + "</w>" for s in base]:
        vocab.setdefault(sym, len(vocab))
    merges = [tuple(m) for m in spec["merges"]]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    for sym in ("<|startoftext|>", "<|endoftext|>"):
        vocab[sym] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    bos = {"content": "<|startoftext|>", "lstrip": False, "normalized": True, "rstrip": False,
           "single_word": False, "__type": "AddedToken"}
    (root / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": bos, "eos_token": "<|endoftext|>",
        "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>", "model_max_length": 77,
        "do_lower_case": True, "errors": "replace", "add_prefix_space": False}))
    (root / "special_tokens_map.json").write_text(json.dumps({
        "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
        "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}))
    return root


def _t5_pipeline(tok, charsmap: bytes):
    tok.normalizer = normalizers.Sequence([normalizers.Precompiled(charsmap),
                                           normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.WhitespaceSplit(),
        pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")])
    return tok


def _write_t5(root: Path) -> Path:
    """FLUX's tokenizer_2/ layout: a Unigram tokenizer.json (<pad> 0,
    </s> 1, <unk> 2, the trained pieces, then <extra_id_99> .. <extra_id_0>)
    with the Precompiled charsmap of CHARSMAP and the collapse of repeated
    spaces, WhitespaceSplit + Metaspace, EOS appended; its config."""
    root.mkdir(parents=True, exist_ok=True)
    charsmap = ttok.build_precompiled_charsmap(CHARSMAP)
    probe = _t5_pipeline(Tokenizer(models.BPE()), charsmap)
    spec = _train(models.Unigram(), trainers.UnigramTrainer(
        vocab_size=260, special_tokens=["<pad>", "</s>", "<unk>"], unk_token="<unk>",
        show_progress=False), probe.normalizer, probe.pre_tokenizer)
    extra = [f"<extra_id_{i}>" for i in range(99, -1, -1)]
    vocab = [tuple(v) for v in spec["vocab"]] + [(t, 0.0) for t in extra]
    assert [p for p, _ in vocab[:3]] == ["<pad>", "</s>", "<unk>"]
    tok = _t5_pipeline(Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=False)), charsmap)
    tok.post_processor = processors.TemplateProcessing(single="$A </s>", pair="$A </s> $B </s>",
                                                       special_tokens=[("</s>", 1)])
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always")
    tok.add_special_tokens(["<pad>", "</s>", "<unk>"] + extra)
    tok.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "pad_token": "<pad>",
        "unk_token": "<unk>", "extra_ids": 100, "additional_special_tokens": extra,
        "model_max_length": 512, "legacy": True}))
    return root


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    return {"clip": _write_clip(root / "clip"), "t5": _write_t5(root / "t5"),
            "qwen": _write_qwen(root / "qwen", True),
            "qwen_vocab": _write_qwen(root / "qwen_vocab", False),
            "qwen3": _write_qwen(root / "qwen3", True, QWEN3_TEMPLATE),
            "qwen3_left": _write_qwen(root / "qwen3_left", True, QWEN3_TEMPLATE, "left")}


def _pair(dirs, name):
    return AutoTokenizer.from_pretrained(str(dirs[name])), ttok.load_tokenizer(dirs[name])


def _same_batch(ref, mine, texts, **kw):
    want = ref(texts, **kw)
    got = mine(texts, **kw)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        assert got[key].dtype == np.int64
    return got


def test_clip_matches_transformers(dirs):
    """FLUX's CLIP call (77 positions, BOS + ids + EOS, padded with the EOS
    id, long prompts cut): ids and attention masks equal transformers'
    CLIPTokenizerFast built from the same vocab.json + merges.txt."""
    ref, mine = _pair(dirs, "clip")
    got = _same_batch(ref, mine, TEXTS, padding="max_length", truncation=True, max_length=77,
                      return_tensors="np")
    assert got["input_ids"].shape == (len(TEXTS), 77)
    assert got["input_ids"][-1, -1] == ref.eos_token_id and got["attention_mask"][-1].all()
    for text in TEXTS:
        assert mine(text)["input_ids"] == ref(text)["input_ids"], text


@pytest.mark.parametrize("max_length", [512, 24])
def test_t5_matches_transformers(dirs, max_length):
    """FLUX's T5 call (512 positions, ids + EOS 1, pad 0; and cut at 24):
    the Unigram tokenizer.json with its Precompiled charsmap gives
    transformers' T5TokenizerFast's ids and masks, on texts that hit the
    charsmap (full-width, ligatures, compatibility forms, a composed pair,
    a key at the start of a grapheme cluster) and pieces no vocabulary
    entry covers (the unknown id, fused)."""
    ref, mine = _pair(dirs, "t5")
    _same_batch(ref, mine, T5_TEXTS, padding="max_length", truncation=True,
                max_length=max_length, return_tensors="np")


@pytest.mark.parametrize("name", ["qwen", "qwen_vocab"])
def test_qwen_matches_transformers(dirs, name):
    """Qwen2's byte-level BPE from tokenizer.json and from vocab.json +
    merges.txt with added_tokens_decoder: the special tokens as single ids,
    NFC, the pre-tokenizer regex; ids without special tokens (the
    adapters' call on each part between the vision markers), and padded to
    24 with masks."""
    ref, mine = _pair(dirs, name)
    for text in TEXTS + ["<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n<think>",
                         "é vs é, ﬁ stays"]:
        assert (mine(text, add_special_tokens=False)["input_ids"]
                == ref(text, add_special_tokens=False)["input_ids"]), text
    _same_batch(ref, mine, TEXTS, padding="max_length", truncation=True, max_length=24,
                return_tensors="np")


def _qwen_adapter_texts():
    """The texts the Qwen-family adapters tokenize: EDIT_TEMPLATE around a
    prompt (Qwen-Image-Edit), the same with Qwen-Image-Edit-Plus's
    "Picture i" references, and DreamOmni2's enhancer turn."""
    from qflux_tpu.trainer import qwen_edit as jqe
    from qflux_tpu.trainer import qwen_edit_plus as jqp

    plus = jqp.QwenImageEditPlusAdapter.__new__(jqp.QwenImageEditPlusAdapter)
    object.__setattr__(plus, "template", jqe.EDIT_TEMPLATE)
    out = []
    for prompt in ("turn the sky orange at sunset", "", "add a red hat, café 😀 12345"):
        out.append(jqe.EDIT_TEMPLATE.format(prompt))
        out.append(plus.format_prompt(prompt, 2))
        # qflux_tpu/trainer/dreamomni2.py:197-199, two reference images
        out.append("<|im_start|>user\n" + "<|vision_start|><|image_pad|><|vision_end|>" * 2
                   + f"{prompt} It is editing task.<|im_end|>\n<|im_start|>assistant\n")
    return out


def test_qwen_adapter_templates_match_transformers(dirs):
    """Every part the Qwen adapters hand the tokenizer (split at the vision
    markers, as `_tokenize_with_images` / `_vl_tokenize` split) gives
    transformers' ids, and so does the whole template."""
    from qflux_tpu_torch.trainer.qwen_edit import _VISION_MARKERS

    ref, mine = _pair(dirs, "qwen")
    for text in _qwen_adapter_texts():
        for part in _VISION_MARKERS.split(text) + [text]:
            if part:
                assert (mine(part, add_special_tokens=False)["input_ids"]
                        == ref(part, add_special_tokens=False)["input_ids"]), part


def test_qwen_decode_matches_transformers(dirs):
    """`decode(ids, skip_special_tokens=True)` (DreamOmni2's enhancer) and
    without skipping: transformers' strings, for ids of every text and for
    ids that split a UTF-8 character (the replacement character)."""
    ref, mine = _pair(dirs, "qwen")
    for text in TEXTS + ["<|im_start|>assistant\nA red hat, café 😀<|im_end|><|endoftext|>"]:
        ids = ref(text, add_special_tokens=False)["input_ids"]
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), (text, skip)
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, len(ref), 12).tolist()
        assert mine.decode(ids, skip_special_tokens=True) == ref.decode(
            ids, skip_special_tokens=True)


@pytest.mark.parametrize("name", ["qwen3", "qwen3_left"])
def test_klein_chat_template_matches_transformers(dirs, name):
    """Klein's one rendering, `apply_chat_template([{"role": "user",
    "content": p}], tokenize=False, add_generation_prompt=True,
    enable_thinking=False)`, on a Qwen3-style template: the same string as
    transformers', and the same ids and masks at Klein's 512 positions (on
    either padding side); a template's raise_exception raises."""
    import jinja2

    ref, mine = _pair(dirs, name)
    prompts = ["turn the sky orange", "", "café 😀\n\nline two", LONG]
    kw = {"tokenize": False, "add_generation_prompt": True, "enable_thinking": False}
    texts = []
    for p in prompts:
        msg = [{"role": "user", "content": p}]
        want = ref.apply_chat_template(msg, **kw)
        assert mine.apply_chat_template(msg, **kw) == want
        texts.append(want)
    assert texts[0].endswith("<think>\n\n</think>\n\n")
    _same_batch(ref, mine, texts, padding="max_length", truncation=True, max_length=512,
                return_tensors="np")
    system = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "x"}]
    assert mine.apply_chat_template(system, **kw) == ref.apply_chat_template(system, **kw)
    with pytest.raises(jinja2.exceptions.TemplateError, match="first message"):
        mine.apply_chat_template([{"role": "assistant", "content": "x"}], **kw)


def test_precompiled_charsmap_matches_tokenizers():
    """The charsmap the test builds (`build_precompiled_charsmap`) read by
    the port's normalizer equals `tokenizers.normalizers.Precompiled` on
    it: replacements longest-key-free (the shortest matching prefix, as
    SentencePiece's), per grapheme cluster under six bytes (a full-width A
    with a combining accent loses the accent), per character otherwise."""
    blob = ttok.build_precompiled_charsmap(CHARSMAP)
    ref = normalizers.Precompiled(blob)
    mine = ttok.Charsmap(blob)
    texts = T5_TEXTS + ["Ａ́̂̃ long cluster", "Ａ́", "\r\n\r\n", "ﬁ́",
                        "👍🏽Ａ", "ㄱ각Ａ", "🇫🇷Ａ🇫"]
    for text in texts:
        assert mine.normalize(text) == ref.normalize_str(text), repr(text)


def test_unigram_viterbi_matches_tokenizers(dirs):
    """The port's Viterbi over the piece scores against `tokenizers`'
    Unigram on the same vocabulary, piece by piece, for random strings over
    the corpus's characters plus characters no piece covers."""
    spec = json.loads((dirs["t5"] / "tokenizer.json").read_text())["model"]
    ref = models.Unigram([tuple(v) for v in spec["vocab"]], unk_id=spec["unk_id"],
                         byte_fallback=False)
    mine = ttok.Unigram(spec["vocab"], spec["unk_id"])
    alphabet = sorted(set("".join(CORPUS).lower().replace(" ", ""))) + ["∮", "☃", "Q", "▁"]
    rng = np.random.default_rng(1)
    for _ in range(300):
        piece = "▁" + "".join(rng.choice(alphabet, rng.integers(1, 12)))
        assert mine.tokenize(piece) == [t.id for t in ref.tokenize(piece)], piece


def test_spiece_model_alone_is_refused(tmp_path):
    """A directory with spiece.model and no tokenizer.json raises, naming
    the missing file; no tokenizer files at all is FileNotFoundError (the
    adapters' hash fallback)."""
    (tmp_path / "spiece.model").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="tokenizer.json"):
        ttok.load_tokenizer(tmp_path)
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(tmp_path / "missing")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(empty)


# ---------------------------------------------------------------------------
# adapter parity: each family's JAX adapter over transformers' tokenizer and
# the port's over its own hand their text encoders the same ids (the encoders
# are held to JAX on the same ids by test_torch_encoders.py,
# test_torch_qwen_encoders.py and test_torch_flux2_klein.py)

PROMPTS = ["turn the sky orange at sunset", "", "add a red hat, café 😀 12345", LONG]


def _checkpoint(tmp_path, dirs, **subdirs) -> Path:
    import shutil

    root = tmp_path / "checkpoint"
    for sub, name in subdirs.items():
        shutil.copytree(dirs[name], root / sub)
    return root


def test_flux_adapter_ids_match_jax(dirs, tmp_path, monkeypatch):
    """FLUX.1-Kontext's encode_prompt: CLIP's 77 and T5's 512 ids of every
    prompt, the JAX adapter over AutoTokenizer of tokenizer/ and
    tokenizer_2/ against the port's over `load_tokenizers` of the same
    checkpoint."""
    import jax.numpy as jnp
    import torch

    from qflux_tpu.trainer import flux_kontext as jfk
    from qflux_tpu_torch.trainer import flux_kontext as tfk

    root = _checkpoint(tmp_path, dirs, tokenizer="clip", tokenizer_2="t5")
    seen = {"jax": [], "port": []}

    def rec(side, clip):
        def encode(_params, _cfg, ids):
            seen[side].append(np.asarray(ids))
            lib = jnp if side == "jax" else torch
            out = lib.zeros((ids.shape[0], ids.shape[1], 4))
            return (out, lib.zeros((ids.shape[0], 4))) if clip else out
        return encode

    monkeypatch.setattr(jfk, "clip_encode_jit", rec("jax", True))
    monkeypatch.setattr(jfk, "t5_encode_jit", rec("jax", False))
    monkeypatch.setattr(tfk, "text_encoders", lambda bundle: {"clip": None, "t5": None})
    monkeypatch.setattr(tfk.te, "clip_encode", rec("port", True))
    monkeypatch.setattr(tfk.te, "t5_encode", rec("port", False))
    cfgs = {"clip": None, "t5": None}
    jb = SimpleNamespace(text_cfgs=cfgs, text_params=cfgs, tokenizers={
        "clip": AutoTokenizer.from_pretrained(str(root / "tokenizer")),
        "t5": AutoTokenizer.from_pretrained(str(root / "tokenizer_2"))})
    jfk.FluxKontextAdapter(None).encode_prompt(jb, PROMPTS, 512)
    tb = SimpleNamespace(text_cfgs=cfgs, tokenizers=tfk.load_tokenizers(root))
    assert isinstance(tb.tokenizers["t5"], ttok.Tokenizer)
    tfk.FluxKontextAdapter(None).encode_prompt(tb, PROMPTS, 512)
    assert [a.shape for a in seen["port"]] == [(4, 77), (4, 512)]
    for got, want in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ["qwen_edit", "qwen_edit_plus", "dreamomni2"])
def test_qwen_family_adapter_ids_match_jax(dirs, tmp_path, family):
    """The Qwen2.5-VL ids of each Qwen-family adapter, image tokens
    expanded: Qwen-Image-Edit's EDIT_TEMPLATE and Qwen-Image-Edit-Plus's
    "Picture i" template (`_tokenize_with_images`) and DreamOmni2's
    enhancer turn (`_vl_tokenize`), the JAX adapter over AutoTokenizer
    against the port's over its loader of the same checkpoint; and the
    enhancer's decode of the generated ids."""
    from qflux_tpu.models.qwen import vl_encoder as jvl
    from qflux_tpu.trainer import dreamomni2 as jd2
    from qflux_tpu.trainer import qwen_edit as jqe
    from qflux_tpu.trainer import qwen_edit_plus as jqp
    from qflux_tpu_torch.models.qwen import vl_encoder as tvl
    from qflux_tpu_torch.trainer import dreamomni2 as td2
    from qflux_tpu_torch.trainer import qwen_edit as tqe
    from qflux_tpu_torch.trainer import qwen_edit_plus as tqp

    root = _checkpoint(tmp_path, dirs, tokenizer="qwen")
    ref = AutoTokenizer.from_pretrained(str(root / "tokenizer"))
    mine = tqe.load_vl_tokenizer(root)
    assert isinstance(mine, ttok.Tokenizer)
    jb = SimpleNamespace(tokenizers={"vl": ref}, text_cfgs={"tokens": jvl.VLSpecialTokens()})
    tb = SimpleNamespace(tokenizers={"vl": mine}, text_cfgs={"tokens": tvl.VLSpecialTokens()})
    n_tok = [6, 4]
    for prompt in PROMPTS:
        if family == "dreamomni2":
            text = ("<|im_start|>user\n" + "<|vision_start|><|image_pad|><|vision_end|>" * 2
                    + f"{prompt}{td2.EDIT_SUFFIX}<|im_end|>\n<|im_start|>assistant\n")
            want = jd2.DreamOmni2Adapter(None)._vl_tokenize(jb, text, n_tok)
            got = td2.DreamOmni2Adapter(None)._vl_tokenize(tb, text, n_tok)
            assert mine.decode(got[-12:], skip_special_tokens=True).strip() == ref.decode(
                want[-12:], skip_special_tokens=True).strip()
        else:
            jad, tad = ((jqe.QwenImageEditAdapter(None), tqe.QwenImageEditAdapter(None))
                        if family == "qwen_edit" else
                        (jqp.QwenImageEditPlusAdapter(None), tqp.QwenImageEditPlusAdapter(None)))
            n = 1 if family == "qwen_edit" else 2
            text = tad.format_prompt(prompt, n)
            assert text == jad.format_prompt(prompt, n)
            want = jad._tokenize_with_images(jb, text, n_tok[:n])
            got = tad._tokenize_with_images(tb, text, n_tok[:n])
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert list(got).count(tvl.VLSpecialTokens().image_token_id) == sum(
            n_tok[:1 if family == "qwen_edit" else 2])


def test_klein_adapter_ids_match_jax(dirs, tmp_path, monkeypatch):
    """FLUX.2-Klein's encode_prompt: the chat template (thinking off)
    rendered and tokenized at 512 positions, ids and mask handed to Qwen3,
    the JAX adapter over AutoTokenizer against the port's over
    `load_qwen3_tokenizer` of the same checkpoint."""
    import jax.numpy as jnp
    import torch

    from qflux_tpu.trainer import flux2_klein as jkl
    from qflux_tpu_torch.trainer import flux2_klein as tkl

    root = _checkpoint(tmp_path, dirs, tokenizer="qwen3")
    seen = {"jax": [], "port": []}

    def rec(side):
        def encode(_params, _cfg, ids, attention_mask=None, hidden_states_layers=None):
            seen[side].append((np.asarray(ids), np.asarray(attention_mask)))
            return (jnp if side == "jax" else torch).zeros((ids.shape[0], ids.shape[1], 4))
        return encode

    monkeypatch.setattr(jkl.qwen3, "encode", rec("jax"))
    monkeypatch.setattr(tkl, "qwen3_encoder", lambda bundle: None)
    monkeypatch.setattr(tkl.qwen3, "encode", rec("port"))
    jb = SimpleNamespace(text_cfgs={"qwen3": None}, text_params={"qwen3": None},
                         tokenizers={"qwen3": AutoTokenizer.from_pretrained(
                             str(root / "tokenizer"))})
    jkl.Flux2KleinAdapter(None).encode_prompt(jb, PROMPTS, 512)
    tb = SimpleNamespace(text_cfgs={"qwen3": None},
                         tokenizers={"qwen3": tkl.load_qwen3_tokenizer(root)})
    tkl.Flux2KleinAdapter(None).encode_prompt(tb, PROMPTS, 512)
    (got_ids, got_mask), (want_ids, want_mask) = seen["port"][0], seen["jax"][0]
    assert got_ids.shape == (4, 512)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
