"""Character classes for the tokenizers: GPT-2's byte table, Unicode
White_Space, the `\\p{L}` / `\\p{N}` classes Oniguruma's regexes use (built
from `unicodedata`), and extended grapheme clusters (UAX #29 from
`unicodedata`'s categories)."""

from __future__ import annotations

import functools
import re
import unicodedata

# ---------------------------------------------------------------------------
# character classes


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """GPT-2's byte → printable character table: the printable Latin-1
    bytes map to themselves, the rest to 256 + n in order."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, n = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return table


# Unicode White_Space: Oniguruma's and Rust's `\s` / `is_whitespace` (Python's
# str.isspace adds U+001C..U+001F)
_WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


def _is_white(c: str) -> bool:
    return c.isspace() and not "\x1c" <= c <= "\x1f"


@functools.lru_cache(maxsize=None)
def _category_ranges(major: str) -> str:
    """The code points whose general category starts with `major` ("L":
    letters, "N": numbers) as the body of a regex character class."""
    out, start, prev = [], None, None
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            elif cp != prev + 1:
                out.append((start, prev))
                start = cp
            prev = cp
    if start is not None:
        out.append((start, prev))
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in out)


_CLASS_ESCAPES = {r"\p{L}": lambda: _category_ranges("L"), r"\p{N}": lambda: _category_ranges("N"),
                  r"\s": lambda: _WHITE_SPACE}


@functools.lru_cache(maxsize=None)
def _compile(pattern: str) -> re.Pattern:
    """A `tokenizers` regex (Oniguruma syntax) as a Python `re` pattern:
    `\\p{L}`, `\\p{N}` and `\\s` become explicit classes (inside a class
    their ranges join it), `\\S` the complement of `\\s`."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            esc = pattern[i:i + 5] if pattern.startswith(r"\p{", i) else pattern[i:i + 2]
            if esc in _CLASS_ESCAPES:
                body = _CLASS_ESCAPES[esc]()
                out.append(body if in_class else f"[{body}]")
            elif esc == r"\S":
                if in_class:
                    raise NotImplementedError(f"\\S inside a class in {pattern!r}")
                out.append(f"[^{_WHITE_SPACE}]")
            elif esc.startswith(r"\p"):
                raise NotImplementedError(f"the property {esc!r} of {pattern!r}")
            else:
                out.append(esc)
            i += len(esc)
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class and pattern[i - 1] != "[" and pattern[i - 2:i] != "[^":
            in_class = False
        out.append(c)
        i += 1
    return re.compile("".join(out))


# GPT-2's pre-tokenizer regex: ByteLevel's with use_regex
_GPT2_RE = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
# transformers' CLIPConverter and Qwen2Converter
_CLIP_RE = r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
_QWEN2_RE = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"""
             r""" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""")

# ---------------------------------------------------------------------------
# extended grapheme clusters (UAX #29, from unicodedata's categories)

_ZWJ, _ZWNJ = "\u200d", "\u200c"


def _is_control(c: str) -> bool:
    cat = unicodedata.category(c)
    return cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and c not in (_ZWNJ, _ZWJ))


def _is_extend(c: str) -> bool:
    cp = ord(c)
    return (unicodedata.category(c) in ("Mn", "Me", "Mc") or c in (_ZWNJ, _ZWJ)
            or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F or cp in (0xFF9E, 0xFF9F))


def _is_pictographic(c: str) -> bool:
    cp = ord(c)
    return (0x1F000 <= cp <= 0x1FAFF or 0x2600 <= cp <= 0x27BF or 0x2300 <= cp <= 0x23FF
            or 0x2B00 <= cp <= 0x2BFF or cp in (0xA9, 0xAE, 0x203C, 0x2049, 0x2122, 0x2139,
                                                0x3030, 0x303D, 0x3297, 0x3299))


def _hangul(c: str) -> str:
    cp = ord(c)
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return ""


def _graphemes(text: str) -> list:
    """`text` cut into extended grapheme clusters: CR LF together, controls
    alone, Hangul syllable sequences, a base with its extending and spacing
    marks, ZWJ emoji sequences and regional-indicator pairs."""
    out, i, n = [], 0, len(text)
    while i < n:
        j, c = i + 1, text[i]
        if c == "\r" and j < n and text[j] == "\n":
            out.append("\r\n")
            i += 2
            continue
        if not _is_control(c):
            ri = 0x1F1E6 <= ord(c) <= 0x1F1FF
            if ri and j < n and 0x1F1E6 <= ord(text[j]) <= 0x1F1FF:
                j += 1
            else:
                h = _hangul(c)
                while h and j < n:
                    nxt = _hangul(text[j])
                    if (h == "L" and nxt in ("L", "V", "LV", "LVT")) or (
                            h in ("LV", "V") and nxt in ("V", "T")) or (
                            h in ("LVT", "T") and nxt == "T"):
                        h, j = nxt, j + 1
                    else:
                        break
            while j < n:
                if _is_extend(text[j]) and not _is_control(text[j]):
                    j += 1
                elif (text[j - 1] == _ZWJ and _is_pictographic(text[j]) and
                      any(_is_pictographic(x) for x in text[i:j])):
                    j += 1
                else:
                    break
        out.append(text[i:j])
        i = j
    return out
