"""A reader of HuggingFace ``tokenizer.json`` files (the part of the
``tokenizers`` package the serving sidecar uses, in plain Python).

The JAX sidecar encodes and decodes text through ``tokenizers.Tokenizer``
(``modelx_tpu/dl/serve.py:161 _Tokenizer``). The port may not import that
package, so it reads the same file itself and gives the same ids and the
same strings for the components of the families it serves or queues:

- Llama-3: ``Split(regex, Isolated)`` + ``ByteLevel(use_regex=false)``,
  BPE with ``ignore_merges``, a ``TemplateProcessing`` bos, the
  ``ByteLevel`` decoder, special added tokens;
- Qwen2: the ``NFC`` normalizer, the same ``Split``, plain BPE, the
  ``ByteLevel`` post-processor;
- Llama-2 / Mistral: ``Prepend("▁")`` + ``Replace(" ", "▁")`` normalizers
  or a ``Metaspace`` pre-tokenizer, BPE with ``byte_fallback`` and
  ``fuse_unk``, the decoder ``Sequence[Replace, ByteFallback, Fuse, Strip]``;
- GPT-2: ``ByteLevel(use_regex=true)``;
- ``WordLevel`` + ``Whitespace`` with no decoder (tokens joined by a
  space);
- BERT: the ``BertNormalizer`` (``clean_text``, ``handle_chinese_chars``,
  ``strip_accents``, ``lowercase``), the ``BertPreTokenizer``, the
  ``WordPiece`` model and decoder, and ``BertProcessing`` or a
  ``TemplateProcessing`` for ``[CLS] ... [SEP]``.

Encoding runs the ``tokenizers`` pipeline step for step: added tokens that
are not ``normalized`` are cut out of the raw text first (leftmost-longest,
with ``single_word``, ``lstrip`` and ``rstrip``), the rest is normalized
and cut again on the normalized added tokens, pre-tokenized, and handed
word by word to the model; the post-processor adds the special tokens.
Decoding maps ids to tokens (added vocabulary first, ids outside both
skipped), runs the decoder chain and joins; invalid UTF-8 becomes U+FFFD
as ``String::from_utf8_lossy`` makes it.

Regex patterns are translated to Python's ``re``: ``\\p{..}`` classes
become explicit code-point classes built from ``unicodedata``, and ``\\s``
is Unicode's White_Space property, as the regex engine of ``tokenizers``
reads it (Python's ``\\s`` also takes U+001C-U+001F). Python 3.12's
``unicodedata`` is Unicode 15.0 and the regex tables of ``tokenizers``
0.22 are Unicode 16.0: the 5,812 code points assigned in between take
their categories from ``UNICODE_AFTER_15_0`` (the normalizers of
``tokenizers`` leave all of them unchanged, as ``unicodedata`` does). The
BERT components read older tables inside ``tokenizers`` (its control,
punctuation and non-spacing-mark classes predate Unicode 11) and Rust's
newer lowercase map; the code points where those differ from
``unicodedata`` are listed in the ``BERT_*`` tables below, each probed over
every code point against ``tokenizers`` 0.22.2. Any component type not
listed above raises ``UnsupportedTokenizerError`` at load, naming it:
nothing is ever encoded with part of the tokenizer ignored.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import unicodedata

# Unicode's White_Space property: Rust's char::is_whitespace and the \s of
# the regex engines inside tokenizers (not Python's \s, which adds
# U+001C..U+001F)
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
               "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_WS = frozenset(WHITE_SPACE)

# the pre-tokenizer GPT-2 and ByteLevel(use_regex=true) split with
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"

# the open roadmap item that brings what this reader still refuses (the
# Unigram model, the Precompiled normalizer, the Digits and Punctuation
# pre-tokenizers among them)
LATER_SLICE = "tokenizer components"


class UnsupportedTokenizerError(NotImplementedError):
    """A ``tokenizer.json`` component this reader does not implement."""

    def __init__(self, component: str) -> None:
        super().__init__(f"tokenizer.json component {component} is not supported")
        self.component = component


# -- Unicode classes ---------------------------------------------------------

# General categories of the code points Unicode 16.0 assigned that
# unicodedata (Unicode 15.0) calls Cn, as the regex engine of tokenizers
# 0.22.2 classes them (each \p{..} class probed over every Cn code point)
UNICODE_AFTER_15_0 = {
    "Lu": ((0x1C89, 0x1C89), (0xA7CB, 0xA7CC), (0xA7DA, 0xA7DA), (0xA7DC, 0xA7DC),
           (0x10D50, 0x10D65)),
    "Ll": ((0x1C8A, 0x1C8A), (0xA7CD, 0xA7CD), (0xA7DB, 0xA7DB), (0x10D70, 0x10D85)),
    "Lm": ((0x10D4E, 0x10D4E), (0x10D6F, 0x10D6F), (0x16D40, 0x16D42), (0x16D6B, 0x16D6C)),
    "Lo": ((0x105C0, 0x105F3), (0x10D4A, 0x10D4D), (0x10D4F, 0x10D4F), (0x10EC2, 0x10EC4),
           (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5),
           (0x113B7, 0x113B7), (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0),
           (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D43, 0x16D6A), (0x18CFF, 0x18CFF),
           (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D)),
    "Nd": ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
           (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA)),
    "Mn": ((0x0897, 0x0897), (0x10D69, 0x10D6D), (0x10EFC, 0x10EFC), (0x113BB, 0x113C0),
           (0x113CE, 0x113CE), (0x113D0, 0x113D0), (0x113D2, 0x113D2), (0x113E1, 0x113E2),
           (0x11F5A, 0x11F5A), (0x1611E, 0x16129), (0x1612D, 0x1612F), (0x1E5EE, 0x1E5EF)),
    "Mc": ((0x113B8, 0x113BA), (0x113C2, 0x113C2), (0x113C5, 0x113C5), (0x113C7, 0x113CA),
           (0x113CC, 0x113CD), (0x113CF, 0x113CF), (0x1612A, 0x1612C)),
    "Pd": ((0x10D6E, 0x10D6E),),
    "Po": ((0x1B4E, 0x1B4F), (0x1B7F, 0x1B7F), (0x113D4, 0x113D5), (0x113D7, 0x113D8),
           (0x11BE1, 0x11BE1), (0x16D6D, 0x16D6F), (0x1E5FF, 0x1E5FF)),
    "Sm": ((0x10D8E, 0x10D8F),),
    "So": ((0x2427, 0x2429), (0x2FFC, 0x2FFF), (0x31E4, 0x31E5), (0x31EF, 0x31EF),
           (0x1CC00, 0x1CCEF), (0x1CD00, 0x1CEB3), (0x1F8B2, 0x1F8BB), (0x1F8C0, 0x1F8C1),
           (0x1FA89, 0x1FA89), (0x1FA8F, 0x1FA8F), (0x1FABE, 0x1FABE), (0x1FAC6, 0x1FAC6),
           (0x1FADC, 0x1FADC), (0x1FADF, 0x1FADF), (0x1FAE9, 0x1FAE9), (0x1FBCB, 0x1FBEF)),
}


@functools.cache
def _newer_categories() -> dict[int, str]:
    return {cp: cat for cat, ranges in UNICODE_AFTER_15_0.items()
            for a, b in ranges for cp in range(a, b + 1)}


def category(ch: str) -> str:
    """The general category of ``ch`` as the tables of ``tokenizers`` give it."""
    return _newer_categories().get(ord(ch)) or unicodedata.category(ch)


@functools.cache
def _category_ranges() -> dict[str, list[tuple[int, int]]]:
    """General category (two letters, and one letter for the major class)
    -> sorted code-point ranges, from one pass over ``unicodedata`` and
    ``UNICODE_AFTER_15_0``."""
    newer = _newer_categories()
    out: dict[str, list[list[int]]] = {}
    for cp in range(0x110000):
        cat = newer.get(cp) or unicodedata.category(chr(cp))
        for key in (cat, cat[0]):
            rngs = out.setdefault(key, [])
            if rngs and rngs[-1][1] == cp - 1:
                rngs[-1][1] = cp
            else:
                rngs.append([cp, cp])
    return {k: [(a, b) for a, b in v] for k, v in out.items()}


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}" if cp > 0xFFFF else f"\\u{cp:04x}"


def _class_body(ranges) -> str:
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


@functools.cache
def _named_class(name: str) -> str:
    """Class body (no brackets) for a ``\\p{name}`` general category, or
    ``s`` (White_Space) / ``d`` (Nd)."""
    if name == "s":
        return _class_body((ord(c), ord(c)) for c in WHITE_SPACE)
    if name == "d":
        name = "Nd"
    ranges = _category_ranges().get(name)
    if ranges is None or name == "Cn":
        raise UnsupportedTokenizerError(f"regex class \\p{{{name}}}")
    return _class_body(ranges)


@functools.cache
def _word_class() -> str:
    """The \\w of Rust's regex crate (the Whitespace pre-tokenizer and the
    added tokens' single_word check): Alphabetic, marks, Nd, Pc and
    Join_Control. Alphabetic is the letters, Nl and Other_Alphabetic, whose
    code points outside the marks are the circled and squared letters."""
    extra = [(0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
             (0x1F170, 0x1F189)]
    return "".join(_named_class(c) for c in ("L", "M", "Nd", "Nl", "Pc")) + _class_body(extra)


def translate_regex(pattern: str) -> str:
    """A pattern of the regex engine inside ``tokenizers`` as a Python
    ``re`` pattern: ``\\p{X}``/``\\P{X}``, ``\\s``/``\\S`` and ``\\d``/``\\D``
    become explicit classes. Constructs whose meaning differs between the
    engines (``\\w``, ``\\b``, anchors, nested classes) raise."""
    out: list[str] = []
    i, n, in_class = 0, len(pattern), False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    j = pattern.index("}", i + 2)
                    name, i = pattern[i + 3:j], j + 1
                else:
                    name, i = pattern[i + 2:i + 3], i + 3
                body, neg = _named_class(name), nxt == "P"
            elif nxt in "sSdD":
                body, neg, i = _named_class(nxt.lower()), nxt.isupper(), i + 2
            elif nxt.isalpha() and nxt not in "rntfvxu":
                raise UnsupportedTokenizerError(f"regex escape \\{nxt} in {pattern!r}")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                if neg:
                    raise UnsupportedTokenizerError(f"negated class inside a set in {pattern!r}")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            continue
        if in_class:
            if c == "[" or pattern.startswith("&&", i):
                raise UnsupportedTokenizerError(f"nested character class in {pattern!r}")
            if c == "]":
                in_class = False
        elif c == "[":
            in_class = True
            out.append(c)
            i += 1
            if pattern.startswith("^", i):
                out.append("^")
                i += 1
            if pattern.startswith("]", i):  # a literal ] first in the set
                out.append("\\]")
                i += 1
            continue
        elif c in "^$":
            raise UnsupportedTokenizerError(f"regex anchor {c} in {pattern!r}")
        out.append(c)
        i += 1
    return "".join(out)


def _compile(pattern: dict):
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern object as a compiled
    Python regex."""
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    if "Regex" in pattern:
        try:
            return re.compile(translate_regex(pattern["Regex"]))
        except re.error as e:
            raise UnsupportedTokenizerError(f"regex {pattern['Regex']!r} ({e})") from None
    raise UnsupportedTokenizerError(f"pattern {pattern!r}")


# -- the BERT components' character classes ---------------------------------
# (lo, hi) code-point ranges, inclusive, as tokenizers 0.22.2 classes them

# what BertNormalizer's clean_text removes: NUL, U+FFFD and its control
# class (Cc, Cf and Co of an older Unicode; tab, newline and CR excepted),
# and the lone surrogates no Rust string can hold
BERT_REMOVED = (
    (0x0, 0x8), (0xB, 0xC), (0xE, 0x1F), (0x7F, 0x9F), (0xAD, 0xAD), (0x600, 0x605),
    (0x61C, 0x61C), (0x6DD, 0x6DD), (0x70F, 0x70F), (0x180E, 0x180E), (0x200B, 0x200F),
    (0x202A, 0x202E), (0x2060, 0x2064), (0x2066, 0x206F), (0xD800, 0xF8FF), (0xFEFF, 0xFEFF),
    (0xFFF9, 0xFFFB), (0xFFFD, 0xFFFD), (0x110BD, 0x110BD), (0x1BCA0, 0x1BCA3),
    (0x1D173, 0x1D17A), (0xE0001, 0xE0001), (0xE0020, 0xE007F), (0xF0000, 0xFFFFD),
    (0x100000, 0x10FFFD),
)
# handle_chinese_chars: the CJK ideograph blocks that get a space each side
BERT_CHINESE = (
    (0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xF900, 0xFAFF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B81F), (0x2B920, 0x2CEAF), (0x2F800, 0x2FA1F),
)
# BertPreTokenizer's punctuation is ASCII punctuation and category P, less
# these (assigned P after its tables), plus U+166D and U+111C9
BERT_NOT_PUNCT = (
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77), (0xC84, 0xC84),
    (0x1B4E, 0x1B4F), (0x1B7D, 0x1B7F), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D), (0x10D6E, 0x10D6E),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89), (0x113D4, 0x113D5),
    (0x113D7, 0x113D8), (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B), (0x11944, 0x11946),
    (0x119E2, 0x119E2), (0x11A3F, 0x11A46), (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2),
    (0x11B00, 0x11B09), (0x11BE1, 0x11BE1), (0x11C41, 0x11C45), (0x11C70, 0x11C71),
    (0x11EF7, 0x11EF8), (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16D6D, 0x16D6F), (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E5FF, 0x1E5FF),
    (0x1E95E, 0x1E95F),
)
BERT_EXTRA_PUNCT = ((0x166D, 0x166D), (0x111C9, 0x111C9))
# strip_accents drops category Mn after NFD, less these (assigned Mn after
# its tables), plus U+1734; U+11938 is left whole by its NFD
BERT_KEPT_MARKS = (
    (0x7FD, 0x7FD), (0x897, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE), (0xAFA, 0xAFF),
    (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C), (0xD00, 0xD00), (0xD3B, 0xD3C),
    (0xD81, 0xD81), (0xEBA, 0xEBA), (0xECE, 0xECE), (0x180F, 0x180F), (0x1885, 0x1886),
    (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFB), (0xA82C, 0xA82C), (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF),
    (0xA9BD, 0xA9BD), (0x10D24, 0x10D27), (0x10D69, 0x10D6D), (0x10EAB, 0x10EAC),
    (0x10EFC, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070),
    (0x11073, 0x11074), (0x110C2, 0x110C2), (0x111C9, 0x111C9), (0x111CF, 0x111CF),
    (0x1123E, 0x1123E), (0x11241, 0x11241), (0x1133B, 0x1133B), (0x113BB, 0x113C0),
    (0x113CE, 0x113CE), (0x113D0, 0x113D0), (0x113D2, 0x113D2), (0x113E1, 0x113E2),
    (0x11438, 0x1143F), (0x11442, 0x11444), (0x11446, 0x11446), (0x1145E, 0x1145E),
    (0x1182F, 0x11837), (0x11839, 0x1183A), (0x1193B, 0x1193C), (0x1193E, 0x1193E),
    (0x11943, 0x11943), (0x119D4, 0x119D7), (0x119DA, 0x119DB), (0x119E0, 0x119E0),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A38), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47),
    (0x11A51, 0x11A56), (0x11A59, 0x11A5B), (0x11A8A, 0x11A96), (0x11A98, 0x11A99),
    (0x11C30, 0x11C36), (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7),
    (0x11CAA, 0x11CB0), (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6), (0x11D31, 0x11D36),
    (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45), (0x11D47, 0x11D47),
    (0x11D90, 0x11D91), (0x11D95, 0x11D95), (0x11D97, 0x11D97), (0x11EF3, 0x11EF4),
    (0x11F00, 0x11F01), (0x11F36, 0x11F3A), (0x11F40, 0x11F40), (0x11F42, 0x11F42),
    (0x11F5A, 0x11F5A), (0x13440, 0x13440), (0x13447, 0x13455), (0x1611E, 0x16129),
    (0x1612D, 0x1612F), (0x16F4F, 0x16F4F), (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D),
    (0x1CF30, 0x1CF46), (0x1E000, 0x1E006), (0x1E008, 0x1E018), (0x1E01B, 0x1E021),
    (0x1E023, 0x1E024), (0x1E026, 0x1E02A), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136),
    (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF), (0x1E5EE, 0x1E5EF),
    (0x1E944, 0x1E94A),
)
# the NFD inside tokenizers predates these combining classes: it reorders
# none of these code points (each a starter to it)
BERT_NFD_STARTERS = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE), (0xC3C, 0xC3C),
    (0xD3B, 0xD3C), (0xEBA, 0xEBA), (0x1715, 0x1715), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFA),
    (0xA82C, 0xA82C), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF),
    (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070), (0x1133B, 0x1133B),
    (0x1145E, 0x1145E), (0x11839, 0x1183A), (0x1193D, 0x1193E), (0x11943, 0x11943),
    (0x119E0, 0x119E0), (0x11A34, 0x11A34), (0x11A47, 0x11A47), (0x11A99, 0x11A99),
    (0x11D42, 0x11D42), (0x11D44, 0x11D45), (0x11D97, 0x11D97), (0x11F41, 0x11F42),
    (0x16FF0, 0x16FF1), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF),
)
# lowercase pairs of Unicode 16.0 (Rust's to_lowercase) that unicodedata's
# 15.0 lacks: (lo, hi, offset to the lowercase)
BERT_LOWER_AFTER_15_0 = (
    (0x1C89, 0x1C89, 1), (0xA7CB, 0xA7CB, 0x264 - 0xA7CB), (0xA7CC, 0xA7CC, 1),
    (0xA7CE, 0xA7CE, 1), (0xA7D2, 0xA7D2, 1), (0xA7D4, 0xA7D4, 1), (0xA7DA, 0xA7DA, 1),
    (0xA7DC, 0xA7DC, 0x19B - 0xA7DC), (0x10D50, 0x10D65, 0x20), (0x16EA0, 0x16EB8, 0x1B),
)


def _cp_set(*tables) -> frozenset:
    return frozenset(cp for table in tables for a, b, *_ in table for cp in range(a, b + 1))


@functools.cache
def _bert_classes() -> dict:
    """The BERT components' classes as sets and maps, built on first use."""
    lower = {chr(cp): chr(cp + d) for a, b, d in BERT_LOWER_AFTER_15_0 for cp in range(a, b + 1)}
    return {
        "removed": _cp_set(BERT_REMOVED),
        "chinese": _cp_set(BERT_CHINESE),
        "not_punct": _cp_set(BERT_NOT_PUNCT),
        "extra_punct": _cp_set(BERT_EXTRA_PUNCT),
        "kept_marks": _cp_set(BERT_KEPT_MARKS),
        "nfd_starters": _cp_set(BERT_NFD_STARTERS),
        "lower": lower,
    }


_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def bert_is_punct(ch: str) -> bool:
    """BertPreTokenizer's punctuation test."""
    if ch in _ASCII_PUNCT:
        return True
    classes, cp = _bert_classes(), ord(ch)
    if cp in classes["extra_punct"]:
        return True
    return category(ch)[0] == "P" and cp not in classes["not_punct"]


def _bert_normalizer(spec: dict):
    """BertNormalizer: clean_text, handle_chinese_chars, strip_accents (null
    follows lowercase) and lowercase, in that order, each per character."""
    clean = bool(spec.get("clean_text", True))
    chinese = bool(spec.get("handle_chinese_chars", True))
    lowercase = bool(spec.get("lowercase", True))
    strip = spec.get("strip_accents")
    strip = lowercase if strip is None else bool(strip)
    classes = _bert_classes()
    removed, cjk, kept, lower = (classes["removed"], classes["chinese"], classes["kept_marks"],
                                 classes["lower"])

    def stripped(s: str) -> str:
        return "".join(c for c in _tokenizers_nfd(s)
                       if not ((category(c) == "Mn" and ord(c) not in kept) or c == "\u1734"))

    def norm(s: str) -> str:
        if clean:
            s = "".join(" " if c in _WS else c for c in s if ord(c) not in removed)
        if chinese:
            s = "".join(f" {c} " if ord(c) in cjk else c for c in s)
        if strip:
            s = stripped(s)
        if lowercase:
            s = "".join(lower.get(c) or c.lower() for c in s)
        return s
    return norm


def _tokenizers_nfd(s: str) -> str:
    """NFD as the BertNormalizer's strip_accents computes it: each character
    decomposed (U+11938 left whole), then canonical ordering, in which the
    ``BERT_NFD_STARTERS`` code points count as starters."""
    starters = _bert_classes()["nfd_starters"]
    chars = [d for c in s for d in (c if c == "\U00011938" else unicodedata.normalize("NFD", c))]
    out, run = [], []
    for c in chars:
        ccc = 0 if ord(c) in starters else unicodedata.combining(c)
        if ccc:
            run.append((ccc, len(run), c))
            continue
        if run:
            out.extend(c for _, _, c in sorted(run))
            run = []
        out.append(c)
    out.extend(c for _, _, c in sorted(run))
    return "".join(out)


# -- byte-level alphabet -----------------------------------------------------


@functools.cache
def _byte_chars() -> tuple[dict[int, str], dict[str, int]]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    keep = [*range(0x21, 0x7F), *range(0xA1, 0xAD), *range(0xAE, 0x100)]
    b2c, extra = {}, 0
    for b in range(256):
        if b in keep:
            b2c[b] = chr(b)
        else:
            b2c[b] = chr(256 + extra)
            extra += 1
    return b2c, {c: b for b, c in b2c.items()}


def _to_byte_chars(s: str) -> str:
    b2c = _byte_chars()[0]
    return "".join(b2c[b] for b in s.encode("utf-8"))


# -- normalizers ----------------------------------------------------------


def _normalizer(spec):
    """``spec`` -> a str -> str function, or None."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def seq(s: str) -> str:
            for step in steps:
                s = step(s)
            return s
        return seq
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda s: prefix + s if s else s
    if kind == "Replace":
        rx, content = _compile(spec["pattern"]), spec["content"]
        return lambda s: rx.sub(lambda _m: content, s)
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    raise UnsupportedTokenizerError(f"normalizer {kind}")


# -- pre-tokenizers --------------------------------------------------------
# a pre-tokenizer maps [(text, at_start)] -> [(text, at_start)], where
# at_start says the piece begins at offset 0 of the original input (what
# Metaspace's prepend_scheme "first" reads); empty pieces are dropped


def split_pieces(text: str, rx, behavior: str, invert: bool = False) -> list[tuple[int, int]]:
    """``(start, end)`` pieces of ``text`` cut by ``rx``'s matches as the
    ``tokenizers`` split behaviors cut them; empty pieces dropped."""
    segs, prev = [], 0
    for m in rx.finditer(text):
        if m.start() != prev:
            segs.append([prev, m.start(), invert])
        segs.append([m.start(), m.end(), not invert])
        prev = m.end()
    if prev != len(text):
        segs.append([prev, len(text), invert])
    if behavior == "Removed":
        out = [s for s in segs if not s[2]]
    elif behavior == "Isolated":
        out = segs
    elif behavior in ("MergedWithPrevious", "MergedWithNext"):
        nxt = behavior == "MergedWithNext"
        out, previous = [], False
        for s in reversed(segs) if nxt else segs:
            if s[2] and not previous and out:
                out[-1][0 if nxt else 1] = s[0 if nxt else 1]
            else:
                out.append(list(s))
            previous = s[2]
        if nxt:
            out.reverse()
    elif behavior == "Contiguous":
        out, previous = [], False
        for s in segs:
            if s[2] == previous and out:
                out[-1][1] = s[1]
            else:
                out.append(list(s))
            previous = s[2]
    else:
        raise UnsupportedTokenizerError(f"split behavior {behavior}")
    return [(a, b) for a, b, _ in out if b > a]


def _splitter(rx, behavior: str, invert: bool = False):
    def split(pieces):
        return [(text[a:b], at_start and a == 0)
                for text, at_start in pieces
                for a, b in split_pieces(text, rx, behavior, invert)]
    return split


def _pre_tokenizer(spec):
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return seq
    if kind == "Split":
        return _splitter(_compile(spec["pattern"]), spec["behavior"], bool(spec.get("invert")))
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space"))
        split = (_splitter(re.compile(translate_regex(GPT2_PATTERN)), "Isolated")
                 if spec.get("use_regex", True) else None)

        def byte_level(pieces):
            if prefix:
                pieces = [(t if t.startswith(" ") else " " + t, s) for t, s in pieces]
            if split is not None:
                pieces = split(pieces)
            return [(_to_byte_chars(t), s) for t, s in pieces]
        return byte_level
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # the older serialization
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        split = _splitter(re.compile(re.escape(rep)), "MergedWithNext") if spec.get(
            "split", True) else None

        def metaspace(pieces):
            out = []
            for text, at_start in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and at_start)):
                    text = rep + text
                out.append((text, at_start))
            return split(out) if split is not None else out
        return metaspace
    if kind == "Whitespace":
        w = _word_class()
        return _splitter(re.compile(f"[{w}]+|[^{w}{_named_class('s')}]+"), "Removed", invert=True)
    if kind == "BertPreTokenizer":
        return _bert_pre_tokenize
    raise UnsupportedTokenizerError(f"pre_tokenizer {kind}")


def _bert_pre_tokenize(pieces):
    """BertPreTokenizer: split on whitespace (removed), then each
    punctuation character is a piece of its own."""
    out = []
    for text, at_start in pieces:
        start, word = 0, []
        for i, ch in enumerate(text):
            if ch in _WS or bert_is_punct(ch):
                if word:
                    out.append(("".join(word), at_start and start == 0))
                    word = []
                if ch not in _WS:
                    out.append((ch, at_start and i == 0))
                start = i + 1
            else:
                word.append(ch)
        if word:
            out.append(("".join(word), at_start and start == 0))
    return out


# -- models -----------------------------------------------------------------


class _WordLevel:
    def __init__(self, spec: dict) -> None:
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")

    def tokenize(self, word: str) -> list[int]:
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk)
            if tid is None:
                raise ValueError(f"WordLevel: {word!r} is not in the vocab and it has no "
                                 f"unk token")
        return [tid]


class _WordPiece:
    """Greedy longest-match-first subwords; a word longer than
    ``max_input_chars_per_word`` characters, or one with a piece no vocab
    entry covers, is the unk token alone."""

    def __init__(self, spec: dict) -> None:
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))

    def _unk(self) -> list[int]:
        tid = self.vocab.get(self.unk)
        if tid is None:
            raise ValueError(f"WordPiece: the unk token {self.unk!r} is not in the vocab")
        return [tid]

    def tokenize(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return self._unk()
        out, start, n = [], 0, len(word)
        while start < n:
            end = n
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                tid = self.vocab.get(sub)
                if tid is not None:
                    break
                end -= 1
            else:
                return self._unk()
            out.append(tid)
            start = end
        return out


class _BPE:
    CACHE_CAPACITY = 10_000  # words; as in tokenizers, full = no new entries

    def __init__(self, spec: dict) -> None:
        if spec.get("dropout"):
            raise UnsupportedTokenizerError("BPE dropout")
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        vocab, plen = self.vocab, len(self.prefix)
        # (left id, right id) -> (rank, merged id); a repeated pair keeps
        # its last rank, as tokenizers' map does
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or ()):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self.merges[(vocab[a], vocab[b])] = (rank, vocab[a + b[plen:]])
            except KeyError as e:
                raise ValueError(f"BPE merge {a!r} {b!r}: {e.args[0]!r} is not in the "
                                 f"vocab") from None
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if self.ignore_merges:
            tid = self.vocab.get(word)
            if tid is not None:
                return [tid]
        got = self._cache.get(word)
        if got is None:
            got = self._merge(self._symbols(word))
            if len(self._cache) < self.CACHE_CAPACITY:
                self._cache[word] = got
        return list(got)

    def _symbols(self, word: str) -> list[int]:
        """The word's characters as ids: prefix/suffix applied, byte
        fallback, unknowns fused when asked (tokenizers' merge_word)."""
        vocab, out, unk = self.vocab, [], None
        last = len(word) - 1
        for i, ch in enumerate(word):
            s = (self.prefix + ch if i and self.prefix else ch) + (
                self.suffix if i == last else "")
            tid = vocab.get(s)
            if tid is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(tid)
                continue
            if self.byte_fallback:
                ids = [vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if None not in ids:
                    out.extend(ids)
                    continue
            if self.unk is not None:
                unk_id = vocab.get(self.unk)
                if unk_id is None:
                    raise ValueError(f"BPE: the unk token {self.unk!r} is not in the vocab")
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = unk_id
        if unk is not None:
            out.append(unk)
        return out

    def _merge(self, ids: list[int]) -> list[int]:
        """Apply merges lowest rank first, leftmost first among equal ranks
        (tokenizers' Word::merge_all)."""
        n, merges = len(ids), self.merges
        if n < 2:
            return ids
        c = list(ids)
        prev, nxt = list(range(-1, n - 1)), list(range(1, n + 1))
        nxt[-1] = -1
        gone = [False] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            j = nxt[pos]
            if gone[pos] or j == -1:
                continue
            m = merges.get((c[pos], c[j]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            c[pos], gone[j] = new_id, True
            k = nxt[pos] = nxt[j]
            if k != -1:
                prev[k] = pos
            p = prev[pos]
            if p != -1 and (m := merges.get((c[p], c[pos]))) is not None:
                heapq.heappush(heap, (m[0], p, m[1]))
            if k != -1 and (m := merges.get((c[pos], c[k]))) is not None:
                heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, g in zip(c, gone) if not g]


def _model(spec: dict):
    kind = spec.get("type")
    if kind is None and "merges" in spec:
        kind = "BPE"  # older files leave the model's type out
    if kind == "BPE":
        return _BPE(spec)
    if kind == "WordLevel":
        return _WordLevel(spec)
    if kind == "WordPiece":
        return _WordPiece(spec)
    raise UnsupportedTokenizerError(f"model {kind}")


# -- post-processors -------------------------------------------------------


def _post_processor(spec) -> tuple[list[int], list[int]]:
    """(ids before, ids after) the sequence when special tokens are added."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind == "Sequence":
        before, after = [], []
        for p in spec["processors"]:
            b, a = _post_processor(p)
            before, after = b + before, after + a
        return before, after
    if kind == "ByteLevel":  # offsets only
        return [], []
    if kind == "BertProcessing":  # [CLS] A [SEP]
        return [int(spec["cls"][1])], [int(spec["sep"][1])]
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens") or {}
        before, after, seen = [], [], False
        for piece in spec["single"]:
            if "Sequence" in piece:
                if piece["Sequence"]["id"] != "A" or seen:
                    raise UnsupportedTokenizerError("TemplateProcessing single template "
                                                    f"{spec['single']!r}")
                seen = True
            else:
                (before if not seen else after).extend(
                    specials[piece["SpecialToken"]["id"]]["ids"])
        return before, after
    raise UnsupportedTokenizerError(f"post_processor {kind}")


# -- decoders ------------------------------------------------------------------


def _lossy(data: bytes) -> str:
    return data.decode("utf-8", errors="replace")


_BYTE_TOKEN = re.compile(r"<0x(\+?[0-9A-Fa-f]{1,2})>")


def _decoder(spec):
    """``spec`` -> a list[str] -> list[str] function (tokenizers'
    decode_chain), or None."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        c2b = _byte_chars()[1]

        def byte_level(tokens):
            data = bytearray()
            for t in tokens:
                if all(ch in c2b for ch in t):
                    data.extend(c2b[ch] for ch in t)
                else:
                    data.extend(t.encode("utf-8"))
            return [_lossy(bytes(data))]
        return byte_level
    if kind == "Replace":
        rx, content = _compile(spec["pattern"]), spec["content"]
        return lambda tokens: [rx.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":
        def byte_fallback(tokens):
            out, pending = [], bytearray()

            def flush():
                if pending:
                    try:
                        out.append(bytes(pending).decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("�" * len(pending))
                    pending.clear()

            for t in tokens:
                m = _BYTE_TOKEN.fullmatch(t) if len(t) == 6 else None
                if m is not None:
                    pending.append(int(m.group(1), 16))
                else:
                    flush()
                    out.append(t)
            flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], int(spec["start"]), int(spec["stop"])

        def strip(tokens):
            out = []
            for t in tokens:
                i = 0
                while i < min(start, len(t)) and t[i] == content:
                    i += 1
                j, k = len(t), 0
                while k < stop and j > i and t[j - 1] == content:
                    j, k = j - 1, k + 1
                out.append(t[i:j])
            return out
        return strip
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        drop_first = scheme != "never"
        return lambda tokens: [
            t.replace(rep, "" if i == 0 and drop_first else " ") for i, t in enumerate(tokens)]
    if kind == "WordPiece":
        prefix, cleanup = spec.get("prefix", "##"), bool(spec.get("cleanup", True))

        def wordpiece(tokens):
            out = []
            for i, t in enumerate(tokens):
                if i:
                    t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
                out.append(_wordpiece_cleanup(t) if cleanup else t)
            return out
        return wordpiece
    raise UnsupportedTokenizerError(f"decoder {kind}")


_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))


def _wordpiece_cleanup(text: str) -> str:
    """The WordPiece decoder's ``cleanup``: spaces before punctuation and
    English contractions dropped, in this order."""
    for a, b in _CLEANUP:
        text = text.replace(a, b)
    return text


# -- the tokenizer ---------------------------------------------------------------


class _AddedTokens:
    """Added tokens of one kind (normalized or not) as one matcher."""

    def __init__(self, tokens: list[tuple[str, dict]]) -> None:
        self.tokens = {content: tok for content, tok in tokens}
        # leftmost-longest: longer alternatives first
        alts = sorted(self.tokens, key=len, reverse=True)
        self.rx = re.compile("|".join(map(re.escape, alts))) if alts else None
        self._word = re.compile(f"[{_word_class()}]") if alts else None

    def split(self, text: str) -> list[tuple[int, int, int | None]]:
        """(start, end, added id or None) pieces of ``text`` (tokenizers'
        AddedVocabulary::find_matches)."""
        if self.rx is None or not text:
            return [(0, len(text), None)]
        out, done = [], 0
        for m in self.rx.finditer(text):
            start, stop = m.start(), m.end()
            tok = self.tokens[m.group()]
            if tok.get("single_word") and (
                    (start > 0 and self._word.match(text, start - 1))
                    or (stop < len(text) and self._word.match(text, stop))):
                continue
            if tok.get("lstrip"):
                s = start
                while s > 0 and text[s - 1] in _WS:
                    s -= 1
                start = max(s, done)
            if tok.get("rstrip"):
                while stop < len(text) and text[stop] in _WS:
                    stop += 1
            if done < start:
                out.append((done, start, None))
            out.append((start, stop, tok["id"]))
            done = stop
        if done != len(text):
            out.append((done, len(text), None))
        return out


class Tokenizer:
    """``tokenizer.json`` -> encode / decode / token_to_id, as
    ``tokenizers.Tokenizer`` gives them for the supported components."""

    def __init__(self, spec: dict) -> None:
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise UnsupportedTokenizerError(key)
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._model = _model(spec["model"])
        self._bos, self._eos = _post_processor(spec.get("post_processor"))
        self._decode = _decoder(spec.get("decoder"))
        added = spec.get("added_tokens") or []
        self._added_by_id = {int(t["id"]): t["content"] for t in added}
        self._added_ids = {t["content"]: int(t["id"]) for t in added}
        self._special = {t["content"] for t in added if t.get("special")}
        self._raw_added = _AddedTokens([(t["content"], t) for t in added
                                        if not t.get("normalized")])
        # normalized added tokens match the normalized text, so their
        # content is normalized too
        norm = self._normalize or (lambda s: s)
        self._norm_added = _AddedTokens([(norm(t["content"]), t) for t in added
                                         if t.get("normalized")])
        self._id_to_token = {i: t for t, i in self._model.vocab.items()}

    @classmethod
    def from_str(cls, text: str) -> Tokenizer:
        return cls(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> Tokenizer:
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def token_to_id(self, token: str) -> int | None:
        tid = self._added_ids.get(token)
        return tid if tid is not None else self._model.vocab.get(token)

    def id_to_token(self, tid: int) -> str | None:
        tok = self._added_by_id.get(tid)
        return tok if tok is not None else self._id_to_token.get(tid)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        words: list[tuple[str, bool]] = []

        def flush_words():
            if self._pre_tokenize is not None:
                words[:] = self._pre_tokenize(words)
            for w, _ in words:
                if w:
                    ids.extend(self._model.tokenize(w))
            words.clear()

        for a, b, tid in self._raw_added.split(text):
            if tid is not None:
                flush_words()
                ids.append(tid)
                continue
            piece = text[a:b]
            if self._normalize is not None:
                piece = self._normalize(piece)
            for c, d, ntid in self._norm_added.split(piece):
                if ntid is not None:
                    flush_words()
                    ids.append(ntid)
                elif d > c:
                    words.append((piece[c:d], a == 0 and c == 0))
        flush_words()
        if add_special_tokens:
            ids = self._bos + ids + self._eos
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        tokens = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tokens.append(tok)
        if self._decode is None:
            return " ".join(tokens)
        return "".join(self._decode(tokens))
