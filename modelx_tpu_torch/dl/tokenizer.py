"""A reader of HuggingFace ``tokenizer.json`` files (the part of the
``tokenizers`` package the serving sidecar uses, in plain Python).

The JAX sidecar encodes and decodes text through ``tokenizers.Tokenizer``
(``modelx_tpu/dl/serve.py:161 _Tokenizer``). The port may not import that
package (nor ``regex``), so it reads the same file itself and gives the
same ids from ``encode(text, add_special_tokens)`` and the same string from
``decode(ids)`` for every component type ``tokenizers`` 0.22.2 knows:

- normalizers: ``NFC``/``NFD``/``NFKC``/``NFKD``, ``Lowercase`` (Rust's
  per-character ``to_lowercase``), ``Strip``, ``StripAccents``, ``Nmt``,
  ``Prepend``, ``Replace``, ``ByteLevel``, ``BertNormalizer``,
  ``Precompiled`` (SentencePiece charsmaps, ``dl/precompiled.py``) and
  ``Sequence``;
- pre-tokenizers: ``Split``, ``ByteLevel``, ``Metaspace``, ``Whitespace``,
  ``WhitespaceSplit``, ``CharDelimiterSplit``, ``Digits`` (Rust's
  ``is_numeric``), ``Punctuation``, ``UnicodeScripts``, ``FixedLength``,
  ``BertPreTokenizer`` and ``Sequence``;
- models: ``BPE`` (with ``byte_fallback``, ``fuse_unk``, ``ignore_merges``,
  affixes and ``dropout``, drawn from the tokenizer's own generator),
  ``Unigram`` (``dl/unigram.py``), ``WordPiece`` and ``WordLevel``;
- post-processors: ``TemplateProcessing`` (any template), ``BertProcessing``,
  ``RobertaProcessing``, ``ByteLevel`` and ``Sequence``;
- decoders: ``ByteLevel``, ``Metaspace``, ``WordPiece``, ``BPEDecoder``,
  ``CTC``, ``Replace``, ``ByteFallback``, ``Fuse``, ``Strip`` and
  ``Sequence``;
- the ``truncation`` and ``padding`` blocks, as a single encode applies
  them (the special tokens counted, a pad up to the longest, a fixed
  length or a multiple).

Encoding runs the ``tokenizers`` pipeline step for step: added tokens that
are not ``normalized`` are cut out of the raw text first (leftmost-longest,
with ``single_word``, ``lstrip`` and ``rstrip``), the rest is normalized
and cut again on the normalized added tokens, pre-tokenized, and handed
word by word to the model; then truncation, the post-processor and
padding. Each piece carries how many of its leading characters align to
offset 0 of the input (``_Normalizer.prefix``), as the alignments of
``tokenizers`` give it, which the Metaspace pre-tokenizer's prepend_scheme
"first" reads. Added tokens take the ids ``tokenizers`` assigns on load,
not the file's. Decoding maps ids to tokens (added vocabulary first, ids
outside both skipped), runs the decoder chain and joins; invalid UTF-8
becomes U+FFFD as ``String::from_utf8_lossy`` makes it.

Regex patterns (Oniguruma's Ruby syntax) are translated to Python's
``re``: every class (``\\p{..}`` by category or script, ``\\s``, ``\\d``,
``\\w``, ``\\h``, bracket classes with nested classes and ``&&``) becomes an
explicit code-point class, ``\\b``/``\\B`` lookarounds, ``^``/``$`` line
anchors, and matches iterate as the onig crate iterates them
(``_matches``). A construct ``re`` cannot express raises
``UnsupportedTokenizerError`` (the sidecar's typed 501, ``LATER_SLICE``);
a file ``tokenizers`` itself refuses (a type it does not know, a malformed
block) raises ``TokenizerLoadError`` with the reference's message.

Unicode versions: Python 3.12's ``unicodedata`` is Unicode 15.0 while the
crates inside ``tokenizers`` read 16.0 or 17.0 (the regex engine, the
grapheme and numeric tables) or tables older than 12 (``UnicodeScripts``,
``StripAccents``, the BERT components). The categories 16.0 assigned come
from ``UNICODE_AFTER_15_0``, the BERT classes from the ``BERT_*`` tables
below, the rest from ``unicode_tables``: each probed over every code point
against ``tokenizers`` 0.22.2. Nothing is ever encoded with part of the
tokenizer ignored.
"""

from __future__ import annotations

import functools
import heapq
import itertools
import json
import random
import re
import struct
import unicodedata

from modelx_tpu_torch.dl import precompiled, unicode_tables
from modelx_tpu_torch.dl.unigram import Unigram

# Unicode's White_Space property: Rust's char::is_whitespace and the \s of
# the regex engines inside tokenizers (not Python's \s, which adds
# U+001C..U+001F)
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
               "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_WS = frozenset(WHITE_SPACE)

# the pre-tokenizer GPT-2 and ByteLevel(use_regex=true) split with
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"

# the roadmap item that lists what this reader still refuses: regex
# constructs Python's re cannot express (ROADMAP.md §C)
LATER_SLICE = "tokenizer regex constructs"


class UnsupportedTokenizerError(NotImplementedError):
    """A ``tokenizer.json`` component this reader does not implement."""

    def __init__(self, component: str) -> None:
        super().__init__(f"tokenizer.json component {component} is not supported")
        self.component = component


# the untagged enum ``tokenizers`` names when a part's type is none it knows
_UNTAGGED = {"normalizer": "NormalizerUntagged", "pre_tokenizer": "PreTokenizerUntagged",
             "post_processor": "PostProcessorWrapper", "decoder": "PyDecoderWrapper",
             "model": "ModelUntagged"}


class TokenizerLoadError(ValueError):
    """A ``tokenizer.json`` that ``tokenizers`` itself refuses to load (a
    component type it does not know, a malformed block); ``part`` names
    the top-level key it lies under, when known."""

    def __init__(self, message: str, part: str | None = None) -> None:
        super().__init__(message)
        self.part = part


def _unknown(part: str, kind) -> TokenizerLoadError:
    return TokenizerLoadError(f"data did not match any variant of untagged enum "
                              f"{_UNTAGGED[part]}", part)


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
    cats = list(map(unicodedata.category, map(chr, range(0x110000))))
    for cp, cat in _newer_categories().items():
        cats[cp] = cat
    out: dict[str, list[tuple[int, int]]] = {}
    lo = 0
    for cat, run in itertools.groupby(cats):
        hi = lo + sum(1 for _ in run) - 1
        out.setdefault(cat, []).append((lo, hi))
        major = out.setdefault(cat[0], [])
        if major and major[-1][1] == lo - 1:
            major[-1] = (major[-1][0], hi)
        else:
            major.append((lo, hi))
        lo = hi + 1
    return out


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}" if cp > 0xFFFF else f"\\u{cp:04x}"


def _class_body(ranges) -> str:
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


def _merge(ranges) -> list[tuple[int, int]]:
    """Sorted, merged (lo, hi) ranges."""
    out: list[list[int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _intersect(a, b) -> list[tuple[int, int]]:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo <= hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _complement(ranges) -> list[tuple[int, int]]:
    """Every code point outside ``ranges`` (surrogates excluded: no text
    holds them)."""
    out, at = [], 0
    for lo, hi in _merge([*ranges, (0xD800, 0xDFFF)]):
        if lo > at:
            out.append((at, lo - 1))
        at = hi + 1
    if at <= 0x10FFFF:
        out.append((at, 0x10FFFF))
    return out


# long names of the general categories Oniguruma takes in \p{..}
_CATEGORY_NAMES = {
    "letter": "L", "casedletter": "LC", "uppercaseletter": "Lu", "lowercaseletter": "Ll",
    "titlecaseletter": "Lt", "modifierletter": "Lm", "otherletter": "Lo", "mark": "M",
    "combiningmark": "M", "nonspacingmark": "Mn", "spacingmark": "Mc", "enclosingmark": "Me",
    "number": "N", "decimalnumber": "Nd", "digit": "Nd", "letternumber": "Nl",
    "othernumber": "No", "punctuation": "P", "connectorpunctuation": "Pc",
    "dashpunctuation": "Pd", "openpunctuation": "Ps", "closepunctuation": "Pe",
    "initialpunctuation": "Pi", "finalpunctuation": "Pf", "otherpunctuation": "Po",
    "symbol": "S", "mathsymbol": "Sm", "currencysymbol": "Sc", "modifiersymbol": "Sk",
    "othersymbol": "So", "separator": "Z", "spaceseparator": "Zs", "lineseparator": "Zl",
    "paragraphseparator": "Zp", "other": "C", "control": "Cc", "format": "Cf",
    "privateuse": "Co", "surrogate": "Cs",
}


@functools.cache
def _script_index() -> dict[str, int]:
    """Oniguruma's script names and four-letter codes, folded (case, spaces,
    ``_`` and ``-`` ignored) -> index into ``SCRIPT_NAMES``."""
    names = {_fold(n): i for i, n in enumerate(unicode_tables.SCRIPT_NAMES)}
    names.update({_fold(code): names[_fold(name)]
                  for code, name in unicode_tables.SCRIPT_CODES.items()})
    return names


def _fold(name: str) -> str:
    return re.sub(r"[\s_-]", "", name).lower()


@functools.cache
def _script_ranges(index: int) -> tuple[tuple[int, int], ...]:
    if index == 0:  # Unknown: what no script takes
        return tuple(_complement([(lo, hi) for lo, hi, _ in unicode_tables.REGEX_SCRIPTS]))
    return tuple((lo, hi) for lo, hi, i in unicode_tables.REGEX_SCRIPTS if i == index)


@functools.cache
def _named_ranges(name: str) -> tuple[tuple[int, int], ...]:
    """Code-point ranges of ``\\p{name}`` as Oniguruma reads it: a general
    category (its code or long name), a script (its name or four-letter
    code), ``Any``; or ``s`` (White_Space), ``d`` (Nd), ``w`` (Oniguruma's
    ``\\w``), ``h`` (hex digits). Anything else raises."""
    if name == "s":
        return tuple((ord(c), ord(c)) for c in WHITE_SPACE)
    if name == "w":
        return unicode_tables.ONIG_WORD
    if name == "h":
        return ((0x30, 0x39), (0x41, 0x46), (0x61, 0x66))
    if name == "d":
        name = "Nd"
    folded = _fold(name)
    if folded == "any":
        return tuple(_complement([]))
    cat = _CATEGORY_NAMES.get(folded) or next(
        (c for c in _category_ranges() if c.lower() == folded), None)
    if cat == "LC":
        return tuple(_merge([*_category_ranges()["Lu"], *_category_ranges()["Ll"],
                             *_category_ranges()["Lt"]]))
    if cat is not None and cat != "Cn":
        return tuple(_category_ranges()[cat])
    index = _script_index().get(folded)
    if index is not None:
        return _script_ranges(index)
    raise UnsupportedTokenizerError(f"regex class \\p{{{name}}}")


def _named_class(name: str) -> str:
    """Class body (no brackets) of ``_named_ranges(name)``."""
    return _class_body(_named_ranges(name))


@functools.cache
def _word_class() -> str:
    """The \\w of Rust's regex crate (the Whitespace pre-tokenizer and the
    added tokens' single_word check): Alphabetic, marks, Nd, Pc and
    Join_Control. Alphabetic is the letters, Nl and Other_Alphabetic, whose
    code points outside the marks are the circled and squared letters."""
    extra = [(0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
             (0x1F170, 0x1F189)]
    return "".join(_named_class(c) for c in ("L", "M", "Nd", "Nl", "Pc")) + _class_body(extra)


_SIMPLE_ESCAPES = {"n": 0xA, "t": 0x9, "r": 0xD, "f": 0xC, "v": 0xB, "a": 0x7, "e": 0x1B}
_CLASS_ESCAPES = "sSdDwWhHpP"


def _hex_escape(pattern: str, i: int) -> tuple[int, int]:
    """The code point of ``\\xHH``, ``\\x{H..}`` or ``\\uHHHH`` at ``i`` (the
    backslash), and the index past it."""
    kind = pattern[i + 1]
    if kind == "x" and pattern.startswith("{", i + 2):
        j = pattern.index("}", i + 3)
        return int(pattern[i + 3:j], 16), j + 1
    m = re.compile(r"[0-9A-Fa-f]{1,2}" if kind == "x" else r"[0-9A-Fa-f]{4}").match(pattern, i + 2)
    if m is None:
        raise ValueError(f"invalid \\{kind} escape in {pattern!r}")
    return int(m.group(), 16), m.end()


def _set_escape(pattern: str, i: int, in_class: bool = False) -> tuple[list[tuple[int, int]], int]:
    """The ranges of a class escape at ``i`` (``\\p{..}``, ``\\P{..}``,
    ``\\pL``, ``\\s``, ``\\d``, ``\\w``, ``\\h`` and their negations), and the
    index past it."""
    kind = pattern[i + 1]
    if kind in "pP":
        if pattern.startswith("{", i + 2):
            j = pattern.index("}", i + 2)
            name, end = pattern[i + 3:j], j + 1
        else:
            name, end = pattern[i + 2:i + 3], i + 3
        neg = kind == "P"
        if name.startswith("^"):
            name, neg = name[1:], not neg
    else:
        name, neg, end = kind.lower(), kind.isupper(), i + 2
    ranges = list(_named_ranges(name))
    if in_class and name == "w":
        # inside a bracket Oniguruma's \w lacks the Latin-1 digits and
        # fractions its \w outside takes (U+00B2, U+00B3, U+00B9, U+00BC-BE)
        ranges = _intersect(ranges, _complement([(0xB2, 0xB3), (0xB9, 0xB9), (0xBC, 0xBE)]))
    return (_complement(ranges) if neg else ranges), end


def _class_atom(pattern: str, i: int):
    """One member of a bracket class at ``i``: (code point, None, next
    index) or (None, ranges, next index) for a class escape."""
    c = pattern[i]
    if c != "\\":
        return ord(c), None, i + 1
    if i + 1 >= len(pattern):
        raise ValueError(f"a trailing backslash in {pattern!r}")
    nxt = pattern[i + 1]
    if nxt in _CLASS_ESCAPES:
        ranges, end = _set_escape(pattern, i, in_class=True)
        return None, ranges, end
    if nxt in _SIMPLE_ESCAPES:
        return _SIMPLE_ESCAPES[nxt], None, i + 2
    if nxt == "b":
        return 0x8, None, i + 2
    if nxt in "xu":
        cp, end = _hex_escape(pattern, i)
        return cp, None, end
    if nxt in "01234567":
        m = re.compile(r"[0-7]{1,3}").match(pattern, i + 1)
        return int(m.group(), 8), None, m.end()
    if nxt.isalpha():
        raise UnsupportedTokenizerError(f"regex escape \\{nxt} in a class in {pattern!r}")
    return ord(nxt), None, i + 2


def _parse_class(pattern: str, i: int) -> tuple[list[tuple[int, int]], int]:
    """The code points of the bracket class opening at ``i`` as Oniguruma
    reads it (nested classes are unions, ``&&`` intersects), and the index
    past its ``]``."""
    n = len(pattern)
    i += 1
    neg = pattern.startswith("^", i)
    i += neg
    parts: list[list[tuple[int, int]]] = []  # the operands of &&
    cur: list[tuple[int, int]] = []
    first = True
    while True:
        if i >= n:
            raise ValueError(f"premature end of char-class in {pattern!r}")
        c = pattern[i]
        if c == "]" and not first:
            i += 1
            break
        first = False
        if pattern.startswith("&&", i):
            parts.append(cur)
            cur, i = [], i + 2
            continue
        if c == "[":
            if pattern.startswith("[:", i):
                raise UnsupportedTokenizerError(f"POSIX bracket in {pattern!r}")
            sub, i = _parse_class(pattern, i)
            cur = _merge([*cur, *sub])
            continue
        lo, ranges, i = _class_atom(pattern, i)
        if ranges is not None:
            cur = _merge([*cur, *ranges])
            continue
        if pattern.startswith("-", i) and i + 1 < n and pattern[i + 1] != "]":
            hi, ranges, j = _class_atom(pattern, i + 1)
            if ranges is not None or hi < lo:
                raise ValueError(f"invalid range in char-class in {pattern!r}")
            cur, i = _merge([*cur, (lo, hi)]), j
        else:
            cur = _merge([*cur, (lo, lo)])
    for part in parts:
        cur = _intersect(part, cur)
    return (_complement(cur) if neg else cur), i


def _bracket(ranges) -> str:
    """``ranges`` as a Python class; an empty one matches nothing."""
    return f"[{_class_body(ranges)}]" if ranges else "(?!)"


# Ruby's option letters as Python's: Ruby's m is Python's s (dot matches a
# newline)
_FLAGS = {"i": "i", "m": "s", "x": "x"}


def translate_regex(pattern: str) -> str:
    """A pattern of the regex engine inside ``tokenizers`` (Oniguruma, Ruby
    syntax) as a Python ``re`` pattern. ``\\p{..}``, ``\\s``, ``\\d``, ``\\w``,
    ``\\h`` and every bracket class (nested classes, ``&&``) become explicit
    code-point classes; ``\\b``/``\\B`` become lookarounds on Oniguruma's
    ``\\w``; ``^``/``$`` are line anchors; ``(?<name>..)`` is a named group;
    Ruby's ``m`` option is Python's ``s``; an inline option applies to the
    rest of its group. A construct Python's ``re`` cannot express raises
    ``UnsupportedTokenizerError`` (the known limits in ROADMAP.md)."""
    out: list[str] = []
    closers: list[int] = [0]  # per open group: option scopes to close with it
    i, n = 0, len(pattern)
    word = _class_body(unicode_tables.ONIG_WORD)
    while i < n:
        c = pattern[i]
        if c == "\\":
            if i + 1 >= n:
                raise ValueError(f"a trailing backslash in {pattern!r}")
            nxt = pattern[i + 1]
            if nxt in _CLASS_ESCAPES:
                ranges, i = _set_escape(pattern, i)
                out.append(_bracket(ranges))
                continue
            i += 2
            if nxt == "b":
                out.append(f"(?:(?<=[{word}])(?![{word}])|(?<![{word}])(?=[{word}]))")
            elif nxt == "B":
                out.append(f"(?:(?<=[{word}])(?=[{word}])|(?<![{word}])(?![{word}]))")
            elif nxt == "A":
                out.append("\\A")
            elif nxt == "z":
                out.append("\\Z")
            elif nxt == "Z":
                out.append("(?=\\n?\\Z)")
            elif nxt == "e":
                out.append("\\x1b")
            elif nxt == "R":
                out.append("(?>\\r\\n|[\\n\\x0b\\x0c\\r\\x85\\u2028\\u2029])")
            elif nxt == "N":
                out.append("[^\\n]")
            elif nxt in "xu":
                cp, i = _hex_escape(pattern, i - 2)
                out.append(_esc(cp))
            elif nxt == "k" and pattern.startswith("<", i):
                j = pattern.index(">", i)
                name = pattern[i + 1:j]
                out.append(f"\\{name}" if name.isdigit() else f"(?P={name})")
                i = j + 1
            elif nxt.isalpha() and nxt not in "ntrfva":
                raise UnsupportedTokenizerError(f"regex escape \\{nxt} in {pattern!r}")
            else:
                out.append("\\" + nxt)
            continue
        if c == "[":
            ranges, i = _parse_class(pattern, i)
            out.append(_bracket(ranges))
            continue
        if c in "^$":
            # Ruby's line anchors; Oniguruma's ^ never matches at the end
            out.append("(?:\\A|(?m:^)(?!\\Z))" if c == "^" else "(?m:$)")
            i += 1
            continue
        if c == "(":
            if pattern.startswith("(?", i):
                rest = pattern[i + 2:i + 3]
                if pattern.startswith("(?<", i) and pattern[i + 3:i + 4] not in ("=", "!"):
                    out.append("(?P<")
                    i += 3
                elif rest == "'":
                    j = pattern.index("'", i + 3)
                    out.append(f"(?P<{pattern[i + 3:j]}>")
                    i = j + 1
                elif rest == "~":
                    raise UnsupportedTokenizerError(f"regex absent operator in {pattern!r}")
                elif rest == "(":
                    m = re.compile(r"\(\?\((?:<([^>]+)>|'([^']+)'|(\d+))\)").match(pattern, i)
                    if m is None:
                        raise UnsupportedTokenizerError(f"regex condition in {pattern!r}")
                    out.append(f"(?({m.group(1) or m.group(2) or m.group(3)})")
                    i = m.end()
                elif rest and (rest in _FLAGS or rest == "-"):
                    m = re.compile(r"\(\?([imx]*)(?:-([imx]*))?([:)])").match(pattern, i)
                    if m is None:
                        raise UnsupportedTokenizerError(f"regex options in {pattern!r}")
                    on = "".join(_FLAGS[f] for f in m.group(1))
                    off = "".join(_FLAGS[f] for f in m.group(2) or "")
                    out.append(f"(?{on}{'-' + off if off else ''}:")
                    if m.group(3) == ":":
                        closers.append(0)
                    else:  # to the end of the enclosing group
                        closers[-1] += 1
                    i = m.end()
                    continue
                else:  # (?: (?= (?! (?<= (?<! (?> (?#
                    out.append(pattern[i:i + 2])
                    i += 2
                    if rest == "#":
                        j = pattern.index(")", i)
                        out.append(pattern[i:j + 1])
                        i = j + 1
                        continue
                closers.append(0)
                continue
            closers.append(0)
        elif c == ")" and len(closers) > 1:
            out.append(")" * closers.pop())
        out.append(c)
        i += 1
    out.append(")" * closers[0])
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
        except ValueError as e:  # a pattern Oniguruma refuses too
            raise TokenizerLoadError(f"Oniguruma error: {e}") from None
    raise TokenizerLoadError(f"pattern {pattern!r}: expected String or Regex")


def _matches(rx, text: str) -> list[tuple[int, int]]:
    """``rx``'s matches in ``text`` as the onig crate iterates them: an
    empty match right where the last match ended is skipped and the search
    moves on one character (Python's ``finditer`` keeps it, and then finds
    a longer match at the same place). An empty text has no match, as
    ``tokenizers``' patterns give it none."""
    if not text:
        return []
    spans = [m.span() for m in rx.finditer(text)]
    if all(start != end for start, end in spans):
        return spans  # no empty match: the two iterations agree
    out: list[tuple[int, int]] = []
    pos, last_end, n = 0, None, len(text)
    while pos <= n:
        m = rx.search(text, pos)
        if m is None:
            break
        start, end = m.span()
        if start == end and last_end == end:
            pos += 1
            continue
        out.append((start, end))
        pos = last_end = end
    return out


def _substitute(rx, content: str, text: str, spans=None) -> str:
    """Every match of ``rx`` (``_matches``, or ``spans``) replaced by
    ``content``."""
    out, last = [], 0
    for start, end in _matches(rx, text) if spans is None else spans:
        out += [text[last:start], content]
        last = end
    out.append(text[last:])
    return "".join(out)


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


def _lowercase(s: str) -> str:
    """Rust's ``char::to_lowercase``, one character at a time (a
    multi-character result stays; no final-sigma context)."""
    lower = _bert_classes()["lower"]
    return "".join(lower.get(c) or c.lower() for c in s)


@functools.cache
def _marks() -> frozenset:
    return _cp_set(unicode_tables.COMBINING_MARKS)


class _Normalizer:
    """A normalizer: ``norm(s)`` is the normalized string, and
    ``norm.apply(s, k)`` is it with how many of its leading characters
    align to offset 0 of the original input when the first ``k`` of ``s``
    do (``k`` < 0: ``s`` does not start the input, so none can).
    ``tokenizers`` keeps these alignments through every normalizer, and the
    Metaspace pre-tokenizer's prepend_scheme "first" reads them. By default
    each character maps on its own: its outputs take its alignment, a
    deleted character leaves none; ``prefix(s, k)`` says otherwise."""

    def __init__(self, fn, prefix=None) -> None:
        self.fn = fn
        self._prefix = prefix

    def __call__(self, s: str) -> str:
        return self.fn(s)

    def apply(self, s: str, k: int) -> tuple[str, int]:
        if k < 0:
            return self.fn(s), k
        return self.fn(s), (self._prefix(s, k) if self._prefix is not None
                            else len(self.fn(s[:k])))


class _Sequence(_Normalizer):
    """A ``Sequence`` normalizer: its steps in order."""

    def __init__(self, steps: list) -> None:
        self.steps = steps

    def fn(self, s: str) -> str:
        for step in self.steps:
            s = step(s)
        return s

    def apply(self, s: str, k: int) -> tuple[str, int]:
        for step in self.steps:
            s, k = step.apply(s, k)
        return s, k


class _Replace(_Normalizer):
    """A ``Replace`` normalizer. Its alignments: text outside the matches
    keeps its own; the content of a match takes its last character's, and
    at an empty match the character's before it, or offset 0 itself at
    the very start."""

    def __init__(self, rx, content: str) -> None:
        self.rx, self.content = rx, content

    def fn(self, s: str) -> str:
        return _substitute(self.rx, self.content, s)

    def apply(self, s: str, k: int) -> tuple[str, int]:
        spans = _matches(self.rx, s)
        out = _substitute(self.rx, self.content, s, spans)
        if k < 0:
            return out, k
        n, last = 0, 0
        for start, end in spans:
            if last < start:  # the text before the match
                n += max(0, min(k, start) - last)
                if k < start:
                    return out, n
            if (end - 1 if end > start else start - 1) < k:
                n += len(self.content)
            elif self.content:
                return out, n
            last = end
        return out, n + max(0, min(k, len(s)) - last)


def _normalizer(spec):
    """``spec`` -> a ``_Normalizer``, or None."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        return _Sequence([_normalizer(s) for s in spec["normalizers"]])
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return _Normalizer(functools.partial(unicodedata.normalize, kind))
    if kind == "Prepend":
        pre = spec["prepend"]
        # the prepended characters take the first character's alignment
        return _Normalizer(lambda s: pre + s if s else s,
                           lambda s, k: k + len(pre) if k > 0 else 0)
    if kind == "Replace":
        return _Replace(_compile(spec["pattern"]), spec["content"])
    if kind == "BertNormalizer":
        return _Normalizer(_bert_normalizer(spec))
    if kind == "Lowercase":
        return _Normalizer(_lowercase)
    if kind == "Strip":
        left, right = bool(spec["strip_left"]), bool(spec["strip_right"])

        def strip(s: str) -> str:
            if left:
                s = s.lstrip(WHITE_SPACE)
            return s.rstrip(WHITE_SPACE) if right else s
        return _Normalizer(strip, lambda s, k: min(
            len(s[:k].lstrip(WHITE_SPACE)) if left else k, len(strip(s))))
    if kind == "StripAccents":
        marks = _marks()
        return _Normalizer(lambda s: "".join(c for c in s if ord(c) not in marks))
    if kind == "Nmt":
        return _Normalizer(precompiled.nmt)
    if kind == "ByteLevel":
        return _Normalizer(_to_byte_chars)
    if kind == "Precompiled":
        charsmap = precompiled.Precompiled(spec["precompiled_charsmap"])
        return _Normalizer(charsmap, charsmap.prefix)
    raise _unknown("normalizer", kind)


# -- pre-tokenizers --------------------------------------------------------
# a pre-tokenizer maps [(text, k)] -> [(text, k)], where k counts the
# piece's leading characters that align to offset 0 of the original input
# (``_Normalizer``; Metaspace's prepend_scheme "first" reads k > 0); empty
# pieces are dropped


def split_pieces(text: str, rx, behavior: str, invert: bool = False) -> list[tuple[int, int]]:
    """``(start, end)`` pieces of ``text`` cut by ``rx``'s matches as the
    ``tokenizers`` split behaviors cut them; empty pieces dropped."""
    segs, prev = [], 0
    for start, end in _matches(rx, text):
        if start != prev:
            segs.append([prev, start, invert])
        segs.append([start, end, not invert])
        prev = end
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
        raise ValueError(f"unknown split behavior {behavior!r}")
    return [(a, b) for a, b, _ in out if b > a]


_BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous")


def _splitter(rx, behavior: str, invert: bool = False):
    if behavior not in _BEHAVIORS:
        raise TokenizerLoadError(f"unknown variant `{behavior}`, expected one of "
                                 + ", ".join(f"`{b}`" for b in _BEHAVIORS))

    def split(pieces):
        return [(text[a:b], min(k, b) - a if a < k else 0)
                for text, k in pieces
                for a, b in split_pieces(text, rx, behavior, invert)]
    return split


@functools.cache
def _char_rx(name: str):
    """One character of a class the split pre-tokenizers cut on, as a
    compiled regex: ``numeric`` (Rust's ``is_numeric``), ``punct``
    (``Punctuation``'s test, the BertPreTokenizer's) or ``space``."""
    if name == "numeric":
        ranges = unicode_tables.NUMERIC
    elif name == "punct":  # bert_is_punct's classes as ranges
        ranges = _merge([*_category_ranges()["P"], *BERT_EXTRA_PUNCT,
                         *((ord(c), ord(c)) for c in _ASCII_PUNCT)])
        ranges = _intersect(ranges, _complement(BERT_NOT_PUNCT))
    else:
        ranges = [(ord(c), ord(c)) for c in WHITE_SPACE]
    return re.compile(f"[{_class_body(ranges)}]")


@functools.cache
def _pre_tokenizer_scripts() -> bytearray:
    """Per code point, the script index the UnicodeScripts pre-tokenizer
    reads (0: Any), Hiragana and Katakana folded into Han."""
    names = unicode_tables.SCRIPT_NAMES
    han = names.index("Han")
    kana = {names.index("Hiragana"), names.index("Katakana")}
    out = bytearray(0x110000)
    for lo, hi, i in unicode_tables.PRE_TOKENIZER_SCRIPTS:
        out[lo:hi + 1] = bytes([han if i in kana else i]) * (hi - lo + 1)
    out[0x30FC] = han
    out[0x20] = 0
    return out


def _unicode_scripts(pieces):
    """UnicodeScripts: a cut wherever the script changes. A character of
    no script (Any: a space, a code point its tables lack) joins the piece
    it is in and does not count as a change; Any characters before the
    first scripted one are dropped, as ``tokenizers`` drops them."""
    table = _pre_tokenizer_scripts()
    out = []
    for text, k in pieces:
        cuts, last = [], None
        for i, ch in enumerate(text):
            script = table[ord(ch)]
            if script and last != script:
                cuts.append(i)
            if script:
                last = script
        cuts.append(len(text))
        out.extend((text[a:b], max(0, min(k, b) - a)) for a, b in zip(cuts, cuts[1:]) if b > a)
    return out


def _fixed_length(length: int):
    def split(pieces):
        if length == 0:
            if any(text for text, _ in pieces):
                raise ValueError("FixedLength: chunk size must be non-zero")
            return []
        return [(text[i:i + length], max(0, min(k, i + length) - i))
                for text, k in pieces for i in range(0, len(text), length)]
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
                pieces = [(t, k) if t.startswith(" ") else (" " + t, k + 1 if k > 0 else 0)
                          for t, k in pieces]
            if split is not None:
                pieces = split(pieces)
            return [(_to_byte_chars(t), len(_to_byte_chars(t[:k])) if k else 0)
                    for t, k in pieces]
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
            for text, k in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and k > 0)):
                    text, k = rep + text, k + len(rep) if k > 0 else 0
                out.append((text, k))
            return split(out) if split is not None else out
        return metaspace
    if kind == "Whitespace":
        w = _word_class()
        return _splitter(re.compile(f"[{w}]+|[^{w}{_named_class('s')}]+"), "Removed", invert=True)
    if kind == "BertPreTokenizer":
        return _bert_pre_tokenize
    if kind == "WhitespaceSplit":
        return _splitter(_char_rx("space"), "Removed")
    if kind == "CharDelimiterSplit":
        delimiter = spec["delimiter"]
        if not isinstance(delimiter, str) or len(delimiter) != 1:
            raise TokenizerLoadError(f"CharDelimiterSplit: delimiter {delimiter!r} is not one "
                                     f"character")
        return _splitter(re.compile(re.escape(delimiter)), "Removed")
    if kind == "Digits":
        return _splitter(_char_rx("numeric"),
                         "Isolated" if spec["individual_digits"] else "Contiguous")
    if kind == "Punctuation":
        return _splitter(_char_rx("punct"), spec.get("behavior", "Isolated"))
    if kind == "FixedLength":
        return _fixed_length(int(spec.get("length", 5)))
    if kind == "UnicodeScripts":
        return _unicode_scripts
    raise _unknown("pre_tokenizer", kind)


def _bert_pre_tokenize(pieces):
    """BertPreTokenizer: split on whitespace (removed), then each
    punctuation character is a piece of its own."""
    out = []
    for text, k in pieces:
        start, word = 0, []
        for i, ch in enumerate(text):
            if ch in _WS or bert_is_punct(ch):
                if word:
                    out.append(("".join(word), max(0, min(k, i) - start)))
                    word = []
                if ch not in _WS:
                    out.append((ch, int(i < k)))
                start = i + 1
            else:
                word.append(ch)
        if word:
            out.append(("".join(word), max(0, min(k, len(text)) - start)))
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

    def __init__(self, spec: dict, rng: random.Random) -> None:
        dropout = spec.get("dropout")
        if dropout is not None and not 0.0 <= float(dropout) <= 1.0:
            raise TokenizerLoadError("Dropout should be between 0 and 1, inclusive")
        # drawn against an f32, as tokenizers draws; 0 is no dropout
        self.dropout = struct.unpack("f", struct.pack("f", float(dropout)))[0] if dropout else 0.0
        self.rng = rng
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
        if self.dropout:  # no word cache and no ignore_merges, as in tokenizers
            return self._merge(self._symbols(word), self.dropout)
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

    def _merge(self, ids: list[int], dropout: float = 0.0) -> list[int]:
        """Apply merges lowest rank first, leftmost first among equal ranks
        (tokenizers' Word::merge_all). With ``dropout``, each entry popped
        is set aside with that probability (one draw of ``self.rng`` each,
        expired entries included) and the ones set aside go back into the
        queue at the next merge."""
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
        skipped = []
        while heap:
            top = heapq.heappop(heap)
            if dropout and self.rng.random() < dropout:
                skipped.append(top)
                continue
            for entry in skipped:
                heapq.heappush(heap, entry)
            skipped.clear()
            _rank, pos, new_id = top
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


def _model(spec: dict, rng: random.Random):
    kind = spec.get("type")
    if kind is None and "merges" in spec:
        kind = "BPE"  # older files leave the model's type out
    if kind == "BPE":
        return _BPE(spec, rng)
    if kind == "WordLevel":
        return _WordLevel(spec)
    if kind == "WordPiece":
        return _WordPiece(spec)
    if kind == "Unigram":
        return Unigram(spec)
    raise _unknown("model", kind)


# -- post-processors -------------------------------------------------------


def _special_ids(specials: dict, name: str) -> list[int]:
    tok = specials.get(name)
    if tok is None:  # tokenizers loads such a template and panics on use
        raise ValueError(f"TemplateProcessing: no special token {name!r}")
    return list(tok["ids"])


def _post_processor(spec):
    """``spec`` -> (process, added): ``process(encodings, add_special)``
    maps the list of id lists a processor takes to the list it gives (a
    single encode starts from one; a ``TemplateProcessing`` gives one per
    piece of its template, so a processor after it in a ``Sequence`` sees
    them all); ``added`` counts the special ids a single sequence gets,
    which truncation leaves room for."""
    if spec is None:
        return (lambda encs, add: encs), 0
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_post_processor(p) for p in spec["processors"]]

        def seq(encs, add):
            for step, _ in steps:
                encs = step(encs, add)
            return encs
        return seq, sum(n for _, n in steps)
    if kind == "ByteLevel":  # offsets only
        return (lambda encs, add: encs), 0
    if kind in ("BertProcessing", "RobertaProcessing"):
        # trim_offsets and add_prefix_space move offsets only
        cls, sep = [int(spec["cls"][1])], [int(spec["sep"][1])]
        mid = sep if kind == "RobertaProcessing" else []

        def bert(encs, add):
            if not add:
                return encs
            return [cls + e + sep if i == 0 else mid + e + sep for i, e in enumerate(encs)]
        return bert, 2
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens") or {}
        single, pair = spec["single"], spec["pair"]
        for piece in (*single, *pair):
            if "Sequence" in piece and piece["Sequence"]["id"] not in ("A", "B"):
                raise TokenizerLoadError(f"TemplateProcessing: unknown sequence "
                                         f"{piece['Sequence']['id']!r}")

        def template(encs, add):
            if len(encs) > 2:
                raise ValueError(f"TemplateProcessing: {len(encs)} sequences to process")
            out = []
            for piece in single if len(encs) == 1 else pair:
                if "Sequence" in piece:
                    i = 0 if piece["Sequence"]["id"] == "A" else 1
                    if i >= len(encs):
                        raise ValueError("TemplateProcessing: the single template uses $B")
                    out.append(list(encs[i]))
                elif add:
                    out.append(_special_ids(specials, piece["SpecialToken"]["id"]))
            return out
        added = sum(len((specials.get(p["SpecialToken"]["id"]) or {"ids": ()})["ids"])
                    for p in single if "SpecialToken" in p)
        return template, added
    raise _unknown("post_processor", kind)


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
        return lambda tokens: [_substitute(rx, content, t) for t in tokens]
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
    if kind == "CTC":
        pad, delimiter = spec["pad_token"], spec["word_delimiter_token"]
        cleanup = bool(spec["cleanup"])

        def ctc(tokens):
            out = []
            for i, t in enumerate(tokens):
                if i and t == tokens[i - 1]:
                    continue  # repeats collapse before anything else
                t = t.replace(pad, "")
                if cleanup:
                    t = _wordpiece_cleanup(t).replace(delimiter, " ")
                if t:
                    out.append(t)
            return out
        return ctc
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: [t.replace(suffix, "" if i == len(tokens) - 1 else " ")
                               for i, t in enumerate(tokens)]
    raise _unknown("decoder", kind)


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


def _json_ends(text: str) -> dict[str, int]:
    """Where each top-level value of the JSON object ``text`` ends (a
    character index; ``""``: the end of the object)."""
    dec, ends = json.JSONDecoder(), {}
    ws = re.compile(r"[ \t\n\r]*")
    i = ws.match(text, 0).end() + 1  # past the {
    while True:
        i = ws.match(text, i).end()
        if text.startswith("}", i):
            ends[""] = i + 1
            return ends
        key, i = dec.raw_decode(text, i)
        i = ws.match(text, i).end() + 1  # past the :
        _, i = dec.raw_decode(text, ws.match(text, i).end())
        ends[key] = i
        i = ws.match(text, i).end()
        i += text.startswith(",", i)


def _at(text: str, index: int) -> str:
    """serde_json's " at line L column C" for a character index (the
    column counts bytes)."""
    line_start = text.rfind("\n", 0, index) + 1
    return (f" at line {text.count(chr(10), 0, index) + 1} column "
            f"{len(text[line_start:index].encode('utf-8'))}")


class Tokenizer:
    """``tokenizer.json`` -> encode / decode / token_to_id, as
    ``tokenizers.Tokenizer`` gives them.

    ``seed`` seeds the generator BPE dropout draws from (the tokenizer's
    own ``random.Random``; from the OS's entropy when None)."""

    def __init__(self, spec: dict, seed: int | None = None) -> None:
        self.rng = random.Random(seed)
        self._normalize = self._part(spec, "normalizer", _normalizer)
        self._pre_tokenize = self._part(spec, "pre_tokenizer", _pre_tokenizer)
        self._model = self._part(spec, "model", lambda m: _model(m, self.rng))
        self._process, self._n_added = self._part(spec, "post_processor", _post_processor)
        self._decode = self._part(spec, "decoder", _decoder)
        self._truncation = self._part(spec, "truncation", _truncation)
        self._padding = self._part(spec, "padding", _padding)
        added = self._added_tokens(spec.get("added_tokens") or [])
        self._added_by_id = {tid: content for content, (tid, _) in added.items()}
        self._added_ids = {content: tid for content, (tid, _) in added.items()}
        # a content once added as special stays special
        self._special = {t["content"] for t in spec.get("added_tokens") or [] if t.get("special")}
        added = [{**t, "id": tid} for tid, t in added.values()]
        self._raw_added = _AddedTokens([(t["content"], t) for t in added
                                        if not t.get("normalized")])
        # normalized added tokens match the normalized text, so their
        # content is normalized too
        norm = self._normalize or (lambda s: s)
        self._norm_added = _AddedTokens([(norm(t["content"]), t) for t in added
                                         if t.get("normalized")])
        self._id_to_token = getattr(self._model, "id_to_token_map", None) or {
            i: t for t, i in self._model.vocab.items()}

    def _added_tokens(self, tokens: list) -> dict[str, tuple[int, dict]]:
        """content -> (id, token) as ``tokenizers`` loads the added tokens:
        in order, each takes the id of the same content added before it or
        in the model's vocab, else the next free one (the vocab's size, or
        one past the largest added id at or above it), whatever id the file
        gives; a content listed twice keeps its id and takes the later
        entry's options; an empty one is skipped."""
        vocab = self._model.vocab
        size = len(getattr(self._model, "pieces", vocab))
        out: dict[str, tuple[int, dict]] = {}
        for t in tokens:
            content = t["content"]
            if not content:
                continue  # tokenizers skips an empty added token
            tid = out[content][0] if content in out else vocab.get(content)
            if tid is None:
                top = max((i for i, _ in out.values()), default=None)
                tid = size if top is None or (top < size and size) else top + 1
            out[content] = (tid, t)
        return out

    @staticmethod
    def _part(spec: dict, key: str, build):
        """``build(spec[key])``; a malformed block fails the load naming
        ``key``, as ``tokenizers`` fails it."""
        value = spec.get(key)
        if value is None and key in ("truncation", "padding"):
            return None
        try:
            return build(value)
        except TokenizerLoadError as e:
            e.part = e.part or key
            raise
        except ValueError as e:  # the block's own checks (a Unigram's unk_id, ...)
            raise TokenizerLoadError(str(e), key) from None
        except (KeyError, TypeError, AttributeError) as e:
            raise TokenizerLoadError(f"{key}: malformed ({type(e).__name__}: {e})", key) from None

    @classmethod
    def from_str(cls, text: str, seed: int | None = None) -> Tokenizer:
        spec = json.loads(text)
        try:
            return cls(spec, seed)
        except TokenizerLoadError as e:
            if str(e).startswith("data did not match") and e.part in _UNTAGGED:
                # serde reads the model last, at the end of the object
                ends = _json_ends(text)
                where = ends.get("" if e.part == "model" else e.part)
                if where is not None:
                    raise TokenizerLoadError(str(e) + _at(text, where), e.part) from None
            raise

    @classmethod
    def from_file(cls, path: str, seed: int | None = None) -> Tokenizer:
        with open(path, encoding="utf-8") as f:
            return cls.from_str(f.read(), seed)

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
            # leading characters aligned to the input's offset 0 (-1: none can be)
            k = min(1, len(piece)) if a == 0 else -1
            if self._normalize is not None:
                piece, k = self._normalize.apply(piece, k)
            for c, d, ntid in self._norm_added.split(piece):
                if ntid is not None:
                    flush_words()
                    ids.append(ntid)
                elif d > c:
                    words.append((piece[c:d], max(0, min(k, d) - c)))
        flush_words()
        if self._truncation is not None:
            ids = self._truncation(ids, self._n_added if add_special_tokens else 0)
        ids = [t for enc in self._process([ids], add_special_tokens) for t in enc]
        if self._padding is not None:
            ids = self._padding(ids)
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


def _truncation(spec: dict):
    """The ``truncation`` block -> ``cut(ids, n_added)``. A single sequence
    keeps ``max_length`` ids less the ``n_added`` special ids the
    post-processor will add (none are left room for when ``max_length``
    is below their count), the head (``Right``) or the tail (``Left``).
    ``stride`` only feeds the overflowing encodings, which the facade
    drops; as in ``tokenizers``, a cut with a stride not below the room
    left fails, and so does ``OnlySecond`` with no second sequence."""
    max_length, stride = int(spec["max_length"]), int(spec["stride"])
    strategy, direction = spec["strategy"], spec["direction"]
    if strategy not in ("LongestFirst", "OnlyFirst", "OnlySecond"):
        raise TokenizerLoadError(f"unknown truncation strategy {strategy!r}")
    if direction not in ("Left", "Right"):
        raise TokenizerLoadError(f"unknown truncation direction {direction!r}")

    def cut(ids: list[int], n_added: int) -> list[int]:
        if n_added > max_length:
            return ids
        room = max_length - n_added
        if room == 0:
            return []
        if len(ids) <= room:
            return ids
        if strategy == "OnlySecond":
            raise ValueError("Truncation error: Second sequence not provided")
        if stride >= room:
            raise ValueError(f"`stride` must be strictly less than `max_len={room}` (note that "
                             f"`max_len` may be shorter than the max length of the original "
                             f"model, as it subtracts the number of special characters")
        return ids[:room] if direction == "Right" else ids[len(ids) - room:]
    return cut


def _padding(spec: dict):
    """The ``padding`` block -> ``pad(ids)``: a single encode is its own
    longest (``BatchLongest``) or padded to ``Fixed``, then up to a
    multiple of ``pad_to_multiple_of``, in front (``Left``) or behind."""
    strategy, direction = spec["strategy"], spec["direction"]
    if strategy != "BatchLongest" and not (isinstance(strategy, dict) and "Fixed" in strategy):
        raise TokenizerLoadError(f"unknown variant {strategy!r}, expected `BatchLongest` or "
                                 f"`Fixed`")
    if direction not in ("Left", "Right"):
        raise TokenizerLoadError(f"unknown padding direction {direction!r}")
    fixed = None if strategy == "BatchLongest" else int(strategy["Fixed"])
    multiple, pad_id = spec.get("pad_to_multiple_of"), int(spec["pad_id"])

    def pad(ids: list[int]) -> list[int]:
        n = len(ids) if fixed is None else fixed
        if multiple and n % multiple:
            n += multiple - n % multiple
        if len(ids) >= n:
            return ids
        fill = [pad_id] * (n - len(ids))
        return fill + ids if direction == "Left" else ids + fill
    return pad
