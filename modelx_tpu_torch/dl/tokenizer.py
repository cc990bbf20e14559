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
  space).

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
``tokenizers`` leave all of them unchanged, as ``unicodedata`` does). Any
component type not listed above raises ``UnsupportedTokenizerError`` at
load, naming it: nothing is ever encoded with part of the tokenizer
ignored.
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

# the slice that brings what this reader refuses: WordPiece, Unigram and
# the BERT normalizer and pre-tokenizer belong to the bert family
LATER_SLICE = "other families"


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
    raise UnsupportedTokenizerError(f"pre_tokenizer {kind}")


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
    raise UnsupportedTokenizerError(f"decoder {kind}")


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
