"""Every tokenizer.json component of ``tokenizers`` 0.22.2 in the port's
reader (modelx_tpu_torch.dl.tokenizer and its siblings) against the
``tokenizers`` package, on the CPU.

Ids and strings must be exactly equal, except BPE dropout at a rate
between 0 and 1, where the two readers draw from different generators:
there each segmentation one draws ``DROPOUT_SEEN`` times the other must
draw too, and each one's frequency must lie within ``DROPOUT_TOL``
(absolute) of the reference's over ``DROPOUT_SAMPLES`` encodes.

- The character classes are held over every code point (surrogates
  excepted), as ``tests/test_torch_tokenizer.py`` holds the BERT ones:
  ``Lowercase``, ``Strip``, ``StripAccents``, ``Nmt`` and ``ByteLevel``
  normalizers, the ``Digits``, ``Punctuation``, ``UnicodeScripts``,
  ``WhitespaceSplit`` and ``CharDelimiterSplit`` pre-tokenizers, and the
  regex classes ``\\w``, ``\\h``, ``\\b`` and ``\\p{<script>}`` in a ``Split``.
- ``Precompiled`` on charsmaps from the double-array writer
  (``modelx_tpu_torch/testing/charsmap.py``): the lookup rules on fixed
  maps, grapheme clusters (combining runs over and under 6 bytes, ZWJ
  emoji, Hangul, CRLF, regional indicators, prepended and spacing marks)
  under an identity map, and a hypothesis search over maps and texts.
- ``Unigram`` trained in the test (``UnigramTrainer``), with and without
  ``byte_fallback``, and on hand-built vocabs whose scores tie.
- Decoders (``CTC``, ``BPEDecoder``), post-processors
  (``RobertaProcessing``, templates), ``truncation`` and ``padding``.
- Chains of normalizers and pre-tokenizers on both models (hypothesis),
  Metaspace's prepend_scheme "first" after normalizers that move the
  input's offset 0, the added tokens' ids as ``tokenizers`` assigns them,
  and regex matches iterated as the onig crate iterates them.
- A JAX ``ModelServer`` and the port's server answer a text
  ``/v1/generate`` with the same bytes, for a Unigram + Precompiled file and
  for a truncation + padding file, and the same status and body for a file
  ``tokenizers`` refuses to load.
"""

import base64
import collections
import copy
import functools
import json
import os
import re
import urllib.error
import urllib.request

import pytest
import tokenizers
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import decoders, models, normalizers, pre_tokenizers, trainers

from modelx_tpu_torch.dl import precompiled
from modelx_tpu_torch.dl.tokenizer import (
    Tokenizer,
    TokenizerLoadError,
    UnsupportedTokenizerError,
    _normalizer,
    _pre_tokenizer,
    split_pieces,
    translate_regex,
)
from modelx_tpu_torch.testing.charsmap import charsmap_bytes, write_charsmap

CHUNK = 4096


@functools.cache
def _every_cp() -> list[str]:
    """Every code point but the surrogates, built on first use (not at
    import: each test worker imports this file)."""
    return [chr(cp) for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF]

CORPUS = [
    "The quick brown fox jumps over the lazy dog. I'LL say it's fine; we've seen worse.",
    "Numbers: 1234567 and 2024-05-01, pi is 3.14159, call 555-0100 now!",
    "Don't stop believing\r\n\nHold on to that feeling.\tTabs\tand  double  spaces.",
    "café naïve résumé Straße ſome KELVIN and the end of Ω.",
    "你好，世界。这是一个测试句子，包含中文标点！日本語のテキストもあります。",
    "Emoji: 🙂👍🏽🎉 and flags 🇫🇷 with ZWJ 👩‍💻 sequences.",
    "Arabic: مرحبا بالعالم — Hindi: नमस्ते दुनिया — Korean: 안녕하세요",
    "def main(argv):\n    return sum(x ** 2 for x in range(10))  # code\n",
    "ﬁne Ａb ａb ①②③ ½ ⅻ … “quoted” ‘single’ ét nbsp",
    "hello world tpu hello world the the the of and to in is was for on with",
] * 3
FIXED = ["", " ", "  ", "a", "hello world", "  lead and trail  ", "12 345 6789 0", "a1b2c3",
         "x五y", "...!!!???", "ét", "café", "ﬁne ＡＢ", "👩‍💻!", "🇫🇷🇩🇪🇫", "\r\n\n",
         "안녕하세요", "각", "á̂̃b", "नमस्ते", "日本語のテキスト", "ー", "a b\tc",
         "<s>x</s>", "<unk>", "Tabs\tand  double  spaces", "ΑΣ ς İstanbul", "\x00\x01\x7f"]

# BPE dropout: encodes per reader at a rate strictly between 0 and 1; the
# largest absolute difference allowed between the two readers' frequencies
# of one segmentation (the difference's standard deviation is at most
# sqrt(2 * 0.25 / 10000) = 0.0071, so 0.04 is over 5.6 of them); and the
# count above which a segmentation one reader draws must be drawn by the
# other too (a frequency of 0.4 %, drawn 0 times in 10,000 with
# probability e^-40)
DROPOUT_SAMPLES = 10000
DROPOUT_TOL = 0.04
DROPOUT_SEEN = 40


def _chunks(items, n=CHUNK):
    for i in range(0, len(items), n):
        yield items[i:i + n]


def _with(spec: dict, **parts) -> str:
    out = copy.deepcopy(spec)
    out.update(parts)
    return json.dumps(out)


def _pair(text: str, seed: int = 0):
    return tokenizers.Tokenizer.from_str(text), Tokenizer.from_str(text, seed=seed)


def _assert_encode_equal(ref, port, text):
    for special in (True, False):
        want = ref.encode(text, add_special_tokens=special).ids
        assert port.encode(text, add_special_tokens=special) == want, (text, special)


def _assert_decode_equal(ref, port, ids):
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
            ids, skip_special_tokens=skip), (ids, skip)


def _wordlevel(vocab=None) -> dict:
    vocab = vocab or {"[UNK]": 0, "a": 1, "b": 2}
    return json.loads(tokenizers.Tokenizer(models.WordLevel(vocab, unk_token="[UNK]")).to_str())


# -- normalizers, every code point ---------------------------------------------------------


@pytest.mark.parametrize("spec", [
    {"type": "Lowercase"}, {"type": "StripAccents"}, {"type": "Nmt"}, {"type": "ByteLevel"},
], ids=lambda s: s["type"])
def test_normalizer_equal_on_every_code_point(spec):
    """Each maps characters one at a time, so a run of code points
    normalizes as their concatenation."""
    ref = normalizers.Sequence([tokenizers.Tokenizer.from_str(_with(
        _wordlevel(), normalizer=spec)).normalizer])
    port = _normalizer(spec)
    for chunk in _chunks(_every_cp()):
        text = "".join(chunk)
        if port(text) != ref.normalize_str(text):
            bad = [c for c in chunk if port(c) != ref.normalize_str(c)]
            raise AssertionError([(hex(ord(c)), port(c), ref.normalize_str(c)) for c in bad[:5]])


@pytest.mark.parametrize("left,right", [(True, True), (True, False), (False, True)])
def test_strip_equal_on_every_code_point(left, right):
    ref = normalizers.Strip(left=left, right=right)
    tok = tokenizers.Tokenizer(models.WordLevel({"a": 0}, unk_token="a"))
    tok.normalizer = ref
    spec = json.loads(tok.to_str())["normalizer"]
    port = _normalizer(spec)
    for c in _every_cp():
        text = f"{c}{c}x{c}"
        assert port(text) == ref.normalize_str(text), hex(ord(c))


# -- pre-tokenizers, every code point ------------------------------------------------------


def _pieces(pre, text):
    return [t for t, _ in pre.pre_tokenize_str(text)]


@pytest.mark.parametrize("spec", [
    {"type": "Digits", "individual_digits": True},
    {"type": "Digits", "individual_digits": False},
    {"type": "Punctuation", "behavior": "Isolated"},
    {"type": "Punctuation", "behavior": "Removed"},
    {"type": "Punctuation", "behavior": "MergedWithPrevious"},
    {"type": "Punctuation", "behavior": "MergedWithNext"},
    {"type": "Punctuation", "behavior": "Contiguous"},
    {"type": "WhitespaceSplit"},
    {"type": "CharDelimiterSplit", "delimiter": "é"},
    {"type": "UnicodeScripts"},
], ids=lambda s: "-".join(str(v) for v in s.values()))
def test_pre_tokenizer_equal_on_every_code_point(spec):
    """Every code point between two ``a``, then (UnicodeScripts) every code
    point in order, between two Greek letters and before U+30FC: the
    pieces' strings must be equal."""
    ref = tokenizers.Tokenizer.from_str(_with(_wordlevel(), pre_tokenizer=spec)).pre_tokenizer
    port = _pre_tokenizer(spec)
    layouts = [lambda c: f"a{c}a"]
    if spec["type"] == "UnicodeScripts":
        layouts += [lambda c: c, lambda c: f"α{c}α", lambda c: f" {c}ー"]
    for layout in layouts:
        for chunk in _chunks(_every_cp()):
            text = "".join(layout(c) for c in chunk)
            want = _pieces(ref, text)
            got = [t for t, _ in port([(text, True)])]
            assert got == want, (hex(ord(chunk[0])), next(
                (w, g) for w, g in zip(want + [None], got + [None]) if w != g))


def test_digits_reads_rust_is_numeric_not_isnumeric():
    """``'五'.isnumeric()`` is True in Python; Rust's ``is_numeric`` (Nd, Nl,
    No) keeps it a letter."""
    spec = {"type": "Digits", "individual_digits": True}
    ref = tokenizers.Tokenizer.from_str(_with(_wordlevel(), pre_tokenizer=spec)).pre_tokenizer
    assert "五".isnumeric() and _pieces(ref, "a五b") == ["a五b"]
    assert [t for t, _ in _pre_tokenizer(spec)([("a五b", True)])] == ["a五b"]


def test_unicode_scripts_quirks():
    """Hiragana, Katakana and U+30FC are Han; a space joins either side and
    leading spaces are dropped; Common is a script of its own."""
    ref = pre_tokenizers.UnicodeScripts()
    port = _pre_tokenizer({"type": "UnicodeScripts"})
    for text in ("a1b", "日本語のテキストー漢字", "  lead a b", "ab  cd ", "Καλη a", "   ",
                 "áb", "x😀y"):
        assert [t for t, _ in port([(text, True)])] == _pieces(ref, text), text
    assert _pieces(ref, "a1b") == ["a", "1", "b"]


@pytest.mark.parametrize("length", [0, 1, 3, 5, 100])
def test_fixed_length_pre_tokenizer(length):
    spec = {"type": "FixedLength", "length": length}
    ref = tokenizers.Tokenizer.from_str(_with(_wordlevel(), pre_tokenizer=spec)).pre_tokenizer
    port = _pre_tokenizer(spec)
    for text in ("", "abc", "abcdefghijk", "日本語のテキスト", "a b c d e f"):
        if length == 0 and text:  # tokenizers panics: "chunk size must be non-zero"
            with pytest.raises(BaseException, match="chunk size must be non-zero"):
                ref.pre_tokenize_str(text)
            with pytest.raises(ValueError, match="chunk size must be non-zero"):
                port([(text, True)])
            continue
        assert [t for t, _ in port([(text, True)])] == _pieces(ref, text), (length, text)


# -- regexes -----------------------------------------------------------------------------

REGEX_CASES = [
    r"\w+", r"\W+", r"\b\w+\b", r"\B.", r"\bfoo\B", r"^\s*\w", r"\w+$", r"(?m:^a)", r"^$",
    r"[a-z[0-9]]+", r"[a-z&&[^aeiou]]+", r"[\w&&[^\d]]+", r"[^[a-c][x-z]]+", r"\h+", r"\H+",
    r"[\h_]+", r"\p{Han}+", r"\p{Hiragana}|\p{Katakana}", r"\p{Latin}+", r"\p{Greek}+",
    r"\p{Common}+", r"\p{Hani}+", r"\p{^Latin}+", r"\P{Cyrillic}+", r"[\p{Han}\p{Latin}]+",
    r"\p{Letter}+", r"\p{Uppercase_Letter}", r"(?i)hello", r"a(?i)b|c", r"(?<word>\w+) \k<word>",
    r"(?>a+)b", r"a++b", r"\x41\x{42}C", r"\Aab", r"ab\z", r"ab\Z", r"\R", r"\N+",
    r"(?m)a.b", r"\e", r"[\x{4e00}-\x{4e0f}]+", r"\s+(?!\S)|\s+", r"[^\r\n\p{L}\p{N}]?\p{L}+",
]
REGEX_TEXTS = ["foo bar_baz 42", "Hello WORLD hello", "a\nb\r\nc\n", "abc xyz aei 019",
               "日本語のテキスト 漢字 カタカナ", "Ελληνικά и русский", "00FFab_gh", "a b\x0bc",
               "foobar foo", "ab", "ab\n", "aaab", "ABCD", "a\nb", "\x1b!", "一丁七万丈", "  x  ",
               "²³¹¼ ‍ a‌b"]


@pytest.mark.parametrize("pattern", REGEX_CASES)
def test_regex_splits_as_tokenizers(pattern):
    """Each construct ``translate_regex`` once refused, as ``Split`` cuts
    with it (isolated and removed)."""
    rx = re.compile(translate_regex(pattern))
    for behavior, camel in (("isolated", "Isolated"), ("removed", "Removed")):
        ref = pre_tokenizers.Split(tokenizers.Regex(pattern), behavior=behavior)
        for text in REGEX_TEXTS:
            want = [off for _, off in ref.pre_tokenize_str(text)]
            assert split_pieces(text, rx, camel) == want, (pattern, text, behavior)


@pytest.mark.parametrize("pattern", [r"\w", r"\h", r"\p{Han}", r"\p{Hiragana}", r"\p{Latin}",
                                     r"\p{Arabic}", r"\p{Common}", r"\p{Inherited}",
                                     r"\p{Unknown}", r"\p{Garay}", r"[\w&&\P{Latin}]"])
def test_regex_class_equal_on_every_code_point(pattern):
    text = "".join(_every_cp())
    kept = "".join(p for p, _ in pre_tokenizers.Split(
        tokenizers.Regex(pattern), behavior="removed").pre_tokenize_str(text))
    want = set(text) - set(kept)
    rx = re.compile(translate_regex(pattern))
    assert {c for c in _every_cp() if rx.fullmatch(c)} == want


@pytest.mark.parametrize("pattern,construct", [
    (r"\X", "\\X"), (r"a\Kb", "\\K"), (r"\Ga", "\\G"), (r"(?~abc)", "absent operator"),
    (r"[[:alpha:]]+", "POSIX bracket"), (r"\p{In_Basic_Latin}", "\\p{In_Basic_Latin}"),
    (r"\p{Alpha}", "\\p{Alpha}"), (r"\p{Cn}", "\\p{Cn}"), (r"(a)\g<1>", "\\g"),
    (r"(?<=a|bc)d", "regex"),
])
def test_regex_constructs_python_cannot_express_answer_501(pattern, construct):
    """What ``re`` cannot express keeps the typed refusal (ROADMAP.md §C),
    and ``tokenizers`` itself takes each one."""
    tokenizers.Regex(pattern)
    spec = _with(_wordlevel(), pre_tokenizer={"type": "Split", "pattern": {"Regex": pattern},
                                              "behavior": "Isolated", "invert": False})
    with pytest.raises(UnsupportedTokenizerError) as e:
        Tokenizer.from_str(spec)
    assert construct in e.value.component


# -- Precompiled --------------------------------------------------------------------------

LOOKUP_MAP = {"a": "A", "e": "E", "é": "X", "é": "Y", "ff": "F"}


def _precompiled_pair(mapping: dict):
    raw = charsmap_bytes(mapping)
    ref = normalizers.Precompiled(raw)
    port = precompiled.Precompiled(base64.b64encode(raw).decode())
    return ref, port


@pytest.mark.parametrize("text,want", [
    ("ét", "Et"),  # the cluster takes e's value: the accent is lost
    ("xé́y", "xXy"),
    ("á̂̃b", "Á̂̃b"),  # 7 bytes: one character at a time
    ("off", "off"),  # no cluster is "ff"
    ("aaée", "AAEE"), ("", ""),
])
def test_precompiled_lookup_rules(text, want):
    ref, port = _precompiled_pair(LOOKUP_MAP)
    assert ref.normalize_str(text) == want
    assert port(text) == want


GRAPHEME_CASES = [
    "é", "é̂", "á̂̃", "à́̂̃̄",
    "é́", "👩‍💻", "👨‍👩‍👧", "©‍©", "©‍", "a‍©",
    "👍🏽", "각", "각", "각ᆨ", "ᄀ가", "ᄀ가", "\r\n", "\r\r\n", "\n\r", "🇫🇷",
    "🇫🇷🇩", "🇫🇷🇩🇪", "a🇫🇷", "؀a", "؀؀a", "कि", "क्ष", "क्‍ष",
    "aः", "\x01́", "́", "a‌", "ab", "áb", "日本゙",
]


def test_precompiled_grapheme_cases():
    """Under the identity map a cluster under 6 bytes keeps only its first
    character (one lookup of the whole cluster), a longer one all of them."""
    keys = {ch for case in GRAPHEME_CASES for ch in case} | set("abc")
    ref, port = _precompiled_pair({ch: ch for ch in keys if ch != "\0"})
    for case in GRAPHEME_CASES:
        for text in (case, "x" + case, case + "y", case + case):
            assert port(text) == ref.normalize_str(text), [hex(ord(c)) for c in text]


def test_precompiled_clusters_equal_on_every_code_point():
    """Every code point after ``a``, before a combining mark and after
    U+00A9 + ZWJ, under an identity map of planes 0 and 1 (the generator of
    ``unicode_tables`` probes more layouts under a map of every code
    point)."""
    keys = [c for c in _every_cp()[:0x20000] if c != "\0"]
    ref, port = _precompiled_pair({c: c for c in keys})
    for layout in (lambda c: f"a{c}", lambda c: f"{c}́", lambda c: f"©‍{c}"):
        for chunk in _chunks(_every_cp(), 16384):
            text = "\x02".join(layout(c) for c in chunk)
            if port(text) != ref.normalize_str(text):
                bad = [c for c in chunk if port(layout(c)) != ref.normalize_str(layout(c))]
                raise AssertionError([hex(ord(c)) for c in bad[:8]])


_MAP_ALPHABET = "abcé́̂‍👩💻각\r\n🇫🇷 "


@settings(max_examples=150, deadline=None, derandomize=True)
@given(mapping=st.dictionaries(st.text(_MAP_ALPHABET, min_size=1, max_size=3),
                               st.text("xyzABé ", max_size=3), min_size=1, max_size=12),
       texts=st.lists(st.text(_MAP_ALPHABET, max_size=10), min_size=1, max_size=4))
def test_precompiled_hypothesis(mapping, texts):
    ref, port = _precompiled_pair(mapping)
    for text in texts:
        assert port(text) == ref.normalize_str(text), (mapping, text)


def test_charsmap_writer_pads_the_trie():
    """The array is a multiple of 256 units with one spare block, so every
    lookup stays inside it; a truncated array is refused or fails loudly."""
    raw = charsmap_bytes(LOOKUP_MAP)
    size = int.from_bytes(raw[:4], "little")
    assert size % 1024 == 0 and size >= 2048
    with pytest.raises(ValueError):
        precompiled.Precompiled(base64.b64encode(raw[:5]).decode())


def test_precompiled_empty_charsmap_fails_the_load():
    """``tokenizers`` panics on an empty charsmap; the port fails the load."""
    with pytest.raises(TokenizerLoadError):
        Tokenizer.from_str(_with(_wordlevel(), normalizer={"type": "Precompiled",
                                                           "precompiled_charsmap": ""}))


# -- Unigram ------------------------------------------------------------------------------


def _unigram(byte_fallback: bool, precompiled_map=None) -> dict:
    """A Unigram trained on the corpus (T5/XLM-R layout: Metaspace, the
    specials in the vocab), with byte fallback as asked; optionally behind
    ``Sequence[Precompiled, Replace(" {2,}", " ")]``."""
    tok = tokenizers.Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    trainer = trainers.UnigramTrainer(vocab_size=300, special_tokens=["<pad>", "</s>", "<unk>"],
                                      unk_token="<unk>", show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    tok.decoder = decoders.Metaspace()
    spec = json.loads(tok.to_str())
    if byte_fallback:  # the trainer writes no byte pieces: the 256 appended
        vocab = spec["model"]["vocab"]
        low = min(score for _, score in vocab)
        vocab += [[f"<0x{b:02X}>", low - 1.0] for b in range(256)]
        spec["model"]["byte_fallback"] = True
        spec["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
             "split": True}, {"type": "ByteFallback"}]}
    if precompiled_map is not None:
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": write_charsmap(precompiled_map)},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    return spec


NFKC_SAMPLE = {"ﬁ": "fi", "ﬀ": "ff", "Ａ": "A", "ａ": "a", "①": "1", "…": "...", "“": '"',
               "”": '"', " ": " ", "\t": " ", "é": "é", "Ω": "Ω"}


@pytest.mark.parametrize("byte_fallback,charsmap", [(False, None), (True, None),
                                                    (False, NFKC_SAMPLE), (True, NFKC_SAMPLE)],
                         ids=["plain", "byte-fallback", "precompiled", "both"])
def test_unigram_encodes_and_decodes_equal(byte_fallback, charsmap):
    text = json.dumps(_unigram(byte_fallback, charsmap))
    ref, port = _pair(text)
    assert json.loads(text)["model"]["byte_fallback"] is byte_fallback
    for t in FIXED + CORPUS[:10]:
        _assert_encode_equal(ref, port, t)
        _assert_decode_equal(ref, port, ref.encode(t).ids)
    n = ref.get_vocab_size()
    _assert_decode_equal(ref, port, list(range(n + 2)))


@settings(max_examples=120, deadline=None, derandomize=True)
@given(text=st.text(alphabet="abcdefghijklmnopqrstuvwxyz ABCé中文🙂́\t.,!?0123456789",
                    max_size=40),
       which=st.sampled_from(["plain", "byte-fallback"]))
def test_unigram_hypothesis(unigram_files, text, which):
    ref, port = unigram_files[which]
    _assert_encode_equal(ref, port, text)


@pytest.fixture(scope="module")
def unigram_files():
    return {"plain": _pair(json.dumps(_unigram(False))),
            "byte-fallback": _pair(json.dumps(_unigram(True)))}


def _tie_vocab(pieces):
    return {"type": "Unigram", "unk_id": 0, "byte_fallback": False,
            "vocab": [["<unk>", 0.0], *pieces]}


@pytest.mark.parametrize("pieces", [
    # "ab" + "c" and "a" + "bc" tie: the first found stays
    [["a", -1.0], ["b", -1.0], ["c", -1.0], ["ab", -1.5], ["bc", -1.5], ["abc", -3.0]],
    [["a", -1.0], ["b", -1.0], ["c", -1.0], ["ab", -2.0], ["bc", -2.0]],
    # scores whose f64 sums round: 0.1 + 0.2 against 0.3
    [["a", -0.1], ["b", -0.2], ["ab", -0.3], ["c", -0.7], ["bc", -0.9]],
    [["a", -0.5], ["aa", -1.0], ["aaa", -1.5], ["b", -10.0]],
    # a piece listed twice takes its last id and score
    [["a", -1.0], ["b", -1.0], ["a", -0.1], ["ab", -5.0]],
    [["x", -2.0], ["́", -1.0], ["é", -0.5]],
], ids=["ab+c=a+bc", "equal-parts", "f64-rounding", "runs", "duplicate", "combining"])
def test_unigram_score_ties(pieces):
    spec = _with(_wordlevel(), model=_tie_vocab(pieces), pre_tokenizer=None)
    ref, port = _pair(spec)
    for text in ("abc", "abcabc", "aaaa", "aaaaab", "ab", "cab", "zzz", "xé́z", "a🙂b", ""):
        _assert_encode_equal(ref, port, text)


def test_unigram_unknowns_fuse_and_load_errors_match():
    spec = _tie_vocab([["a", -1.0]])
    ref, port = _pair(_with(_wordlevel(), model=spec))
    assert port.encode("xyaxy") == ref.encode("xyaxy").ids == [0, 1, 0]
    # no unk id: an unknown character fails the encode in both
    ref, port = _pair(_with(_wordlevel(), model={**spec, "unk_id": None}))
    with pytest.raises(Exception, match="unk"):
        ref.encode("x")
    with pytest.raises(ValueError, match="unk"):
        port.encode("x")
    for bad in ({**spec, "unk_id": 5}, {**spec, "unk_id": 0, "vocab": []}):
        with pytest.raises(Exception):
            tokenizers.Tokenizer.from_str(_with(_wordlevel(), model=bad))
        with pytest.raises(TokenizerLoadError):
            Tokenizer.from_str(_with(_wordlevel(), model=bad))


# -- BPE dropout --------------------------------------------------------------------------


def _bpe(dropout) -> str:
    tok = tokenizers.Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=300, special_tokens=["[UNK]"], show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    spec = json.loads(tok.to_str())
    spec["model"]["dropout"] = dropout
    spec["model"]["ignore_merges"] = True
    return json.dumps(spec)


@pytest.mark.parametrize("dropout", [0.0, 1.0])
def test_bpe_dropout_at_the_ends_is_exact(dropout):
    """0 is no dropout (the word cache and ignore_merges in use); 1 drops
    every merge."""
    ref, port = _pair(_bpe(dropout))
    for t in FIXED + CORPUS[:10]:
        _assert_encode_equal(ref, port, t)
    if dropout == 1.0:
        assert len(port.encode("quick")) == 5


@pytest.mark.parametrize("dropout", [0.1, 0.5])
def test_bpe_dropout_segmentations_and_frequencies(dropout):
    """The same segmentations (each drawn ``DROPOUT_SEEN`` times by one
    reader is drawn by the other), each with a frequency within
    ``DROPOUT_TOL`` of the reference's over ``DROPOUT_SAMPLES`` encodes; the
    port's draws repeat under one seed."""
    ref, port = _pair(_bpe(dropout), seed=1)
    for word in ("believing", "numbers", "the"):
        want = collections.Counter(tuple(ref.encode(word).ids) for _ in range(DROPOUT_SAMPLES))
        got = collections.Counter(tuple(port.encode(word)) for _ in range(DROPOUT_SAMPLES))
        assert {k for k, v in want.items() if v >= DROPOUT_SEEN} <= set(got), word
        assert {k for k, v in got.items() if v >= DROPOUT_SEEN} <= set(want), word
        worst = max(abs(want[k] - got[k]) / DROPOUT_SAMPLES for k in set(want) | set(got))
        assert worst <= DROPOUT_TOL, (word, worst)
    a, b = Tokenizer.from_str(_bpe(dropout), seed=1), Tokenizer.from_str(_bpe(dropout), seed=1)
    assert [a.encode("believing") for _ in range(30)] == [b.encode("believing") for _ in range(30)]


def test_bpe_dropout_out_of_range_fails_the_load():
    spec = json.loads(_bpe(None))
    spec["model"]["dropout"] = 1.5
    with pytest.raises(Exception, match="Dropout should be between 0 and 1"):
        tokenizers.Tokenizer.from_str(json.dumps(spec))
    with pytest.raises(TokenizerLoadError, match="Dropout should be between 0 and 1"):
        Tokenizer.from_str(json.dumps(spec))


# -- decoders and post-processors ---------------------------------------------------------

DECODE_VOCAB = {"[UNK]": 0, "<pad>": 1, "|": 2, "h": 3, "e": 4, "l": 5, "o": 6, "w": 7, "r": 8,
                "d": 9, "'": 10, "s": 11, ".": 12, "hel</w>": 13, "lo</w>": 14, "wor": 15,
                "ld</w>": 16, "do": 17, " n't": 18, "</w>": 19}


@pytest.mark.parametrize("decoder", [
    {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|", "cleanup": True},
    {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|", "cleanup": False},
    {"type": "CTC", "pad_token": "h", "word_delimiter_token": "l", "cleanup": True},
    {"type": "BPEDecoder", "suffix": "</w>"},
    {"type": "BPEDecoder", "suffix": "o"},
], ids=["ctc", "ctc-no-cleanup", "ctc-odd-tokens", "bpe", "bpe-o"])
def test_decoders_equal(decoder):
    ref, port = _pair(_with(_wordlevel(DECODE_VOCAB), decoder=decoder))
    for ids in ([3, 3, 4, 1, 5, 5, 1, 5, 6, 2, 7, 6, 8, 5, 9], [13, 14, 15, 16], [1, 1, 1],
                [], [2, 2, 12, 10, 11, 2, 18], [17, 2, 18, 12], [19, 19, 3], [0, 5, 5, 5, 2]):
        _assert_decode_equal(ref, port, ids)


def _specials_spec(**parts) -> str:
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "a": 4, "b": 5, "c": 6, "d": 7}
    tok = tokenizers.Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.add_special_tokens(["[PAD]", "[CLS]", "[SEP]"])
    return _with(json.loads(tok.to_str()), **parts)


_A = {"Sequence": {"id": "A", "type_id": 0}}
_B = {"Sequence": {"id": "B", "type_id": 1}}


def _s(name):
    return {"SpecialToken": {"id": name, "type_id": 0}}


_SPECIALS = {"[CLS]": {"id": "[CLS]", "ids": [2], "tokens": ["[CLS]"]},
             "[SEP]": {"id": "[SEP]", "ids": [3], "tokens": ["[SEP]"]},
             "X": {"id": "X", "ids": [2, 3, 2], "tokens": ["[CLS]", "[SEP]", "[CLS]"]}}


def _template(single):
    return {"type": "TemplateProcessing", "single": single, "pair": [_A, _B],
            "special_tokens": _SPECIALS}


POST_PROCESSORS = {
    "roberta": {"type": "RobertaProcessing", "sep": ["[SEP]", 3], "cls": ["[CLS]", 2],
                "trim_offsets": True, "add_prefix_space": True},
    "bert": {"type": "BertProcessing", "sep": ["[SEP]", 3], "cls": ["[CLS]", 2]},
    "cls-a-sep": _template([_s("[CLS]"), _A, _s("[SEP]")]),
    "a-a": _template([_A, _A]),
    "multi-id": _template([_s("X"), _A, _s("X")]),
    "special-only": _template([_s("[CLS]")]),
    "empty": _template([]),
    "a-cls-a": _template([_A, _s("[CLS]"), _A]),
    "sequence": {"type": "Sequence", "processors": [_template([_s("[CLS]"), _A]),
                                                    _template([_A, _s("[SEP]")])]},
    "sequence-roberta": {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
         "use_regex": True}, {"type": "RobertaProcessing", "sep": ["[SEP]", 3],
                              "cls": ["[CLS]", 2], "trim_offsets": True,
                              "add_prefix_space": True}]},
}


@pytest.mark.parametrize("name", sorted(POST_PROCESSORS))
def test_post_processors_equal(name):
    ref, port = _pair(_specials_spec(post_processor=POST_PROCESSORS[name]))
    for text in ("a b c", "", "d", "a [SEP] b"):
        _assert_encode_equal(ref, port, text)


# -- truncation and padding -------------------------------------------------------------


def _trunc(max_length, strategy="LongestFirst", direction="Right", stride=0):
    return {"max_length": max_length, "strategy": strategy, "stride": stride,
            "direction": direction}


def _pad(strategy, direction="Right", multiple=None):
    return {"strategy": strategy, "direction": direction, "pad_to_multiple_of": multiple,
            "pad_id": 0, "pad_type_id": 0, "pad_token": "[PAD]"}


_CLS_SEP = POST_PROCESSORS["cls-a-sep"]
TRUNCATION_PADDING = {
    "4": (_CLS_SEP, _trunc(4), None),  # [CLS] a b [SEP]: specials counted
    "4-left": (_CLS_SEP, _trunc(4, direction="Left"), None),  # the tail kept
    "below-specials": (_CLS_SEP, _trunc(1), None),  # not truncated at all
    "equal-specials": (_CLS_SEP, _trunc(2), None),
    "zero": (_CLS_SEP, _trunc(0), None),
    "zero-no-processor": (None, _trunc(0), None),
    "2-no-processor": (None, _trunc(2), None),
    "only-first": (_CLS_SEP, _trunc(4, "OnlyFirst"), None),
    "stride": (_CLS_SEP, _trunc(8, stride=2), None),  # overflow only
    "multi-id": (POST_PROCESSORS["multi-id"], _trunc(8), None),
    "batch-longest-8": (_CLS_SEP, None, _pad("BatchLongest", multiple=8)),
    "fixed-8-left": (_CLS_SEP, None, _pad({"Fixed": 8}, "Left")),
    "fixed-below": (_CLS_SEP, None, _pad({"Fixed": 2})),
    "fixed-5-multiple-4": (_CLS_SEP, None, _pad({"Fixed": 5}, multiple=4)),
    "multiple-0": (_CLS_SEP, None, _pad("BatchLongest", multiple=0)),
    "both": (_CLS_SEP, _trunc(4), _pad({"Fixed": 6})),
    "both-left": (POST_PROCESSORS["roberta"], _trunc(5, direction="Left"),
                  _pad("BatchLongest", "Left", 4)),
}


@pytest.mark.parametrize("name", sorted(TRUNCATION_PADDING))
def test_truncation_and_padding_equal(name):
    pp, trunc, pad = TRUNCATION_PADDING[name]
    ref, port = _pair(_specials_spec(post_processor=pp, truncation=trunc, padding=pad))
    for text in ("a b c d a b", "a b c", "a", "", "a b c d a b c d a b c d"):
        _assert_encode_equal(ref, port, text)


def test_specials_counted_and_padding_to_a_multiple():
    ref, port = _pair(_specials_spec(post_processor=_CLS_SEP, truncation=_trunc(4)))
    assert port.encode("a b c d") == ref.encode("a b c d").ids == [2, 4, 5, 3]
    ref, port = _pair(_specials_spec(post_processor=_CLS_SEP,
                                     padding=_pad("BatchLongest", multiple=8)))
    assert port.encode("a b c") == ref.encode("a b c").ids == [2, 4, 5, 6, 3, 0, 0, 0]


@pytest.mark.parametrize("trunc,match", [
    (_trunc(4, "OnlySecond"), "Second sequence not provided"),
    (_trunc(4, stride=2), "`stride` must be strictly less than `max_len=2`"),
])
def test_truncation_errors_match(trunc, match):
    ref, port = _pair(_specials_spec(post_processor=_CLS_SEP, truncation=trunc))
    with pytest.raises(BaseException, match=match):
        ref.encode("a b c d a b")
    with pytest.raises(ValueError, match=match):
        port.encode("a b c d a b")
    assert port.encode("a") == ref.encode("a").ids  # nothing to cut


# -- whole pipelines ----------------------------------------------------------------------

_NORMALIZERS = [
    {"type": "Lowercase"}, {"type": "StripAccents"}, {"type": "Nmt"}, {"type": "NFKC"},
    {"type": "NFD"}, {"type": "Strip", "strip_left": True, "strip_right": False},
    {"type": "Strip", "strip_left": True, "strip_right": True}, {"type": "ByteLevel"},
    {"type": "Replace", "pattern": {"Regex": r"\s+"}, "content": " "},
    {"type": "Replace", "pattern": {"Regex": r"[\p{P}&&[^.]]"}, "content": ""},
    {"type": "Prepend", "prepend": "▁"},
    {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True,
     "strip_accents": None, "lowercase": True},
    {"type": "Precompiled", "precompiled_charsmap": "NFKC_SAMPLE"},
    # deletions (at the start too), insertions and growth
    {"type": "Precompiled", "precompiled_charsmap": "ODD"},
]
_ODD_MAP = {"​": "", " ": "  ", "H": "", "ﬁ": "f i", "e": "", "a": "aa", "\t": ""}
_PRE_TOKENIZERS = [
    {"type": "WhitespaceSplit"}, {"type": "Whitespace"}, {"type": "BertPreTokenizer"},
    {"type": "Digits", "individual_digits": True}, {"type": "Digits", "individual_digits": False},
    {"type": "Punctuation", "behavior": "Isolated"},
    {"type": "Punctuation", "behavior": "MergedWithNext"}, {"type": "UnicodeScripts"},
    {"type": "FixedLength", "length": 2}, {"type": "FixedLength", "length": 4},
    {"type": "CharDelimiterSplit", "delimiter": " "},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
    {"type": "Split", "pattern": {"Regex": r"\b\w+\b|\W"}, "behavior": "Isolated",
     "invert": False},
    {"type": "Split", "pattern": {"Regex": r"^\s+|\p{Han}+"}, "behavior": "MergedWithPrevious",
     "invert": False},
    {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
]
_PIPELINE_TEXTS = FIXED + CORPUS[:10] + ["​Hello", "  lo lo", "lo world", "HHHx", "\tea",
                                         "ﬁne", " Hello", "  Hello, WORLD!! 12.5% ÀÉÎ ﬁ  日本語ー  x"]


def _pipeline_spec(model: dict, norms, pres, added) -> str:
    charsmaps = {"NFKC_SAMPLE": write_charsmap(NFKC_SAMPLE), "ODD": write_charsmap(_ODD_MAP)}
    norms = [{**n, "precompiled_charsmap": charsmaps[n["precompiled_charsmap"]]}
             if n["type"] == "Precompiled" else n for n in norms]
    spec = copy.deepcopy(model)
    spec["normalizer"] = {"type": "Sequence", "normalizers": norms}
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": pres}
    if added:  # the file's ids collide with the vocab's: tokenizers assigns its own
        spec["added_tokens"] = (spec.get("added_tokens") or []) + [
            {"id": 1, "content": "lo", "single_word": False, "lstrip": True, "rstrip": False,
             "normalized": True, "special": False},
            {"id": 2, "content": "  ", "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True}]
    return json.dumps(spec)


@pytest.fixture(scope="module")
def pipeline_models():
    return {"bpe": json.loads(_bpe(None)), "unigram": _unigram(True)}


@settings(max_examples=60, deadline=None, derandomize=True)
@given(model=st.sampled_from(["bpe", "unigram"]),
       norms=st.lists(st.sampled_from(range(len(_NORMALIZERS))), max_size=3, unique=True),
       pres=st.lists(st.sampled_from(range(len(_PRE_TOKENIZERS))), max_size=3, unique=True),
       added=st.booleans())
def test_random_pipelines_encode_equal(pipeline_models, model, norms, pres, added):
    """Chains of the normalizers and pre-tokenizers over both models, with
    added tokens whose file ids collide: the ids equal ``tokenizers``' where
    it encodes (it panics on some chains, as after a Precompiled deletion
    at the very start; those texts are skipped). Metaspace's "first" reads
    which pieces still align to the input's offset 0 after every step."""
    text = _pipeline_spec(pipeline_models[model], [_NORMALIZERS[i] for i in norms],
                          [_PRE_TOKENIZERS[i] for i in pres], added)
    ref, port = _pair(text)
    for t in _PIPELINE_TEXTS:
        for special in (True, False):
            try:
                want = ref.encode(t, add_special_tokens=special).ids
            except BaseException:  # a panic inside tokenizers
                continue
            assert port.encode(t, add_special_tokens=special) == want, (t, norms, pres)


@pytest.mark.parametrize("norms,pres,text", [
    # Strip drops the offset-0 character: no piece is "first"
    ([{"type": "Strip", "strip_left": True, "strip_right": False}],
     [{"type": "Punctuation", "behavior": "MergedWithNext"},
      {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True}],
     "  lead and trail  "),
    # Prepend's characters and the first one all align to offset 0
    ([{"type": "Prepend", "prepend": "▁"}],
     [{"type": "Split", "pattern": {"Regex": r"\b\w+\b|\W"}, "behavior": "Isolated",
       "invert": False},
      {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True}],
     "Don't stop"),
    # a multi-byte first character split across pieces: each piece is "first"
    ([{"type": "ByteLevel"}],
     [{"type": "FixedLength", "length": 2},
      {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True}],
     "👩‍💻!"),
    # a deletion at the very start shifts the next character onto offset 0
    ([{"type": "Precompiled", "precompiled_charsmap": "ODD"}],
     [{"type": "FixedLength", "length": 1},
      {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False}],
     "​Hello"),
], ids=["strip", "prepend", "byte-level", "precompiled-deletion"])
def test_metaspace_first_reads_original_offsets(pipeline_models, norms, pres, text):
    ref, port = _pair(_pipeline_spec(pipeline_models["bpe"], norms, pres, False))
    _assert_encode_equal(ref, port, text)


def test_added_token_ids_are_assigned_as_tokenizers_loads_them():
    """The file's ids are not read: an added token takes its content's id in
    the vocab, else the next one past the vocab; a repeated content keeps
    its id and takes the later entry's options."""
    vocab = {"a": 0, "b": 1, "c": 2, "lo": 3}
    spec = json.loads(tokenizers.Tokenizer(models.WordLevel(vocab, unk_token="a")).to_str())
    spec["added_tokens"] = [
        {"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": sp}
        for i, c, sp in ((9, "X", True), (7, "Y", True), (0, "lo", False), (1, "Z", False),
                         (2, "X", False))]
    ref, port = _pair(json.dumps(spec))
    for t in ("X", "Y", "lo", "Z", "aXbYloZ"):
        assert port.token_to_id(t) == ref.token_to_id(t), t
        _assert_encode_equal(ref, port, t)
    _assert_decode_equal(ref, port, [4, 5, 3, 6, 0])


@pytest.mark.parametrize("pattern", [r"x*", r"x*|y", r"^", r"$", r"\b", r"(?=a)"])
def test_empty_matches_iterate_as_oniguruma(pattern):
    """An empty match where the last match ended is skipped (Python's
    ``finditer`` keeps it), an empty text has no match, ``^`` never
    matches at the end after a newline."""
    texts = ("xxy", "abc", "a\n", "a\n\n", "", "xx yxx", "aa")
    ref = normalizers.Replace(tokenizers.Regex(pattern), "-")
    port = _normalizer({"type": "Replace", "pattern": {"Regex": pattern}, "content": "-"})
    split = pre_tokenizers.Split(tokenizers.Regex(pattern), behavior="isolated")
    rx = re.compile(translate_regex(pattern))
    for t in texts:
        assert port(t) == ref.normalize_str(t), (pattern, t)
        assert split_pieces(t, rx, "Isolated") == [off for _, off in split.pre_tokenize_str(t)]


# -- load errors ----------------------------------------------------------------------------


@pytest.mark.parametrize("part,value", [
    ("normalizer", {"type": "Foo"}), ("pre_tokenizer", {"type": "Foo"}),
    ("post_processor", {"type": "Foo"}), ("decoder", {"type": "Foo"}),
    ("model", {"type": "Foo", "vocab": {}}),
    ("normalizer", {"type": "Sequence", "normalizers": [{"type": "Lowercase"}, {"type": "Foo"}]}),
])
def test_unknown_component_fails_the_load_as_tokenizers(part, value):
    """A type ``tokenizers`` does not know fails the load with its message,
    position included."""
    for indent in (None, 2):
        spec = _wordlevel()
        spec["added_tokens"] = [{"id": 9, "content": "é中", "single_word": False,
                                 "lstrip": False, "rstrip": False, "normalized": False,
                                 "special": True}]
        spec[part] = value
        text = json.dumps(spec, indent=indent, ensure_ascii=False)
        with pytest.raises(Exception) as want:
            tokenizers.Tokenizer.from_str(text)
        with pytest.raises(TokenizerLoadError) as got:
            Tokenizer.from_str(text)
        assert str(got.value) == str(want.value)


# -- the servers ----------------------------------------------------------------------------


def _serve_files():
    """(name, tokenizer.json) served by both pods: a Unigram behind a
    Precompiled charsmap with a template, and a truncation + padding
    file."""
    uni = _unigram(False, NFKC_SAMPLE)
    uni["post_processor"] = {
        "type": "TemplateProcessing", "single": [_A, {"SpecialToken": {"id": "</s>",
                                                                        "type_id": 0}}],
        "pair": [_A, _B], "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                                      "tokens": ["</s>"]}}}
    padded = json.loads(_specials_spec(post_processor=_CLS_SEP, truncation=_trunc(6),
                                       padding=_pad("BatchLongest", multiple=8)))
    broken = _wordlevel()
    broken["normalizer"] = {"type": "NoSuchNormalizer"}
    return {"unigram": uni, "padded": padded, "broken": broken}


@pytest.fixture(scope="module")
def text_pods(tmp_path_factory):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from modelx_tpu.dl import safetensors as jst
    from modelx_tpu.dl.serve import ModelServer as JaxModelServer
    from modelx_tpu.dl.serve import ServerSet as JaxServerSet
    from modelx_tpu.dl.serve import serve as jax_serve
    from modelx_tpu.models import llama as jl
    from modelx_tpu.registry.server import free_port
    from modelx_tpu_torch.dl import serve_main

    base = str(tmp_path_factory.mktemp("tiny-text"))
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), rope_theta=500000.0, dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jst.write_safetensors(os.path.join(base, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})
    dirs = {}
    for name, spec in _serve_files().items():
        d = str(tmp_path_factory.mktemp(name))
        os.symlink(os.path.join(base, "model.safetensors"), os.path.join(d, "model.safetensors"))
        with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(spec, f, ensure_ascii=False)
        dirs[name] = d
    jsset = JaxServerSet({n: JaxModelServer(d, mesh_spec="dp=1", dtype="float32",
                                            max_seq_len=64, name=n)
                          for n, d in dirs.items()}, default="unigram")
    jsset.load_all()
    jhttpd = jax_serve(jsset, listen=f"127.0.0.1:{free_port()}")
    argv = [a for n, d in dirs.items() for a in ("--model", f"{n}={d}")]
    _, thttpd = serve_main.start([*argv, "--device", "cpu", "--dtype", "float32",
                                  "--max-seq-len", "64", "--listen",
                                  f"127.0.0.1:{free_port()}"])
    yield jhttpd.server_address[1], thttpd.server_address[1]
    for h in (jhttpd, thttpd):
        h.shutdown()
        h.server_close()


def _call(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("path,body", [
    ("/v1/unigram/generate", {"text": "ﬁne  “quoted” café\tworld", "max_new_tokens": 6}),
    ("/v1/unigram/generate", {"text": "The quick brown fox ét", "max_new_tokens": 4,
                              "temperature": 0.8, "seed": 3}),
    ("/v1/padded/generate", {"text": "a b c", "max_new_tokens": 5}),
    ("/v1/padded/generate", {"text": "a b c d a b c d a b", "max_new_tokens": 5}),
    ("/v1/broken/generate", {"text": "a b", "max_new_tokens": 2}),
], ids=["unigram-greedy", "unigram-sampled", "padded", "truncated-padded", "load-failure"])
def test_text_generate_json_identical_to_jax_sidecar(text_pods, path, body):
    jport, tport = text_pods
    jstatus, jbody = _call(jport, path, body)
    tstatus, tbody = _call(tport, path, body)
    assert tstatus == jstatus
    assert tbody == jbody
