"""The port's tokenizer.json reader (modelx_tpu_torch.dl.tokenizer) against
the ``tokenizers`` package the JAX sidecar encodes with, on the CPU.

Each configuration is a ``tokenizers.Tokenizer`` trained in the test on a
small corpus with the BPE trainer, given the components of one family's
published tokenizer.json (Llama-3, Qwen2, Llama-2 byte fallback, Mistral
Metaspace, GPT-2 ByteLevel, the word-level file of tests/test_openai_api.py)
and saved; both readers load the same JSON. The BERT files, uncased and
cased, are WordPiece trained the same way, with the BertNormalizer, the
BertPreTokenizer, a TemplateProcessing or BertProcessing ``[CLS] ... [SEP]``
and the WordPiece decoder, and a 16-character word limit so an over-long
word becomes ``[UNK]``. Ids and strings must be
exactly equal: fixed cases, decodes that split a UTF-8 sequence or leave
the vocab, and a derandomized hypothesis search over strings drawn from
the same alphabets.

Unicode versions: Python 3.12's unicodedata is Unicode 15.0, the regex
tables inside tokenizers 0.22 are Unicode 16.0. The reader classes the
5,812 code points assigned in between from its own table
(``UNICODE_AFTER_15_0``): each \\p{..} class and \\w must take exactly the
code points the ``tokenizers`` regex engine takes, and every one of the
5,004 letters and digits among them must encode to the same ids. Code
points unassigned in both versions stay out of the generated strings. The
BERT components read older tables inside ``tokenizers``: every code point
but the surrogates goes through each BertNormalizer option and the
BertPreTokenizer on both sides.
"""

import copy
import json
import re
import unicodedata

import pytest
import tokenizers
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import decoders, models, normalizers, pre_tokenizers, trainers

import chip_smoke
from modelx_tpu_torch.dl.tokenizer import (
    UNICODE_AFTER_15_0,
    Tokenizer,
    UnsupportedTokenizerError,
    _word_class,
    category,
    split_pieces,
    translate_regex,
)

# the pre-tokenizer regexes of Meta-Llama-3-8B's and Qwen2-7B's tokenizer.json
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?"
                  r"[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?"
                 r"[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CORPUS = [
    "The quick brown fox jumps over the lazy dog. I'LL say it's fine; we've seen worse.",
    "Numbers: 1234567 and 2024-05-01, pi is 3.14159, call 555-0100 now!",
    "Don't stop believing\r\n\nHold on to that feeling.\tTabs\tand  double  spaces.",
    "café naïve résumé Straße ſome KELVIN and the end of Ω.",
    "你好，世界。这是一个测试句子，包含中文标点！日本語のテキストもあります。",
    "Emoji: 🙂👍🏽🎉 and flags 🇫🇷 with ZWJ 👩‍💻 sequences.",
    "Arabic: مرحبا بالعالم — Hindi: नमस्ते दुनिया — Korean: 안녕하세요",
    "def main(argv):\n    return sum(x ** 2 for x in range(10))  # code\n",
    "Non\xa0breaking\xa0space, ideographic　space, line separator.",
    "Control chars \x1c\x1d\x1e\x1f between words, and \x85 next line.",
    "<|begin_of_text|>special tokens inside<|eot_id|> the text <s> and </s>.",
    "hello world tpu hello world the the the of and to in is was for on with",
] * 3

FIXED = [
    "", " ", "I'LL", "I'll WE'VE they'RE", "123456789", "12 345 6789 0",
    "\r\n\n", "a\r\n\nb", "     word", "   spaced   out   ", "a\x1cb", "x\x1c\x1d\x1e\x1fy",
    "non\xa0breaking", "中文测试", "🙂🙂", "👩‍💻!", "é", "Ω ſ K", "tab\tnew\nline",
    "<|begin_of_text|>hi", "a<|eot_id|>b", "<s>x</s>", "<|im_start|>user\nhi<|im_end|>",
    "hello world tpu", "w5 w6 unknown", "'s's's", "...!!!???", "naïve café",
    "ﬁne Ａb ａb Ab XY  XYXY w9x w9xw9x", "①②③ ½ ⅻ",
    "Supercalifragilisticexpialidocious!", "ÀÉÎÕÜ àéîõü ΑΣ İstanbul ǅ", "a\x00b\ufffdc\x07d",
    "你好世界，這是測試。", "[CLS] hello [MASK] world [SEP]", "do not , it ' s ok", "don't !",
]

ALPHABET = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    " \t\n\r\x0b\x0c\x1c\x1d\x1e\x1f\x85\xa0　  ​‍"
    ".,;:!?'\"-_()[]{}<>|/\\@#$%^&*+=~`"
    "ſKΩéèñüßçÉ́̈中文你好世界。，日本語한국어مرحباनमस्तेﬁＡａ①½"
    "🙂👍🏽🎉🇫🇷💻"
    # assigned in Unicode 16.0: Lu, Ll, Lo, Nd, Mn, Po, So
    "\u1c89\u1c8a\U0002ebf0\U00010d40\u0897\u1b4e\u2427"
)
assert not [c for c in ALPHABET if category(c) == "Cn"]

# the code points Unicode 16.0 assigned (Cn in Python 3.12's unicodedata)
NEWER = sorted(cp for ranges in UNICODE_AFTER_15_0.values()
               for a, b in ranges for cp in range(a, b + 1))
NEWER_LN = [cp for cp in NEWER if category(chr(cp))[0] in "LN"]


def _bytes_vocab(vocab: dict) -> dict:
    """``vocab`` with the 256 ``<0xHH>`` byte tokens appended."""
    out = dict(vocab)
    for b in range(256):
        out.setdefault(f"<0x{b:02X}>", len(out))
    return out


def _train(pre_tokenizer, special, vocab_size=700, alphabet=None, **bpe):
    tok = tokenizers.Tokenizer(models.BPE(**bpe))
    tok.pre_tokenizer = pre_tokenizer
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=special,
                                  initial_alphabet=alphabet or [], show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    return json.loads(tok.to_str())


def _llama3() -> dict:
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    spec = _train(pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True), [],
                  alphabet=pre_tokenizers.ByteLevel.alphabet())
    spec["model"]["ignore_merges"] = True
    n = len(spec["model"]["vocab"])
    spec["added_tokens"] = [
        {"id": n + i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True} for i, c in enumerate(specials)]
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]}
    spec["post_processor"] = {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
         "use_regex": True},
        {"type": "TemplateProcessing",
         "single": [{"SpecialToken": {"id": specials[0], "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}}],
         "pair": [{"SpecialToken": {"id": specials[0], "type_id": 0}},
                  {"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": specials[0], "type_id": 1}},
                  {"Sequence": {"id": "B", "type_id": 1}}],
         "special_tokens": {specials[0]: {"id": specials[0], "ids": [n],
                                          "tokens": [specials[0]]}}}]}
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                       "use_regex": True}
    return spec


def _qwen2() -> dict:
    spec = _train(pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True),
                  ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                  alphabet=pre_tokenizers.ByteLevel.alphabet())
    spec["normalizer"] = {"type": "NFC"}
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
         "use_regex": False}]}
    spec["post_processor"] = {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": False, "use_regex": False}
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                       "use_regex": False}
    return spec


_SP_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}


def _sentencepiece_bpe() -> dict:
    spec = _train(pre_tokenizers.Metaspace(), ["<unk>", "<s>", "</s>"], unk_token="<unk>")
    spec["model"].update(vocab=_bytes_vocab(spec["model"]["vocab"]), byte_fallback=True,
                         fuse_unk=True)
    spec["decoder"] = _SP_DECODER
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                   {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}}
    return spec


def _llama2() -> dict:
    spec = _sentencepiece_bpe()
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"},
        {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
    spec["pre_tokenizer"] = None
    # older files write merges as "a b" strings
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    return spec


def _gemma() -> dict:
    """Gemma's (and Gemma-2's) published layout: BPE with byte_fallback
    behind a lone ``Replace(" ", "▁")`` normalizer (no ``Prepend``: no
    dummy prefix), no pre-tokenizer, a ``<bos>`` template, and the decoder
    ``Sequence[Replace, ByteFallback, Fuse]`` (nothing to strip)."""
    spec = _sentencepiece_bpe()
    spec["normalizer"] = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
    spec["pre_tokenizer"] = None
    spec["decoder"] = {"type": "Sequence", "decoders": _SP_DECODER["decoders"][:3]}
    return spec


def test_gemma_layout_encodes_and_decodes_equal():
    """The port's reader takes Gemma's tokenizer.json components as they
    are: ids and strings equal the ``tokenizers`` package's."""
    text = json.dumps(_gemma())
    ref, port = tokenizers.Tokenizer.from_str(text), Tokenizer.from_str(text)
    for t in FIXED + CORPUS[:12] + ["  two  spaces ", "é€ß 🙂"]:
        _assert_encode_equal(ref, port, t)
        _assert_decode_equal(ref, port, ref.encode(t).ids)


def _mistral() -> dict:
    spec = _sentencepiece_bpe()
    spec["normalizer"] = None
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": False}
    return spec


def _gpt2() -> dict:
    spec = _train(pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True),
                  ["<|endoftext|>"], alphabet=pre_tokenizers.ByteLevel.alphabet())
    spec["post_processor"] = {"type": "ByteLevel", "add_prefix_space": True,
                              "trim_offsets": False, "use_regex": True}
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                       "use_regex": True}
    return spec


def _wordlevel() -> dict:
    """tests/test_openai_api.py's tokenizer.json, plus added tokens with
    each matching option."""
    vocab = {"<unk>": 0, "hello": 1, "world": 2, "tpu": 3}
    vocab.update({f"w{i}": i for i in range(4, 64)})
    tok = tokenizers.Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["<s>", "</s>"])
    tok.add_tokens([tokenizers.AddedToken("XY", lstrip=True, rstrip=True),
                    tokenizers.AddedToken("w9x", single_word=True),
                    tokenizers.AddedToken("Ab", normalized=True)])
    spec = json.loads(tok.to_str())
    assert spec["decoder"] is None
    return spec


def _bert(lowercase: bool) -> dict:
    """A BERT tokenizer.json: WordPiece trained on the corpus, the
    BertNormalizer, the BertPreTokenizer, ``[CLS] ... [SEP]`` (uncased
    through a TemplateProcessing, as newer files carry it; cased through
    BertProcessing) and the WordPiece decoder."""
    from tokenizers import processors

    tok = tokenizers.Tokenizer(models.WordPiece(unk_token="[UNK]", max_input_chars_per_word=16))
    tok.normalizer = normalizers.BertNormalizer(lowercase=lowercase)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    trainer = trainers.WordPieceTrainer(
        vocab_size=700, show_progress=False,
        special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    tok.train_from_iterator(CORPUS, trainer)
    cls, sep = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
    if lowercase:
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", cls), ("[SEP]", sep)])
    else:
        tok.post_processor = processors.BertProcessing(("[SEP]", sep), ("[CLS]", cls))
    tok.decoder = decoders.WordPiece(prefix="##", cleanup=True)
    return json.loads(tok.to_str())


def _nfkc_wordlevel() -> dict:
    """The word-level file under NFKC: normalized added tokens match the
    normalized text ("Ａb" -> "Ab")."""
    spec = _wordlevel()
    spec["normalizer"] = {"type": "NFKC"}
    return spec


CONFIGS = {
    "llama3": _llama3, "qwen2": _qwen2, "llama2": _llama2, "mistral": _mistral,
    "gpt2": _gpt2, "wordlevel": _wordlevel, "wordlevel-nfkc": _nfkc_wordlevel,
    "bert-uncased": lambda: _bert(True), "bert-cased": lambda: _bert(False),
    "smoke-llama3": lambda: json.loads(chip_smoke.llama3_tokenizer_json(vocab_size=3000)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    text = json.dumps(CONFIGS[request.param]())
    return request.param, tokenizers.Tokenizer.from_str(text), Tokenizer.from_str(text)


def _assert_encode_equal(ref, port, text):
    for special in (True, False):
        want = ref.encode(text, add_special_tokens=special).ids
        assert port.encode(text, add_special_tokens=special) == want, (text, special)


def _assert_decode_equal(ref, port, ids):
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
            ids, skip_special_tokens=skip), (ids, skip)


def test_fixed_cases_encode_and_decode_equal(pair):
    _name, ref, port = pair
    for text in FIXED + CORPUS[:12]:
        _assert_encode_equal(ref, port, text)
        ids = ref.encode(text).ids
        _assert_decode_equal(ref, port, ids)


def test_decode_split_utf8_and_ids_outside_the_vocab(pair):
    _name, ref, port = pair
    n = ref.get_vocab_size(with_added_tokens=True)
    for text in ("🙂👍🏽 中文", "é€ß", "a🇫🇷b"):
        ids = ref.encode(text, add_special_tokens=False).ids
        for i in range(len(ids) + 1):
            _assert_decode_equal(ref, port, ids[:i])
            _assert_decode_equal(ref, port, ids[i:])
    _assert_decode_equal(ref, port, [n, n + 7, 0, 10**6, 1, n + 1])
    _assert_decode_equal(ref, port, list(range(n + 3)))


def test_token_to_id_equal(pair):
    _name, ref, port = pair
    spec = json.loads(ref.to_str())
    for tok in [t["content"] for t in spec["added_tokens"]] + list(spec["model"]["vocab"])[:300]:
        assert port.token_to_id(tok) == ref.token_to_id(tok), tok
    assert port.token_to_id("no such token ∅") is None


_pieces = st.one_of(
    st.text(alphabet=ALPHABET, max_size=24),
    # any code point assigned in Unicode 16.0 (Cs: not text)
    st.text(alphabet=st.characters(exclude_categories=("Cn", "Cs")), max_size=8),
    st.text(alphabet=st.sampled_from([chr(cp) for cp in NEWER]), max_size=8),
    st.sampled_from(["<|begin_of_text|>", "<|eot_id|>", "<|im_end|>", "<s>", "</s>", "XY",
                     " XY ", "w9x", "Ab", "ab", "I'LL", "'s", "12345", "\r\n\n", "   "]),
)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(pieces=st.lists(_pieces, max_size=6), name=st.sampled_from(sorted(CONFIGS)))
def test_hypothesis_encode_equal(loaded, pieces, name):
    ref, port = loaded[name]
    _assert_encode_equal(ref, port, "".join(pieces))


@settings(max_examples=120, deadline=None, derandomize=True)
@given(data=st.data(), name=st.sampled_from(sorted(CONFIGS)))
def test_hypothesis_decode_equal(loaded, data, name):
    ref, port = loaded[name]
    n = ref.get_vocab_size(with_added_tokens=True)
    ids = data.draw(st.lists(st.integers(0, n + 4), max_size=12))
    _assert_decode_equal(ref, port, ids)


@pytest.fixture(scope="module")
def loaded():
    out = {}
    for name, build in CONFIGS.items():
        text = json.dumps(build())
        out[name] = (tokenizers.Tokenizer.from_str(text), Tokenizer.from_str(text))
    return out


@pytest.mark.parametrize("text", ["a'ſ b'K c'S", "x\x1cy z", " a　b", "12345678"])
def test_translated_regex_splits_as_tokenizers(text):
    for pattern in (LLAMA3_PATTERN, QWEN2_PATTERN):
        ref = pre_tokenizers.Split(tokenizers.Regex(pattern), behavior="isolated")
        want = [off for _, off in ref.pre_tokenize_str(text)]
        rx = re.compile(translate_regex(pattern))
        assert split_pieces(text, rx, "Isolated") == want


@pytest.mark.parametrize("behavior", ["removed", "isolated", "merged_with_previous",
                                      "merged_with_next", "contiguous"])
@pytest.mark.parametrize("invert", [False, True])
def test_split_behaviors_match_tokenizers(behavior, invert):
    camel = {"removed": "Removed", "isolated": "Isolated",
             "merged_with_previous": "MergedWithPrevious", "merged_with_next": "MergedWithNext",
             "contiguous": "Contiguous"}[behavior]
    for text in ("a--b-c---", "--x", "abc", "-", "a-b"):
        ref = pre_tokenizers.Split("-", behavior=behavior, invert=invert)
        want = [off for _, off in ref.pre_tokenize_str(text)]
        assert split_pieces(text, re.compile("-"), camel, invert) == want, text


@pytest.mark.parametrize("scheme", ["always", "first", "never"])
def test_metaspace_decoder_matches_tokenizers(scheme):
    tokens = ["▁▁a", "▁b", "c▁", "▁"]
    tok = tokenizers.Tokenizer(models.WordLevel({t: i for i, t in enumerate(tokens)},
                                                unk_token=tokens[0]))
    tok.decoder = decoders.Metaspace(prepend_scheme=scheme)
    port = Tokenizer.from_str(tok.to_str())
    for ids in ([0, 1, 2, 3], [1, 0], [3, 3]):
        assert port.decode(ids) == tok.decode(ids, skip_special_tokens=False)


def _with(spec: dict, **parts) -> str:
    out = copy.deepcopy(spec)
    out.update(parts)
    return json.dumps(out)


_ONCE_REFUSED = [
    ("model", {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0], ["a", -1.0]]},
     "model Unigram"),
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": None}, "normalizer Precompiled"),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True}, "pre_tokenizer Digits"),
    ("pre_tokenizer", {"type": "Punctuation", "behavior": "Isolated"},
     "pre_tokenizer Punctuation"),
    ("decoder", {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|",
                 "cleanup": True}, "decoder CTC"),
    ("post_processor", {"type": "RobertaProcessing", "sep": ["</s>", 1], "cls": ["<s>", 0],
                        "trim_offsets": True, "add_prefix_space": False},
     "post_processor RobertaProcessing"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"}, "behavior": "Isolated",
                       "invert": False}, "regex escape \\w"),
    ("truncation", {"max_length": 8, "strategy": "LongestFirst", "stride": 0,
                    "direction": "Right"}, "truncation"),
]


@pytest.mark.parametrize("part,value,component", _ONCE_REFUSED)
def test_once_refused_component_loads_and_encodes_equal(part, value, component):
    """What the reader refused until the tokenizer components were ported
    now encodes and decodes as ``tokenizers`` does (the Precompiled case's
    charsmap written by the port's double-array writer)."""
    from modelx_tpu_torch.testing.charsmap import write_charsmap

    if part == "normalizer":
        value = {**value, "precompiled_charsmap": write_charsmap({"é": "e", "Ａ": "A"})}
    vocab = {"<s>": 0, "</s>": 1, "a": 2, "b": 3, "<pad>": 4, "|": 5, "[UNK]": 6}
    base = json.loads(tokenizers.Tokenizer(models.WordLevel(vocab, unk_token="[UNK]")).to_str())
    base["pre_tokenizer"] = {"type": "WhitespaceSplit"}
    text = _with(base, **{part: value})
    ref, port = tokenizers.Tokenizer.from_str(text), Tokenizer.from_str(text)
    for t in ("a b", "a, b! 12 a", "é Ａ b a a a a a a a a a", "ab", "", "<pad>|a"):
        _assert_encode_equal(ref, port, t)
        _assert_decode_equal(ref, port, ref.encode(t).ids)
    _assert_decode_equal(ref, port, [4, 4, 5, 2, 2, 5, 3, 4])


@pytest.mark.parametrize("pattern,component", [
    (r"\X+", "regex escape \\X"),
    (r"a\Kb", "regex escape \\K"),
    (r"\Ga", "regex escape \\G"),
    (r"(?~ab)", "regex absent operator"),
    (r"[[:alpha:]]", "POSIX bracket"),
    (r"\p{In_Basic_Latin}", "regex class \\p{In_Basic_Latin}"),
    (r"\p{Alpha}", "regex class \\p{Alpha}"),
    (r"\p{Cn}", "regex class \\p{Cn}"),
])
def test_unsupported_component_raises_naming_it(pattern, component):
    """A regex construct Python's ``re`` cannot express (ROADMAP.md §C)
    refuses the load, naming it; ``tokenizers`` takes each one."""
    tokenizers.Regex(pattern)
    base = json.loads(tokenizers.Tokenizer(models.WordLevel({"a": 0}, unk_token="a")).to_str())
    split = {"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated",
             "invert": False}
    with pytest.raises(UnsupportedTokenizerError) as e:
        Tokenizer.from_str(_with(base, pre_tokenizer=split))
    assert component in str(e.value) and component in e.value.component


def test_bert_components_load_and_refusals_name_an_open_item():
    """The BERT components load; what the reader still refuses (a regex
    construct Python's ``re`` cannot express) answers the sidecar's 501
    under a label naming the known limits of ROADMAP.md §C."""
    from modelx_tpu_torch.dl.tokenizer import LATER_SLICE

    spec = _bert(True)
    assert (spec["model"]["type"], spec["normalizer"]["type"], spec["pre_tokenizer"]["type"],
            spec["decoder"]["type"]) == ("WordPiece", "BertNormalizer", "BertPreTokenizer",
                                         "WordPiece")
    Tokenizer.from_str(json.dumps(spec))
    assert LATER_SLICE == "tokenizer regex constructs"


def _bert_normalizers():
    """Each BertNormalizer option alone, as (name, JSON spec)."""
    off = {"clean_text": False, "handle_chinese_chars": False, "strip_accents": False,
           "lowercase": False}
    return [(opt, {"type": "BertNormalizer", **off, opt: True}) for opt in off]


_EVERY_CP = [chr(cp) for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF]


@pytest.mark.parametrize("name,spec", _bert_normalizers(), ids=lambda v: v if isinstance(
    v, str) else "")
def test_bert_normalizer_equal_on_every_code_point(name, spec):
    """clean_text (controls removed, whitespace a space), the CJK blocks,
    strip_accents (NFD, non-spacing marks dropped) and lowercase, one code
    point at a time (each option maps characters one by one, so a run of
    them normalizes as their concatenation)."""
    from modelx_tpu_torch.dl.tokenizer import _normalizer

    ref = normalizers.BertNormalizer(**{k: v for k, v in spec.items() if k != "type"})
    port = _normalizer(spec)
    for i in range(0, len(_EVERY_CP), 4096):
        chunk = "".join(_EVERY_CP[i:i + 4096])
        if port(chunk) != ref.normalize_str(chunk):
            bad = [c for c in chunk if port(c) != ref.normalize_str(c)]
            raise AssertionError(f"{name}: {[(hex(ord(c)), port(c), ref.normalize_str(c)) for c in bad[:5]]}")


def test_bert_pre_tokenizer_equal_on_every_code_point():
    """Whitespace splits (removed), punctuation pieces of their own, every
    other code point joins its word."""
    from modelx_tpu_torch.dl.tokenizer import _pre_tokenizer

    ref = pre_tokenizers.BertPreTokenizer()
    port = _pre_tokenizer({"type": "BertPreTokenizer"})
    for i in range(0, len(_EVERY_CP), 4096):
        chunk = "".join(f"a{c}" for c in _EVERY_CP[i:i + 4096])
        want = [t for t, _ in ref.pre_tokenize_str(chunk)]
        assert [t for t, _ in port([(chunk, True)])] == want, hex(ord(_EVERY_CP[i]))


def test_newer_code_points_are_cn_in_unicodedata():
    assert len(NEWER) == 5812 and len(NEWER_LN) == 5004
    assert all(unicodedata.category(chr(cp)) == "Cn" for cp in NEWER)


@pytest.mark.parametrize("cls", ["L", "N", "M", "P", "S", "Lu", "Ll", "Lm", "Lo", "Nd",
                                 "Mn", "Mc", "Pd", "Po", "Sm", "So", "Cn"])
def test_unicode_16_classes_equal_the_tokenizers_regex(cls):
    """Membership of every code point Unicode 16.0 assigned, in \\p{cls}
    and \\w: the port's translated class against the regex engine of
    ``tokenizers`` (Split with "removed" drops exactly the members)."""
    text = "".join(chr(cp) for cp in NEWER)
    for pattern in (rf"\p{{{cls}}}", r"\w") if cls == "L" else (rf"\p{{{cls}}}",):
        kept = "".join(p for p, _ in pre_tokenizers.Split(
            tokenizers.Regex(pattern), behavior="removed").pre_tokenize_str(text))
        want = sorted(set(text) - set(kept))
        if cls == "Cn":  # the port refuses \p{Cn}; it is empty here in both
            assert want == []
            continue
        rx = re.compile(translate_regex(pattern) if pattern != r"\w"
                        else "[" + _word_class() + "]")
        assert [c for c in text if rx.fullmatch(c)] == want, pattern


@pytest.mark.parametrize("name", ["llama3", "qwen2", "gpt2"])
def test_letters_and_digits_of_unicode_16_encode_equal(loaded, name):
    """All 5,004 letters and digits Unicode 16.0 assigned, each in a
    contraction, beside a digit and inside a word."""
    ref, port = loaded[name]
    for i in range(0, len(NEWER_LN), 500):
        text = "".join(f" {c}'s{c}1 x{c}," for c in map(chr, NEWER_LN[i:i + 500]))
        _assert_encode_equal(ref, port, text)


def test_unicode_16_letter_contraction_llama3_ids(loaded):
    ref, port = loaded["llama3"]
    text = " \u1c89's"
    assert ref.encode(text).ids == [700, 220, 157, 110, 231, 347]
    assert port.encode(text) == [700, 220, 157, 110, 231, 347]


@pytest.mark.parametrize("kind", ["NFC", "NFD", "NFKC", "NFKD"])
def test_unicode_16_code_points_normalize_as_tokenizers(kind):
    """The reader normalizes with unicodedata (Unicode 15.0); the
    normalizers of tokenizers leave every code point 16.0 assigned as
    unicodedata does, alone and after a base letter."""
    ref = getattr(normalizers, kind)()
    for cp in NEWER:
        for text in (chr(cp), "a" + chr(cp) + "\u0301"):
            assert unicodedata.normalize(kind, text) == ref.normalize_str(text), hex(cp)
