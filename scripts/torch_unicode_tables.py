"""Writes ``modelx_tpu_torch/dl/unicode_tables.py``: the Unicode tables the
port's tokenizer.json reader needs and Python 3.12's ``unicodedata`` lacks
(scripts, grapheme cluster breaks), and the classes ``tokenizers`` reads
from tables of its own (Rust's ``char::is_numeric``, the combining marks
``StripAccents`` drops, Oniguruma's ``\\w``).

    python scripts/torch_unicode_tables.py [--out PATH]

Each table is built from the ``regex`` package's properties (``\\p{Script=..}``,
``\\p{GCB=..}``, ``\\p{Extended_Pictographic}``, ``\\p{InCB=..}``, ``\\p{N}``,
``\\p{M}``, ``\\w``; fontTools gives the script names and codes to ask for),
then held against ``tokenizers`` over every code point, and where the two
disagree (the crates inside ``tokenizers`` follow other Unicode versions
than ``regex``) ``tokenizers`` wins:

- the ``UnicodeScripts`` pre-tokenizer, each code point between two
  ``a``, two Greek letters and two letters of its own script: a code
  point that joins both ``a`` and the Greek is "Any" to it;
- ``\\p{<script>}`` in a ``Split`` regex: one ``Split`` per bit of the
  script's index, over every code point;
- grapheme clusters through ``Precompiled`` with the identity charsmap
  of every code point (a cluster under 6 bytes keeps only its first
  character): each code point after ``a``, before each break class, and
  around a ZWJ with U+00A9; a code point the probes disagree on takes
  the break class and pictographic flag that makes them agree;
- ``Digits`` (numeric), ``StripAccents`` (marks) and ``Split(\\w)``, each
  code point between two ``a``.

Needs ``regex``, ``tokenizers`` 0.22.2 and fontTools. It prints how many
code points each table takes from ``tokenizers`` against ``regex`` and
fails if a probe still disagrees.
"""

from __future__ import annotations

import argparse
import operator
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "modelx_tpu_torch", "dl", "unicode_tables.py")

CPS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
GCB_NAMES = ("Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator", "Prepend",
             "SpacingMark", "L", "V", "T", "LV", "LVT")
INCB_NAMES = ("None", "Linker", "Consonant", "Extend")
# break-class representatives a probed code point is put before: (text,
# class); each under 6 bytes beside a 1- or 2-byte code point
BREAK_REPS = ("a", "\r", "\n", "̀", "‍", "ः", "ᅡ", "ᆨ", "ᄀ",
              "가", "각", "©", "؀", "\x01")


def ranges(cps) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for c in sorted(cps):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [(a, b) for a, b in out]


def valued_ranges(values: dict[int, int]) -> list[tuple[int, int, int]]:
    out: list[list[int]] = []
    for c in sorted(values):
        v = values[c]
        if out and out[-1][1] == c - 1 and out[-1][2] == v:
            out[-1][1] = c
        else:
            out.append([c, c, v])
    return [tuple(r) for r in out]


def regex_members(pattern: str, text: str) -> set[int]:
    import regex

    return {ord(ch) for m in regex.finditer(pattern + "+", text) for ch in m.group()}


def split_members(pattern: str, text: str) -> set[int]:
    """The code points of ``text`` that ``tokenizers``' regex engine
    matches with ``pattern`` (a ``Split`` with "removed" drops them)."""
    import tokenizers
    from tokenizers import pre_tokenizers

    split = pre_tokenizers.Split(tokenizers.Regex(pattern), behavior="removed")
    kept = {ord(ch) for piece, _ in split.pre_tokenize_str(text) for ch in piece}
    return {ord(ch) for ch in text} - kept


def between_a(pre_tokenizer, cps) -> set[int]:
    """The code points a pre-tokenizer cuts out of ``a<c>a`` as a piece
    of their own."""
    text = "".join(f"a{chr(c)}a" for c in cps)
    return {ord(p) for p, _ in pre_tokenizer.pre_tokenize_str(text) if len(p) == 1 and p != "a"}


# -- scripts ---------------------------------------------------------------------------


def scripts(all_text: str, log) -> dict:
    import tokenizers
    from fontTools.unicodedata import Scripts
    from tokenizers import pre_tokenizers

    names = sorted({n for n in Scripts.NAMES.values() if n != "Unknown"})
    script = {}
    for i, name in enumerate(names, 1):
        for c in regex_members(rf"\p{{Script={name}}}", all_text):
            script[c] = i
    # the UnicodeScripts pre-tokenizer: Hiragana, Katakana and U+30FC are
    # Han to it, a space is Any; probe each code point
    han = names.index("Han") + 1
    kana = {names.index("Hiragana") + 1, names.index("Katakana") + 1}

    def fixed(c):
        s = script.get(c, 0)
        return han if s in kana or c == 0x30FC else s

    ut = pre_tokenizers.UnicodeScripts()
    probe = [c for c in CPS if c != 0x20]

    # pieces start on a triple's first character: each joined triple is
    # one piece of 3, or part of a longer run of the same script
    def joined_triples(rep_of) -> set[int]:
        text = "".join(f"{rep_of(c)}{chr(c)}{rep_of(c)}" for c in probe)
        cuts = {start for _, (start, _end) in ut.pre_tokenize_str(text)}
        return {c for i, c in enumerate(probe)
                if 3 * i + 1 not in cuts and 3 * i + 2 not in cuts}

    with_a = joined_triples(lambda c: "a")
    with_greek = joined_triples(lambda c: "α")
    reps = {}
    for c in probe:
        s = fixed(c)
        if s and s not in reps and not (c in with_a and c in with_greek):
            reps[s] = chr(c)
    reps[0] = "a"
    with_own = joined_triples(lambda c: reps.get(fixed(c), "a"))
    pre, moved = {}, {}
    for c in probe:
        if c in with_a and c in with_greek:
            continue  # Any
        pre[c] = script.get(c, 0)
        if c not in with_own:
            moved[c] = None
    # a code point of another script in tokenizers' older table: the
    # script whose letters it joins
    for c in moved:
        for s, rep in reps.items():
            if s and ut.pre_tokenize_str(f"{rep}{chr(c)}{rep}")[0][0] == f"{rep}{chr(c)}{rep}":
                pre[c] = moved[c] = s
                break
        else:
            raise SystemExit(f"UnicodeScripts: U+{c:04X} joins no script's letters")
    # Hiragana and Katakana are one script to it, so either name does
    for c, s in moved.items():
        if s == han and script.get(c) in kana:
            pre[c] = script[c]
    any_newer = sum(1 for c in script if c != 0x20 and c not in pre)
    log(f"scripts: {len(names)} names; UnicodeScripts takes {any_newer} code points that "
        f"regex assigns as Any and {sum(pre[c] != script.get(c, 0) for c in moved)} as "
        f"another script")
    # \p{<script>} in tokenizers' regexes (Oniguruma's table): the index,
    # bit by bit
    known = []
    for name in names:
        try:
            tokenizers.Regex(rf"\p{{{name}}}")
            known.append(name)
        except Exception:
            pass
    onig: dict[int, int] = {}
    for bit in range(max(len(names), 1).bit_length()):
        cls = "".join(rf"\p{{{n}}}" for n in known if (names.index(n) + 1) >> bit & 1)
        if cls:
            for c in split_members(f"[{cls}]", all_text):
                onig[c] = onig.get(c, 0) | 1 << bit
    moved = sum(1 for c in CPS if onig.get(c, 0) != script.get(c, 0))
    log(f"scripts: Oniguruma knows {len(known)} of them; its \\p{{..}} differs from regex's "
        f"on {moved} code points")
    codes = {code: name for code, name in Scripts.NAMES.items() if name in known}
    return {"names": names, "pre": pre, "onig": onig, "codes": codes}


# -- grapheme clusters -----------------------------------------------------------------


def grapheme_probes(cps: list[int]) -> tuple[list[str], list[int]]:
    """The probe texts of each code point and, beside each, its code point:
    after ``a``, U+0600 (a prepended mark) and U+00A9 + ZWJ; before each of
    ``BREAK_REPS`` where the pair is under 6 bytes; before ZWJ + U+00A9
    when it is one byte."""
    texts: list[str] = []
    owners: list[int] = []
    by_len: dict[int, list[int]] = {}
    for c in cps:
        by_len.setdefault(len(chr(c).encode()), []).append(c)
    for prefix in ("a", "؀", "©‍"):
        texts += [prefix + chr(c) for c in cps]
        owners += cps
    for n, group in sorted(by_len.items()):
        for y in BREAK_REPS:
            if n + len(y.encode()) < 6:
                texts += [chr(c) + y for c in group]
                owners += group
        if n == 1:
            texts += [chr(c) + "‍©" for c in group]
            owners += group
    return texts, owners


def first_chars(clusters) -> str:
    return "".join(g if len(g) == 1 else g[0] if len(g.encode()) < 6 else g for g in clusters)


def graphemes(all_text: str, log) -> dict:
    from tokenizers import normalizers

    sys.path.insert(0, REPO)
    from modelx_tpu_torch.dl import precompiled
    from modelx_tpu_torch.testing.charsmap import charsmap_bytes

    gcb = {}
    for i, name in enumerate(GCB_NAMES[1:], 1):
        for c in regex_members(rf"\p{{GCB={name}}}", all_text):
            gcb[c] = i
    ep = {c: 1 for c in regex_members(r"\p{Extended_Pictographic}", all_text)}
    incb = {}
    for i, name in enumerate(INCB_NAMES[1:], 1):
        for c in regex_members(rf"\p{{InCB={name}}}", all_text):
            incb[c] = i
    tables = [np.zeros(0x110000, np.uint8) for _ in range(3)]
    for t, values in zip(tables, (gcb, ep, incb)):
        for c, v in values.items():
            t[c] = v
    identity = normalizers.Precompiled(charsmap_bytes({chr(c): chr(c) for c in CPS if c}))
    # U+0002 (a control: a break each side) parts the probes
    texts, owners = grapheme_probes([c for c in CPS if c not in (0x0, 0x2)])
    want = identity.normalize_str("\x02".join(texts)).split("\x02")
    assert len(want) == len(texts)

    def ours(text: str) -> str:
        return first_chars(precompiled.grapheme_clusters(text, tables))

    got = ours("\x02".join(texts)).split("\x02")
    bad = np.flatnonzero(np.fromiter(map(operator.ne, want, got), bool, len(want))).tolist()
    wrong = sorted({owners[i] for i in bad})
    mine: dict[int, list] = {c: [] for c in wrong}
    for i, c in enumerate(owners):
        if c in mine:
            mine[c].append((texts[i], want[i]))
    fixed = 0
    for c in wrong:
        g0, e0 = tables[0][c], tables[1][c]
        # regex's class with the other flag first, then every class
        for g, e in [(g0, 1 - e0)] + [(g, e) for e in (e0, 1 - e0)
                                       for g in range(len(GCB_NAMES))]:
            tables[0][c], tables[1][c] = g, e
            if all(ours(t) == w for t, w in mine[c]):
                break
        else:
            raise SystemExit(f"graphemes: no break class makes U+{c:04X} agree with "
                             f"tokenizers: {mine[c][:3]}")
        fixed += 1
    log(f"graphemes: {len(texts)} probes; {fixed} code points take their break class or "
        f"pictographic flag from tokenizers")
    return {"gcb": {c: int(tables[0][c]) for c in np.flatnonzero(tables[0]).tolist()},
            "ep": set(np.flatnonzero(tables[1]).tolist()),
            "incb": {c: int(tables[2][c]) for c in np.flatnonzero(tables[2]).tolist()}}


# -- the character classes -----------------------------------------------------------------


def classes(all_text: str, log) -> dict:
    from tokenizers import normalizers, pre_tokenizers

    out = {}
    numeric = between_a(pre_tokenizers.Digits(individual_digits=True), CPS)
    base = regex_members(r"\p{N}", all_text)
    log(f"numeric: {len(numeric)} code points, {len(numeric ^ base)} differ from regex's \\p{{N}}")
    out["numeric"] = numeric
    kept = {ord(ch) for ch in normalizers.StripAccents().normalize_str(all_text)}
    marks = set(CPS) - kept
    base = regex_members(r"\p{M}", all_text)
    log(f"marks: StripAccents drops {len(marks)} code points, {len(marks ^ base)} differ from "
        f"regex's \\p{{M}}")
    out["marks"] = marks
    word = split_members(r"\w", all_text)
    base = regex_members(r"\w", all_text)
    log(f"word: Oniguruma's \\w takes {len(word)} code points, {len(word ^ base)} differ from "
        f"regex's \\w")
    out["word"] = word
    return out


# -- the module ------------------------------------------------------------------------------

HEADER = '''"""Unicode tables of the port's tokenizer.json reader (``dl/tokenizer.py``,
``dl/precompiled.py``) that Python 3.12's ``unicodedata`` lacks, as
``tokenizers`` 0.22.2 reads them. Written by
``scripts/torch_unicode_tables.py`` from the ``regex`` package's
properties, each held against ``tokenizers`` over every code point
(``tokenizers`` wins where the Unicode versions differ); do not edit.

- ``SCRIPT_NAMES``: index -> script (0 is Unknown); ``SCRIPT_CODES``: the
  four-letter codes Oniguruma takes as names.
- ``PRE_TOKENIZER_SCRIPTS``: the script of each code point as the
  ``UnicodeScripts`` pre-tokenizer reads it; a code point outside is Any.
- ``REGEX_SCRIPTS``: the script of each code point as ``\\\\p{<script>}``
  reads it in a ``Split`` or ``Replace`` regex; outside is Unknown.
- ``GCB``, ``EXTENDED_PICTOGRAPHIC``, ``INCB``: the grapheme cluster break
  properties (``GCB_NAMES``, ``INCB_NAMES``; outside is Other / None).
- ``NUMERIC``: Rust's ``char::is_numeric`` (``Digits``).
- ``COMBINING_MARKS``: what ``StripAccents`` drops.
- ``ONIG_WORD``: Oniguruma's ``\\\\w``.

Ranges are (first, last) code points, inclusive, with a value where the
table has one.
"""

# ruff: noqa: E501
'''


def _fmt(name: str, rows, per_line: int) -> str:
    lines = [f"{name} = ("]
    for i in range(0, len(rows), per_line):
        lines.append("    " + " ".join(
            "(" + ", ".join(hex(v) if j < 2 else str(v) for j, v in enumerate(r)) + ")," for r in
            rows[i:i + per_line]))
    lines.append(")")
    return "\n".join(lines)


def render(sc: dict, gr: dict, cl: dict) -> str:
    parts = [HEADER]
    parts.append("SCRIPT_NAMES = (\n" + "\n".join(
        f"    {n!r}," for n in ["Unknown", *sc["names"]]) + "\n)")
    parts.append("SCRIPT_CODES = {\n" + "\n".join(
        f"    {k!r}: {v!r}," for k, v in sorted(sc["codes"].items())) + "\n}")
    parts.append(_fmt("PRE_TOKENIZER_SCRIPTS", valued_ranges(sc["pre"]), 5))
    parts.append(_fmt("REGEX_SCRIPTS", valued_ranges(
        {c: v for c, v in sc["onig"].items() if v}), 5))
    parts.append(f"GCB_NAMES = {GCB_NAMES!r}")
    parts.append(f"INCB_NAMES = {INCB_NAMES!r}")
    parts.append(_fmt("GCB", valued_ranges(gr["gcb"]), 5))
    parts.append(_fmt("EXTENDED_PICTOGRAPHIC", ranges(gr["ep"]), 6))
    parts.append(_fmt("INCB", valued_ranges(gr["incb"]), 5))
    parts.append(_fmt("NUMERIC", ranges(cl["numeric"]), 6))
    parts.append(_fmt("COMBINING_MARKS", ranges(cl["marks"]), 6))
    parts.append(_fmt("ONIG_WORD", ranges(cl["word"]), 6))
    return "\n\n".join(parts) + "\n"


def build(log=print) -> str:
    """The module's text."""
    all_text = "".join(map(chr, CPS))
    return render(scripts(all_text, log), graphemes(all_text, log), classes(all_text, log))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT, help="where to write the module")
    args = ap.parse_args(argv)
    text = build()
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"wrote {args.out} ({len(text)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
