"""The ``Precompiled`` normalizer of a ``tokenizer.json`` (SentencePiece's
``precompiled_charsmap``, as T5, ALBERT, XLM-R and mT5 carry it) and the
extended grapheme clusters it cuts text into.

The charsmap is base64; decoded, it holds a little-endian u32 giving the
trie's size in bytes, a darts-clone double array of u32 units, and
NUL-terminated replacement strings. Normalizing cuts the text into
extended grapheme clusters (UAX #29, with the tables of
``unicode_tables``): a cluster under 6 UTF-8 bytes is looked up whole,
any other one character by character. A lookup is a common-prefix search
of the trie that takes the first result, the SHORTEST key that is a prefix
of the chunk, and replaces the WHOLE chunk with that key's value; a chunk
no key prefixes stays as it is. So with ``e`` mapped, ``e`` + U+0301 (one
cluster) becomes ``e``'s value and the accent is lost, and ``off`` stays
``off`` with ``ff`` mapped, since no cluster is ``ff``. This is what
``tokenizers`` 0.22.2 does (its ``spm_precompiled`` and
``unicode-segmentation`` crates).
"""

from __future__ import annotations

import base64
import binascii
import functools
import sys
from array import array

import numpy as np

from modelx_tpu_torch.dl import unicode_tables as ut

# -- extended grapheme clusters ------------------------------------------------

(_OTHER, _CR, _LF, _CONTROL, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING, _L, _V, _T, _LV,
 _LVT) = range(14)
assert ut.GCB_NAMES == ("Other", "CR", "LF", "Control", "Extend", "ZWJ",
                        "Regional_Indicator", "Prepend", "SpacingMark", "L", "V", "T", "LV", "LVT")
_INCB_LINKER, _INCB_CONSONANT, _INCB_EXTEND = 1, 2, 3
assert ut.INCB_NAMES == ("None", "Linker", "Consonant", "Extend")
_CONTROLS = (_CR, _LF, _CONTROL)


def _classes(*members: int) -> np.ndarray:
    """A break class -> bool lookup (indexing beats ``np.isin`` here)."""
    out = np.zeros(len(ut.GCB_NAMES), bool)
    out[list(members)] = True
    return out


_IS_CONTROL = _classes(*_CONTROLS)
_L_NEXT = _classes(_L, _V, _LV, _LVT)  # GB6
_LV_V, _V_T, _LVT_T = _classes(_LV, _V), _classes(_V, _T), _classes(_LVT, _T)  # GB7, GB8
_EXTENDING = _classes(_EXTEND, _ZWJ, _SPACING)  # GB9, GB9a


def _table(ranges, size: int = 0x110000) -> np.ndarray:
    out = np.zeros(size, np.uint8)
    for lo, hi, *value in ranges:
        out[lo:hi + 1] = value[0] if value else 1
    return out


@functools.cache
def _grapheme_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(grapheme break class, Extended_Pictographic, InCB) per code point."""
    return _table(ut.GCB), _table(ut.EXTENDED_PICTOGRAPHIC), _table(ut.INCB)


def _joins(g: np.ndarray, e: np.ndarray, k: np.ndarray) -> np.ndarray:
    """For each pair of neighbours in a text whose characters have break
    classes ``g``, pictographic flags ``e`` and InCB values ``k``: no
    boundary between them (UAX #29's rules GB3-GB13)."""
    prev, cur = g[:-1], g[1:]
    controls = _IS_CONTROL[prev] | _IS_CONTROL[cur]  # GB4, GB5
    join = ((prev == _L) & _L_NEXT[cur]  # GB6
            | _LV_V[prev] & _V_T[cur]  # GB7
            | _LVT_T[prev] & (cur == _T)  # GB8
            | _EXTENDING[cur] | (prev == _PREPEND))  # GB9, 9a, 9b
    join &= ~controls
    # the rules that read further back, at the few places they could join
    maybe = ~controls & ~join & (((prev == _ZWJ) & (e[1:] == 1))
                                 | ((prev == _RI) & (cur == _RI))
                                 | (k[1:] == _INCB_CONSONANT))
    for i in np.flatnonzero(maybe).tolist():  # between i and i + 1
        j = i
        if g[i] == _ZWJ and e[i + 1]:  # GB11: ExtPict Extend* ZWJ x ExtPict
            j = i - 1
            while j >= 0 and not e[j] and g[j] == _EXTEND:
                j -= 1
            if j >= 0 and e[j]:
                join[i] = True
                continue
        if g[i] == _RI and g[i + 1] == _RI:  # GB12, GB13: pairs
            j = i
            while j >= 0 and g[j] == _RI:
                j -= 1
            join[i] = (i - j) % 2 == 1
            continue
        if k[i + 1] == _INCB_CONSONANT:  # GB9c: Consonant [Extend Linker]* Linker ...
            j, linker = i, False
            while j >= 0 and k[j] in (_INCB_EXTEND, _INCB_LINKER):
                linker = linker or k[j] == _INCB_LINKER
                j -= 1
            join[i] = bool(j >= 0 and k[j] == _INCB_CONSONANT and linker)
    if np.any((prev == _CR) & (cur == _LF)):
        join |= (prev == _CR) & (cur == _LF)  # GB3
    return join


def grapheme_clusters(text: str, tables=None) -> list[str]:
    """``text`` cut into extended grapheme clusters; ``tables`` (grapheme
    break class, Extended_Pictographic, InCB per code point, as uint8
    arrays) default to ``unicode_tables``'."""
    if text.isascii():  # every boundary but the one inside CR LF
        if "\r\n" not in text:
            return list(text)
        out, i, n = [], 0, len(text)
        while i < n:
            j = i + 2 if text.startswith("\r\n", i) else i + 1
            out.append(text[i:j])
            i = j
        return out
    gcb, ep, incb = tables if tables is not None else _grapheme_tables()
    cps = np.frombuffer(text.encode("utf-32-le", "surrogatepass"), np.uint32)
    cuts = (np.flatnonzero(~_joins(gcb[cps], ep[cps], incb[cps])) + 1).tolist()
    return [text[a:b] for a, b in zip([0, *cuts], [*cuts, len(text)])]


# -- the charsmap ----------------------------------------------------------------


class Precompiled:
    """A ``Precompiled`` normalizer over its base64 charsmap."""

    def __init__(self, charsmap: str) -> None:
        if not isinstance(charsmap, str):
            raise ValueError("Precompiled: precompiled_charsmap is not a string")
        try:
            data = base64.b64decode(charsmap, validate=True)
        except (binascii.Error, ValueError) as e:
            raise ValueError(f"Precompiled: precompiled_charsmap is not base64 ({e})") from None
        if len(data) < 4:
            raise ValueError("Precompiled: Cannot parse precompiled_charsmap")
        size = int.from_bytes(data[:4], "little")
        n = size // 4
        if 4 + 4 * n > len(data):
            raise ValueError("Precompiled: Cannot parse precompiled_charsmap")
        self.units = array("I")
        self.units.frombytes(data[4:4 + 4 * n])
        if sys.byteorder != "little":
            self.units.byteswap()
        self.blob = data[4 + 4 * n:]
        try:
            self.blob.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"Precompiled: the replacements are not UTF-8 ({e})") from None
        self._memo: dict[str, str | None] = {}

    def _value(self, at: int) -> str:
        end = self.blob.find(b"\0", at)
        return self.blob[at:end if end >= 0 else len(self.blob)].decode("utf-8")

    def transform(self, chunk: str) -> str | None:
        """The replacement of ``chunk``: the value of the shortest key that
        prefixes it (darts-clone's common-prefix search), or None."""
        got = self._memo.get(chunk, self)
        if got is not self:
            return got
        units, result = self.units, None
        try:
            pos = units[0] >> 10 << ((units[0] & (1 << 9)) >> 6)
            for c in chunk.encode("utf-8"):
                if c == 0:
                    break
                pos ^= c
                unit = units[pos]
                if unit & ((1 << 31) | 0xFF) != c:
                    break
                pos ^= unit >> 10 << ((unit & (1 << 9)) >> 6)
                if unit & (1 << 8):
                    result = self._value(units[pos] & 0x7FFFFFFF)
                    break
        except IndexError:
            raise ValueError("Precompiled: a lookup left the charsmap's trie (an array "
                             "that is not padded)") from None
        if len(self._memo) < 100_000:
            self._memo[chunk] = result
        return result

    def prefix(self, text: str, k: int) -> int:
        """How many leading characters of ``self(text)`` align to the
        input's offset 0 when the first ``k`` of ``text`` do, as the
        alignments ``tokenizers`` gives its output: each output character
        consumes one input character or is inserted after the last one
        consumed (offset 0 itself before any), and a chunk replaced by
        nothing adds its characters to the previous output character's
        change, or, at the very start, to none, so that the next output
        character takes the first input character's alignment. Only the
        clusters that can reach the first ``k`` are walked."""
        changes: list[int] = []  # per output character, as tokenizers records it

        def replace(old: str, new: str) -> None:
            changes.extend([0] * len(new))
            diff = len(new) - len(old)
            if diff > 0:
                changes[len(changes) - diff:] = [1] * diff
            elif diff < 0 and changes:
                changes[-1] += diff

        seen = 0
        # the clusters of a bounded head: one cut at its end is 6 bytes or
        # longer either way, so looked up one character at a time as whole
        for g in grapheme_clusters(text[:k + 64]):
            if seen > k + 8:
                break
            seen += len(g)
            norm = self.transform(g) if len(g) == 1 or len(g.encode("utf-8")) < 6 else None
            if norm is not None:
                replace(g, norm)
                continue
            for ch in g:
                norm = self.transform(ch)
                if norm is None:
                    changes.append(0)
                else:
                    replace(ch, norm)
        out, consumed = 0, 0
        for change in changes:
            if change > 0:
                aligned = consumed == 0 or consumed - 1 < k
            else:
                aligned, consumed = consumed < k, consumed + 1 - change
            if not aligned:
                break
            out += 1
        return out

    def __call__(self, text: str) -> str:
        out: list[str] = []
        for g in grapheme_clusters(text):
            if len(g) == 1 or len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
                if len(g) == 1:
                    out.append(g)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


def nmt(text: str) -> str:
    """The ``Nmt`` normalizer: these controls dropped, these spaces,
    separators and marks mapped to a space (every code point probed
    against ``tokenizers`` 0.22.2)."""
    return text.translate(_NMT)


_NMT = {**{c: None for c in (*range(0x1, 0x9), 0xB, *range(0xE, 0x20), 0x7F, 0x8F, 0x9F)},
        **{c: " " for c in (0x9, 0xA, 0xC, 0xD, 0x1680, *range(0x200B, 0x2010), 0x2028,
                            0x2029, 0x2581, 0xFEFF, 0xFFFD)}}
