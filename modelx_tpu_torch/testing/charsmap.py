"""A writer of SentencePiece ``precompiled_charsmap`` blobs, the form the
``Precompiled`` normalizer of a ``tokenizer.json`` carries (base64).

The blob is a little-endian u32 giving the trie's size in bytes, a
darts-clone double array of u32 units over the UTF-8 keys, then the
NUL-terminated replacement strings; a key's leaf holds the byte offset of
its replacement. Unit layout (darts-clone): bits 0-7 the label, bit 8 "has
a leaf", bit 9 the offset's extension flag, bits 10-31 the offset; a leaf
unit has bit 31 set and the value in bits 0-30.

A child of the node at ``pos`` with label ``c`` sits at ``pos ^ offset ^
c``; a node's leaf is its child with label 0. Bases are unique and every
child slot is free when a base is taken, so no lookup reads another
node's child. The array is padded to a multiple of 256 units and one more
block, so that every lookup ``base ^ c`` stays inside it (``tokenizers``
indexes it unchecked and panics past its end).

Used by the tests and by ``chip_smoke.py`` to write the charsmaps they
hold the port's ``Precompiled`` reader to.
"""

from __future__ import annotations

import base64
import struct
import sys
from array import array

_LEAF = 1 << 31
_HAS_LEAF = 1 << 8


def _offset_bits(offset: int) -> int | None:
    """The offset field of a unit, or None if ``offset`` cannot be held."""
    if offset < 1 << 21:
        return offset << 10
    if offset < 1 << 29 and not offset & 0xFF:
        return (offset << 2) | (1 << 9)
    return None


class _Builder:
    def __init__(self, keys: list[tuple[bytes, int]]) -> None:
        self.keys = keys
        self.units = array("I", bytes(4 * 1024))
        self.used = bytearray(1024)
        self.bases: set[int] = set()
        self.free = 1  # the first slot that may be free
        self.top = 1  # the first 256-unit block no node has a child in
        self.used[0] = 1  # the root

    def _grow(self, n: int) -> None:
        if n > len(self.used):
            extra = max(n, 2 * len(self.used)) - len(self.used)
            self.used.extend(bytes(extra))
            self.units.extend(bytes(4 * extra))

    def _find_base(self, pos: int, labels: list[int]) -> int:
        if len(labels) > 1:
            # a fresh block, at the node's low byte so the offset's is 0
            while True:
                base = (self.top << 8) | (pos & 0xFF)
                self.top += 1
                self._grow((base | 0xFF) + 1)
                if base not in self.bases and all(not self.used[base ^ c] for c in labels):
                    return base
        c = labels[0]
        # first a free slot in the node's own block (a small offset), then
        # the first free slot that can be held, then a fresh block
        home = pos & ~0xFF
        for p in range(home, home + 256):
            if not self.used[p] and p ^ c not in self.bases:
                return p ^ c
        while self.free < len(self.used) and (self.used[self.free]
                                              or self.free in self.bases):
            self.free += 1
        for p in range(self.free, self.free + 1024):
            self._grow(p + 1)
            if (not self.used[p] and p ^ c not in self.bases
                    and _offset_bits(pos ^ p ^ c) is not None):
                self.top = max(self.top, (p >> 8) + 1)
                return p ^ c
        p = (self.top << 8) | ((pos ^ c) & 0xFF)  # the offset's low byte 0
        self.top += 1
        self._grow((p | 0xFF) + 1)
        return p ^ c

    def build(self) -> array:
        stack = [(0, 0, len(self.keys), 0)]  # (node pos, lo, hi, depth)
        while stack:
            pos, lo, hi, depth = stack.pop()
            groups: list[tuple[int, int, int]] = []  # (label, lo, hi)
            i = lo
            while i < hi:
                key = self.keys[i][0]
                label = key[depth] if len(key) > depth else 0
                j = i + 1
                while j < hi and (len(self.keys[j][0]) > depth and self.keys[j][0][depth] == label
                                  if label else False):
                    j += 1
                groups.append((label, i, j))
                i = j
            base = self._find_base(pos, [g[0] for g in groups])
            self.bases.add(base)
            self.units[pos] |= _offset_bits(pos ^ base)
            for label, a, b in groups:
                child = base ^ label
                self.used[child] = 1
                if label == 0:
                    self.units[pos] |= _HAS_LEAF
                    self.units[child] = _LEAF | self.keys[a][1]
                else:
                    self.units[child] = label
                    stack.append((child, a, b, depth + 1))
        n = len(self.used.rstrip(b"\0"))
        n = (n + 255) // 256 * 256 + 256
        self._grow(n)
        return self.units[:n]


def double_array(keys: dict[bytes, int]) -> array:
    """The darts-clone double array of ``keys`` (UTF-8 bytes, neither empty
    nor holding a NUL) -> leaf values below 2**31."""
    for key, value in keys.items():
        if not key or b"\0" in key or not 0 <= value < _LEAF:
            raise ValueError(f"charsmap key {key!r} -> {value}: keys are non-empty and hold "
                             f"no NUL, values are below 2**31")
    return _Builder(sorted(keys.items())).build()


def charsmap_bytes(mapping: dict[str, str]) -> bytes:
    """The precompiled charsmap of ``mapping`` (source string ->
    replacement) as raw bytes; equal replacements share one entry."""
    blob, at = bytearray(), {}
    keys = {}
    for src, dst in sorted(mapping.items()):
        if "\0" in dst:
            raise ValueError(f"charsmap replacement {dst!r} holds a NUL")
        if dst not in at:
            at[dst] = len(blob)
            blob += dst.encode("utf-8") + b"\0"
        keys[src.encode("utf-8")] = at[dst]
    units = double_array(keys)
    if sys.byteorder != "little":
        units.byteswap()
    trie = units.tobytes()
    return struct.pack("<I", len(trie)) + trie + bytes(blob)


def write_charsmap(mapping: dict[str, str]) -> str:
    """``mapping`` as the base64 ``precompiled_charsmap`` of a
    ``Precompiled`` normalizer."""
    return base64.b64encode(charsmap_bytes(mapping)).decode("ascii")
