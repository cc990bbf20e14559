"""The ``Unigram`` model of a ``tokenizer.json`` (T5, ALBERT, XLM-R, mT5):
SentencePiece's unigram language model, as ``tokenizers`` 0.22.2 encodes
with it (``encode_optimized``, a Viterbi pass over the text).

For each position, in order, every piece that starts there is a
candidate, shortest first; its score plus the best score up to the
position (both Python floats, f64, added in that order) replaces the best
path ending after it only when STRICTLY greater, so on a tie the first
candidate found stays. A character no single-character piece covers is
an unknown costing ``min_score - 10.0``. Walking the best path back,
unknowns in a row are fused into one piece; a piece that is not in the
vocab becomes, with ``byte_fallback``, its ``<0xXX>`` byte pieces when all
of them are, else the unk id.
"""

from __future__ import annotations

import bisect

UNK_PENALTY = 10.0


class Unigram:
    def __init__(self, spec: dict) -> None:
        vocab = spec.get("vocab")
        if not isinstance(vocab, list):
            raise ValueError("Unigram: vocab must be a list of [piece, score]")
        self.unk_id = spec.get("unk_id")
        if self.unk_id is not None:
            if not vocab:
                raise ValueError("Unable to load vocab EmptyVocabulary")
            if not 0 <= int(self.unk_id) < len(vocab):
                raise ValueError("Unable to load vocab UnkIdNotInVocabulary")
            self.unk_id = int(self.unk_id)
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.pieces: list[str] = [str(p) for p, _ in vocab]
        self.scores: list[float] = [float(s) for _, s in vocab]
        # a piece listed twice takes its last id, as tokenizers' map does
        self.vocab: dict[str, int] = {p: i for i, p in enumerate(self.pieces)}
        self.id_to_token_map = dict(enumerate(self.pieces))
        self.min_score = min(self.scores, default=float("inf"))
        self._sorted = sorted(self.vocab)
        self._max_len = max(map(len, self.pieces), default=0)
        self._cache: dict[str, list[int]] = {}

    def _has_prefix(self, s: str) -> bool:
        i = bisect.bisect_left(self._sorted, s)
        return i < len(self._sorted) and self._sorted[i].startswith(s)

    def _unk(self) -> int:
        if self.unk_id is None:
            raise ValueError("Encountered an unknown token but `unk_id` is missing")
        return self.unk_id

    def encode(self, text: str) -> list[str]:
        """The best segmentation of ``text`` as strings, unknowns fused."""
        n = len(text)
        vocab, scores = self.vocab, self.scores
        best = [0.0] * (n + 1)
        starts = [-1] * (n + 1)
        ids = [0] * (n + 1)
        unk_score = self.min_score - UNK_PENALTY
        for i in range(n):
            here = best[i]
            single = False
            for j in range(i + 1, min(n, i + self._max_len) + 1):
                piece = text[i:j]
                tid = vocab.get(piece)
                if tid is not None:
                    cand = scores[tid] + here
                    if starts[j] < 0 or cand > best[j]:
                        best[j], starts[j], ids[j] = cand, i, tid
                    single = single or j == i + 1
                elif not self._has_prefix(piece):
                    break
            if not single:
                cand = unk_score + here
                if starts[i + 1] < 0 or cand > best[i + 1]:
                    best[i + 1], starts[i + 1], ids[i + 1] = cand, i, self._unk()
        out: list[str] = []
        fused: list[str] = []
        j = n
        while j > 0:
            i = starts[j]
            if self.unk_id is not None and ids[j] == self.unk_id:
                fused.append(text[i:j])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(text[i:j])
            j = i
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def tokenize(self, word: str) -> list[int]:
        got = self._cache.get(word)
        if got is not None:
            return list(got)
        out: list[int] = []
        for piece in self.encode(word):
            tid = self.vocab.get(piece)
            if tid is None:
                if self.byte_fallback:
                    byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in piece.encode("utf-8")]
                    if None not in byte_ids:
                        out.extend(byte_ids)
                        continue
                tid = self._unk()
            out.append(tid)
        if len(self._cache) < 10_000:
            self._cache[word] = out
        return list(out)
