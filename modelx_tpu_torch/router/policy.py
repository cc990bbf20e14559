"""Routing policy: prefix-sticky first, then least queue depth
(counterpart of ``modelx_tpu/router/policy.py``; the same keys and plan
order for equal inputs).

Why sticky: a pod's ``PrefixKVCache`` (models/decode.py) keeps the
prefill KV of recent prompts on device, so a multi-turn chat that
re-sends its history prefills only the new suffix — but ONLY on the pod
that stored the prefix. A stateless round-robin above the fleet destroys
that locality (ServerlessLLM's core observation: route to where the live
state already resides). The router therefore fingerprints each request's
conversation prefix the same way the pod layer does — cheap
content-addressed hashes of the normalized prompt head
(``continuous._fingerprint`` is crc32 over the token bytes; this module
does the same over normalized prefix windows).

Why a LADDER of keys, not one hash: turn N+1 of a conversation is turn
N's prompt plus new text, so any single fixed-window hash either never
repeats (whole-prompt) or breaks for prompts shorter than the window.
PrefixKVCache solves this on device with longest-STORED-prefix lookup;
the router mirrors it at bucketed granularity: each request derives keys
for power-of-two prefix windows (4, 8, ... ``window_tokens`` tokens; x4
chars for text), lookup takes the LONGEST bucket that has an assignment,
and a successful route assigns every bucket. Turn 2 (longer prompt) then
hits turn 1's bucket keys because their shared head hashes identically —
the longest-prefix property, O(log window) per request.

Sticky NEVER overrides health: a sticky pod that is no longer a READY
candidate is a miss, and the assignment is rewritten to the least-loaded
candidate (losing a warm cache beats routing into a draining/dead pod).
"""

from __future__ import annotations

import json
import threading
import zlib
from collections import OrderedDict

# largest prefix window fingerprinted: ~the system prompt + opening user
# turn, the conversation's stable identity. Chars are sized at ~4
# chars/token so the text and token forms cover a comparable head.
DEFAULT_WINDOW_TOKENS = 64
MIN_WINDOW_TOKENS = 4
CHARS_PER_TOKEN = 4
# bounded-load rendezvous: the HRW anchor holds only while its effective
# load is within this many requests of the least-loaded candidate —
# replica agreement is worth a small queueing premium, not a hotspot
HRW_LOAD_SLACK = 4


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _buckets(window_tokens: int) -> list[int]:
    """Power-of-two prefix windows, longest first: the largest pow2 <=
    ``window_tokens`` (floored at MIN_WINDOW_TOKENS) down to the floor."""
    out = []
    b = 1 << (max(window_tokens, MIN_WINDOW_TOKENS).bit_length() - 1)
    while b >= MIN_WINDOW_TOKENS:
        out.append(b)
        b //= 2
    return out


def sticky_keys(model: str, req: dict, path: str,
                window_tokens: int = DEFAULT_WINDOW_TOKENS) -> list[tuple]:
    """The request's conversation-prefix fingerprints, LONGEST window
    first; empty when the body carries no prompt (those route by load
    alone).

    Normalization mirrors what the pod layer keys on:

    - token requests fingerprint prefixes of row 0's ids (PrefixKVCache
      keys on exact token tuples: same ids -> same key);
    - text/prompt requests strip leading whitespace and fingerprint char
      prefixes (window x CHARS_PER_TOKEN);
    - chat requests serialize messages compactly (role + content with
      control-char separators, so JSON framing whitespace can't split a
      conversation across pods) and fingerprint char prefixes.

    The model name is part of every key: the same opening prompt against
    two models is two conversations with two (per-model) prefix caches.
    Only windows <= the prompt's own length emit a key — a fingerprint of
    padded/absent material would collide unrelated short prompts.
    """
    ids = req.get("tokens")
    if isinstance(ids, list) and ids and isinstance(ids[0], list):
        head = [t for t in ids[0][:window_tokens]
                if isinstance(t, int) and not isinstance(t, bool)]
        if head:
            return [
                (model, "tok", b, _crc(json.dumps(head[:b]).encode()))
                for b in _buckets(window_tokens) if b <= len(head)
            ] or [(model, "tok", len(head), _crc(json.dumps(head).encode()))]
    text = None
    kind = "text"
    messages = req.get("messages")
    if isinstance(messages, list) and messages:
        parts = []
        for m in messages:
            if isinstance(m, dict):
                parts.append(f"{m.get('role', '')}\x00{m.get('content', '')}")
        text = "\x1e".join(parts).lstrip()
        kind = "chat"
    else:
        for field in ("text", "prompt"):
            val = req.get(field)
            if isinstance(val, list):  # OpenAI batch form: row 0 decides
                val = val[0] if val and isinstance(val[0], str) else None
            if isinstance(val, str) and val.strip():
                text = val.lstrip()
                break
    if not text:
        return []
    head = text[: window_tokens * CHARS_PER_TOKEN]
    keys = [
        (model, kind, b, _crc(head[: b * CHARS_PER_TOKEN].encode("utf-8", "replace")))
        for b in _buckets(window_tokens)
        if b * CHARS_PER_TOKEN <= len(head)
    ]
    if not keys:  # prompt shorter than the smallest window: exact-head key
        keys = [(model, kind, len(head), _crc(head.encode("utf-8", "replace")))]
    return keys


class StickyTable:
    """LRU map: sticky key -> pod URL, with hit/miss accounting.

    ``lookup`` walks a request's key ladder longest-first and validates
    the assignment against the CURRENT candidate set, so an entry
    pointing at a demoted/draining pod reads as a miss (and ``assign``
    then rewrites the ladder). Bounded: the table is an optimization —
    evicting an old conversation costs one suffix re-prefill on a new
    pod, never correctness."""

    def __init__(self, max_entries: int = 4096) -> None:
        self.max_entries = max(1, int(max_entries))
        self._od: OrderedDict[tuple, str] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # forgets whose model had registry-published prefix KV at the
        # time: the next pod installs the shared prefix
        # instead of re-prefilling, so these losses are absorbed
        self.forgets_recoverable = 0

    def lookup(self, keys: list[tuple], candidate_urls) -> str | None:
        """The remembered pod for the LONGEST assigned window that is
        still a candidate; None otherwise (one miss counted — keyless
        requests count nothing, they were never sticky-eligible)."""
        if not keys:
            return None
        with self._lock:
            for key in keys:
                url = self._od.get(key)
                if url is not None and url in candidate_urls:
                    self._od.move_to_end(key)
                    self.hits += 1
                    return url
            self.misses += 1
            return None

    def assign(self, keys: list[tuple], url: str) -> None:
        if not keys:
            return
        with self._lock:
            for key in keys:
                self._od[key] = url
                self._od.move_to_end(key)
            while len(self._od) > self.max_entries:
                self._od.popitem(last=False)

    def forget_pod(self, url: str, recoverable_models=None) -> int:
        """Drop every assignment to ``url`` (pod quarantined: its prefix
        cache is gone with it, so the next turn should re-assign by load
        instead of missing against a dead entry). ``recoverable_models``
        names models with registry-published prefix KV (dl/kv_store.py):
        forgotten assignments for those count recoverable — the next pod
        installs the shared prefix instead of re-prefilling it. Returns
        the recoverable count."""
        recoverable_models = recoverable_models or ()
        recovered = 0
        with self._lock:
            stale = [k for k, v in self._od.items() if v == url]
            for k in stale:
                del self._od[k]
                # sticky keys are (model, kind, bucket, crc)
                if k[0] in recoverable_models:
                    recovered += 1
            self.forgets_recoverable += recovered
        return recovered

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._od),
                "sticky_hits": self.hits,
                "sticky_misses": self.misses,
                "sticky_hit_ratio": round(self.hits / total, 4) if total else None,
                "sticky_forgets_recoverable_total": self.forgets_recoverable,
            }


def rendezvous_pod(key: tuple, candidates):
    """Highest-random-weight (rendezvous) choice for a sticky key: every
    candidate scores ``crc32(key | url)`` and the max wins. Deterministic
    from (key, candidate set) alone — two router replicas that have never
    exchanged a byte pick the SAME pod for the same prefix, and removing
    a pod only remaps the conversations that scored it highest (the
    consistent-hashing property, without a ring to maintain)."""
    seed = repr(key).encode()
    return max(candidates,
               key=lambda p: (_crc(seed + b"|" + p.url.encode()), p.url))


def plan_route(model: str, candidates, sticky: StickyTable,
               keys: list[tuple], inflight: dict[str, int]) -> list:
    """The ordered failover plan for one request: the sticky pod first
    (when it is a live candidate), then the remaining candidates by
    effective load — poll-time queue depth plus the router's OWN live
    in-flight count per pod (the poll is up to an interval stale; the
    router's counts are exact for the traffic it originated).

    A sticky MISS with a prompt falls back to rendezvous hashing on the
    request's SMALLEST window key (the most stable fingerprint across a
    growing conversation — and shared by every conversation with the
    same opening head, so common system prompts colocate their prefix
    KV) instead of the queue-depth tiebreak alone: two router replicas
    then agree on the anchor pod without shared state. The anchor is
    BOUNDED-LOAD, though: when its effective load exceeds the
    least-loaded candidate's by more than ``HRW_LOAD_SLACK``, the plan
    reverts to pure load order — a hot prefix herd must not pile onto
    one pod past the point where losing replica agreement is cheaper
    than the queueing. Failover order after the anchor stays by load,
    and keyless requests (no prompt) route purely by load.

    Returns PodState objects; empty means no READY pod serves the model.
    """
    if not candidates:
        return []
    by_url = {p.url: p for p in candidates}
    url = sticky.lookup(keys, by_url)

    def load(p) -> int:
        return inflight.get(p.url, 0) + p.queue_depth(model)

    ordered = sorted(candidates, key=lambda p: (load(p), p.url))
    if url is None:
        if not keys:
            return ordered
        anchor = rendezvous_pod(keys[-1], candidates)
        if load(anchor) > load(ordered[0]) + HRW_LOAD_SLACK:
            return ordered
        return [anchor] + [p for p in ordered if p.url != anchor.url]
    first = by_url[url]
    return [first] + [p for p in ordered if p.url != url]
