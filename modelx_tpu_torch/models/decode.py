"""Shared cached decode (counterpart of ``modelx_tpu/models/decode.py``).

``forward``/``init_kv_cache`` are parameters, so the offset logic cannot
drift between families. A cache is a dict of ``[B, max_len, ...]`` tensors
written in place. JAX's ``lax.scan`` over steps becomes a Python loop.

Every forward attends over the cache's first ``kv_len`` positions only, the
longest any row can see at that step (``_visible``); the positions past it
are masked in the JAX package's full-length attention, so the math is the
same. It makes a step's shapes depend only on the prompt and the step, not
on how long a caller sized its cache: the streamed and the one-shot decode
then launch the same kernels at every step and draw the same bits on the
card.

Sampling is per row (``ops/sampling.sample``); a batch whose rows are all
greedy takes the argmax, which is what ``sample`` returns for such rows.
On a mesh of processes every rank runs the same decode on its part of the
model, and ``agree`` (``Mesh.broadcast_from_leader``) makes each picked
token rank 0's: the ranks never count on their samplers agreeing bit for
bit.
"""

from __future__ import annotations

import collections
import logging
import threading

import numpy as np
import torch

from modelx_tpu_torch.ops import prng
from modelx_tpu_torch.ops import sampling as sampling_ops
from modelx_tpu_torch.utils.tswheel import RateSet

logger = logging.getLogger("modelx.decode")

SEQ_BUCKET = 16


def pad_seq_len(s: int) -> int:
    """Round a prompt length up to the shared bucket quantum."""
    return -(-s // SEQ_BUCKET) * SEQ_BUCKET


def stop_cut(tokens, stops) -> int | None:
    """Index AFTER the first stop token in ``tokens`` (the inclusive trim
    length), or None when no stop matches."""
    if not stops:
        return None
    for i, t in enumerate(tokens):
        if t in stops:
            return i + 1
    return None


def _visible(cache: dict, kv_len: int) -> dict:
    """Views of the cache's first ``kv_len`` positions (writes land in it)."""
    return {name: c[:, :kv_len] for name, c in cache.items()}


def _host_lens(row_lens, s: int) -> list[int]:
    lens = [int(n) for n in torch.as_tensor(row_lens).reshape(-1).tolist()]
    if not lens or min(lens) < 1 or max(lens) > s:
        raise ValueError(f"row_lens must be in [1, {s}], got {lens}")
    return lens


def _step_offsets(lens: list[int], row_lens: torch.Tensor):
    """``offset(t)``: where decode step ``t`` writes each row's token. An
    int when every row has one prompt length, as every ``/v1/generate``
    request and stream has: the cache write is then a slice and nothing
    waits on the card. A ragged batch gets a [B] tensor, in range by
    construction (the cache holds max(lens) plus every new token)."""
    if len(set(lens)) == 1:
        return lambda t: lens[0] + t
    return lambda t: row_lens + t


def _make_picker(b: int, device, temperature=None, top_k=None, top_p=None, seeds=None,
                 agree=None):
    """``pick(logits [B, V], step) -> [B]`` for one request's per-row
    controls (host arrays): the argmax when no row samples, else
    ``sampling.sample`` on float32 logits with the per-row (seed, step)
    streams of base key ``PRNGKey(0)``. None filters stay None, so the
    sampler does no filter work for them. ``agree(tokens)`` (a mesh's
    broadcast from rank 0) is applied to every pick."""
    if agree is not None:
        base = _make_picker(b, device, temperature, top_k, top_p, seeds)
        return lambda logits, step: agree(base(logits, step).contiguous())
    if temperature is None or not bool((torch.as_tensor(temperature) > 0).any()):
        return lambda logits, step: torch.argmax(logits, dim=-1)

    def vec(x, dtype):
        return None if x is None else torch.as_tensor(np.asarray(x), device=device).to(dtype)

    t = vec(temperature, torch.float32)
    k, p = vec(top_k, torch.int64), vec(top_p, torch.float32)
    s = torch.zeros((b,), dtype=torch.int64, device=device) if seeds is None \
        else vec(seeds, torch.int64)
    key = prng.PRNGKey(0, device=device)

    def pick(logits, step):
        return sampling_ops.sample(logits.float(), key, t, top_k=k, top_p=p, seeds=s,
                                   step=step)

    return pick


def family_fns(forward, init_kv_cache, cfg, device):
    """A family's cached forward and cache allocator as this module, the
    streams and the continuous engine call them: ``fwd(p, t, kv_cache,
    cache_offset)`` over ``forward(p, t, cfg, kv_cache=, cache_offset=)``
    and ``init(b, max_len)`` over ``init_kv_cache(cfg, b, max_len,
    device=)``, on the params' ``device``."""

    def fwd(p, t, kv_cache, cache_offset):
        return forward(p, t, cfg, kv_cache=kv_cache, cache_offset=cache_offset)

    return fwd, (lambda b, max_len: init_kv_cache(cfg, b, max_len, device=device))


def paged_family_fn(forward, cfg):
    """A family's forward over PAGED kv pools, as the engine's in-place
    chunk step calls it: ``fwd(p, t, kv_cache, cache_offset, table,
    n_blocks)`` over ``forward(..., paged_table=, paged_blocks=)``."""

    def fwd(p, t, kv_cache, cache_offset, table, n_blocks=None):
        return forward(p, t, cfg, kv_cache=kv_cache, cache_offset=cache_offset,
                       paged_table=table, paged_blocks=n_blocks)

    return fwd


def ragged_greedy_generate(
    forward,
    init_kv_cache,
    params,
    prompt: torch.Tensor,  # [B, S] right-padded
    row_lens,  # [B] real prompt length per row (1..S)
    max_new_tokens: int = 16,
    temperature=None,  # [B] float; enables sampling (<=0 rows stay greedy)
    top_k=None,  # [B] int; 0 = off
    top_p=None,  # [B] float; >=1 = off
    seeds=None,  # [B] int per-row sample stream
    agree=None,  # on a mesh: every rank takes rank 0's picks
) -> torch.Tensor:
    """Decode for a RAGGED batch: rows of different prompt lengths
    right-padded to a common S, each decoding from its own offset. Returns
    the generated tokens only, [B, max_new_tokens]. Greedy by default;
    ``temperature`` switches to per-row sampling.

    Right-padding preserves outputs for causal models: pads sit after every
    real token, so the causal mask hides them from the prefill; decode then
    writes each new token at the row's own next position, overwriting pad
    slots, and the per-row causal threshold keeps the rest invisible."""
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=prompt.dtype, device=prompt.device)
    lens = _host_lens(row_lens, s)
    row_lens = torch.tensor(lens, device=prompt.device)
    offset = _step_offsets(lens, row_lens)
    pick = _make_picker(b, prompt.device, temperature, top_k, top_p, seeds, agree)
    cache = init_kv_cache(b, s + max_new_tokens)
    logits, _ = forward(params, prompt, kv_cache=_visible(cache, s), cache_offset=0)
    # each row's first decoded token comes from ITS last real position
    tok = pick(logits[torch.arange(b, device=logits.device), row_lens - 1], 0)[:, None]
    out = [tok]
    for t in range(max_new_tokens - 1):
        logits, _ = forward(params, tok, kv_cache=_visible(cache, max(lens) + t + 1),
                            cache_offset=offset(t))
        tok = pick(logits[:, -1, :], t + 1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).to(prompt.dtype)


class PrefixKVCache:
    """Exact-prefix KV reuse for chat-shaped traffic.

    Multi-turn chat re-sends the same prefix every turn. This cache keeps a
    prompt's prefill KV (trimmed to its 16-bucket, on the device) keyed by
    the exact token ids; a later prompt that starts with a stored key
    prefills only its suffix from that offset. KV values are a function of
    the token prefix, so the resumed stream equals an uncached one, greedy
    and sampled alike.

    Capacity is an LRU entry count; ``max_bytes`` > 0 also caps the
    entries' actual KV bytes (summed at ``put``). The newest entry always
    survives, even alone over the byte cap, so a long conversation still
    hits on its next turn.

    The registry's KV store (``dl/kv_store.py``) rides on it: per-key hit
    counts drive the publish threshold (``take_publishable``), each entry
    records its origin (``"local"``, or ``"installed"`` from a registry
    bundle, which is never published again and whose hits count apart in
    ``hits_installed``), and an optional ``fetcher`` hears of every miss.
    """

    def __init__(self, capacity: int = 4, max_bytes: int = 0) -> None:
        self.capacity = max(1, int(capacity))
        self.max_bytes = max(0, int(max_bytes))
        self._od: collections.OrderedDict[tuple, object] = collections.OrderedDict()
        # per-key (nbytes, stored_len), computed once at put
        self._meta: dict[tuple, tuple[int, int | None]] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # the KV store's plumbing: per-key hits (the publish threshold),
        # each entry's origin, and the keys already taken for publishing
        self._hits_by_key: dict[tuple, int] = {}
        self._origin: dict[tuple, str] = {}
        self._published: set[tuple] = set()
        self.hits_installed = 0
        self.installed_total = 0
        self.published_total = 0
        self._rates = RateSet(("hit", "miss"))
        # optional kv_store.KVFetcher: told of every miss (outside the
        # lock, an O(1) bounded enqueue) so published bundles fetch through
        self.fetcher = None

    def lookup(self, ids, max_total: int | None = None) -> tuple[int, object] | None:
        """Longest stored key that is a STRICT prefix of ``ids`` (the suffix
        prefill needs >= 1 real token) and whose stored length plus the
        suffix's bucket fits ``max_total``. Returns (prefix_len, entry) or
        None; hits and misses count usable lookups only."""
        ids = tuple(int(t) for t in ids)
        best = None
        with self._lock:
            for key in self._od:
                if len(key) >= len(ids) or ids[: len(key)] != key:
                    continue
                stored_len = self._meta[key][1]
                if (max_total is not None and stored_len is not None
                        and stored_len + pad_seq_len(len(ids) - len(key)) > max_total):
                    continue
                if best is None or len(key) > len(best):
                    best = key
            if best is not None:
                self._od.move_to_end(best)
                self.hits += 1
                self._hits_by_key[best] = self._hits_by_key.get(best, 0) + 1
                if self._origin.get(best) == "installed":
                    self.hits_installed += 1
                self._rates.mark("hit")
                return len(best), self._od[best]
            self.misses += 1
            self._rates.mark("miss")
            fetcher = self.fetcher
        # outside the lock: even an O(1) enqueue must not lengthen the
        # critical section every admission scan shares
        if fetcher is not None:
            try:
                fetcher.on_miss(ids)
            except Exception:
                logger.debug("kv fetcher on_miss failed", exc_info=True)
        return None

    @staticmethod
    def _entry_meta(entry) -> tuple[int, int | None]:
        """(nbytes, stored length) of a dict of [1, L, ...] tensors or
        arrays; anything else counts 0 bytes of unknown length."""
        leaves = list(entry.values()) if isinstance(entry, dict) else []
        nbytes = sum(int(getattr(leaf, "nbytes", 0)) for leaf in leaves)
        try:
            stored_len = int(leaves[0].shape[1])
        except (AttributeError, IndexError, TypeError):
            stored_len = None
        return nbytes, stored_len

    def _pop_lru(self) -> None:
        key, _ = self._od.popitem(last=False)
        self._bytes -= self._meta.pop(key)[0]
        self._hits_by_key.pop(key, None)
        self._origin.pop(key, None)
        self._published.discard(key)

    def put(self, ids, entry, origin: str = "local") -> None:
        key = tuple(int(t) for t in ids)
        meta = self._entry_meta(entry)
        with self._lock:
            if key in self._od:
                self._bytes -= self._meta[key][0]
                # a re-put of a key (the engine refreshes entries) keeps an
                # installed entry installed: registry KV is never ours to
                # publish again
                if origin == "local":
                    origin = self._origin.get(key, "local")
            self._od[key] = entry
            self._meta[key] = meta
            self._origin[key] = origin
            if origin == "installed":
                self.installed_total += 1
                self._published.add(key)  # already in the registry
            self._bytes += meta[0]
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                self._pop_lru()
            while self.max_bytes and self._bytes > self.max_bytes and len(self._od) > 1:
                self._pop_lru()

    def entry_origin(self, ids) -> str | None:
        """"local" or "installed" for a stored key, None when absent."""
        key = tuple(int(t) for t in ids)
        with self._lock:
            return self._origin.get(key)

    def take_publishable(self, threshold: int = 2) -> list[tuple[tuple, object]]:
        """Hot local entries worth shipping to the registry: hit at least
        ``threshold`` times, origin "local", not taken before. The returned
        keys are marked published (the outbox owns durability from here: a
        failed publish retries the spooled bytes, not the entry)."""
        out = []
        with self._lock:
            for key, entry in self._od.items():
                if key in self._published or self._origin.get(key, "local") != "local":
                    continue
                if self._hits_by_key.get(key, 0) < max(1, int(threshold)):
                    continue
                self._published.add(key)
                self.published_total += 1
                out.append((key, entry))
        return out

    def stats(self) -> dict:
        with self._lock:
            out = {"hits": self.hits, "misses": self.misses,
                   "entries": len(self._od), "bytes": self._bytes,
                   "hits_installed": self.hits_installed,
                   "installed_total": self.installed_total,
                   "published_total": self.published_total}
        out.update(self._rates.snapshot())
        return out

    def clear(self) -> None:
        """Drop every entry (their KV tensors pin device memory)."""
        with self._lock:
            self._od.clear()
            self._meta.clear()
            self._bytes = 0
            self._hits_by_key.clear()
            self._origin.clear()
            self._published.clear()


class ChunkedDecoder:
    """Streaming decode: tokens come back in ``chunk_size`` pieces so a
    server can flush them while the rest still generates. The token stream
    equals ``ragged_greedy_generate``'s with the same controls: same per-row
    offsets, same (seed, step) sample streams, same shapes at every step.

    With a ``prefix_cache``, single-row streams store their prefill KV and
    later streams sharing a prompt prefix prefill only the suffix. On a
    mesh, ``agree`` makes every rank take rank 0's picks.
    """

    def __init__(self, forward, init_kv_cache, chunk_size: int = 8,
                 prefix_cache: PrefixKVCache | None = None, agree=None) -> None:
        self.forward = forward
        self.init_kv_cache = init_kv_cache
        self.chunk_size = int(chunk_size)
        self.prefix_cache = prefix_cache
        self.agree = agree

    def stream(self, params, prompt, row_lens, max_new_tokens: int,
               temperature=None, top_k=None, top_p=None, seeds=None,
               stop_token_ids=None):
        """Yields [B, k] int32 numpy arrays of new tokens (k <= chunk_size),
        totalling max_new_tokens per row, or FEWER when ``stop_token_ids``
        (single-row streams only) matches: the stream emits up to and
        including the stop token, then ends without decoding the rest."""
        b, s = prompt.shape
        if max_new_tokens <= 0:
            return
        dev = prompt.device
        lens = _host_lens(row_lens, s)
        row_lens = torch.tensor(lens, device=dev)
        offset = _step_offsets(lens, row_lens)
        pick = _make_picker(b, dev, temperature, top_k, top_p, seeds, self.agree)
        # cache sized for whole chunks, rounded up to a power of two of
        # them, as the JAX package sizes it
        n_chunks = -(-max_new_tokens // self.chunk_size)
        n_chunks = 1 << (n_chunks - 1).bit_length()
        cache_len = s + n_chunks * self.chunk_size + 1
        ids = hit = None
        if self.prefix_cache is not None and b == 1:
            ids = prompt[0, : lens[0]].tolist()
            hit = self.prefix_cache.lookup(ids)
        if hit is not None:
            plen, stored = hit
            suffix = ids[plen:]
            sb = pad_seq_len(len(suffix))
            # the cache holds the stored bucket AND the suffix block's whole
            # write span (plen + suffix bucket)
            stored_len = next(iter(stored.values())).shape[1]
            cache_len = max(cache_len, stored_len, plen + sb)
        cache = self.init_kv_cache(b, cache_len)
        if hit is not None:
            for name, c in cache.items():
                c[:, :stored_len] = stored[name]
            # the stored bucket's junk past plen lies inside the suffix's
            # write span (bucket - plen < 16 <= sb), so nothing stale survives
            block = torch.zeros((1, sb), dtype=prompt.dtype, device=dev)
            block[0, : len(suffix)] = torch.tensor(suffix, dtype=prompt.dtype)
            logits, _ = self.forward(params, block, kv_cache=_visible(cache, plen + sb),
                                     cache_offset=plen)
            tok = pick(logits[:, len(suffix) - 1], 0)[:, None]
        else:
            logits, _ = self.forward(params, prompt, kv_cache=_visible(cache, s),
                                     cache_offset=0)
            tok = pick(logits[torch.arange(b, device=dev), row_lens - 1], 0)[:, None]
        if ids is not None:
            # store THIS prompt's KV (a copy: decode overwrites the bucket's
            # tail) so the next turn, which extends it, hits
            n = pad_seq_len(len(ids))
            self.prefix_cache.put(ids, {name: c[:, :n].clone() for name, c in cache.items()})
        stops = set(stop_token_ids or ()) if b == 1 else set()
        emitted = 0
        while emitted < max_new_tokens:
            take = min(self.chunk_size, max_new_tokens - emitted)
            toks = []
            for step in range(emitted, emitted + take):
                toks.append(tok)
                if step + 1 < max_new_tokens:
                    logits, _ = self.forward(
                        params, tok, kv_cache=_visible(cache, max(lens) + step + 1),
                        cache_offset=offset(step))
                    tok = pick(logits[:, -1, :], step + 1)[:, None]
            piece = torch.cat(toks, dim=1).to(torch.int32).cpu().numpy()
            if stops:
                cut = stop_cut(piece[0].tolist(), stops)
                if cut is not None:
                    yield piece[:, :cut]  # include the stop token
                    return
            yield piece
            emitted += take
