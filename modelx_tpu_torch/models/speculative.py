"""Prompt-lookup speculative decoding (counterpart of
``modelx_tpu/models/speculative.py``).

The continuation after the latest earlier occurrence of the sequence's
trailing n-gram is proposed, and one cached forward over ``[1, k+1]``
tokens verifies the whole proposal. Greedy acceptance keeps the output
token for token that of plain greedy decode: speculation changes how many
device steps it takes, never what comes back. Sampled acceptance is
modified rejection: each emitted token is distributed exactly as the plain
sampler's, drawn from the request's own (seed, draw position) streams of
``ops/prng.py`` (``jax.random``'s bits), so a seeded request draws the JAX
package's tokens.

Every verify step has the same shapes (a ``[1, k+1]`` block, proposals
padded) and the prompt is padded to the 16-bucket, as in the JAX package.
Rejected positions leave stale KV in the cache; the next step's offset
rewinds to the accepted end, so those slots are overwritten before the
causal mask ever exposes them.

On a mesh of processes the decoder runs on rank 0: ``on_step(kind,
inputs)`` hears each device step before it runs (``"open"``: the padded
prompt, the cache length and the sampling controls; ``"verify"``: the
block of rank 0's proposals, the offset its accepted count rolled the
cache back to and the draw position), and a follower replays them on a
``SpecSession`` of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from modelx_tpu_torch.models.decode import _visible, pad_seq_len
from modelx_tpu_torch.ops import prng
from modelx_tpu_torch.ops import sampling as sampling_ops


def ngram_propose(ids, k: int, max_ngram: int = 3, min_ngram: int = 1) -> list[int]:
    """Up to ``k`` proposed continuation tokens for the sequence ``ids``:
    the tokens that followed the latest earlier occurrence of the longest
    matching trailing n-gram. Empty when nothing matches. One-shot O(L·n)
    scan; the decoder uses the incremental ``_NgramIndex`` (same answers)."""
    ids = list(ids)
    L = len(ids)
    for n in range(max_ngram, min_ngram - 1, -1):
        if L < n + 1:
            continue
        tail = ids[L - n:]
        # latest occurrence wins: recent context predicts the near future best
        for start in range(L - n - 1, -1, -1):
            if ids[start:start + n] == tail:
                cont = ids[start + n:start + n + k]
                if cont:
                    return cont
    return []


class _NgramIndex:
    """Latest continuation-start per n-gram, kept incrementally so a lookup
    never rescans the sequence. For each gram the latest two positions are
    kept: the trailing gram's own (just-appended) occurrence must not
    propose its empty self, so a lookup landing on the sequence end falls
    back to the previous one."""

    def __init__(self, max_ngram: int) -> None:
        self.max_ngram = max_ngram
        self._cur: dict[tuple, int] = {}
        self._prev: dict[tuple, int] = {}

    def extend(self, seq: list, start: int) -> None:
        """Account for seq[start:] having been appended (positions are
        continuation starts, i.e. the index after the gram)."""
        for end in range(max(start, 1), len(seq) + 1):
            for n in range(1, self.max_ngram + 1):
                if end - n < 0:
                    break
                g = tuple(seq[end - n:end])
                cur = self._cur.get(g)
                if cur is not None and cur != end:
                    self._prev[g] = cur
                self._cur[g] = end

    def propose(self, seq: list, k: int) -> list[int]:
        L = len(seq)
        for n in range(self.max_ngram, 0, -1):
            if L < n + 1:
                continue
            g = tuple(seq[L - n:])
            pos = self._cur.get(g)
            if pos == L:  # the trailing gram itself: use the prior occurrence
                pos = self._prev.get(g)
            if pos is not None and pos < L:
                cont = seq[pos:pos + k]
                if cont:
                    return cont
        return []


class SpeculativeDecoder:
    """Decode for a single row with n-gram speculation. ``forward`` /
    ``init_kv_cache`` are the family decode fns (``ChunkedDecoder``'s seam).
    ``generate`` returns (new_tokens, stats); stats count device steps,
    proposed and accepted tokens."""

    def __init__(self, forward, init_kv_cache, k: int = 8, max_ngram: int = 3) -> None:
        self.forward = forward
        self.init_kv_cache = init_kv_cache
        self.k = int(k)
        self.max_ngram = int(max_ngram)

    def _prefill(self, params, prompt, cache, last: int) -> int:
        """``prompt`` is right-padded to the 16-bucket; ``last`` is the real
        final position, whose logits pick the first token."""
        logits, _ = self.forward(params, prompt, kv_cache=_visible(cache, prompt.shape[1]),
                                 cache_offset=0)
        return int(torch.argmax(logits[0, last]))

    def _verify(self, params, block, cache, offset: int) -> np.ndarray:
        """block: [1, k+1] = last accepted token + padded proposals. Returns
        the model's argmax at every position: position i is its pick for the
        token after block[:i+1]."""
        logits, _ = self.forward(params, block,
                                 kv_cache=_visible(cache, offset + block.shape[1]),
                                 cache_offset=offset)
        return torch.argmax(logits[0], dim=-1).cpu().numpy()

    # -- sampled speculation (modified rejection) -----------------------------
    #
    # The n-gram draft is a point mass q = delta(prop_i), so speculative
    # sampling's acceptance (accept x ~ q with prob min(1, p(x)/q(x)); on
    # rejection resample from norm(max(p - q, 0))) reduces to: accept prop_i
    # with prob p_i(prop_i); on rejection sample from p_i with prop_i struck
    # out. Each emitted token is then distributed exactly as p_i.

    @staticmethod
    def _spec_keys(seed: int, step0: int, tag: int, n: int, device) -> torch.Tensor:
        """[n, 2] keys: one independent stream per (request seed, absolute
        draw position step0 + i, use): use 0 = accept uniforms, 1 = draws."""
        base = prng.fold_in(prng.PRNGKey(0, device=device), seed)
        steps = step0 + torch.arange(n, dtype=torch.int64, device=device)
        return prng.fold_in(prng.fold_in(base, steps), tag)

    def _prefill_sampled(self, params, prompt, cache, last: int, temp, top_k, top_p,
                         seed: int) -> int:
        """Like ``_prefill`` but the first token samples from the filtered
        target distribution (draw position 0 of the request's stream)."""
        logits, _ = self.forward(params, prompt, kv_cache=_visible(cache, prompt.shape[1]),
                                 cache_offset=0)
        filtered = sampling_ops.scale_and_filter(logits[0, last][None].float(), temp, top_k,
                                                 top_p)
        key = self._spec_keys(seed, 0, 1, 1, logits.device)
        return int(prng.categorical(key, filtered)[0])

    def _verify_sampled(self, params, block, cache, offset: int, temp, top_k, top_p,
                        seed: int, step0: int):
        """Sampled verify over one [1, k+1] block. Returns, per position i
        (the distribution for the token after block[:i+1]): accept[i]
        (u_i < p_i(block[i+1])), resample[i] (a draw from p_i with the
        proposed token struck out) and plain[i] (a draw from p_i), as numpy."""
        logits, _ = self.forward(params, block,
                                 kv_cache=_visible(cache, offset + block.shape[1]),
                                 cache_offset=offset)
        n = self.k + 1
        dev = logits.device
        filt = sampling_ops.scale_and_filter(
            logits[0].float(), temp.expand(n),
            None if top_k is None else top_k.expand(n),
            None if top_p is None else top_p.expand(n))  # [k+1, V]
        probs = torch.softmax(filt, dim=-1)
        proposed_next = torch.cat([block[0, 1:], torch.zeros((1,), dtype=block.dtype,
                                                             device=dev)])
        p_prop = torch.gather(probs, 1, proposed_next[:, None].long())[:, 0]
        u = prng.uniform(self._spec_keys(seed, step0, 0, n, dev), 1)[:, 0]
        accept = u < p_prop
        draw_keys = self._spec_keys(seed, step0, 1, n, dev)
        struck = filt.scatter(1, proposed_next[:, None].long(), sampling_ops.NEG_INF)
        resample = prng.categorical(draw_keys, struck)
        plain = prng.categorical(draw_keys, filt)
        return (accept.cpu().numpy(), resample.cpu().numpy(), plain.cpu().numpy())

    def generate(self, params, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0) -> tuple[list[int], dict]:
        """Decode ``max_new_tokens`` tokens after ``prompt_ids`` (a 1-D int
        sequence). Greedy (temperature 0) is token-exact against plain
        greedy decode; temperature > 0 samples with modified rejection."""
        stats = {"device_steps": 0, "proposed": 0, "accepted": 0}
        out: list[int] = []
        for chunk in self.stream(params, prompt_ids, max_new_tokens, stats=stats,
                                 temperature=temperature, top_k=top_k, top_p=top_p,
                                 seed=seed):
            out.extend(chunk[0].tolist())
        return out, stats

    def stream(self, params, prompt_ids, max_new_tokens: int, stats: dict | None = None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               on_step=None):
        """Yields [1, c] int32 arrays of new tokens, one chunk per device
        step (the first token, then each verify step's accepted run and
        bonus token). Concatenated they equal ``generate``'s output.
        ``stats`` (optional) accumulates device_steps/proposed/accepted;
        ``on_step(kind, inputs)`` hears each device step first."""
        prompt_ids = [int(t) for t in prompt_ids]
        if stats is None:
            stats = {"device_steps": 0, "proposed": 0, "accepted": 0}
        if max_new_tokens <= 0:
            return
        s = len(prompt_ids)
        pad_s = pad_seq_len(s)
        # + k+1 slack: a verify block near the budget may write past it;
        # the cache length rounds up to a power of two, as in the JAX package
        need = max(pad_s, s + max_new_tokens + self.k) + 1
        opened = {"prompt": np.asarray([prompt_ids + [0] * (pad_s - s)], np.int64),
                  "real_len": s, "cache_len": 1 << (need - 1).bit_length(),
                  "temperature": float(temperature), "top_k": int(top_k),
                  "top_p": float(top_p), "seed": int(seed)}
        if on_step is not None:
            on_step("open", opened)
        session = SpecSession(self, params, **opened)
        first = session.first
        sampled = session.sampled
        stats["device_steps"] += 1
        out = [first]
        yield np.asarray([[first]], np.int32)
        seq = prompt_ids + out
        index = _NgramIndex(self.max_ngram)
        index.extend(seq, 0)
        offset = s  # the cache holds [0, offset) verified positions
        draws = 1  # absolute draw position (prefill consumed 0); sampled only
        while len(out) < max_new_tokens:
            prop = index.propose(seq, self.k)
            stats["proposed"] += len(prop)
            block = np.zeros((1, self.k + 1), np.int64)  # static shape
            block[0, 0] = seq[-1]
            if prop:
                block[0, 1:1 + len(prop)] = prop
            if on_step is not None:
                on_step("verify", {"block": block, "offset": offset, "draws": draws})
            verdict = session.verify(block, offset, draws)
            if sampled:
                accept, resample, plain = verdict
                stats["device_steps"] += 1
                # accept proposals while their rejection coin passes; the
                # first rejected position resamples from the residual, a
                # fully accepted run takes a plain draw at the next position
                a = 0
                while a < len(prop) and bool(accept[a]):
                    a += 1
                nxt = int(resample[a]) if a < len(prop) else int(plain[a])
                new = prop[:a] + [nxt]
                draws += a + 1
            else:
                argm = verdict
                stats["device_steps"] += 1
                # accept while the model agrees with the proposal, then take
                # the model's own token at the first disagreement
                a = 0
                while a < len(prop) and int(argm[a]) == prop[a]:
                    a += 1
                new = prop[:a] + [int(argm[a])]
            new = new[: max_new_tokens - len(out)]
            # count only emitted accepted tokens: a final step may accept
            # more than the budget has room for
            stats["accepted"] += min(a, len(new))
            grown_from = len(seq)
            out.extend(new)
            seq.extend(new)
            index.extend(seq, grown_from)
            if new:
                yield np.asarray([new], np.int32)
            # rewind past any rejected or padded cache entries: only the
            # block tokens that produced accepted output are verified history
            offset += a + 1


class SpecSession:
    """One speculative decode's device state: its cache, allocated and
    prefilled at construction (``first`` is the first token), and its
    verify steps. The decoder's own loop drives one; a mesh follower
    drives one from rank 0's posted steps."""

    def __init__(self, dec: SpeculativeDecoder, params, prompt: np.ndarray, real_len: int,
                 cache_len: int, temperature: float, top_k: int, top_p: float,
                 seed: int) -> None:
        self.dec, self.params, self.seed = dec, params, int(seed)
        self.cache = dec.init_kv_cache(1, int(cache_len))
        dev = self.dev = next(iter(self.cache.values())).device
        self.sampled = float(temperature) > 0.0
        prompt_t = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)
        if self.sampled:
            self.temp = torch.tensor([float(temperature)], dtype=torch.float32, device=dev)
            self.tk = (torch.tensor([int(top_k)], dtype=torch.int64, device=dev)
                       if int(top_k) > 0 else None)
            self.tp = (torch.tensor([float(top_p)], dtype=torch.float32, device=dev)
                       if float(top_p) < 1.0 else None)
            self.first = dec._prefill_sampled(params, prompt_t, self.cache, real_len - 1,
                                              self.temp, self.tk, self.tp, self.seed)
        else:
            self.first = dec._prefill(params, prompt_t, self.cache, real_len - 1)

    def verify(self, block: np.ndarray, offset: int, draws: int):
        """The verify step of ``block`` [1, k+1] at ``offset``: the argmax
        per position (greedy) or (accept, resample, plain) (sampled)."""
        block_t = torch.from_numpy(np.asarray(block, np.int64)).to(self.dev)
        if self.sampled:
            return self.dec._verify_sampled(self.params, block_t, self.cache, int(offset),
                                            self.temp, self.tk, self.tp, self.seed,
                                            int(draws))
        return self.dec._verify(self.params, block_t, self.cache, int(offset))


def speculative_generate(forward, init_kv_cache, params, prompt, max_new_tokens: int = 16,
                         k: int = 8, max_ngram: int = 3) -> tuple[np.ndarray, dict]:
    """One-shot convenience over SpeculativeDecoder (prompt: [1, S]).
    Returns ([1, S + max_new_tokens] prompt + generated, stats)."""
    prompt = np.asarray(prompt)
    if prompt.ndim != 2 or prompt.shape[0] != 1:
        raise ValueError("speculative decode is single-row: prompt must be [1, S]")
    dec = SpeculativeDecoder(forward, init_kv_cache, k=k, max_ngram=max_ngram)
    new, stats = dec.generate(params, prompt[0].tolist(), max_new_tokens)
    full = np.concatenate([prompt[0], np.asarray(new, prompt.dtype)])[None, :]
    return full, stats
