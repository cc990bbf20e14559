"""Shared cached greedy decode (counterpart of ``modelx_tpu/models/decode.py``).

``forward``/``init_kv_cache`` are parameters, so the offset logic cannot
drift between families. JAX's ``lax.scan`` over steps becomes a Python loop
that writes the static-shape cache in place. ``ChunkedDecoder`` (streaming)
and ``PrefixKVCache`` come with the sampling/streaming slice.
"""

from __future__ import annotations

import torch

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


def greedy_generate(
    forward,  # (params, tokens, kv_cache=, cache_offset=) -> (logits, cache)
    init_kv_cache,  # (batch, max_len) -> cache
    params,
    prompt: torch.Tensor,  # [B, S]
    max_new_tokens: int = 16,
) -> torch.Tensor:
    """Greedy decode with a static-shape KV cache. Returns
    [B, S + max_new_tokens]; max_new_tokens <= 0 returns the prompt."""
    if max_new_tokens <= 0:
        return prompt
    b, s = prompt.shape
    cache = init_kv_cache(b, s + max_new_tokens)
    logits, cache = forward(params, prompt, kv_cache=cache, cache_offset=0)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]  # [B,1]
    out = [prompt, tok]
    for i in range(max_new_tokens - 1):
        logits, cache = forward(params, tok, kv_cache=cache, cache_offset=s + i)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        out.append(tok)
    return torch.cat([x.to(prompt.dtype) for x in out], dim=1)


def ragged_greedy_generate(
    forward,
    init_kv_cache,
    params,
    prompt: torch.Tensor,  # [B, S] right-padded
    row_lens: torch.Tensor,  # [B] real prompt length per row (1..S)
    max_new_tokens: int = 16,
) -> torch.Tensor:
    """Greedy decode for a RAGGED batch: rows of different prompt lengths
    right-padded to a common S, each decoding from its own offset. Returns
    the generated tokens only, [B, max_new_tokens].

    Right-padding preserves outputs for causal models: pads sit after every
    real token, so the causal mask hides them from the prefill; decode then
    writes each new token at the row's own next position, overwriting pad
    slots, and the per-row causal threshold keeps the rest invisible."""
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=prompt.dtype, device=prompt.device)
    row_lens = torch.as_tensor(row_lens, device=prompt.device).long()
    if int(row_lens.min()) < 1 or int(row_lens.max()) > s:
        raise ValueError(f"row_lens must be in [1, {s}], got {row_lens.tolist()}")
    cache = init_kv_cache(b, s + max_new_tokens)
    logits, cache = forward(params, prompt, kv_cache=cache, cache_offset=0)
    # each row's first decoded token comes from ITS last real position
    last = logits[torch.arange(b, device=logits.device), row_lens - 1]
    tok = torch.argmax(last, dim=-1)[:, None]
    out = [tok]
    for t in range(max_new_tokens - 1):
        logits, cache = forward(params, tok, kv_cache=cache, cache_offset=row_lens + t)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).to(prompt.dtype)
