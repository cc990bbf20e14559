"""Paged decode attention: online softmax over page blocks, in place
(counterpart of ``modelx_tpu/ops/paged_attention.py``).

The paged continuous engine (``dl/continuous.py``) keeps each layer's KV
as a POOL of fixed-size pages plus a block table. Its gather mode builds a
dense view of every slot's pages per layer and runs the family forward on
it; this op removes the view for families that wire it (llama/qwen2 via
``forward(..., paged_table=...)``): attention reads the pool directly, one
page block at a time, with the flash-attention accumulation (running max /
normalizer), so the per-step transient is one [slots, page_size] block.

The JAX twin is ``lax.fori_loop`` plus gathers, not a Pallas kernel, so
this is plain torch ops with the same per-page blockwise update: the
numerics the reference's tests hold, and the property that a fully masked
block's update is the identity (m_new = m, corr = exp(0) = 1, p = 0), which
makes the ragged loop bound exact. The bound is the batch's actual max
page, ``ceil(max(lengths) / page_size)``: the JAX twin computes it on the
device; eagerly that would be a host sync per layer, so callers that know
the lengths on the host pass ``n_blocks`` (the engine does), and a call
without it reads the maximum back once.

Numerics: the blockwise accumulation is algebraically the softmax but not
bit-identical to a full-width softmax (a different reduction order); fp32
accumulation throughout.
"""

from __future__ import annotations

import math

import torch

from modelx_tpu_torch.ops.attention import NEG_INF  # one masking sentinel everywhere


def page_coords(table: torch.Tensor, offsets: torch.Tensor, page_size: int):
    """(page_idx [S], off_in_page [S]) locating each row's position
    ``offsets`` inside its page pool: the page-addressing convention every
    pool write site shares (the model's paged branch, the engine's gather
    write-back and its speculative verify)."""
    offsets = offsets.to(table.device, torch.int64)
    page_idx = torch.gather(table.to(torch.int64), 1,
                            torch.div(offsets, page_size, rounding_mode="floor")[:, None])[:, 0]
    return page_idx, offsets % page_size


def write_token_kv(pool: torch.Tensor, block: torch.Tensor, table: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Write one decode step's [S, 1, H, D] k or v block into each row's
    current page of the [P, ps, H, D] pool, in place (exclusive page
    ownership makes it collision-free; idle rows hit the trash page).
    Returns the pool."""
    page_idx, off_in = page_coords(table, offsets, pool.shape[1])
    pool[page_idx, off_in] = block[:, 0].to(pool.dtype)
    return pool


def ragged_blocks(max_length: int, page_size: int, pages_per_slot: int) -> int:
    """The loop bound for a batch whose longest row holds ``max_length``
    positions: ``ceil(max_length / page_size)`` clipped to [1, table width]."""
    return max(1, min(-(-int(max_length) // page_size), pages_per_slot))


def paged_attention(
    q: torch.Tensor,  # [S, Hq, D]: one decode step per slot
    pool_k: torch.Tensor,  # [P, ps, Hkv, D]
    pool_v: torch.Tensor,  # [P, ps, Hkv, D]
    table: torch.Tensor,  # [S, pages_per_slot] int (0 = trash page)
    lengths: torch.Tensor,  # [S] valid positions per slot (= offset + 1)
    scale: float | None = None,
    logit_softcap: float = 0.0,
    window: int = 0,
    n_blocks: int | None = None,
) -> torch.Tensor:
    """Returns [S, Hq, D]. Positions >= lengths[s] (junk pages, partial
    tails) contribute exactly zero weight; every slot has >= 1 valid
    position (idle slots attend to their trash-page write at 0).

    ``scale`` defaults to 1/sqrt(head_dim). ``logit_softcap`` > 0 applies
    cap * tanh(scores / cap) before masking, ``window`` > 0 keeps only each
    row's last ``window`` positions visible, as ``attention_reference``'s
    kwargs of the same names. ``n_blocks`` is the host-known ragged bound
    (``ragged_blocks``); None reads ``max(lengths)`` back from the device."""
    s, hq, d = q.shape
    _p, ps, hkv, _d = pool_k.shape
    rep = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pages_per_slot = table.shape[1]
    if n_blocks is None:
        n_blocks = ragged_blocks(int(lengths.max()), ps, pages_per_slot)
    dev = q.device
    table = table.to(dev, torch.int64)
    lengths = lengths.to(dev, torch.int64)
    qg = (q.float() * scale).reshape(s, hkv, rep, d)
    # every block's mask at once: [n_blocks, S, ps] (the loop reads rows)
    pos = torch.arange(n_blocks * ps, device=dev).reshape(n_blocks, 1, ps)
    masks = pos < lengths[None, :, None]
    if window > 0:  # each row's query sits at lengths - 1
        masks = masks & (pos > (lengths - 1 - window)[None, :, None])
    m = torch.full((s, hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((s, hkv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((s, hkv, rep, d), dtype=torch.float32, device=dev)
    for j in range(n_blocks):
        pids = table[:, j]
        kb = pool_k[pids].float()  # [S, ps, Hkv, D]
        vb = pool_v[pids].float()
        scores = torch.einsum("skrd,spkd->skrp", qg, kb)  # [S, Hkv, rep, ps]
        if logit_softcap > 0.0:
            scores = logit_softcap * torch.tanh(scores / logit_softcap)
        mask = masks[j][:, None, None, :]
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        # multiply by the mask AFTER exp: an all-masked block would
        # otherwise contribute exp(NEG_INF - NEG_INF) = 1 per position
        p = torch.exp(scores - m_new[..., None]) * mask
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("skrp,spkd->skrd", p, vb)
        m = m_new
    out = acc / l[..., None]
    return out.reshape(s, hq, d).to(q.dtype)
