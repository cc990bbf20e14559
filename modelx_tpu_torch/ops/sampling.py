"""Token sampling: temperature / top-k / top-p with PER-ROW parameters.

Counterpart of ``modelx_tpu/ops/sampling.py``. One call serves a batch
whose rows carry different controls:

- ``temperature <= 0``   -> greedy (argmax) for that row;
- ``top_k == 0``         -> no top-k cut;
- ``top_p >= 1``         -> no nucleus cut.

Fused path: the row's k / nucleus cuts are thresholds read off a
descending ``torch.topk(scaled, K_CAP)`` prefix, and the full-vocab sort
runs only when some row's cut overflows the cap. The two branches are
byte-identical by construction, as in the JAX twin: both read their
thresholds off the SAME [B, K_CAP] prefix values (``topk`` values equal a
descending sort's first K_CAP columns: both are exact selections of one
multiset), the softmax max and denominator come once from the full
unsorted row, and the nucleus cumsum runs at width K_CAP in both branches
for rows that fit (a cumsum is not width-stable: on the card it is a
parallel scan), so the fallback uses its full-width cumsum only for rows
that overflowed. ``scale_and_filter_reference`` is the always-sort branch
the tests hold the fused path to.

The branch is chosen on the host (``bool(fits.all())``, JAX's
``lax.cond``): a sync with the card when a filter is on, in exchange for no
[B, V] sort on steps whose cuts fit. Draws come from ``ops/prng.py``, the
port's copy of ``jax.random``'s threefry, so seeded rows draw the JAX
package's tokens.
"""

from __future__ import annotations

import torch

from modelx_tpu_torch.ops import prng

# Legacy sentinel kept for parity with the JAX module; the filter masks are
# dtype-aware (mask_value)
NEG_INF = -1e30

# Static prefix width for the fused threshold path. Any row with
# 0 < top_k <= K_CAP and a nucleus cut inside the first K_CAP sorted probs
# resolves without sorting the vocab.
K_CAP = 64


def mask_value(dtype: torch.dtype) -> float:
    """Most-negative FINITE value of ``dtype``, the fill for filtered-out
    logits: -1e30 overflows fp16 to -inf, and -inf logits turn max/softmax
    arithmetic into NaN."""
    return torch.finfo(dtype).min


def _prefix_keep(scaled, prefix, top_k, top_p):
    """Keep-mask for ``scaled`` [B, V] from a DESCENDING prefix [B, W] of
    each row (W == V for the full sort). Returns ``(keep, fits)``;
    ``fits[b]`` says row b's active filters resolved inside the prefix."""
    b, v = scaled.shape
    w = prefix.shape[1]
    keep = torch.ones_like(scaled, dtype=torch.bool)
    fits = torch.ones((b,), dtype=torch.bool, device=scaled.device)
    if top_k is not None:
        # top-k: keep logits >= the k-th largest (per-row k)
        k = torch.clamp(top_k.to(torch.int64), 0, v)
        kth = torch.gather(prefix, 1, torch.clamp(k - 1, 0, w - 1)[:, None])
        keep &= torch.where(k[:, None] > 0, scaled >= kth, True)
        fits &= (k == 0) | (k <= w)
    if top_p is not None:
        # nucleus: smallest sorted prefix with cumulative probability >= p;
        # keep logits >= its last member. Softmax stats come from the full
        # unsorted row, so every prefix width sees identical probs.
        p = top_p.to(scaled.dtype)[:, None]
        m = prefix[:, :1]  # row max: exact, width-independent
        denom = torch.sum(torch.exp(scaled - m), dim=-1, keepdim=True)
        probs = torch.exp(prefix - m) / denom  # [B, W]
        cum = torch.cumsum(probs, dim=-1)
        in_nucleus = cum - probs < p  # the prefix including the item crossing p
        cut = torch.clamp(in_nucleus.sum(dim=-1) - 1, min=0)[:, None]
        pth = torch.gather(prefix, 1, cut)
        keep &= torch.where(p < 1.0, scaled >= pth, True)
        # the cut lands inside the prefix iff the prefix holds >= p mass
        fits &= (p[:, 0] >= 1.0) | (cum[:, -1] >= p[:, 0])
    return keep, fits


def _scaled(logits, temperature):
    t = temperature.to(logits.dtype)
    return logits / torch.where(t > 0, t, 1.0)[:, None]


def _sorted_desc(x):
    return torch.sort(x, dim=-1, descending=True).values


def scale_and_filter(
    logits: torch.Tensor,  # [B, V] float
    temperature: torch.Tensor,  # [B] float; <=0 rows pass through at scale 1
    top_k: torch.Tensor | None = None,  # [B] int; 0 = off; None = skip filter
    top_p: torch.Tensor | None = None,  # [B] float; >=1 = off; None = skip filter
    *,
    k_cap: int | None = K_CAP,  # fused-prefix width; None = always sort
) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-filtered logits: softmax of the
    result is the distribution ``sample`` draws from. The full sort runs
    only when a row's cut overflows ``k_cap`` (see module docstring)."""
    v = logits.shape[1]
    scaled = _scaled(logits, temperature)
    if top_k is None and top_p is None:
        return scaled
    neg = mask_value(scaled.dtype)
    if k_cap is None or v <= int(k_cap):
        # the "prefix" is the whole sorted row: every cut fits
        keep, _ = _prefix_keep(scaled, _sorted_desc(scaled), top_k, top_p)
        return torch.where(keep, scaled, neg)
    prefix = torch.topk(scaled, int(k_cap), dim=-1).values  # [B, W] descending
    keep, fits = _prefix_keep(scaled, prefix, top_k, top_p)
    if not bool(fits.all()):
        scale_and_filter.sorts += 1
        keep_full, _ = _prefix_keep(scaled, _sorted_desc(scaled), top_k, top_p)
        # fitting rows keep the prefix decision; overflowing rows take the
        # full-width one
        keep = torch.where(fits[:, None], keep, keep_full)
    return torch.where(keep, scaled, neg)


# calls that overflowed the prefix and sorted the vocab (the fallback branch)
scale_and_filter.sorts = 0


def scale_and_filter_reference(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor | None = None,
    top_p: torch.Tensor | None = None,
    *,
    k_cap: int | None = K_CAP,
) -> torch.Tensor:
    """The always-sort branch of :func:`scale_and_filter`: for batches whose
    cuts fit inside ``k_cap`` the fused path must equal it byte for byte."""
    v = logits.shape[1]
    scaled = _scaled(logits, temperature)
    if top_k is None and top_p is None:
        return scaled
    neg = mask_value(scaled.dtype)
    full = _sorted_desc(scaled)
    if k_cap is None or v <= int(k_cap):
        keep, _ = _prefix_keep(scaled, full, top_k, top_p)
        return torch.where(keep, scaled, neg)
    keep_pre, fits = _prefix_keep(scaled, full[:, : int(k_cap)], top_k, top_p)
    keep_full, _ = _prefix_keep(scaled, full, top_k, top_p)
    return torch.where(torch.where(fits[:, None], keep_pre, keep_full), scaled, neg)


def sample(
    logits: torch.Tensor,  # [B, V] float
    key: torch.Tensor,  # base key data [2] (prng.PRNGKey)
    temperature,  # [B] float; <=0 = greedy
    top_k=None,  # [B] int; 0 = off; None = skip filter
    top_p=None,  # [B] float; >=1 = off; None = skip filter
    seeds=None,  # [B] int per-row stream
    step=0,  # int or [B] int: the decode step, folded in so steps differ
) -> torch.Tensor:
    """Next token per row, [B] int32. Row b draws with the key
    ``fold_in(fold_in(key, seeds[b]), step[b])``, so a row's stream depends
    only on its (seed, step), never on the batch around it. Noise is drawn
    in float32: pass float32 logits for the JAX package's tokens."""
    b = logits.shape[0]
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)
    temperature = torch.as_tensor(temperature, device=dev).to(logits.dtype)
    if top_k is not None:
        top_k = torch.as_tensor(top_k, device=dev)
    if top_p is not None:
        top_p = torch.as_tensor(top_p, device=dev)
    filtered = scale_and_filter(logits, temperature, top_k, top_p)
    seeds = (torch.zeros((b,), dtype=torch.int64, device=dev) if seeds is None
             else torch.as_tensor(seeds, device=dev).to(torch.int64))
    if isinstance(step, int):  # a fill, not a host-to-device copy
        steps = torch.full((b,), step, dtype=torch.int64, device=dev)
    else:
        steps = torch.as_tensor(step, device=dev).to(torch.int64).expand(b)
    keys = prng.fold_in(prng.fold_in(key.to(dev), seeds), steps)
    sampled = prng.categorical(keys, filtered)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
