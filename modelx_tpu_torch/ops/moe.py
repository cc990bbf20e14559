"""Mixture-of-experts FFN: the top-k router and per-expert dispatch
(counterpart of ``modelx_tpu/ops/moe.py``).

The JAX twin dispatches with dense one-hot einsums over a fixed per-expert
capacity C, because a TPU program wants static shapes; at C = S that does
E / k times the routed work. Eagerly on the card the same function is a
gather: each expert runs its SwiGLU on the rows routed to it, and its
output, times the combine weight, is added into an fp32 sum with
``index_add_``. The tokens kept are the same: capacity ``C`` per expert
and batch row, filled in sequence order (a cumulative sum), overflow
dropped; ``capacity_factor`` <= 0 is drop-free (C = S, Mixtral's math).
The casts to the activation dtype sit where the twin's einsums put them:
the expert inputs, gate and up, ``silu(gate) * up``, down, and the combine
weights before the fp32 sum, which is cast once at the end. Each expert
adds its rows in one call, with no row twice, so the sum is deterministic
(experts in order).

Not a Pallas kernel in the JAX package (XLA einsums), so plain torch here,
as is training's load-balancing loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from modelx_tpu_torch.ops.nn import linear as _linear


def router_topk(router_logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixtral-style routing: softmax over experts, keep the top k,
    renormalise. router_logits: [..., E]. Returns (probs [..., E], zero off
    the kept experts and summing to 1 over them; mask [..., E] as 0/1
    floats). Every expert whose probability ties the k-th largest is kept,
    so a tie may admit more than k, as in the JAX twin."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    threshold = torch.topk(probs, k, dim=-1).values[..., k - 1:k]
    mask = (probs >= threshold).to(probs.dtype)
    kept = probs * mask
    return kept / torch.clamp(kept.sum(-1, keepdim=True), min=1e-9), mask


def expert_capacity(seq: int, num_experts: int, k: int, capacity_factor: float) -> int:
    """Per-expert token budget C for one batch row."""
    c = int(capacity_factor * seq * k / num_experts + 0.5)
    return max(1, min(seq, c))


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T as fp32, not rounded to x's dtype (the twin's
    ``preferred_element_type=float32``)."""
    if x.dtype == torch.float32 or not x.is_cuda:
        return F.linear(x.float(), w.float())
    y = torch.mm(x.reshape(-1, x.shape[-1]), w.T, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[0])


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
            w3: torch.Tensor, *, top_k: int, capacity_factor: float = 0.0) -> torch.Tensor:
    """Sparse MoE FFN with SwiGLU experts. x: [B, S, D]; gate_w: [E, D]
    (the router, torch Linear layout); w1/w3: [E, F, D] (gate/up), w2:
    [E, D, F] (down), stacked. Returns [B, S, D] in x's dtype.

    Each expert's rows and their count are read back to the host to slice
    them: the card's queue drains once a layer."""
    b, s, d = x.shape
    e = gate_w.shape[0]
    c = s if capacity_factor <= 0 else expert_capacity(s, e, top_k, capacity_factor)
    probs, mask = router_topk(_f32_product(x, gate_w), top_k)  # [B, S, E]
    pos = torch.cumsum(mask, dim=1) * mask - 1.0  # slot in its expert's buffer, -1 unrouted
    in_cap = (pos >= 0) & (pos < c)
    combine = torch.where(in_cap, probs, 0.0).to(x.dtype).reshape(b * s, e)
    routed = in_cap.reshape(b * s, e).T  # [E, B*S]
    counts = routed.sum(dim=1).tolist()
    rows = torch.nonzero(routed)[:, 1]  # token indices, expert-major, in order
    xf = x.reshape(b * s, d)
    out = torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    lo = 0
    for ei, n in enumerate(counts):
        if n == 0:
            continue
        idx = rows[lo:lo + n]
        lo += n
        xe = xf[idx]
        h = F.silu(_linear(xe, w1[ei])) * _linear(xe, w3[ei])
        ye = _linear(h, w2[ei])
        out.index_add_(0, idx, combine[idx, ei, None].float() * ye.float())
    return out.to(x.dtype).reshape(b, s, d)


def load_balancing_loss(router_logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss: E * sum_e f_e * p_e,
    where f_e = fraction of tokens routed to expert e, p_e = mean router
    probability; fp32. router_logits/mask: [..., E] (counterpart of
    ``modelx_tpu/ops/moe.py:104``)."""
    e = router_logits.shape[-1]
    probs = torch.softmax(router_logits.float(), dim=-1).reshape(-1, e)
    frac = mask.reshape(-1, e).float()
    return e * torch.sum(frac.mean(0) * probs.mean(0))
