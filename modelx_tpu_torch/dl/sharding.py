"""Checkpoint family detection and the shard-layout rules, as plain JSON.

The port's own copy of ``modelx_tpu/dl/sharding.py``'s table half:
``infer_family :212``, ``encode_rules :30``, ``rules_for_family :205`` and
the family rule sets. A rule is ``[regex, partition_spec]`` (first match
wins), partition_spec one entry per tensor dimension: an axis name, a list
of axis names, or null for replicated. A push writes them into the
``modelx.shard.spec`` annotation (``client/push.py``), byte for byte as the
JAX package's push does.

The mesh half (``spec_for :38``, ``clean_spec :48``, ``sharding_for :64``,
``cache_sharding :70``) answers, instead of a ``NamedSharding``, the index
slice one rank holds: ``Sharding.index(shape, coord)`` is what the
reference's ``devices_indices_map`` gives the device at that mesh
coordinate. A spec is a tuple with one entry per dimension (None, an axis
name, or a tuple of axis names, split major to minor); an axis splits a
dimension only when the mesh has it and its size divides the dimension,
else the dimension replicates.
"""

from __future__ import annotations

import json
import logging
import math
import re
from typing import Sequence

logger = logging.getLogger("modelx.dl")

Rules = list[tuple[str, list]]


def encode_rules(rules: Rules) -> str:
    return json.dumps([[pattern, spec] for pattern, spec in rules])


def decode_rules(payload: str) -> Rules:
    return [(pattern, spec) for pattern, spec in json.loads(payload)]


# -- the mesh half ------------------------------------------------------------

Spec = tuple  # one entry per dimension: None | axis name | tuple of axis names


def spec_for(name: str, rules: Rules) -> Spec:
    """First-match-wins lookup of a tensor's spec."""
    for pattern, spec in rules:
        if re.search(pattern, name):
            return tuple(tuple(s) if isinstance(s, list) else s for s in spec)
    return ()


def clean_spec(spec: Spec, mesh) -> Spec:
    """Drop axis names the mesh doesn't have (e.g. tp rules on a dp-only mesh)."""
    cleaned = []
    for entry in spec:
        if entry is None:
            cleaned.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in mesh.axis_names)
            cleaned.append(kept if kept else None)
        else:
            cleaned.append(entry if entry in mesh.axis_names else None)
    return tuple(cleaned)


class Sharding:
    """A spec on a mesh: which slice of a tensor each rank holds."""

    def __init__(self, mesh, spec: Spec) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"

    def _axes(self, dim: int, size: int) -> tuple[str, ...]:
        entry = self.spec[dim] if dim < len(self.spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(self.mesh.shape.get(a, 1) for a in axes)
        return axes if n > 1 and size % n == 0 else ()

    def placed_spec(self, shape: Sequence[int]) -> Spec:
        """The spec as placed on ``shape``: indivisible dims replicate."""
        out = []
        for dim, size in enumerate(shape):
            axes = self._axes(dim, size)
            out.append(None if not axes else (axes[0] if len(axes) == 1 else axes))
        return tuple(out)

    def index(self, shape: Sequence[int], coord: dict[str, int] | None = None) -> tuple:
        """The slices (one per dim) of ``shape`` the rank at ``coord``
        (default: this rank's) holds."""
        coord = self.mesh.coord if coord is None else coord
        out = []
        for dim, size in enumerate(shape):
            axes = self._axes(dim, size)
            chunk, at = size, 0
            for a in axes:  # major to minor
                chunk //= self.mesh.shape[a]
                at = at * self.mesh.shape[a] + (coord or {}).get(a, 0)
            out.append(slice(at * chunk, (at + 1) * chunk))
        return tuple(out)

    def indices_map(self, shape: Sequence[int]) -> dict[int, tuple]:
        """rank -> its slices, over every rank of the mesh."""
        names = tuple(self.mesh.shape)
        out = {}
        for rank in range(self.mesh.size):
            idx, coord = rank, {}
            for name in reversed(names):
                coord[name] = idx % self.mesh.shape[name]
                idx //= self.mesh.shape[name]
            out[rank] = self.index(shape, coord)
        return out

    def is_fully_replicated(self, shape: Sequence[int]) -> bool:
        return all(s is None for s in self.placed_spec(shape))


def sharding_for(name: str, rules: Rules, mesh) -> Sharding:
    return Sharding(mesh, clean_spec(spec_for(name, rules), mesh))


def cache_sharding(mesh, shape: Sequence[int], batch_dim: int = 0,
                   head_dim: int = 2) -> Sharding:
    """One KV-cache leaf: slots over dp, kv heads over tp, each axis applied
    only when the mesh has it AND its size divides the dimension (GQA head
    counts and tiny test models routinely don't divide; an indivisible dim
    replicates rather than erroring). ``batch_dim=-1`` for pooled/paged
    leaves whose leading dim is a global page index no axis may split."""
    spec: list = [None] * len(shape)

    def _assign(axis: str, dim: int) -> None:
        size = mesh.shape.get(axis, 1)
        if 0 <= dim < len(shape) and size > 1 and shape[dim] % size == 0:
            spec[dim] = axis

    _assign("dp", batch_dim)
    _assign("tp", head_dim)
    return Sharding(mesh, tuple(spec))


# -- default rule sets --------------------------------------------------------

# Llama-family (HF safetensors names). Megatron-style: attention q/k/v and
# ffn up/gate column-parallel (shard dim 0, the output features), o_proj and
# down_proj row-parallel (shard dim 1), embeddings sharded over vocab.
LLAMA_RULES: Rules = [
    (r"embed_tokens\.weight$", ["tp", None]),
    (r"lm_head\.weight$", ["tp", None]),
    (r"(q|k|v)_proj\.weight$", ["tp", None]),
    (r"o_proj\.weight$", [None, "tp"]),
    (r"(gate|up)_proj\.weight$", ["tp", None]),
    (r"down_proj\.weight$", [None, "tp"]),
    (r"norm\.weight$", [None]),
    (r".*", []),
]

# Qwen2 (HF names): llama's layout plus q/k/v input biases, which split
# with their column-parallel weights' output features (dim 0 over tp).
QWEN2_RULES: Rules = [
    (r"(q|k|v)_proj\.bias$", ["tp"]),
    *LLAMA_RULES,
]

# Gemma2 (HF names): llama's projection layout; the extra sandwich norms
# (pre/post_feedforward_layernorm) are 1-D and replicate via the norm rule.
GEMMA2_RULES: Rules = LLAMA_RULES

# Phi-3 (HF names): llama with FUSED qkv_proj / gate_up_proj, whose
# output rows shard over tp like their unfused counterparts.
PHI3_RULES: Rules = [
    (r"embed_tokens\.weight$", ["tp", None]),
    (r"lm_head\.weight$", ["tp", None]),
    (r"qkv_proj\.weight$", ["tp", None]),
    (r"o_proj\.weight$", [None, "tp"]),
    (r"gate_up_proj\.weight$", ["tp", None]),
    (r"down_proj\.weight$", [None, "tp"]),
    (r"norm\.weight$", [None]),
    (r".*", []),
]

# GPT-2 (HF names; Conv1D weights are [in, out] so column-parallel = dim 1).
GPT2_RULES: Rules = [
    (r"wte\.weight$", ["tp", None]),
    (r"wpe\.weight$", [None, None]),
    (r"c_attn\.weight$", [None, "tp"]),
    (r"c_attn\.bias$", ["tp"]),
    (r"attn\.c_proj\.weight$", ["tp", None]),
    (r"c_fc\.weight$", [None, "tp"]),
    (r"c_fc\.bias$", ["tp"]),
    (r"mlp\.c_proj\.weight$", ["tp", None]),
    (r".*", []),
]

# BERT (HF names).
BERT_RULES: Rules = [
    (r"word_embeddings\.weight$", ["tp", None]),
    (r"(query|key|value)\.weight$", ["tp", None]),
    (r"(query|key|value)\.bias$", ["tp"]),
    (r"attention\.output\.dense\.weight$", [None, "tp"]),
    (r"intermediate\.dense\.weight$", ["tp", None]),
    (r"intermediate\.dense\.bias$", ["tp"]),
    (r"output\.dense\.weight$", [None, "tp"]),
    (r".*", []),
]

# Mixtral (llama attention + stacked-expert MoE FFN; models/mixtral.py).
# Expert axis over ep, expert ffn features over tp within each expert.
MIXTRAL_RULES: Rules = [
    (r"embed_tokens\.weight$", ["tp", None]),
    (r"lm_head\.weight$", ["tp", None]),
    (r"(q|k|v)_proj\.weight$", ["tp", None]),
    (r"o_proj\.weight$", [None, "tp"]),
    (r"block_sparse_moe\.gate\.weight$", [None, None]),
    (r"experts\.(w1|w3)\.weight$", ["ep", "tp", None]),
    (r"experts\.w2\.weight$", ["ep", None, "tp"]),
    (r"norm\.weight$", [None]),
    (r".*", []),
]

DEFAULT_RULES: dict[str, Rules] = {
    "llama": LLAMA_RULES,
    "qwen2": QWEN2_RULES,
    "gemma2": GEMMA2_RULES,
    "phi3": PHI3_RULES,
    "gpt2": GPT2_RULES,
    "bert": BERT_RULES,
    "mixtral": MIXTRAL_RULES,
}


def rules_for_family(family: str) -> Rules:
    return DEFAULT_RULES.get(family, [(r".*", [])])


def infer_family(tensor_names: Sequence[str]) -> str:
    """Family name from tensor names; "" when no family matches."""
    joined = "\n".join(tensor_names)
    if "block_sparse_moe" in joined:
        return "mixtral"
    if "pre_feedforward_layernorm" in joined:
        # llama layout + sandwich norms: gemma2 — but gemma3 also carries
        # them, adding per-head q_norm/k_norm attention norms that gemma2's
        # math doesn't have; refuse instead of mis-serving it
        if "q_norm" in joined or "k_norm" in joined:
            logger.warning(
                "checkpoint has gemma2-style sandwich norms AND q_norm/"
                "k_norm attention-norm tensors (gemma3?): refusing the "
                "gemma2 family match — these layer tensors are not part "
                "of any supported architecture"
            )
            return ""
        return "gemma2"
    if "qkv_proj" in joined:
        return "phi3"  # llama layout with fused qkv/gate_up projections
    if "q_proj.bias" in joined:
        return "qwen2"  # llama layout + qkv biases
    if "q_proj" in joined or "gate_proj" in joined:
        return "llama"
    if "c_attn" in joined or "wte" in joined:
        return "gpt2"
    if "word_embeddings" in joined:
        return "bert"
    return ""
