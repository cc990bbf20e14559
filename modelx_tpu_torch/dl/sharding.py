"""Checkpoint family detection and the shard-layout rules, as plain JSON.

The port's own copy of ``modelx_tpu/dl/sharding.py``'s table half:
``infer_family :212``, ``encode_rules :30``, ``rules_for_family :205`` and
the family rule sets. A rule is ``[regex, partition_spec]`` (first match
wins), partition_spec one entry per tensor dimension: an axis name, a list
of axis names, or null for replicated. A push writes them into the
``modelx.shard.spec`` annotation (``client/push.py``), byte for byte as the
JAX package's push does; the one-card loader reads the annotation and has
nothing to place. The mesh helpers beside them in the JAX package come
with the multi-device slice.
"""

from __future__ import annotations

import json
import logging
from typing import Sequence

logger = logging.getLogger("modelx.dl")

Rules = list[tuple[str, list]]


def encode_rules(rules: Rules) -> str:
    return json.dumps([[pattern, spec] for pattern, spec in rules])


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
