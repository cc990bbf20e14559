"""Checkpoint family detection from tensor names.

The port's own copy of ``modelx_tpu/dl/sharding.py:212 infer_family``. The
mesh partition rules beside it in the JAX package come with the
multi-device slice.
"""

from __future__ import annotations

import logging
from typing import Sequence

logger = logging.getLogger("modelx.dl")


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
