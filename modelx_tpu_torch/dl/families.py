"""Model-family registry for the serving path: checkpoint tensor names ->
(config inference, forward/generate adapters).

Counterpart of ``modelx_tpu/dl/families.py``. The checkpoint describes
itself: ``infer_config`` recovers the architecture from tensor shapes and
``apply_sidecar_config`` reconciles it with a pulled ``config.json``. This
slice registers ``llama`` and ``qwen2``; the other families the JAX package
serves raise "not yet ported".
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Callable

import torch

from modelx_tpu_torch.dl.sharding import infer_family

# families the JAX package serves that later slices port
NOT_YET_PORTED = ("gemma2", "phi3", "mixtral", "gpt2", "bert")


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    infer_config: Callable[[dict], Any]
    forward: Callable[..., torch.Tensor]  # (params, tokens, cfg) -> logits
    generate: Callable[..., torch.Tensor] | None = None  # causal LMs only
    # ragged-batch greedy decode (params, prompt, row_lens, cfg,
    # max_new_tokens) -> generated [B, max_new]
    generate_ragged: Callable[..., torch.Tensor] | None = None


def _shape(params: dict, name: str) -> tuple[int, ...]:
    return tuple(params[name].shape)


def _act_dtype(params: dict, name: str) -> torch.dtype:
    """Activation dtype for a checkpoint: the (float) dtype of its embedding
    weight; non-float storage computes in bfloat16."""
    dt = params[name].dtype
    return dt if dt.is_floating_point else torch.bfloat16


def abstract_params(infos: dict) -> dict[str, torch.Tensor]:
    """Meta tensors (shape and dtype, no storage) for a checkpoint known only
    by its header: everything config inference needs before a byte loads."""
    return {
        name: torch.empty(info.shape, dtype=info.torch_dtype(), device="meta")
        for name, info in infos.items()
    }


# -- llama --------------------------------------------------------------------


def infer_llama_config(params: dict):
    """Recover the architecture from checkpoint tensor shapes."""
    from modelx_tpu_torch.models import llama

    vocab, hidden = _shape(params, "model.embed_tokens.weight")
    layers = 0
    while f"model.layers.{layers}.self_attn.q_proj.weight" in params:
        layers += 1
    q = _shape(params, "model.layers.0.self_attn.q_proj.weight")[0]
    kv = _shape(params, "model.layers.0.self_attn.k_proj.weight")[0]
    inter = _shape(params, "model.layers.0.mlp.gate_proj.weight")[0]
    # head_dim heuristics: big models use 128 (llama/mistral/qwen2-7B+)
    # unless that would leave fewer than 2 kv heads. kv=128 is ambiguous —
    # MQA-128 (32 q heads x 1 kv head, e.g. q=4096) vs qwen2-0.5B (14 x 64,
    # 2 kv heads, q=896) — so 128 also wins when the checkpoint is clearly
    # big (q//128 >= 8), while 0.5B-class models (q//128 == 7) fall to 64
    if q % 128 == 0 and kv % 128 == 0 and (kv // 128 >= 2 or q // 128 >= 8):
        head_dim = 128
    elif q % 64 == 0 and kv % 64 == 0 and kv // 64 >= 2:
        head_dim = 64
    else:
        head_dim = max(q // 32, 32)
    if hidden <= 512:  # toy checkpoints
        head_dim = 32
    return llama.LlamaConfig(
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=inter,
        num_layers=layers,
        num_heads=q // head_dim,
        num_kv_heads=kv // head_dim,
        head_dim=head_dim,
        tie_embeddings="lm_head.weight" not in params,
        dtype=_act_dtype(params, "model.embed_tokens.weight"),
    )


def infer_qwen2_config(params: dict):
    """Qwen2 = llama's decoder with qkv input biases, plus qwen2's constants
    (rms eps 1e-6, rope theta 1e6), which shapes cannot reveal."""
    cfg = infer_llama_config(params)
    return dataclasses.replace(cfg, qkv_bias=True, rms_eps=1e-6, rope_theta=1_000_000.0)


def _llama_forward(params, tokens, cfg):
    from modelx_tpu_torch.models import llama

    return llama.forward(params, tokens, cfg)[0]


def _llama_generate(params, tokens, cfg, max_new_tokens=16):
    from modelx_tpu_torch.models import llama

    return llama.greedy_generate(params, tokens, cfg, max_new_tokens=max_new_tokens)


def _llama_generate_ragged(params, tokens, row_lens, cfg, max_new_tokens=16):
    from modelx_tpu_torch.models import llama

    return llama.ragged_greedy_generate(params, tokens, row_lens, cfg,
                                        max_new_tokens=max_new_tokens)


FAMILIES: dict[str, Family] = {
    "llama": Family("llama", infer_llama_config, _llama_forward, _llama_generate,
                    _llama_generate_ragged),
    # qwen2 differs only in config (biases ride the param dict), so every
    # llama entry point serves it unchanged
    "qwen2": Family("qwen2", infer_qwen2_config, _llama_forward, _llama_generate,
                    _llama_generate_ragged),
}


logger = logging.getLogger("modelx.serve")


def sidecar_config(model_dir: str) -> dict | None:
    """The checkpoint's pulled ``config.json`` (the HF sidecar), if any.
    Shape inference recovers the architecture but NOT the RoPE parameters."""
    try:
        with open(os.path.join(model_dir, "config.json")) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    return raw if isinstance(raw, dict) else None


# rope_scaling schemes that reshape position encoding at EVERY position:
# serving them with plain RoPE is wrong from token 0, so they refuse.
# Other schemes (llama3 / linear / dynamic-ntk) match plain RoPE inside the
# original context window — those warn and serve.
_ROPE_SCALING_REFUSED = ("longrope", "su", "yarn")


def apply_sidecar_config(cfg, sidecar: dict, family_name: str):
    """Reconcile a shape-inferred config with the checkpoint's config.json:
    longrope/su/yarn ``rope_scaling`` refuses, other schemes warn, and a
    numeric ``rope_theta`` replaces the inferred default."""
    scaling = sidecar.get("rope_scaling")
    if scaling:
        stype = (
            scaling.get("type") or scaling.get("rope_type")
            if isinstance(scaling, dict) else scaling
        )
        if not isinstance(stype, str) or stype.lower() in _ROPE_SCALING_REFUSED:
            raise ValueError(
                f"{family_name} checkpoint's config.json declares "
                f"rope_scaling ({stype!r}); this runtime implements "
                "unscaled RoPE only — refusing to mis-serve a long-context "
                "checkpoint (e.g. phi-3-*-128k)"
            )
        logger.warning(
            "%s config.json declares rope_scaling %r: not implemented — "
            "serving is exact only within the pre-scaling context window",
            family_name, stype,
        )
    theta = sidecar.get("rope_theta")
    if theta is not None and hasattr(cfg, "rope_theta"):
        try:
            theta = float(theta)
        except (TypeError, ValueError):
            logger.warning(
                "%s config.json rope_theta=%r is not numeric; keeping the "
                "inferred %s", family_name, theta, cfg.rope_theta,
            )
            return cfg
        if theta != float(cfg.rope_theta):
            logger.warning(
                "%s config.json rope_theta=%s overrides the shape-inferred %s",
                family_name, theta, cfg.rope_theta,
            )
            cfg = dataclasses.replace(cfg, rope_theta=theta)
    return cfg


def detect(tensor_names) -> Family:
    """Family from tensor names; raises for unrecognized checkpoints and for
    families a later slice ports."""
    names = list(tensor_names)
    name = infer_family(names)
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model family {name!r} is not yet ported to modelx_tpu_torch "
            f"(ported: {sorted(FAMILIES)})"
        )
    if not name or name not in FAMILIES:
        raise ValueError(
            f"cannot determine model family from tensors ({names[:4]}...); "
            f"supported: {sorted(FAMILIES)}"
        )
    return FAMILIES[name]
