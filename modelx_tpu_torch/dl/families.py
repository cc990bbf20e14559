"""Model-family registry for the serving path: checkpoint tensor names ->
(config inference, forward/generate adapters).

Counterpart of ``modelx_tpu/dl/families.py``. The checkpoint describes
itself: ``infer_config`` recovers the architecture from tensor shapes and
``apply_sidecar_config`` reconciles it with a pulled ``config.json``. The
generative families (llama, qwen2, phi3, gemma2, mixtral, gpt2) and the
encoder, bert, are registered; bert has no decode entry points, so a
generate on it is refused as the JAX sidecar refuses it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Callable

import torch

from modelx_tpu_torch.dl.sharding import infer_family


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    infer_config: Callable[[dict], Any]
    forward: Callable[..., torch.Tensor]  # (params, tokens, cfg) -> logits
    # ragged-batch decode (params, prompt, row_lens, cfg, max_new_tokens,
    # temperature=, top_k=, top_p=, seeds=) -> generated [B, max_new]
    generate_ragged: Callable[..., torch.Tensor] | None = None
    # (params, cfg) -> (forward, init_kv_cache) for models/decode.py's
    # ChunkedDecoder (streams) and the continuous engine; None = the family
    # does not stream and the engine refuses it
    decode_fns: Callable[..., tuple] | None = None
    # (params, cfg) -> forward over PAGED kv pools (kv_cache = page pools +
    # a block table; ops/paged_attention.py reads them in place): the
    # continuous engine's in-place paged chunk step; None = the engine
    # keeps its dense-gather chunk for this family
    paged_decode_fns: Callable[..., Callable] | None = None


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


# -- phi3 ---------------------------------------------------------------------


def infer_phi3_config(params: dict):
    """Phi-3's fused shapes: qkv rows = q + 2*kv with q == hidden in every
    released dense variant (mini 32 x 96, medium 40 x 128). head_dim:
    medium's GQA (kv rows != hidden) means 128; mini's MHA means hidden/32
    = 96. Returns a ``llama.LlamaConfig`` (the module reuses llama's
    decoder). rope_theta 10000 is the 4k variants'; the 128k variants'
    longrope scaling leaves no trace in shapes, and
    ``apply_sidecar_config`` refuses it from the pulled config.json."""
    from modelx_tpu_torch.models import llama

    vocab, hidden = _shape(params, "model.embed_tokens.weight")
    layers = 0
    while f"model.layers.{layers}.self_attn.qkv_proj.weight" in params:
        layers += 1
    qkv_rows = _shape(params, "model.layers.0.self_attn.qkv_proj.weight")[0]
    inter = _shape(params, "model.layers.0.mlp.gate_up_proj.weight")[0] // 2
    kv_rows = (qkv_rows - hidden) // 2
    if hidden <= 512:  # toy checkpoints: 4 q heads by convention
        head_dim = max(hidden // 4, 8)
    elif kv_rows != hidden:  # GQA (phi-3-medium): 128 everywhere released
        head_dim = 128
    else:  # MHA (phi-3-mini): 32 heads of hidden/32
        head_dim = hidden // 32
    return llama.LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
        num_layers=layers, num_heads=hidden // head_dim,
        num_kv_heads=kv_rows // head_dim, head_dim=head_dim,
        rope_theta=10000.0, rms_eps=1e-5, tie_embeddings=False,
        dtype=_act_dtype(params, "model.embed_tokens.weight"),
    )


# -- gemma2 -------------------------------------------------------------------


def infer_gemma2_config(params: dict):
    """Gemma2's shapes are llama-like; head_dim is 256 in every released
    checkpoint but 27b's (hidden 4608: head_dim 128, query_pre_attn_scalar
    hidden/heads = 144 instead of head_dim). The softcaps and the 4096
    sliding window are architecture constants that shapes cannot reveal."""
    from modelx_tpu_torch.models import gemma2

    vocab, hidden = _shape(params, "model.embed_tokens.weight")
    layers = 0
    while f"model.layers.{layers}.self_attn.q_proj.weight" in params:
        layers += 1
    q = _shape(params, "model.layers.0.self_attn.q_proj.weight")[0]
    kv = _shape(params, "model.layers.0.self_attn.k_proj.weight")[0]
    inter = _shape(params, "model.layers.0.mlp.gate_proj.weight")[0]
    if hidden <= 512:  # toy checkpoints
        head_dim, qpas, window = 32, 32.0, 16
    elif hidden >= 4608:  # gemma2-27b
        head_dim, window = 128, 4096
        qpas = float(hidden // (q // head_dim))
    else:  # 2b / 9b
        head_dim, qpas, window = 256, 256.0, 4096
    return gemma2.Gemma2Config(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
        num_layers=layers, num_heads=q // head_dim,
        num_kv_heads=kv // head_dim, head_dim=head_dim,
        query_pre_attn_scalar=qpas, sliding_window=window,
        dtype=_act_dtype(params, "model.embed_tokens.weight"),
    )


# -- mixtral ------------------------------------------------------------------


def infer_mixtral_config(params: dict):
    """Mixtral's stacked expert shapes ([E, F, D], folded by the loader)
    give the expert count and width; top-2 routing and rope theta 1e6 are
    the config's defaults."""
    from modelx_tpu_torch.models import mixtral

    vocab, hidden = _shape(params, "model.embed_tokens.weight")
    layers = 0
    while f"model.layers.{layers}.self_attn.q_proj.weight" in params:
        layers += 1
    q = _shape(params, "model.layers.0.self_attn.q_proj.weight")[0]
    kv = _shape(params, "model.layers.0.self_attn.k_proj.weight")[0]
    num_experts, inter, _ = _shape(params, "model.layers.0.block_sparse_moe.experts.w1.weight")
    head_dim = 128 if q % 128 == 0 and q // 128 >= 8 else max(q // 32, 32)
    if hidden <= 512:
        head_dim = 32
    return mixtral.MixtralConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
        num_layers=layers, num_heads=q // head_dim, num_kv_heads=kv // head_dim,
        head_dim=head_dim, num_experts=num_experts,
        dtype=_act_dtype(params, "model.embed_tokens.weight"),
    )


# -- gpt2 ---------------------------------------------------------------------


def infer_gpt2_config(params: dict):
    """GPT-2: hidden/64 heads (4 for toy checkpoints); ``n_positions`` is
    the learned position table's length."""
    from modelx_tpu_torch.models import gpt2

    vocab, hidden = _shape(params, "wte.weight")
    n_pos = _shape(params, "wpe.weight")[0]
    layers = 0
    while f"h.{layers}.attn.c_attn.weight" in params:
        layers += 1
    num_heads = max(hidden // 64, 1)
    if hidden <= 128:  # toy checkpoints
        num_heads = 4
    return gpt2.GPT2Config(
        vocab_size=vocab, n_positions=n_pos, hidden_size=hidden,
        num_layers=layers, num_heads=num_heads,
        dtype=_act_dtype(params, "wte.weight"),
    )


# -- bert ---------------------------------------------------------------------


def infer_bert_config(params: dict):
    """BERT: hidden/64 heads (4 for toy checkpoints, hidden <= 128); the
    position and token-type tables give their sizes."""
    from modelx_tpu_torch.models import bert

    vocab, hidden = _shape(params, "bert.embeddings.word_embeddings.weight")
    max_pos = _shape(params, "bert.embeddings.position_embeddings.weight")[0]
    type_vocab = _shape(params, "bert.embeddings.token_type_embeddings.weight")[0]
    layers = 0
    while f"bert.encoder.layer.{layers}.attention.self.query.weight" in params:
        layers += 1
    inter = _shape(params, "bert.encoder.layer.0.intermediate.dense.weight")[0]
    num_heads = max(hidden // 64, 1)
    if hidden <= 128:
        num_heads = 4
    return bert.BertConfig(
        vocab_size=vocab, hidden_size=hidden, num_layers=layers,
        num_heads=num_heads, intermediate_size=inter,
        max_position_embeddings=max_pos, type_vocab_size=type_vocab,
        dtype=_act_dtype(params, "bert.embeddings.word_embeddings.weight"),
    )


def _bert_forward(params, tokens, cfg):
    """The sequence output [B, S, E]: an encoder's "logits" are features
    (argmax over E is what ``/v1/forward`` answers, as in the JAX twin)."""
    from modelx_tpu_torch.models import bert

    return bert.forward(params, tokens, cfg)[0]


def _family(module: str) -> tuple:
    """(forward, generate_ragged, decode_fns, paged_decode_fns) adapters of
    ``modelx_tpu_torch.models.<module>``, imported on first call. The mesh
    arguments (``mesh=``, ``attention_impl=``) pass through to the llama
    module, the one family the mesh forward serves."""
    import importlib

    def mod():
        return importlib.import_module(f"modelx_tpu_torch.models.{module}")

    def forward(params, tokens, cfg, **mesh_kw):
        return mod().forward(params, tokens, cfg, **mesh_kw)[0]

    def generate_ragged(params, tokens, row_lens, cfg, max_new_tokens=16, **kw):
        return mod().ragged_greedy_generate(params, tokens, row_lens, cfg,
                                            max_new_tokens=max_new_tokens, **kw)

    def decode_fns(params, cfg, **mesh_kw):
        return mod().decode_fns(params, cfg, **mesh_kw)

    def paged_decode_fns(params, cfg, **mesh_kw):
        return mod().paged_decode_fns(params, cfg, **mesh_kw)

    return forward, generate_ragged, decode_fns, paged_decode_fns


FAMILIES: dict[str, Family] = {
    "llama": Family("llama", infer_llama_config, *_family("llama")),
    # qwen2 differs only in config (biases ride the param dict), so every
    # llama entry point serves it unchanged
    "qwen2": Family("qwen2", infer_qwen2_config, *_family("llama")),
    "phi3": Family("phi3", infer_phi3_config, *_family("phi3")),
    "gemma2": Family("gemma2", infer_gemma2_config, *_family("gemma2")),
    "mixtral": Family("mixtral", infer_mixtral_config, *_family("mixtral")),
    "gpt2": Family("gpt2", infer_gpt2_config, *_family("gpt2")),
    # the encoder: no decode entry points (generate is refused, no batcher,
    # no continuous engine)
    "bert": Family("bert", infer_bert_config, _bert_forward),
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
    """Family from tensor names; raises for unrecognized checkpoints."""
    names = list(tensor_names)
    name = infer_family(names)
    if not name or name not in FAMILIES:
        raise ValueError(
            f"cannot determine model family from tensors ({names[:4]}...); "
            f"supported: {sorted(FAMILIES)}"
        )
    return FAMILIES[name]
