"""Phi-3-family decoder, mini and medium dense variants (counterpart of
``modelx_tpu/models/phi3.py``).

Phi-3 is llama's architecture with FUSED projections in the checkpoint:
``self_attn.qkv_proj.weight`` packs [q | k | v] rows and
``mlp.gate_up_proj.weight`` packs [gate | up]; everything else (RMSNorm,
rope theta 1e4, the SwiGLU product, the untied lm_head, GQA) is the llama
decoder verbatim. So the forward slices the fused tensors into row views
(no copy; an int8 ``QTensor`` slices its per-row scales with its rows) and
runs ``llama.forward``: the flash kernel on the cache-free path (head_dim
96 for Phi-3-mini), the cached, ragged and paged decodes.

The config is ``llama.LlamaConfig``: phi-3's hyperparameters map onto it
exactly; only the checkpoint's tensor names differ.
"""

from __future__ import annotations

import math

import torch

from modelx_tpu_torch.models import llama
from modelx_tpu_torch.models.llama import LlamaConfig
from modelx_tpu_torch.ops.quant import QTensor


def param_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    e, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size
    shapes: dict[str, tuple[int, ...]] = {
        "model.embed_tokens.weight": (cfg.vocab_size, e),
        "model.norm.weight": (e,),
        "lm_head.weight": (cfg.vocab_size, e),
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "self_attn.qkv_proj.weight": (q + 2 * kv, e),
            p + "self_attn.o_proj.weight": (e, q),
            p + "mlp.gate_up_proj.weight": (2 * f, e),
            p + "mlp.down_proj.weight": (e, f),
            p + "input_layernorm.weight": (e,),
            p + "post_attention_layernorm.weight": (e,),
        })
    return shapes


def init_params(cfg: LlamaConfig, generator: torch.Generator, dtype=None,
                device=None) -> dict[str, torch.Tensor]:
    """Random params from ``generator``: norms are ones, weights
    N(0, 1/fan_in), as the JAX twin draws them (with other bits)."""
    dtype = dtype or cfg.dtype
    device = torch.device(device) if device is not None else generator.device
    params: dict[str, torch.Tensor] = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith("norm.weight"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        params[name] = x.mul_(1.0 / math.sqrt(shape[-1])).to(dtype)
    return params


def _slice_rows(w, lo: int, hi: int):
    """Rows [lo, hi) of a weight OR an int8 QTensor: per-output-row scales
    slice with the rows, so a fused quantized tensor un-fuses exactly."""
    if isinstance(w, QTensor):
        return QTensor(w.q[lo:hi], w.scale[lo:hi])
    return w[lo:hi]


def as_llama_params(params: dict, cfg: LlamaConfig) -> dict:
    """A fused phi3 checkpoint in llama's param vocabulary: the q/k/v and
    gate/up weights are row views of the fused tensors."""
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size
    out = {k: params[k] for k in ("model.embed_tokens.weight", "model.norm.weight",
                                  "lm_head.weight") if k in params}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        qkv = params[p + "self_attn.qkv_proj.weight"]
        gu = params[p + "mlp.gate_up_proj.weight"]
        out[p + "self_attn.q_proj.weight"] = _slice_rows(qkv, 0, qd)
        out[p + "self_attn.k_proj.weight"] = _slice_rows(qkv, qd, qd + kvd)
        out[p + "self_attn.v_proj.weight"] = _slice_rows(qkv, qd + kvd, qd + 2 * kvd)
        out[p + "mlp.gate_proj.weight"] = _slice_rows(gu, 0, f)
        out[p + "mlp.up_proj.weight"] = _slice_rows(gu, f, 2 * f)
        for suffix in ("self_attn.o_proj.weight", "mlp.down_proj.weight",
                       "input_layernorm.weight", "post_attention_layernorm.weight"):
            out[p + suffix] = params[p + suffix]
    return out


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, kv_cache: dict | None = None,
            cache_offset=0, attention_impl: str = "auto",
            paged_table: torch.Tensor | None = None, paged_blocks: int | None = None,
            ) -> tuple[torch.Tensor, dict | None]:
    """``llama.forward`` over the un-fused param views."""
    return llama.forward(as_llama_params(params, cfg), tokens, cfg, kv_cache=kv_cache,
                         cache_offset=cache_offset, attention_impl=attention_impl,
                         paged_table=paged_table, paged_blocks=paged_blocks)


init_kv_cache = llama.init_kv_cache


def decode_fns(params, cfg: LlamaConfig):
    """(forward, init_kv_cache) for ``models/decode.py``. The views of
    ``params`` are cut once here, not at every decode step."""
    views = as_llama_params(params, cfg)
    fwd, init = llama.decode_fns(views, cfg)

    def phi3_fwd(p, t, kv_cache, cache_offset):
        return fwd(views if p is params else as_llama_params(p, cfg), t, kv_cache, cache_offset)

    return phi3_fwd, init


def paged_decode_fns(params, cfg: LlamaConfig):
    """The forward over PAGED kv pools (the continuous engine's in-place step)."""
    views = as_llama_params(params, cfg)
    fwd = llama.paged_decode_fns(views, cfg)

    def phi3_fwd(p, t, kv_cache, cache_offset, table, n_blocks=None):
        return fwd(views if p is params else as_llama_params(p, cfg), t, kv_cache,
                   cache_offset, table, n_blocks)

    return phi3_fwd


def ragged_greedy_generate(params, prompt, row_lens, cfg: LlamaConfig, max_new_tokens: int = 16,
                           temperature=None, top_k=None, top_p=None, seeds=None):
    """Ragged-batch decode, greedy or per-row-sampled (models/decode.py);
    returns the generated tokens [B, max_new_tokens] only."""
    return llama.ragged_greedy_generate(
        as_llama_params(params, cfg), prompt, row_lens, cfg, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, seeds=seeds)
