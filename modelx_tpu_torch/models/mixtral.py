"""Mixtral-family sparse-MoE decoder: llama's attention and a MoE FFN
(counterpart of ``modelx_tpu/models/mixtral.py``).

Params are a flat dict keyed by HF safetensors names, with the per-expert
FFN weights STACKED along a leading E axis, as the JAX twin keeps them:

    model.layers.N.block_sparse_moe.gate.weight        [E, D]
    model.layers.N.block_sparse_moe.experts.w1.weight  [E, F, D]   (gate)
    model.layers.N.block_sparse_moe.experts.w2.weight  [E, D, F]   (down)
    model.layers.N.block_sparse_moe.experts.w3.weight  [E, F, D]   (up)

The loader folds HF's ``experts.<i>.wN.weight`` tensors into this layout
(``dl/loader.fuse_expert_tensors``); ``from_hf_state_dict`` does the same
for arrays in memory. Each block is ``llama.decoder_layer`` with the MoE
block (``ops/moe.py``) as its ``mlp_fn``, so the cache-free forward runs
the flash kernel on the card, and the cached, ragged and paged decodes are
llama's.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from modelx_tpu_torch.models import decode, llama
from modelx_tpu_torch.ops import moe as moe_ops
from modelx_tpu_torch.ops.nn import linear as _linear


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 0.0  # <= 0: drop-free (exact Mixtral math)
    rope_theta: float = 1000000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def mixtral_8x7b(cls) -> "MixtralConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "MixtralConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            num_experts=4, top_k=2, rope_theta=10000.0,
        )


# the attention half of a layer: llama's params without its dense FFN
ATTN_SUFFIXES = tuple(s for s in llama.LAYER_PARAM_SUFFIXES if not s.startswith("mlp."))


def param_shapes(cfg: MixtralConfig) -> dict[str, tuple[int, ...]]:
    e, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    f, ne = cfg.intermediate_size, cfg.num_experts
    shapes: dict[str, tuple[int, ...]] = {
        "model.embed_tokens.weight": (cfg.vocab_size, e),
        "model.norm.weight": (e,),
        "lm_head.weight": (cfg.vocab_size, e),
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "self_attn.q_proj.weight": (q, e),
            p + "self_attn.k_proj.weight": (kv, e),
            p + "self_attn.v_proj.weight": (kv, e),
            p + "self_attn.o_proj.weight": (e, q),
            p + "block_sparse_moe.gate.weight": (ne, e),
            p + "block_sparse_moe.experts.w1.weight": (ne, f, e),
            p + "block_sparse_moe.experts.w2.weight": (ne, e, f),
            p + "block_sparse_moe.experts.w3.weight": (ne, f, e),
            p + "input_layernorm.weight": (e,),
            p + "post_attention_layernorm.weight": (e,),
        })
    return shapes


def init_params(cfg: MixtralConfig, generator: torch.Generator, dtype=None,
                device=None) -> dict[str, torch.Tensor]:
    """Random params from ``generator``: norms are ones, weights
    N(0, 1/fan_in) (fan_in the last axis)."""
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


_HF_EXPERT = re.compile(
    r"^(model\.layers\.\d+\.block_sparse_moe\.experts)\.(\d+)\.(w[123])\.weight$")


def from_hf_state_dict(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Fold HF Mixtral names (experts.<i>.wN.weight) into stacked tensors."""
    out: dict[str, np.ndarray] = {}
    experts: dict[str, dict[int, np.ndarray]] = {}
    for name, value in sd.items():
        m = _HF_EXPERT.match(name)
        if m:
            experts.setdefault(f"{m.group(1)}.{m.group(3)}.weight", {})[int(m.group(2))] = \
                np.asarray(value)
        else:
            out[name] = np.asarray(value)
    for name, parts in experts.items():
        out[name] = np.stack([parts[i] for i in range(len(parts))])
    return out


def _attn_config(cfg: MixtralConfig) -> llama.LlamaConfig:
    return llama.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        rms_eps=cfg.rms_eps, dtype=cfg.dtype)


def forward(params: dict, tokens: torch.Tensor, cfg: MixtralConfig, kv_cache: dict | None = None,
            cache_offset=0, attention_impl: str = "auto",
            paged_table: torch.Tensor | None = None, paged_blocks: int | None = None,
            ) -> tuple[torch.Tensor, dict | None]:
    """Returns (logits [B, S, V], kv_cache written in place, or None): the
    contract of ``llama.forward``, paged decode included; the FFN is the
    sparse-MoE block."""
    acfg = _attn_config(cfg)
    positions = llama.positions_for(tokens, kv_cache is not None, cache_offset)
    x = F.embedding(tokens, params["model.embed_tokens.weight"]).to(cfg.dtype)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {suffix: params[p + suffix] for suffix in ATTN_SUFFIXES}

        def moe_fn(h, p=p):
            return moe_ops.moe_ffn(
                h, params[p + "block_sparse_moe.gate.weight"],
                params[p + "block_sparse_moe.experts.w1.weight"],
                params[p + "block_sparse_moe.experts.w2.weight"],
                params[p + "block_sparse_moe.experts.w3.weight"],
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)

        cache = (kv_cache[f"k{i}"], kv_cache[f"v{i}"]) if kv_cache is not None else None
        x, _ = llama.decoder_layer(lp, x, positions, acfg, cache=cache, cache_offset=cache_offset,
                                   attention_impl=attention_impl, paged_table=paged_table,
                                   paged_blocks=paged_blocks, mlp_fn=moe_fn)
    x = llama._rms_norm(x, params["model.norm.weight"], cfg.rms_eps)
    return _linear(x, params["lm_head.weight"]), kv_cache


def init_kv_cache(cfg: MixtralConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    return llama.init_kv_cache(_attn_config(cfg), batch, max_len, dtype=dtype, device=device)


def decode_fns(params, cfg: MixtralConfig):
    """(forward, init_kv_cache) for ``models/decode.py``."""
    return decode.family_fns(forward, init_kv_cache, cfg,
                             params["model.embed_tokens.weight"].device)


def paged_decode_fns(params, cfg: MixtralConfig):
    """The forward over PAGED kv pools (the continuous engine's in-place step)."""
    return decode.paged_family_fn(forward, cfg)


def ragged_greedy_generate(params, prompt, row_lens, cfg: MixtralConfig,
                           max_new_tokens: int = 16, temperature=None, top_k=None, top_p=None,
                           seeds=None):
    """Ragged-batch decode, greedy or per-row-sampled (models/decode.py)."""
    return decode.ragged_greedy_generate(
        *decode_fns(params, cfg), params, prompt, row_lens, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, seeds=seeds)
