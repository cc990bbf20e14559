"""BERT family (counterpart of ``modelx_tpu/models/bert.py``): the encoder.

Params keyed by HF safetensors names (``bert.embeddings.word_embeddings.weight``,
``bert.encoder.layer.N.attention.self.query.weight``, ...); linear weights
are [out, in] like llama's. Attention is bidirectional and runs the plain
``attention_reference``, as the JAX twin does (``bert.py:122``): bert
launches no kernel. Positions are a learned table of
``max_position_embeddings`` rows: ``forward`` refuses a longer sequence
before any device work (the JAX twin's gather past it fills NaN; on the
card the same gather is a device-side assert).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from modelx_tpu_torch.ops import attention as attn_ops
from modelx_tpu_torch.ops.nn import layer_norm as _layer_norm
from modelx_tpu_torch.ops.nn import linear as _linear


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @classmethod
    def bert_base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position_embeddings=64)


def param_shapes(cfg: BertConfig) -> dict[str, tuple[int, ...]]:
    e, f = cfg.hidden_size, cfg.intermediate_size
    shapes: dict[str, tuple[int, ...]] = {
        "bert.embeddings.word_embeddings.weight": (cfg.vocab_size, e),
        "bert.embeddings.position_embeddings.weight": (cfg.max_position_embeddings, e),
        "bert.embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, e),
        "bert.embeddings.LayerNorm.weight": (e,),
        "bert.embeddings.LayerNorm.bias": (e,),
        "bert.pooler.dense.weight": (e, e),
        "bert.pooler.dense.bias": (e,),
    }
    for i in range(cfg.num_layers):
        p = f"bert.encoder.layer.{i}."
        shapes.update({
            p + "attention.self.query.weight": (e, e),
            p + "attention.self.query.bias": (e,),
            p + "attention.self.key.weight": (e, e),
            p + "attention.self.key.bias": (e,),
            p + "attention.self.value.weight": (e, e),
            p + "attention.self.value.bias": (e,),
            p + "attention.output.dense.weight": (e, e),
            p + "attention.output.dense.bias": (e,),
            p + "attention.output.LayerNorm.weight": (e,),
            p + "attention.output.LayerNorm.bias": (e,),
            p + "intermediate.dense.weight": (f, e),
            p + "intermediate.dense.bias": (f,),
            p + "output.dense.weight": (e, f),
            p + "output.dense.bias": (e,),
            p + "output.LayerNorm.weight": (e,),
            p + "output.LayerNorm.bias": (e,),
        })
    return shapes


def init_params(cfg: BertConfig, generator: torch.Generator, dtype=None,
                device=None) -> dict[str, torch.Tensor]:
    """Random params from ``generator``: layer norms are ones, biases zeros,
    weights N(0, 0.02^2), as the JAX twin draws them (with other bits)."""
    dtype = dtype or cfg.dtype
    device = torch.device(device) if device is not None else generator.device
    params: dict[str, torch.Tensor] = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif "LayerNorm" in name:
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            params[name] = x.mul_(0.02).to(dtype)
    return params


def check_positions(cfg: BertConfig, seq_len: int) -> None:
    """A sequence longer than the learned position table has no embedding:
    refuse it before the gather (on the card an out-of-range index is a
    device-side assert that ends the CUDA context)."""
    if seq_len > cfg.max_position_embeddings:
        raise ValueError(f"prompt length {seq_len} exceeds the model's "
                         f"{cfg.max_position_embeddings}-position context")


def forward(params: dict, tokens: torch.Tensor, cfg: BertConfig,
            token_type_ids: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sequence_output [B, S, E], pooled_output [B, E])."""
    b, s = tokens.shape
    check_positions(cfg, s)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(tokens)
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = (F.embedding(tokens, params["bert.embeddings.word_embeddings.weight"])
         + F.embedding(positions, params["bert.embeddings.position_embeddings.weight"])
         + F.embedding(token_type_ids, params["bert.embeddings.token_type_embeddings.weight"])
         ).to(cfg.dtype)
    x = _layer_norm(x, params["bert.embeddings.LayerNorm.weight"],
                    params["bert.embeddings.LayerNorm.bias"], cfg.layer_norm_eps)
    head_dim = cfg.hidden_size // cfg.num_heads

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, s, cfg.num_heads, head_dim).transpose(1, 2)

    for i in range(cfg.num_layers):
        p = f"bert.encoder.layer.{i}."
        q, k, v = (heads(_linear(x, params[p + f"attention.self.{n}.weight"],
                                 params[p + f"attention.self.{n}.bias"]))
                   for n in ("query", "key", "value"))
        out = attn_ops.attention_reference(q, k, v, causal=False)  # bidirectional
        out = out.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        out = _linear(out, params[p + "attention.output.dense.weight"],
                      params[p + "attention.output.dense.bias"])
        x = _layer_norm(x + out, params[p + "attention.output.LayerNorm.weight"],
                        params[p + "attention.output.LayerNorm.bias"], cfg.layer_norm_eps)
        h = F.gelu(_linear(x, params[p + "intermediate.dense.weight"],
                           params[p + "intermediate.dense.bias"]), approximate="none")
        h = _linear(h, params[p + "output.dense.weight"], params[p + "output.dense.bias"])
        x = _layer_norm(x + h, params[p + "output.LayerNorm.weight"],
                        params[p + "output.LayerNorm.bias"], cfg.layer_norm_eps)
    pooled = torch.tanh(_linear(x[:, 0], params["bert.pooler.dense.weight"],
                                params["bert.pooler.dense.bias"]))
    return x, pooled
