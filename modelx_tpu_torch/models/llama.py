"""Llama-family decoder (counterpart of ``modelx_tpu/models/llama.py``).

Plain functions on tensors: params are a flat dict keyed by HF safetensors
names ("model.layers.N.self_attn.q_proj.weight", ...) in HF's [out, in]
layout, exactly as the JAX twin keys them, so one checkpoint loads into
either package with no renaming.

Cache-free forwards (``/v1/forward``, prompt scoring) attend through the
hand-written flash kernel on the card (``ops/attention.flash_attention``);
cached prefill and decode attend through the plain reference, as in the
JAX package. The KV cache is written in place.

Not ported yet: the paged KV table (continuous-engine slice) and ring /
Ulysses sequence parallelism (multi-device slice).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from modelx_tpu_torch.ops import attention as attn_ops
from modelx_tpu_torch.ops.nn import linear as _linear


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # Qwen2-style attention input biases on q/k/v (the only architectural
    # delta between the llama and qwen2 families)
    qkv_bias: bool = False
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LlamaConfig":
        """Test/dry-run config: real structure, toy sizes."""
        return cls(
            vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            rope_theta=10000.0,
        )


# -- params -------------------------------------------------------------------

LAYER_PARAM_SUFFIXES = (
    "self_attn.q_proj.weight",
    "self_attn.k_proj.weight",
    "self_attn.v_proj.weight",
    "self_attn.o_proj.weight",
    "mlp.gate_proj.weight",
    "mlp.up_proj.weight",
    "mlp.down_proj.weight",
    "input_layernorm.weight",
    "post_attention_layernorm.weight",
)

# optional per-layer params (qwen2's qkv biases); present iff cfg.qkv_bias
BIAS_SUFFIXES = (
    "self_attn.q_proj.bias",
    "self_attn.k_proj.bias",
    "self_attn.v_proj.bias",
)


def param_names(cfg: LlamaConfig) -> list[str]:
    names = ["model.embed_tokens.weight", "model.norm.weight"]
    if not cfg.tie_embeddings:
        names.append("lm_head.weight")
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        names += [p + s for s in LAYER_PARAM_SUFFIXES]
        if cfg.qkv_bias:
            names += [p + s for s in BIAS_SUFFIXES]
    return names


def param_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """HF layout: linear weights are [out_features, in_features]."""
    e, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size
    shapes: dict[str, tuple[int, ...]] = {
        "model.embed_tokens.weight": (cfg.vocab_size, e),
        "model.norm.weight": (e,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head.weight"] = (cfg.vocab_size, e)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "self_attn.q_proj.weight": (q, e),
            p + "self_attn.k_proj.weight": (kv, e),
            p + "self_attn.v_proj.weight": (kv, e),
            p + "self_attn.o_proj.weight": (e, q),
            p + "mlp.gate_proj.weight": (f, e),
            p + "mlp.up_proj.weight": (f, e),
            p + "mlp.down_proj.weight": (e, f),
            p + "input_layernorm.weight": (e,),
            p + "post_attention_layernorm.weight": (e,),
        })
        if cfg.qkv_bias:
            shapes[p + "self_attn.q_proj.bias"] = (q,)
            shapes[p + "self_attn.k_proj.bias"] = (kv,)
            shapes[p + "self_attn.v_proj.bias"] = (kv,)
    return shapes


def init_params(cfg: LlamaConfig, generator: torch.Generator, dtype=None,
                device=None) -> dict[str, torch.Tensor]:
    """Random params from ``generator`` (on ``device``, default the
    generator's): norms are ones, biases N(0, 0.05^2), weights
    N(0, 1/fan_in). The draws differ from ``jax.random``'s, so parity tests
    hand both packages the same numpy arrays instead."""
    dtype = dtype or cfg.dtype
    device = torch.device(device) if device is not None else generator.device
    params: dict[str, torch.Tensor] = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith("norm.weight"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        if name.endswith(".bias"):
            # small random biases (not zeros): parity tests must catch a
            # forward that forgets to add them
            x.mul_(0.05)
        else:
            x.mul_(1.0 / math.sqrt(shape[-1]))
        params[name] = x.to(dtype)
    return params


# -- forward ------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in fp32, cast back, THEN scale by the weight."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embeddings in fp32. x: [B, S, H, D], positions: [B, S]."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _write_cache(c: torch.Tensor, u: torch.Tensor, offset) -> None:
    """Write u [B, s, Hkv, D] into cache c [B, max_len, Hkv, D] in place at
    ``offset``: an int, or a [B] tensor for per-row (ragged) positions.
    Callers size caches as the JAX package does (prompt + new tokens), so a
    write never runs past the end — where JAX's dynamic_update_slice would
    clamp its start instead, this raises."""
    b, s = u.shape[:2]
    if isinstance(offset, torch.Tensor) and offset.ndim:
        pos = offset.to(c.device, torch.long)[:, None] + torch.arange(s, device=c.device)
        if int(pos.max()) >= c.shape[1] or int(pos.min()) < 0:
            raise IndexError(f"cache write at {pos.tolist()} outside [0, {c.shape[1]})")
        c[torch.arange(b, device=c.device)[:, None], pos] = u
    else:
        off = int(offset)
        if off < 0 or off + s > c.shape[1]:
            raise IndexError(f"cache write [{off}, {off + s}) outside [0, {c.shape[1]})")
        c[:, off:off + s] = u


def decoder_layer(
    lp: dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: LlamaConfig,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_offset=0,
    attention_impl: str = "auto",
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """One transformer block. ``lp`` holds the layer's params keyed by the
    unprefixed HF suffix. Returns (x, the (k, v) cache written in place, or
    None for a cache-free forward)."""
    b, s = x.shape[:2]
    h = _rms_norm(x, lp["input_layernorm.weight"], cfg.rms_eps)
    q = _linear(h, lp["self_attn.q_proj.weight"], lp.get("self_attn.q_proj.bias"))
    k = _linear(h, lp["self_attn.k_proj.weight"], lp.get("self_attn.k_proj.bias"))
    v = _linear(h, lp["self_attn.v_proj.weight"], lp.get("self_attn.v_proj.bias"))
    q = _rope(q.reshape(b, s, cfg.num_heads, cfg.head_dim), positions, cfg.rope_theta)
    k = _rope(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), positions, cfg.rope_theta)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)

    if cache is not None:
        ck, cv = cache
        _write_cache(ck, k, cache_offset)
        _write_cache(cv, v, cache_offset)
        attn_out = _attend(q, ck, cv, causal=True, q_offset=cache_offset, impl="reference")
    else:
        attn_out = _attend(q, k, v, causal=True, q_offset=0, impl=attention_impl)

    attn_out = attn_out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    x = x + _linear(attn_out, lp["self_attn.o_proj.weight"])

    h = _rms_norm(x, lp["post_attention_layernorm.weight"], cfg.rms_eps)
    gate = _linear(h, lp["mlp.gate_proj.weight"])
    up = _linear(h, lp["mlp.up_proj.weight"])
    x = x + _linear(F.silu(gate) * up, lp["mlp.down_proj.weight"])
    return x, cache


def forward(
    params: dict[str, torch.Tensor],
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    kv_cache: dict | None = None,
    cache_offset=0,
    attention_impl: str = "auto",
    paged_table=None,
    mesh=None,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (logits [B, S, V], kv_cache written in place, or None).

    Prefill: kv_cache=None. Decode: pass the cache and the current offset
    (an int, or a [B] tensor of per-row offsets); tokens is [B, s]."""
    if paged_table is not None:
        raise NotImplementedError("paged KV comes with the continuous-engine slice")
    if mesh is not None:
        raise NotImplementedError(
            "meshes (ring/Ulysses, tensor parallel) come with the multi-device slice")
    b, s = tokens.shape
    dev = tokens.device
    off = cache_offset if kv_cache is not None else 0
    positions = torch.arange(s, device=dev)[None, :]
    if isinstance(off, torch.Tensor) and off.ndim:
        positions = positions + off.to(dev)[:, None]
    else:
        positions = positions + int(off)
    positions = positions.expand(b, s)

    x = F.embedding(tokens, params["model.embed_tokens.weight"]).to(cfg.dtype)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {suffix: params[p + suffix] for suffix in LAYER_PARAM_SUFFIXES}
        for suffix in BIAS_SUFFIXES:
            if p + suffix in params:
                lp[suffix] = params[p + suffix]
        cache = (kv_cache[f"k{i}"], kv_cache[f"v{i}"]) if kv_cache is not None else None
        x, _ = decoder_layer(lp, x, positions, cfg, cache=cache, cache_offset=cache_offset,
                             attention_impl=attention_impl)

    x = _rms_norm(x, params["model.norm.weight"], cfg.rms_eps)
    head = params.get("lm_head.weight", params["model.embed_tokens.weight"])
    return _linear(x, head), kv_cache


def _attend(q, k, v, causal: bool, q_offset, impl: str):
    """q: [B, S, H, D], k/v: [B, Sk, Hkv, D]. Transposes to [B, H, S, D] and
    picks the implementation: ``auto`` is the flash kernel on the card and
    the reference on the CPU."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        out = attn_ops.flash_attention(qt, kt, vt, causal=causal)
    elif impl == "reference":
        out = attn_ops.attention_reference(qt, kt, vt, causal=causal, q_offset=q_offset)
    elif impl in ("ring", "ulysses"):
        raise NotImplementedError(f"{impl} attention comes with the multi-device slice")
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return out.transpose(1, 2)


# -- kv cache + greedy decode -------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> dict:
    dtype = dtype or cfg.dtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {}
    for i in range(cfg.num_layers):
        cache[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        cache[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _decode_fns(params, cfg: LlamaConfig):
    device = params["model.embed_tokens.weight"].device

    def fwd(p, t, kv_cache, cache_offset):
        return forward(p, t, cfg, kv_cache=kv_cache, cache_offset=cache_offset)

    return fwd, (lambda b, max_len: init_kv_cache(cfg, b, max_len, device=device))


def greedy_generate(
    params: dict[str, torch.Tensor],
    prompt: torch.Tensor,  # [B, S]
    cfg: LlamaConfig,
    max_new_tokens: int = 16,
) -> torch.Tensor:
    """Greedy decode with a static-shape KV cache (models/decode.py)."""
    from modelx_tpu_torch.models import decode

    fwd, init = _decode_fns(params, cfg)
    return decode.greedy_generate(fwd, init, params, prompt, max_new_tokens=max_new_tokens)


def ragged_greedy_generate(
    params: dict[str, torch.Tensor],
    prompt: torch.Tensor,  # [B, S] right-padded
    row_lens: torch.Tensor,  # [B]
    cfg: LlamaConfig,
    max_new_tokens: int = 16,
) -> torch.Tensor:
    """Ragged-batch greedy decode (models/decode.py); returns the generated
    tokens [B, max_new_tokens] only."""
    from modelx_tpu_torch.models import decode

    fwd, init = _decode_fns(params, cfg)
    return decode.ragged_greedy_generate(
        fwd, init, params, prompt, row_lens, max_new_tokens=max_new_tokens)
