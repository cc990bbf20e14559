"""Gemma2-family decoder (counterpart of ``modelx_tpu/models/gemma2.py``).

llama.py's shape (a flat HF-named param dict, a KV cache written in
place), with gemma2's deltas, as HF ``Gemma2ForCausalLM`` computes them:

- RMSNorm stores ``w`` and scales by ``(1 + w)``, multiplying in fp32
  BEFORE the cast back (checkpoint norm weights are zeros-centred);
- embeddings are scaled by ``sqrt(hidden_size)``, the factor cast to the
  compute dtype first;
- FOUR norms per layer: the attention and FFN outputs are each
  re-normalised before their residual add;
- GeGLU FFN: ``down(gelu_tanh(gate(x)) * up(x))``;
- attention scales by ``query_pre_attn_scalar ** -0.5`` (not head_dim),
  softcaps its logits at ``attn_logit_softcap`` before the mask, and the
  final logits at ``final_logit_softcap`` (in fp32, then cast);
- every EVEN layer attends through a sliding window (4096 in released
  checkpoints), odd layers globally;
- embeddings are always tied (no lm_head.weight in checkpoints).

The cache-free forward runs the flash kernel on the card, which carries
the scale, the softcap and the window itself; the CPU runs the plain
reference, as the JAX twin does off the TPU. The dense cached decode reads
its cache through the reference and the paged one reads the page pools in
place (``ops/paged_attention.py`` takes the same three arguments).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from modelx_tpu_torch.models import decode, llama
from modelx_tpu_torch.ops.nn import linear as _linear


@dataclasses.dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0
    sliding_window: int = 4096
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def gemma2_2b(cls) -> "Gemma2Config":
        return cls()

    @classmethod
    def gemma2_9b(cls) -> "Gemma2Config":
        return cls(hidden_size=3584, intermediate_size=14336, num_layers=42,
                   num_heads=16, num_kv_heads=8)

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "Gemma2Config":
        """Test config: real structure (a sliding window small enough for
        short prompts to cut), toy sizes."""
        return cls(
            vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            query_pre_attn_scalar=32.0, sliding_window=16,
        )


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
    "pre_feedforward_layernorm.weight",
    "post_feedforward_layernorm.weight",
)


def param_shapes(cfg: Gemma2Config) -> dict[str, tuple[int, ...]]:
    """HF layout: linear weights are [out_features, in_features]; tied head."""
    e, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size
    shapes: dict[str, tuple[int, ...]] = {
        "model.embed_tokens.weight": (cfg.vocab_size, e),
        "model.norm.weight": (e,),
    }
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
            **{p + s: (e,) for s in LAYER_PARAM_SUFFIXES if s.endswith("norm.weight")},
        })
    return shapes


def init_params(cfg: Gemma2Config, generator: torch.Generator, dtype=None,
                device=None) -> dict[str, torch.Tensor]:
    """Random params from ``generator``: norms are ZEROS (gemma2 scales by
    1 + w), weights N(0, 1/fan_in)."""
    dtype = dtype or cfg.dtype
    device = torch.device(device) if device is not None else generator.device
    params: dict[str, torch.Tensor] = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith("norm.weight"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        params[name] = x.mul_(1.0 / math.sqrt(shape[-1])).to(dtype)
    return params


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma2's convention: the norm AND the (1 + w) scale in fp32, then the
    cast back (llama casts before it scales)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(x.dtype)


def decoder_layer(lp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: Gemma2Config,
                  layer_idx: int, cache=None, cache_offset=0, attention_impl: str = "auto",
                  paged_table: torch.Tensor | None = None, paged_blocks: int | None = None):
    """One gemma2 block: sandwich norms around both halves; even layers
    slide their attention window. Returns (x, the cache written in place)."""
    b, s = x.shape[:2]
    window = cfg.sliding_window if layer_idx % 2 == 0 else 0
    h = _rms_norm(x, lp["input_layernorm.weight"], cfg.rms_eps)
    q = _linear(h, lp["self_attn.q_proj.weight"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = _linear(h, lp["self_attn.k_proj.weight"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _linear(h, lp["self_attn.v_proj.weight"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = llama._rope(q, positions, cfg.rope_theta)
    k = llama._rope(k, positions, cfg.rope_theta)
    attn_out = llama.attend_layer(
        q, k, v, cache, cache_offset, attention_impl, paged_table, paged_blocks,
        scale=cfg.query_pre_attn_scalar ** -0.5, logit_softcap=cfg.attn_logit_softcap,
        window=window)
    attn_out = _linear(attn_out.reshape(b, s, cfg.num_heads * cfg.head_dim),
                       lp["self_attn.o_proj.weight"])
    x = x + _rms_norm(attn_out, lp["post_attention_layernorm.weight"], cfg.rms_eps)

    h = _rms_norm(x, lp["pre_feedforward_layernorm.weight"], cfg.rms_eps)
    gate = _linear(h, lp["mlp.gate_proj.weight"])
    up = _linear(h, lp["mlp.up_proj.weight"])
    ff = _linear(F.gelu(gate, approximate="tanh") * up, lp["mlp.down_proj.weight"])
    x = x + _rms_norm(ff, lp["post_feedforward_layernorm.weight"], cfg.rms_eps)
    return x, cache


def forward(params: dict, tokens: torch.Tensor, cfg: Gemma2Config, kv_cache: dict | None = None,
            cache_offset=0, attention_impl: str = "auto",
            paged_table: torch.Tensor | None = None, paged_blocks: int | None = None,
            ) -> tuple[torch.Tensor, dict | None]:
    """Returns (logits [B, S, V], kv_cache written in place, or None).
    Prefill: kv_cache=None; decode: the cache and its offset (an int, or a
    [B] tensor). With ``paged_table``, kv_cache holds PAGE POOLS read in
    place (single-token steps). ``attention_impl`` picks the cache-free
    attention: ``auto`` (the flash kernel on the card) or ``reference``."""
    positions = llama.positions_for(tokens, kv_cache is not None, cache_offset)
    x = F.embedding(tokens, params["model.embed_tokens.weight"]).to(cfg.dtype)
    # HF casts the sqrt(hidden) normaliser to the compute dtype BEFORE the multiply
    x = x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype, device=x.device)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {suffix: params[p + suffix] for suffix in LAYER_PARAM_SUFFIXES}
        cache = (kv_cache[f"k{i}"], kv_cache[f"v{i}"]) if kv_cache is not None else None
        x, _ = decoder_layer(lp, x, positions, cfg, i, cache=cache, cache_offset=cache_offset,
                             attention_impl=attention_impl, paged_table=paged_table,
                             paged_blocks=paged_blocks)
    x = _rms_norm(x, params["model.norm.weight"], cfg.rms_eps)
    logits = _linear(x, params["model.embed_tokens.weight"])  # tied head
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        logits = (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)
    return logits, kv_cache


def init_kv_cache(cfg: Gemma2Config, batch: int, max_len: int, dtype=None, device=None) -> dict:
    dtype = dtype or cfg.dtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {}
    for i in range(cfg.num_layers):
        cache[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        cache[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def decode_fns(params, cfg: Gemma2Config):
    """(forward, init_kv_cache) for ``models/decode.py``."""
    return decode.family_fns(forward, init_kv_cache, cfg,
                             params["model.embed_tokens.weight"].device)


def paged_decode_fns(params, cfg: Gemma2Config):
    """The forward over PAGED kv pools (the continuous engine's in-place step)."""
    return decode.paged_family_fn(forward, cfg)


def ragged_greedy_generate(params, prompt, row_lens, cfg: Gemma2Config, max_new_tokens: int = 16,
                           temperature=None, top_k=None, top_p=None, seeds=None):
    """Ragged-batch decode, greedy or per-row-sampled (models/decode.py)."""
    return decode.ragged_greedy_generate(
        *decode_fns(params, cfg), params, prompt, row_lens, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, seeds=seeds)
