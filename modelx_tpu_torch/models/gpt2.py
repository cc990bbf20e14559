"""GPT-2 family (counterpart of ``modelx_tpu/models/gpt2.py``).

Params keyed by HF safetensors names (``wte.weight``,
``h.N.attn.c_attn.weight``, ...). HF GPT-2's Conv1D layers store their
weights [in, out], transposed against llama's [out, in] Linear. Positions
are a learned table (``wpe``) of ``n_positions`` rows: the decode entry
points refuse to run past it (``_check_context``), and the server answers
400 before they are reached. Attention is the plain reference on every
path, as in the JAX twin (no kernel): cache-free, dense cached and ragged,
and the paged pools in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from modelx_tpu_torch.models import decode, llama
from modelx_tpu_torch.ops.nn import conv1d as _conv1d
from modelx_tpu_torch.ops.nn import layer_norm as _layer_norm


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @classmethod
    def gpt2_125m(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "GPT2Config":
        return cls(vocab_size=256, n_positions=64, hidden_size=64, num_layers=2, num_heads=4)


def param_shapes(cfg: GPT2Config) -> dict[str, tuple[int, ...]]:
    e = cfg.hidden_size
    shapes: dict[str, tuple[int, ...]] = {
        "wte.weight": (cfg.vocab_size, e),
        "wpe.weight": (cfg.n_positions, e),
        "ln_f.weight": (e,),
        "ln_f.bias": (e,),
    }
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        shapes.update({
            p + "ln_1.weight": (e,),
            p + "ln_1.bias": (e,),
            p + "attn.c_attn.weight": (e, 3 * e),  # Conv1D: [in, out]
            p + "attn.c_attn.bias": (3 * e,),
            p + "attn.c_proj.weight": (e, e),
            p + "attn.c_proj.bias": (e,),
            p + "ln_2.weight": (e,),
            p + "ln_2.bias": (e,),
            p + "mlp.c_fc.weight": (e, 4 * e),
            p + "mlp.c_fc.bias": (4 * e,),
            p + "mlp.c_proj.weight": (4 * e, e),
            p + "mlp.c_proj.bias": (e,),
        })
    return shapes


def init_params(cfg: GPT2Config, generator: torch.Generator, dtype=None,
                device=None) -> dict[str, torch.Tensor]:
    """Random params from ``generator``: layer norms are ones, biases zeros,
    weights N(0, 0.02^2), as the JAX twin draws them (with other bits)."""
    dtype = dtype or cfg.dtype
    device = torch.device(device) if device is not None else generator.device
    params: dict[str, torch.Tensor] = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif "ln_" in name:
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            params[name] = x.mul_(0.02).to(dtype)
    return params


def _logits(x: torch.Tensor, wte: torch.Tensor) -> torch.Tensor:
    """x @ wte.T in fp32, not rounded to the activation dtype: the JAX
    twin's head keeps its fp32 accumulator."""
    if x.dtype == torch.float32 or not x.is_cuda:
        return F.linear(x.float(), wte.float())
    y = torch.mm(x.reshape(-1, x.shape[-1]), wte.T, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], wte.shape[0])


def forward(params: dict, tokens: torch.Tensor, cfg: GPT2Config, kv_cache: dict | None = None,
            cache_offset=0, paged_table: torch.Tensor | None = None,
            paged_blocks: int | None = None) -> tuple[torch.Tensor, dict | None]:
    """Returns (logits [B, S, V] in fp32, kv_cache written in place, or
    None): the cached-decode contract of ``llama.forward``, so the shared
    decode (ragged batches, streams, the continuous engine) serves GPT-2
    unchanged. Prefill: kv_cache=None. Decode: the cache and its offset (an
    int, or [B] for ragged rows). With ``paged_table``, kv_cache holds page
    pools read in place (single-token steps)."""
    b, s = tokens.shape
    positions = llama.positions_for(tokens, kv_cache is not None, cache_offset)
    x = F.embedding(tokens, params["wte.weight"]) + F.embedding(positions, params["wpe.weight"])
    x = x.to(cfg.dtype)
    head_dim = cfg.hidden_size // cfg.num_heads
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        h = _layer_norm(x, params[p + "ln_1.weight"], params[p + "ln_1.bias"], cfg.layer_norm_eps)
        qkv = _conv1d(h, params[p + "attn.c_attn.weight"], params[p + "attn.c_attn.bias"])
        q, k, v = (t.reshape(b, s, cfg.num_heads, head_dim) for t in torch.chunk(qkv, 3, dim=-1))
        cache = (kv_cache[f"k{i}"], kv_cache[f"v{i}"]) if kv_cache is not None else None
        out = llama.attend_layer(q, k, v, cache, cache_offset, "reference", paged_table,
                                 paged_blocks)
        out = out.reshape(b, s, cfg.hidden_size)
        x = x + _conv1d(out, params[p + "attn.c_proj.weight"], params[p + "attn.c_proj.bias"])
        h = _layer_norm(x, params[p + "ln_2.weight"], params[p + "ln_2.bias"], cfg.layer_norm_eps)
        h = F.gelu(_conv1d(h, params[p + "mlp.c_fc.weight"], params[p + "mlp.c_fc.bias"]),
                   approximate="tanh")
        x = x + _conv1d(h, params[p + "mlp.c_proj.weight"], params[p + "mlp.c_proj.bias"])
    x = _layer_norm(x, params["ln_f.weight"], params["ln_f.bias"], cfg.layer_norm_eps)
    return _logits(x, params["wte.weight"]), kv_cache


def _check_context(cfg: GPT2Config, last_pos: int) -> None:
    """Positions past the learned wpe table have no embedding (the JAX
    twin's gather would clamp and answer plausible garbage): the decode
    entry points refuse up front. The bound is on positions decoded, not
    on how long a caller sizes its cache."""
    if last_pos > cfg.n_positions:
        raise ValueError(
            f"prompt + max_new_tokens needs {last_pos} positions, but this "
            f"gpt2 has n_positions={cfg.n_positions} — exceeds the model's "
            "position context"
        )


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int, dtype=None, device=None) -> dict:
    dtype = dtype or cfg.dtype
    head_dim = cfg.hidden_size // cfg.num_heads
    return {
        f"{kind}{i}": torch.zeros((batch, max_len, cfg.num_heads, head_dim), dtype=dtype,
                                  device=device)
        for i in range(cfg.num_layers)
        for kind in ("k", "v")
    }


def decode_fns(params, cfg: GPT2Config):
    """(forward, init_kv_cache) for ``models/decode.py``."""
    return decode.family_fns(forward, init_kv_cache, cfg, params["wte.weight"].device)


def paged_decode_fns(params, cfg: GPT2Config):
    """The forward over PAGED kv pools (the continuous engine's in-place step)."""
    return decode.paged_family_fn(forward, cfg)


def ragged_greedy_generate(params, prompt, row_lens, cfg: GPT2Config, max_new_tokens: int = 16,
                           temperature=None, top_k=None, top_p=None, seeds=None):
    """Ragged-batch decode, greedy or per-row-sampled (models/decode.py).
    The prefill touches positions [0, S); each row then decodes to its
    length + max_new_tokens."""
    _check_context(cfg, max(prompt.shape[1],
                            int(np.max(np.asarray(row_lens))) + max_new_tokens))
    return decode.ragged_greedy_generate(
        *decode_fns(params, cfg), params, prompt, row_lens, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, seeds=seeds)
