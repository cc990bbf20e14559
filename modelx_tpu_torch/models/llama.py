"""Llama-family decoder (counterpart of ``modelx_tpu/models/llama.py``).

Plain functions on tensors: params are a flat dict keyed by HF safetensors
names ("model.layers.N.self_attn.q_proj.weight", ...) in HF's [out, in]
layout, exactly as the JAX twin keys them, so one checkpoint loads into
either package with no renaming.

Cache-free forwards (``/v1/forward``, prompt scoring) attend through the
hand-written flash kernel on the card (``ops/attention.flash_attention``);
cached prefill and decode attend through the plain reference, as in the
JAX package. The KV cache is written in place.

With ``paged_table`` the cached decode reads PAGED KV: the cache leaves are
page pools [P, page_size, Hkv, D] and attention reads them in place
(``ops/paged_attention.py``), the continuous engine's in-place chunk step.

``forward(mesh=...)`` runs one rank's part of the model on a mesh of
processes (``parallel/mesh.py``), Megatron-style, with the collectives
written out (``ShardingCtx``): params are the rank's slices
(``ShardingCtx.param_index``), tokens are the whole batch on every rank,
and every rank gets the whole logits back.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from modelx_tpu_torch.models import decode
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
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(
            hidden_size=8192, intermediate_size=28672, num_layers=80,
            num_heads=64, num_kv_heads=8,
        )

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
    clamp its start instead, an int offset raises. A [B] offset on the card
    is not read back (that would wait on the card at every layer): its
    caller keeps it in range (``models/decode.py`` checks the row lengths
    on the host), and the indexed write itself fails past the end."""
    b, s = u.shape[:2]
    if isinstance(offset, torch.Tensor) and offset.ndim:
        pos = offset.to(c.device, torch.long)[:, None] + torch.arange(s, device=c.device)
        if not pos.is_cuda and (int(pos.max()) >= c.shape[1] or int(pos.min()) < 0):
            raise IndexError(f"cache write at {pos.tolist()} outside [0, {c.shape[1]})")
        c[torch.arange(b, device=c.device)[:, None], pos] = u
    else:
        off = int(offset)
        if off < 0 or off + s > c.shape[1]:
            raise IndexError(f"cache write [{off}, {off + s}) outside [0, {c.shape[1]})")
        c[:, off:off + s] = u


def attend_layer(q, k, v, cache, cache_offset, attention_impl: str = "auto",
                 paged_table: torch.Tensor | None = None, paged_blocks: int | None = None,
                 **attn_kw) -> torch.Tensor:
    """One layer's causal attention, q: [B, s, H, D], k/v: [B, s, Hkv, D]
    -> [B, s, H, D]. With a cache, k and v are written into it in place
    first: into the page pools when ``paged_table`` is given (single-token
    steps; ``ops/paged_attention.py`` reads the pools in place), else into
    the dense [B, max_len, Hkv, D] cache, which the plain reference reads.
    Without one, ``attention_impl`` picks the cache-free attention (the
    flash kernel on the card). ``attn_kw`` (``scale``, ``logit_softcap``,
    ``window``) reach whichever attention runs."""
    s = q.shape[1]
    if cache is not None and paged_table is not None:
        from modelx_tpu_torch.ops.paged_attention import paged_attention, write_token_kv

        if s != 1:
            raise ValueError(
                f"paged decode is single-token only (got seq len {s}); "
                "multi-token blocks (spec verify) take the dense path")
        ck, cv = cache  # pools [P, ps, Hkv, D]
        write_token_kv(ck, k, paged_table, cache_offset)
        write_token_kv(cv, v, paged_table, cache_offset)
        return paged_attention(q[:, 0], ck, cv, paged_table, cache_offset + 1,
                               n_blocks=paged_blocks, **attn_kw)[:, None]  # [B, 1, Hq, D]
    if cache is not None:
        ck, cv = cache
        _write_cache(ck, k, cache_offset)
        _write_cache(cv, v, cache_offset)
        return _attend(q, ck, cv, causal=True, q_offset=cache_offset, impl="reference",
                       **attn_kw)
    return _attend(q, k, v, causal=True, q_offset=0, impl=attention_impl, **attn_kw)


def positions_for(tokens: torch.Tensor, cached: bool, cache_offset=0) -> torch.Tensor:
    """[B, s] positions of ``tokens``: from 0 for a cache-free forward, else
    from ``cache_offset`` (an int, or a [B] tensor of per-row offsets)."""
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)[None, :]
    off = cache_offset if cached else 0
    if isinstance(off, torch.Tensor) and off.ndim:
        positions = positions + off.to(dev)[:, None]
    else:
        positions = positions + int(off)
    return positions.expand(b, s)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """One config's Megatron placement on a mesh (counterpart of the
    reference's ``ShardingCtx``, ``modelx_tpu/models/llama.py:172``, whose
    constraints GSPMD turns into collectives; here the collectives are
    written out). Decided once, at load, from the config and the mesh:

    - q heads (and o_proj's input columns) split over tp when tp divides
      the heads; kv heads too when tp divides them, else k/v weights
      replicate and each rank keeps the kv heads its q heads read
      (``kv_select``);
    - gate/up rows and down_proj's columns split over tp when tp divides
      the intermediate size;
    - the embedding and lm_head split the vocab over tp when tp divides it
      (a masked lookup + all-reduce; local logits + all-gather);
    - o_proj and down_proj are each followed by an all-reduce over tp when
      split;
    - dp splits the batch rows and sp the tokens (per forward: only where
      they divide; ``forward`` decides).

    A dimension tp does not divide replicates, as ``clean_spec`` and the
    reference's ``constrain`` drop the axis; no mesh the reference serves
    is refused."""

    mesh: object
    cfg: LlamaConfig
    heads: int  # this rank's q heads
    kv_heads_w: int  # kv heads in this rank's k/v weights
    kv_heads: int  # kv heads this rank attends with (after kv_select)
    kv_select: tuple[int, ...] | None  # indices into the k/v weights' heads
    attn_split: bool
    kv_split: bool
    mlp_split: bool
    vocab_split: bool

    @staticmethod
    def _kv_layout(cfg: LlamaConfig, tp: int, r: int) -> tuple:
        """(attn split, kv split, q heads, kv_select) of tp rank ``r``."""
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        attn = tp > 1 and h % tp == 0
        kv = attn and hkv % tp == 0
        heads = h // tp if attn else h
        select = None
        if attn and not kv:
            g = h // hkv
            needed = [(r * heads + j) // g for j in range(heads)]
            if heads % g == 0:  # whole groups: each kv head once, ratio g
                select = tuple(dict.fromkeys(needed))
            elif g % heads == 0:  # one group's part: its one kv head
                select = (needed[0],)
            else:  # groups cut across ranks: one kv head per q head
                select = tuple(needed)
        return attn, kv, heads, select

    @classmethod
    def build(cls, cfg: LlamaConfig, mesh) -> "ShardingCtx":
        tp, r = mesh.axis_size("tp"), mesh.axis_index("tp")
        hkv = cfg.num_kv_heads
        attn, kv, heads, select = cls._kv_layout(cfg, tp, r)
        kv_heads = len(select) if select is not None else (hkv // tp if kv else hkv)
        return cls(mesh=mesh, cfg=cfg, heads=heads, kv_heads_w=hkv // tp if kv else hkv,
                   kv_heads=kv_heads, kv_select=select, attn_split=attn, kv_split=kv,
                   mlp_split=tp > 1 and cfg.intermediate_size % tp == 0,
                   vocab_split=tp > 1 and cfg.vocab_size % tp == 0)

    def cache_heads(self, r: int | None = None) -> list[int]:
        """The kv heads (global indices) tp rank ``r``'s caches hold (this
        rank's by default): its tp slice, its ``kv_select`` or every head."""
        tp = self.mesh.axis_size("tp")
        r = self.mesh.axis_index("tp") if r is None else r
        _attn, kv, _heads, select = self._kv_layout(self.cfg, tp, r)
        if select is not None:
            return list(select)
        n = self.cfg.num_kv_heads // tp if kv else self.cfg.num_kv_heads
        return list(range(r * n, r * n + n)) if kv else list(range(n))

    def cache_spec(self):
        """A prefix-cache leaf's [1, S, Hkv, D] layout in the reference's
        spelling (``dl/kv_store._spec_of``): kv heads over tp where tp
        divides them, else None (the reference replicates the leaf)."""
        return [None, None, "tp"] if self.kv_split else None

    def splits(self, name: str) -> bool:
        """Whether the rank holds a tp slice of param ``name`` (else the
        whole of it)."""
        if "embed_tokens" in name or name.startswith("lm_head"):
            return self.vocab_split
        if "q_proj" in name or "o_proj" in name:
            return self.attn_split
        if "k_proj" in name or "v_proj" in name:
            return self.kv_split
        if "gate_proj" in name or "up_proj" in name or "down_proj" in name:
            return self.mlp_split
        return False

    def param_index(self, name: str, shape) -> tuple:
        """The slices of param ``name`` this rank holds: the family rule's
        slice (``dl/sharding.py``) where the placement splits it, else the
        whole tensor."""
        if not self.splits(name):
            return tuple(slice(0, n) for n in shape)
        from modelx_tpu_torch.dl import sharding

        rules = sharding.rules_for_family("qwen2" if self.cfg.qkv_bias else "llama")
        return sharding.sharding_for(name, rules, self.mesh).index(shape)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding lookup; vocab-split: a masked local lookup summed
        over tp (exact: one rank contributes each row, the rest zeros)."""
        if not self.vocab_split:
            return F.embedding(tokens, table)
        lo = self.mesh.axis_index("tp") * table.shape[0]
        local = tokens - lo
        inside = (local >= 0) & (local < table.shape[0])
        x = F.embedding(local.clamp(0, table.shape[0] - 1), table)
        x = x.masked_fill(~inside[..., None], 0)
        return self.mesh.all_reduce(x, "tp")

    def select_kv(self, x: torch.Tensor) -> torch.Tensor:
        """[B, s, Hkv_w, D] -> the kv heads this rank's q heads read."""
        if self.kv_select is None:
            return x
        return x[:, :, list(self.kv_select)]

    def local_rows(self, b: int, split_rows: bool = True) -> tuple[int, int]:
        """[start, stop) of the batch rows this rank computes: a dp slice
        when dp divides ``b`` (and ``split_rows``), else every row."""
        return self.mesh.local_rows(b) if split_rows else (0, b)


@functools.lru_cache(maxsize=64)
def sharding_ctx(cfg: LlamaConfig, mesh) -> ShardingCtx:
    return ShardingCtx.build(cfg, mesh)


def decoder_layer(
    lp: dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: LlamaConfig,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_offset=0,
    attention_impl: str = "auto",
    paged_table: torch.Tensor | None = None,
    paged_blocks: int | None = None,
    mlp_fn=None,
    ctx: ShardingCtx | None = None,
    sp_impl: str | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """One transformer block. ``lp`` holds the layer's params keyed by the
    unprefixed HF suffix. Returns (x, the (k, v) cache written in place, or
    None for a cache-free forward).

    ``mlp_fn(h)`` replaces the dense SwiGLU FFN when given (the post-norm
    hidden states go in, the FFN output comes out): Mixtral passes its
    sparse-MoE block here so the attention half stays shared.

    ``paged_table`` switches the cached decode to PAGED layout: the cache
    leaves are page pools [P, page_size, Hkv, D], the table maps each row
    to its pages, and attention reads the pool in place
    (``ops/paged_attention.py``; ``paged_blocks`` is its host-known ragged
    bound). Single-token steps only (s == 1), the shape the continuous
    engine's chunk step drives.

    With ``ctx`` (a mesh) the layer's params are this rank's slices: its
    heads, its kv heads (``ctx.select_kv``), and the all-reduces over tp
    after o_proj and down_proj where they are split. ``sp_impl`` ("ring"
    or "ulysses") attends over the sp axis from this rank's token shard;
    with a cache (a prefill from 0) the sp shards' k/v are then gathered
    into the rank's whole cache."""
    b, s = x.shape[:2]
    heads, kv_heads = (cfg.num_heads, cfg.num_kv_heads) if ctx is None else (
        ctx.heads, ctx.kv_heads_w)
    h = _rms_norm(x, lp["input_layernorm.weight"], cfg.rms_eps)
    q = _linear(h, lp["self_attn.q_proj.weight"], lp.get("self_attn.q_proj.bias"))
    k = _linear(h, lp["self_attn.k_proj.weight"], lp.get("self_attn.k_proj.bias"))
    v = _linear(h, lp["self_attn.v_proj.weight"], lp.get("self_attn.v_proj.bias"))
    k = k.reshape(b, s, kv_heads, cfg.head_dim)
    v = v.reshape(b, s, kv_heads, cfg.head_dim)
    if ctx is not None:
        k, v = ctx.select_kv(k), ctx.select_kv(v)
    q = _rope(q.reshape(b, s, heads, cfg.head_dim), positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if sp_impl is not None:
        attn_out = _attend_sp(q, k, v, cache, ctx.mesh, sp_impl)
    else:
        attn_out = attend_layer(q, k, v, cache, cache_offset, attention_impl, paged_table,
                                paged_blocks)
    attn_out = attn_out.reshape(b, s, heads * cfg.head_dim)
    o = _linear(attn_out, lp["self_attn.o_proj.weight"])
    if ctx is not None and ctx.attn_split:
        o = ctx.mesh.all_reduce(o, "tp")
    x = x + o

    h = _rms_norm(x, lp["post_attention_layernorm.weight"], cfg.rms_eps)
    if mlp_fn is not None:
        return x + mlp_fn(h), cache
    gate = _linear(h, lp["mlp.gate_proj.weight"])
    up = _linear(h, lp["mlp.up_proj.weight"])
    ff = _linear(F.silu(gate) * up, lp["mlp.down_proj.weight"])
    if ctx is not None and ctx.mlp_split:
        ff = ctx.mesh.all_reduce(ff, "tp")
    return x + ff, cache


def _attend_sp(q, k, v, cache, mesh, impl: str) -> torch.Tensor:
    """Causal attention of this rank's token shard over the sp axis
    (ring or Ulysses), [B, s, H, D] in and out; with a cache, the sp
    shards' k/v are gathered into it at [0, S) first."""
    if cache is not None:
        ck, cv = cache
        _write_cache(ck, mesh.all_gather(k, "sp", dim=1), 0)
        _write_cache(cv, mesh.all_gather(v, "sp", dim=1), 0)
    fn = attn_ops.ring_attention if impl == "ring" else attn_ops.ulysses_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return fn(qt, kt, vt, mesh, axis="sp", causal=True).transpose(1, 2)


def forward(
    params: dict[str, torch.Tensor],
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    kv_cache: dict | None = None,
    cache_offset=0,
    attention_impl: str = "auto",
    paged_table: torch.Tensor | None = None,
    mesh=None,
    paged_blocks: int | None = None,
    split_rows: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (logits [B, S, V], kv_cache written in place, or None).

    Prefill: kv_cache=None. Decode: pass the cache and the current offset
    (an int, or a [B] tensor of per-row offsets); tokens is [B, s]. With
    ``paged_table``, kv_cache holds PAGE POOLS and attention reads them in
    place (see decoder_layer; single-token decode, a [B] offset tensor).

    With ``mesh`` (a live ``parallel.mesh.Mesh``) ``params`` and
    ``kv_cache`` are this rank's (``ShardingCtx.param_index`` of each
    param, ``init_kv_cache(..., mesh=)``) and ``tokens`` and ``cache_offset`` the whole batch's; the
    returned logits are the whole batch's on every rank. A paged pool is
    then the rank's kv heads of every page, and ``paged_table`` the whole
    batch's table; ``split_rows=False`` computes every row on every dp
    rank (a cache allocated with ``init_kv_cache(split_rows=False)``)."""
    if mesh is not None:
        return _forward_mesh(params, tokens, cfg, sharding_ctx(cfg, mesh), kv_cache,
                             cache_offset, attention_impl, paged_table, paged_blocks,
                             split_rows)
    positions = positions_for(tokens, kv_cache is not None, cache_offset)
    x = F.embedding(tokens, params["model.embed_tokens.weight"]).to(cfg.dtype)
    return _layers_and_head(params, x, positions, cfg, kv_cache, cache_offset,
                            attention_impl=attention_impl, paged_table=paged_table,
                            paged_blocks=paged_blocks), kv_cache


def _layers_and_head(params, x, positions, cfg: LlamaConfig, kv_cache, cache_offset,
                     **layer_kw) -> torch.Tensor:
    """The decoder layers (``layer_kw`` to each), the final norm and the
    head's logits (on a mesh, this rank's vocab slice of them)."""
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {suffix: params[p + suffix] for suffix in LAYER_PARAM_SUFFIXES}
        for suffix in BIAS_SUFFIXES:
            if p + suffix in params:
                lp[suffix] = params[p + suffix]
        cache = (kv_cache[f"k{i}"], kv_cache[f"v{i}"]) if kv_cache is not None else None
        x, _ = decoder_layer(lp, x, positions, cfg, cache=cache, cache_offset=cache_offset,
                             **layer_kw)
    x = _rms_norm(x, params["model.norm.weight"], cfg.rms_eps)
    head = params.get("lm_head.weight", params["model.embed_tokens.weight"])
    return _linear(x, head)


def _sp_impl(ctx: ShardingCtx, s: int, cached: bool, cache_offset, impl: str) -> str | None:
    """The sequence-parallel attention a mesh forward of ``s`` tokens runs,
    or None for the one-rank attention. Cache-free: an explicit "ring" or
    "ulysses" at any sp size, "auto" -> ring when sp > 1. Cached: only a
    prefill from 0 with sp > 1 (decode steps run replicated over sp).
    Never when sp does not divide the tokens: they replicate instead."""
    sp = ctx.mesh.axis_size("sp")
    if s % sp:
        return None
    if cached:
        if sp == 1 or isinstance(cache_offset, torch.Tensor) or int(cache_offset) != 0:
            return None
        return "ulysses" if impl == "ulysses" else "ring" if impl in ("auto", "ring") else None
    if impl in ("ring", "ulysses"):
        return impl
    return "ring" if impl == "auto" and sp > 1 else None


def _forward_mesh(params, tokens, cfg: LlamaConfig, ctx: ShardingCtx, kv_cache,
                  cache_offset, attention_impl: str, paged_table=None, paged_blocks=None,
                  split_rows: bool = True):
    """One rank's part of ``forward``: its dp rows, its sp tokens (when the
    attention is sequence-parallel), its tp slices; then the logits
    gathered over tp (vocab), sp (tokens) and dp (rows)."""
    mesh = ctx.mesh
    b, s = tokens.shape
    cached = kv_cache is not None
    r0, r1 = ctx.local_rows(b, split_rows)
    rows_split = (r1 - r0) != b
    tokens = tokens[r0:r1]
    if isinstance(cache_offset, torch.Tensor) and cache_offset.ndim:
        cache_offset = cache_offset[r0:r1]
    if paged_table is not None:
        paged_table = paged_table[r0:r1]
    positions = positions_for(tokens, cached, cache_offset)
    sp_impl = None if paged_table is not None else _sp_impl(ctx, s, cached, cache_offset,
                                                             attention_impl)
    seq_split = sp_impl is not None and mesh.axis_size("sp") > 1
    if seq_split:
        n = s // mesh.axis_size("sp")
        t0 = mesh.axis_index("sp") * n
        tokens, positions = tokens[:, t0:t0 + n], positions[:, t0:t0 + n]
    impl = "auto" if attention_impl in ("ring", "ulysses") else attention_impl
    x = ctx.embed(params["model.embed_tokens.weight"], tokens).to(cfg.dtype)
    logits = _layers_and_head(params, x, positions, cfg, kv_cache, cache_offset,
                              attention_impl=impl, ctx=ctx, sp_impl=sp_impl,
                              paged_table=paged_table, paged_blocks=paged_blocks)
    if ctx.vocab_split:
        logits = mesh.all_gather(logits, "tp", dim=-1)
    if seq_split:
        logits = mesh.all_gather(logits, "sp", dim=1)
    if rows_split:
        logits = mesh.all_gather(logits, "dp", dim=0)
    return logits, kv_cache


def _attend(q, k, v, causal: bool, q_offset, impl: str, **attn_kw):
    """q: [B, S, H, D], k/v: [B, Sk, Hkv, D]. Transposes to [B, H, S, D] and
    picks the implementation: ``auto`` is the flash kernel on the card and
    the reference on the CPU."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        out = attn_ops.flash_attention(qt, kt, vt, causal=causal, **attn_kw)
    elif impl == "reference":
        out = attn_ops.attention_reference(qt, kt, vt, causal=causal, q_offset=q_offset,
                                           **attn_kw)
    elif impl in ("ring", "ulysses"):
        raise NotImplementedError(f"{impl} attention needs a mesh: the multi-device path "
                                  "is forward(mesh=...)")
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return out.transpose(1, 2)


# -- kv cache + decode -------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None, mesh=None, split_rows: bool = True) -> dict:
    """Zeroed [batch, max_len, Hkv, D] k/v leaves per layer; with ``mesh``
    this rank's: its dp rows (every row without ``split_rows``) and the kv
    heads it attends with."""
    dtype = dtype or cfg.dtype
    kv_heads = cfg.num_kv_heads
    if mesh is not None:
        ctx = sharding_ctx(cfg, mesh)
        r0, r1 = ctx.local_rows(batch, split_rows)
        batch, kv_heads = r1 - r0, ctx.kv_heads
    shape = (batch, max_len, kv_heads, cfg.head_dim)
    cache = {}
    for i in range(cfg.num_layers):
        cache[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        cache[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def decode_fns(params, cfg: LlamaConfig, mesh=None, attention_impl: str = "auto",
               split_rows: bool = True):
    """(forward, init_kv_cache) for ``models/decode.py``: the cached forward
    and a cache allocator on the params' device. With ``mesh``, this rank's
    part of both (``forward(mesh=)``, ``init_kv_cache(mesh=)``);
    ``attention_impl`` then picks the sp prefill's attention, and
    ``split_rows=False`` keeps every row on every dp rank."""
    device = params["model.embed_tokens.weight"].device
    if mesh is None:
        return decode.family_fns(forward, init_kv_cache, cfg, device)

    def fwd(p, t, kv_cache, cache_offset):
        return forward(p, t, cfg, kv_cache=kv_cache, cache_offset=cache_offset, mesh=mesh,
                       attention_impl=attention_impl, split_rows=split_rows)

    return fwd, (lambda b, max_len: init_kv_cache(cfg, b, max_len, device=device, mesh=mesh,
                                                  split_rows=split_rows))


def paged_decode_fns(params, cfg: LlamaConfig, mesh=None, attention_impl: str = "auto"):
    """The forward over PAGED kv pools (the continuous engine's in-place
    chunk step): ``fwd(p, t, kv_cache, cache_offset, table, n_blocks)``;
    with ``mesh`` this rank's part (its kv heads of every page)."""
    if mesh is None:
        return decode.paged_family_fn(forward, cfg)

    def fwd(p, t, kv_cache, cache_offset, table, n_blocks=None):
        return forward(p, t, cfg, kv_cache=kv_cache, cache_offset=cache_offset,
                       paged_table=table, paged_blocks=n_blocks, mesh=mesh,
                       attention_impl=attention_impl)

    return fwd


def ragged_greedy_generate(
    params: dict[str, torch.Tensor],
    prompt: torch.Tensor,  # [B, S] right-padded
    row_lens,  # [B]
    cfg: LlamaConfig,
    max_new_tokens: int = 16,
    temperature=None,
    top_k=None,
    top_p=None,
    seeds=None,
    mesh=None,
    attention_impl: str = "auto",
) -> torch.Tensor:
    """Ragged-batch decode, greedy or per-row-sampled (models/decode.py);
    returns the generated tokens [B, max_new_tokens] only. With ``mesh``
    every rank runs it on its part and takes rank 0's token at each step."""
    return decode.ragged_greedy_generate(
        *decode_fns(params, cfg, mesh, attention_impl), params, prompt, row_lens,
        max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
        seeds=seeds, agree=None if mesh is None else mesh.broadcast_from_leader)
