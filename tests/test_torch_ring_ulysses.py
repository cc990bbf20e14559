"""Ring and Ulysses attention, and the llama forward on a mesh, against
the JAX package, on the CPU.

The port's side runs in one 4-process gloo group for the whole module
(``tests/torch_mesh_util.py``); the JAX side on the forced 8-device host.
Inputs come from ``np.random.RandomState``. Tolerances:

- ring and Ulysses against ``modelx_tpu/ops/attention.py``'s
  ``ring_attention``/``ulysses_attention`` (the cases of
  ``tests/test_model.py:70-139``), fp32: atol 2e-6, the reference's own
  bound against plain attention;
- the tiny llama's logits on a mesh against ``llama.forward(mesh=...)``,
  fp32: atol 1e-5 (the same math summed in another order);
- greedy tokens against the reference's greedy decode on the same mesh:
  exactly, in fp32.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_mesh_util as mu
from modelx_tpu.dl.sharding import LLAMA_RULES, QWEN2_RULES
from modelx_tpu.models import llama as jl
from modelx_tpu.models.train import batch_sharding, shard_params
from modelx_tpu.ops import attention as jattn
from modelx_tpu.parallel.mesh import make_mesh

ATTN_ATOL = 2e-6
LOGITS_ATOL = 1e-5


@pytest.fixture(scope="module")
def group():
    g = mu.GlooGroup(4)
    yield g
    g.close()


def _qkv(seed=0, b=2, h=4, hkv=4, s=128, d=32):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, s, d).astype(np.float32), rng.rand(b, hkv, s, d).astype(np.float32),
            rng.rand(b, hkv, s, d).astype(np.float32))


def _jmesh(spec):
    n = 1
    for part in spec.split(","):
        n *= int(part.split("=")[1])
    return make_mesh(spec, devices=jax.devices()[:n])


RING_CASES = [  # (spec, causal, block_k)
    ("sp=4", True, 0), ("sp=4", False, 0), ("sp=2", True, 16), ("sp=2", False, 16),
    ("sp=2", True, 0),
]


@pytest.mark.parametrize("spec,causal,block_k", RING_CASES)
def test_ring_equals_the_reference_ring(group, spec, causal, block_k):
    q, k, v = _qkv()
    want = np.asarray(jattn.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           _jmesh(spec), axis="sp", causal=causal,
                                           block_k=block_k))
    got = group.run(mu.sp_attention, q, k, v, spec, "ring", causal, block_k)[0]
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL)
    plain = np.asarray(jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, plain, atol=ATTN_ATOL)


ULYSSES_CASES = [  # (spec, causal, q heads, kv heads): GQA, partial repeat
    ("sp=4", True, 4, 4), ("sp=4", False, 4, 4), ("sp=4", True, 4, 2), ("sp=4", True, 8, 2),
    ("sp=2", True, 4, 1),
]


@pytest.mark.parametrize("spec,causal,h,hkv", ULYSSES_CASES)
def test_ulysses_equals_the_reference_ulysses(group, spec, causal, h, hkv):
    q, k, v = _qkv(seed=7, h=h, hkv=hkv)
    want = np.asarray(jattn.ulysses_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              _jmesh(spec), axis="sp", causal=causal))
    got = group.run(mu.sp_attention, q, k, v, spec, "ulysses", causal)[0]
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL)


def test_ulysses_head_mismatch_raises_the_reference_error(group):
    q, k, v = _qkv(h=2, hkv=2)  # 2 heads on sp=4
    with pytest.raises(ValueError) as jerr:
        jattn.ulysses_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                _jmesh("sp=4"), axis="sp")
    got = group.run(mu.sp_attention, q, k, v, "sp=4", "ulysses")
    assert got == [str(jerr.value)] * 4


# -- the tiny llama on a mesh ----------------------------------------------------------

_CFG_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
               "num_kv_heads", "head_dim", "rope_theta", "rms_eps", "tie_embeddings",
               "qkv_bias")


def _model(variant="llama"):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=96), dtype=jnp.float32)
    if variant == "qwen2":
        jcfg = dataclasses.replace(jcfg, qkv_bias=True, rms_eps=1e-6)
    params = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    kw = {f: getattr(jcfg, f) for f in _CFG_FIELDS}
    kw["dtype"] = "float32"
    return jcfg, params, {k: np.asarray(v) for k, v in params.items()}, kw


@pytest.fixture(scope="module")
def tiny():
    return _model()


# tp=4 puts the tiny model's 2 kv heads on 4 ranks: k/v replicate
MESH_CASES = [("tp=2", "auto"), ("dp=2,tp=2", "auto"), ("tp=4", "auto"),
              ("sp=2,tp=2", "auto"), ("sp=2,tp=2", "ulysses"), ("dp=2,sp=2", "auto")]


@pytest.mark.parametrize("spec,impl", MESH_CASES)
def test_llama_logits_on_a_mesh_equal_the_reference(group, tiny, spec, impl):
    jcfg, params, np_params, kw = tiny
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    mesh = _jmesh(spec)
    sharded = shard_params(params, LLAMA_RULES, mesh)
    fwd = jax.jit(lambda p, t: jl.forward(p, t, jcfg, mesh=mesh, attention_impl=impl)[0])
    want = np.asarray(fwd(sharded, jax.device_put(jnp.asarray(tokens), batch_sharding(mesh))))
    got = group.run(mu.llama_logits, np_params, tokens, kw, spec, impl)[0]
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL)
    base = np.asarray(jl.forward(params, jnp.asarray(tokens), jcfg)[0])
    np.testing.assert_allclose(got, base, atol=LOGITS_ATOL)


def test_qwen2_logits_at_tp2_equal_the_reference(group):
    jcfg, params, np_params, kw = _model("qwen2")
    tokens = np.random.RandomState(2).randint(0, jcfg.vocab_size, (1, 12)).astype(np.int32)
    mesh = _jmesh("tp=2")
    fwd = jax.jit(lambda p, t: jl.forward(p, t, jcfg, mesh=mesh)[0])
    want = np.asarray(fwd(shard_params(params, QWEN2_RULES, mesh), jnp.asarray(tokens)))
    got = group.run(mu.llama_logits, np_params, tokens, kw, "tp=2")[0]
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL)


@pytest.mark.parametrize("spec", ["tp=2", "dp=2,tp=2", "tp=4", "sp=2,tp=2"])
def test_greedy_tokens_on_a_mesh_equal_the_reference(group, tiny, spec):
    jcfg, params, np_params, kw = tiny
    prompt = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    mesh = _jmesh(spec)
    want = np.asarray(jl.greedy_generate(shard_params(params, LLAMA_RULES, mesh),
                                         jnp.asarray(prompt), jcfg, max_new_tokens=8,
                                         mesh=mesh))[:, 16:]
    got = group.run(mu.llama_generate, np_params, prompt, kw, spec, 8)
    for rank_out in got:  # every rank of the mesh holds rank 0's tokens
        if rank_out is not None:
            np.testing.assert_array_equal(rank_out, want)


def test_sampled_tokens_agree_on_every_rank(group, tiny):
    jcfg, _, np_params, kw = tiny
    prompt = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    sampling = dict(temperature=np.full((2,), 0.9, np.float32), seeds=np.array([3, 4]))
    got = group.run(mu.llama_generate, np_params, prompt, kw, "dp=2,tp=2", 6, **sampling)
    assert all(np.array_equal(g, got[0]) for g in got)
    one = group.run(mu.llama_generate, np_params, prompt, kw, "dp=1", 6, **sampling)[0]
    assert got[0] is not None
    np.testing.assert_array_equal(got[0], one)
