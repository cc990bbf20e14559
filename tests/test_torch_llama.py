"""Port llama (modelx_tpu_torch.models) against the JAX package, on the CPU.

Both packages get the same params (the JAX package's init, handed over as
numpy arrays) and the same token ids. Tolerances: fp32 logits atol 1e-5
(the same math in another summation order; observed 3.2e-6); bf16 logits
atol 0.1 over logits of magnitude ~4, where one bf16 ulp is 0.03 (both
frameworks round every activation to bf16, at slightly different points
through 2 layers; observed 0.039); greedy tokens are compared exactly, in fp32 only (a bf16
argmax near-tie can flip between frameworks).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.models import decode as jdecode
from modelx_tpu.models import llama as jl
from modelx_tpu.ops import nn as jnn
from modelx_tpu.ops import quant as jquant
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import decode as tdecode
from modelx_tpu_torch.models import llama as tl
from modelx_tpu_torch.ops import attention as tattn
from modelx_tpu_torch.ops import nn as tnn
from modelx_tpu_torch.ops import quant as tquant

FP32_ATOL = 1e-5
BF16_ATOL = 0.1

_CFG_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
               "num_kv_heads", "head_dim", "rope_theta", "rms_eps", "tie_embeddings",
               "qkv_bias")


def port_cfg(jcfg, dtype):
    return tl.LlamaConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS}, dtype=dtype)


def _model(variant: str, dtype: str):
    jcfg = jl.LlamaConfig.tiny()
    if variant == "qwen2":
        jcfg = dataclasses.replace(jcfg, qkv_bias=True, rms_eps=1e-6)
    elif variant == "tied":
        jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcfg = dataclasses.replace(jcfg, dtype=jdt)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jdt)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jcfg, jparams, port_cfg(jcfg, getattr(torch, dtype)), tparams


@pytest.fixture(scope="module")
def fp32_llama():
    return _model("llama", "float32")


def _tokens(cfg, shape=(2, 16), seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("variant", ["llama", "qwen2", "tied"])
def test_forward_logits_fp32(variant):
    jcfg, jp, tcfg, tp = _model(variant, "float32")
    tok = _tokens(jcfg)
    jlog = np.asarray(jl.forward(jp, jnp.asarray(tok), jcfg)[0])
    tlog, cache = tl.forward(tp, torch.as_tensor(tok), tcfg)
    assert cache is None and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=FP32_ATOL)


def test_forward_logits_bf16():
    jcfg, jp, tcfg, tp = _model("llama", "bfloat16")
    tok = _tokens(jcfg)
    jlog = np.asarray(jl.forward(jp, jnp.asarray(tok), jcfg)[0]).astype(np.float32)
    tlog = tl.forward(tp, torch.as_tensor(tok), tcfg)[0]
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(tlog.float().numpy(), jlog, atol=BF16_ATOL)


def test_flash_impl_on_cpu_equals_reference(fp32_llama):
    """attention_impl="flash" on CPU tensors runs the wrapper's plain
    version: identical logits to the reference path, no kernel launch."""
    _, _, tcfg, tp = fp32_llama
    tok = torch.as_tensor(_tokens(tcfg))
    before = tattn.flash_attention.launches
    a = tl.forward(tp, tok, tcfg, attention_impl="flash")[0]
    b = tl.forward(tp, tok, tcfg, attention_impl="reference")[0]
    assert torch.equal(a, b)
    assert tattn.flash_attention.launches == before


def test_cached_prefill_matches_cache_free_forward(fp32_llama):
    _, _, tcfg, tp = fp32_llama
    tok = torch.as_tensor(_tokens(tcfg, (2, 12)))
    cache = tl.init_kv_cache(tcfg, 2, 20)
    cached, cache = tl.forward(tp, tok, tcfg, kv_cache=cache, cache_offset=0)
    free = tl.forward(tp, tok, tcfg)[0]
    torch.testing.assert_close(cached, free, atol=FP32_ATOL, rtol=0)
    assert cache["k0"][:, 12:].abs().sum() == 0  # nothing past the prompt


def test_greedy_generate_tokens_equal_fp32(fp32_llama):
    jcfg, jp, tcfg, tp = fp32_llama
    tok = _tokens(jcfg, (2, 10), seed=5)
    jout = np.asarray(jl.greedy_generate(jp, jnp.asarray(tok), jcfg, max_new_tokens=8))
    # the port's one decode path, every row a whole prompt (what /v1/generate runs)
    tout = tl.ragged_greedy_generate(tp, torch.as_tensor(tok), [10, 10], tcfg,
                                     max_new_tokens=8)
    assert tout.shape == (2, 8)
    np.testing.assert_array_equal(tout.numpy(), jout[:, 10:])


def test_ragged_greedy_generate_tokens_equal_fp32(fp32_llama):
    jcfg, jp, tcfg, tp = fp32_llama
    tok = _tokens(jcfg, (3, 12), seed=6)
    row_lens = np.array([12, 5, 9], np.int32)
    jout = np.asarray(jl.ragged_greedy_generate(
        jp, jnp.asarray(tok), jnp.asarray(row_lens), jcfg, max_new_tokens=7))
    tout = tl.ragged_greedy_generate(
        tp, torch.as_tensor(tok), torch.as_tensor(row_lens), tcfg, max_new_tokens=7)
    np.testing.assert_array_equal(tout.numpy(), jout)


def test_generate_zero_new_tokens(fp32_llama):
    _, _, tcfg, tp = fp32_llama
    tok = torch.as_tensor(_tokens(tcfg, (1, 4)))
    assert tl.ragged_greedy_generate(tp, tok, torch.tensor([4]), tcfg, 0).shape == (1, 0)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 4, 32).astype(np.float32)
    w = rng.rand(32).astype(np.float32)
    pos = np.stack([np.arange(5), np.arange(5) + 11])
    np.testing.assert_allclose(
        tl._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), atol=1e-6)
    np.testing.assert_allclose(
        tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jl._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), atol=2e-5)


def test_linear_matches_jax_with_bias_after_cast():
    rng = np.random.RandomState(8)
    x = rng.randn(3, 4, 16).astype(np.float32)
    w = rng.randn(8, 16).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    np.testing.assert_allclose(
        tnn.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jnn.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), atol=1e-5)
    # an int8 QTensor weight: the scale on the fp32 product, the bias after the cast
    np.testing.assert_allclose(
        tnn.linear(torch.from_numpy(x), tquant.quantize(w), torch.from_numpy(b)).numpy(),
        np.asarray(jnn.linear(jnp.asarray(x), jquant.quantize(w), jnp.asarray(b))), atol=1e-5)


def test_param_names_shapes_and_init():
    for jcfg in (jl.LlamaConfig.tiny(), dataclasses.replace(jl.LlamaConfig.tiny(), qkv_bias=True,
                                                            tie_embeddings=True)):
        tcfg = port_cfg(jcfg, torch.float32)
        assert tl.param_names(tcfg) == jl.param_names(jcfg)
        assert tl.param_shapes(tcfg) == jl.param_shapes(jcfg)
    tcfg = tl.LlamaConfig.tiny()
    a = tl.init_params(tcfg, torch.Generator().manual_seed(3))
    b = tl.init_params(tcfg, torch.Generator().manual_seed(3))
    assert sorted(a) == sorted(tl.param_names(tcfg))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(tuple(a[n].shape) == s for n, s in tl.param_shapes(tcfg).items())
    assert torch.equal(a["model.norm.weight"], torch.ones(tcfg.hidden_size, dtype=torch.bfloat16))
    assert tl.LlamaConfig.llama3_8b() == tl.LlamaConfig()


def test_decode_helpers_match_jax():
    for s in (1, 15, 16, 17, 300):
        assert tdecode.pad_seq_len(s) == jdecode.pad_seq_len(s)
    for toks, stops in (([4, 5, 6, 5], {5}), ([1, 2], {9}), ([1, 2], set())):
        assert tdecode.stop_cut(toks, stops) == jdecode.stop_cut(toks, stops)


def test_later_slice_features_raise(fp32_llama):
    _, _, tcfg, tp = fp32_llama
    tok = torch.as_tensor(_tokens(tcfg, (1, 4)))
    # the paged branch (the continuous engine's in-place step) is
    # single-token only, as in the JAX package
    pools = {n: torch.zeros((3, 4) + c.shape[2:]) for n, c in tl.init_kv_cache(
        tcfg, 1, 4, dtype=torch.float32).items()}
    with pytest.raises(ValueError, match="paged decode is single-token only"):
        tl.forward(tp, tok, tcfg, kv_cache=pools, cache_offset=torch.zeros(1, dtype=torch.long),
                   paged_table=torch.zeros((1, 1), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="multi-device"):
        tl._attend(*(torch.zeros(1, 4, 2, 32),) * 3, causal=True, q_offset=0, impl="ring")
