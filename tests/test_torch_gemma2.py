"""Port gemma2 (modelx_tpu_torch.models.gemma2) against the JAX package, on the CPU.

The JAX package's tiny preset (2 layers, a sliding window of 16 on layer
0), its init with the zero-centred norm weights moved off zero (so the
(1 + w) scale is exercised), handed over as numpy arrays. Prompts are
longer than the window, so it cuts. Tolerances: fp32 logits atol 1e-5, as
tests/test_torch_llama.py (the attention softcap's and the final softcap's
tanh in fp32 need no looser bound: observed 3.3e-6 on logits up to 7.5);
bf16 logits atol 0.1, as for llama (one bf16 ulp is 0.03 at 7.4; both
frameworks round every activation through 2 layers, at slightly different
points; observed 0.031); greedy tokens exactly, in fp32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_family_util as fu
from modelx_tpu.models import gemma2 as jg
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import gemma2 as tg
from modelx_tpu_torch.ops import attention as tattn

FP32_ATOL = 1e-5
BF16_ATOL = 0.1


def port_cfg(jcfg, dtype):
    fields = [f for f in tg.Gemma2Config.__dataclass_fields__ if f != "dtype"]
    return tg.Gemma2Config(**{f: getattr(jcfg, f) for f in fields}, dtype=dtype)


def _model(dtype: str = "float32", vocab: int = 512):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcfg = dataclasses.replace(jg.Gemma2Config.tiny(vocab_size=vocab), dtype=jdt)
    jparams = jg.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.RandomState(1)
    jparams = {k: (np.asarray(v) + rng.normal(0, 0.2, v.shape).astype(np.float32)
                   if k.endswith("norm.weight") else np.asarray(v)) for k, v in jparams.items()}
    jparams = {k: jnp.asarray(v, jdt) for k, v in jparams.items()}
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jcfg, jparams, port_cfg(jcfg, getattr(torch, dtype)), tparams


@pytest.fixture(scope="module")
def fp32_gemma2():
    return _model()


def _tokens(vocab, shape, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def test_forward_logits_fp32_past_the_window(fp32_gemma2):
    jcfg, jp, tcfg, tp = fp32_gemma2
    tok = _tokens(jcfg.vocab_size, (2, 40))
    jlog = np.asarray(jg.forward(jp, jnp.asarray(tok), jcfg)[0])
    tlog, cache = tg.forward(tp, torch.as_tensor(tok), tcfg)
    assert cache is None and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=FP32_ATOL)
    # the window cuts: the same forward with a window past the prompt differs
    wide = dataclasses.replace(tcfg, sliding_window=64)
    assert not np.allclose(tg.forward(tp, torch.as_tensor(tok), wide)[0].numpy(), jlog,
                           atol=1e-3)


def test_forward_logits_bf16():
    jcfg, jp, tcfg, tp = _model("bfloat16")
    tok = _tokens(jcfg.vocab_size, (2, 24))
    jlog = np.asarray(jg.forward(jp, jnp.asarray(tok), jcfg)[0]).astype(np.float32)
    tlog = tg.forward(tp, torch.as_tensor(tok), tcfg)[0]
    assert tlog.dtype == torch.bfloat16  # the final softcap casts back
    np.testing.assert_allclose(tlog.float().numpy(), jlog, atol=BF16_ATOL)


def test_rms_norm_and_normaliser_match_jax():
    """(1 + w) in fp32 before the cast, in bf16 where the order shows."""
    rng = np.random.RandomState(2)
    x = rng.normal(0, 3, (3, 64)).astype(np.float32)
    w = rng.normal(0, 0.5, (64,)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jg._rms_norm(jx, jw, 1e-6)).astype(np.float32)
    got = tg._rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-6)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_flash_impl_on_cpu_equals_reference(fp32_gemma2):
    """attention_impl "flash" on CPU tensors is the wrapper's plain version:
    the same logits, with the scale, softcap and window, no launch."""
    _, _, tcfg, tp = fp32_gemma2
    tok = torch.as_tensor(_tokens(tcfg.vocab_size, (1, 30)))
    before = tattn.flash_attention.launches
    a = tg.forward(tp, tok, tcfg, attention_impl="flash")[0]
    b = tg.forward(tp, tok, tcfg, attention_impl="reference")[0]
    assert torch.equal(a, b) and tattn.flash_attention.launches == before


def test_cached_decode_equals_cache_free_forward(fp32_gemma2):
    """A prefill then one-token steps through the dense cache, past the
    window: every step's logits are the cache-free forward's."""
    _, _, tcfg, tp = fp32_gemma2
    tok = torch.as_tensor(_tokens(tcfg.vocab_size, (2, 36), seed=3))
    free = tg.forward(tp, tok, tcfg)[0]
    cache = tg.init_kv_cache(tcfg, 2, 40)
    pre, _ = tg.forward(tp, tok[:, :10], tcfg, kv_cache=cache, cache_offset=0)
    torch.testing.assert_close(pre, free[:, :10], atol=FP32_ATOL, rtol=0)
    for t in range(10, 36):
        step, _ = tg.forward(tp, tok[:, t:t + 1], tcfg, kv_cache=cache, cache_offset=t)
        torch.testing.assert_close(step[:, 0], free[:, t], atol=FP32_ATOL, rtol=0)


def test_greedy_tokens_equal_jax(fp32_gemma2):
    jcfg, jp, tcfg, tp = fp32_gemma2
    tok = _tokens(jcfg.vocab_size, (2, 20), seed=5)
    jout = np.asarray(jg.greedy_generate(jp, jnp.asarray(tok), jcfg, max_new_tokens=10))
    tout = tg.ragged_greedy_generate(tp, torch.as_tensor(tok), [20, 20], tcfg, max_new_tokens=10)
    np.testing.assert_array_equal(tout.numpy(), jout[:, 20:])


def test_ragged_sampled_tokens_equal_jax(fp32_gemma2):
    jcfg, jp, tcfg, tp = fp32_gemma2
    tok = _tokens(jcfg.vocab_size, (3, 24), seed=6)
    lens = np.array([24, 9, 17], np.int32)
    samp = dict(temperature=np.array([0.0, 0.9, 1.2], np.float32),
                top_k=np.array([0, 20, 0], np.int32), top_p=np.array([1.0, 1.0, 0.9], np.float32),
                seeds=np.array([0, 5, 9], np.int32))
    jout = np.asarray(jg.ragged_greedy_generate(jp, jnp.asarray(tok), jnp.asarray(lens), jcfg,
                                                max_new_tokens=8,
                                                **{k: jnp.asarray(v) for k, v in samp.items()}))
    tout = tg.ragged_greedy_generate(tp, torch.as_tensor(tok), lens, tcfg, max_new_tokens=8,
                                     **{k: torch.as_tensor(v) for k, v in samp.items()})
    np.testing.assert_array_equal(tout.numpy(), jout)


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    jcfg, jp, _, _ = _model(vocab=256)
    d = fu.write_checkpoint(str(tmp_path_factory.mktemp("gemma2")), jp)
    p = fu.Pods(d, "gemma2")
    yield p
    p.close()


REQUESTS = fu.parity_requests(256, seq=24)


@pytest.mark.parametrize("path,body", REQUESTS, ids=[f"{i}{p}" for i, (p, _) in
                                                       enumerate(REQUESTS)])
def test_http_bodies_identical_to_jax_pod(pods, path, body):
    (js, jb), (ts, tb) = pods.both(path, body)
    assert (ts, tb) == (js, jb)
    assert js == 200


@pytest.mark.parametrize("mode", sorted(fu.ENGINE_MODES))
def test_continuous_engine_equals_jax_generate(pods, mode):
    """Dense, paged gather and paged in place (the window and softcap in
    ops/paged_attention.py): each request's tokens are the JAX plain
    path's, prompts up to 30 tokens plus 10 past the 16-key window."""
    reqs = fu.engine_requests(256)
    got = fu.engine_tokens(pods.server, reqs, mode, n_new=10)
    for (prompt, samp), g in zip(reqs, got):
        want = np.asarray(pods.jserver.generate(prompt, max_new_tokens=10, **samp))
        np.testing.assert_array_equal(g, want)
