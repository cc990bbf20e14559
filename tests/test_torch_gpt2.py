"""Port gpt2 (modelx_tpu_torch.models.gpt2) against the JAX package, on the CPU.

The JAX package's tiny preset (2 layers, 64 positions) and init, with the
zero biases and unit layer norms moved off their init values so they are
exercised, handed over as numpy arrays. Tolerances: fp32 logits atol
1e-5, as tests/test_torch_llama.py (observed 2.7e-7: logits are small
with 0.02-scale weights); ``layer_norm`` and ``conv1d`` atol 1e-6 in fp32
and equal bits in bf16 (one rounding of an fp32 result); greedy and
seeded sampled tokens exactly. The context bound answers JAX's 400 bodies.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_family_util as fu
from modelx_tpu.models import gpt2 as jg
from modelx_tpu.ops import nn as jnn
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import gpt2 as tg
from modelx_tpu_torch.ops import nn as tnn

FP32_ATOL = 1e-5


def _model(vocab: int = 256):
    jcfg = jg.GPT2Config(**{**jg.GPT2Config.tiny().__dict__, "vocab_size": vocab})
    jparams = jg.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    jparams = {k: (np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(np.float32)
                   if k.endswith(".bias") or "ln_" in k else np.asarray(v))
               for k, v in jparams.items()}
    fields = [f for f in tg.GPT2Config.__dataclass_fields__ if f != "dtype"]
    tcfg = tg.GPT2Config(**{f: getattr(jcfg, f) for f in fields}, dtype=torch.float32)
    tparams = from_jax_params(jparams, device="cpu")
    return jcfg, {k: jnp.asarray(v) for k, v in jparams.items()}, tcfg, tparams


@pytest.fixture(scope="module")
def fp32_gpt2():
    return _model()


def _tokens(vocab, shape, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_conv1d_match_jax(dtype):
    rng = np.random.RandomState(2)
    x, w, b = (rng.normal(0, s, shape).astype(np.float32)
               for s, shape in ((2.0, (3, 5, 32)), (0.2, (32, 48)), (0.1, (48,))))
    g, beta = rng.normal(1, 0.1, (32,)).astype(np.float32), rng.normal(0, 0.1, (32,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    ln_j = np.asarray(jnn.layer_norm(jx, jnp.asarray(g, jd), jnp.asarray(beta, jd), 1e-5))
    ln_t = tnn.layer_norm(tx, torch.from_numpy(g).to(td), torch.from_numpy(beta).to(td), 1e-5)
    if dtype == "float32":  # JAX's CPU has no bf16 x bf16 -> fp32 dot: conv1d in fp32 only
        c_j = np.asarray(jnn.conv1d(jx, jnp.asarray(w), jnp.asarray(b)))
        c_t = tnn.conv1d(tx, torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(c_t.numpy(), c_j, atol=1e-6)
        np.testing.assert_allclose(ln_t.numpy(), ln_j, atol=1e-6)
    else:
        np.testing.assert_array_equal(ln_t.float().numpy(), ln_j.astype(np.float32))


def test_forward_logits_fp32(fp32_gpt2):
    jcfg, jp, tcfg, tp = fp32_gpt2
    tok = _tokens(jcfg.vocab_size, (2, 40))
    jlog = np.asarray(jg.forward(jp, jnp.asarray(tok), jcfg)[0])
    tlog, cache = tg.forward(tp, torch.as_tensor(tok), tcfg)
    assert cache is None and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=FP32_ATOL)


def test_bf16_forward_keeps_fp32_logits(fp32_gpt2):
    """The head's fp32 accumulator is the logits, as in the twin."""
    _, _, tcfg, tp = fp32_gpt2
    bf = {k: v.bfloat16() for k, v in tp.items()}
    cfg = tg.GPT2Config(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    logits = tg.forward(bf, torch.as_tensor(_tokens(cfg.vocab_size, (1, 8))), cfg)[0]
    assert logits.dtype == torch.float32


def test_cached_decode_equals_cache_free_forward(fp32_gpt2):
    _, _, tcfg, tp = fp32_gpt2
    tok = torch.as_tensor(_tokens(tcfg.vocab_size, (2, 30), seed=3))
    free = tg.forward(tp, tok, tcfg)[0]
    cache = tg.init_kv_cache(tcfg, 2, 32)
    pre, _ = tg.forward(tp, tok[:, :8], tcfg, kv_cache=cache, cache_offset=0)
    torch.testing.assert_close(pre, free[:, :8], atol=FP32_ATOL, rtol=0)
    offsets = torch.tensor([8, 8])
    for t in range(8, 30):  # a [B] offset: the ragged path's per-row positions
        step, _ = tg.forward(tp, tok[:, t:t + 1], tcfg, kv_cache=cache, cache_offset=offsets)
        torch.testing.assert_close(step[:, 0], free[:, t], atol=FP32_ATOL, rtol=0)
        offsets = offsets + 1


def test_greedy_and_sampled_tokens_equal_jax(fp32_gpt2):
    jcfg, jp, tcfg, tp = fp32_gpt2
    tok = _tokens(jcfg.vocab_size, (3, 14), seed=5)
    lens = np.array([14, 6, 11], np.int32)
    samp = dict(temperature=np.array([0.0, 0.9, 1.2], np.float32),
                top_k=np.array([0, 20, 0], np.int32), top_p=np.array([1.0, 1.0, 0.9], np.float32),
                seeds=np.array([0, 5, 9], np.int32))
    jout = np.asarray(jg.ragged_greedy_generate(jp, jnp.asarray(tok), jnp.asarray(lens), jcfg,
                                                max_new_tokens=8,
                                                **{k: jnp.asarray(v) for k, v in samp.items()}))
    tout = tg.ragged_greedy_generate(tp, torch.as_tensor(tok), lens, tcfg, max_new_tokens=8,
                                     **{k: torch.as_tensor(v) for k, v in samp.items()})
    np.testing.assert_array_equal(tout.numpy(), jout)


def test_context_check_refuses_as_jax(fp32_gpt2):
    jcfg, jp, tcfg, tp = fp32_gpt2
    tok = _tokens(jcfg.vocab_size, (1, 60))
    with pytest.raises(ValueError) as want:
        jg.ragged_greedy_generate(jp, jnp.asarray(tok), jnp.asarray([60]), jcfg, max_new_tokens=8)
    with pytest.raises(ValueError) as got:
        tg.ragged_greedy_generate(tp, torch.as_tensor(tok), np.array([60]), tcfg,
                                  max_new_tokens=8)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    _, jp, _, _ = _model()
    d = fu.write_checkpoint(str(tmp_path_factory.mktemp("gpt2")), jp)
    p = fu.Pods(d, "gpt2")
    yield p
    p.close()


_LONG = np.random.RandomState(9).randint(0, 256, (1, 65)).tolist()
REQUESTS = fu.parity_requests(256) + [
    # past the 64-position table: the JAX sidecar's 400 bodies
    ("/v1/forward", {"tokens": _LONG}),
    ("/v1/generate", {"tokens": [_LONG[0][:60]], "max_new_tokens": 8}),
    ("/v1/generate", {"tokens": [_LONG[0][:60]], "max_new_tokens": 8, "stream": True}),
    ("/v1/generate", {"tokens": [_LONG[0][:56]], "max_new_tokens": 8}),  # exactly 64: served
]


@pytest.mark.parametrize("path,body", REQUESTS, ids=[f"{i}{p}" for i, (p, _) in
                                                       enumerate(REQUESTS)])
def test_http_bodies_identical_to_jax_pod(pods, path, body):
    (js, jb), (ts, tb) = pods.both(path, body)
    assert (ts, tb) == (js, jb)
    assert js == (400 if len(body["tokens"][0]) + body.get("max_new_tokens", 0) > 64 else 200)


@pytest.mark.parametrize("mode", sorted(fu.ENGINE_MODES))
def test_continuous_engine_equals_jax_generate(pods, mode):
    reqs = fu.engine_requests(256)
    got = fu.engine_tokens(pods.server, reqs, mode, n_new=10)
    for (prompt, samp), g in zip(reqs, got):
        want = np.asarray(pods.jserver.generate(prompt, max_new_tokens=10, **samp))
        np.testing.assert_array_equal(g, want)


def test_engine_max_len_clamps_to_n_positions(tmp_path):
    """--kv-page-size 48 with --max-seq-len 256: max_len clamps to the 64
    positions, then down to a page multiple (48), as the JAX sidecar does."""
    from modelx_tpu.registry.server import free_port
    from modelx_tpu_torch.dl import serve_main

    _, jp, _, _ = _model()
    d = fu.write_checkpoint(str(tmp_path), jp)
    sset, httpd = serve_main.start([
        "--model", f"gpt2={d}", "--device", "cpu", "--dtype", "float32", "--max-seq-len", "256",
        "--continuous-batch", "--kv-page-size", "48", "--listen", f"127.0.0.1:{free_port()}"])
    try:
        cb = sset.continuous_for(sset.servers["gpt2"])
        assert cb.max_len == 48 and cb.page_size == 48
    finally:
        httpd.shutdown()
        httpd.server_close()
        for cb in sset.cbatchers.values():
            cb.close()
