"""Port mixtral (modelx_tpu_torch.models.mixtral) against the JAX package, on the CPU.

The JAX package's tiny preset (2 layers, 4 experts, top 2) and init,
handed over as numpy arrays. Tolerances: fp32 logits atol 1e-5, as
tests/test_torch_llama.py (llama's attention, the MoE block of
tests/test_torch_moe.py); greedy and seeded sampled tokens exactly, in
fp32. The HTTP pods serve the checkpoint in HF's per-expert layout, so
both loaders fold the experts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_family_util as fu
from modelx_tpu.models import mixtral as jm
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import llama as tl
from modelx_tpu_torch.models import mixtral as tm

FP32_ATOL = 1e-5


def _model(vocab: int = 512, capacity_factor: float = 0.0):
    jcfg = dataclasses.replace(jm.MixtralConfig.tiny(vocab_size=vocab), dtype=jnp.float32,
                               capacity_factor=capacity_factor)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    fields = [f for f in tm.MixtralConfig.__dataclass_fields__ if f != "dtype"]
    tcfg = tm.MixtralConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=torch.float32)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def fp32_mixtral():
    return _model()


def _tokens(vocab, shape, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def test_param_shapes_equal_jax():
    jcfg, _, tcfg, _ = _model()
    assert tm.param_shapes(tcfg) == jm.param_shapes(jcfg)


@pytest.mark.parametrize("factor", [0.0, 0.5])
def test_forward_logits_fp32(factor):
    """Drop-free (Mixtral's math) and under a capacity that drops tokens."""
    jcfg, jp, tcfg, tp = _model(capacity_factor=factor)
    tok = _tokens(jcfg.vocab_size, (2, 24))
    jlog = np.asarray(jm.forward(jp, jnp.asarray(tok), jcfg)[0])
    tlog, cache = tm.forward(tp, torch.as_tensor(tok), tcfg)
    assert cache is None
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=FP32_ATOL)


def test_mlp_fn_replaces_the_dense_ffn(fp32_mixtral):
    """llama.decoder_layer with an ``mlp_fn``: the block's FFN is the hook's
    output, no dense SwiGLU param is read."""
    _, _, tcfg, tp = fp32_mixtral
    acfg = tm._attn_config(tcfg)
    lp = {s: tp["model.layers.0." + s] for s in tm.ATTN_SUFFIXES}
    x = torch.randn(1, 5, tcfg.hidden_size, generator=torch.Generator().manual_seed(0))
    pos = tl.positions_for(torch.zeros(1, 5, dtype=torch.long), False)
    seen = []
    out, _ = tl.decoder_layer(lp, x, pos, acfg, mlp_fn=lambda h: seen.append(h) or 2 * h)
    no_ffn, _ = tl.decoder_layer(lp, x, pos, acfg, mlp_fn=torch.zeros_like)
    torch.testing.assert_close(out, no_ffn + 2 * seen[0], atol=1e-6, rtol=0)


def test_from_hf_state_dict_equals_jax():
    rng = np.random.RandomState(3)
    sd = {f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}.weight":
          rng.normal(0, 1, (6, 4)).astype(np.float32)
          for i in range(2) for e in range(3) for w in ("w1", "w2", "w3")}
    sd["model.norm.weight"] = np.ones(4, np.float32)
    want, got = jm.from_hf_state_dict(sd), tm.from_hf_state_dict(sd)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_cached_decode_equals_cache_free_forward(fp32_mixtral):
    _, _, tcfg, tp = fp32_mixtral
    tok = torch.as_tensor(_tokens(tcfg.vocab_size, (2, 20), seed=3))
    free = tm.forward(tp, tok, tcfg)[0]
    cache = tm.init_kv_cache(tcfg, 2, 24)
    pre, _ = tm.forward(tp, tok[:, :8], tcfg, kv_cache=cache, cache_offset=0)
    torch.testing.assert_close(pre, free[:, :8], atol=FP32_ATOL, rtol=0)
    for t in range(8, 20):
        step, _ = tm.forward(tp, tok[:, t:t + 1], tcfg, kv_cache=cache, cache_offset=t)
        torch.testing.assert_close(step[:, 0], free[:, t], atol=FP32_ATOL, rtol=0)


def test_greedy_and_sampled_tokens_equal_jax(fp32_mixtral):
    jcfg, jp, tcfg, tp = fp32_mixtral
    tok = _tokens(jcfg.vocab_size, (3, 14), seed=5)
    lens = np.array([14, 6, 11], np.int32)
    samp = dict(temperature=np.array([0.0, 0.9, 1.2], np.float32),
                top_k=np.array([0, 20, 0], np.int32), top_p=np.array([1.0, 1.0, 0.9], np.float32),
                seeds=np.array([0, 5, 9], np.int32))
    jout = np.asarray(jm.ragged_greedy_generate(jp, jnp.asarray(tok), jnp.asarray(lens), jcfg,
                                                max_new_tokens=8,
                                                **{k: jnp.asarray(v) for k, v in samp.items()}))
    tout = tm.ragged_greedy_generate(tp, torch.as_tensor(tok), lens, tcfg, max_new_tokens=8,
                                     **{k: torch.as_tensor(v) for k, v in samp.items()})
    np.testing.assert_array_equal(tout.numpy(), jout)


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Both pods over a checkpoint in HF's per-expert layout."""
    _, jp, _, _ = _model(vocab=256)
    hf = chip_smoke.hf_expert_layout({k: np.asarray(v) for k, v in jp.items()})
    assert "model.layers.0.block_sparse_moe.experts.3.w1.weight" in hf
    d = fu.write_checkpoint(str(tmp_path_factory.mktemp("mixtral")), hf)
    p = fu.Pods(d, "mixtral")
    yield p
    p.close()


REQUESTS = fu.parity_requests(256)


def test_pods_fold_the_experts(pods):
    w1 = "model.layers.1.block_sparse_moe.experts.w1.weight"
    assert tuple(pods.server.params[w1].shape) == (4, 256, 128)
    np.testing.assert_array_equal(pods.server.params[w1].numpy(),
                                  np.asarray(pods.jserver.params[w1]))


@pytest.mark.parametrize("path,body", REQUESTS, ids=[f"{i}{p}" for i, (p, _) in
                                                       enumerate(REQUESTS)])
def test_http_bodies_identical_to_jax_pod(pods, path, body):
    (js, jb), (ts, tb) = pods.both(path, body)
    assert (ts, tb) == (js, jb)
    assert js == 200


@pytest.mark.parametrize("mode", sorted(fu.ENGINE_MODES))
def test_continuous_engine_equals_jax_generate(pods, mode):
    reqs = fu.engine_requests(256)
    got = fu.engine_tokens(pods.server, reqs, mode, n_new=10)
    for (prompt, samp), g in zip(reqs, got):
        want = np.asarray(pods.jserver.generate(prompt, max_new_tokens=10, **samp))
        np.testing.assert_array_equal(g, want)
