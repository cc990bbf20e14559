"""Prompt-lookup speculation in the port (models/speculative.py and the
ModelServer's speculative branch) against the JAX package on the CPU.

Tolerance: equality. ``ngram_propose`` and ``_NgramIndex`` answer JAX's on
random sequences; ``SpeculativeDecoder.generate`` and ``stream`` give JAX's
tokens, chunks and stats in fp32, greedy and seeded sampled (the port draws
``jax.random``'s bits), on prompts that repeat so that proposals are
accepted; a ``speculative_k`` server streams and generates JAX's tokens.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.models import llama as jl
from modelx_tpu.models import speculative as jspec
from modelx_tpu_torch.dl.serve import ModelServer, ServerSet
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import llama as tl
from modelx_tpu_torch.models import speculative as tspec


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "dtype"}
    tcfg = tl.LlamaConfig(**fields, dtype=torch.float32)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")

    def jfwd(p, t, kv_cache, cache_offset, mesh=None):
        return jl.forward(p, t, jcfg, kv_cache=kv_cache, cache_offset=cache_offset)

    tfwd, tinit = tl.decode_fns(tparams, tcfg)
    # one JAX decoder per k: each instance compiles its programs anew
    jdecs = {k: jspec.SpeculativeDecoder(jfwd, lambda b, n: jl.init_kv_cache(jcfg, b, n), k=k)
             for k in (4, 8)}
    return (jparams, jfwd, jdecs), (tparams, tfwd, tinit)


@pytest.mark.parametrize("seed", range(6))
def test_ngram_propose_and_index_agree_with_jax(seed):
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, 2 + seed, 60).tolist()  # small alphabets: many repeats
    jidx, tidx = jspec._NgramIndex(3), tspec._NgramIndex(3)
    jidx.extend(seq[:5], 0)
    tidx.extend(seq[:5], 0)
    for end in range(5, len(seq) + 1):
        prefix = seq[:end]
        for k in (1, 4, 8):
            for max_ngram in (1, 2, 3):
                assert tspec.ngram_propose(prefix, k, max_ngram) == jspec.ngram_propose(
                    prefix, k, max_ngram)
            assert tidx.propose(prefix, k) == jidx.propose(prefix, k)
        if end < len(seq):
            jidx.extend(seq[:end + 1], end)
            tidx.extend(seq[:end + 1], end)
    assert tspec.ngram_propose([], 4) == [] and tspec.ngram_propose([1], 4) == []


PROMPTS = {
    "loop": [7, 8, 9, 10, 7, 8, 9, 10, 7, 8],
    "pair": [5, 6, 5, 6, 5, 6, 5, 6],
    "arbitrary": [3, 41, 17, 26, 11, 60, 2],
}
SAMPLING = {
    "greedy": {},
    "temperature": {"temperature": 0.3, "seed": 7},
    "filtered": {"temperature": 1.2, "top_k": 20, "top_p": 0.9, "seed": 3},
}


@pytest.mark.parametrize("samp", list(SAMPLING), ids=list(SAMPLING))
@pytest.mark.parametrize("k,prompt", [(4, p) for p in PROMPTS] + [(8, "loop")],
                         ids=[f"4-{p}" for p in PROMPTS] + ["8-loop"])
def test_decoder_generate_and_stream_equal_jax(model, prompt, samp, k):
    (jp, _, jdecs), (tp, tfwd, tinit) = model
    ids, kw, n = PROMPTS[prompt], SAMPLING[samp], 14
    want, want_stats = jdecs[k].generate(jp, ids, n, **kw)
    dec = tspec.SpeculativeDecoder(tfwd, tinit, k=k)
    got, got_stats = dec.generate(tp, ids, n, **kw)
    assert got == want
    assert got_stats == want_stats
    jstats, tstats = {"device_steps": 0, "proposed": 0, "accepted": 0}, {
        "device_steps": 0, "proposed": 0, "accepted": 0}
    jpieces = [p.tolist() for p in jdecs[k].stream(jp, ids, n, stats=jstats, **kw)]
    tpieces = [p.tolist() for p in dec.stream(tp, ids, n, stats=tstats, **kw)]
    assert tpieces == jpieces and tstats == jstats
    assert [t for p in tpieces for t in p[0]] == got


@pytest.mark.parametrize("samp", list(SAMPLING), ids=list(SAMPLING))
def test_the_parity_cases_accept_proposals(model, samp):
    """The parity cases above reach the acceptance path: for each sampling
    mode some prompt has proposals accepted (and some rejected)."""
    (jp, _, jdecs), _ = model
    stats = [jdecs[4].generate(jp, ids, 14, **SAMPLING[samp])[1] for ids in PROMPTS.values()]
    assert any(s["accepted"] > 0 for s in stats), stats
    assert any(s["proposed"] > s["accepted"] for s in stats), stats


def test_speculative_generate_equals_jax(model):
    (jp, jfwd, jdecs), (tp, tfwd, tinit) = model
    jinit = jdecs[4].init_kv_cache
    prompt = np.asarray([PROMPTS["loop"]], np.int32)
    want, want_stats = jspec.speculative_generate(jfwd, jinit, jp, prompt, 12, k=4)
    got, got_stats = tspec.speculative_generate(tfwd, tinit, tp, prompt, 12, k=4)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got_stats == want_stats
    for n in (1, 2, 5):  # the budget holds exactly; cut acceptances do not count
        got, stats = tspec.speculative_generate(tfwd, tinit, tp, prompt[:, :6], n, k=8)
        assert got.shape == (1, 6 + n) and stats["accepted"] <= n
    with pytest.raises(ValueError, match="single-row"):
        tspec.speculative_generate(tfwd, tinit, tp, np.zeros((2, 4), np.int32), 4)


@pytest.fixture(scope="module")
def servers(model, tmp_path_factory):
    (jp, _, _), _ = model
    d = str(tmp_path_factory.mktemp("spec"))
    jst.write_safetensors(os.path.join(d, "model.safetensors"),
                          {k: np.asarray(v) for k, v in jp.items()})
    js = JaxModelServer(d, mesh_spec="dp=1", dtype="float32", speculative_k=4)
    js.load()
    ts = ModelServer(d, dtype="float32", device="cpu", speculative_k=4)
    ts.load()
    return js, ts


@pytest.mark.parametrize("samp", list(SAMPLING), ids=list(SAMPLING))
def test_server_speculates_jax_tokens(servers, samp):
    js, ts = servers
    tokens = np.asarray([PROMPTS["pair"]], np.int32)
    kw = SAMPLING[samp]
    steps = ts.stats.get("spec_device_steps", 0)
    np.testing.assert_array_equal(ts.generate(tokens, max_new_tokens=12, **kw),
                                  js.generate(tokens, max_new_tokens=12, **kw))
    assert ts.stats["spec_device_steps"] > steps and ts.stats["spec_proposed"] > 0
    want = [p.tolist() for p in js.generate_stream(tokens, max_new_tokens=12, **kw)]
    got = [p.tolist() for p in ts.generate_stream(tokens, max_new_tokens=12, **kw)]
    assert got == want


def test_server_stream_stops_at_a_stop_token(servers):
    js, ts = servers
    tokens = np.asarray([PROMPTS["pair"]], np.int32)
    whole = ts.generate(tokens, max_new_tokens=12)[0, tokens.shape[1]:].tolist()
    stop = whole[5]
    want = [p.tolist() for p in js.generate_stream(tokens, max_new_tokens=12,
                                                   stop_token_ids=[stop])]
    generated = ts.stats["tokens_generated"]
    got = [p.tolist() for p in ts.generate_stream(tokens, max_new_tokens=12,
                                                  stop_token_ids=[stop])]
    assert got == want
    flat = [t for p in got for t in p[0]]
    assert flat == whole[: whole.index(stop) + 1]
    assert ts.stats["tokens_generated"] == generated + len(flat)


def test_engine_for_routes_single_rows_to_speculation(servers):
    _, ts = servers
    sset = ServerSet({"m": ts}, dynamic_batch=True)
    try:
        assert sset.engine_for(ts, 1, 0.0) is ts
        assert sset.engine_for(ts, 1, 0.8) is ts
        assert sset.engine_for(ts, 2, 0.0) is sset.batchers["m"]
    finally:
        sset.close()
