"""The port's dynamic batcher (dl/serve.py Batcher, ServerSet routing)
against the JAX package's on the CPU.

Tolerance: equality in fp32. ``_pack`` gives JAX's batch and spans; one
concurrent group of forward, greedy and seeded sampled requests gives the
JAX Batcher's arrays, each also equal to the same request sent alone to the
server; malformed tokens and a closed batcher fail as in JAX, and only the
requested tokens count as generated.
"""

import dataclasses
import os
import threading
from concurrent.futures import Future

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.serve import Batcher as JaxBatcher
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.models import llama as jl
from modelx_tpu_torch.dl.serve import Batcher, ModelServer, ServerSet

V = 96


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("batch"))
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V), rope_theta=500000.0,
                              dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    jst.write_safetensors(os.path.join(d, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})
    js = JaxModelServer(d, mesh_spec="dp=1", dtype="float32")
    js.load()
    ts = ModelServer(d, dtype="float32", device="cpu")
    ts.load()
    return js, ts


@pytest.mark.parametrize("shapes", [
    [(1, 5)], [(1, 16)], [(2, 3), (1, 17), (3, 9)], [(4, 1), (4, 31)], [(1, 40)] * 5,
])
def test_pack_equals_jax(shapes):
    rng = np.random.RandomState(len(shapes))
    rows = [rng.randint(0, V, s).astype(np.int32) for s in shapes]
    want_batch, want_spans = JaxBatcher._pack(rows)
    got_batch, got_spans = Batcher._pack(rows)
    np.testing.assert_array_equal(got_batch, want_batch)
    assert got_batch.dtype == want_batch.dtype and got_spans == want_spans


def _requests():
    rng = np.random.RandomState(7)
    toks = lambda b, s: rng.randint(0, V, (b, s)).astype(np.int32)  # noqa: E731
    return [
        ("fwd", toks(1, 12), {}),
        ("fwd", toks(2, 30), {}),
        ("fwd", toks(1, 5), {}),
        ("gen", toks(1, 9), {"max_new_tokens": 6}),
        ("gen", toks(2, 20), {"max_new_tokens": 11}),
        ("gen", toks(1, 14), {"max_new_tokens": 5, "temperature": 0.8, "top_k": 30,
                              "seed": 11}),
        ("gen", toks(2, 7), {"max_new_tokens": 9, "temperature": 1.1, "top_p": 0.9,
                             "seed": 4}),
        ("gen", toks(1, 3), {"max_new_tokens": 4, "top_k": 5}),  # greedy: stray filter
    ]


def _run_group(batcher, requests):
    """Submit every request at once from its own thread; the window and
    max_batch are sized so they all land in one group."""
    out = [None] * len(requests)
    gate = threading.Barrier(len(requests))

    def go(i, kind, tokens, kw):
        gate.wait()
        out[i] = (batcher.forward_argmax(tokens) if kind == "fwd"
                  else batcher.generate(tokens, **kw))

    threads = [threading.Thread(target=go, args=(i, *r)) for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def test_mixed_group_equals_jax_batcher_and_lone_requests(servers):
    js, ts = servers
    reqs = _requests()
    jb = JaxBatcher(js, max_batch=len(reqs), window_ms=5000)
    tb = Batcher(ts, max_batch=len(reqs), window_ms=5000)
    try:
        generated = ts.stats["tokens_generated"]
        want = _run_group(jb, reqs)
        got = _run_group(tb, reqs)
        # one group: its forwards as one padded forward, its generates as
        # one ragged decode
        assert tb.batches == jb.batches == 2
        assert ts.stats["tokens_generated"] - generated == sum(
            t.shape[0] * kw["max_new_tokens"] for k, t, kw in reqs if k == "gen")
    finally:
        jb.close()
        tb.close()
    for (kind, tokens, kw), g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        alone = ts.forward_argmax(tokens) if kind == "fwd" else ts.generate(tokens, **kw)
        np.testing.assert_array_equal(g, alone)


def test_malformed_tokens_and_a_closed_batcher_fail_as_jax(servers):
    js, ts = servers
    jb, tb = JaxBatcher(js), Batcher(ts)
    try:
        for bad in (np.zeros((0, 3), np.int32), np.zeros((2, 0), np.int32),
                    np.zeros((4,), np.int32)):
            with pytest.raises(ValueError) as want:
                jb.forward_argmax(bad)
            with pytest.raises(ValueError) as got:
                tb.forward_argmax(bad)
            assert str(got.value) == str(want.value)
    finally:
        jb.close()
        tb.close()
    for b in (jb, tb):
        with pytest.raises(RuntimeError, match="batcher is closed"):
            b.generate(np.ones((1, 3), np.int32), max_new_tokens=2)
        b._thread.join(timeout=10)
        assert not b._thread.is_alive()


def test_a_request_racing_close_fails_rather_than_hangs(servers):
    _, ts = servers
    tb = Batcher(ts, window_ms=1)
    tb.close()
    tb._thread.join(timeout=10)
    # a request that slipped into the queue after the sentinel was consumed
    fut = Future()
    tb._q.put(("fwd", np.ones((1, 2), np.int32), 0, None, fut))
    tb._drain_closed()
    with pytest.raises(RuntimeError, match="batcher is closed"):
        fut.result(timeout=5)


def test_server_set_routes_through_the_batcher(servers):
    _, ts = servers
    plain = ServerSet({"m": ts})
    assert plain.batcher_for(ts) is None and plain.engine_for(ts, 3, 0.0) is ts
    sset = ServerSet({"m": ts}, dynamic_batch=True, max_batch=4, batch_window_ms=1.5)
    try:
        b = sset.batcher_for(ts)
        assert isinstance(b, Batcher) and sset.batcher_for(ts) is b
        assert b.max_batch == 4 and b.window_s == 1.5e-3
        assert sset.engine_for(ts, 1, 0.0) is b and sset.engine_for(ts, 2, 0.7) is b
    finally:
        sset.close()
    assert sset.batchers == {}
    with pytest.raises(RuntimeError, match="batcher is closed"):
        b.forward_argmax(np.ones((1, 2), np.int32))
