"""The port's continuous engine (modelx_tpu_torch.dl.continuous) on the CPU.

The exactness oracle everywhere: a request decoded by the engine yields
exactly the tokens of the same request on the plain paths, the JAX
package's (``ModelServer.generate``, its ragged decode) and the port's,
greedy by argmax and seeded sampled rows because the (seed, step) streams
ride per slot, at every pipeline and dispatch depth. A tiny fp32 llama (2
layers, the JAX package's ``LlamaConfig.tiny``) written by the JAX package,
inputs from ``np.random.RandomState``. Scheduling: mid-decode joins, more
requests than slots (FIFO), grouped admissions, prefix-cache second turns,
chunked prefill with its budget and preemption, stream close freeing the
slot.
"""

import concurrent.futures
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.models import llama as jl
from modelx_tpu_torch.dl.continuous import ContinuousBatcher
from modelx_tpu_torch.dl.serve import ModelServer
from modelx_tpu_torch.models.decode import PrefixKVCache
from modelx_tpu_torch.models.speculative import SpeculativeDecoder

SAMPLED = {"temperature": 0.8, "top_k": 12, "top_p": 0.9, "seed": 41}
N_NEW = 10


def write_tiny_fp32(dirpath: str) -> None:
    """tests/test_lifecycle.py's write_tiny, in fp32 and with llama-3's
    rope_theta (the value config inference assumes)."""
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), rope_theta=500000.0, dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    os.makedirs(dirpath, exist_ok=True)
    jst.write_safetensors(os.path.join(dirpath, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})


def _prompts():
    rng = np.random.RandomState(0)
    return {
        "short": rng.randint(1, 512, (1, 5)).astype(np.int32),
        "mid": rng.randint(1, 512, (1, 13)).astype(np.int32),
        "long": rng.randint(1, 512, (1, 40)).astype(np.int32),
    }


REQUESTS = [("short", {}), ("mid", SAMPLED), ("long", {}), ("long", SAMPLED),
            ("mid", {"temperature": 1.1, "seed": 3})]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-engine"))
    write_tiny_fp32(d)
    server = ModelServer(d, dtype="float32", device="cpu", max_seq_len=96)
    server.load()
    jserver = JaxModelServer(d, mesh_spec="dp=1", dtype="float32", max_seq_len=96)
    jserver.load()
    prompts = _prompts()
    want = {}
    for name, samp in REQUESTS:
        key = (name, tuple(sorted(samp.items())))
        jax_out = np.asarray(jserver.generate(prompts[name], max_new_tokens=N_NEW, **samp))
        port_out = server.generate(prompts[name], max_new_tokens=N_NEW, **samp)
        assert np.array_equal(jax_out, port_out), key  # the two plain paths agree
        want[key] = port_out
    return {"server": server, "prompts": prompts, "want": want, "jserver": jserver}


def _want(model, name, samp):
    return model["want"][(name, tuple(sorted(samp.items())))]


def _concurrently(fn, args):
    with concurrent.futures.ThreadPoolExecutor(len(args)) as pool:
        return list(pool.map(fn, args))


@pytest.mark.parametrize("pipeline_depth", [1, 2, 3])
@pytest.mark.parametrize("dispatch_depth", [1, 2, 4])
def test_tokens_equal_the_plain_paths_at_every_depth(model, pipeline_depth, dispatch_depth):
    cb = ContinuousBatcher(model["server"], max_slots=4, chunk_size=4,
                           pipeline_depth=pipeline_depth, dispatch_depth=dispatch_depth)
    try:
        got = _concurrently(
            lambda r: cb.generate(model["prompts"][r[0]], max_new_tokens=N_NEW, **r[1]),
            REQUESTS)
        for (name, samp), g in zip(REQUESTS, got):
            np.testing.assert_array_equal(g, _want(model, name, samp))
        if dispatch_depth > 1 and pipeline_depth == 1:
            # a lone steady row decodes several chunks per dispatch
            cb.generate(model["prompts"]["short"], max_new_tokens=40)
            assert cb.stats["dispatch_depth_max"] > 1
    finally:
        cb.close()


def test_stream_concatenates_to_generate_and_multirow(model):
    server = model["server"]
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4)
    try:
        tokens = model["prompts"]["mid"]
        pieces = list(cb.stream(tokens, max_new_tokens=N_NEW, **SAMPLED))
        assert pieces[0].shape == (1, 1)  # the prefill token alone
        assert all(p.shape[1] <= 4 for p in pieces)
        np.testing.assert_array_equal(np.concatenate(pieces, axis=1),
                                      _want(model, "mid", SAMPLED)[:, 13:])
        two = np.random.RandomState(1).randint(1, 512, (2, 7)).astype(np.int32)
        np.testing.assert_array_equal(cb.generate(two, max_new_tokens=6, **SAMPLED),
                                      server.generate(two, max_new_tokens=6, **SAMPLED))
    finally:
        cb.close()


def test_mid_decode_join(model):
    server = model["server"]
    # one chunk per dispatch: the first row is still decoding at the join
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, dispatch_depth=1)
    try:
        long_tokens = model["prompts"]["long"]
        res = {}
        t = threading.Thread(target=lambda: res.update(
            long=cb.generate(long_tokens, max_new_tokens=40)))
        t.start()
        deadline = time.monotonic() + 30
        while cb.stats["chunks"] < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert cb._rows, "the first row should still be decoding"
        joined = cb.generate(model["prompts"]["mid"], max_new_tokens=N_NEW, **SAMPLED)
        t.join()
        np.testing.assert_array_equal(joined, _want(model, "mid", SAMPLED))
        np.testing.assert_array_equal(res["long"],
                                      server.generate(long_tokens, max_new_tokens=40))
        assert cb.stats["admitted"] == 2 and cb.stats["active_peak"] == 2
    finally:
        cb.close()


def test_more_requests_than_slots_admit_fifo(model):
    server = model["server"]
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, burst_window_ms=0)
    try:
        rng = np.random.RandomState(2)
        reqs = [rng.randint(1, 512, (1, 3 + i)).astype(np.int32) for i in range(5)]
        tickets = [cb.submit(r[0].tolist(), 6, {}, request_id=f"r{i}")
                   for i, r in enumerate(reqs)]
        for r, tk in zip(reqs, tickets):
            got = np.concatenate(list(cb._drain_row(tk.out)), axis=1)
            np.testing.assert_array_equal(got, server.generate(r, max_new_tokens=6)[:, r.shape[1]:])
        admits = [e["request_id"] for e in cb.flightrec.events() if e["event"] == "admit"]
        assert admits == [f"r{i}" for i in range(5)]
        assert cb.stats["active_peak"] == 2
        stamps = [tk.t_admit for tk in tickets]
        assert stamps == sorted(stamps)
    finally:
        cb.close()


def test_grouped_admission_pads_to_a_power_of_two(model):
    server = model["server"]
    cb = ContinuousBatcher(server, max_slots=8, chunk_size=4)
    try:
        rng = np.random.RandomState(3)
        three = rng.randint(1, 512, (3, 9)).astype(np.int32)  # one bucket, one burst
        got = cb.generate(three, max_new_tokens=7, **SAMPLED)
        np.testing.assert_array_equal(got, server.generate(three, max_new_tokens=7, **SAMPLED))
        assert cb.stats["admit_batches"] == 1 and cb.stats["admit_pad_rows"] == 1
    finally:
        cb.close()


def test_prefix_cache_second_turn_matches_plain(model):
    server = model["server"]
    pc = PrefixKVCache(capacity=4)
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, prefix_cache=pc)
    try:
        turn1 = model["prompts"]["mid"]
        out1 = cb.generate(turn1, max_new_tokens=6)
        np.testing.assert_array_equal(out1, server.generate(turn1, max_new_tokens=6))
        turn2 = np.concatenate([out1, np.asarray([[7, 8, 9]], np.int32)], axis=1)
        for samp in ({}, SAMPLED):
            np.testing.assert_array_equal(cb.generate(turn2, max_new_tokens=8, **samp),
                                          server.generate(turn2, max_new_tokens=8, **samp))
        assert pc.stats()["hits"] >= 2
        # entries stay bucketed to their PROMPT's 16-quantum
        assert all(v["k0"].shape[1] % 16 == 0 for v in pc._od.values())
    finally:
        cb.close()


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
@pytest.mark.parametrize("samp", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_installed_prefix_kv_resumes_exactly_and_is_counted(model, page_size, samp):
    """A prefix captured on one engine, bundled (dl/kv_store.py) and
    installed into a second engine's cache: the second decodes from it the
    tokens of a local prefill and of the JAX package's plain path, exactly
    in fp32, and counts the admission in ``prefix_hits_installed``."""
    from modelx_tpu_torch.dl import kv_store

    server = model["server"]
    history = model["prompts"]["mid"][0].tolist()
    turn2 = np.asarray([history + [4, 4, 2]], np.int32)
    pc1 = PrefixKVCache(capacity=4)
    cb1 = ContinuousBatcher(server, max_slots=4, chunk_size=4, page_size=page_size,
                            prefix_cache=pc1)
    try:
        cb1.generate(np.asarray([history], np.int32), max_new_tokens=4, **samp)
        local = cb1.generate(turn2, max_new_tokens=7, **samp)  # a local hit
        assert cb1.stats["prefix_hits_installed"] == 0
    finally:
        cb1.close()
    entry = dict(pc1.take_publishable(1))[tuple(history)]
    _fwd, init = server.family.decode_fns(server.params, server.cfg)
    pc2 = PrefixKVCache(capacity=4)
    stats = kv_store.install_bundle(kv_store.build_bundle(history, entry), init, pc2)
    assert stats["installed"] == 1, stats["reasons"]
    cb2 = ContinuousBatcher(server, max_slots=4, chunk_size=4, page_size=page_size,
                            prefix_cache=pc2)
    try:
        got = cb2.generate(turn2, max_new_tokens=7, **samp)
        installed = cb2.stats["prefix_hits_installed"]
        admits = [e for e in cb2.flightrec.events() if e["event"] == "dispatch_admit"]
    finally:
        cb2.close()
    want = np.asarray(model["jserver"].generate(turn2, max_new_tokens=7, **samp))
    np.testing.assert_array_equal(local, want)
    np.testing.assert_array_equal(got, want)
    assert installed == 1 and pc2.hits_installed == 1
    assert [e["installed_kv"] for e in admits] == [True]


def test_chunked_prefill_matches_plain_and_interleaves_with_decode(model):
    server = model["server"]
    # one chunk per dispatch: the decode row then outlasts the fill's pieces
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, prefill_chunk=16,
                           dispatch_depth=1)
    try:
        np.testing.assert_array_equal(
            cb.generate(model["prompts"]["long"], max_new_tokens=N_NEW, **SAMPLED),
            _want(model, "long", SAMPLED))
        assert cb.stats["prefill_pieces"] == 3  # 40 tokens -> 16 + 16 + 8
        # a decode row keeps emitting while a long prompt fills: no two
        # pieces without a decode chunk between them ("p": a piece after the
        # decode row ended, with nothing left to interleave)
        order: list[str] = []
        chunk, piece = cb._chunk, cb._piece
        cb._chunk = lambda *a: (order.append("C"), chunk(*a))[1]
        cb._piece = lambda *a: (order.append("P" if cb._rows else "p"), piece(*a))[1]
        dec = model["prompts"]["short"]
        long48 = np.random.RandomState(9).randint(1, 512, (1, 48)).astype(np.int32)
        res = {}
        chunks0 = cb.stats["chunks"]
        t = threading.Thread(target=lambda: res.update(dec=cb.generate(dec, max_new_tokens=40)))
        t.start()
        deadline = time.monotonic() + 30
        while cb.stats["chunks"] - chunks0 < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        res["long"] = cb.generate(long48, max_new_tokens=4)
        t.join()
        np.testing.assert_array_equal(res["dec"], server.generate(dec, max_new_tokens=40))
        np.testing.assert_array_equal(res["long"], server.generate(long48, max_new_tokens=4))
        seq = "".join(order)
        assert seq.lower().count("p") == 3 and seq.count("P") >= 2 and "PP" not in seq, seq
    finally:
        cb.close()


def test_prefill_budget_lands_one_piece_per_boundary(model):
    server = model["server"]
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, prefill_chunk=16,
                           prefill_budget=16)
    try:
        rng = np.random.RandomState(10)
        a, b = (rng.randint(1, 512, (1, 40)).astype(np.int32) for _ in range(2))
        per_boundary: list[int] = []
        dispatch = cb._dispatch_pieces

        def spy(spend):
            before = cb.stats["prefill_pieces"]
            landed = dispatch(spend)
            per_boundary.append(cb.stats["prefill_pieces"] - before)
            return landed

        cb._dispatch_pieces = spy
        tickets = cb.submit_many([(a[0].tolist(), 5, {}), (b[0].tolist(), 5, {})])
        for src, tk in zip((a, b), tickets):
            got = np.concatenate(list(cb._drain_row(tk.out)), axis=1)
            np.testing.assert_array_equal(got, server.generate(src, max_new_tokens=5)[:, 40:])
        assert cb.stats["prefill_pieces"] == 6
        assert max(per_boundary) == 1  # only the exempt head piece per boundary
    finally:
        cb.close()


def test_fill_contention_preempts_the_youngest_and_stays_exact(model):
    server = model["server"]
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, page_size=16,
                           max_live_tokens=80, prefill_chunk=16)
    try:
        rng = np.random.RandomState(18)
        a, b = (rng.randint(1, 512, (1, 40)).astype(np.int32) for _ in range(2))
        tickets = cb.submit_many([(a[0].tolist(), 8, {}), (b[0].tolist(), 8, {})])
        for src, tk in zip((a, b), tickets):
            got = np.concatenate(list(cb._drain_row(tk.out)), axis=1)
            np.testing.assert_array_equal(got, server.generate(src, max_new_tokens=8)[:, 40:])
        assert cb.stats["fill_preempts"] >= 1
        assert tickets[1].timing()["preempts"] >= 1
        assert cb.stats["pages_free"] == cb.num_pages - 1
    finally:
        cb.close()


def test_stream_close_frees_the_slot(model):
    server = model["server"]
    cb = ContinuousBatcher(server, max_slots=1, chunk_size=4)
    try:
        gen = cb.stream(model["prompts"]["short"], max_new_tokens=60)
        next(gen)
        next(gen)
        gen.close()  # the client went away
        deadline = time.monotonic() + 10
        while (cb._rows or len(cb._free) != 1) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not cb._rows and cb._free == [0]
        # the one slot serves the next request exactly
        np.testing.assert_array_equal(
            cb.generate(model["prompts"]["mid"], max_new_tokens=N_NEW, **SAMPLED),
            _want(model, "mid", SAMPLED))
    finally:
        cb.close()


def test_speculation_in_the_engine_equals_plain_greedy(model):
    server = model["server"]
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, speculative_k=4)
    try:
        periodic = np.tile(np.asarray([[3, 17, 99, 5]], np.int32), (1, 6))
        got = cb.generate(periodic, max_new_tokens=20)
        np.testing.assert_array_equal(got, server.generate(periodic, max_new_tokens=20))
        # proposals and accepts are the plain speculative decoder's, step for step
        with torch.inference_mode():
            dec_toks, dec = SpeculativeDecoder(
                *server.family.decode_fns(server.params, server.cfg), k=4).generate(
                    server.params, periodic[0].tolist(), 20)
        assert dec_toks == got[0, periodic.shape[1]:].tolist()
        assert dec["accepted"] > 0
        assert (cb.stats["spec_steps"], cb.stats["spec_proposed"], cb.stats["spec_accepted"]) == (
            dec["device_steps"] - 1, dec["proposed"], dec["accepted"])  # less its prefill
        # a sampled row never speculates, and stays exact
        np.testing.assert_array_equal(
            cb.generate(model["prompts"]["mid"], max_new_tokens=N_NEW, **SAMPLED),
            _want(model, "mid", SAMPLED))
    finally:
        cb.close()


def test_resume_rejoins_the_sample_stream_at_step_k(model):
    cb = ContinuousBatcher(model["server"], max_slots=2, chunk_size=4)
    try:
        tokens = model["prompts"]["mid"]
        whole = _want(model, "mid", SAMPLED)[0, 13:].tolist()
        k = 4
        resumed = np.concatenate(list(cb.stream(
            np.asarray([tokens[0].tolist() + whole[:k]], np.int32),
            max_new_tokens=N_NEW - k, resume_step=k, **SAMPLED)), axis=1)
        assert whole[:k] + resumed[0].tolist() == whole
        timing: dict = {}
        list(cb.stream(tokens, max_new_tokens=3, timing=timing))
        assert {"queue_ms", "prefill_ms", "ttft_ms"} <= set(timing)
    finally:
        cb.close()


def test_snapshot_and_validation(model):
    cb = ContinuousBatcher(model["server"], max_slots=2, chunk_size=4)
    try:
        cb.generate(model["prompts"]["short"], max_new_tokens=12)
        snap = cb.snapshot()
        assert snap["engine_state"] == "running" and snap["active"] == 0
        assert snap["admitted"] == 1 and snap["chunks"] >= 3
        assert snap["ttft_ms_hist"]["count"] == 1 and snap["queue_ms_hist"]["count"] == 1
        assert snap["host_syncs_per_boundary"] <= 1
        assert "boundary_host_ms_p50" in snap and snap["mesh"] == "dp=1"
        with pytest.raises(ValueError, match="max_len"):
            cb.submit(list(range(1, 90)), 10, {})
        with pytest.raises(ValueError, match="empty prompt"):
            cb.submit([], 4, {})
    finally:
        cb.close()
    with pytest.raises(RuntimeError, match="closed"):
        cb.submit([1, 2], 3, {})
    cb.release_device_state()
    assert cb._cache is None and cb._tok is None
