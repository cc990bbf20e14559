"""Every serving option of llama on a mesh of processes, against the JAX
package on the same mesh, on the CPU.

The port's pods run in one 4-process gloo group for the module
(``tests/torch_mesh_util.py mesh_pod``: rank 0 serves, the others replay
its op log); the JAX side runs on the forced host devices at the same mesh
spec. The checkpoint is ``LlamaConfig.tiny(vocab_size=64)`` in fp32;
prompts come from ``np.random.RandomState``. Tolerances:

- tokens (the continuous engine dense and paged, greedy, sampled and
  multi-row; speculation; prefix-cache streams; a batcher burst; an
  admin-loaded model) equal exactly, as the reference's own oracle holds
  its engine to its plain path on one mesh
  (``tests/test_sharding_mesh.py:437-441``);
- int8 codes and scales equal the unsharded load bit for bit, the
  row-parallel o_proj and down_proj included (``tests/test_quant.py:78``);
- a LoRA merge on tp=2 within rtol 1e-5 of the JAX merge
  (``tests/test_lora.py:103``);
- ``logprobs`` within 1e-5 (atol) of the JAX sidecar's;
- a KV bundle's recorded specs equal the JAX ``build_bundle``'s.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_family_util as fu
import torch_mesh_util as mu
from modelx_tpu.dl import kv_store as jkv
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.continuous import ContinuousBatcher as JaxContinuousBatcher
from modelx_tpu.dl.lora import merge_adapter as jax_merge_adapter
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import ServerSet as JaxServerSet
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port

SPEC = "dp=2,tp=2"
MAX_SEQ = 96
LOGPROB_ATOL = 1e-5
LORA_RTOL = 1e-5


@pytest.fixture(scope="module")
def group():
    g = mu.GlooGroup(4)
    yield g
    g.close()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    return fu.write_checkpoint(str(tmp_path_factory.mktemp("mesh-options")), params), params


@pytest.fixture(scope="module")
def qwen2_ckpt(tmp_path_factory):
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), dtype=jnp.float32,
                              qkv_bias=True)
    params = jl.init_params(cfg, jax.random.PRNGKey(1))
    return fu.write_checkpoint(str(tmp_path_factory.mktemp("mesh-qwen2")), params), params


@pytest.fixture(scope="module")
def jserver(ckpt):
    srv = JaxModelServer(ckpt[0], mesh_spec=SPEC, dtype="float32", max_seq_len=MAX_SEQ)
    srv.load()
    return srv


def _prompts(seed: int, lens) -> list:
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 64, (n,)).tolist() for n in lens]


# -- the continuous engine ----------------------------------------------------------


ENGINE_CASES = [  # (tokens, max_new_tokens, sampling): the reference's three
    ([[5, 9, 2, 7, 1]], 11, {}),
    ([[3, 4, 5]], 9, {"temperature": 0.8, "top_k": 12, "top_p": 0.9, "seed": 41}),
    ([[5, 9, 2], [8, 1, 1]], 6, {}),
]


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_the_engine_equals_the_jax_engine_on_the_mesh(group, ckpt, jserver, page_size):
    cb = JaxContinuousBatcher(jserver, max_slots=4, chunk_size=4, page_size=page_size)
    try:
        want = [np.asarray(cb.generate(np.asarray(t, np.int32), max_new_tokens=n, **samp))
                for t, n, samp in ENGINE_CASES]
    finally:
        cb.close()
    set_kw = {"continuous_batch": True, "max_slots": 4, "stream_chunk_size": 4,
              "kv_page_size": page_size}
    out, snap, shapes = group.run(mu.mesh_pod, ckpt[0], SPEC, {}, set_kw, "drive_engine",
                                  (ENGINE_CASES,))[0]
    for (engine, plain), expect in zip(out, want):
        np.testing.assert_array_equal(engine, expect)
        np.testing.assert_array_equal(engine, plain)  # the reference's own oracle
    assert (snap["mesh"], snap["mesh_devices"]) == (SPEC, 4)
    # this rank's leaves: dense, slots over dp and kv heads over tp; paged,
    # the page dim whole (global) and kv heads over tp
    if page_size:
        assert shapes["k0"][1:] == (16, 1, 32) and shapes["k0"][0] > 4
    else:
        assert shapes["k0"] == (2, MAX_SEQ, 1, 32)


def test_chunked_prefill_and_prefix_hits_on_the_engine_at_dp2(group, ckpt, jserver):
    """Prefill pieces land on the slot's dp owner alone (the first token
    and the stored prefix reach the other dp ranks by a gather), and a
    prefix hit seeds a later fill: tokens equal the JAX engine's."""
    from modelx_tpu.models.decode import PrefixKVCache as JaxPrefixKVCache

    a = _prompts(11, [40])[0]
    cases = [([a], 6, {}), ([a + [3, 9, 4, 2, 8, 1, 7, 6, 5]], 6, {"temperature": 0.7,
                                                                      "seed": 2}),
             ([a[:20]], 5, {})]
    cb = JaxContinuousBatcher(jserver, max_slots=4, chunk_size=4, prefill_chunk=16,
                              prefix_cache=JaxPrefixKVCache(4))
    try:
        want = [np.asarray(cb.generate(np.asarray(t, np.int32), max_new_tokens=n, **samp))
                for t, n, samp in cases]
    finally:
        cb.close()
    out, snap, _shapes = group.run(
        mu.mesh_pod, ckpt[0], SPEC, {"prefix_cache_size": 4},
        {"continuous_batch": True, "max_slots": 4, "stream_chunk_size": 4, "prefill_chunk": 16},
        "drive_engine", (cases,))[0]
    for (engine, _plain), expect in zip(out, want):
        np.testing.assert_array_equal(engine, expect)
    assert snap["prefill_pieces"] > 0


def test_a_fill_seeds_from_the_prefix_entry_stored_when_it_starts(group, ckpt):
    """tp=2, one slot, one prefix entry: while conversation A decodes, the
    waiting E and C are looked up (C, an extension of A, hits A's entry);
    E's last prefill piece stores E's KV, which evicts A's on every rank,
    before C starts its fill. C decides its hit again when it starts (a
    miss now) and does not seed from the evicted entry: the tokens equal
    the JAX engine's and the mesh serves every row."""
    from modelx_tpu.models.decode import PrefixKVCache as JaxPrefixKVCache

    a, e, s = _prompts(12, [20, 30, 20])
    rows = [(a, 8, {}), (e, 4, {}), (a + s, 6, {"temperature": 0.7, "seed": 3})]
    jsrv = JaxModelServer(ckpt[0], mesh_spec="tp=2", dtype="float32", max_seq_len=MAX_SEQ)
    jsrv.load()
    cb = JaxContinuousBatcher(jsrv, max_slots=1, chunk_size=4, prefill_chunk=16,
                              prefix_cache=JaxPrefixKVCache(1))
    try:
        want = [np.asarray(cb.generate(np.asarray([ids], np.int32), max_new_tokens=n,
                                       **samp))[0, len(ids):].tolist()
                for ids, n, samp in rows]
    finally:
        cb.close()
    got, stats = group.run(
        mu.mesh_pod, ckpt[0], "tp=2", {"prefix_cache_size": 1},
        {"continuous_batch": True, "max_slots": 1, "stream_chunk_size": 4, "prefill_chunk": 16},
        "drive_engine_burst", (rows,))[0]
    assert got == want
    # A and E missed, C's lookup while it waited hit A's entry, and its
    # start found that entry evicted and missed
    assert (stats["hits"], stats["misses"]) == (1, 3)


def test_qwen2_on_the_engine_equals_the_jax_engine(group, qwen2_ckpt):
    jsrv = JaxModelServer(qwen2_ckpt[0], mesh_spec=SPEC, dtype="float32", max_seq_len=MAX_SEQ)
    jsrv.load()
    cb = JaxContinuousBatcher(jsrv, max_slots=4, chunk_size=4, page_size=16)
    try:
        want = [np.asarray(cb.generate(np.asarray(t, np.int32), max_new_tokens=n, **samp))
                for t, n, samp in ENGINE_CASES[:2]]
    finally:
        cb.close()
    out, _snap, _shapes = group.run(
        mu.mesh_pod, qwen2_ckpt[0], SPEC, {"prefix_cache_size": 2},
        {"continuous_batch": True, "max_slots": 4, "stream_chunk_size": 4, "kv_page_size": 16,
         "kv_attention": "in-place"}, "drive_engine", (ENGINE_CASES[:2],))[0]
    for (engine, plain), expect in zip(out, want):
        np.testing.assert_array_equal(engine, expect)
        np.testing.assert_array_equal(engine, plain)


def test_an_engine_crash_rebuilds_every_rank_and_serves_on(group, ckpt):
    first, crashed, again, restarts = group.run(
        mu.mesh_pod, ckpt[0], SPEC, {}, {"continuous_batch": True, "max_slots": 4,
                                        "stream_chunk_size": 4},
        "drive_engine_crash", ([[5, 9, 2, 7, 1]], 8))[0]
    assert crashed == "EngineBrokenError" and restarts == 1
    np.testing.assert_array_equal(again, first)


@pytest.mark.slow
def test_dp_only_mesh(group, ckpt):
    """dp=4: weights replicate, the cache shards its slot dim, and the
    engine equals the plain path, as in the reference's slow case."""
    tokens = [[5, 9, 2, 7]]
    out, snap, shapes = group.run(
        mu.mesh_pod, ckpt[0], "dp=4", {}, {"continuous_batch": True, "max_slots": 4,
                                          "stream_chunk_size": 4},
        "drive_engine", ([(tokens, 8, {})],))[0]
    engine, plain = out[0]
    np.testing.assert_array_equal(engine, plain)
    assert shapes["k0"] == (1, MAX_SEQ, 2, 32)


# -- int8 and LoRA on per-rank slices -------------------------------------------------


@pytest.mark.parametrize("spec", ["tp=2", "tp=4"])
@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_int8_codes_and_scales_equal_the_unsharded_load(group, ckpt, qwen2_ckpt, spec, family):
    from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors

    model_dir = (ckpt if family == "llama" else qwen2_ckpt)[0]
    src = LocalFileSource(os.path.join(model_dir, "model.safetensors"))
    try:
        whole, _ = load_safetensors(src, "cpu", quantize="int8")
    finally:
        src.close()
    ranks = [r for r in group.run(mu.loaded_slices, model_dir, spec, {"quantize": "int8"})
             if r is not None]
    seen = set()
    for params in ranks:
        for name, (box, val) in params.items():
            if not isinstance(val, tuple):
                continue
            rows, cols = (slice(*b) for b in box)
            np.testing.assert_array_equal(val[0], whole[name].q.numpy()[rows, cols], name)
            np.testing.assert_array_equal(val[1], whole[name].scale.numpy()[rows], name)
            if (cols.start, cols.stop) != (0, whole[name].q.shape[1]):
                seen.add(name.rsplit(".", 2)[-2])
    # the row-parallel weights really were split on their input dim
    assert {"o_proj", "down_proj"} <= seen


def _write_adapter(path: str, cfg, r: int = 4, alpha: int = 8, seed: int = 5) -> dict:
    rng = np.random.RandomState(seed)
    shapes = jl.param_shapes(cfg)
    pairs, tensors = {}, {}
    for target in ("model.layers.0.self_attn.q_proj.weight",
                   "model.layers.1.self_attn.o_proj.weight",
                   "model.layers.0.mlp.down_proj.weight", "model.layers.1.mlp.up_proj.weight"):
        out_f, in_f = shapes[target]
        a = (rng.randn(r, in_f) * 0.05).astype(np.float32)
        b = (rng.randn(out_f, r) * 0.05).astype(np.float32)
        stem = "base_model.model." + target[: -len(".weight")]
        tensors[f"{stem}.lora_A.weight"], tensors[f"{stem}.lora_B.weight"] = a, b
        pairs[target] = (a, b)
    os.makedirs(path, exist_ok=True)
    jst.write_safetensors(os.path.join(path, "adapter_model.safetensors"), tensors)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha}, f)
    return pairs


def test_lora_merged_on_a_tp_mesh_equals_the_jax_merge(group, ckpt, tmp_path):
    model_dir, params = ckpt
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), dtype=jnp.float32)
    pairs = _write_adapter(str(tmp_path / "ad"), cfg)
    merged = jax_merge_adapter(dict(params), str(tmp_path / "ad"))
    ranks = [r for r in group.run(mu.loaded_slices, model_dir, "tp=2",
                                  {"lora_dir": str(tmp_path / "ad")}) if r is not None]
    assert len(ranks) == 2
    for rank in ranks:
        for target in pairs:
            box, val = rank[target]
            want = np.asarray(merged[target])[tuple(slice(*b) for b in box)]
            np.testing.assert_allclose(val, want, rtol=LORA_RTOL)
            assert val.shape != tuple(np.shape(merged[target]))  # kept its split


# -- speculation, logprobs, the batcher -------------------------------------------------


def test_speculation_tokens_and_accepts_equal_the_jax_mesh(group, ckpt):
    jsrv = JaxModelServer(ckpt[0], mesh_spec=SPEC, dtype="float32", max_seq_len=MAX_SEQ,
                          speculative_k=4, name="m")
    jsrv.load()
    # repetitive prompts, so the n-gram proposals get accepted
    bodies = [{"tokens": [[7, 8, 9, 7, 8, 9, 7, 8]], "max_new_tokens": 12},
              {"tokens": [[1, 2, 3, 1, 2, 3]], "max_new_tokens": 10, "temperature": 0.7,
               "seed": 3},
              {"tokens": [[4, 5, 4, 5, 4]], "max_new_tokens": 9, "stream": True}]
    jhttpd = jax_serve(jsrv, listen=f"127.0.0.1:{free_port()}")
    try:
        want = [fu.call(jhttpd.server_address[1], "/v1/m/generate", b) for b in bodies]
        # the JAX sidecar counts device steps and accepted tokens
        jstats = {k: jsrv.stats.get(f"spec_{k}") for k in ("device_steps", "accepted")}
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    got, info = group.run(mu.mesh_pod, ckpt[0], SPEC, {"speculative_k": 4}, {}, "drive_http",
                          ([("POST", "/v1/m/generate", b) for b in bodies],))[0]
    assert got == want
    assert {k: info["stats"].get(f"spec_{k}") for k in jstats} == jstats
    assert jstats["accepted"] > 0


def test_logprobs_equal_the_jax_sidecar(group, ckpt, jserver):
    rows = [(_prompts(1, [9])[0], [3, 17, 40]), (_prompts(2, [5])[0], [8, 8]),
            (_prompts(3, [20])[0], [])]
    want = jserver.score_logprobs_rows(rows, top_k=3)
    got = group.run(mu.mesh_pod, ckpt[0], SPEC, {}, {}, "drive_scores", (rows, 3))[0]
    for (lp, tid, tlp), (jlp, jtid, jtlp) in zip(got, want):
        np.testing.assert_allclose(lp, np.asarray(jlp), atol=LOGPROB_ATOL)
        np.testing.assert_array_equal(tid, np.asarray(jtid))
        np.testing.assert_allclose(tlp, np.asarray(jtlp), atol=LOGPROB_ATOL)


def test_a_batcher_burst_answers_as_the_jax_sidecar(group, ckpt, jserver):
    prompts = _prompts(4, [5, 9, 3, 12, 7, 6])
    bodies = [{"tokens": [p], "max_new_tokens": 5} for p in prompts[:4]] + [
        {"tokens": [prompts[4]], "max_new_tokens": 6, "temperature": 0.9, "seed": 5},
        {"tokens": [prompts[5]]}]
    paths = ["/v1/m/generate"] * 5 + ["/v1/m/forward"]
    jhttpd = jax_serve(jserver, listen=f"127.0.0.1:{free_port()}")
    try:
        want = [fu.call(jhttpd.server_address[1], p.replace("/m/", "/"), b)
                for p, b in zip(paths, bodies)]
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    got, info = group.run(
        mu.mesh_pod, ckpt[0], SPEC, {}, {"dynamic_batch": True, "batch_window_ms": 200.0},
        "drive_http", ([("POST", p, b) for p, b in zip(paths, bodies)], True))[0]
    assert got == want
    # the burst coalesced: fewer device calls than requests
    assert 0 < info["batches"] < len(bodies)


# -- the prefix cache and KV bundles ----------------------------------------------------


def test_a_follower_replays_rank0_prefix_decisions(group, ckpt, jserver):
    """Rank 0 keeps 4 prefix entries, the followers' caches would keep 1:
    they still serve rank 0's hits (they never evict or look up on their
    own), and the streams equal the JAX sidecar's on the mesh."""
    a, b = _prompts(6, [9, 7])
    prompts = [a, b, a + [3, 4], b + [5], a + [3, 4, 9]]
    want = []
    for ids in prompts:
        pieces = jserver.generate_stream(np.asarray([ids], np.int32), max_new_tokens=6,
                                         chunk_size=4)
        want.append(np.concatenate(list(pieces), axis=1)[0].tolist())
    got, stats = group.run(mu.mesh_pod, ckpt[0], SPEC, {"prefix_cache_size": 4}, {},
                           "drive_streams", (prompts, 6, {}),
                           follower_kw={"prefix_cache_size": 1})[0]
    assert got == want
    assert stats["hits"] == 3


def test_kv_bundles_record_the_jax_specs_and_skip_another_mesh(group, ckpt, tmp_path):
    model_dir, _ = ckpt
    hot = [5, 6, 7, 8, 9]
    jpod = JaxModelServer(model_dir, mesh_spec=SPEC, dtype="float32", max_seq_len=64,
                          prefix_cache_size=4)
    jpod.load()
    for ids in (hot, hot + [4, 2]):
        list(jpod.generate_stream(np.asarray([ids], np.int32), max_new_tokens=6,
                                  chunk_size=4))
    (key, entry), = jpod._prefix_cache.take_publishable(1)
    jmeta = jkv._bundle_meta(jkv.build_bundle(list(key), entry, mesh=jpod.mesh))
    streamed, key, data = group.run(mu.mesh_pod, model_dir, SPEC, {"prefix_cache_size": 4},
                                    {}, "drive_kv_bundle", ([hot, hot + [4, 2]], 6))[0]
    from modelx_tpu_torch.dl import kv_store

    meta = kv_store._bundle_meta(data)
    assert key == hot and meta["mesh"] == jmeta["mesh"] == SPEC
    assert ([(leaf["shape"], leaf["spec"]) for leaf in meta["leaves"]]
            == [(leaf["shape"], leaf["spec"]) for leaf in jmeta["leaves"]])
    # a fresh pod on the same mesh installs it (each rank its heads) and
    # streams the extended prompt as the first pod did; another mesh skips it
    for spec, installed in ((SPEC, 1), ("tp=4", 0)):
        d = tmp_path / spec.replace(",", "_").replace("=", "")
        shutil.copytree(model_dir, d)
        (d / kv_store.bundle_name("mesh", "hot")).write_bytes(data)
        out, info = group.run(mu.mesh_pod, str(d), spec, {"prefix_cache_size": 4}, {},
                              "drive_http", ([("GET", "/v1/models", None)],))[0]
        stats = json.loads(out[0][1])["models"]["m"]["kv"]
        assert (stats["installed"], stats["skipped"]) == (installed, 1 - installed), stats
        if installed:
            got, cache = group.run(mu.mesh_pod, str(d), spec, {"prefix_cache_size": 4}, {},
                                   "drive_streams", ([hot + [4, 2]], 6, {}))[0]
            assert got == streamed[1:] and cache["hits_installed"] == 1


def test_a_bundle_of_an_entry_evicted_since_it_was_taken_is_not_built(group, ckpt):
    """A publishable entry evicted before its bundle's gather: rank 0 posts
    no gather for it (the followers dropped it), the build answers None and
    the mesh streams on, as before the eviction."""
    hot = [5, 6, 7, 8, 9]
    others = _prompts(13, [6, 7])
    streamed, data, again = group.run(
        mu.mesh_pod, ckpt[0], SPEC, {"prefix_cache_size": 2}, {}, "drive_kv_evicted",
        (hot, others, 6))[0]
    assert data is None and again == streamed[0]


# -- admin load and unload ------------------------------------------------------------


def test_admin_load_then_unload_on_the_mesh(group, ckpt, jserver):
    model_dir, _ = ckpt
    body = {"tokens": [_prompts(8, [6])[0]], "max_new_tokens": 7}
    jhttpd = jax_serve(JaxServerSet({"x": jserver}), listen=f"127.0.0.1:{free_port()}")
    try:
        want = fu.call(jhttpd.server_address[1], "/v1/x/generate", body)
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    requests = [("POST", "/admin/models", {"name": "x", "model_dir": model_dir, "wait": True}),
                ("POST", "/v1/x/generate", body),
                ("DELETE", "/admin/models/x", None),
                ("POST", "/v1/x/generate", body),
                ("POST", "/v1/m/generate", body)]
    got, _info = group.run(mu.mesh_pod, model_dir, SPEC, {}, {"allow_admin_load": True},
                           "drive_http", (requests,))[0]
    assert got[0][0] == 200 and json.loads(got[0][1])["x"]["state"] == "READY"
    assert got[1] == want  # the admin-loaded model answers on every rank
    assert got[2][0] == 200 and json.loads(got[2][1])["x"]["state"] == "UNLOADED"
    assert got[3][0] == 404
    assert got[4] == want  # the boot model serves on


def test_the_pool_keys_its_tiers_by_the_mesh(ckpt):
    from modelx_tpu_torch.dl.serve import ModelServer, ServerSet
    from modelx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh("tp=2", devices=2)
    sset = ServerSet({"m": ModelServer(ckpt[0], dtype="float32", device="cpu")}, mesh=mesh,
                     host_state_budget_bytes=1 << 20)
    plain = ServerSet({"m": ModelServer(ckpt[0], dtype="float32", device="cpu")},
                      host_state_budget_bytes=1 << 20)
    assert sset.pool.tiers.mesh_key == "tp=2" and plain.pool.tiers.mesh_key == ""
    pairs = [("model.safetensors", 10, "x")]
    # a spool of another layout never promotes: its key differs
    assert sset.pool.tiers.key_for(pairs) != plain.pool.tiers.key_for(pairs)
