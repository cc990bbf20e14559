"""``modelx-serve-torch --mesh`` on the CPU: one process per rank over gloo.

- A 2-rank port pod at ``--mesh tp=2`` (rank 0 starts rank 1 itself)
  answers ``/v1/forward`` and ``/v1/generate`` (greedy, seeded sampled,
  NDJSON streams; ``tests/torch_family_util.parity_requests``) with the
  same bytes as the JAX sidecar at ``--mesh dp=1,tp=2`` on the forced host
  devices, fp32. Its stats carry the mesh, and each rank read about half
  the checkpoint.
- Every serving option answers under a mesh as the JAX sidecar at
  ``dp=1,tp=2``: the window batcher, the continuous engine (one-shot and
  streamed), int8, speculation, the prefix cache, LoRA, ``logprobs``,
  admin load and unload (a 2-process gloo group, ``torch_mesh_util
  mesh_pod``; ``tests/test_torch_serve_mesh_options.py`` holds each at
  dp=2,tp=2). The families other than llama and qwen2 answer the typed
  501 with their slice; they refuse before any device work, so they run
  in process on a mesh with no process group.
- A request that fails the same way on every rank (a forward too long
  for the host's memory) answers its error, and the pod serves on.
- A killed follower: rank 0 answers 503 and exits non-zero within the
  group's timeout (``--mesh-timeout-s``).
- A mesh that needs more cards than the host has exits non-zero naming
  both counts; a ``--device`` that names one card is refused on a mesh of
  more than one rank, and no mesh is built without ``--mesh``.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_family_util as fu
import torch_mesh_util as mu
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import ServerSet as JaxServerSet
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.models import gpt2 as jgpt2
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl.serve import ModelServer, ServerSet, serve
from modelx_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_TIMEOUT_S = 20


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=96), rope_theta=500000.0,
                              dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return fu.write_checkpoint(str(tmp_path_factory.mktemp("mesh-serve")), params), cfg


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MODELX_") and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


class MeshPod:
    """A ``serve_main --mesh`` process (its followers are its children)."""

    def __init__(self, model_dir: str, mesh: str, *extra: str, log_path: str) -> None:
        self.port = free_port()
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "modelx_tpu_torch.dl.serve_main", "--model",
             f"m={model_dir}", "--device", "cpu", "--dtype", "float32", "--max-seq-len",
             str(fu.MAX_SEQ_LEN), "--listen", f"127.0.0.1:{self.port}", "--mesh", mesh,
             "--mesh-timeout-s", str(MESH_TIMEOUT_S), "--drain-seconds", "0", *extra],
            env=_env(), cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT)
        self.log_path = log_path
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, self.tail()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/healthz",
                                            timeout=2) as r:
                    if r.status == 200:
                        return
            except OSError:
                time.sleep(0.3)
        raise AssertionError("mesh pod never became ready:\n" + self.tail())

    def tail(self) -> str:
        with open(self.log_path) as f:
            return f.read()[-3000:]

    def follower_pids(self) -> list[int]:
        with open(self.log_path) as f:
            return [int(p) for p in re.findall(r"mesh rank \d+ pid (\d+)", f.read())]

    def close(self) -> int:
        if self.proc.poll() is None:
            self.proc.terminate()
        rc = self.proc.wait(timeout=60)
        self.log.close()
        return rc


@pytest.fixture(scope="module")
def pods(ckpt, tmp_path_factory):
    model_dir, _ = ckpt
    jserver = JaxModelServer(model_dir, mesh_spec="dp=1,tp=2", dtype="float32",
                             max_seq_len=fu.MAX_SEQ_LEN, name="m")
    jserver.load()
    jhttpd = jax_serve(jserver, listen=f"127.0.0.1:{free_port()}")
    pod = MeshPod(model_dir, "tp=2", log_path=str(tmp_path_factory.mktemp("pod") / "log"))
    yield jhttpd.server_address[1], pod
    jhttpd.shutdown()
    jhttpd.server_close()
    assert pod.close() == 0, pod.tail()  # SIGTERM: drained, followers told to exit


def test_a_tp2_pod_answers_as_the_jax_sidecar(ckpt, pods):
    _, cfg = ckpt
    jport, pod = pods
    for path, body in fu.parity_requests(cfg.vocab_size) + [
            ("/v1/m/generate", {"tokens": [[5, 9, 2, 7, 1]], "max_new_tokens": 11}),
            ("/v1/generate", {"tokens": [[3, 4]], "max_new_tokens": 6, "stream": True,
                              "stop_token_ids": [3, 4, 5]})]:
        want = fu.call(jport, path, body)
        got = fu.call(pod.port, path, body)
        assert got == want, (path, body, got, want)


def test_the_pod_reports_its_mesh(ckpt, pods):
    _, pod = pods
    with urllib.request.urlopen(f"http://127.0.0.1:{pod.port}/v1/models", timeout=10) as r:
        stats = json.loads(r.read())["models"]["m"]
    assert (stats["mesh"], stats["mesh_devices"], stats["weight_shard_factor"]) == ("tp=2", 2, 2)
    # this rank read its slices: about half the checkpoint (norms whole)
    assert stats["load_bytes"] // 2 < stats["rank_load_bytes"] < stats["load_bytes"] * 0.6
    assert stats["lifecycle"]["hbm_reserved_bytes"] == -(-stats["load_bytes"] // 2)
    with urllib.request.urlopen(f"http://127.0.0.1:{pod.port}/metrics", timeout=10) as r:
        pool = json.loads(r.read())["pool"]
    assert (pool["mesh"], pool["mesh_devices"], pool["weight_shard_factor"]) == ("tp=2", 2, 2)


# a forward this long asks the host allocator for the plain attention's
# [1, H/tp, S, S] fp32 scores (2 TiB at tp=2): refused at once on every rank
OVERSIZED_SEQ = 1 << 19


def test_an_oversized_request_answers_its_error_and_the_pod_serves_on(ckpt, pods):
    _, pod = pods
    body = {"tokens": [[1, 2, 3]]}
    status, want = fu.call(pod.port, "/v1/forward", body)
    assert status == 200
    status, raw = fu.call(pod.port, "/v1/forward", {"tokens": [[1] * OVERSIZED_SEQ]})
    assert status == 500 and b"allocate" in raw, raw[:300]
    assert fu.call(pod.port, "/v1/forward", body) == (200, want)
    status, raw = fu.call(pod.port, "/v1/generate", {"tokens": [[5, 9]], "max_new_tokens": 4})
    assert status == 200, raw


# -- the serving options under a mesh -----------------------------------------------------


@pytest.fixture(scope="module")
def group():
    g = mu.GlooGroup(2)
    yield g
    g.close()


OPTIONS = [  # (server options, set options, route, body): each as the JAX sidecar
    ({}, {"dynamic_batch": True}, "/v1/m/forward", {"tokens": [[1, 2]]}),
    ({}, {"continuous_batch": True}, "/v1/m/generate", {"tokens": [[1, 2]], "max_new_tokens": 2}),
    ({}, {"continuous_batch": True}, "/v1/m/generate",
     {"tokens": [[1, 2]], "max_new_tokens": 2, "stream": True}),
    ({"quantize": "int8"}, {}, "/v1/m/forward", {"tokens": [[1, 2]]}),
    ({"speculative_k": 4}, {}, "/v1/m/generate", {"tokens": [[1, 2]], "max_new_tokens": 2}),
    ({"prefix_cache_size": 2}, {}, "/v1/m/generate",
     {"tokens": [[1, 2]], "max_new_tokens": 2, "stream": True}),
]


@pytest.mark.parametrize("server_kw,set_kw,route,body", OPTIONS)
def test_options_answer_under_a_mesh_as_the_jax_sidecar(ckpt, group, server_kw, set_kw, route,
                                                        body):
    model_dir, _ = ckpt
    jserver = JaxModelServer(model_dir, mesh_spec="dp=1,tp=2", dtype="float32", max_seq_len=96,
                             name="m", **server_kw)
    jserver.load()
    jhttpd = jax_serve(JaxServerSet({"m": jserver}, **set_kw),
                       listen=f"127.0.0.1:{free_port()}")
    try:
        # twice: a prefix-cache hit, a warm engine, a coalesced batch
        want = [fu.call(jhttpd.server_address[1], route, body) for _ in range(2)]
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    got, _info = group.run(mu.mesh_pod, model_dir, "tp=2", server_kw, set_kw, "drive_http",
                           ([("POST", route, body)] * 2,))[0]
    assert [tuple(g) for g in got] == want


def test_admin_logprobs_and_lora_answer_under_a_mesh(ckpt, group, tmp_path):
    model_dir, cfg = ckpt
    rng = np.random.RandomState(0)
    q_out, e, f = cfg.num_heads * cfg.head_dim, cfg.hidden_size, cfg.intermediate_size
    ab = {"model.layers.1.self_attn.q_proj": ((4, e), (q_out, 4)),  # split by rows
          "model.layers.0.mlp.down_proj": ((4, f), (e, 4))}  # split on the input dim
    tensors = {f"base_model.model.{t}.lora_{n}.weight": (rng.randn(*shape) * 0.05).astype(
        np.float32) for t, shapes in ab.items() for n, shape in zip("AB", shapes)}
    os.makedirs(tmp_path / "ad")
    jst.write_safetensors(str(tmp_path / "ad" / "adapter_model.safetensors"), tensors)
    body = {"tokens": [[5, 9, 2, 7, 1]], "max_new_tokens": 6}
    jlora = JaxModelServer(model_dir, mesh_spec="dp=1,tp=2", dtype="float32", max_seq_len=96,
                           name="m", lora_dir=str(tmp_path / "ad"))
    jlora.load()
    jhttpd = jax_serve(jlora, listen=f"127.0.0.1:{free_port()}")
    try:
        want = fu.call(jhttpd.server_address[1], "/v1/m/generate", body)
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    got, _info = group.run(mu.mesh_pod, model_dir, "tp=2", {"lora_dir": str(tmp_path / "ad")},
                           {}, "drive_http", ([("POST", "/v1/m/generate", body)],))[0]
    assert tuple(got[0]) == want
    jplain = JaxModelServer(model_dir, mesh_spec="dp=1,tp=2", dtype="float32", max_seq_len=96)
    jplain.load()
    rows = [([5, 9, 2], [7, 1, 4]), ([3], [8])]
    for (lp, tid, tlp), (jlp, jtid, jtlp) in zip(
            group.run(mu.mesh_pod, model_dir, "tp=2", {}, {}, "drive_scores", (rows, 2))[0],
            jplain.score_logprobs_rows(rows, top_k=2)):
        np.testing.assert_allclose(lp, np.asarray(jlp), atol=1e-5)
        np.testing.assert_array_equal(tid, np.asarray(jtid))
        np.testing.assert_allclose(tlp, np.asarray(jtlp), atol=1e-5)
    admin = [("POST", "/admin/models", {"name": "x", "model_dir": model_dir, "wait": True}),
             ("DELETE", "/admin/models/x", None)]
    got, _info = group.run(mu.mesh_pod, model_dir, "tp=2", {}, {"allow_admin_load": True},
                           "drive_http", (admin,))[0]
    assert [status for status, _raw in got] == [200, 200]


FLAG_PODS = [  # serve_main flags under --mesh, and the JAX sidecar's matching options
    (("--continuous-batch", "--prefix-cache", "4", "--speculative-k", "4",
      "--allow-admin-load"),
     {"prefix_cache_size": 4, "speculative_k": 4}, {"continuous_batch": True}),
    (("--quantize", "int8", "--dynamic-batch"), {"quantize": "int8"}, {"dynamic_batch": True}),
]


@pytest.mark.parametrize("flags,server_kw,set_kw", FLAG_PODS, ids=["engine", "int8-batcher"])
def test_a_tp2_pod_started_with_option_flags_answers_as_the_jax_sidecar(ckpt, tmp_path, flags,
                                                                        server_kw, set_kw):
    """The flags reach every rank: rank 0 starts its followers with the same
    options, and the pod answers as the JAX sidecar with those options."""
    model_dir, cfg = ckpt
    jserver = JaxModelServer(model_dir, mesh_spec="dp=1,tp=2", dtype="float32",
                             max_seq_len=fu.MAX_SEQ_LEN, name="m", **server_kw)
    jserver.load()
    jhttpd = jax_serve(JaxServerSet({"m": jserver}, **set_kw),
                       listen=f"127.0.0.1:{free_port()}")
    pod = MeshPod(model_dir, "tp=2", *flags, log_path=str(tmp_path / "log"))
    try:
        prompt = np.random.RandomState(9).randint(0, cfg.vocab_size, (1, 7)).tolist()
        for path, body in [("/v1/m/generate", {"tokens": prompt, "max_new_tokens": 6}),
                           ("/v1/m/generate", {"tokens": prompt, "max_new_tokens": 6,
                                               "stream": True}),
                           ("/v1/m/generate", {"tokens": prompt, "max_new_tokens": 5,
                                               **fu.SAMPLED}),
                           ("/v1/m/forward", {"tokens": prompt})]:
            assert fu.call(pod.port, path, body) == fu.call(jhttpd.server_address[1], path,
                                                            body), (path, body)
        if "--allow-admin-load" in flags:
            status, raw = fu.call(pod.port, "/admin/models",
                                  {"name": "x", "model_dir": model_dir, "wait": True})
            assert status == 200, raw
            body = {"tokens": prompt, "max_new_tokens": 6}
            assert fu.call(pod.port, "/v1/x/generate", body) == fu.call(
                jhttpd.server_address[1], "/v1/m/generate", body)
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
        assert pod.close() == 0, pod.tail()


# -- the typed 501s ---------------------------------------------------------------------


def _gpt2_dir(tmp_path) -> str:
    cfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
    params = jgpt2.init_params(cfg, jax.random.PRNGKey(1))
    return fu.write_checkpoint(str(tmp_path / "gpt2"), params)


REFUSALS = [  # (server options, set options, route, body, slice)
    ({}, {}, "/v1/g/forward", {"tokens": [[1, 2]]}, "multi-device families"),
    ({}, {}, "/v1/g/generate", {"tokens": [[1, 2]], "max_new_tokens": 2},
     "multi-device families"),
]


@pytest.mark.parametrize("server_kw,set_kw,route,body,slice_name", REFUSALS)
def test_routes_not_ported_under_a_mesh_answer_501(ckpt, tmp_path, server_kw, set_kw, route,
                                                  body, slice_name):
    model_dir, _ = ckpt
    mesh = make_mesh("tp=2", devices=2)  # refusals need no process group
    # the set's options refuse on the set's mesh, before the server's work
    smesh = None if set_kw else mesh
    servers = {"m": ModelServer(model_dir, dtype="float32", device="cpu", mesh=smesh,
                                **server_kw),
               "g": ModelServer(_gpt2_dir(tmp_path), dtype="float32", device="cpu", mesh=mesh)}
    sset = ServerSet(servers, mesh=mesh, **set_kw)
    sset.load_all()
    httpd = serve(sset, listen=f"127.0.0.1:{free_port()}")
    try:
        status, raw = fu.call(httpd.server_address[1], route, body)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 501, raw
    payload = json.loads(raw)
    assert (payload["type"], payload["slice"]) == ("not_ported", slice_name)
    assert servers["g"].params is None  # nothing was placed
    if server_kw:
        assert servers["m"].params is None


# -- failures ---------------------------------------------------------------------------


def test_a_killed_follower_makes_rank0_answer_503_and_exit(ckpt, tmp_path):
    model_dir, _ = ckpt
    pod = MeshPod(model_dir, "tp=2", log_path=str(tmp_path / "log"))
    try:
        (pid,) = pod.follower_pids()
        assert fu.call(pod.port, "/v1/forward", {"tokens": [[1, 2, 3]]})[0] == 200
        os.kill(pid, 9)
        time.sleep(0.5)
        t0 = time.monotonic()
        status, raw = fu.call(pod.port, "/v1/forward", {"tokens": [[1, 2, 3]]})
        assert status == 503 and b"mesh rank 1 exited" in raw
        rc = pod.proc.wait(timeout=MESH_TIMEOUT_S + 10)
        assert rc != 0 and time.monotonic() - t0 < MESH_TIMEOUT_S + 10
    finally:
        pod.close()


def test_a_mesh_larger_than_the_host_exits_naming_both_counts(ckpt):
    model_dir, _ = ckpt
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    proc = subprocess.run(
        [sys.executable, "-m", "modelx_tpu_torch.dl.serve_main", "--model", f"m={model_dir}",
         "--mesh", f"tp={have + 8}", "--listen", f"127.0.0.1:{free_port()}"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert f"mesh tp={have + 8} needs {have + 8} devices, have {have}" in proc.stderr


def test_a_device_naming_one_card_is_refused_on_a_mesh(ckpt):
    model_dir, _ = ckpt
    proc = subprocess.run(
        [sys.executable, "-m", "modelx_tpu_torch.dl.serve_main", "--model", f"m={model_dir}",
         "--mesh", "tp=2", "--device", "cuda:1", "--listen", f"127.0.0.1:{free_port()}"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "--device cuda:1 names one card, but the mesh tp=2 runs one rank per card" \
        in proc.stderr


@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_no_mesh_without_the_flag_on_a_host_with_cards(ckpt, monkeypatch, device):
    from modelx_tpu_torch.dl import serve_main

    model_dir, _ = ckpt
    monkeypatch.setattr(serve_main, "_local_cards", lambda _device: 4)
    _, args = serve_main._parse(["--model", f"m={model_dir}", "--device", device])
    assert serve_main.join_mesh(args) == (None, [])


class _Gone:
    def poll(self):
        return 1


def test_the_op_log_is_in_step_only_when_every_follower_finished_the_op():
    import datetime

    import torch.distributed as dist

    from modelx_tpu_torch.dl.mesh_serve import OpLog

    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          timeout=datetime.timedelta(seconds=10))
    leader = OpLog(store, world=2, timeout_s=5)
    follower = OpLog(store, rank=1, world=2, timeout_s=5)
    for outcome, in_step in (("ok", True), ("request OutOfMemoryError", True),
                             ("fatal DistBackendError", False)):
        seq = leader.post("forward", "m", np.zeros((1, 2)))
        assert follower.read()[0] == seq
        follower.report(seq, outcome)
        assert leader.in_step(seq) is in_step
    # a follower that never reports and has exited: out of step at once
    seq = leader.post("forward", "m", np.zeros((1, 2)))
    leader.children = [_Gone()]
    t0 = time.monotonic()
    assert leader.in_step(seq) is False
    assert time.monotonic() - t0 < 5


def test_the_op_log_carries_named_arrays():
    import datetime

    import torch.distributed as dist

    from modelx_tpu_torch.dl.mesh_serve import OpLog

    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          timeout=datetime.timedelta(seconds=10))
    leader = OpLog(store, world=2, timeout_s=5, namespace="a/")
    follower = OpLog(store, rank=1, world=2, timeout_s=5, namespace="a/")
    other = OpLog(store, rank=1, world=2, timeout_s=5, namespace="b/")
    ints = np.arange(12, dtype=np.int64).reshape(3, 4)
    floats = np.linspace(0, 1, 5, dtype=np.float32)
    leader.post("engine", "m", np.array([[7, 8]]), ints=ints, floats=floats, step="chunk",
                slots=[1, 3], table=None)
    seq, head, arrays = follower.read()
    assert (seq, head) == (0, {"op": "engine", "model": "m", "step": "chunk", "slots": [1, 3],
                               "table": None})
    assert sorted(arrays) == ["floats", "ints", "tokens"]
    np.testing.assert_array_equal(arrays["tokens"], [[7, 8]])
    np.testing.assert_array_equal(arrays["ints"], ints)
    np.testing.assert_array_equal(arrays["floats"], floats)
    assert arrays["floats"].dtype == np.float32
    # another pod's log in the same store is apart
    leader2 = OpLog(store, world=2, timeout_s=5, namespace="b/")
    leader2.post("shutdown")
    assert other.read()[1]["op"] == "shutdown"


def test_a_replica_prefix_cache_keeps_what_rank0_keeps():
    from modelx_tpu_torch.models.decode import PrefixKVCache, key_digest

    entry = {"k0": np.zeros((1, 16, 1, 4), np.float32)}
    leader, replica = PrefixKVCache(1), PrefixKVCache(1, replica=True)
    evictions = []
    leader.on_evict = evictions.extend
    for ids in ([1, 2, 3], [4, 5, 6]):
        leader.put(ids, entry)
        replica.put(ids, entry)
    # rank 0 evicted the first entry by its capacity; the replica keeps
    # both until told
    assert evictions == [key_digest([1, 2, 3])]
    assert replica.by_digest(key_digest([1, 2, 3]))[0] == 3
    replica.evict(evictions)
    with pytest.raises(RuntimeError, match="no entry"):
        replica.by_digest(key_digest([1, 2, 3]))
    assert replica.by_digest(key_digest([4, 5, 6]))[0] == 3
    assert leader.lookup([4, 5, 6, 7])[0] == 3 and replica.stats()["entries"] == 1


def test_a_sharded_prefix_entry_counts_its_whole_bytes_as_the_jax_cache():
    import torch

    from modelx_tpu.models.decode import PrefixKVCache as JaxPrefixKVCache
    from modelx_tpu_torch.models.decode import PrefixKVCache

    rng = np.random.RandomState(0)
    whole = rng.randn(1, 16, 4, 8).astype(np.float32)  # [1, L, Hkv, D]
    cap = whole.nbytes * 2 * 3 // 2  # one whole entry of two leaves, not two
    jcache = JaxPrefixKVCache(4, max_bytes=cap)
    shard = PrefixKVCache(4, max_bytes=cap)
    shard.kv_heads = 4  # this rank holds kv heads 0-1 of 4 (tp=2)
    for ids in ([1, 2, 3], [4, 5, 6]):
        jcache.put(ids, {n: jnp.asarray(whole) for n in ("k0", "v0")})
        shard.put(ids, {n: torch.from_numpy(whole[:, :, :2].copy()) for n in ("k0", "v0")})
        assert shard._bytes == jcache._bytes
    # the byte cap evicted the first entry on both, as the whole entries count
    assert shard.stats()["entries"] == jcache.stats()["entries"] == 1
    assert shard.lookup([1, 2, 3, 9]) is None and jcache.lookup([1, 2, 3, 9]) is None
