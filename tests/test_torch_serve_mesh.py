"""``modelx-serve-torch --mesh`` on the CPU: one process per rank over gloo.

- A 2-rank port pod at ``--mesh tp=2`` (rank 0 starts rank 1 itself)
  answers ``/v1/forward`` and ``/v1/generate`` (greedy, seeded sampled,
  NDJSON streams; ``tests/torch_family_util.parity_requests``) with the
  same bytes as the JAX sidecar at ``--mesh dp=1,tp=2`` on the forced host
  devices, fp32. Its stats carry the mesh, and each rank read about half
  the checkpoint.
- Every route not ported under a mesh answers the typed 501 with its
  slice: the window batcher, the continuous engine, int8, speculation,
  LoRA, the prefix cache, ``logprobs``, admin load and unload, and the
  families other than llama and qwen2. These refuse before any device
  work, so they run in process on a mesh with no process group.
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
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.models import gpt2 as jgpt2
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl.serve import ModelServer, NotPortedError, ServerSet, serve
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


# -- the typed 501s ---------------------------------------------------------------------


def _gpt2_dir(tmp_path) -> str:
    cfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
    params = jgpt2.init_params(cfg, jax.random.PRNGKey(1))
    return fu.write_checkpoint(str(tmp_path / "gpt2"), params)


REFUSALS = [  # (server options, set options, route, body, slice)
    ({}, {"dynamic_batch": True}, "/v1/m/forward", {"tokens": [[1, 2]]},
     "multi-device serving"),
    ({}, {"continuous_batch": True}, "/v1/m/generate", {"tokens": [[1, 2]], "max_new_tokens": 2},
     "multi-device serving"),
    ({}, {"continuous_batch": True}, "/v1/m/generate",
     {"tokens": [[1, 2]], "max_new_tokens": 2, "stream": True}, "multi-device serving"),
    ({"quantize": "int8"}, {}, "/v1/m/forward", {"tokens": [[1, 2]]}, "multi-device serving"),
    ({"speculative_k": 4}, {}, "/v1/m/generate", {"tokens": [[1, 2]], "max_new_tokens": 2},
     "multi-device serving"),
    ({"prefix_cache_size": 2}, {}, "/v1/m/generate",
     {"tokens": [[1, 2]], "max_new_tokens": 2, "stream": True}, "multi-device serving"),
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


def test_admin_logprobs_and_lora_refuse_under_a_mesh(ckpt, tmp_path):
    model_dir, _ = ckpt
    mesh = make_mesh("tp=2", devices=2)
    server = ModelServer(model_dir, dtype="float32", device="cpu", mesh=mesh)
    with pytest.raises(NotPortedError, match="logprobs scoring under a mesh") as e:
        server.score_logprobs_rows([([1, 2], [3])])
    assert e.value.slice_name == "multi-device serving"
    lora = ModelServer(model_dir, dtype="float32", device="cpu", mesh=mesh,
                       lora_dir=str(tmp_path))
    lora.load()
    with pytest.raises(NotPortedError, match="LoRA adapters under a mesh"):
        lora.generate(np.array([[1, 2]]), max_new_tokens=2)
    sset = ServerSet({"m": lora}, mesh=mesh, allow_admin_load=True)
    httpd = serve(sset, listen=f"127.0.0.1:{free_port()}")
    try:
        port = httpd.server_address[1]
        status, raw = fu.call(port, "/admin/models", {"name": "x", "model_dir": model_dir})
        assert status == 501 and json.loads(raw)["slice"] == "multi-device serving"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/admin/models/m", method="DELETE")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 501
    finally:
        httpd.shutdown()
        httpd.server_close()


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
