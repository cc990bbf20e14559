"""The sidecar's observability surface, the port's against the JAX package's,
on the CPU: a JAX pod and a port pod serve one tiny fp32 llama checkpoint
and take the same requests (a forward with a client request id, a greedy
generate, a 400, a stream with ``include_timing``; then the same through
the continuous engine).

Held equal between the two pods:
- the ``/metrics`` JSON key tree and its counter values, apart from each
  package's own load stats (``PACKAGE_KEYS``: the JAX mesh fields, the
  port's device and dtype), the device sample and the control plane (each
  package's registry health is process-wide: the other tests of a worker
  process move it);
- the Prometheus view's metric names and label sets, apart from the
  families of those same keys;
- ``/v1/trace?request_id=``: span paths and counts;
- the names of the ``X-ModelX-*`` headers on every answer, and the
  request id and attempt echoed;
- the access log: one line per POST with equal fields, apart from ``ts``,
  ``ms``, the timing values and the minted request ids;
- the ``/v1/profile`` and ``/admin/profile`` validation, 409 and 401
  bodies, byte for byte; and six admin captures leave four capture dirs.
The port's CPU profile writes a Chrome trace.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_family_util as fu
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import ServerSet as JaxServerSet
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port
from modelx_tpu.utils import trace as jtrace
from modelx_tpu_torch.dl import serve_main
from modelx_tpu_torch.utils import trace as ttrace
from test_promexp import parse_exposition

TOKEN = "obs-admin"
# per-model load stats that are each package's own (JAX: the mesh; the
# port: its device, dtype, resident bytes and kernel library)
PACKAGE_KEYS = {"mesh", "mesh_devices", "weight_shard_factor", "device", "dtype",
                "device_bytes", "kernel_library"}
RID = "req-obs-1"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), rope_theta=500000.0, dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return fu.write_checkpoint(str(tmp_path_factory.mktemp("obs-ckpt")), params)


class Pair:
    """A JAX pod and a port pod on ``ckpt``, each with an access log, a
    trace dir and an admin token."""

    def __init__(self, ckpt: str, root, engine: bool) -> None:
        self.root = root
        self.jsset = JaxServerSet(
            {"m": JaxModelServer(ckpt, mesh_spec="dp=1", dtype="float32", max_seq_len=64,
                                 name="m")},
            admin_tokens=(TOKEN,), trace_dir=str(root / "jtrace"),
            continuous_batch=engine, max_slots=4)
        self.jsset.load_all()
        self.jhttpd = jax_serve(self.jsset, listen=f"127.0.0.1:{free_port()}",
                                access_log=str(root / "j.log"))
        argv = ["--model", f"m={ckpt}", "--device", "cpu", "--dtype", "float32",
                "--max-seq-len", "64", "--listen", f"127.0.0.1:{free_port()}",
                "--admin-token", TOKEN, "--access-log", str(root / "t.log"),
                "--trace-dir", str(root / "ttrace")]
        if engine:
            argv += ["--continuous-batch", "--max-slots", "4"]
        self.tsset, self.thttpd = serve_main.start(argv)
        self.ports = (self.jhttpd.server_address[1], self.thttpd.server_address[1])

    def close(self) -> None:
        for h in (self.jhttpd, self.thttpd):
            h.shutdown()
            h.server_close()
        for cb in self.jsset.cbatchers.values():
            cb.close()
        self.tsset.close()


def call(port: int, path: str, body=None, headers=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


TOKS = np.random.RandomState(5).randint(0, 512, (1, 9)).tolist()
SEQUENCE = [
    ("/v1/forward", {"tokens": TOKS}, {"X-ModelX-Request-Id": RID, "X-ModelX-Attempt": "3"}),
    ("/v1/generate", {"tokens": TOKS, "max_new_tokens": 4}, {}),
    ("/v1/generate", {"tokens": [[1, 999]]}, {}),
    ("/v1/generate", {"tokens": TOKS, "max_new_tokens": 5, "stream": True,
                      "include_timing": True}, {}),
    ("/v1/m/generate", {"tokens": TOKS, "max_new_tokens": 3, "temperature": 0.8, "seed": 4},
     {"X-ModelX-Request-Id": "bad id with spaces"}),
]


def _drive(pair: Pair) -> list:
    """SEQUENCE on both pods: per pod, [(status, headers, body)]."""
    jtrace.tracer().clear()
    ttrace.tracer().clear()
    return [[call(port, path, body, hdrs) for path, body, hdrs in SEQUENCE]
            for port in pair.ports]


@pytest.fixture(scope="module", params=["plain", "engine"])
def driven(request, ckpt, tmp_path_factory):
    pair = Pair(ckpt, tmp_path_factory.mktemp(f"obs-{request.param}"),
                engine=request.param == "engine")
    answers = _drive(pair)
    yield pair, answers
    pair.close()


def _obs_names(headers: dict) -> set:
    return {k for k in headers if k.startswith("X-ModelX-")}


def test_answers_and_header_names_equal(driven):
    _pair, (jax_answers, port_answers) = driven
    for (path, body, _), (js, jh, jb), (ts, th, tb) in zip(SEQUENCE, jax_answers,
                                                          port_answers):
        assert ts == js, path
        assert _obs_names(th) == _obs_names(jh), (path, body)
        if not body.get("include_timing"):
            assert tb == jb
    # the client's id and attempt echo; a malformed id is replaced by a minted one
    for answers in (jax_answers, port_answers):
        assert answers[0][1]["X-ModelX-Request-Id"] == RID
        assert answers[0][1]["X-ModelX-Attempt"] == "3"
        assert answers[1][1]["X-ModelX-Attempt"] == "1"
        assert answers[4][1]["X-ModelX-Request-Id"].startswith("req-")
        assert "Total-Ms" in " ".join(_obs_names(answers[2][1]))  # a 400 reports its time


def test_stream_timing_line_has_the_same_keys(driven):
    _pair, (jax_answers, port_answers) = driven
    lines = [[json.loads(x) for x in ans[3][2].splitlines()] for ans in (jax_answers,
                                                                         port_answers)]
    assert [x for x in lines[1] if "timing" not in x] == [x for x in lines[0] if "timing"
                                                          not in x]
    timings = [next(x["timing"] for x in side if "timing" in x) for side in lines]
    assert set(timings[1]) == set(timings[0]) and timings[1]["tokens"] == 5


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return type(obj).__name__


def _counters(metrics: dict) -> dict:
    """The request-driven values: per-model requests, tokens and lifecycle
    counters, the engine's admissions and histogram counts, pool totals,
    the windowed request rate."""
    m = metrics["m"]
    out = {"requests": m["requests"], "tokens_generated": m["tokens_generated"],
           "lifecycle": {k: v for k, v in m["lifecycle"].items() if k != "state_age_s"},
           "pool": {k: v for k, v in metrics["pool"].items() if k.endswith("_total")},
           "rates": metrics["rates"]["requests_per_s_5m"]}
    cont = m.get("continuous")
    if cont is not None:
        out["continuous"] = {k: cont[k] for k in ("admitted", "shed", "expired",
                                                  "engine_restarts", "quarantined")}
        out["hists"] = [cont[h]["count"] for h in ("queue_ms_hist", "ttft_ms_hist")]
    return out


def test_metrics_json_key_tree_and_counters_equal(driven):
    pair, _answers = driven
    trees = [json.loads(call(port, "/metrics")[2]) for port in pair.ports]
    jm, tm = trees
    for side in trees:
        side["m"] = {k: v for k, v in side["m"].items() if k not in PACKAGE_KEYS}
        assert side.pop("device")["device_count"] >= 0  # each package's own sample
        assert side.pop("control_plane")["state"] in ("ok", "degraded", "offline")
    assert _key_tree(tm) == _key_tree(jm)
    assert _counters(tm) == _counters(jm)
    assert _counters(tm)["requests"] == 4  # the 400 is refused before it counts


def _families(text: str) -> set:
    return {(name, tuple(sorted(labels.items())))
            for name, fam in parse_exposition(text).items()
            for _, labels, _ in fam["samples"]}


def test_prometheus_names_and_label_sets_equal(driven):
    pair, _answers = driven
    got = []
    for port in pair.ports:
        status, headers, raw = call(port, "/metrics?format=prometheus")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        got.append(_families(raw.decode()))
    own = {f"modelx_{k}" for k in PACKAGE_KEYS} | {"modelx_hbm_bytes_limit",
                                                  "modelx_kernel_library_nvcc_seconds"}
    jfams, tfams = ({f for f in side if f[0] not in own
                     and f[1] != (("model", "control_plane"),)} for side in got)
    assert tfams == jfams
    assert ("modelx_requests", (("model", "m"),)) in tfams


def test_trace_slices_one_request(driven):
    pair, _answers = driven
    summaries = [json.loads(call(port, f"/v1/trace?request_id={RID}")[2])
                 for port in pair.ports]
    want = {p: a["count"] for p, a in summaries[0].items()}
    assert {p: a["count"] for p, a in summaries[1].items()} == want == {
        "serve.request": 1, "serve.request/serve.forward": 1}
    prefixed = json.loads(call(pair.ports[1], "/v1/trace?prefix=serve.request/")[2])
    assert set(prefixed) and all(p.startswith("serve.request/") for p in prefixed)


def _log_lines(path) -> list:
    with open(path, encoding="utf-8") as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    for rec in lines:
        rec.pop("ts"), rec.pop("ms")
        rec["timing"] = sorted(rec["timing"])
        if rec["request_id"] != RID:
            assert rec["request_id"].startswith("req-")
            rec["request_id"] = "<minted>"
    return lines


def test_access_log_lines_equal(driven):
    pair, _answers = driven
    jlines, tlines = (_log_lines(pair.root / name) for name in ("j.log", "t.log"))
    assert tlines == jlines and len(tlines) == len(SEQUENCE)
    assert [x["status"] for x in tlines] == [200, 200, 400, 200, 200]
    assert tlines[0]["attempt"] == 3 and tlines[0]["model"] == "m"
    assert tlines[0]["client"] == "ip:127.0.0.1"


PROFILE_REFUSALS = [
    ("/v1/profile", {"seconds": -1}, {}),
    ("/v1/profile", {"seconds": 61}, {}),
    ("/v1/profile", {"seconds": "x"}, {}),
    ("/admin/profile", {"duration_s": 1}, {}),
    ("/admin/profile", {"duration_s": 1}, {"Authorization": "Bearer wrong"}),
    ("/admin/profile", {"duration_s": 0}, {"Authorization": f"Bearer {TOKEN}"}),
    ("/admin/profile", {"duration_s": 61}, {"Authorization": f"Bearer {TOKEN}"}),
    ("/admin/profile", {"duration_s": [1]}, {"Authorization": f"Bearer {TOKEN}"}),
]


@pytest.fixture(scope="module")
def plain_pair(ckpt, tmp_path_factory):
    pair = Pair(ckpt, tmp_path_factory.mktemp("obs-profile"), engine=False)
    yield pair
    pair.close()


@pytest.mark.parametrize("path,body,headers", PROFILE_REFUSALS, ids=[
    "seconds-negative", "seconds-over", "seconds-nan", "admin-no-token", "admin-bad-token",
    "duration-zero", "duration-over", "duration-list"])
def test_profile_refusals_byte_equal(plain_pair, path, body, headers):
    (js, _, jb), (ts, _, tb) = (call(p, path, body, headers) for p in plain_pair.ports)
    assert (ts, tb) == (js, jb) and ts in (400, 401)


def test_profile_conflict_and_capture_cap(plain_pair):
    """A profile while one runs answers 409 on both routes (one lock), six
    admin captures leave four dirs, and the port's CPU capture is a Chrome
    trace holding the forward run inside its window."""
    admin = {"Authorization": f"Bearer {TOKEN}"}
    bodies = []
    for port in plain_pair.ports:
        first = []
        t = threading.Thread(target=lambda p=port: first.append(
            call(p, "/v1/profile", {"seconds": 1.5})))
        t.start()
        time.sleep(0.5)
        bodies.append([call(port, "/v1/profile", {"seconds": 0})[::2],
                       call(port, "/admin/profile", {"duration_s": 1}, admin)[::2]])
        if port == plain_pair.ports[1]:
            assert call(port, "/v1/forward", {"tokens": TOKS})[0] == 200
        t.join()
        assert first[0][0] == 200
    assert bodies[1] == bodies[0] == [(409, b'{"error": "profile already running"}')] * 2
    jtrace_dir, ttrace_dir = (json.loads(call(p, "/v1/profile", {"seconds": 0})[2])["trace_dir"]
                              for p in plain_pair.ports)
    assert ttrace_dir == str(plain_pair.root / "ttrace")
    with open(os.path.join(ttrace_dir, ttrace.TRACE_FILE)) as f:
        assert json.load(f)["traceEvents"]
    for port, trace_dir in zip(plain_pair.ports, (jtrace_dir, ttrace_dir)):
        dirs = []
        for _ in range(6):
            status, _, raw = call(port, "/admin/profile", {"duration_s": 0.05}, admin)
            assert status == 200 and json.loads(raw)["duration_s"] == 0.05
            dirs.append(json.loads(raw)["capture_dir"])
            time.sleep(0.02)  # distinct mtimes order the pruning
        kept = sorted(os.listdir(os.path.join(trace_dir, "captures")))
        assert len(kept) == 4 and sorted(os.path.basename(d) for d in dirs[-4:]) == kept
