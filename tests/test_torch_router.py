"""The port's fleet router (modelx_tpu_torch/router) against the JAX
package's, on the CPU, over a live fleet of port pods: one loaded tiny fp32
llama (with a word-level tokenizer.json) served by several ``ServerSet``
pods, with the JAX router and the port's router in front of them in turn.

- The same requests give byte-identical bodies through either router and
  straight from the pod (native JSON, NDJSON streams seeded and greedy,
  OpenAI JSON and SSE with ``id``/``created`` masked, the 400s and 404s),
  the same pod choices (sticky assignments included) and the same router
  ``/metrics`` counters.
- A pod killed mid-stream (``PodKillSwitch``) is continued on the other
  pod: the spliced bytes equal the uninterrupted stream exactly, seeded
  sampling included; the same for a drain hand-off.
- A dead fleet answers the same typed 503 with ``Retry-After``; a 429 is
  relayed verbatim; an incoming ``X-ModelX-Deadline-Ms`` is clamped.
- Breakers open, half-open and close on an injected clock, not on sleeps.

Tolerance: exact equality (masked fields named above).
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from modelx_tpu.router import admission as jadm
from modelx_tpu.router import policy as jpol
from modelx_tpu.router import registry as jreg
from modelx_tpu.router import server as jsrv
from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.dl import serve as tserve
from modelx_tpu_torch.models import llama
from modelx_tpu_torch.registry.server import free_port
from modelx_tpu_torch.router import admission as tadm
from modelx_tpu_torch.router import policy as tpol
from modelx_tpu_torch.router import registry as treg
from modelx_tpu_torch.router import server as tsrv
from modelx_tpu_torch.dl.serving_errors import REQUEST_ID_HEADER
from modelx_tpu_torch.testing.faults import FaultPlan, InjectedCrash, PodKillSwitch
from tests.test_torch_openai import _parse, _wordlevel_json

PKGS = {"jax": (jreg, jpol, jadm, jsrv), "port": (treg, tpol, tadm, tsrv)}
SAMPLED = {"temperature": 0.9, "top_k": 20, "top_p": 0.95, "seed": 5}
PROMPT = np.random.RandomState(7).randint(4, 64, (1, 20)).tolist()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("router-model")
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=64), dtype=torch.float32)
    st.write_safetensors(str(d / "model.safetensors"),
                         llama.init_params(cfg, torch.Generator().manual_seed(0)))
    (d / "tokenizer.json").write_text(_wordlevel_json())
    srv = tserve.ModelServer(str(d), dtype="float32", device="cpu", name="m", max_seq_len=128)
    srv.load()
    return srv


class Pod:
    """One ServerSet front over the shared loaded model, with a kill switch."""

    def __init__(self, srv) -> None:
        self.sset = tserve.ServerSet({"m": srv}, continuous_batch=True, max_slots=4,
                                     stream_chunk_size=1)
        self.httpd = tserve.serve(self.sset, listen=f"127.0.0.1:{free_port()}")
        self.switch = PodKillSwitch(self.httpd, self.sset)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.port = self.httpd.server_address[1]

    def close(self) -> None:
        self.switch.kill()
        self.httpd.shutdown()
        self.sset.close()


@pytest.fixture(scope="module")
def fleet(model):
    pods = [Pod(model), Pod(model)]
    yield pods
    for p in pods:
        p.close()


class Router:
    """One router of package ``pkg`` in front of ``urls``, in process."""

    def __init__(self, pkg: str, urls, poll_s: float = 0.05, **kw) -> None:
        reg, pol, adm, srv = PKGS[pkg]
        clock = kw.pop("clock", time.monotonic)
        breaker = kw.pop("breaker", (0, 10.0))
        self.registry = reg.PodRegistry(list(urls), poll_interval_s=poll_s, poll_timeout_s=5.0)
        self.router = srv.FleetRouter(
            self.registry, sticky=pol.StickyTable(), default_model="m",
            breakers=adm.BreakerBoard(*breaker, clock=clock), **kw)
        self.router.start()
        self.httpd = srv.route_serve(self.router, listen=f"127.0.0.1:{free_port()}")
        self.port = self.httpd.server_address[1]

    def settle(self) -> None:
        """Wait until no request is admitted: a handler counts and records
        its outcome after the client has its last byte."""
        until(lambda: not self.router.admission.snapshot()["inflight"])

    def metrics(self) -> dict:
        self.settle()
        return self.router.snapshot()["router"]

    def close(self) -> None:
        self.httpd.shutdown()
        self.router.close()


def until(pred, timeout=60.0):
    """Wait for ``pred`` (a state the test needs), failing after ``timeout``
    seconds instead of hanging."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "the awaited state never came"
        time.sleep(0.002)


def call(port, path, body=None, headers=None, raw=None):
    data = raw if raw is not None else None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _body(status, headers, raw):
    ctype = headers.get("Content-Type", "")
    if ctype in ("text/event-stream",) or (ctype == "application/json" and raw[:1] == b"{"
                                            and b'"created"' in raw):
        return status, _parse(ctype, raw)
    return status, raw


REQUESTS = [
    ("/v1/forward", {"tokens": PROMPT}),
    ("/v1/m/forward", {"tokens": [PROMPT[0][:7], PROMPT[0][3:10]]}),
    ("/v1/generate", {"tokens": PROMPT, "max_new_tokens": 9}),
    ("/v1/m/generate", {"tokens": PROMPT, "max_new_tokens": 9, **SAMPLED}),
    ("/v1/generate", {"tokens": PROMPT, "max_new_tokens": 10, "stream": True, **SAMPLED}),
    ("/v1/m/generate", {"tokens": [PROMPT[0][:12]], "max_new_tokens": 8, "stream": True}),
    ("/v1/generate", {"tokens": PROMPT + PROMPT, "max_new_tokens": 5, "stream": True}),
    ("/v1/completions", {"model": "m", "prompt": "hello world w5 w9", "max_tokens": 6,
                         "temperature": 0}),
    ("/v1/completions", {"prompt": "hello tpu w7", "max_tokens": 6, "stream": True,
                         "temperature": 0.8, "seed": 3}),
    ("/v1/chat/completions", {"model": "m", "max_tokens": 5, "stream": True, "seed": 11,
                              "messages": [{"role": "user", "content": "hello w4 w8"}]}),
    ("/v1/nope/generate", {"tokens": PROMPT}),
    ("/v1/generate", {"tokens": "not tokens"}),
]


def test_bodies_choices_and_counters_equal_through_both_routers(fleet):
    """Every request answers the pod's own bytes through either router; the
    two routers pick the same pods and count the same."""
    direct = {i: _body(*call(fleet[0].port, path if path.count("/") > 2 or "completions" in path
                                else path.replace("/v1/", "/v1/m/"), body))
              for i, (path, body) in enumerate(REQUESTS)}
    seen = {}
    for pkg in ("jax", "port"):
        # one poll, of idle pods: a later poll could catch an engine's last
        # row still active and reorder the plan by load
        r = Router(pkg, [p.url for p in fleet], poll_s=600.0)
        try:
            got = {i: _body(*call(r.port, path, body)) for i, (path, body) in
                   enumerate(REQUESTS)}
            # a repeated conversation head sticks to its pod
            got["again"] = _body(*call(r.port, *REQUESTS[4]))
            status, _, raw = call(r.port, "/v1/generate", raw=b"{bad json")
            got["bad"] = (status, raw)
            seen[pkg] = (got, r.metrics(), r.router.snapshot()["admission"]["admitted_total"])
        finally:
            r.close()
    (jgot, jm, jadmitted), (tgot, tm, tadmitted) = seen["jax"], seen["port"]
    assert tgot == jgot
    for i, (path, _) in enumerate(REQUESTS):
        if not path.startswith("/v1/nope"):
            assert tgot[i] == direct[i], path
    assert tm == jm and tadmitted == jadmitted
    assert tm["sticky_hits"] >= 1 and sum(tm["routes"].values()) == len(REQUESTS)


def _arm(pods, action, at_piece: int):
    """Run ``action(pod)`` when the fleet's first single-row stream, on
    whichever pod serves it, is about to emit piece ``at_piece``; later
    streams (the continuation) run untouched."""
    armed = [True]
    for pod in pods:
        real = pod.sset.stream_source

        def wrapped(*a, pod=pod, real=real, **kw):
            gen = real(*a, **kw)
            if not armed[0]:
                return gen
            armed[0] = False

            def pieces():
                for i, piece in enumerate(gen):
                    if i == at_piece:
                        action(pod)
                    yield piece
            return pieces()

        pod.sset.stream_source = wrapped


STREAM = {"tokens": PROMPT, "max_new_tokens": 14, "stream": True, **SAMPLED}


@pytest.mark.parametrize("how", ["kill", "drain"])
def test_a_severed_stream_is_spliced_exactly(model, fleet, how):
    """A pod killed (or drained) mid-stream: the router continues the
    stream on the other pod with the resume block; the client's bytes equal
    the uninterrupted stream, and both routers count the same."""
    _, _, whole = call(fleet[0].port, "/v1/m/generate", STREAM)
    assert whole.count(b"\n") == 15
    seen = {}
    for pkg in ("jax", "port"):
        pods = [Pod(model), Pod(model)]
        r = Router(pkg, [p.url for p in pods])
        try:
            def drain(pod):
                pod.switch.drain()
                # hold the stream until the router's poll has seen the
                # drain: the hand-off is then decided by state
                until(lambda: r.registry.pod(pod.url).status == "draining")

            _arm(pods, (lambda pod: pod.switch.kill()) if how == "kill" else drain, at_piece=4)
            status, _, raw = call(r.port, "/v1/generate", STREAM)
            m = r.metrics()
            seen[pkg] = (status, raw, {k: v for k, v in m.items() if k.endswith("_total")})
        finally:
            r.close()
            for p in pods:
                p.close()
    assert seen["port"] == seen["jax"]
    status, raw, counters = seen["port"]
    assert (status, raw) == (200, whole)
    assert counters["streams_continued_total"] == 1 and counters["severed_streams_total"] == 0
    assert counters["drain_handoffs_total"] == (1 if how == "drain" else 0)


def test_a_dead_fleet_answers_the_same_typed_503(model):
    seen = {}
    for pkg in ("jax", "port"):
        pods = [Pod(model), Pod(model)]
        r = Router(pkg, [p.url for p in pods])
        try:
            assert call(r.port, "/v1/forward", {"tokens": PROMPT})[0] == 200
            for p in pods:
                p.switch.kill()
            out = []
            for body in ({"tokens": PROMPT}, {"tokens": PROMPT}):
                status, headers, raw = call(r.port, "/v1/forward", body)
                out.append((status, headers.get("Retry-After"), raw))
            status, headers, raw = call(r.port, "/v1/completions", {"prompt": "hello"})
            out.append((status, headers.get("Retry-After"), raw))
            until(lambda: all(p.status == "unreachable" for p in r.registry.pods()))
            status, headers, raw = call(r.port, "/healthz")
            out.append((status, headers.get("Retry-After"), raw))
            seen[pkg] = (out, {k: v for k, v in r.metrics().items() if k.endswith("_total")})
        finally:
            r.close()
            for p in pods:
                p.close()
    assert seen["port"] == seen["jax"]
    out = seen["port"][0]
    assert [o[:2] for o in out] == [(503, "2")] * 4
    assert b"every candidate failed" in out[0][2] and b"fleet state: READY" in out[1][2]


class Stub:
    """A pod that answers its health and placement reads as READY and every
    POST with the status, headers and body the test sets; it echoes the
    deadline header it was sent."""

    def __init__(self) -> None:
        self.answer = (500, {}, {"error": "boom"})
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status, headers, obj):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {}, {"status": "ok"})
                else:
                    self._send(200, {}, {"models": {"m": {"state": "READY"}}, "serving": {}})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                status, headers, obj = stub.answer
                if status == 200:
                    obj = dict(obj, deadline_ms=int(self.headers["X-ModelX-Deadline-Ms"]))
                self._send(status, headers, obj)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", free_port()), H)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()


class Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_backpressure_and_deadline_on_an_injected_clock():
    """The breaker opens after 2 unexpected 5xx, skips the pod (the typed
    503) until the injected clock passes its cooldown, lets one probe
    through, and closes on its success; a 429 with Retry-After is relayed
    verbatim; an incoming deadline is clamped to the router's budget, and a
    spent one answers 504 before any dispatch."""
    stub = Stub()
    seen = {}
    try:
        for pkg in ("jax", "port"):
            clock = Clock()
            r = Router(pkg, [stub.url], breaker=(2, 30.0), clock=clock, request_timeout_s=2.0)
            out = []

            def step(headers=None):
                status, h, raw = call(r.port, "/v1/forward", {"tokens": [[1, 2]]}, headers)
                body = json.loads(raw)
                if "deadline_ms" in body:  # the stamped budget: at most the router's 2 s
                    assert 0 < body.pop("deadline_ms") <= 2000
                r.settle()
                out.append((status, h.get("Retry-After"), body,
                            r.router.breakers.snapshot()["pods"]))

            try:
                stub.answer = (500, {}, {"error": "boom"})
                step(), step(), step()  # 500, 500 (opens), skipped: 503
                clock.t += 29.0
                step()  # still open
                clock.t += 2.0
                step()  # the half-open probe fails: open again
                clock.t += 31.0
                stub.answer = (200, {}, {"logits_argmax": [[3, 4]]})
                step()  # the probe succeeds: closed
                stub.answer = (429, {"Retry-After": "7"}, {"error": "queue full"})
                step()
                stub.answer = (200, {}, {"logits_argmax": [[3, 4]]})
                step({"X-ModelX-Deadline-Ms": "5000"})
                step({"X-ModelX-Deadline-Ms": "0"})
                seen[pkg] = (out, {k: v for k, v in r.metrics().items()
                                   if k.endswith("_total")})
            finally:
                r.close()
    finally:
        stub.close()
    assert seen["port"] == seen["jax"]
    statuses = [(s, ra) for s, ra, _, _ in seen["port"][0]]
    assert statuses == [(500, None), (500, None), (503, "2"), (503, "2"), (500, None),
                        (200, None), (429, "7"), (200, None), (504, None)]


# -- the chaos sweeps (make chaos-torch: under the port's lockdep) -------------------
# The port's counterparts of tests/test_router.py's and tests/test_admission.py's
# sweeps, on the port's router in front of port pods.


def _arm_plan(pods, plan: FaultPlan):
    """The fleet's first single-row stream fires ``plan``'s "pod.kill" op
    once per relayed piece, on whichever pod serves it; the scheduled index
    kills that pod there. Later streams (the continuation) run untouched."""
    armed = [True]
    for pod in pods:
        real = pod.sset.stream_source
        hook = pod.switch.fire_kills(plan)

        def wrapped(*a, real=real, hook=hook, **kw):
            gen = real(*a, **kw)
            if not armed[0]:
                return gen
            armed[0] = False

            def pieces():
                for piece in gen:
                    hook()
                    yield piece
            return pieces()

        pod.sset.stream_source = wrapped


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("seed", [1234, 7])
def test_chaos_midstream_kill_continuation_byte_identical(model, seed):
    """tests/test_router.py:1433 on the port: a seeded mid-stream pod kill
    behind the router loses zero tokens; the routed body equals the
    uninterrupted stream byte for byte, sampled and seeded."""
    pods = [Pod(model), Pod(model)]
    r = None
    try:
        _, _, whole = call(pods[0].port, "/v1/m/generate", STREAM)
        assert whole.endswith(b'{"done": true}\n')
        at = int(np.random.RandomState(seed).randint(2, 10))
        plan = FaultPlan(seed=seed).add("pod.kill", errors_at=[at], error=InjectedCrash("kill"))
        _arm_plan(pods, plan)
        r = Router("port", [p.url for p in pods], poll_s=60.0)
        status, _, raw = call(r.port, "/v1/generate", STREAM)
        assert any(p.switch.killed for p in pods), "the kill never fired"
        assert (status, raw) == (200, whole)
        m = r.metrics()
        assert m["streams_continued_total"] == 1 and m["severed_streams_total"] == 0
    finally:
        if r is not None:
            r.close()
        for p in pods:
            p.close()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_streams_survive_kill_and_drain_under_load(model):
    """tests/test_router.py:1474 on the port: concurrent seeded streams
    while one pod hard-dies and another drains; every stream ends equal to
    the uninterrupted one, no client-visible sever."""
    pods = [Pod(model) for _ in range(3)]
    r = None
    body = {"tokens": [[3, 1, 4, 1]], "max_new_tokens": 10, "stream": True,
            "temperature": 0.9, "top_k": 8, "top_p": 0.95, "seed": 4321}
    try:
        _, _, full = call(pods[0].port, "/v1/m/generate", body)
        assert full.endswith(b'{"done": true}\n')
        r = Router("port", [p.url for p in pods], poll_s=0.2)
        failures: list = []

        def client(idx: int):
            for n in range(4):
                try:
                    status, _, data = call(r.port, "/v1/generate", body)
                    if status != 200 or data != full:
                        failures.append((idx, n, status, data[-120:]))
                except OSError as e:
                    failures.append((idx, n, repr(e)))

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.4)
        pods[0].switch.kill()  # hard death under load
        time.sleep(0.4)
        pods[1].switch.drain()  # coordinated drain under load
        for t in threads:
            t.join(timeout=120)
        assert not failures, failures[:5]
        assert r.metrics()["severed_streams_total"] == 0
    finally:
        if r is not None:
            r.close()
        for p in pods:
            p.close()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_concurrent_soak_with_pod_kill(model):
    """tests/test_router.py:1526 on the port: 8 clients of repeated-prefix
    traffic while a pod dies mid-soak; every response a 200 with the
    expected tokens, the dead pod out of rotation."""
    pods = [Pod(model) for _ in range(3)]
    r = Router("port", [p.url for p in pods], poll_s=0.2)
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(1, 60, size=6)] for _ in range(8)]
    try:
        expected = {}
        for p in prompts:
            status, _, raw = call(r.port, "/v1/generate", {"tokens": [p], "max_new_tokens": 4})
            assert status == 200
            expected[tuple(p)] = json.loads(raw)["tokens"]
        failures: list = []

        def client(idx: int):
            prompt = prompts[idx]
            for _ in range(15):
                try:
                    status, _, raw = call(r.port, "/v1/generate",
                                          {"tokens": [prompt], "max_new_tokens": 4})
                    if status != 200:
                        failures.append((idx, status, raw[:200]))
                    elif json.loads(raw)["tokens"] != expected[tuple(prompt)]:
                        failures.append((idx, "wrong tokens"))
                except OSError as e:
                    failures.append((idx, repr(e)))

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        time.sleep(0.4)
        pods[0].switch.kill()  # die under load
        for t in threads:
            t.join(timeout=120)
        assert not failures, failures[:5]
        until(lambda: not r.registry.pod(pods[0].url).healthy)
        assert r.metrics()["requests_total"] >= 8 * 15
    finally:
        r.close()
        for p in pods:
            p.close()


def _read_log(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_one_id_threads_logs_spans_and_timing_across_a_kill(model, tmp_path):
    """tests/test_router.py:1856 on the port: one request id threads the
    router's access log, both pods' access logs (the original attempt and
    the continuation), the span timeline and the in-stream timing block of
    a streamed request that failed over mid-stream after a seeded kill."""
    pods = []
    for i in range(2):
        pod = Pod.__new__(Pod)
        pod.sset = tserve.ServerSet({"m": model}, continuous_batch=True, max_slots=4,
                                    stream_chunk_size=1)
        pod.httpd = tserve.serve(pod.sset, listen=f"127.0.0.1:{free_port()}",
                                 access_log=str(tmp_path / f"pod{i}.log"))
        pod.switch = PodKillSwitch(pod.httpd, pod.sset)
        pod.port = pod.httpd.server_address[1]
        pod.url = f"http://127.0.0.1:{pod.port}"
        pods.append(pod)
    router_log = tmp_path / "router.log"
    r = Router("port", [p.url for p in pods], poll_s=60.0, access_log=str(router_log))
    rid = "e2e-trace-1"
    try:
        _arm_plan(pods, FaultPlan(seed=3).add("pod.kill", errors_at=[4],
                                              error=InjectedCrash("kill")))
        body = dict(STREAM, include_timing=True)
        status, headers, raw = call(r.port, "/v1/generate", body,
                                    headers={REQUEST_ID_HEADER: rid})
        assert status == 200 and headers[REQUEST_ID_HEADER] == rid
        lines = [json.loads(ln) for ln in raw.splitlines() if ln]
        assert any(p.switch.killed for p in pods), "the kill never fired"
        assert lines[-1] == {"done": True}
        (timing,) = [ln["timing"] for ln in lines if "timing" in ln]
        assert timing["total_ms"] > 0 and timing["ttft_ms"] > 0 and timing["tokens"] >= 1
        until(lambda: [x for x in _read_log(router_log) if x["request_id"] == rid])
        rrec = [x for x in _read_log(router_log) if x["request_id"] == rid][-1]
        assert (rrec["route"], rrec["attempt"], rrec["status"]) == ("continuation", 2, 200)
        attempts = set()
        for i in range(2):
            until(lambda i=i: [x for x in _read_log(tmp_path / f"pod{i}.log")
                               if x["request_id"] == rid])
            attempts.update(x["attempt"] for x in _read_log(tmp_path / f"pod{i}.log")
                            if x["request_id"] == rid)
        assert attempts == {1, 2}
        paths: set = set()
        for port in [r.port] + [p.port for p in pods if not p.switch.killed]:
            status, _, raw = call(port, f"/v1/trace?request_id={rid}")
            if status == 200:
                paths.update(json.loads(raw))
        assert any(p.startswith("serve.request") for p in paths)
        assert any(p.startswith("router.request") for p in paths)
    finally:
        r.close()
        for p in pods:
            p.close()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_fair_storm_with_pod_kill(model):
    """tests/test_admission.py:805 on the port: 3 clients, one 10x hotter,
    storm 2 pods through an admission-enabled router while one pod dies
    mid-storm. Every answer is the expected 200 or a typed shed; the cold
    clients keep goodput and the hot one cannot monopolize; upstream
    attempts stay inside the retry budget."""
    pods = [Pod(model) for _ in range(2)]
    r = Router("port", [p.url for p in pods], poll_s=0.2, request_timeout_s=30.0,
               admission=tadm.AdmissionController(fair_share=4, max_backlog=16),
               retry_budget=tadm.RetryBudget(ratio=0.2, reserve=10.0))
    rng = np.random.RandomState(9)
    prompts = {n: [int(t) for t in rng.randint(1, 60, size=6)] for n in ("hot", "cold1", "cold2")}
    try:
        expected = {}
        for name, prompt in prompts.items():
            status, _, raw = call(r.port, "/v1/forward", {"tokens": [prompt]})
            assert status == 200
            expected[name] = json.loads(raw)["logits_argmax"]
        results = {n: {"ok": 0, "shed": 0} for n in prompts}
        failures: list = []
        stop_at = time.monotonic() + 6.0
        lock = threading.Lock()

        def client(name: str) -> None:
            while time.monotonic() < stop_at:
                try:
                    status, _, raw = call(r.port, "/v1/forward", {"tokens": [prompts[name]]},
                                          headers={"X-ModelX-Client": name})
                except OSError as e:
                    with lock:
                        failures.append((name, repr(e)))
                    continue
                in_window = time.monotonic() <= stop_at
                with lock:
                    if status == 200:
                        if json.loads(raw)["logits_argmax"] != expected[name]:
                            failures.append((name, "wrong tokens"))
                        elif in_window:
                            results[name]["ok"] += 1
                    elif status in (429, 503, 504):
                        if "error" not in json.loads(raw):
                            failures.append((name, "untyped shed"))
                        if in_window:
                            results[name]["shed"] += 1
                    else:
                        failures.append((name, status, raw[:120]))

        threads = [threading.Thread(target=client, args=("hot",), daemon=True)
                   for _ in range(10)]
        threads += [threading.Thread(target=client, args=(n,), daemon=True)
                    for n in ("cold1", "cold2")]
        for t in threads:
            t.start()
        time.sleep(2.0)
        pods[0].switch.kill()  # mid-storm
        for t in threads:
            t.join(timeout=60)
        assert not failures, failures[:5]
        snap = r.router.snapshot()
        hot, c1, c2 = (results[n]["ok"] for n in ("hot", "cold1", "cold2"))
        assert c1 > 0 and c2 > 0
        assert hot < 6 * (c1 + c2), results
        adm = snap["admission"]
        shed_hot = adm["clients"].get("hdr:hot", {}).get("shed", 0)
        shed_cold = sum(adm["clients"].get(f"hdr:{n}", {}).get("shed", 0)
                        for n in ("cold1", "cold2"))
        if shed_hot + shed_cold > 0:
            assert shed_hot >= shed_cold, adm["clients"]
        assert tadm.jain_index([hot, (c1 + c2) * 5]) is not None
        m = snap["router"]
        assert m["upstream_attempts_total"] <= m["requests_total"] * 1.2 + 10 + 1, m
    finally:
        r.close()
        for p in pods:
            p.close()
