"""Supervision and admission control of the port's continuous engine, on
the CPU: a crash injected into the chunk step fails its waiters with typed
errors and the engine rebuilds and serves the same tokens again; the
breaker opens after ``max_crashes``; a request whose admission crashed the
loop twice is quarantined (400); the boundary watchdog turns a wedged
dispatch into a crash; a full backlog sheds with 429 + ``Retry-After``
(the JAX package's ``QueueFullError``) and an expired deadline answers 504,
in the engine and on the HTTP surface; a crash dump carries the flight
recorder's events.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl.continuous import ContinuousBatcher
from modelx_tpu_torch.dl.serve import ModelServer, ServerSet, serve
from modelx_tpu_torch.dl.serving_errors import (
    DeadlineExceededError,
    EngineBrokenError,
    PoisonedRequestError,
    QueueFullError,
    ServingError,
)
from tests.test_torch_continuous import write_tiny_fp32

TOKENS = np.array([[5, 9, 2, 7, 1]], np.int32)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-faults"))
    write_tiny_fp32(d)
    srv = ModelServer(d, dtype="float32", device="cpu", max_seq_len=96)
    srv.load()
    return srv


def _crash_next(cb, attr: str = "_chunk", n: int = 1, error=None, sleep_s: float = 0.0):
    """Make the engine's next ``n`` calls of ``attr`` raise (or, with
    ``sleep_s``, stall first); later calls run the real step."""
    real = getattr(cb, attr)
    left = [n]

    def faulty(*a, **kw):
        if left[0] > 0:
            left[0] -= 1
            if sleep_s:
                time.sleep(sleep_s)
            else:
                raise error or RuntimeError("injected")
        return real(*a, **kw)

    setattr(cb, attr, faulty)


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pred()


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_crash_fails_waiters_typed_then_rebuilds_exactly(server, page_size, tmp_path):
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, page_size=page_size,
                           restart_backoff_s=0.05, flight_dump_dir=str(tmp_path))
    try:
        expected = server.generate(TOKENS, max_new_tokens=11)
        np.testing.assert_array_equal(cb.generate(TOKENS, max_new_tokens=11), expected)
        _crash_next(cb)
        with pytest.raises(EngineBrokenError, match="injected"):
            cb.generate(TOKENS, max_new_tokens=11)
        _wait(lambda: cb.snapshot()["engine_restarts"] >= 1 and cb.engine_state == "running")
        np.testing.assert_array_equal(cb.generate(TOKENS, max_new_tokens=11), expected)
        snap = cb.snapshot()
        assert snap["engine_restarts"] == 1 and snap["quarantined"] == 0
        if page_size:
            assert snap["pages_free"] == cb.num_pages - 1  # the pool was rebuilt
        dumps = os.listdir(tmp_path)
        assert len(dumps) == 1 and "crash" in dumps[0]
        lines = [json.loads(x) for x in open(tmp_path / dumps[0])]
        assert lines[0]["kind"] == "flightrec" and "injected" in lines[0]["error"]
        assert any(x.get("event") == "crash" for x in lines)
    finally:
        cb.close()


def test_every_waiter_of_a_crash_gets_a_typed_error_or_is_served(server):
    cb = ContinuousBatcher(server, max_slots=1, chunk_size=4, restart_backoff_s=0.05)
    try:
        long_t = cb.submit([5, 5, 5], 48, {})
        assert isinstance(long_t.out.get(timeout=30), np.ndarray)  # admitted
        waiters = [cb.submit([2, 2], 8, {}) for _ in range(3)]
        _crash_next(cb)
        outcomes = []
        for t in [long_t] + waiters:
            while True:
                item = t.out.get(timeout=60)
                if isinstance(item, BaseException):
                    assert isinstance(item, EngineBrokenError), item
                    outcomes.append("failed")
                    break
                if not isinstance(item, np.ndarray):
                    outcomes.append("served")
                    break
        assert outcomes[0] == "failed"
    finally:
        cb.close()


def test_breaker_opens_after_max_crashes(server):
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, restart_backoff_s=0.01,
                           max_crashes=2, crash_window_s=60.0)
    try:
        _crash_next(cb, n=64, error=RuntimeError("always"))
        deadline = time.monotonic() + 60
        while cb.engine_state != "broken" and time.monotonic() < deadline:
            with pytest.raises(ServingError):
                cb.generate(TOKENS[:, :2], max_new_tokens=4)
            time.sleep(0.02)
        assert cb.engine_state == "broken"
        with pytest.raises(EngineBrokenError, match="broken"):
            cb.submit([4, 5], 4, {})
        assert cb.snapshot()["engine_restarts"] == 2
    finally:
        cb.close()


def test_poisoned_request_is_quarantined_with_400(server):
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, restart_backoff_s=0.02)
    try:
        cb.generate(np.array([[1, 2, 3]], np.int32), max_new_tokens=4)
        _crash_next(cb, attr="_prefill", n=2, error=RuntimeError("poison"))
        poison = np.array([[7, 7, 7, 7]], np.int32)
        for i in range(2):
            with pytest.raises(EngineBrokenError):
                cb.generate(poison, max_new_tokens=5)
            _wait(lambda: cb.snapshot()["engine_restarts"] >= i + 1
                  and cb.engine_state == "running")
        with pytest.raises(PoisonedRequestError) as ei:
            cb.generate(poison, max_new_tokens=5)
        assert ei.value.http_status == 400
        assert cb.snapshot()["quarantined"] == 1
        # a different budget is a different request; innocent ones serve
        assert cb.generate(poison, max_new_tokens=6).shape == (1, 10)
    finally:
        cb.close()


def test_watchdog_fails_a_wedged_dispatch_then_restarts(server):
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, restart_backoff_s=0.05,
                           boundary_watchdog_s=30.0)
    try:
        expected = server.generate(TOKENS, max_new_tokens=11)
        np.testing.assert_array_equal(cb.generate(TOKENS, max_new_tokens=11), expected)
        cb.boundary_watchdog_s = 0.2
        _crash_next(cb, sleep_s=2.0)
        t0 = time.monotonic()
        with pytest.raises(EngineBrokenError, match="watchdog"):
            cb.generate(TOKENS, max_new_tokens=11)
        assert time.monotonic() - t0 < 1.9  # failed by the watchdog, mid-wedge
        assert cb.stats["watchdog_stalls"] == 1
        # the wide window again: a loaded CPU can take 0.2 s for a real step
        cb.boundary_watchdog_s = 30.0
        _wait(lambda: cb.snapshot()["engine_restarts"] >= 1 and cb.engine_state == "running")
        np.testing.assert_array_equal(cb.generate(TOKENS, max_new_tokens=11), expected)
    finally:
        cb.close()


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_full_queue_sheds_429_with_retry_after(server, page_size):
    cb = ContinuousBatcher(server, max_slots=1, chunk_size=4, page_size=page_size,
                           max_queue_depth=2)
    try:
        busy = cb.submit([5, 5, 5], 40, {})
        assert isinstance(busy.out.get(timeout=30), np.ndarray)  # holds the slot
        queued = [cb.submit([2, 3], 4, {}) for _ in range(2)]
        with pytest.raises(QueueFullError) as ei:
            cb.submit([2, 3], 4, {})
        assert ei.value.http_status == 429 and ei.value.headers() == {"Retry-After": "3"}
        assert cb.snapshot()["shed"] == 1 and cb.snapshot()["queue_depth"] == 2
        for t in [busy] + queued:
            list(cb._drain_row(t.out))
        assert cb.snapshot()["queue_depth"] == 0
    finally:
        cb.close()


@pytest.mark.parametrize("state", ["waiting for a slot", "prefilling", "decoding"])
def test_deadline_expires_504_in_every_state(server, state):
    cb = ContinuousBatcher(server, max_slots=1, chunk_size=4, prefill_chunk=16)
    try:
        if state == "waiting for a slot":
            busy = cb.submit([5, 5, 5], 60, {})
            assert isinstance(busy.out.get(timeout=30), np.ndarray)
            t = cb.submit([2, 3], 4, {}, timeout_s=0.05)
        elif state == "prefilling":
            slow = cb._piece
            cb._piece = lambda *a: (time.sleep(0.05), slow(*a))[1]
            t = cb.submit(list(range(1, 70)), 4, {}, timeout_s=0.08)
        else:
            t = cb.submit([2, 3], 70, {}, timeout_s=0.05)
            slow = cb._chunk
            cb._chunk = lambda *a: (time.sleep(0.02), slow(*a))[1]
        with pytest.raises(DeadlineExceededError, match=state) as ei:
            list(cb._drain_row(t.out))
        assert ei.value.http_status == 504
        assert cb.snapshot()["expired"] == 1
    finally:
        cb.close()


def _post(port, path, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_surface_maps_engine_states(server):
    sset = ServerSet({"m": server}, continuous_batch=True, max_slots=1, stream_chunk_size=4,
                     max_queue_depth=1)
    sset.pool.mark_ready("m")
    port = free_port()
    httpd = serve(sset, listen=f"127.0.0.1:{port}")
    try:
        assert _post(port, "/v1/m/generate", {"tokens": [[5, 9]], "max_new_tokens": 3})[0] == 200
        cb = sset.cbatchers["m"]
        # 429 + Retry-After: a slot busy and the one queue place taken
        held = threading.Event()
        slow = cb._chunk
        cb._chunk = lambda *a: (held.wait(10), slow(*a))[1]
        bg = [threading.Thread(target=_post, args=(port, "/v1/m/generate",
                                                   {"tokens": [[5, 9]], "max_new_tokens": 30}))
              for _ in range(2)]
        bg[0].start()
        _wait(lambda: cb._rows)
        bg[1].start()
        _wait(lambda: cb.snapshot()["queue_depth"] == 1)
        status, headers, body = _post(port, "/v1/m/generate",
                                      {"tokens": [[5, 9]], "max_new_tokens": 3})
        assert status == 429 and headers["Retry-After"] == "2"
        assert "admission queue full" in json.loads(body)["error"]
        held.set()
        for t in bg:
            t.join()
        cb._chunk = slow
        # an expired propagated deadline: 504 before any work
        status, _, body = _post(port, "/v1/m/generate", {"tokens": [[5, 9]]},
                                {"X-ModelX-Deadline-Ms": "0"})
        assert status == 504 and "deadline" in json.loads(body)["error"]
        # a crash with a long backoff: /healthz drains, /livez stays alive
        cb.restart_backoff_s = 30.0
        _crash_next(cb)
        assert _post(port, "/v1/m/generate", {"tokens": [[5, 9]], "max_new_tokens": 8})[0] == 503
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/livez") as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "engine-restarting"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/admin/models") as r:
            serving = json.loads(r.read())["serving"]["m"]
        assert serving["engine_state"] == "restarting"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/flightrec") as r:
            rings = json.loads(r.read())
        assert set(rings) == {"m", "pool"}
        assert any(e["event"] == "crash" for e in rings["m"]["events"])
        cb._closed_ev.set()  # cut the backoff short
        _wait(lambda: cb.engine_state == "running")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert r.status == 200
        # the breaker: /livez fails only now
        cb.max_crashes = 0
        _crash_next(cb)
        _post(port, "/v1/m/generate", {"tokens": [[5, 9]], "max_new_tokens": 8})
        _wait(lambda: cb.engine_state == "broken")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/livez")
        assert ei.value.code == 503 and json.loads(ei.value.read()) == {"status": "engine-broken"}
    finally:
        sset.close()
        httpd.shutdown()
        httpd.server_close()


def test_kv_allocation_oom_sheds_an_idle_model_and_retries_once(server, monkeypatch):
    """An out-of-memory KV allocation demotes an idle tenant
    (``shed_idle_for_bytes``), records ``engine.alloc_oom_retry`` and
    retries once; with nothing to shed it answers the typed 503."""
    import torch

    from modelx_tpu_torch.dl import continuous

    real = continuous.ContinuousBatcher._alloc_device_state
    fails = [1]

    def oom_once(self, max_live_tokens):
        if fails[0]:
            fails[0] -= 1
            self._cache = {"k0": torch.zeros(4)}  # a partial allocation, dropped
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return real(self, max_live_tokens)

    monkeypatch.setattr(continuous.ContinuousBatcher, "_alloc_device_state", oom_once)
    other = ModelServer(server.model_dir, dtype="float32", device="cpu", max_seq_len=96)
    sset = ServerSet({"a": server, "b": other}, continuous_batch=True, max_slots=2,
                     stream_chunk_size=4)
    try:
        sset.load_all()
        cb = sset.continuous_for(sset.servers["a"])
        assert cb is not None and cb.engine_state == "running"
        assert sset.pool.states()["b"]["state"] == "UNLOADED"
        ev = [e for e in sset.pool.flightrec.events() if e["event"] == "engine.alloc_oom_retry"]
        assert len(ev) == 1 and ev[0]["model"] == "a" and ev[0]["freed_bytes"] > 0
        np.testing.assert_array_equal(cb.generate(TOKENS, max_new_tokens=5),
                                      server.generate(TOKENS, max_new_tokens=5))
    finally:
        sset.close()
    fails[0] = 1
    lone = ServerSet({"a": server}, continuous_batch=True, max_slots=2)
    lone.pool.mark_ready("a")
    with pytest.raises(EngineBrokenError, match="no idle model") as ei:
        lone.continuous_for(server)
    assert ei.value.http_status == 503


# -- the chaos sweep (make chaos-torch: under the port's lockdep) ----------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_seeded_dispatch_fault_sweep_always_terminates(server):
    """tests/test_engine_faults.py:665 on the port: across seeds, a
    supervised engine under a random dispatch-fault schedule keeps serving
    (restarts) or breaks its circuit cleanly; every request ends with its
    tokens or a typed error, never a hang."""
    from modelx_tpu_torch.testing import faults

    for seed in range(3):
        cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, restart_backoff_s=0.01,
                               max_crashes=4, crash_window_s=30.0)
        plan = faults.FaultPlan(seed=seed)
        plan.add("engine.dispatch", error_rate=0.15, horizon=128, error=RuntimeError("chaos"))
        cb._chunk = faults.wrap_dispatch(cb._chunk, plan)
        try:
            outcomes = []
            for i in range(12):
                tokens = np.array([[1 + (seed + i) % 9, 2, 3]], np.int32)
                try:
                    out = cb.generate(tokens, max_new_tokens=6)
                    assert out.shape == (1, 9)
                    outcomes.append("ok")
                except ServingError:
                    outcomes.append("err")
                if cb.engine_state == "broken":
                    break
            assert outcomes, "no request terminated"
            assert cb.engine_state in ("running", "restarting", "broken")
            assert plan.count("engine.dispatch") > 0
        finally:
            cb.close()
