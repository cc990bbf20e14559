"""The port's router policy (modelx_tpu_torch/router/{policy, admission,
rebalance}.py) against the JAX package's, on the CPU: for hypothesis-drawn
requests, pod tables and event sequences under one injected clock, both
return equal results: ``sticky_keys``, ``rendezvous_pod``, ``plan_route``
and ``StickyTable``; ``TokenBucket``, ``RetryBudget``, ``BreakerBoard`` and
``AdmissionController`` decisions, snapshots and ``Retry-After`` values;
``plan_actions``. Tolerance: exact equality. No test here sleeps on the
wall clock: time moves only through the injected clock, and a queued
admission is followed by waiting for its waiter to appear, not by a sleep.
"""

import threading

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from modelx_tpu.router import admission as jadm
from modelx_tpu.router import policy as jpol
from modelx_tpu.router import rebalance as jreb
from modelx_tpu.router import registry as jreg
from modelx_tpu_torch.router import admission as tadm
from modelx_tpu_torch.router import policy as tpol
from modelx_tpu_torch.router import rebalance as treb
from modelx_tpu_torch.router import registry as treg

SETTINGS = dict(deadline=None, suppress_health_check=[HealthCheck.too_slow])


class Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


# -- requests and pod tables -------------------------------------------------------

token = st.integers(0, 300)
text = st.text(alphabet=st.sampled_from(list(" ab\tc\x00é日\n")), max_size=300)
message = st.fixed_dictionaries({"role": st.sampled_from(["system", "user", "assistant"]),
                                 "content": text})
request = st.one_of(
    st.fixed_dictionaries({"tokens": st.lists(st.lists(st.one_of(token, st.booleans()),
                                                       max_size=140), max_size=2)}),
    st.fixed_dictionaries({"text": text}),
    st.fixed_dictionaries({"prompt": st.one_of(text, st.lists(text, max_size=2))}),
    st.fixed_dictionaries({"messages": st.lists(st.one_of(message, st.just("x")), max_size=3)}),
    st.just({}),
)
windows = st.sampled_from([0, 1, 3, 4, 7, 16, 64, 100])


@settings(max_examples=300, **SETTINGS)
@given(model=st.sampled_from(["m", "llama3-8b"]), req=request, window=windows)
def test_sticky_keys_equal(model, req, window):
    assert tpol.sticky_keys(model, req, "/v1/generate", window) == \
        jpol.sticky_keys(model, req, "/v1/generate", window)


models = st.sampled_from(["a", "b"])
snap = st.fixed_dictionaries({
    "state": st.sampled_from(["READY", "LOADING", "DRAINING", "FAILED"]),
    "ref": st.sampled_from(["", "http://reg/library/x@v1"]),
    "inflight": st.integers(0, 2), "loads_total": st.integers(0, 3)})
serving = st.fixed_dictionaries({
    "queue_depth": st.integers(0, 9), "active": st.integers(0, 3), "waiting": st.integers(0, 3),
    "prefix_cache": st.fixed_dictionaries({"hit_per_s_1m": st.floats(0, 5),
                                           "published_total": st.integers(0, 2)})})
pod_row = st.fixed_dictionaries({
    "healthy": st.booleans(),
    "models": st.dictionaries(models, snap, max_size=2),
    "serving": st.dictionaries(models, serving, max_size=2),
    "control_plane": st.sampled_from([{}, {"state": "online"}, {"state": "offline"}])})
fleet = st.lists(pod_row, min_size=1, max_size=5)


def _pods(mod, rows):
    return [mod.PodState(f"http://pod-{i}:8000", healthy=r["healthy"], status="ok",
                         models=r["models"], serving=r["serving"],
                         control_plane=r["control_plane"]) for i, r in enumerate(rows)]


@settings(max_examples=200, **SETTINGS)
@given(rows=fleet, reqs=st.lists(request, min_size=1, max_size=6),
       inflight=st.dictionaries(st.sampled_from([f"http://pod-{i}:8000" for i in range(5)]),
                                st.integers(0, 8)))
def test_plan_route_and_sticky_table_equal(rows, reqs, inflight):
    jt, tt = jpol.StickyTable(max_entries=8), tpol.StickyTable(max_entries=8)
    jpods, tpods = _pods(jreg, rows), _pods(treg, rows)
    for req in reqs:
        keys = jpol.sticky_keys("a", req, "/v1/generate")
        jc = [p for p in jpods if p.serves("a")]
        tc = [p for p in tpods if p.serves("a")]
        jplan = [p.url for p in jpol.plan_route("a", jc, jt, keys, inflight)]
        tplan = [p.url for p in tpol.plan_route("a", tc, tt, keys, inflight)]
        assert tplan == jplan
        if keys and tc:
            assert tpol.rendezvous_pod(keys[-1], tc).url == jpol.rendezvous_pod(keys[-1], jc).url
        if tplan:
            jt.assign(keys, jplan[0])
            tt.assign(keys, tplan[0])
        assert tt.stats() == jt.stats()
    for i in range(len(rows)):
        url = f"http://pod-{i}:8000"
        assert tt.forget_pod(url, {"a"}) == jt.forget_pod(url, {"a"})
    assert tt.stats() == jt.stats()
    assert (tpol.DEFAULT_WINDOW_TOKENS, tpol.HRW_LOAD_SLACK) == \
        (jpol.DEFAULT_WINDOW_TOKENS, jpol.HRW_LOAD_SLACK)


@settings(max_examples=200, **SETTINGS)
@given(rows=fleet, pressure=st.dictionaries(models, st.integers(0, 9)),
       room=st.dictionaries(st.sampled_from([f"http://pod-{i}:8000" for i in range(5)]), models),
       high=st.integers(1, 5))
def test_plan_actions_equal(rows, pressure, room, high):
    def plan(reb, reg):
        pods = _pods(reg, rows)
        rates, published = reb.fleet_kv_signals(pods)
        return [a.snapshot() for a in reb.plan_actions(
            pods, pressure, queue_high=high, make_room_on=room, hit_rates=rates,
            kv_published=published)], rates, sorted(published)

    assert plan(treb, treg) == plan(jreb, jreg)


@settings(max_examples=200, **SETTINGS)
@given(rows=fleet)
def test_pod_state_reads_equal(rows):
    for jp, tp in zip(_pods(jreg, rows), _pods(treg, rows)):
        for m in ("a", "b"):
            assert (tp.serves(m), tp.queue_depth(m), tp.prefix_hit_rate(m),
                    tp.kv_published(m)) == (jp.serves(m), jp.queue_depth(m),
                                            jp.prefix_hit_rate(m), jp.kv_published(m))
        assert tp.snapshot() == jp.snapshot() and tp.ready_models() == jp.ready_models()


# -- the overload layer under one injected clock ------------------------------------

tick = st.tuples(st.just("tick"), st.floats(0.0, 3.0))


@settings(max_examples=200, **SETTINGS)
@given(rate=st.sampled_from([0.0, 0.25, 1.0, 3.0]), burst=st.sampled_from([0.0, 0.5, 2.0, 6.0]),
       events=st.lists(st.one_of(tick, st.tuples(st.just("take"), st.sampled_from([1.0, 0.5, 2.0]))),
                       max_size=40))
def test_token_bucket_equal(rate, burst, events):
    jc, tc = Clock(), Clock()
    jb, tb = jadm.TokenBucket(rate, burst, clock=jc), tadm.TokenBucket(rate, burst, clock=tc)
    for kind, x in events:
        if kind == "tick":
            jc.t += x
            tc.t += x
            continue
        assert (tb.wait_s(x), tb.take(x), tb.level()) == (jb.wait_s(x), jb.take(x), jb.level())


@settings(max_examples=200, **SETTINGS)
@given(ratio=st.sampled_from([0.0, 0.1, 0.5]), reserve=st.sampled_from([0.0, 1.0, 10.0]),
       events=st.lists(st.sampled_from(["attempt", "retry"]), max_size=60))
def test_retry_budget_equal(ratio, reserve, events):
    jb, tb = jadm.RetryBudget(ratio, reserve), tadm.RetryBudget(ratio, reserve)
    for e in events:
        if e == "attempt":
            jb.record_attempt()
            tb.record_attempt()
        else:
            assert tb.allow_retry() == jb.allow_retry()
    assert tb.snapshot() == jb.snapshot()


pod = st.sampled_from(["http://a", "http://b"])


@settings(max_examples=200, **SETTINGS)
@given(threshold=st.sampled_from([0, 1, 3]), cooldown=st.sampled_from([0.2, 5.0]),
       events=st.lists(st.one_of(tick, st.tuples(st.just("allow"), pod),
                                 st.tuples(st.sampled_from(["ok", "fail", "forget"]), pod)),
                       max_size=60))
def test_breaker_board_equal(threshold, cooldown, events):
    """The breaker's cooldown runs on the injected clock: an OPEN pod
    turns half-open only when the test moves time past it."""
    jc, tc = Clock(), Clock()
    jb = jadm.BreakerBoard(threshold, cooldown, clock=jc)
    tb = tadm.BreakerBoard(threshold, cooldown, clock=tc)
    for kind, x in events:
        if kind == "tick":
            jc.t += x
            tc.t += x
        elif kind == "allow":
            assert tb.allow(x) == jb.allow(x)
        elif kind == "forget":
            jb.forget(x)
            tb.forget(x)
        else:
            jb.record(x, kind == "ok")
            tb.record(x, kind == "ok")
        assert tb.snapshot() == jb.snapshot()


class _Admissions:
    """One AdmissionController driven event by event. An admission that
    queues runs on its own thread; the test waits until its waiter is in
    the backlog (or the call returned) before the next event, so the
    order of events is the order of decisions."""

    def __init__(self, mod, clock, **kw) -> None:
        self.ctrl = mod.AdmissionController(clock=clock, **kw)
        self.threads: list = []  # (thread, waiter, outcome dict)

    def _waiters(self) -> set:
        with self.ctrl._lock:
            return {w for c in self.ctrl._clients.values() for w in c.waiting}

    def admit(self, key: str, priority: str) -> str:
        before = self._waiters()
        out: dict = {}

        def run():
            try:
                self.ctrl.admit(key, priority=priority)
                out["result"] = "admitted"
            except Exception as e:  # the typed 429 or 504
                out["result"] = f"{type(e).__name__} {e.http_status} {e.headers()} {e}"

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while t.is_alive():
            new = self._waiters() - before
            if new:
                self.threads.append((t, new.pop(), out))
                return "queued"
            t.join(timeout=0.001)
        return out["result"]

    def settle(self) -> list:
        """Join every waiter the last event granted or evicted; their
        outcomes, in queue order."""
        done = []
        for t, w, out in list(self.threads):
            if w.granted or w.evicted:
                t.join()
                self.threads.remove((t, w, out))
                done.append(out["result"])
        return done


@settings(max_examples=60, **SETTINGS)
@given(kw=st.fixed_dictionaries({"fair_share": st.sampled_from([0, 1, 2]),
                                 "client_rate": st.sampled_from([0.0, 0.5, 2.0]),
                                 "max_backlog": st.sampled_from([0, 1, 3])}),
       events=st.lists(st.one_of(
           tick,
           st.tuples(st.just("admit"), st.tuples(st.sampled_from(["c1", "c2", "c3"]),
                                                 st.sampled_from(["interactive", "batch"]))),
           st.tuples(st.just("release"), st.sampled_from(["c1", "c2", "c3"]))), max_size=30))
def test_admission_decisions_equal(kw, events):
    """Admit, queue, shed (with its Retry-After), displace and grant
    decisions, and every snapshot, are equal event by event."""
    jc, tc = Clock(), Clock()
    ja, ta = _Admissions(jadm, jc, **kw), _Admissions(tadm, tc, **kw)
    held: dict = {}
    try:
        for kind, x in events:
            if kind == "tick":
                jc.t += x
                tc.t += x
                continue
            if kind == "admit":
                got = (ta.admit(*x), ja.admit(*x))
                assert got[0] == got[1]
                if got[0] in ("admitted", "queued"):
                    held[x[0]] = held.get(x[0], 0) + 1
            elif held.get(x, 0):
                held[x] -= 1
                ja.ctrl.release(x)
                ta.ctrl.release(x)
            assert ta.settle() == ja.settle()
            assert ta.ctrl.snapshot() == ja.ctrl.snapshot()
    finally:
        for adm in (ja, ta):  # grant what is still queued, so no thread is left
            while adm.threads:
                with adm.ctrl._lock:
                    holders = [c.key for c in adm.ctrl._clients.values() if c.inflight]
                adm.ctrl.release(holders[0] if holders else "c1")
                adm.settle()


def test_headers_and_helpers_equal():
    assert (tadm.DEADLINE_HEADER, tadm.PRIORITY_HEADER, tadm.CLIENT_HEADER) == \
        (jadm.DEADLINE_HEADER, jadm.PRIORITY_HEADER, jadm.CLIENT_HEADER)
    for v in (None, "", "abc", "-5", "0", "1500", "1e3", "nan", "inf", " 250 "):
        assert tadm.parse_deadline_ms(v) == jadm.parse_deadline_ms(v), v
    for v in (None, "", "batch", "BATCH", "interactive", "bulk"):
        assert tadm.parse_priority(v) == jadm.parse_priority(v), v
    for headers in ({}, {"Authorization": "Bearer tok"}, {"X-ModelX-Client": "team-a"},
                    {"Authorization": "Basic x", "X-ModelX-Client": "b"}):
        assert tadm.client_key(headers, ("10.0.0.1", 5)) == \
            jadm.client_key(headers, ("10.0.0.1", 5))
    for vals in ([], [0, 0], [1, 1, 1], [5, 1], [3, None, 3]):
        assert tadm.jain_index(vals) == jadm.jain_index(vals)
