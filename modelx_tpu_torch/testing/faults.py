"""Deterministic fault injection for the storage and serving paths
(counterpart of ``modelx_tpu/testing/faults.py``; the same schedules, so
the same plan gives the same verdict at the Nth call of an op).

The codebase already treats transient faults as EXPECTED on the storage
path (loader retry x3, governor backoff, extension retries) and — with
engine supervision — on the serving path too. This module makes those
faults reproducible on demand: a seeded ``FaultPlan`` holds per-operation
schedules (error / latency / truncation / short-read), and thin wrappers
apply them to the three seams the framework exposes:

- ``FaultyByteSource`` wraps any loader ``ByteSource`` (dl/loader.py);
- ``wrap_dispatch`` wraps an engine dispatch (the continuous
  engine's chunk step, ``dl/continuous.py _chunk``) so a crash lands at an exact call index;
- ``tests/fake_s3.py`` / ``tests/fake_gcs.py`` accept a plan directly
  (server-side 500s and mid-body truncation for blob-store traffic);
- ``FaultyFSProvider`` wraps any registry ``FSProvider`` with crash-point
  injection: abort before ``fs.put`` (nothing written) or mid-put (a TORN
  object commits, then :class:`InjectedCrash`), plus scheduled errors and
  latency on every provider op — the registry torn-write/scrub drills;
- ``FSRegistryStore(fault_plan=...)`` fires ``store.manifest_persisted``
  between manifest persist and index refresh, so stale-index recovery is
  a deterministic test;
- ``PodKillSwitch`` hard-kills a live serving pod's HTTP server (listener
  closed, live connections RST) — the fleet router's pod-death drills:
  mid-stream death must surface typed, failover must cover the rest;
- ``RegistryKillSwitch`` does the same to a RegistryServer and adds
  brownout modes (503 storms, accept-path hangs, mid-body truncation) —
  the control-plane outage drills: pods must keep serving from pinned
  manifests and local blobs while the registry is down.

Determinism: schedules are either explicit call indices (``errors_at``)
or drawn once per op from ``random.Random(seed ^ crc(op))`` at rule-add
time (``error_rate``) — the Nth call to an op always sees the same
verdict, independent of wall clock or thread interleaving (a lock orders
the counter).

Production use is ENV-GATED and default OFF: ``MODELX_FAULT_PLAN`` holds
inline JSON (or ``@/path/to/plan.json``) and ``from_env()`` returns None
unless it is set — the engine and loader consult it at construction, so
an unset env costs one getenv. Example:

    MODELX_FAULT_PLAN='{"seed": 7, "rules": [
        {"op": "engine.dispatch", "errors_at": [100], "error": "chaos"}]}'
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import zlib

ENV_VAR = "MODELX_FAULT_PLAN"


class Action:
    """What one call to ``fire(op)`` must do: sleep ``latency_s``, then
    raise ``error`` (if set); ``keep_bytes`` (when >= 0) tells byte-moving
    wrappers to truncate / short-read the payload instead."""

    __slots__ = ("error", "latency_s", "keep_bytes")

    def __init__(self) -> None:
        self.error: BaseException | None = None
        self.latency_s = 0.0
        self.keep_bytes = -1

    @property
    def clean(self) -> bool:
        return self.error is None and not self.latency_s and self.keep_bytes < 0


class _Rule:
    __slots__ = ("errors_at", "error", "latency_at", "latency_s",
                 "truncate_at", "keep_bytes")

    def __init__(self, errors_at, error, latency_at, latency_s,
                 truncate_at, keep_bytes) -> None:
        self.errors_at = frozenset(errors_at)
        self.error = error
        self.latency_at = frozenset(latency_at)
        self.latency_s = latency_s
        self.truncate_at = frozenset(truncate_at)
        self.keep_bytes = keep_bytes


def _freshen(err: BaseException) -> BaseException:
    """A fresh exception per raise: re-raising one instance accumulates
    tracebacks and couples unrelated call sites."""
    try:
        return type(err)(*err.args)
    except Exception:
        return RuntimeError(f"injected fault: {err}")


class FaultPlan:
    """Seeded, deterministic per-operation fault schedules. Thread-safe:
    ops are counted under a lock, so the Nth call to an op sees the same
    verdict whatever the thread interleaving."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)
        self._rules: dict[str, list[_Rule]] = {}
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    # -- schedule construction ------------------------------------------------

    def add(self, op: str, *, errors_at=(), error: BaseException | None = None,
            error_rate: float = 0.0, horizon: int = 256,
            latency_at=(), latency_s: float = 0.0,
            truncate_at=(), keep_bytes: int = 0) -> "FaultPlan":
        """Add one rule for ``op``. ``errors_at``/``latency_at``/
        ``truncate_at`` are 0-based call indices; ``error_rate`` draws a
        deterministic error schedule over the first ``horizon`` calls from
        the plan's seed (the same (seed, op, rate) always yields the same
        indices). Returns self for chaining."""
        errors_at = set(errors_at)
        if error_rate > 0.0:
            rng = random.Random(self.seed ^ zlib.crc32(op.encode()))
            errors_at |= {i for i in range(horizon) if rng.random() < error_rate}
        rule = _Rule(errors_at, error or OSError(f"injected fault on {op}"),
                     latency_at, float(latency_s), truncate_at, int(keep_bytes))
        with self._lock:
            self._rules.setdefault(op, []).append(rule)
        return self

    def has(self, op: str) -> bool:
        return op in self._rules

    def count(self, op: str) -> int:
        """Calls to ``op`` so far (observability for tests/drills)."""
        with self._lock:
            return self._counts.get(op, 0)

    # -- firing ---------------------------------------------------------------

    def fire(self, op: str) -> Action:
        """Count one call to ``op`` and return its scheduled action."""
        with self._lock:
            i = self._counts.get(op, 0)
            self._counts[op] = i + 1
            act = Action()
            for rule in self._rules.get(op, ()):
                if i in rule.latency_at:
                    act.latency_s = max(act.latency_s, rule.latency_s)
                if i in rule.truncate_at:
                    act.keep_bytes = rule.keep_bytes
                if i in rule.errors_at and act.error is None:
                    act.error = _freshen(rule.error)
            return act

    def maybe_fail(self, op: str) -> None:
        """Apply ``op``'s scheduled latency + error (the wrapper shape for
        call-through seams like engine dispatch)."""
        act = self.fire(op)
        if act.latency_s:
            time.sleep(act.latency_s)
        if act.error is not None:
            raise act.error


# -- seam wrappers -------------------------------------------------------------


class InjectedCrash(RuntimeError):
    """A deterministic 'host died here' stand-in. Raised at a scheduled
    point, it aborts the in-flight operation exactly where a crash would;
    the drill then rebuilds the store over the same underlying provider to
    model a process restart and asserts recovery (torn-write quarantine,
    stale-index rebuild, marker-protected GC)."""


class FaultyFSProvider:
    """Wrap any registry ``FSProvider`` with a seeded :class:`FaultPlan`.

    Ops fired (0-based call indices, per plan semantics): ``fs.put``,
    ``fs.get``, ``fs.stat``, ``fs.remove``, ``fs.exists``, ``fs.list``.
    Special ``fs.put`` behaviors:

    - an error schedule raises BEFORE the inner put — nothing written
      (crash before the write);
    - a truncation schedule (``truncate_at``/``keep_bytes``) COMMITS the
      torn prefix at the destination path and then raises
      :class:`InjectedCrash` — the torn-write shape a non-atomic backend
      (or a crash on a store without fsync-before-rename) produces. This
      is what the scrub/quarantine drills feed on.

    Unlike ``FaultInjectionFSProvider`` (callback-driven), schedules here
    are seeded and index-exact, so crash drills replay byte-identically.
    """

    def __init__(self, inner, plan: FaultPlan, prefix: str = "fs") -> None:
        self.inner = inner
        self.plan = plan
        self.prefix = prefix

    def _op(self, name: str) -> str:
        return f"{self.prefix}.{name}"

    def put(self, path: str, content, size: int = -1, content_type: str = "") -> None:
        act = self.plan.fire(self._op("put"))
        if act.latency_s:
            time.sleep(act.latency_s)
        if act.error is not None:
            raise act.error
        if act.keep_bytes >= 0:
            torn = content.read()[: act.keep_bytes]
            import io as _io

            self.inner.put(path, _io.BytesIO(torn), len(torn), content_type)
            raise InjectedCrash(
                f"torn write: {len(torn)} bytes committed at {path}"
            )
        self.inner.put(path, content, size, content_type)

    def get(self, path: str, offset: int = 0, length: int = -1):
        self.plan.maybe_fail(self._op("get"))
        return self.inner.get(path, offset, length)

    def stat(self, path: str):
        self.plan.maybe_fail(self._op("stat"))
        return self.inner.stat(path)

    def remove(self, path: str) -> None:
        self.plan.maybe_fail(self._op("remove"))
        self.inner.remove(path)

    def exists(self, path: str) -> bool:
        self.plan.maybe_fail(self._op("exists"))
        return self.inner.exists(path)

    def list(self, prefix: str, recursive: bool = False):
        self.plan.maybe_fail(self._op("list"))
        return self.inner.list(prefix, recursive)

    def __getattr__(self, name):
        # pass through provider extras (e.g. LocalFSProvider.local_path)
        return getattr(self.inner, name)


class PodKillSwitch:
    """Abrupt pod death for fleet-router drills — and, with a
    ``sset``, its opposite: coordinated drain.

    A clean ``httpd.shutdown()`` lets in-flight handlers FINISH — the
    opposite of a crash. This switch models the real thing: every accepted
    connection socket is tracked, and ``kill()`` closes the listener and
    severs every live connection (``shutdown(SHUT_RDWR)`` — a plain
    ``close()`` would only drop a reference while the handler's
    rfile/wfile keep the fd alive), so a client mid-stream sees a severed
    TCP stream — truncated chunked body, no terminator — not a graceful
    error event, and new connections are refused.

    ``drain()`` is the coordinated path the same drills must also cover:
    what SIGTERM does to a real pod (serve_main's handler), done to an
    in-process pod — ``sset.draining`` flips, ``/healthz`` answers 503
    ``{"status": "draining"}``, admission stops, live streams keep
    flowing so the fleet router can hand them off token-exactly.

    Seeded scheduling composes with :class:`FaultPlan`: drive the kill
    (or drain) from an exact call index by firing an op per relayed
    chunk and calling ``kill()``/``drain()`` when the scheduled error
    lands (see ``fire_kills``/``fire_drain``); the drill replays
    byte-identically.
    """

    def __init__(self, httpd, sset=None) -> None:
        self._httpd = httpd
        self._sset = sset
        self.draining = False
        self._conns: list = []
        self._lock = threading.Lock()
        self.killed = False
        orig_get_request = httpd.get_request

        def get_request():
            sock, addr = orig_get_request()
            with self._lock:
                self._conns.append(sock)
            return sock, addr

        httpd.get_request = get_request

    def kill(self) -> None:
        """Idempotent hard death: refuse new connections, sever live ones
        mid-whatever-they-were-doing."""
        import socket as _socket

        with self._lock:
            if self.killed:
                return
            self.killed = True
            conns = list(self._conns)
        try:
            self._httpd.socket.close()
        except OSError:
            pass  # already closed: the death is what matters
        for sock in conns:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass  # connection already gone
            try:
                sock.close()
            except OSError:
                pass

    def fire_kills(self, plan: FaultPlan, op: str = "pod.kill"):
        """A per-event hook: call the returned function once per relayed
        chunk/request; when the plan schedules an error at that index the
        pod dies THERE. Returns True when the kill fired."""

        def hook() -> bool:
            act = plan.fire(op)
            if act.latency_s:
                time.sleep(act.latency_s)
            if act.error is not None:
                self.kill()
                return True
            return False

        return hook

    def drain(self) -> None:
        """Coordinated drain: what serve_main's SIGTERM handler does,
        applied to an in-process pod. Idempotent; requires the switch to
        have been built with the pod's ServerSet."""
        if self._sset is None:
            raise RuntimeError("PodKillSwitch needs sset= to drain")
        self.draining = True
        self._sset.draining = True

    def fire_drain(self, plan: FaultPlan, op: str = "pod.drain"):
        """Like ``fire_kills`` but the scheduled event DRAINS the pod
        instead of killing it — drills cover both the crash and the
        coordinated hand-off path. Returns True when the drain fired."""

        def hook() -> bool:
            act = plan.fire(op)
            if act.latency_s:
                time.sleep(act.latency_s)
            if act.error is not None:
                self.drain()
                return True
            return False

        return hook


class RegistryKillSwitch:
    """Registry death and brownout for control-plane drills.

    Hard-down is the PodKillSwitch move applied to a RegistryServer:
    ``kill()`` closes the listener and severs every live connection, so
    in-flight manifest/blob requests die mid-stream and new connections
    are refused. A *restart* is modeled by constructing a fresh
    RegistryServer over the SAME store on the SAME port (the HTTP server
    sets ``allow_reuse_address``) — what the chaos soak does to assert
    the publish outbox drains after recovery.

    Brownout rides a seeded :class:`FaultPlan` fired once per ACCEPTED
    connection (op ``registry.accept``, 0-based indices):

    - an error schedule answers the connection with a raw ``503`` +
      ``Retry-After`` and closes it — the 50x storm a dying control
      plane emits (clients must back off per endpoint, then fail over);
    - a latency schedule sleeps in the accept path — the hang shape,
      surfaced to clients at their connect/read timeout
      (``--request-timeout``) granularity;
    - a truncation schedule lets the handler start responding, then
      severs the connection ``truncate_delay_s`` later — mid-body
      truncation, the torn blob stream digest verification must catch.

    Schedules replay byte-identically (the plan counts accepts under its
    lock); a switch with no plan is inert until ``kill()``.
    """

    OP = "registry.accept"

    def __init__(self, server, plan: FaultPlan | None = None,
                 truncate_delay_s: float = 0.01) -> None:
        self._httpd = server.httpd if hasattr(server, "httpd") else server
        self.plan = plan
        self.truncate_delay_s = float(truncate_delay_s)
        self._conns: list = []
        self._lock = threading.Lock()
        self.killed = False
        self.storms = 0  # connections answered with the injected 503
        orig_get_request = self._httpd.get_request

        def get_request():
            sock, addr = orig_get_request()
            with self._lock:
                self._conns.append(sock)
            if self.plan is not None:
                act = self.plan.fire(self.OP)
                if act.latency_s:
                    # brownout hang: the accept loop stalls, clients wait
                    # out their own timeouts
                    time.sleep(act.latency_s)
                if act.error is not None:
                    with self._lock:
                        self.storms += 1
                    try:
                        sock.sendall(
                            b"HTTP/1.1 503 Service Unavailable\r\n"
                            b"Retry-After: 1\r\nContent-Length: 0\r\n"
                            b"Connection: close\r\n\r\n"
                        )
                    except OSError:
                        pass  # client already gone; the refusal stands
                    self._sever(sock)
                    # swallowed by BaseServer._handle_request_noblock: the
                    # serve loop continues, this connection never reaches
                    # a handler
                    raise OSError("injected 503 storm")
                if act.keep_bytes >= 0:
                    t = threading.Timer(self.truncate_delay_s,
                                        self._sever, args=(sock,))
                    t.daemon = True
                    t.start()
            return sock, addr

        self._httpd.get_request = get_request

    @staticmethod
    def _sever(sock) -> None:
        import socket as _socket

        try:
            sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass  # connection already gone
        try:
            sock.close()
        except OSError:
            pass

    def kill(self) -> None:
        """Idempotent hard death: refuse new connections, sever live
        ones mid-stream."""
        with self._lock:
            if self.killed:
                return
            self.killed = True
            conns = list(self._conns)
        try:
            self._httpd.socket.close()
        except OSError:
            pass  # already closed: the death is what matters
        for sock in conns:
            self._sever(sock)


def wrap_dispatch(fn, plan: FaultPlan, op: str = "engine.dispatch"):
    """Wrap a dispatch callable (e.g. the continuous engine's
    chunk program): scheduled latency/errors fire BEFORE the real call, so
    a crash at call index N never half-applies device state."""

    def wrapped(*args, **kwargs):
        plan.maybe_fail(op)
        return fn(*args, **kwargs)

    wrapped.__wrapped__ = fn
    return wrapped


class FaultyByteSource:
    """A loader ``ByteSource`` with scheduled faults. Errors surface as
    OSError (what the loader's ``_read_with_retry`` treats as transient);
    a truncation schedule performs a SHORT READ — the head of the range
    lands in the caller's buffer, then the read fails like a dropped
    connection, exercising partial-spool recovery paths."""

    def __init__(self, source, plan: FaultPlan, op: str = "loader.read") -> None:
        self._source = source
        self.plan = plan
        self.op = op

    def read_range(self, offset: int, length: int, out=None):
        act = self.plan.fire(self.op)
        if act.latency_s:
            time.sleep(act.latency_s)
        if act.error is not None:
            raise act.error
        if 0 <= act.keep_bytes < length:
            if act.keep_bytes and out is not None:
                self._source.read_range(offset, act.keep_bytes,
                                        memoryview(out)[: act.keep_bytes])
            raise OSError(
                f"injected short read: {act.keep_bytes}/{length} bytes at {offset}"
            )
        return self._source.read_range(offset, length, out)

    def close(self) -> None:
        close = getattr(self._source, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        # pass through source extras (the port's sources carry ``transport``
        # and ``native_reads``)
        return getattr(self._source, name)


# -- env gating ----------------------------------------------------------------


def from_env(env_var: str = ENV_VAR) -> FaultPlan | None:
    """Build a plan from ``MODELX_FAULT_PLAN`` (inline JSON or ``@path``);
    None when unset — the default-off gate every production seam uses."""
    spec = os.environ.get(env_var, "")
    if not spec:
        return None
    if spec.startswith("@"):
        with open(spec[1:], encoding="utf-8") as f:
            spec = f.read()
    d = json.loads(spec)
    plan = FaultPlan(seed=int(d.get("seed", 0)))
    for r in d.get("rules", ()):
        err: BaseException | None = None
        if r.get("crash"):
            err = InjectedCrash(r.get("error", "injected crash"))
        elif r.get("error"):
            err = OSError(r["error"])
        plan.add(
            r["op"],
            errors_at=r.get("errors_at", ()),
            error=err,
            error_rate=float(r.get("error_rate", 0.0)),
            horizon=int(r.get("horizon", 256)),
            latency_at=r.get("latency_at", ()),
            latency_s=float(r.get("latency_s", 0.0)),
            truncate_at=r.get("truncate_at", ()),
            keep_bytes=int(r.get("keep_bytes", 0)),
        )
    return plan
