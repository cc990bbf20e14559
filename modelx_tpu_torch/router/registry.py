"""Pod registry: the router's placement table (counterpart of
``modelx_tpu/router/registry.py``).

A background poller scrapes every backend pod's ``GET /healthz`` and
``GET /admin/models`` (which carries the per-model ``serving``
block: queue depth + prefix-cache stats, so ONE endpoint yields the whole
ranking signal) into :class:`PodState` rows:

    model -> [pods x lifecycle state x queue depth x engine health]

Health has two inputs with different latencies:

- the POLL (every ``poll_interval_s``, with the shared
  ``utils/retry.RetryPolicy`` backoff inside one poll round): a pod whose
  poll fails after retries is DEMOTED — no new routes — until a poll
  succeeds again;
- the DATA PATH (``quarantine``): when a proxied request hits a
  connection error, the front door quarantines the pod IMMEDIATELY —
  waiting up to ``poll_interval_s`` to stop routing at a dead pod would
  shed every in-between request into connection errors. A quarantined pod
  only returns through a successful poll.

Lock discipline (the analysis gate's blocking-under-lock rule): all HTTP
happens OUTSIDE ``_lock``; a poll round collects every pod's fresh state
first, then swaps it in under the lock.
"""

from __future__ import annotations

import logging
import threading
import time

from modelx_tpu_torch.router.http import LazySession, TransportError, bearer_headers
from modelx_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger("modelx.router")

# lifecycle states a pod reports per model (dl/lifecycle.py); only READY
# models on healthy pods are routable
READY = "READY"
_ROUTABLE_HEALTH = ("ok", "degraded")  # /healthz statuses that admit routes


class PodState:
    """One pod's last-known placement row. Immutable by convention once
    published into the registry's table (poll rounds REPLACE rows rather
    than mutating them, so readers never see a half-updated pod)."""

    __slots__ = ("url", "healthy", "status", "models", "serving", "pool",
                 "control_plane", "consecutive_failures", "polled_at", "error")

    def __init__(self, url: str, healthy: bool = False, status: str = "unpolled",
                 models: dict | None = None, serving: dict | None = None,
                 pool: dict | None = None, control_plane: dict | None = None,
                 consecutive_failures: int = 0,
                 polled_at: float = 0.0, error: str = "") -> None:
        self.url = url
        self.healthy = healthy
        self.status = status              # /healthz status string
        self.models = models or {}        # name -> lifecycle snapshot
        self.serving = serving or {}      # name -> {queue_depth, prefix_cache,..}
        self.pool = pool or {}            # pod-level HBM budget accounting
        self.control_plane = control_plane or {}  # pod's registry health view
        self.consecutive_failures = consecutive_failures
        self.polled_at = polled_at        # monotonic stamp of last attempt
        self.error = error                # last poll failure, for /metrics

    def ready_models(self) -> list[str]:
        return [n for n, snap in self.models.items()
                if snap.get("state") == READY]

    def serves(self, model: str) -> bool:
        return self.healthy and self.models.get(model, {}).get("state") == READY

    def queue_depth(self, model: str) -> int:
        d = self.serving.get(model, {})
        return int(d.get("queue_depth", 0)) + int(d.get("active", 0)) \
            + int(d.get("waiting", 0))

    def prefix_hit_rate(self, model: str) -> float:
        """This pod's 1m-windowed prefix-cache hit rate for ``model``
        (hits/s from the serving block's tswheel export) — the rebalance
        heat signal: a model hitting its prefix cache NOW has a shared
        prompt worth pre-installing on any replica spread."""
        pc = self.serving.get(model, {}).get("prefix_cache", {})
        try:
            return float(pc.get("hit_per_s_1m", 0.0))
        except (TypeError, ValueError):
            return 0.0

    def kv_published(self, model: str) -> bool:
        """Has this pod shipped prefix KV for ``model`` to the registry
        (published_total in the serving block)? Used to judge whether a
        quarantined pod's sticky-cache loss is recoverable."""
        pc = self.serving.get(model, {}).get("prefix_cache", {})
        try:
            return int(pc.get("published_total", 0)) > 0
        except (TypeError, ValueError):
            return False

    def snapshot(self) -> dict:
        """JSON-safe view for the router's /metrics."""
        out = {
            "healthy": self.healthy,
            "status": self.status,
            "models": {n: s.get("state") for n, s in self.models.items()},
            "consecutive_failures": self.consecutive_failures,
        }
        if self.serving:
            out["serving"] = self.serving
        if self.control_plane:
            out["control_plane"] = self.control_plane.get("state", "")
        if self.error:
            out["error"] = self.error
        return out


class PodRegistry:
    """Polls a fixed set of pod base URLs into a placement table.

    ``session`` is any object with ``request(method, url, ...)`` returning
    a requests-shaped response, injected by tests; the default is the
    router's keep-alive transport (``router/http.py``)."""

    def __init__(self, pod_urls: list[str], poll_interval_s: float = 2.0,
                 poll_timeout_s: float = 5.0,
                 retry: RetryPolicy | None = None,
                 admin_token: str = "", session=None) -> None:
        urls = [u.rstrip("/") for u in pod_urls]
        if not urls:
            raise ValueError("router needs at least one --pod URL")
        if len(set(urls)) != len(urls):
            raise ValueError("duplicate --pod URLs")
        self.poll_interval_s = float(poll_interval_s)
        self.poll_timeout_s = float(poll_timeout_s)
        # one poll ROUND retries each pod with the same backoff +
        # Retry-After stance the registry client uses (utils/retry.py);
        # short budget — the next round is at most poll_interval_s away
        self.retry = retry or RetryPolicy(retries=2, backoff_s=0.1,
                                          retry_after_cap_s=2.0)
        self.admin_token = admin_token
        self._session = LazySession(session)
        self._lock = threading.Lock()
        self._pods: dict[str, PodState] = {u: PodState(u) for u in urls}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.polls_total = 0
        self.poll_failures_total = 0

    # -- plumbing -------------------------------------------------------------

    def _get_json(self, url: str) -> tuple[int, dict]:
        """One GET with the shared retry stance; returns (status, body).
        Raises the transport's exception when every attempt failed to
        CONNECT; HTTP error statuses return normally (the poller decides
        what they mean)."""
        headers = bearer_headers(self.admin_token)
        for attempt in self.retry.attempts():
            try:
                resp = self._session.get().request(
                    "GET", url, headers=headers, timeout=self.poll_timeout_s
                )
            except TransportError:
                if self.retry.last(attempt):
                    raise
                self.retry.sleep(attempt, None)
                continue
            if resp.status_code >= 500 and not self.retry.last(attempt):
                retry_after = resp.headers.get("Retry-After")
                resp.close()
                self.retry.sleep(attempt, retry_after)
                continue
            try:
                body = resp.json() if resp.content else {}
            except ValueError:
                body = {}
            return resp.status_code, body
        raise AssertionError("unreachable")  # every path above returns/raises

    # -- polling --------------------------------------------------------------

    def start(self) -> None:
        """Run the poll loop on a daemon thread (one immediate round first,
        so candidates() works as soon as start() returns)."""
        self.poll_once()
        self._thread = threading.Thread(
            target=self._run, name="router-pod-poller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_timeout_s + 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:
                # a poll round must never kill the poller thread; the
                # per-pod failure accounting below is the real signal
                logger.exception("poll round failed")

    def poll_once(self) -> None:
        """One poll round: every pod's fresh state is collected OUTSIDE
        the lock — CONCURRENTLY, so one blackholed pod costs the round
        one timeout, not pods x timeouts — then swapped in. A row the
        data path quarantined DURING the round keeps its quarantine (the
        round's sample predates the observed death; only the NEXT round,
        which samples the pod after it, may restore it)."""
        round_start = time.monotonic()
        with self._lock:
            urls = list(self._pods)
            prev = {u: self._pods[u] for u in urls}
        fresh: dict[str, PodState] = {}
        fresh_lock = threading.Lock()

        def one(u: str) -> None:
            state = self._poll_pod(u, prev[u])
            with fresh_lock:
                fresh[u] = state

        threads = [threading.Thread(target=one, args=(u,),
                                    name=f"router-poll-{i}", daemon=True)
                   for i, u in enumerate(urls)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._lock:
            for u, state in fresh.items():
                cur = self._pods.get(u)
                if (cur is not None and cur.status == "quarantined"
                        and cur.polled_at > round_start):
                    continue  # death observed mid-round beats a stale sample
                self._pods[u] = state
            self.polls_total += 1

    def _poll_pod(self, url: str, prev: PodState) -> PodState:
        now = time.monotonic()
        try:
            h_status, h_body = self._get_json(url + "/healthz")
            health = str(h_body.get("status", ""))
            healthy = h_status == 200 and health in _ROUTABLE_HEALTH
            models: dict = {}
            serving: dict = {}
            pool: dict = {}
            control_plane: dict = {}
            # lifecycle + load detail even while not ready: a LOADING pod's
            # table row lets /metrics (and the rebalancer) see it coming
            a_status, a_body = self._get_json(url + "/admin/models")
            if a_status == 200:
                models = dict(a_body.get("models", {}))
                serving = dict(a_body.get("serving", {}))
                pool = dict(a_body.get("pool", {}))
                control_plane = dict(a_body.get("control_plane", {}))
            elif a_status == 401:
                # auth misconfiguration is an operator error, not a dead
                # pod: say so in the table instead of flapping health
                return PodState(
                    url, healthy=False, status="admin-unauthorized",
                    consecutive_failures=prev.consecutive_failures + 1,
                    polled_at=now,
                    error="GET /admin/models: 401 (pass --pod-admin-token)",
                )
            return PodState(url, healthy=healthy, status=health or str(h_status),
                            models=models, serving=serving, pool=pool,
                            control_plane=control_plane,
                            consecutive_failures=0, polled_at=now)
        except TransportError as e:
            with self._lock:  # poll rounds run one thread per pod now
                self.poll_failures_total += 1
            # keep the last-known placement (like quarantine does): a
            # fully-dead fleet should answer "no ready pod, retry" for a
            # model it certainly served, not 404 as if the name never
            # existed
            return PodState(
                url, healthy=False, status="unreachable",
                models=prev.models, serving=prev.serving, pool=prev.pool,
                control_plane=prev.control_plane,
                consecutive_failures=prev.consecutive_failures + 1,
                polled_at=now, error=str(e)[:200],
            )

    # -- data-path demotion ---------------------------------------------------

    def quarantine(self, url: str, reason: str = "connection failed") -> None:
        """Immediate demotion from the data path: a request just watched
        this pod's connection die. The pod stops receiving routes NOW and
        only returns through a successful poll."""
        url = url.rstrip("/")
        with self._lock:
            pod = self._pods.get(url)
            if pod is None:
                return
            self._pods[url] = PodState(
                url, healthy=False, status="quarantined",
                models=pod.models, serving=pod.serving, pool=pod.pool,
                control_plane=pod.control_plane,
                consecutive_failures=pod.consecutive_failures + 1,
                polled_at=time.monotonic(), error=reason[:200],
            )
        logger.warning("pod %s quarantined: %s", url, reason)

    # -- reads ----------------------------------------------------------------

    def pods(self) -> list[PodState]:
        with self._lock:
            return list(self._pods.values())

    def pod(self, url: str) -> PodState | None:
        with self._lock:
            return self._pods.get(url.rstrip("/"))

    def candidates(self, model: str) -> list[PodState]:
        """READY pods for ``model``, least-loaded first (poll-time queue
        depth; the front door adds its own live in-flight counts on top).
        DRAINING/LOADING/FAILED models and unhealthy pods never appear."""
        with self._lock:
            pods = list(self._pods.values())
        out = [p for p in pods if p.serves(model)]
        out.sort(key=lambda p: (p.queue_depth(model), p.url))
        return out

    def known_state(self, model: str) -> str | None:
        """Best lifecycle state any pod reports for ``model`` (routable or
        not) — lets the front door answer 503 + Retry-After for a model
        that is LOADING somewhere rather than a blank 503."""
        rank = {"READY": 0, "LOADING": 1, "PULLING": 2, "DRAINING": 3,
                "FAILED": 4, "UNLOADED": 5}
        best: str | None = None
        with self._lock:
            pods = list(self._pods.values())
        for p in pods:
            st = p.models.get(model, {}).get("state")
            if st is None:
                continue
            if best is None or rank.get(st, 9) < rank.get(best, 9):
                best = st
        return best

    def models(self) -> dict[str, dict]:
        """Fleet-wide model inventory: name -> {state-per-pod} (the
        router's GET /v1/models aggregates from here, no proxy fan-out)."""
        out: dict[str, dict] = {}
        with self._lock:
            pods = list(self._pods.values())
        for p in pods:
            for name, snap in p.models.items():
                out.setdefault(name, {})[p.url] = snap.get("state")
        return out

    def snapshot(self) -> dict:
        with self._lock:
            pods = {u: p.snapshot() for u, p in self._pods.items()}
        return {
            "pods": pods,
            "polls_total": self.polls_total,
            "poll_failures_total": self.poll_failures_total,
        }
