"""Router admission control: per-client fairness, retry budgets, breakers
(counterpart of ``modelx_tpu/router/admission.py``).

The front door (router/server.py) faithfully *relays* backpressure — a
pod's 429/503 propagates verbatim, Retry-After included — but before this
module it did nothing to *shape* it: one greedy client could monopolize
every pod's queue slots FIFO-by-arrival, a fleet-wide brownout turned
every request into N failover attempts (retry amplification exactly when
the fleet is weakest), and a pod answering 5xx bursts kept receiving
routes because only *connection* death quarantines. This module is the
overload-protection layer, pure policy with no HTTP so every decision is
unit-testable:

- :class:`TokenBucket` — the rate primitive (per-client ceilings and the
  retry budget both draw from it);
- :class:`AdmissionController` — per-client token buckets plus a
  weighted fair-share scheduler (start-time fair queueing over a bounded
  backlog): under saturation each *active* client converges to its fair
  share of the router's upstream slots instead of whoever arrived
  hardest; shed decisions carry a Retry-After computed from the observed
  drain rate, and ``batch``-priority work sheds first;
- :class:`RetryBudget` — Finagle-style: first attempts deposit a ratio,
  failover attempts withdraw 1, so a brownout degrades to ~one upstream
  attempt per request instead of N (no retry storms);
- :class:`BreakerBoard` — per-pod circuit breaker over *non-connection*
  upstream failures (5xx bursts), with half-open probe recovery: the gap
  between "connection death => quarantine" and "read timeout => never
  quarantine".

Every knob defaults to 0 = observe-only: accounting runs (per-client
admit/shed counters, would-open breaker counts land in /metrics) but no
request is ever queued, shed, or skipped — current behavior preserved
until an operator turns a knob.
"""

from __future__ import annotations

import math
import threading
import time

# the header contract lives in serving_errors (the shared dependency-free
# wire-contract module) so the router and pod halves cannot drift apart;
# re-exported here because this module is the router-side API for it
from modelx_tpu_torch.dl.serving_errors import (  # noqa: F401  (re-exports)
    CLIENT_HEADER,
    DEADLINE_HEADER,
    PRIORITY_BATCH,
    PRIORITY_HEADER,
    PRIORITY_INTERACTIVE,
    DeadlineExceededError,
    QueueFullError,
    client_identity,
    parse_deadline_ms,
    parse_priority,
)

# WFQ stride weights: an interactive grant advances its client's virtual
# pass 1/4 as far as a batch grant, so interactive work gets ~4x the
# share when both classes contend (and batch still progresses — weighted
# fairness, not starvation)
_CLASS_WEIGHT = {PRIORITY_INTERACTIVE: 4.0, PRIORITY_BATCH: 1.0}


def client_key(headers, client_address) -> str:
    """The fairness identity of a request: API token, else the explicit
    ``X-ModelX-Client`` header, else source IP — first available. Tokens
    are hashed before they become a metrics key: /metrics must never leak
    a bearer credential. The canonical implementation lives in
    serving_errors (``client_identity``) — both access
    logs and this fairness key must bucket a caller identically."""
    return client_identity(headers, client_address)


def jain_index(values) -> float | None:
    """Jain's fairness index over per-client goodput: 1.0 = perfectly
    equal shares, 1/n = one client has everything. None when there is
    nothing to compare."""
    vals = [float(v) for v in values if v is not None]
    if not vals or not any(vals):
        return None
    sq = sum(v * v for v in vals)
    return round((sum(vals) ** 2) / (len(vals) * sq), 4) if sq else None


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill toward ``burst``
    capacity; ``take`` is all-or-nothing. ``rate <= 0`` disables the
    bucket (every take succeeds) so knobs can default to observe-only.
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, rate: float, burst: float = 0.0,
                 clock=time.monotonic) -> None:
        self.rate = float(rate)
        # capacity floors at one whole token: a sub-1.0 burst (e.g. rate
        # 0.25 with burst 2x = 0.5) could otherwise never satisfy
        # take(1.0) and would shed every request forever
        self.capacity = max(1.0, float(burst)) if burst > 0 \
            else max(1.0, self.rate)
        self._tokens = self.capacity
        self._clock = clock
        self._t = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        if now > self._t:
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._t) * self.rate)
        self._t = now

    def take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def wait_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (the Retry-After
        a rate-shed response should carry); 0 when takeable now."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            self._refill(self._clock())
            missing = n - self._tokens
            return max(0.0, missing / self.rate)

    def level(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens


class RetryBudget:
    """Finagle-style retry budget: every *first* upstream attempt
    deposits ``ratio`` tokens, every retry (failover attempt beyond the
    first) withdraws one. Sustained retries are therefore bounded to
    ``ratio`` of recent request volume — a fleet-wide brownout degrades
    to ~one upstream attempt per request instead of candidates x
    requests. ``reserve`` seeds the bucket so low-traffic routers can
    still fail over; ``ratio <= 0`` disables (unlimited retries, the
    pre-admission behavior)."""

    def __init__(self, ratio: float = 0.0, reserve: float = 10.0,
                 cap: float = 1000.0) -> None:
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._tokens = min(float(reserve), self.cap)
        self._lock = threading.Lock()
        self.requests_total = 0
        self.retries_allowed = 0
        self.retries_denied = 0

    @property
    def enabled(self) -> bool:
        return self.ratio > 0

    def record_attempt(self) -> None:
        """A logical request's FIRST upstream attempt: deposit."""
        with self._lock:
            self.requests_total += 1
            if self.enabled:
                self._tokens = min(self.cap, self._tokens + self.ratio)

    def allow_retry(self) -> bool:
        """May this request make one MORE upstream attempt?"""
        with self._lock:
            if not self.enabled:
                self.retries_allowed += 1
                return True
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.retries_allowed += 1
                return True
            self.retries_denied += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "ratio": self.ratio,
                "tokens": round(self._tokens, 2),
                "requests_total": self.requests_total,
                "retries_allowed": self.retries_allowed,
                "retries_denied": self.retries_denied,
            }


class BreakerBoard:
    """Per-pod circuit breakers over non-connection upstream failures.

    Connection death already quarantines a pod immediately (registry
    semantics), and a read timeout deliberately never does (a slow query
    must not cascade into sticky-cache loss) — but a pod answering a
    *burst of 5xx* kept receiving routes. The breaker fills that gap:

    - CLOSED: ``threshold`` consecutive failures -> OPEN (skip the pod);
    - OPEN: after ``cooldown_s`` -> HALF-OPEN, exactly one probe request
      is allowed through;
    - HALF-OPEN: probe success -> CLOSED, probe failure -> OPEN again.

    ``threshold <= 0`` = observe-only: ``allow`` never blocks, but
    consecutive-failure accounting still runs and ``would_open`` counts
    what an enabled breaker would have done (the operator's dry run).
    Backpressure (429/503) is a pod working CORRECTLY under load — the
    caller records those as successes, not failures."""

    OBSERVE_THRESHOLD = 5  # would_open accounting when disabled

    def __init__(self, threshold: int = 0, cooldown_s: float = 10.0,
                 clock=time.monotonic) -> None:
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        # url -> {fails, state, open_until, probing, opens, would_open}
        self._pods: dict[str, dict] = {}

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def _entry(self, url: str) -> dict:
        e = self._pods.get(url)
        if e is None:
            e = self._pods[url] = {"fails": 0, "state": "closed",
                                   "open_until": 0.0, "probing": 0.0,
                                   "opens": 0, "would_open": 0}
        return e

    def allow(self, url: str) -> bool:
        """Data-path gate: may a request be dispatched to this pod?"""
        if not self.enabled:
            return True
        with self._lock:
            e = self._entry(url)
            if e["state"] == "closed":
                return True
            now = self._clock()
            if e["state"] == "open":
                if now < e["open_until"]:
                    return False
                e["state"] = "half-open"
                e["probing"] = 0.0
            # half-open: one probe in flight at a time. The probe slot is
            # a LEASE, not a flag — a caller that took it but never
            # dispatched (its deadline or retry budget ran out first)
            # must not wedge the pod in half-open forever
            if e["probing"] and now - e["probing"] < self.cooldown_s:
                return False
            e["probing"] = now
            return True

    def record(self, url: str, ok: bool) -> None:
        """Outcome of one dispatched attempt (ok = the pod answered
        something other than an unexpected 5xx)."""
        with self._lock:
            e = self._entry(url)
            if e["state"] == "half-open":
                e["probing"] = 0.0
                if ok:
                    e["state"] = "closed"
                    e["fails"] = 0
                else:
                    e["state"] = "open"
                    e["open_until"] = self._clock() + self.cooldown_s
                    e["opens"] += 1
                return
            if ok:
                e["fails"] = 0
                return
            e["fails"] += 1
            limit = self.threshold if self.enabled else self.OBSERVE_THRESHOLD
            if e["fails"] >= limit:
                if self.enabled:
                    e["state"] = "open"
                    e["open_until"] = self._clock() + self.cooldown_s
                    e["opens"] += 1
                else:
                    e["would_open"] += 1
                e["fails"] = 0

    def forget(self, url: str) -> None:
        """The pod just got quarantined (connection death): the registry
        owns its recovery now — a stale OPEN state must not outlive the
        quarantine and block the pod's first routed request back."""
        with self._lock:
            self._pods.pop(url, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "threshold": self.threshold,
                "pods": {
                    u: {"state": e["state"], "consecutive_failures": e["fails"],
                        "opens": e["opens"], "would_open": e["would_open"]}
                    for u, e in self._pods.items()
                },
            }


class _Client:
    """One fairness identity's live state."""

    __slots__ = ("key", "bucket", "inflight", "vpass", "admitted", "shed",
                 "waiting", "last_seen")

    def __init__(self, key: str, rate: float, burst: float, clock) -> None:
        self.key = key
        self.bucket = TokenBucket(rate, burst, clock=clock)
        self.inflight = 0
        self.vpass = 0.0       # WFQ virtual pass (stride scheduling)
        self.admitted = 0
        self.shed = 0
        self.waiting: list = []  # FIFO _Waiter queue for this client
        self.last_seen = 0.0

    def active(self) -> bool:
        return self.inflight > 0 or bool(self.waiting)


class _Waiter:
    """One queued request; flags flipped under the controller lock."""

    __slots__ = ("client", "priority", "granted", "evicted")

    def __init__(self, client: _Client, priority: str) -> None:
        self.client = client
        self.priority = priority
        self.granted = False
        self.evicted = False


class AdmissionController:
    """Per-client fair admission over the router's upstream capacity.

    Three gates, in order:

    1. **per-client rate** (``client_rate`` req/s, burst 2x): a hard
       ceiling per fairness identity, shed immediately with Retry-After
       from the bucket's refill time;
    2. **fair share** (``fair_share`` concurrent upstream slots): below
       the limit with nobody queued, admit inline. At the limit, the
       request joins a bounded backlog and a weighted fair scheduler
       (start-time fair queueing: grant the waiting client with the
       smallest virtual pass; each grant advances the grantee's pass by
       1/weight) hands out freed slots — so each active client converges
       to its weighted share of slots no matter how hard another client
       arrives. ``interactive`` outweighs ``batch`` 4:1;
    3. **bounded backlog** (``max_router_backlog`` waiters): a full
       backlog sheds — batch first: an arriving interactive request
       evicts the newest queued batch waiter instead of being shed
       itself; failing that, the newest waiter of the most-backlogged
       other client is displaced when the arrival holds fewer waiters
       than its share (a 10-thread client must not own the whole
       backlog and shed everyone else at the door). Shed responses are
       the typed 429 with ``Retry-After`` computed from the *observed
       drain rate* (completions/s EWMA), so the number is the fleet's
       honest catch-up estimate, not a constant.

    ``fair_share <= 0`` disables gates 2-3, ``client_rate <= 0`` gate 1;
    with everything 0 (the default) ``acquire`` only does accounting.

    Waiters block on a Condition bound to the controller lock; grants are
    targeted (flags on the waiter object) so a wake-up storm can't
    reorder the scheduler's decisions.
    """

    MAX_CLIENTS = 1024  # fairness table bound: idle identities LRU out

    def __init__(self, fair_share: int = 0, client_rate: float = 0.0,
                 max_backlog: int = 0, clock=time.monotonic) -> None:
        self.fair_share = int(fair_share)
        self.client_rate = float(client_rate)
        self.max_backlog = int(max_backlog)
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._clients: dict[str, _Client] = {}
        self._inflight_total = 0
        self._backlog = 0
        self._vtime = 0.0
        # drain-rate EWMA (completions/s) -> honest Retry-After on sheds
        self._last_done = 0.0
        self._drain_rate = 0.0
        self.admitted_total = 0
        self.shed_total = 0
        self.shed_by_class = {PRIORITY_INTERACTIVE: 0, PRIORITY_BATCH: 0}
        self.evicted_batch_total = 0
        self.expired_total = 0  # queued deadlines that ran out (504s)

    @property
    def enabled(self) -> bool:
        return self.fair_share > 0 or self.client_rate > 0

    # -- bookkeeping (all under self._lock) -----------------------------------

    def _client(self, key: str) -> _Client:
        c = self._clients.get(key)
        if c is None:
            if len(self._clients) >= self.MAX_CLIENTS:
                idle = [k for k, v in self._clients.items() if not v.active()]
                idle.sort(key=lambda k: self._clients[k].last_seen)
                for k in idle[: max(1, len(idle) // 4)]:
                    del self._clients[k]
            c = self._clients[key] = _Client(
                key, self.client_rate, 2 * self.client_rate, self._clock
            )
        c.last_seen = self._clock()
        return c

    def _retry_after(self) -> int:
        """Backlog length over observed drain rate, clamped to [1, 60] —
        "come back when the queue you'd join should have drained"."""
        rate = max(self._drain_rate, 0.2)
        return max(1, min(60, math.ceil((self._backlog + 1) / rate)))

    def _shed_error(self, retry_after: int | None = None,
                    message: str | None = None) -> QueueFullError:
        return QueueFullError(
            self._backlog, self.max_backlog or self.fair_share,
            retry_after=retry_after if retry_after is not None
            else self._retry_after(),
            message=message,
        )

    def _shed(self, c: _Client, priority: str, retry_after: int | None = None,
              message: str | None = None):
        c.shed += 1
        self.shed_total += 1
        self.shed_by_class[priority] = self.shed_by_class.get(priority, 0) + 1
        return self._shed_error(retry_after, message)

    def _charge(self, c: _Client, priority: str) -> None:
        """WFQ grant accounting: advance virtual time to the grantee's
        start tag, then push the grantee's pass one stride ahead."""
        self._vtime = max(self._vtime, c.vpass)
        c.vpass = max(c.vpass, self._vtime) + 1.0 / _CLASS_WEIGHT[priority]
        c.inflight += 1
        c.admitted += 1
        self._inflight_total += 1
        self.admitted_total += 1

    def _grant_next(self) -> None:
        """Hand freed slots to waiters: smallest virtual pass wins, FIFO
        within a client. Called with the lock held."""
        granted = False
        while self._inflight_total < self.fair_share:
            contenders = [c for c in self._clients.values() if c.waiting]
            if not contenders:
                break
            c = min(contenders, key=lambda cl: (cl.vpass, cl.key))
            w = c.waiting.pop(0)
            self._backlog -= 1
            w.granted = True
            self._charge(c, w.priority)
            granted = True
        if granted:
            self._cond.notify_all()

    def _evict_waiter(self, c: _Client, i: int) -> None:
        w = c.waiting.pop(i)
        w.evicted = True
        self._backlog -= 1
        c.shed += 1
        self.shed_total += 1
        self.shed_by_class[w.priority] = (
            self.shed_by_class.get(w.priority, 0) + 1)
        if w.priority == PRIORITY_BATCH:
            self.evicted_batch_total += 1
        self._cond.notify_all()

    def _evict_newest_batch(self) -> bool:
        """Backlog full, interactive arriving: shed batch first. The
        victim is the most-served client's (largest virtual pass) newest
        batch waiter — evicting the least-served client's oldest would
        starve batch work that is nearly due."""
        newest: tuple[float, _Client, int] | None = None
        for c in self._clients.values():
            for i in range(len(c.waiting) - 1, -1, -1):
                if c.waiting[i].priority == PRIORITY_BATCH:
                    cand = (c.vpass, c, i)
                    if newest is None or cand[0] > newest[0]:
                        newest = cand
                    break
        if newest is None:
            return False
        _, c, i = newest
        self._evict_waiter(c, i)
        return True

    def _displace_for(self, c: _Client, priority: str) -> bool:
        """Full backlog: make room for a DESERVING arrival instead of
        shedding it. Batch waiters go first; failing that, the newest
        waiter of the most-backlogged OTHER client is displaced when it
        holds strictly more than the arrival's share — otherwise one
        client's thread count would own the whole backlog and everyone
        else would shed at the door (the FIFO monopoly this module
        exists to break, reappearing one layer up). A batch arrival
        never displaces interactive work."""
        if self._evict_newest_batch():
            return True
        if priority == PRIORITY_BATCH:
            return False
        heaviest = None
        for cl in self._clients.values():
            if cl is not c and cl.waiting:
                if heaviest is None or (
                    (len(cl.waiting), cl.vpass)
                    > (len(heaviest.waiting), heaviest.vpass)
                ):
                    heaviest = cl
        if heaviest is None or len(heaviest.waiting) <= len(c.waiting) + 1:
            return False  # the arrival already holds its share
        self._evict_waiter(heaviest, len(heaviest.waiting) - 1)
        return True

    # -- the data-path surface ------------------------------------------------

    def admit(self, key: str, priority: str = PRIORITY_INTERACTIVE,
              deadline: float | None = None,
              budget_s: float | None = None) -> None:
        """Admit one request for ``key`` or raise a typed error: the 429
        for overload sheds (rate ceiling, full backlog, eviction), the
        504 when the caller's OWN deadline expires while queued — the
        same status the routing loop would answer a moment later, so
        clients keying retry behavior on 429-vs-504 see one semantic
        (``budget_s`` is only the number that 504 names). Blocks
        (bounded by ``deadline``, a monotonic stamp) while the fair
        scheduler holds the request in the backlog. Every return path
        that does NOT raise must be paired with ``release``. (Named
        ``admit``, not ``acquire``: a shed RAISES instead of returning,
        so this is an admission decision, not a mutex protocol.)"""
        with self._cond:
            c = self._client(key)
            if self.client_rate > 0 and not c.bucket.take():
                # the per-client ceiling: Retry-After from the bucket's
                # own refill clock, not the global drain estimate — and
                # a message naming the ceiling, not a backlog that may
                # not even be enabled
                raise self._shed(
                    c, priority,
                    retry_after=max(1, math.ceil(c.bucket.wait_s())),
                    message=f"client request rate exceeds the ceiling "
                            f"({self.client_rate:g}/s); retry later",
                )
            if self.fair_share <= 0:
                # observe-only: account, never queue or shed
                c.inflight += 1
                c.admitted += 1
                self._inflight_total += 1
                self.admitted_total += 1
                return
            if self._inflight_total < self.fair_share and self._backlog == 0:
                self._charge(c, priority)
                return
            if self.max_backlog > 0 and self._backlog >= self.max_backlog:
                # shed batch first, then displace the most-backlogged
                # client's newest waiter for an under-share arrival —
                # the backlog bound is shared fairly, not
                # first-come-keeps-it
                if not self._displace_for(c, priority):
                    raise self._shed(c, priority)
            w = _Waiter(c, priority)
            if not c.active():
                # (re)activating client: joins at the current virtual
                # time — history earns no banked burst, idleness no debt
                c.vpass = max(c.vpass, self._vtime)
            c.waiting.append(w)
            self._backlog += 1
            self._grant_next()  # a slot may already be free
            while not w.granted and not w.evicted:
                timeout = None
                if deadline is not None:
                    timeout = deadline - self._clock()
                    if timeout <= 0:
                        break
                self._cond.wait(timeout=timeout)
            if w.granted:
                return
            if w.evicted:
                # the eviction already did the shed accounting
                raise self._shed_error()
            # the caller's deadline ran out while queued: withdraw (the
            # lock is held from wait-return to here, so the waiter is
            # still queued — no grant can race the removal) and answer
            # the DEADLINE error, not an overload shed: the budget
            # expired, exactly as it would have in the routing loop
            c.waiting.remove(w)
            self._backlog -= 1
            self.expired_total += 1
            raise DeadlineExceededError("queued for admission",
                                        budget_s or 0.0)

    def release(self, key: str) -> None:
        """One admitted request finished (any outcome): free its slot,
        feed the drain-rate estimate, and grant the next waiter."""
        with self._cond:
            c = self._clients.get(key)
            if c is not None and c.inflight > 0:
                c.inflight -= 1
            self._inflight_total = max(0, self._inflight_total - 1)
            now = self._clock()
            if self._last_done > 0 and now > self._last_done:
                inst = 1.0 / (now - self._last_done)
                self._drain_rate = (
                    inst if self._drain_rate <= 0
                    else 0.8 * self._drain_rate + 0.2 * inst
                )
            self._last_done = now
            if self.fair_share > 0:
                self._grant_next()

    def snapshot(self) -> dict:
        with self._lock:
            total_inflight = max(1, self._inflight_total)
            clients = {
                c.key: {
                    "admitted": c.admitted,
                    "shed": c.shed,
                    "inflight": c.inflight,
                    "waiting": len(c.waiting),
                    "occupancy_share": round(c.inflight / total_inflight, 4),
                }
                for c in self._clients.values()
                if c.admitted or c.shed or c.active()
            }
            return {
                "enabled": self.enabled,
                "fair_share": self.fair_share,
                "client_rate": self.client_rate,
                "max_backlog": self.max_backlog,
                "inflight": self._inflight_total,
                "backlog": self._backlog,
                "drain_rate_per_s": round(self._drain_rate, 3),
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "shed_by_class": dict(self.shed_by_class),
                "evicted_batch_total": self.evicted_batch_total,
                "expired_total": self.expired_total,
                "clients": clients,
            }
