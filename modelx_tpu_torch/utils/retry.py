"""Shared exponential-backoff + ``Retry-After`` retry policy (counterpart of
``modelx_tpu/utils/retry.py``, with the same schedules on the same clocks):

- exponential backoff with decorrelating jitter: ``backoff_s * 2^attempt``
  plus ``uniform(0, delay/2)``: a fleet of sidecars retrying the same
  endpoint must not re-collide;
- a server ``Retry-After`` wins when LONGER than the computed backoff,
  capped so a hostile or buggy header can't park the caller for minutes;
- only the numeric-seconds form of ``Retry-After`` is honored: the
  HTTP-date form (or garbage) keeps the backoff.

Standard library only.
"""

from __future__ import annotations

import random
import threading
import time


def parse_retry_after(value: str | None, cap_s: float) -> float | None:
    """Seconds a ``Retry-After`` header asks for, capped; None for the
    HTTP-date form, garbage, or a missing header (caller keeps its own
    backoff). Negative values clamp to 0 (retry now, but still a valid
    server hint)."""
    if not value:
        return None
    try:
        return min(max(float(value), 0.0), cap_s)
    except ValueError:
        return None  # HTTP-date form (or garbage): keep the backoff


class RetryPolicy:
    """One retry stance: how many attempts, how long between them.

    ``delay_s`` is pure arithmetic + jitter (unit-testable without
    sleeping); ``sleep`` applies it. ``attempts`` iterates attempt
    indices so call sites keep the familiar ``for attempt in
    policy.attempts()`` shape with ``policy.last(attempt)`` telling them
    when to stop swallowing errors.
    """

    def __init__(self, retries: int = 3, backoff_s: float = 0.2,
                 retry_after_cap_s: float = 5.0,
                 sleep=time.sleep, rng=random.uniform) -> None:
        self.retries = max(1, int(retries))
        self.backoff_s = float(backoff_s)
        self.retry_after_cap_s = float(retry_after_cap_s)
        self._sleep = sleep
        self._rng = rng

    def attempts(self) -> range:
        return range(self.retries)

    def last(self, attempt: int) -> bool:
        return attempt >= self.retries - 1

    def delay_s(self, attempt: int, retry_after: str | None = None) -> float:
        """Backoff before the attempt AFTER ``attempt`` (0-based):
        exponential with jitter; a longer (numeric, capped) server
        ``Retry-After`` wins."""
        delay = self.backoff_s * (2 ** attempt)
        delay += self._rng(0.0, delay / 2)  # jitter
        hinted = parse_retry_after(retry_after, self.retry_after_cap_s)
        if hinted is not None:
            delay = max(delay, hinted)
        return delay

    def sleep(self, attempt: int, retry_after: str | None = None) -> None:
        self._sleep(self.delay_s(attempt, retry_after))


def retriable_status(status: int) -> bool:
    """The transient-server-trouble statuses every retry loop in the tree
    agrees on: 5xx and 429. 4xx below 429 is deterministic (auth /
    not-found / validation) and never retried."""
    return status >= 500 or status == 429


class EndpointRotation:
    """Sticky preference order over equivalent endpoints (a primary plus
    read mirrors). ``order()`` yields indices starting from the
    last endpoint that worked — after a failover the client keeps talking
    to the live mirror instead of re-timing-out on the dead primary every
    request — and ``mark_good`` moves the start. Thread-safe: the serving
    pull path and the outbox drainer share one client."""

    def __init__(self, count: int) -> None:
        self.count = max(1, int(count))
        self._start = 0
        self._lock = threading.Lock()

    def order(self) -> list[int]:
        with self._lock:
            start = self._start
        return [(start + i) % self.count for i in range(self.count)]

    def mark_good(self, index: int) -> None:
        if 0 <= index < self.count:
            with self._lock:
                self._start = index

    @property
    def preferred(self) -> int:
        with self._lock:
            return self._start


def hedged_call(calls, hedge_delay_s: float, *, on_loser=None, wait=None):
    """First-success-wins hedging over equivalent fetches (ranged blob
    GETs against a primary + mirrors). ``calls[0]`` starts
    immediately; each later call launches only once ``hedge_delay_s``
    passes with no winner (a healthy primary never costs the mirror a
    byte) or an earlier call FAILS (fail-fast failover).

    Returns ``(index, result)`` of the winner; any LOSER that completes
    late gets ``on_loser(result)`` so the caller can close its response.
    When every call fails, the first error (launch order) raises.
    ``wait`` overrides the delay primitive (``wait(event, timeout) ->
    bool``) so tests drive the hedge arithmetic without sleeping."""
    calls = list(calls)
    if not calls:
        raise ValueError("hedged_call needs at least one call")
    if wait is None:
        wait = threading.Event.wait
    tick = threading.Event()  # set on EVERY completion, success or failure
    lock = threading.Lock()
    results: list = []    # (index, value) in completion order
    failures: dict = {}   # index -> exc

    def run(i: int, fn) -> None:
        try:
            value = fn()
        except Exception as e:
            with lock:
                failures[i] = e
            tick.set()
            return
        with lock:
            results.append((i, value))
            late = len(results) > 1
        tick.set()
        if late and on_loser is not None:
            on_loser(value)

    launched = 0

    def launch() -> None:
        nonlocal launched
        i = launched
        launched += 1
        threading.Thread(target=run, args=(i, calls[i]), daemon=True,
                         name=f"hedge-{i}").start()

    launch()
    while True:
        with lock:
            if results:
                return results[0]
            if len(failures) >= launched and launched >= len(calls):
                raise failures[min(failures)]
            # every launched call already failed: hedge NOW, not at the
            # delay — waiting out a dead primary's timer helps nobody
            hedge_now = len(failures) >= launched
            tick.clear()  # inside the lock: completions after this set it
        if launched < len(calls):
            if hedge_now or not wait(tick, hedge_delay_s):
                launch()
        else:
            wait(tick, None)  # all legs in flight: wait for completions
