"""Explicit-bucket latency histograms (the ``Histogram`` of
``modelx_tpu/utils/promexp.py``). The continuous engine feeds two of them
per request, queue time and time to first token, and ``snapshot()``
serves their Prometheus-semantics view. The exposition renderer is not
ported yet.
"""

from __future__ import annotations

import math
import threading

DEFAULT_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class Histogram:
    """Fixed explicit-bucket histogram. ``observe()`` is O(buckets) under
    one short lock; ``snapshot()`` returns the Prometheus-semantics view
    (CUMULATIVE bucket counts keyed by upper bound, plus sum and count)
    as a plain dict, so it embeds directly in the JSON snapshot trees."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, buckets=DEFAULT_MS_BUCKETS) -> None:
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._bounds = tuple(bounds)
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        with self._lock:
            self._sum += v
            self._count += 1
            for i, bound in enumerate(self._bounds):
                if v <= bound:
                    self._counts[i] += 1
                    break

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, acc = self._count, self._sum
        buckets: dict[str, int] = {}
        running = 0
        for bound, n in zip(self._bounds, counts):
            running += n
            buckets[f"{bound:g}"] = running
        buckets["+Inf"] = total
        return {"buckets": buckets, "sum": acc, "count": total}
