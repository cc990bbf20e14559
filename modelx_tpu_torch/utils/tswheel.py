"""Per-second rate wheels (a copy of ``modelx_tpu/utils/tswheel.py``'s
``Wheel`` and ``RateSet``; the port imports nothing of the JAX package).

``Wheel.add(n)`` charges ``n`` to the current monotonic second's bucket;
``rate(w)`` sums the buckets of the trailing ``w`` seconds over ``w``. A
bucket older than the span is zeroed when its slot is reused, so an idle
wheel decays to 0 without a thread.
"""

from __future__ import annotations

import threading
import time

# the exported windows: (suffix, seconds)
WINDOWS = (("1m", 60), ("5m", 300))


class Wheel:
    """One counter's ring of 1-second buckets."""

    def __init__(self, span_s: int = 300, _clock=time.monotonic) -> None:
        if span_s < 1:
            raise ValueError("span_s must be >= 1")
        self.span_s = int(span_s)
        # +1 guard slot: the current second never aliases the oldest bucket
        self._size = self.span_s + 1
        self._counts = [0] * self._size
        self._stamps = [-1] * self._size  # the second each slot holds
        self._lock = threading.Lock()
        self._clock = _clock

    def add(self, n: int = 1) -> None:
        now_s = int(self._clock())
        i = now_s % self._size
        with self._lock:
            if self._stamps[i] != now_s:
                self._stamps[i] = now_s
                self._counts[i] = 0
            self._counts[i] += n

    def rate(self, window_s: int) -> float:
        """Events per second over the trailing ``window_s`` seconds."""
        window_s = min(int(window_s), self.span_s)
        if window_s < 1:
            raise ValueError("window_s must be >= 1")
        now_s = int(self._clock())
        lo = now_s - window_s  # buckets in (lo, now_s] count
        with self._lock:
            total = sum(c for c, s in zip(self._counts, self._stamps) if lo < s <= now_s)
        return total / float(window_s)


class RateSet:
    """Named wheels; ``snapshot()`` gives ``{"<name>_per_s_1m": x,
    "<name>_per_s_5m": y}`` per name."""

    def __init__(self, names: tuple[str, ...], span_s: int = 300,
                 _clock=time.monotonic) -> None:
        self._wheels = {n: Wheel(span_s, _clock=_clock) for n in names}

    def mark(self, name: str, n: int = 1) -> None:
        self._wheels[name].add(n)

    def snapshot(self) -> dict:
        return {f"{name}_per_s_{suffix}": round(wheel.rate(secs), 4)
                for name, wheel in self._wheels.items() for suffix, secs in WINDOWS}
