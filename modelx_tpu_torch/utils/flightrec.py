"""Flight recorder: a bounded ring of structured events, and the black-box
dump written when the component that owns it dies (a copy of
``modelx_tpu/utils/flightrec.py``; the port imports nothing of the JAX
package).

Each event is a small dict stamped with a monotonic time ``t``, a sequence
number ``seq`` and, where it applies, a slot and a request id. The model
pool keeps one ring for its tier promotions and demotions, OOM retries and
control-plane transitions, served by ``GET /debug/flightrec`` under
``"pool"`` with the ``?request_id=`` slicing of ``/v1/trace``.
:meth:`FlightRecorder.dump` writes one JSON-lines file: a header line, then
one line per slot state, then the events, oldest first.

Concurrency: appends and reads take one small lock; the critical section
is a list store and two integer bumps.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

__all__ = ["FlightRecorder", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 512

logger = logging.getLogger("modelx.flightrec")


class FlightRecorder:
    """Bounded ring of engine events; oldest entries overwrite silently
    (the drop count is reported, the drops themselves are the point —
    a black box records the END of the flight)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring: list = [None] * self.capacity
        self._seq = 0  # total events ever recorded (monotone)
        self._lock = threading.Lock()

    # -- write side (engine loop / watchdog thread) ------------------------

    def record(self, event: str, slot: int = -1, request_id: str = "",
               **fields) -> None:
        rec = {"t": round(time.monotonic(), 6), "event": event}
        if slot >= 0:
            rec["slot"] = slot
        if request_id:
            rec["request_id"] = request_id
        if fields:
            rec.update(fields)
        with self._lock:
            rec["seq"] = self._seq
            self._ring[self._seq % self.capacity] = rec
            self._seq += 1

    def reset(self) -> None:
        """Fresh flight: a supervised restart's rebuilt engine must not
        replay the dead engine's timeline into its next dump."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._seq = 0

    # -- read side (HTTP handler threads / the dump path) ------------------

    @property
    def total(self) -> int:
        """Events ever recorded this flight (ring drops included)."""
        with self._lock:
            return self._seq

    def events(self, request_id: str | None = None) -> list[dict]:
        """The live ring, oldest first; ``request_id`` slices one
        request's events out of it (the ``/v1/trace`` convention)."""
        with self._lock:
            seq = self._seq
            start = max(0, seq - self.capacity)
            out = [dict(self._ring[i % self.capacity])
                   for i in range(start, seq)]
        if request_id is not None:
            out = [e for e in out if e.get("request_id") == request_id]
        return out

    def summary(self, request_id: str | None = None) -> dict:
        evs = self.events(request_id)
        return {
            "events": evs,
            "recorded_total": self.total,
            "dropped": max(0, self.total - self.capacity),
            "capacity": self.capacity,
        }

    def dump(self, dump_dir: str, reason: str, meta: dict | None = None,
             slots: list | None = None) -> str:
        """Write the black-box file: one header line, one line per slot
        state, then the ring's events oldest first. Returns the path
        ("" when the write failed — the engine is already dying; the
        dump must never add a second failure mode)."""
        snap = self.summary()
        name = "flightrec-%d-%d-%s.jsonl" % (
            os.getpid(), int(time.time() * 1e3), reason.replace(" ", "-"))
        path = os.path.join(dump_dir, name)
        try:
            os.makedirs(dump_dir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                header = {
                    "kind": "flightrec", "reason": reason,
                    "ts": time.time(),
                    "recorded_total": snap["recorded_total"],
                    "dropped": snap["dropped"],
                    "capacity": snap["capacity"],
                }
                if meta:
                    header.update(meta)
                f.write(json.dumps(header) + "\n")
                for s in slots or ():
                    f.write(json.dumps({"kind": "slot", **s}) + "\n")
                for e in snap["events"]:
                    f.write(json.dumps({"kind": "event", **e}) + "\n")
        except OSError:
            logger.exception("flight-recorder dump to %s failed", path)
            return ""
        return path
