"""Durable publish outbox (counterpart of ``modelx_tpu/dl/outbox.py``):
derived-artifact publishes survive a registry outage.

``--publish-programs`` and ``--publish-kv`` attach a pod's kernel library
(``dl/program_store.py``) and its hot prefix KV (``dl/kv_store.py``) to the
model version, a write against the registry on the tail of a runtime load
or a publisher sweep. The registry is a soft dependency, so those
publishes ENQUEUE here instead of blocking or failing a load. The outbox is
a bounded on-disk spool (``{seq}.bin`` payload + ``{seq}.json`` meta, the
meta written last so a torn entry is invisible); a background
:class:`Drainer` replays entries through the real publish with exponential
backoff, so bundles built during a brownout land in the registry within
one backoff cycle of recovery, and survive a pod restart in between,
because the spool is just files.

A full spool DROPS the new entry (counted, logged) rather than blocking:
the bundles are an optimization (the next puller builds its kernel or
prefills cold), and the load path must never wait on registry health.
Pure host code: the spool layout, bounds, ordering, per-kind handlers and
backoff are the reference's.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

logger = logging.getLogger("modelx.dl")


class Outbox:
    """Bounded on-disk FIFO of pending publishes.

    One entry = ``{seq:08d}.bin`` (the payload bytes) plus
    ``{seq:08d}.json`` (kind/ref/size/enqueued_at). The meta file commits
    the entry: it is written with temp+rename AFTER the payload, so a
    crash mid-enqueue leaves only an orphan ``.bin`` that the next
    construction sweeps. Entries from a previous process generation are
    picked up as-is — that is the durability the chaos drill asserts."""

    DEFAULT_MAX_ENTRIES = 64
    DEFAULT_MAX_BYTES = 512 * 1024 * 1024

    def __init__(self, root: str, max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES) -> None:
        self.root = root
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self.stats = {"enqueued_total": 0, "drained_total": 0,
                      "drop_full_total": 0, "publish_failures_total": 0,
                      "dropped_unknown_kind_total": 0}
        self._seq = 0
        for seq, meta_path, _bin_path in self._scan():
            self._seq = max(self._seq, seq + 1)
        # sweep orphan payloads (crash between payload write and meta
        # commit) so they don't count against the byte budget forever
        metas = {seq for seq, _m, _b in self._scan()}
        for fn in os.listdir(root):
            if fn.endswith(".bin"):
                try:
                    seq = int(fn[:-4])
                except ValueError:
                    continue
                if seq not in metas:
                    try:
                        os.unlink(os.path.join(root, fn))
                    except OSError as e:
                        logger.warning("outbox orphan sweep %s: %s", fn, e)

    def _scan(self) -> list[tuple[int, str, str]]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".json"):
                continue
            try:
                seq = int(fn[:-5])
            except ValueError:
                continue
            out.append((seq, os.path.join(self.root, fn),
                        os.path.join(self.root, fn[:-5] + ".bin")))
        out.sort()
        return out

    def depth(self) -> int:
        return len(self._scan())

    def pending_bytes(self) -> int:
        total = 0
        for _seq, _meta, bin_path in self._scan():
            try:
                total += os.path.getsize(bin_path)
            except OSError:
                pass
        return total

    def enqueue(self, kind: str, ref: str, data: bytes) -> bool:
        """Spool one publish; False (and a counted drop) when the spool
        is full or the disk refuses the write — never raises, never
        blocks on the registry."""
        # admission + seq reservation under the lock; the disk writes run
        # lock-free (meta-commits-entry keeps them atomic on their own).
        # A concurrent enqueue racing an in-flight write can overshoot the
        # byte budget by at most that one payload — bounded and benign.
        with self._lock:
            if (self.depth() >= self.max_entries
                    or self.pending_bytes() + len(data) > self.max_bytes):
                self.stats["drop_full_total"] += 1
                logger.warning("outbox full (%d entries); dropping %s publish "
                               "for %s", self.depth(), kind, ref)
                return False
            seq = self._seq
            self._seq += 1
        base = os.path.join(self.root, f"{seq:08d}")
        try:
            with open(base + ".bin.tmp", "wb") as f:
                f.write(data)
            os.replace(base + ".bin.tmp", base + ".bin")
            meta = {"kind": kind, "ref": ref, "size": len(data),
                    "enqueued_at": time.time()}
            with open(base + ".json.tmp", "w") as f:
                json.dump(meta, f)
            os.replace(base + ".json.tmp", base + ".json")
        except OSError as e:
            with self._lock:
                self.stats["drop_full_total"] += 1
            logger.warning("outbox spool write failed for %s: %s", ref, e)
            for suffix in (".bin.tmp", ".bin", ".json.tmp"):
                try:
                    os.unlink(base + suffix)
                except OSError:
                    continue  # already gone / never written
            return False
        with self._lock:
            self.stats["enqueued_total"] += 1
        return True

    def peek(self) -> tuple[int, dict, bytes] | None:
        """Oldest pending entry as (seq, meta, payload), or None."""
        for seq, meta_path, bin_path in self._scan():
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                with open(bin_path, "rb") as f:
                    data = f.read()
            except (OSError, ValueError) as e:
                logger.warning("outbox entry %08d unreadable (%s); removing",
                               seq, e)
                self.remove(seq)
                continue
            return seq, meta, data
        return None

    def remove(self, seq: int) -> None:
        base = os.path.join(self.root, f"{seq:08d}")
        for suffix in (".json", ".bin"):
            try:
                os.unlink(base + suffix)
            except OSError:
                continue  # half-removed entries finish disappearing here

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
        out["depth"] = self.depth()
        out["pending_bytes"] = self.pending_bytes()
        return out


class Drainer:
    """Background replay of the outbox through the real publish.

    One entry at a time, oldest first; a failure keeps the entry, counts
    it, and backs off exponentially (capped), so a dead registry costs a
    bounded poll instead of a retry storm. ``kick()`` short-circuits the
    backoff — the lifecycle calls it after every enqueue, and tests call
    it after restarting the registry so the drain lands within one cycle.
    ``sleeper`` injects the wait primitive (``sleeper(event, timeout) ->
    bool``) for sleep-free tests."""

    BACKOFF_S = 0.5
    BACKOFF_CAP_S = 30.0

    # spool entries whose meta carries no kind are program bundles (the
    # only artifact the reference's first outbox shipped): a restart over
    # such a spool drains them through the program publisher
    DEFAULT_KIND = "programs"

    def __init__(self, outbox: Outbox, handler=None, backoff_s: float = BACKOFF_S,
                 backoff_cap_s: float = BACKOFF_CAP_S, recorder=None,
                 sleeper=None) -> None:
        self.outbox = outbox
        self.handler = handler  # (kind, ref, data) -> None; fallback for any kind
        # per-kind dispatch: an entry routes to its kind's registered
        # publisher first, the fallback second
        self.handlers: dict = {}
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.recorder = recorder  # flight recorder (or None)
        self._sleeper = sleeper or threading.Event.wait
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._failures = 0  # consecutive, resets on success
        self.last_error = ""

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="outbox-drainer")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def kick(self) -> None:
        self._wake.set()

    def register_handler(self, kind: str, fn) -> None:
        """Route spool entries of ``kind`` to ``fn(kind, ref, data)``."""
        self.handlers[kind] = fn

    def _record(self, event: str, **fields) -> None:
        rec = self.recorder
        if rec is not None:
            rec.record(event, **fields)

    def drain_once(self) -> bool:
        """Attempt the oldest entry; True when one drained. Public so
        tests (and a synchronous shutdown flush) can drive the drain
        without the thread."""
        item = self.outbox.peek()
        if item is None:
            return False
        seq, meta, data = item
        kind = meta.get("kind") or self.DEFAULT_KIND
        ref = meta.get("ref", "")
        handler = self.handlers.get(kind, self.handler)
        if handler is None:
            # an artifact kind nobody registered must not wedge the FIFO
            # behind it forever: drop it, counted and recorded
            self.outbox.remove(seq)
            with self.outbox._lock:
                self.outbox.stats["dropped_unknown_kind_total"] += 1
            self._record("outbox.dropped_unknown_kind", ref=ref, kind=kind)
            logger.warning("outbox dropping %s entry for %s: no handler "
                           "registered", kind, ref)
            return True
        t0 = time.monotonic()
        try:
            handler(kind, ref, data)
        except Exception as e:
            self._failures += 1
            self.last_error = str(e)
            with self.outbox._lock:
                self.outbox.stats["publish_failures_total"] += 1
                key = f"publish_failures_{kind}_total"
                self.outbox.stats[key] = self.outbox.stats.get(key, 0) + 1
            self._record("outbox.publish_failed", ref=ref, kind=kind,
                         failures=self._failures)
            logger.warning("outbox publish of %s %s failed (attempt %d): %s",
                           kind, ref, self._failures, e)
            return False
        self.outbox.remove(seq)
        self._failures = 0
        self.last_error = ""
        with self.outbox._lock:
            self.outbox.stats["drained_total"] += 1
            key = f"drained_{kind}_total"
            self.outbox.stats[key] = self.outbox.stats.get(key, 0) + 1
        self._record("outbox.drained", ref=ref, kind=kind,
                     depth=self.outbox.depth(), bytes=len(data),
                     seconds=round(time.monotonic() - t0, 6))
        logger.info("outbox drained %s publish for %s (%d pending)",
                    kind, ref, self.outbox.depth())
        return True

    def _delay_s(self) -> float:
        if self._failures <= 0:
            return 0.0
        return min(self.backoff_s * (2 ** (self._failures - 1)),
                   self.backoff_cap_s)

    def _run(self) -> None:
        while not self._stop.is_set():
            drained = self.drain_once()
            if self._stop.is_set():
                return
            if drained and self.outbox.depth() > 0:
                continue  # keep draining a backlog at full speed
            delay = self._delay_s()
            self._wake.clear()
            # idle (empty spool, no failure): park until a kick; failed:
            # wake early on kick, else at the backoff boundary
            self._sleeper(self._wake, delay if delay > 0 else None)

    def snapshot(self) -> dict:
        out = self.outbox.snapshot()
        out["consecutive_failures"] = self._failures
        out["backoff_s"] = round(self._delay_s(), 3)
        if self.last_error:
            out["last_error"] = self.last_error
        out["running"] = self._thread is not None
        return out
