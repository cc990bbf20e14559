"""Opt-in structured access logs (counterpart of
``modelx_tpu/utils/accesslog.py``): one JSON object per line.

The serving pod takes ``--access-log PATH`` and writes one line per
completed POST with the end-to-end request id, the attempt, the hashed
client identity, the model, the final status, the wall time and the
per-phase timing breakdown. JSON lines, because the consumers are ``jq``
and log shippers; the request id joins the line to the pod's spans.

The writer is small: append mode, line-buffered, one lock around the
write so concurrent handler threads never interleave bytes mid-line. A
write failure (disk full, path gone) disables the log and logs one
warning: observability never takes the serving path down.

Rotation: ``--access-log-max-bytes`` caps the file. When a write pushes
the size past the cap the file renames to ``<path>.1`` (one generation;
the previous ``.1`` is overwritten) and a fresh file opens, under the same
write lock so no line is torn across the swap. 0 (the default) appends
forever.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any

logger = logging.getLogger("modelx.accesslog")


class AccessLog:
    """Thread-safe JSON-lines access log writer."""

    def __init__(self, path: str, max_bytes: int = 0) -> None:
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1, encoding="utf-8")
        self._size = self._fh.tell()  # append mode: tell() is the size
        self._broken = False

    def _rotate_locked(self) -> None:
        """Rename to ``.1`` and reopen; caller holds the lock. A rotation
        failure disables the log like any other write failure."""
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a", buffering=1, encoding="utf-8")
        self._size = 0

    def write(self, **fields: Any) -> None:
        """Append one log line; ``ts`` (unix seconds) is stamped here so
        every producer's lines sort on the same clock."""
        rec = {"ts": round(time.time(), 3)}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=str) + "\n"
        except (TypeError, ValueError) as e:
            logger.warning("unserializable access-log record dropped: %s", e)
            return
        with self._lock:
            if self._broken:
                return
            try:
                self._fh.write(line)
                self._size += len(line.encode("utf-8"))
                if 0 < self.max_bytes <= self._size:
                    self._rotate_locked()
            except OSError as e:
                # one warning, then silence: a full disk must not turn
                # every request into a logging error
                self._broken = True
                logger.warning("access log %s failed, disabling: %s",
                               self.path, e)

    def close(self) -> None:
        with self._lock:
            self._broken = True
            try:
                self._fh.close()
            except OSError as e:
                logger.warning("access log close failed: %s", e)


def open_log(path: str | None, max_bytes: int = 0) -> AccessLog | None:
    """``--access-log`` plumbing: None/"" disables (the default);
    ``max_bytes`` > 0 enables size-capped rotation."""
    return AccessLog(path, max_bytes=max_bytes) if path else None
