"""Structured spans and the device profiler window (counterpart of
``modelx_tpu/utils/trace.py``).

A process-local collector of closed spans. ``span()`` is a context manager;
nesting is tracked per thread or task with a contextvar, so span names
compose into paths (``serve.request/serve.forward``). A span records host
time only: it never synchronizes the device, so a span around work the
card runs asynchronously closes when the host has enqueued it.

    with trace.span("dl.load", uri=uri):
        with trace.span("fetch", tensor=name):
            ...

Every closed span is logged at DEBUG (or INFO with MODELX_TRACE=1), kept in
a bounded ring for ``trace.spans()`` / ``trace.export_json()``, and served
by the sidecar's ``/v1/trace``. A request id bound with
``request_context`` stamps every span closed inside it.

``torch_profile()`` is the device-level window behind ``/v1/profile`` and
``/admin/profile``: ``torch.profiler`` with CPU activity, and CUDA activity
(CUPTI) when the process holds a CUDA device, written as a Chrome trace.
The profiler's CUPTI subscription outlives the window unless kineto is
told to tear it down (``TEARDOWN_CUPTI=1``): on an H100 every later kernel
launch of the process then cost 1.24-1.42x as much
(``scripts/torch_profiler_overhead.py``), and the port's decode is bound by
launches. So a window sets ``TEARDOWN_CUPTI=1`` unless the operator set it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import inspect
import json
import logging
import os
import threading
import time
from typing import Any, Iterator

logger = logging.getLogger("modelx.trace")

MAX_SPANS = 8192

_current_path: contextvars.ContextVar[str] = contextvars.ContextVar("modelx_span_path", default="")

# the request id rides a contextvar beside the span path: every span closed
# while a request context is active carries it, so /v1/trace can filter one
# request's timeline out of the ring
_current_request: contextvars.ContextVar[str] = contextvars.ContextVar(
    "modelx_request_id", default="")


def current_request_id() -> str:
    """The request id bound to this thread/task context ("" when none)."""
    return _current_request.get()


@contextlib.contextmanager
def request_context(request_id: str) -> Iterator[None]:
    """Bind a request id for the duration of a block: every span closed
    inside (across nested calls, same thread/task) is stamped with it."""
    token = _current_request.set(str(request_id or ""))
    try:
        yield
    finally:
        _current_request.reset(token)


class Tracer:
    """Collects closed spans in a bounded ring; drop count is tracked."""

    def __init__(self, max_spans: int = MAX_SPANS) -> None:
        self._lock = threading.Lock()
        self._spans: collections.deque[dict[str, Any]] = collections.deque(maxlen=max_spans)
        self._dropped = 0
        self.max_spans = max_spans

    def record(self, span: dict[str, Any]) -> None:
        with self._lock:
            if len(self._spans) == self.max_spans:
                self._dropped += 1  # deque(maxlen) evicts the oldest in O(1)
            self._spans.append(span)
        level = logging.INFO if os.environ.get("MODELX_TRACE") else logging.DEBUG
        if logger.isEnabledFor(level):
            logger.log(level, "span %s %.1fms %s", span["path"], span["duration_s"] * 1e3,
                       {k: v for k, v in span.items()
                        if k not in ("path", "start_s", "duration_s")})

    def spans(self, prefix: str = "", request_id: str = "") -> list[dict[str, Any]]:
        # one O(n) copy under the lock, filtering outside it: concurrent
        # record() calls never wait on a caller's aggregation
        with self._lock:
            out = list(self._spans)
        if prefix:
            out = [s for s in out if s["path"].startswith(prefix)]
        if request_id:
            out = [s for s in out if s.get("request_id") == request_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.spans(), f, indent=1)

    def summary(self, prefix: str = "", request_id: str = "") -> dict[str, dict[str, float]]:
        """Per-path aggregate: count / total_s / max_s (for /v1/trace,
        optionally filtered to one request id), over a snapshot copy of
        the ring."""
        agg: dict[str, dict[str, float]] = {}
        for s in self.spans(prefix, request_id):
            a = agg.setdefault(s["path"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += s["duration_s"]
            a["max_s"] = max(a["max_s"], s["duration_s"])
        return agg


_tracer = Tracer()


def tracer() -> Tracer:
    return _tracer


def spans(prefix: str = "") -> list[dict[str, Any]]:
    return _tracer.spans(prefix)


def export_json(path: str) -> None:
    _tracer.export_json(path)


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[dict[str, Any]]:
    """Time a block on the host's clock; the yielded dict accepts extra
    attrs while open."""
    parent = _current_path.get()
    path = f"{parent}/{name}" if parent else name
    token = _current_path.set(path)
    rec: dict[str, Any] = dict(attrs)
    start = time.monotonic()
    try:
        yield rec
    except BaseException as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _current_path.reset(token)
        rec["path"] = path
        rec["start_s"] = start
        rec["duration_s"] = time.monotonic() - start
        rid = _current_request.get()
        if rid:
            rec["request_id"] = rid
        _tracer.record(rec)


def traced(name: str):
    """Decorator form of :func:`span`. A generator function keeps its span
    open across the whole iteration (a plain ``with span`` would close it
    at the first yield, before any work ran)."""

    def deco(fn):
        if inspect.isgeneratorfunction(fn):

            @functools.wraps(fn)
            def genwrapper(*args, **kwargs):
                with span(name):
                    yield from fn(*args, **kwargs)

            return genwrapper

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


TRACE_FILE = "trace.json"
# set while a torch_profile window records (the profiler's own enabled
# flag is per thread, and the window records every thread's kernels)
_profiling = threading.Event()


def profile_active() -> bool:
    """Whether a ``torch_profile`` window is recording now."""
    return _profiling.is_set()


@contextlib.contextmanager
def torch_profile(trace_dir: str) -> Iterator[None]:
    """Device-level profiling window: ``torch.profiler`` over the block,
    with CPU activity and, when this process holds a CUDA device, CUDA
    activity (CUPTI: every kernel on the card, whichever thread launched
    it). The Chrome trace lands in ``trace_dir/trace.json``. A profiler
    that cannot start or stop logs a warning and the block runs anyway:
    profiling never takes the service down."""
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
            # kineto reads it when the window stops: without it CUPTI stays
            # subscribed and slows every later launch of the pod
            os.environ.setdefault("TEARDOWN_CUPTI", "1")
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
        _profiling.set()
    except Exception as e:
        logger.warning("torch profiler unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            _profiling.clear()
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
            except Exception as e:
                logger.warning("torch profiler stop failed: %s", e)
