"""Runtime lock-order checking ("lockdep"): TSan-lite for the port.

The AST lint proves lexical discipline; it cannot see DYNAMIC ordering —
thread A taking ``pool._lock`` then ``sset._servers_lock`` while thread B
takes them in the other order deadlocks only under the right interleaving,
which a test suite hits once a quarter and production hits on the worst
day of the year. On the card the stakes are higher: ``ModelServer._device_lock``
serializes every launch, so a hold there stalls every model's traffic.
This module makes ordering observable every run:

- :class:`LockGraph` records, per thread, which locks are held when a new
  one is acquired, building a global lock-order graph keyed by each
  lock's ALLOCATION SITE (file:line — the "lock class", as in the kernel's
  lockdep). A new edge that closes a cycle is a potential deadlock and is
  reported with both acquisition stacks.
- It also reports holds exceeding a threshold (``MODELX_LOCKDEP_HOLD_MS``,
  default 200 ms) with the acquire and release stacks — the dynamic twin
  of the ``blocking-under-lock`` lint rule.
- :func:`install` monkeypatches ``threading.Lock``/``threading.RLock`` so
  every lock allocated AFTER install is instrumented (queue.Queue,
  concurrent.futures, and all of modelx_tpu_torch included). It is
  env-gated: ``MODELX_LOCKDEP=1`` (see
  :mod:`modelx_tpu_torch.analysis.pytest_lockdep`); when the env is unset
  nothing is patched and the overhead is zero.

Self-edges between DIFFERENT instances from the same allocation site
(e.g. two per-repo index locks) are ignored — same-site nesting is the
``_index_locks`` pattern and only an actual same-instance non-reentrant
re-acquire would deadlock, which hangs rather than needing a report.

Tests can build a private :class:`LockGraph` and wrap locks explicitly
with :func:`make_lock`/:func:`make_rlock` — the inversion drill asserts a
cycle on its own graph without failing the suite's global gate.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from _thread import allocate_lock as _raw_lock

ENV_VAR = "MODELX_LOCKDEP"
ENV_HOLD_MS = "MODELX_LOCKDEP_HOLD_MS"
DEFAULT_HOLD_MS = 200.0
_STACK_DEPTH = 16

# frames from these files are instrumentation noise, not user code
_SELF_FILES = (os.sep + "lockdep.py", os.sep + "threading.py")


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0")


def _capture_stack(skip: int = 2) -> tuple:
    """Cheap stack snapshot: (filename, lineno, funcname) tuples, innermost
    last, instrumentation frames dropped."""
    frames = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    depth = 0
    while f is not None and depth < _STACK_DEPTH:
        fn = f.f_code.co_filename
        if not any(fn.endswith(s) for s in _SELF_FILES):
            frames.append((fn, f.f_lineno, f.f_code.co_name))
        f = f.f_back
        depth += 1
    frames.reverse()
    return tuple(frames)


def _format_stack(stack) -> str:
    if not stack:
        return "    <no stack captured>"
    return "\n".join(f'    File "{fn}", line {ln}, in {name}'
                     for fn, ln, name in stack)


def _alloc_site(skip: int = 2) -> str:
    """file:line of the frame that allocated the lock, skipping
    instrumentation and threading internals (a lock allocated inside
    queue.Queue.__init__ is labeled by queue.py — that IS its class)."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "<unknown>"
    while f is not None:
        fn = f.f_code.co_filename
        if not any(fn.endswith(s) for s in _SELF_FILES):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class CycleReport:
    """A potential deadlock: acquiring ``site_b`` while holding ``site_a``
    closed a cycle in the global order graph."""

    def __init__(self, path_sites: list[str], held_stack, acquire_stack,
                 thread_name: str) -> None:
        self.path_sites = path_sites  # the cycle, as allocation sites
        self.held_stack = held_stack
        self.acquire_stack = acquire_stack
        self.thread_name = thread_name

    def render(self) -> str:
        arrows = " -> ".join(self.path_sites + [self.path_sites[0]])
        return (
            f"potential deadlock (lock-order cycle) in thread "
            f"{self.thread_name!r}:\n  cycle: {arrows}\n"
            f"  earlier lock acquired at:\n{_format_stack(self.held_stack)}\n"
            f"  cycle-closing acquire at:\n{_format_stack(self.acquire_stack)}"
        )


class HoldReport:
    """One lock held past the threshold, with both stacks."""

    def __init__(self, site: str, duration_s: float, acquire_stack,
                 release_stack, thread_name: str) -> None:
        self.site = site
        self.duration_s = duration_s
        self.acquire_stack = acquire_stack
        self.release_stack = release_stack
        self.thread_name = thread_name

    def render(self) -> str:
        return (
            f"lock {self.site} held {self.duration_s * 1e3:.1f} ms in thread "
            f"{self.thread_name!r}\n  acquired at:\n"
            f"{_format_stack(self.acquire_stack)}\n  released at:\n"
            f"{_format_stack(self.release_stack)}"
        )


class LockGraph:
    """The global lock-order graph + per-thread held stacks.

    Internal state is guarded by a RAW ``_thread`` lock (never itself
    instrumented). Nodes are allocation sites; edges carry the first-seen
    stack pair for reporting."""

    def __init__(self, hold_threshold_ms: float | None = None) -> None:
        if hold_threshold_ms is None:
            hold_threshold_ms = float(
                os.environ.get(ENV_HOLD_MS, "") or DEFAULT_HOLD_MS)
        self.hold_threshold_s = hold_threshold_ms / 1e3
        self._mu = _raw_lock()
        self._tls = threading.local()
        # site -> set(site): "while holding KEY, VALUE was acquired"
        self._edges: dict[str, set[str]] = {}
        self._cycles: list[CycleReport] = []
        self._holds: dict[str, HoldReport] = {}  # site -> worst hold
        self._hold_counts: dict[str, int] = {}  # site -> over-threshold holds
        self._sites: set[str] = set()  # every lock class acquired at least once
        self._seen_cycles: set[frozenset] = set()
        self.acquisitions = 0

    # -- per-thread held stack -------------------------------------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- instrumentation callbacks --------------------------------------------

    def note_acquired(self, lock: "_LockdepBase") -> None:
        held = self._held()
        stack = _capture_stack(skip=3)
        now = time.monotonic()
        with self._mu:
            self.acquisitions += 1
            self._sites.add(lock.site)
            for prev_lock, _t0, prev_stack in held:
                if prev_lock is lock:
                    continue
                self._add_edge(prev_lock, prev_stack, lock, stack)
        held.append((lock, now, stack))

    def note_released(self, lock: "_LockdepBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                _l, t0, acq_stack = held.pop(i)
                dur = time.monotonic() - t0
                if dur >= self.hold_threshold_s:
                    self._record_hold(lock, dur, acq_stack)
                return

    def _record_hold(self, lock, dur: float, acq_stack) -> None:
        rel_stack = _capture_stack(skip=4)
        with self._mu:
            self._hold_counts[lock.site] = self._hold_counts.get(lock.site, 0) + 1
            worst = self._holds.get(lock.site)
            if worst is None or dur > worst.duration_s:
                self._holds[lock.site] = HoldReport(
                    lock.site, dur, acq_stack, rel_stack,
                    threading.current_thread().name)

    def _add_edge(self, prev_lock, prev_stack, lock, stack) -> None:
        """Caller holds self._mu. Add prev.site -> lock.site; if the
        reverse direction is already reachable, report the cycle once per
        site set."""
        a, b = prev_lock.site, lock.site
        if a == b:
            # same allocation site: only a true same-instance re-acquire
            # deadlocks (and that hangs outright); different instances are
            # the per-repo-lock pattern — not an ordering violation
            return
        succ = self._edges.setdefault(a, set())
        if b in succ:
            return
        succ.add(b)
        path = self._find_path(b, a)
        if path is not None:
            key = frozenset(path)
            if key not in self._seen_cycles:
                self._seen_cycles.add(key)
                self._cycles.append(CycleReport(
                    path, prev_stack, stack,
                    threading.current_thread().name))

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS src -> dst over the edge set; returns the node path
        [dst, ..., src] reordered to start at dst (the cycle), or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- reporting -------------------------------------------------------------

    @property
    def cycles(self) -> list[CycleReport]:
        with self._mu:
            return list(self._cycles)

    @property
    def long_holds(self) -> list[HoldReport]:
        with self._mu:
            return sorted(self._holds.values(),
                          key=lambda h: -h.duration_s)

    @property
    def classes(self) -> set[str]:
        """Every lock class (allocation site) acquired at least once."""
        with self._mu:
            return set(self._sites)

    def edges(self) -> dict[str, set[str]]:
        """The order graph: site -> sites acquired while holding it."""
        with self._mu:
            return {a: set(b) for a, b in self._edges.items()}

    def hold_counts(self) -> dict[str, int]:
        """Site -> how many of its holds passed the threshold."""
        with self._mu:
            return dict(self._hold_counts)

    def render_report(self) -> str:
        cycles, holds = self.cycles, self.long_holds
        if not cycles and not holds:
            return (f"lockdep: clean — {self.acquisitions} nested "
                    "acquisitions, no order cycles, no over-threshold holds")
        parts = [f"lockdep: {len(cycles)} cycle(s), {len(holds)} "
                 f"over-threshold hold(s) "
                 f"(threshold {self.hold_threshold_s * 1e3:.0f} ms)"]
        parts.extend(c.render() for c in cycles)
        parts.extend(h.render() for h in holds)
        return "\n\n".join(parts)


# -- instrumented lock types ----------------------------------------------------


class _LockdepBase:
    """Shared acquire/release bookkeeping around an inner primitive."""

    __slots__ = ("_inner", "_graph", "site")

    def __init__(self, inner, graph: LockGraph, site: str) -> None:
        self._inner = inner
        self._graph = graph
        self.site = site

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # concurrent.futures.thread registers this with os.register_at_fork
        # at import time; the child's held-state is per-thread TLS and
        # starts empty there anyway
        self._inner._at_fork_reinit()

    def __getattr__(self, name: str):
        # delegate anything else (stdlib internals poke at lock attrs);
        # acquire/release stay on the wrappers so bookkeeping never skips
        if name in ("_inner", "_graph", "site"):
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<lockdep {type(self).__name__} @ {self.site} wrapping {self._inner!r}>"


class InstrumentedLock(_LockdepBase):
    __slots__ = ()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.note_acquired(self)
        return got

    def release(self) -> None:
        self._graph.note_released(self)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedRLock(_LockdepBase):
    """Reentrant: only the outermost acquire/release touch the graph.
    Provides ``_release_save``/``_acquire_restore``/``_is_owned`` so
    ``threading.Condition`` treats it exactly like a real RLock (wait()
    fully releases — the graph sees that as a release, correctly)."""

    __slots__ = ("_depth",)

    def __init__(self, inner, graph: LockGraph, site: str) -> None:
        super().__init__(inner, graph, site)
        self._depth = 0  # mutated only while the inner lock is held

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._depth += 1
            if self._depth == 1:
                self._graph.note_acquired(self)
        return got

    def release(self) -> None:
        if self._depth == 1:
            self._graph.note_released(self)
        self._depth -= 1
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol ------------------------------------------------------

    def _release_save(self):
        self._graph.note_released(self)
        depth = self._depth
        self._depth = 0
        return depth, self._inner._release_save()

    def _acquire_restore(self, state) -> None:
        depth, inner_state = state
        self._inner._acquire_restore(inner_state)
        self._depth = depth
        self._graph.note_acquired(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


# -- global graph + monkeypatch install ----------------------------------------

_global_graph: LockGraph | None = None
_saved: dict | None = None


def global_graph() -> LockGraph | None:
    return _global_graph


def make_lock(graph: LockGraph, site: str = "") -> InstrumentedLock:
    return InstrumentedLock(_raw_lock(), graph,
                            site or _alloc_site(skip=2))


def make_rlock(graph: LockGraph, site: str = "") -> InstrumentedRLock:
    import _thread

    return InstrumentedRLock(_thread.RLock(), graph,
                             site or _alloc_site(skip=2))


def install(graph: LockGraph | None = None) -> LockGraph:
    """Patch ``threading.Lock``/``threading.RLock`` so every lock
    allocated from now on reports into ``graph`` (a fresh one by
    default). Idempotent; :func:`uninstall` restores the originals.
    Locks created BEFORE install stay raw — install early (the pytest
    plugin does it at configure time)."""
    global _global_graph, _saved
    if _saved is not None:
        return _global_graph  # already installed
    import _thread

    g = graph or LockGraph()
    _global_graph = g
    real_lock = threading.Lock
    real_rlock = threading.RLock
    _saved = {"Lock": real_lock, "RLock": real_rlock}

    def patched_lock():
        return InstrumentedLock(_thread.allocate_lock(), g, _alloc_site(skip=2))

    def patched_rlock():
        return InstrumentedRLock(_thread.RLock(), g, _alloc_site(skip=2))

    threading.Lock = patched_lock
    threading.RLock = patched_rlock
    _saved["patched"] = (patched_lock, patched_rlock)
    return g


def owns_factories() -> bool:
    """Are ``threading.Lock``/``RLock`` this module's patched factories?
    False when not installed, or when another instrumentation patched them
    again after :func:`install` (its locks would bypass this graph)."""
    if _saved is None:
        return False
    return (threading.Lock, threading.RLock) == _saved["patched"]


def uninstall() -> None:
    """Restore the real lock factories. Already-created instrumented
    locks keep working (their graph just stops growing new allocation
    sites)."""
    global _saved
    if _saved is None:
        return
    threading.Lock = _saved["Lock"]
    threading.RLock = _saved["RLock"]
    _saved = None


def install_from_env() -> LockGraph | None:
    """The production gate: install iff ``MODELX_LOCKDEP=1``."""
    if enabled():
        return install()
    return None
