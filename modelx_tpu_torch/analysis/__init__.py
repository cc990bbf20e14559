"""The port's static analysis + runtime lock-order checking.

The port's serving path (the sidecar, the continuous engine, the model
pool, the tiers, the outbox, the router, the registry) rests on locking
and error-typing invariants that are easy to state and easy to break:
"heavy teardown runs outside the pool lock", "every handler error is
typed", "acquire is always pinned by try/finally", "nothing waits on the
card while it holds a lock other threads need". This package turns them
into machine checks.

Two halves:

- **AST lint** (`lint.py` + `rules/`): ``python -m
  modelx_tpu_torch.analysis`` walks the tree and enforces six rules
  (blocking-under-lock, lock-leak, untyped-handler-error, bare-thread,
  swallowed-exception, capture-impurity). blocking-under-lock knows
  torch's host-device syncs (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()``, a ``.to()`` onto the host) beside
  file, network, sleep and future waits. Findings carry ``file:line``, a
  rule id and a fix hint; ``baseline.toml`` suppresses individually vetted
  sites (justification required) so only NEW violations fail the gate.

- **Runtime lockdep** (`lockdep.py` + `pytest_lockdep.py`): an
  instrumented Lock/RLock (env-gated ``MODELX_LOCKDEP=1``, zero overhead
  when off) that records per-thread acquisition order into a global
  lock-order graph, reports cycles (potential deadlocks) and
  over-threshold holds with both stacks, and rides the port's chaos
  sweeps as a pytest plugin (``-p modelx_tpu_torch.analysis.pytest_lockdep``).
"""

from modelx_tpu_torch.analysis.lint import Finding, analyze_paths, main  # noqa: F401
