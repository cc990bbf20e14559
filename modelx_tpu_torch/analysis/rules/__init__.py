"""Rule registry + shared AST helpers for the port's lint.

Each rule module registers callables with :func:`register`; a rule is
``rule(ctx: ModuleContext) -> Iterable[Finding]`` with a ``rule_id``
attribute. The ids are stable (baseline entries reference them):

- ``blocking-under-lock``  network/file I/O, sleeps, waits on the card
  (``.item()``, ``.cpu()``, ``torch.cuda.synchronize`` ...), future
  waits, or subprocesses while holding a lock
- ``lock-leak``            ``acquire()`` not pinned by try/finally
- ``untyped-handler-error`` raise reaching an HTTP handler that is not a
  typed serving/registry error
- ``bare-thread``          ``threading.Thread`` without a daemon flag or
  a supervised join
- ``swallowed-exception``  silent ``except: pass`` on server paths
- ``capture-impurity``     wall-clock/RNG calls inside functions that
  ``torch.compile``, CUDA graph capture or ``torch.jit`` freeze when
  they capture them
"""

from __future__ import annotations

import ast
import re

_REGISTRY: list = []


def register(rule_id: str, doc: str):
    """Decorator: register ``fn`` as a lint rule under ``rule_id``."""

    def deco(fn):
        fn.rule_id = rule_id
        fn.rule_doc = doc
        _REGISTRY.append(fn)
        return fn

    return deco


def all_rules() -> list:
    _load()
    return list(_REGISTRY)


def rule_catalog() -> dict[str, str]:
    _load()
    return {r.rule_id: r.rule_doc for r in _REGISTRY}


_loaded = False


def _load() -> None:
    global _loaded
    if _loaded:
        return
    # import for registration side effects
    from modelx_tpu_torch.analysis.rules import handlers, locks, purity, threads  # noqa: F401

    _loaded = True


# -- shared AST helpers ---------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of an expression: ``time.sleep`` for
    ``time.sleep(...)``, ``.result`` for ``fut.result`` (unknown
    receiver), ``open`` for a bare name."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        if base and not base.startswith("."):
            return f"{base}.{node.attr}"
        return f".{node.attr}"
    if isinstance(node, ast.Call):
        return dotted_name(node.func)
    return ""


def terminal_name(node: ast.AST) -> str:
    """The last path component of an expression: ``_lock`` for
    ``self._lock``, ``lock`` for ``lock``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return terminal_name(node.func)
    return ""


_LOCK_NAME_RE = re.compile(r"(^|_)(lock|locks|rlock|mutex|mtx|cv|cond|guard)s?($|_)",
                           re.IGNORECASE)


def lock_named(name: str) -> bool:
    return bool(name) and bool(_LOCK_NAME_RE.search(name))


_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
    # lockdep's instrumented wrappers are locks too
    "lockdep.Lock", "lockdep.RLock",
}


def module_lock_names(tree: ast.Module) -> set[str]:
    """Names/attributes assigned from ``threading.Lock()`` & co anywhere
    in the module — catches locks whose names don't look lock-ish
    (``self._profiling = threading.Lock()``)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Call)
                and dotted_name(node.value.func) in _LOCK_FACTORIES):
            continue
        for tgt in node.targets:
            t = terminal_name(tgt)
            if t:
                names.add(t)
    return names


def is_lock_expr(node: ast.AST, known_locks: set[str]) -> bool:
    """Heuristic: does this with-item / receiver look like a lock? Either
    its terminal name matches the lock-naming convention, it was assigned
    from a lock factory in this module, or it's a ``_repo_lock(...)``-style
    accessor call whose name says lock."""
    t = terminal_name(node)
    return lock_named(t) or t in known_locks


def body_nodes_outside_nested_defs(stmts) -> list[ast.AST]:
    """Every node lexically inside ``stmts`` that actually EXECUTES there:
    nested function/class bodies are skipped (they run later, not under
    the enclosing with/lock), but their decorators/defaults do execute."""
    out: list[ast.AST] = []
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(node.args.defaults)
            stack.extend(d for d in (node.args.kw_defaults or []) if d is not None)
            continue
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.ClassDef):
            stack.extend(node.decorator_list)
            stack.extend(node.bases)
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out
