"""Lock-discipline rules: blocking-under-lock and lock-leak.

The invariants these enforce are the port's (and the reference's):

- "heavy teardown runs OUTSIDE the pool lock" (dl/lifecycle.py
  ``_finish_free``), "one tenant's teardown must not stall admission";
- "the engine loop never sleeps holding ``_close_lock``";
- nothing waits on the card while it holds a lock other threads need:
  a ``.item()`` or ``.cpu()`` under a lock holds it for as long as the
  stream's queued work takes;
- every manual ``acquire()`` is released on every path, including the
  exception ones.

``blocking-under-lock`` flags calls that block on the network, disk,
the card, a future, a subprocess, or the wall clock while a lock is
lexically held (a ``with <lock>:`` body, or a ``try`` immediately
following a bare ``x.acquire()``). The card's waits are torch's
host-device syncs: ``torch.cuda.synchronize()``, ``.synchronize()`` on a
stream or event, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
and a ``.to(...)`` that copies onto the host (a ``"cpu"`` device, or an
explicit ``non_blocking=False``); a ``.to(dtype)`` cast does not wait.
``Condition.wait`` is exempt — it releases the lock while waiting.
Nested ``def``/``lambda`` bodies are exempt — they run later, not under
the lock.

``lock-leak`` flags statement-form ``x.acquire()`` whose release is not
pinned by a ``finally`` in the same function.
"""

from __future__ import annotations

import ast

from modelx_tpu_torch.analysis.rules import (
    body_nodes_outside_nested_defs,
    dotted_name,
    is_lock_expr,
    module_lock_names,
    register,
    terminal_name,
)

# dotted-name prefixes/exacts that block. ``.name`` entries match any
# receiver (attribute calls); bare entries match exact dotted paths.
_BLOCKING_EXACT = {
    "time.sleep",
    "open", "os.replace", "os.rename", "os.renames", "os.unlink", "os.remove",
    "os.stat", "os.lstat", "os.listdir", "os.scandir", "os.makedirs",
    "os.mkdir", "os.rmdir", "os.removedirs", "os.fsync", "os.ftruncate",
    "os.truncate", "os.pwrite", "os.pread", "os.utime", "os.kill",
    "os.path.getsize", "os.path.getmtime", "os.path.exists", "os.path.isfile",
    "os.path.isdir",
    "shutil.rmtree", "shutil.copy", "shutil.copy2", "shutil.copyfile",
    "shutil.copytree", "shutil.move",
    # torch's host-device syncs: the host waits for the card's queue
    "torch.cuda.synchronize",
    "socket.create_connection",
}
# the port's own blocking I/O, called bare or on any receiver: the native
# engine's reads and hashes (native/__init__.py: pread_fd, pread_scatter,
# sha256_file, NativeHTTPConnection.get_range) and the registry client's
# one request (client/remote.py send_request), each a file or socket wait
_PORT_IO = {"pread_fd", "pread_scatter", "sha256_file", "get_range", "send_request"}
_BLOCKING_PREFIX = (
    "requests.", "urllib.", "subprocess.", "http.client.",
)
_BLOCKING_METHOD = {
    # attribute calls on any receiver
    "result",            # Future.result() — waits for another thread
    "urlopen",
    # torch: each reads a value the card computes, so the host waits for
    # every launch queued before it on the stream
    "synchronize",       # torch.cuda.Stream/Event.synchronize()
    "item",
    "tolist",
    "cpu",
    "numpy",
} | _PORT_IO
_TO_HOST_DEVICES = {"cpu"}
# the registry's FSProvider seam (registry/fs.py): `self.fs.put(...)` is
# local-disk OR S3/GCS network I/O depending on deployment — under a lock
# it must be a deliberate, documented serialization (baseline it), never
# an accident
_PROVIDER_RECEIVER = "fs"
_PROVIDER_METHODS = {"put", "get", "stat", "remove", "exists", "list"}

# methods that look blocking but must NOT count
_EXEMPT_METHOD = {
    "wait",       # Condition.wait / Event.wait: Condition RELEASES the lock;
                  # Event.wait under a lock would still be a hazard, but the
                  # repo convention is Conditions — keep the rule precise
    "notify", "notify_all",
}

_RULE_BLOCK = "blocking-under-lock"
_RULE_LEAK = "lock-leak"


def _is_blocking_call(call: ast.Call) -> str | None:
    """The matched blocking-name, or None."""
    name = dotted_name(call.func)
    if not name:
        return None
    if name in _BLOCKING_EXACT or name in _PORT_IO:
        return name
    for p in _BLOCKING_PREFIX:
        if name.startswith(p):
            return name
    if isinstance(call.func, ast.Attribute):
        meth = call.func.attr
        if meth in _EXEMPT_METHOD:
            return None
        if meth in _BLOCKING_METHOD:
            return name
        if meth == "to" and _to_blocks(call):
            return name
        if (meth in _PROVIDER_METHODS
                and terminal_name(call.func.value) == _PROVIDER_RECEIVER):
            return name
    return None


def _is_host_device(node: ast.AST) -> bool:
    """``"cpu"``, ``"cpu:0"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":", 1)[0] in _TO_HOST_DEVICES
    if isinstance(node, ast.Call) and dotted_name(node.func) in ("torch.device", "device"):
        return bool(node.args) and _is_host_device(node.args[0])
    return False


def _to_blocks(call: ast.Call) -> bool:
    """Does this ``.to(...)`` wait for the card? A copy onto the host does
    (unless ``non_blocking=True``), and so does any ``.to`` that spells out
    ``non_blocking=False``: the copy leaves the card before the host goes
    on. A dtype cast (``.to(torch.float32)``, ``.to(dtype=...)``) stays on
    its device and queues like any other launch; a ``.to(device)`` whose
    device is a name is not decided here."""
    nb = next((kw.value for kw in call.keywords if kw.arg == "non_blocking"), None)
    if isinstance(nb, ast.Constant) and nb.value is False:
        return True
    if isinstance(nb, ast.Constant) and nb.value is True:
        return False
    targets = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(_is_host_device(t) for t in targets)


def _held_regions(ctx, known_locks):
    """Yield (lock_label, stmts, witness_node) for every lexical region
    that runs with a lock held."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.With):
            lock_items = [i.context_expr for i in node.items
                          if is_lock_expr(i.context_expr, known_locks)]
            if lock_items:
                yield dotted_name(lock_items[0]) or terminal_name(lock_items[0]), node.body, node
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # bare `x.acquire()` statement followed by a try whose finally
            # releases: the try body is the held region
            yield from _manual_regions(node, known_locks)


def _manual_regions(fn, known_locks):
    for stmts in _stmt_blocks(fn):
        for i, stmt in enumerate(stmts):
            recv = _acquire_receiver(stmt)
            if recv is None:
                # conditional probe: `if not x.acquire(blocking=False): ...`
                # followed by the pinned try — the try body holds the lock
                recv = _conditional_acquire_receiver(stmt)
            if recv is None or not is_lock_expr(recv, known_locks):
                continue
            if i + 1 < len(stmts) and isinstance(stmts[i + 1], ast.Try):
                yield dotted_name(recv) or terminal_name(recv), stmts[i + 1].body, stmts[i + 1]


def _stmt_blocks(fn):
    """Every statement list inside ``fn`` (body, orelse, finalbody, ...),
    not descending into nested defs."""
    blocks = [fn.body]
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(node, attr, None)
            if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                blocks.append(sub)
                stack.extend(sub)
        for h in getattr(node, "handlers", []) or []:
            blocks.append(h.body)
            stack.extend(h.body)
    return blocks


def _acquire_receiver(stmt):
    """The receiver expr of a statement-form ``x.acquire(...)``, else None."""
    if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == "acquire"):
        return stmt.value.func.value
    return None


def _conditional_acquire_receiver(stmt):
    """The receiver of an ``.acquire(...)`` appearing in an If test (the
    non-blocking probe shape: ``if not x.acquire(blocking=False):``)."""
    if not isinstance(stmt, ast.If):
        return None
    for n in ast.walk(stmt.test):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "acquire"):
            return n.func.value
    return None


@register(_RULE_BLOCK, "network/file I/O, sleeps, waits on the card (.item(), "
                       ".cpu(), synchronize ...), future waits, or subprocesses "
                       "while holding a lock")
def blocking_under_lock(ctx):
    known_locks = module_lock_names(ctx.tree)
    findings = []
    seen = set()
    for label, stmts, _witness in _held_regions(ctx, known_locks):
        for node in body_nodes_outside_nested_defs(stmts):
            # a nested `with <other lock>` region is reported once, for
            # the innermost lock it blocks under — dedup on position
            if not isinstance(node, ast.Call):
                continue
            matched = _is_blocking_call(node)
            if matched is None:
                continue
            pos = (node.lineno, node.col_offset)
            if pos in seen:
                continue
            seen.add(pos)
            findings.append(ctx.finding(
                _RULE_BLOCK, node,
                f"{matched}() while holding {label!r}",
                hint="move the blocking call outside the lock (collect work "
                     "under the lock, perform it after release — see "
                     "ModelPool._free_entry_locked/_finish_free for the "
                     "split pattern; a read of the card's result can wait "
                     "past the release, the stream keeps its order)",
            ))
    return findings


@register(_RULE_LEAK, "acquire() not pinned by try/finally")
def lock_leak(ctx):
    findings = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for stmts in _stmt_blocks(node):
            for i, stmt in enumerate(stmts):
                recv = _acquire_receiver(stmt)
                if recv is None:
                    continue
                if _release_pinned(ctx, stmts, i, stmt, recv):
                    continue
                label = dotted_name(recv) or terminal_name(recv)
                findings.append(ctx.finding(
                    _RULE_LEAK, stmt,
                    f"{label}.acquire() is not pinned by try/finally",
                    hint="follow acquire() immediately with `try: ... "
                         f"finally: {label}.release()` (or use `with "
                         f"{label}:`) so an exception cannot leak the lock",
                ))
    return findings


def _release_pinned(ctx, stmts, i, stmt, recv) -> bool:
    """Is the acquire at stmts[i] released in a finally? Accepts the
    canonical shape (next statement is a Try with release in finalbody)
    and the acquire-inside-a-try-whose-finally-releases shape."""
    target = ast.dump(recv)

    def releases(block) -> bool:
        for s in block:
            for n in ast.walk(s):
                if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "release"
                        and ast.dump(n.func.value) == target):
                    return True
        return False

    nxt = stmts[i + 1] if i + 1 < len(stmts) else None
    if isinstance(nxt, ast.Try) and releases(nxt.finalbody):
        return True
    for anc in ctx.ancestors(stmt):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        if isinstance(anc, ast.Try) and releases(anc.finalbody):
            return True
    return False
