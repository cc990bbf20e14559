"""bare-thread: every ``threading.Thread`` must declare its lifecycle.

A thread created without ``daemon=`` and without a supervised ``join()``
is an orphan: it outlives the work that spawned it, keeps the process
alive on shutdown, and its crashes vanish. The repo's convention (engine
supervisor, drain workers, GC cron) is ``daemon=True`` plus either a
supervising loop or an explicit join on the paths that must complete.
"""

from __future__ import annotations

import ast

from modelx_tpu_torch.analysis.rules import dotted_name, register

_RULE = "bare-thread"
_THREAD_NAMES = {"threading.Thread", "Thread"}


@register(_RULE, "threading.Thread without a daemon flag or supervised join")
def bare_thread(ctx):
    findings = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and dotted_name(node.func) in _THREAD_NAMES):
            continue
        if any(kw.arg == "daemon" for kw in node.keywords):
            continue
        if _joined_nearby(ctx, node):
            continue
        findings.append(ctx.finding(
            _RULE, node,
            "Thread() without a daemon flag or a join in the same function",
            hint="pass daemon=True (supervised/cron threads) or keep a "
                 "reference and join() it on the owning path; an undeclared "
                 "thread leaks past shutdown and hides its crashes",
        ))
    return findings


def _joined_nearby(ctx, call: ast.Call) -> bool:
    """``t = Thread(...)`` ... ``t.join()`` in the same function (or the
    Thread expression is chained ``.start()``/``.join()`` directly)."""
    fn = ctx.enclosing_function(call)
    if fn is None:
        return False
    # name the thread is assigned to, if any
    parent = ctx.parents.get(call)
    names = set()
    if isinstance(parent, ast.Assign):
        for tgt in parent.targets:
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
    elif isinstance(parent, ast.Attribute):
        # self._thread = ... handled via the attribute name
        pass
    if isinstance(parent, ast.Assign) and not names:
        for tgt in parent.targets:
            if isinstance(tgt, ast.Attribute):
                names.add(tgt.attr)
    if not names:
        return False
    for n in ast.walk(fn):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"):
            recv = n.func.value
            t = recv.id if isinstance(recv, ast.Name) else (
                recv.attr if isinstance(recv, ast.Attribute) else "")
            if t in names:
                return True
    return False
