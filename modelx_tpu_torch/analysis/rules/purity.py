"""capture-impurity: wall-clock / RNG calls inside captured functions.

The port's counterpart of the reference's ``jax-impurity``. A
``time.time()`` or ``random.random()`` inside a function that torch
captures does not do what it reads like: it runs ONCE, while the function
is captured, and the value is baked into what replays:

- ``torch.compile`` traces the function with dynamo; a host clock or a
  Python RNG draw becomes a constant of the compiled graph (or a graph
  break on every call);
- a CUDA graph (``torch.cuda.graph``, ``torch.cuda.make_graphed_callables``)
  records the launches of one run; every replay reuses the host values
  of that run;
- ``torch.jit.script`` / ``torch.jit.trace`` freeze a traced call's host
  values the same way.

Detection is the reference's shape: the rule collects every name that
flows into one of those capture entry points in a module — a call
(``torch.compile(self._step_impl, ...)``), a decorator (``@torch.compile``,
``@torch.compile(mode=...)``, ``@partial(torch.compile, ...)``), a
``functools.partial`` target, or the body of a ``with torch.cuda.graph(g):``
block — and scans those function bodies, nested defs included, for
``time.*`` clock reads, stdlib/numpy ``random``, ``datetime`` now/utcnow and
``uuid4``. ``torch.rand*``/``torch.randn`` with a ``generator`` are fine:
they are device RNG the capture replays with fresh state (the port's
sampler threads its own key through ``ops/prng.py``).
"""

from __future__ import annotations

import ast

from modelx_tpu_torch.analysis.rules import dotted_name, register

_RULE = "capture-impurity"

_IMPURE_EXACT = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "time.monotonic_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "uuid.uuid4",
}
_IMPURE_RANDOM_BASES = {"random", "np.random", "numpy.random"}

# entry points that capture the function handed to them
_CAPTURE_NAMES = {
    "torch.compile",
    "torch.jit.script", "torch.jit.trace", "jit.script", "jit.trace",
    "torch.cuda.make_graphed_callables", "make_graphed_callables",
}
# context managers whose body is recorded into a CUDA graph
_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}


def _is_capture(name: str) -> bool:
    return name in _CAPTURE_NAMES


def _captured_function_names(tree: ast.Module) -> set[str]:
    """Bare names of functions that flow into a capture in this module:
    ``torch.compile(fn, ...)``, ``torch.compile(self._impl, ...)``,
    ``@torch.compile``, ``@torch.compile(...)``, ``@partial(torch.compile,
    ...)``, ``partial(torch.compile, ...)(fn)``, and the functions called
    inside a ``with torch.cuda.graph(...):`` block."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if _is_capture(fname) and node.args:
                _add_target(names, node.args[0])
            # partial(torch.compile, ...)(fn)
            if (isinstance(node.func, ast.Call)
                    and dotted_name(node.func.func).endswith("partial")
                    and node.func.args and _is_capture(dotted_name(node.func.args[0]))
                    and node.args):
                _add_target(names, node.args[0])
            # make_graphed_callables((fn1, fn2), ...) takes a tuple too
            if fname.endswith("make_graphed_callables") and node.args and isinstance(
                    node.args[0], (ast.Tuple, ast.List)):
                for elt in node.args[0].elts:
                    _add_target(names, elt)
        if isinstance(node, ast.With) and any(
                isinstance(i.context_expr, ast.Call)
                and dotted_name(i.context_expr.func) in _GRAPH_CONTEXTS
                for i in node.items):
            for inner in ast.walk(ast.Module(body=node.body, type_ignores=[])):
                if isinstance(inner, ast.Call):
                    _add_target(names, inner.func)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = dotted_name(dec)
                if _is_capture(d):
                    names.add(node.name)
                elif isinstance(dec, ast.Call) and _is_capture(dotted_name(dec.func)):
                    names.add(node.name)
                elif (isinstance(dec, ast.Call)
                      and dotted_name(dec.func).endswith("partial")
                      and dec.args and _is_capture(dotted_name(dec.args[0]))):
                    names.add(node.name)
    return names


def _add_target(names: set[str], target: ast.AST) -> None:
    tail = dotted_name(target).rsplit(".", 1)[-1]
    if tail:
        names.add(tail)


def _impure_call(call: ast.Call) -> str | None:
    name = dotted_name(call.func)
    if name in _IMPURE_EXACT:
        return name
    if isinstance(call.func, ast.Attribute):
        base = dotted_name(call.func.value)
        if base in _IMPURE_RANDOM_BASES:
            return name
    return None


@register(_RULE, "wall-clock/RNG calls inside functions torch.compile, CUDA "
                 "graph capture or torch.jit capture (frozen at capture time)")
def capture_impurity(ctx):
    captured = _captured_function_names(ctx.tree)
    if not captured:
        return []
    findings = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name not in captured:
            continue
        for inner in ast.walk(node):
            if not isinstance(inner, ast.Call):
                continue
            matched = _impure_call(inner)
            if matched is None:
                continue
            findings.append(ctx.finding(
                _RULE, inner,
                f"{matched}() inside captured function {node.name!r} runs "
                "once at capture time and is baked into what replays",
                hint="pass the value in as a tensor argument (timestamps) "
                     "or draw on the device from a torch.Generator / the "
                     "port's ops/prng key (randomness); the captured value "
                     "silently replays on every call",
            ))
    return findings
