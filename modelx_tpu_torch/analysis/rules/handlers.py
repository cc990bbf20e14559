"""Handler-surface rules: untyped-handler-error and swallowed-exception.

The port keeps the reference's contract that EVERY error crossing an HTTP
surface is typed — ``ServingError`` subclasses (dl/serving_errors.py),
``oai.APIError`` and ``NotPortedError`` (the 501 naming the slice that
brings a feature) on the serving side, ``errors.ErrorInfo`` constructors
on the registry side, ``PoolError`` on the admin side — so native and
OpenAI responses, streaming and not, agree on status + headers. A ``raise
RuntimeError`` inside a handler silently downgrades that contract to a
generic 500 with no Retry-After and no API error type.

``untyped-handler-error`` flags raises inside HTTP handler classes
(``BaseHTTPRequestHandler`` subclasses) and the OpenAI veneer module that
are neither typed nor explicitly caught-and-mapped in the same function.
A raise caught by a *named* except (e.g. ``except ValueError`` -> 400) is
fine: that IS the mapping. The blanket ``except Exception`` backstop does
not count — it exists to keep the socket alive, not to type errors.

``swallowed-exception`` flags silent ``except: pass`` (and broad
``except Exception: pass``) on server-path modules, where a dropped error
is a debugging dead end under churn. Narrow, typed ``except OSError:
pass`` around best-effort cleanup is the repo's accepted idiom and stays
legal.
"""

from __future__ import annotations

import ast

from modelx_tpu_torch.analysis.rules import dotted_name, register

_RULE_UNTYPED = "untyped-handler-error"
_RULE_SWALLOW = "swallowed-exception"

# the typed families every HTTP surface of the port speaks:
# dl/serving_errors.py (ServingError and its 12 subclasses),
# dl/openai_api.APIError, dl/lifecycle.PoolError, errors.ErrorInfo, and
# dl/serve.py's ChatTemplateRejected (400) and NotPortedError (501)
_TYPED_NAMES = {
    "ServingError", "QueueFullError", "DeadlineExceededError",
    "PoisonedRequestError", "EngineBrokenError", "ModelLoadingError",
    "ModelUnloadedError", "ModelDrainingError", "ModelFailedError",
    "NoReadyPodError", "UpstreamSeveredError",
    "MalformedResumeError", "ResumeExhaustedError",
    "APIError", "PoolError", "ErrorInfo", "ChatTemplateRejected",
    "NotPortedError",
}
# modules whose raises are typed constructors (`raise errors.blob_unknown(...)`)
_TYPED_FACTORY_MODULES = {"errors", "serving_errors", "oai"}
_TYPED_FACTORY_FUNCS = {"api_error_for"}

# server-path modules where a swallowed exception hides churn failures:
# the reference's list mapped onto the port (its parallel/mesh.py has no
# counterpart yet), plus server-path modules the reference's list leaves
# out (router/http.py, native/__init__.py, dl/serving_errors.py) and the
# port's own with no counterpart there (the tokenizer reader, the kernel
# library's build and bind, the registry's entry point)
_PORT = "modelx_tpu_torch/"
_SERVER_PATH_FILES = tuple(_PORT + f for f in (
    "dl/serve.py",
    "dl/serve_main.py",
    "dl/openai_api.py",
    "dl/continuous.py",
    "ops/sampling.py",
    "ops/paged_attention.py",
    "dl/lifecycle.py",
    "dl/tiers.py",
    "dl/manifest_cache.py",
    "dl/outbox.py",
    "dl/program_store.py",
    "dl/kv_store.py",
    "dl/loader.py",
    "dl/sharding.py",
    "registry/server.py",
    "registry/store_fs.py",
    "registry/gc.py",
    "registry/scrub.py",
    "router/server.py",
    "router/registry.py",
    "router/rebalance.py",
    "router/admission.py",
    "utils/promexp.py",
    "utils/trace.py",
    "utils/accesslog.py",
    "utils/flightrec.py",
    "utils/devmem.py",
    "utils/tswheel.py",
    "router/http.py",
    "native/__init__.py",
    "dl/serving_errors.py",
    "dl/tokenizer.py",
    "kernels/build.py",
    "registry/server_main.py",
))

_OPENAI_VENEER = _PORT + "dl/openai_api.py"
_HANDLER_MODULES = tuple(_PORT + f for f in (
    "dl/serve.py",
    "dl/openai_api.py",
    "registry/server.py",
    "router/server.py",
))


def _handler_scopes(ctx):
    """Functions whose raises reach an HTTP response writer: every method
    (incl. nested defs) of a BaseHTTPRequestHandler subclass, plus — in
    modelx_tpu_torch/dl/openai_api.py, which is one big handler veneer —
    every top-level function."""
    scopes = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) and any(
            "BaseHTTPRequestHandler" in ast.dump(b) for b in node.bases
        ):
            scopes.append(node)
    if ctx.rel == _OPENAI_VENEER:
        scopes.extend(n for n in ctx.tree.body
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return scopes


def _is_typed_raise(exc: ast.expr | None) -> bool:
    if exc is None:  # bare `raise` — re-raising what a typed path threw
        return True
    if isinstance(exc, ast.Name):  # `raise e` — re-raise of a caught name
        return True
    if not isinstance(exc, ast.Call):
        return False
    name = dotted_name(exc.func)
    tail = name.rsplit(".", 1)[-1]
    if tail in _TYPED_NAMES or tail in _TYPED_FACTORY_FUNCS:
        return True
    head = name.split(".", 1)[0].lstrip(".")
    if head in _TYPED_FACTORY_MODULES:
        return True
    # `raise errors.<factory>(...)` via attribute on errors-like modules
    if isinstance(exc.func, ast.Attribute):
        base = dotted_name(exc.func.value)
        if base.rsplit(".", 1)[-1] in _TYPED_FACTORY_MODULES:
            return True
    return False


def _caught_and_mapped(ctx, raise_node: ast.Raise, scope_fn) -> bool:
    """Is this raise explicitly caught by a NAMED except (not the blanket
    Exception backstop) in the same function? That pattern — raise
    ValueError, map to 400 below — is the handler's local typing."""
    exc = raise_node.exc
    raised = ""
    if isinstance(exc, ast.Call):
        raised = dotted_name(exc.func).rsplit(".", 1)[-1]
    elif isinstance(exc, ast.Name):
        raised = exc.id
    if not raised:
        return False
    cur = raise_node
    for anc in ctx.ancestors(raise_node):
        if isinstance(anc, ast.Try):
            in_try_body = any(_contains(s, cur) for s in anc.body) or any(
                _contains(s, cur) for s in anc.orelse)
            if in_try_body:
                for h in anc.handlers:
                    for caught in _handler_type_names(h):
                        if caught == raised:
                            return True
        if anc is scope_fn:
            break
    return False


def _handler_type_names(h: ast.ExceptHandler) -> list[str]:
    t = h.type
    if t is None:
        return []
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    names = []
    for e in elts:
        n = dotted_name(e).rsplit(".", 1)[-1]
        if n and n not in ("Exception", "BaseException"):
            names.append(n)
    return names


def _contains(tree_node: ast.AST, target: ast.AST) -> bool:
    return any(n is target for n in ast.walk(tree_node))


@register(_RULE_UNTYPED, "raise reaching an HTTP handler that is not a typed "
                         "serving/registry error")
def untyped_handler_error(ctx):
    if ctx.rel not in _HANDLER_MODULES:
        return []
    findings = []
    for scope in _handler_scopes(ctx):
        for node in ast.walk(scope):
            if not isinstance(node, ast.Raise):
                continue
            if _is_typed_raise(node.exc):
                continue
            fn = ctx.enclosing_function(node)
            if fn is not None and _caught_and_mapped(ctx, node, fn):
                continue
            name = dotted_name(node.exc) if node.exc is not None else "raise"
            findings.append(ctx.finding(
                _RULE_UNTYPED, node,
                f"untyped {name or 'exception'} raised on a handler path",
                hint="raise a typed error instead (ServingError subclass / "
                     "oai.APIError / NotPortedError / errors.* / PoolError) "
                     "or catch-and-map "
                     "it explicitly in this handler; untyped raises surface "
                     "as blank 500s with no retry contract",
            ))
    return findings


@register(_RULE_SWALLOW, "silent `except: pass` on server paths")
def swallowed_exception(ctx):
    findings = []
    on_server_path = ctx.rel in _SERVER_PATH_FILES
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        bare = node.type is None
        broad = (not bare
                 and dotted_name(node.type).rsplit(".", 1)[-1]
                 in ("Exception", "BaseException"))
        silent = all(isinstance(s, (ast.Pass, ast.Continue)) or
                     (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
                     for s in node.body)
        if bare and silent:
            findings.append(ctx.finding(
                _RULE_SWALLOW, node,
                "bare `except:` swallows everything, including "
                "KeyboardInterrupt and injected faults",
                hint="name the exceptions this cleanup tolerates (OSError, "
                     "ValueError, ...) or at least `except Exception` with a "
                     "logger.debug breadcrumb",
            ))
        elif broad and silent and on_server_path:
            findings.append(ctx.finding(
                _RULE_SWALLOW, node,
                "`except Exception: pass` on a server path drops the error "
                "on the floor",
                hint="narrow the exception type, or log it "
                     "(logger.exception/debug) so churn failures leave a "
                     "trace — a silent drop here is a debugging dead end",
            ))
    return findings
