"""The port's lint (modelx_tpu_torch/analysis) against the JAX package's
(modelx_tpu/analysis), on the CPU.

- **Parity.** Every synthetic module that tests/test_analysis.py lints is
  linted by both packages here. A file placed under ``modelx_tpu/`` for
  the reference sits at the same path under ``modelx_tpu_torch/`` for the
  port (each lint scopes its handler and server-path rules to its own
  package). The five shared rules must give the same ``(rule, line,
  scope)`` findings. Where the two must differ, the case states both
  answers: ``jax.device_put`` is a blocking call in the reference and not
  in the port, and ``jax.jit`` is the reference's capture where the port's
  is ``torch.compile`` (``jax-impurity`` against ``capture-impurity``).
- **The port's own cases.** Each torch host-device sync under a lock, the
  ``.to(...)`` cases, the native engine's and the registry client's
  blocking I/O, the capture forms of ``capture-impurity``, the port's typed
  errors and server-path modules.
- **The gate.** The port's tree exits 0 with no unused baseline entry, a
  seeded ``time.sleep`` or ``.item()`` under a lock exits 1, a malformed
  baseline exits 2, and ``--list-rules`` names six rules.
- **The repairs the lint found** in the port's code, each shown.

Tolerance: exact equality of the finding lists.
"""

import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from modelx_tpu.analysis import lint as jlint
from modelx_tpu_torch.analysis import lint
from modelx_tpu_torch.analysis.lint import (
    BaselineError,
    Finding,
    Suppression,
    _parse_baseline_toml,
    analyze_paths,
    apply_baseline,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = {"blocking-under-lock", "lock-leak", "untyped-handler-error", "bare-thread",
          "swallowed-exception"}


def _write(tmp_path, source: str, filename: str):
    p = tmp_path / filename
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return p


def run_lint(tmp_path, source: str, filename: str = "mod.py"):
    """Lint one synthetic module with the port's lint; returns the findings."""
    p = _write(tmp_path, source, filename)
    findings, errors = analyze_paths([str(p)], root=str(tmp_path))
    assert not errors, errors
    return findings


def rules_of(findings):
    return sorted({f.rule for f in findings})


def port_path(filename: str) -> str:
    return ("modelx_tpu_torch/" + filename[len("modelx_tpu/"):]
            if filename.startswith("modelx_tpu/") else filename)


def both(tmp_path, source: str, filename: str = "mod.py"):
    """(reference findings, port findings) on the same module, each at its
    own package's path."""
    jp = _write(tmp_path / "ref", source, filename)
    jf, jerr = jlint.analyze_paths([str(jp)], root=str(tmp_path / "ref"))
    tp = _write(tmp_path / "port", source, port_path(filename))
    tf, terr = analyze_paths([str(tp)], root=str(tmp_path / "port"))
    assert not jerr and not terr, (jerr, terr)
    return jf, tf


def shared(findings):
    return sorted((f.rule, f.line, f.scope) for f in findings if f.rule in SHARED)


# -- the reference's synthetic trees (tests/test_analysis.py), both lints -------

_HANDLER = """
    from http.server import BaseHTTPRequestHandler
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            {extra}
            {raise_stmt}
"""

REF_CASES = {
    # TestBlockingUnderLock
    "sleep_under_with_lock": ("mod.py", """
        import threading, time
        lock = threading.Lock()
        def f():
            with lock:
                time.sleep(1)
    """),
    "file_io_and_rmtree_under_lock": ("mod.py", """
        import threading, shutil, os
        class C:
            def __init__(self):
                self._lock = threading.Lock()
            def f(self, d):
                with self._lock:
                    shutil.rmtree(d)
                    os.replace("a", "b")
    """),
    "future_result_and_device_put_under_lock": ("mod.py", """
        import threading, jax
        def f(fut, x):
            mu = threading.Lock()
            with mu:
                fut.result()
                jax.device_put(x)
    """),
    "lock_known_by_assignment_not_name": ("mod.py", """
        import threading, time
        class C:
            def __init__(self):
                self._profiling = threading.Lock()
            def f(self):
                with self._profiling:
                    time.sleep(0.1)
    """),
    "provider_seam_under_lock": ("mod.py", """
        import threading
        class Store:
            def __init__(self, fs):
                self.fs = fs
                self._lock = threading.Lock()
            def refresh(self, data):
                with self._lock:
                    self.fs.put("index.json", data)
    """),
    "nested_def_under_lock_is_exempt": ("mod.py", """
        import threading, time
        def f():
            lock = threading.Lock()
            with lock:
                def later():
                    time.sleep(1)
                cb = later
            return cb
    """),
    "condition_wait_is_exempt": ("mod.py", """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.RLock()
                self._idle = threading.Condition(self._lock)
            def drain(self):
                with self._lock:
                    self._idle.wait(timeout=0.5)
    """),
    "work_after_release_is_clean": ("mod.py", """
        import threading, shutil
        def f(entries):
            lock = threading.Lock()
            with lock:
                victims = list(entries)
            for v in victims:
                shutil.rmtree(v)
    """),
    # TestLockLeak
    "unpinned_acquire": ("mod.py", """
        import threading
        lock = threading.Lock()
        def f():
            lock.acquire()
            do_work()
            lock.release()
    """),
    "acquire_pinned_by_try_finally": ("mod.py", """
        import threading
        lock = threading.Lock()
        def f():
            lock.acquire()
            try:
                do_work()
            finally:
                lock.release()
    """),
    "acquire_inside_try_whose_finally_releases": ("mod.py", """
        import threading
        lock = threading.Lock()
        def f():
            try:
                lock.acquire()
                do_work()
            finally:
                lock.release()
    """),
    "nonblocking_acquire_with_clean_body_not_flagged": ("mod.py", """
        import threading
        lock = threading.Lock()
        def f():
            if not lock.acquire(blocking=False):
                return None
            try:
                return do_work()
            finally:
                lock.release()
    """),
    "conditional_acquire_blocking_body_flagged": ("mod.py", """
        import threading, time
        lock = threading.Lock()
        def f(seconds):
            if not lock.acquire(blocking=False):
                return None
            try:
                time.sleep(seconds)
            finally:
                lock.release()
    """),
    # TestUntypedHandlerError
    "untyped_raise_in_handler": ("modelx_tpu/dl/serve.py", _HANDLER.format(
        extra="", raise_stmt='raise RuntimeError("boom")')),
    "typed_raise_is_clean": ("modelx_tpu/dl/serve.py", """
        from http.server import BaseHTTPRequestHandler
        from modelx_tpu.dl.serving_errors import QueueFullError
        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                raise QueueFullError(9, 8)
    """),
    "registry_factory_raise_is_clean": ("modelx_tpu/registry/server.py", """
        from http.server import BaseHTTPRequestHandler
        from modelx_tpu import errors
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                raise errors.blob_unknown("sha256:00")
    """),
    "caught_and_mapped_raise_is_clean": ("modelx_tpu/dl/serve.py", """
        from http.server import BaseHTTPRequestHandler
        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                try:
                    raise ValueError("bad field")
                except ValueError as e:
                    self.send_error(400, str(e))
    """),
    "blanket_exception_backstop_does_not_type": ("modelx_tpu/dl/serve.py", """
        from http.server import BaseHTTPRequestHandler
        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                try:
                    raise KeyError("x")
                except Exception:
                    self.send_error(500)
    """),
    "non_handler_module_out_of_scope": ("modelx_tpu/dl/other.py", _HANDLER.format(
        extra="", raise_stmt='raise RuntimeError("boom")')),
    # TestBareThread
    "thread_without_daemon_or_join": ("mod.py", """
        import threading
        def f():
            threading.Thread(target=print).start()
    """),
    "daemon_thread_is_clean": ("mod.py", """
        import threading
        def f():
            threading.Thread(target=print, daemon=True).start()
    """),
    "joined_thread_is_clean": ("mod.py", """
        import threading
        def f():
            t = threading.Thread(target=print)
            t.start()
            t.join()
    """),
    # TestSwallowedException
    "bare_except_pass": ("mod.py", """
        def f():
            try:
                work()
            except:
                pass
    """),
    "broad_silent_except_on_server_path": ("modelx_tpu/dl/serve.py", """
        def f():
            try:
                work()
            except Exception:
                pass
    """),
    "narrow_typed_cleanup_is_legal": ("modelx_tpu/dl/serve.py", """
        import os
        def f(p):
            try:
                os.unlink(p)
            except OSError:
                pass
    """),
    "broad_except_off_server_path_is_legal": ("modelx_tpu/models/llama.py", """
        def f():
            try:
                work()
            except Exception:
                pass
    """),
    # TestJaxImpurity
    "time_in_jitted_builder": ("mod.py", """
        import jax, time
        def _step_impl(x):
            t0 = time.time()
            return x + t0
        step = jax.jit(_step_impl)
    """),
    "stdlib_random_in_decorated_jit": ("mod.py", """
        import jax, random
        @jax.jit
        def step(x):
            return x * random.random()
    """),
    "jax_random_is_pure_and_legal": ("mod.py", """
        import jax
        def _sample_impl(key, logits):
            return jax.random.categorical(key, logits)
        sample = jax.jit(_sample_impl)
    """),
    "time_outside_jit_is_legal": ("mod.py", """
        import jax, time
        def _step_impl(x):
            return x + 1
        step = jax.jit(_step_impl)
        def dispatch(x):
            t0 = time.time()
            return step(x), time.time() - t0
    """),
    "method_impl_jitted_from_init": ("mod.py", """
        import jax, time
        class Decoder:
            def __init__(self):
                self._chunk = jax.jit(self._chunk_impl, donate_argnums=(1,))
            def _chunk_impl(self, cache):
                time.monotonic()
                return cache
    """),
}

# the reference's expected rule sets (tests/test_analysis.py), for the
# cases whose answer is a rule set; a case missing here expects []
REF_RULES = {
    "sleep_under_with_lock": ["blocking-under-lock"],
    "file_io_and_rmtree_under_lock": ["blocking-under-lock"],
    "future_result_and_device_put_under_lock": ["blocking-under-lock"],
    "lock_known_by_assignment_not_name": ["blocking-under-lock"],
    "provider_seam_under_lock": ["blocking-under-lock"],
    "unpinned_acquire": ["lock-leak"],
    "conditional_acquire_blocking_body_flagged": ["blocking-under-lock"],
    "untyped_raise_in_handler": ["untyped-handler-error"],
    "blanket_exception_backstop_does_not_type": ["untyped-handler-error"],
    "thread_without_daemon_or_join": ["bare-thread"],
    "bare_except_pass": ["swallowed-exception"],
    "broad_silent_except_on_server_path": ["swallowed-exception"],
    "time_in_jitted_builder": ["jax-impurity"],
    "stdlib_random_in_decorated_jit": ["jax-impurity"],
    "method_impl_jitted_from_init": ["jax-impurity"],
}

# the one shared-rule case whose answers differ: jax.device_put blocks in
# the reference; the port has no jax, its device waits are torch's syncs
DIFFERS = {
    "future_result_and_device_put_under_lock": (
        [("blocking-under-lock", 6, "f"), ("blocking-under-lock", 7, "f")],  # reference
        [("blocking-under-lock", 6, "f")],                                    # port
    ),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_shared_rules_find_what_the_reference_finds(tmp_path, case):
    filename, source = REF_CASES[case]
    jf, tf = both(tmp_path, source, filename)
    assert sorted({f.rule for f in jf}) == REF_RULES.get(case, [])
    if case in DIFFERS:
        want_ref, want_port = DIFFERS[case]
        assert shared(jf) == want_ref
        assert shared(tf) == want_port
    else:
        assert shared(tf) == shared(jf)
        assert [f.message for f in tf if f.rule in SHARED] == [
            f.message for f in jf if f.rule in SHARED]


JAX_CASES = ["time_in_jitted_builder", "stdlib_random_in_decorated_jit",
             "jax_random_is_pure_and_legal", "time_outside_jit_is_legal",
             "method_impl_jitted_from_init"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_purity_rule_both_answers(tmp_path, case):
    """jax.jit is the reference's capture, torch.compile the port's: on
    the reference's module the reference flags jax-impurity and the port
    nothing; on the same module with ``jax.jit`` spelled ``torch.compile``
    the port flags capture-impurity at the same line and scope, and the
    reference nothing."""
    filename, source = REF_CASES[case]
    jf, tf = both(tmp_path / "jax", source, filename)
    ref = [(f.line, f.scope) for f in jf if f.rule == "jax-impurity"]
    assert [f.rule for f in tf] == []
    torch_src = source.replace("import jax,", "import torch,").replace(
        "import jax\n", "import torch\n").replace("jax.jit(", "torch.compile(").replace(
        "@jax.jit", "@torch.compile").replace("jax.random.categorical(key, logits)",
                                              "torch.distributions.Categorical(logits=logits)")
    jf2, tf2 = both(tmp_path / "torch", torch_src, filename)
    assert jf2 == []
    assert [(f.line, f.scope) for f in tf2 if f.rule == "capture-impurity"] == ref
    assert rules_of(tf2) == (["capture-impurity"] if ref else [])


# -- the port's own cases ----------------------------------------------------------

SYNCS = {
    "torch.cuda.synchronize()": "torch.cuda.synchronize",
    "stream.synchronize()": "stream.synchronize",
    "ev.synchronize()": "ev.synchronize",
    "x.item()": "x.item",
    "x.tolist()": "x.tolist",
    "x.cpu()": "x.cpu",
    "x.numpy()": "x.numpy",
    "x.argmax(-1).cpu().numpy()": "x.argmax.cpu.numpy",
    'x.to("cpu")': "x.to",
    'x.to("cpu:0")': "x.to",
    'x.to(torch.device("cpu"))': "x.to",
    'x.to(device="cpu")': "x.to",
    "x.to(dev, non_blocking=False)": "x.to",
    "native.pread_fd(fd, 0, 8, out)": "native.pread_fd",
    "native.pread_scatter(path, ranges)": "native.pread_scatter",
    "native.sha256_file(path)": "native.sha256_file",
    "pread_fd(fd, 0, 8, out)": "pread_fd",
    "conn.get_range(path, 0, 8, out)": "conn.get_range",
    'send_request(pool, "GET", url, {})': "send_request",
    'remote.send_request(pool, "GET", url, {})': "remote.send_request",
}


@pytest.mark.parametrize("call", sorted(SYNCS))
def test_each_wait_under_a_lock_is_flagged(tmp_path, call):
    findings = run_lint(tmp_path, f"""
        import threading, torch
        class S:
            def __init__(self):
                self._device_lock = threading.Lock()
            def f(self, x, stream, ev, dev, native, fd, out, path, ranges, conn, pool,
                  url, remote):
                with self._device_lock:
                    y = {call}
                return y
    """)
    assert [(f.rule, f.line, f.scope) for f in findings] == [
        ("blocking-under-lock", 9, "S.f")]
    assert findings[0].message == f"{SYNCS[call]}() while holding 'self._device_lock'"


NOT_WAITS = [
    "x.to(torch.float32)",
    "x.to(dtype=torch.bfloat16)",
    "x.to(dev)",
    'x.to("cuda")',
    'x.to("cpu", non_blocking=True)',
    "x.to(dev, non_blocking=True)",
    "d.items()",
    "x.float().argmax(-1)",
    "torch.cuda.current_device()",
    "np.asarray(rows)",
    "cv.wait(timeout=0.1)",
    "cv.notify_all()",
]


@pytest.mark.parametrize("call", NOT_WAITS)
def test_similar_calls_that_do_not_wait_stay_quiet(tmp_path, call):
    """A dtype cast or a copy onto the card queues like any other launch;
    ``.items()`` is not ``.item()``; a Condition's wait releases the lock."""
    findings = run_lint(tmp_path, f"""
        import threading, torch
        import numpy as np
        class S:
            def __init__(self):
                self._device_lock = threading.Lock()
                self.cv = threading.Condition(self._device_lock)
            def f(self, x, dev, d, rows):
                cv = self.cv
                with self._device_lock:
                    y = {call}
                return y
    """)
    assert findings == []


def test_a_host_read_after_the_release_is_clean(tmp_path):
    """The repair the hint teaches for the card: queue the copy under the
    lock, wait for it after the release."""
    findings = run_lint(tmp_path, """
        import threading, torch
        from modelx_tpu_torch.device import start_host_copy
        lock = threading.Lock()
        def f(model, x):
            with lock:
                fetch = start_host_copy(model(x).argmax(-1))
            return fetch()
        def g(model, x):
            with lock:
                y = model(x)
            return y.cpu().numpy()
    """)
    assert findings == []


CAPTURES = {
    "call": """
        import torch, time
        def _step_impl(x):
            return x + time.time()
        step = torch.compile(_step_impl)
    """,
    "method": """
        import torch, time
        class Engine:
            def __init__(self):
                self._chunk = torch.compile(self._chunk_impl, mode="reduce-overhead")
            def _chunk_impl(self, x):
                time.monotonic()
                return x
    """,
    "decorator": """
        import torch, random
        @torch.compile
        def step(x):
            return x * random.random()
    """,
    "decorator_call": """
        import torch, time
        @torch.compile(fullgraph=True)
        def step(x):
            return x * time.perf_counter()
    """,
    "partial_decorator": """
        import torch, time
        from functools import partial
        @partial(torch.compile, dynamic=False)
        def step(x):
            return x * time.time()
    """,
    "partial_call": """
        import torch, functools
        import numpy as np
        def _impl(x):
            return x * np.random.rand()
        step = functools.partial(torch.compile, mode="max-autotune")(_impl)
    """,
    "jit_script": """
        import torch, time
        def _impl(x):
            return x + time.time()
        scripted = torch.jit.script(_impl)
    """,
    "jit_trace": """
        import torch, uuid
        def _impl(x):
            uuid.uuid4()
            return x
        traced = torch.jit.trace(_impl, (torch.zeros(1),))
    """,
    "graphed_callables": """
        import torch, time
        def _a(x):
            return x + time.time()
        def _b(x):
            return x
        a, b = torch.cuda.make_graphed_callables((_a, _b), ((torch.zeros(1),), (torch.zeros(1),)))
    """,
    "cuda_graph_block": """
        import torch, random
        def _decode_step(x):
            return x * random.random()
        def capture(g, x):
            with torch.cuda.graph(g):
                y = _decode_step(x)
            return y
    """,
    "nested_def_runs_at_capture": """
        import torch, time
        @torch.compile
        def step(x):
            def inner():
                return time.time()
            return x + inner()
    """,
}


@pytest.mark.parametrize("form", sorted(CAPTURES))
def test_capture_impurity_flags_each_capture_form(tmp_path, form):
    findings = run_lint(tmp_path, CAPTURES[form])
    assert rules_of(findings) == ["capture-impurity"]
    assert len(findings) == 1


NOT_CAPTURED = {
    "device_rng_with_generator": """
        import torch
        @torch.compile
        def step(x, gen):
            return x + torch.rand(x.shape, generator=gen, device=x.device)
    """,
    "clock_outside_the_compiled_function": """
        import torch, time
        def _step_impl(x):
            return x + 1
        step = torch.compile(_step_impl)
        def dispatch(x):
            t0 = time.monotonic()
            return step(x), time.monotonic() - t0
    """,
    "re_compile_is_not_a_capture": """
        import re, time
        def pattern():
            time.time()
            return "a+"
        rx = re.compile(pattern())
    """,
    "jax_jit_is_the_references_capture": """
        import jax, time
        def _step_impl(x):
            return x + time.time()
        step = jax.jit(_step_impl)
    """,
}


@pytest.mark.parametrize("form", sorted(NOT_CAPTURED))
def test_capture_impurity_stays_quiet(tmp_path, form):
    assert run_lint(tmp_path, NOT_CAPTURED[form]) == []


def test_port_typed_errors_are_typed(tmp_path):
    """NotPortedError (the 501 naming the slice that brings a feature) is
    typed on the port's handler surface; the reference's list lacks it."""
    src = """
        from http.server import BaseHTTPRequestHandler
        from modelx_tpu_torch.dl.serve import NotPortedError
        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                raise NotPortedError("tokenizer.json component Unigram", "tokenizer")
    """
    jf, tf = both(tmp_path, src, "modelx_tpu/dl/serve.py")
    assert rules_of(tf) == [] and rules_of(jf) == ["untyped-handler-error"]


def test_openai_veneer_top_level_functions_are_handler_scopes(tmp_path):
    findings = run_lint(tmp_path, """
        def completions(server, req):
            raise RuntimeError("boom")
        def chat(server, req):
            raise APIError(400, "bad")
    """, filename="modelx_tpu_torch/dl/openai_api.py")
    assert [(f.rule, f.scope) for f in findings] == [
        ("untyped-handler-error", "completions")]


@pytest.mark.parametrize("module", ["router/http.py", "native/__init__.py",
                                    "dl/serving_errors.py", "dl/tokenizer.py",
                                    "kernels/build.py", "registry/server_main.py"])
def test_port_server_paths_the_reference_leaves_out(tmp_path, module):
    src = """
        def f():
            try:
                work()
            except Exception:
                pass
    """
    jf, tf = both(tmp_path, src, "modelx_tpu/" + module)
    assert rules_of(tf) == ["swallowed-exception"]
    assert rules_of(jf) == []


def test_the_reference_paths_are_out_of_the_ports_scope(tmp_path):
    findings = run_lint(tmp_path, _HANDLER.format(extra="", raise_stmt='raise RuntimeError("x")'),
                        filename="modelx_tpu/dl/serve.py")
    assert findings == []


# -- the baseline (tests/test_analysis.py TestBaseline, port paths) ------------------


class TestBaseline:
    def _finding(self, **kw):
        base = dict(rule="blocking-under-lock", file="modelx_tpu_torch/dl/x.py",
                    line=10, col=4, message="m", scope="C.f")
        base.update(kw)
        return Finding(**base)

    def test_scope_match_suppresses(self):
        sups = [Suppression(rule="blocking-under-lock",
                            file="modelx_tpu_torch/dl/x.py", scope="C.f", reason="ok")]
        new, suppressed = apply_baseline([self._finding()], sups)
        assert new == [] and len(suppressed) == 1
        assert sups[0].used == 1

    def test_scope_mismatch_does_not_suppress(self):
        sups = [Suppression(rule="blocking-under-lock",
                            file="modelx_tpu_torch/dl/x.py", scope="C.g", reason="ok")]
        new, _ = apply_baseline([self._finding()], sups)
        assert len(new) == 1

    def test_file_wide_suppression(self):
        sups = [Suppression(rule="blocking-under-lock",
                            file="modelx_tpu_torch/dl/x.py", reason="ok")]
        new, suppressed = apply_baseline(
            [self._finding(), self._finding(scope="D.g", line=99)], sups)
        assert new == [] and len(suppressed) == 2

    def test_parse_roundtrip_equals_the_reference(self):
        text = textwrap.dedent("""
            # comment
            [[suppression]]
            rule = "lock-leak"
            file = "modelx_tpu_torch/dl/loader.py"
            scope = "load_safetensors._gated_read"
            reason = "vetted: release happens in the governor"
        """)
        sups = _parse_baseline_toml(text, "test.toml")
        ref = jlint._parse_baseline_toml(text, "test.toml")
        assert len(sups) == 1
        assert (sups[0].rule, sups[0].file, sups[0].scope, sups[0].reason) == (
            ref[0].rule, ref[0].file, ref[0].scope, ref[0].reason)

    @pytest.mark.parametrize("text", [
        '[[suppression]]\nrule = "lock-leak"\nfile = "x.py"\n',
        '[[suppression]]\nrule = "lock-leak"\nfile = "x.py"\nreason = ""\n',
        '[[suppression]]\nrule = lock-leak\n',
        'rule = "lock-leak"\n',
    ])
    def test_malformed_rejected_as_the_reference_rejects(self, text):
        with pytest.raises(BaselineError):
            _parse_baseline_toml(text, "test.toml")
        with pytest.raises(jlint.BaselineError):
            jlint._parse_baseline_toml(text, "test.toml")

    def test_checked_in_baseline_parses_with_port_reasons(self):
        sups = lint.load_baseline(lint.default_baseline_path())
        assert sups, "checked-in baseline should not be empty"
        ref = {s.reason for s in jlint.load_baseline(jlint.default_baseline_path())}
        for s in sups:
            assert s.reason.strip()
            assert s.reason not in ref, "a reason copied from the reference's baseline"
            assert not s.file.startswith("modelx_tpu/")


# -- the gate ---------------------------------------------------------------------


class TestGate:
    def test_port_tree_is_green_with_no_unused_entry(self, capsys):
        rc = lint.main(["--root", REPO_ROOT])
        out, err = capsys.readouterr()
        assert rc == 0, out
        assert "unused baseline suppression" not in err
        assert "0 new finding(s)" in out

    def test_gate_walks_the_port_and_its_card_scripts(self):
        files = [rel for _, rel in lint.iter_python_files(lint.DEFAULT_TARGETS, REPO_ROOT)]
        assert "chip_smoke.py" in files
        assert "modelx_tpu_torch/dl/serve.py" in files
        assert not any(f.startswith("modelx_tpu/") for f in files)
        findings, errors = analyze_paths(list(lint.DEFAULT_TARGETS), root=REPO_ROOT)
        assert errors == []
        assert len(files) > 100

    @pytest.mark.parametrize("body", ["time.sleep(5)", "x.item()"])
    def test_seeded_violation_fails_nonzero(self, tmp_path, body):
        bad = tmp_path / "seeded.py"
        bad.write_text(textwrap.dedent(f"""
            import threading, time
            lock = threading.Lock()
            def f(x):
                with lock:
                    {body}
        """))
        proc = subprocess.run(
            [sys.executable, "-m", "modelx_tpu_torch.analysis",
             "--root", str(tmp_path), str(bad)],
            capture_output=True, text=True, cwd=REPO_ROOT,
        )
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "seeded.py:6: blocking-under-lock" in proc.stdout

    def test_malformed_baseline_exits_2(self, tmp_path):
        bad_baseline = tmp_path / "baseline.toml"
        bad_baseline.write_text('[[suppression]]\nrule = "lock-leak"\n')
        clean = tmp_path / "ok.py"
        clean.write_text("x = 1\n")
        rc = lint.main(["--root", str(tmp_path), "--baseline", str(bad_baseline), str(clean)])
        assert rc == 2

    def test_missing_target_and_unknown_rule_exit_2(self, tmp_path):
        assert lint.main(["--root", str(tmp_path), "nope.py"]) == 2
        assert lint.main(["--root", str(tmp_path), "--rule", "jax-impurity"]) == 2

    def test_list_rules_names_all_six(self, capsys):
        rc = lint.main(["--list-rules"])
        assert rc == 0
        out = capsys.readouterr().out
        ids = [line.split(":", 1)[0] for line in out.splitlines()]
        assert sorted(ids) == sorted(SHARED | {"capture-impurity"})

    def test_an_unused_entry_warns(self, tmp_path, capsys):
        base = tmp_path / "baseline.toml"
        base.write_text('[[suppression]]\nrule = "lock-leak"\nfile = "gone.py"\n'
                        'reason = "the site was repaired"\n')
        ok = tmp_path / "ok.py"
        ok.write_text("x = 1\n")
        assert lint.main(["--root", str(tmp_path), "--baseline", str(base), str(ok)]) == 0
        assert "unused baseline suppression lock-leak @ gone.py" in capsys.readouterr().err


class TestRepoConventions:
    def test_all_rules_have_ids_and_docs(self):
        from modelx_tpu_torch.analysis.rules import all_rules

        rules = all_rules()
        assert len(rules) == 6
        for r in rules:
            assert r.rule_id and r.rule_doc

    def test_the_analysis_package_stands_alone(self):
        """The gate imports nothing beyond the standard library: it runs on
        the card's host without torch being imported."""
        code = ("import sys; import modelx_tpu_torch.analysis.lint as l; "
                "from modelx_tpu_torch.analysis.rules import all_rules; all_rules(); "
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('torch', 'jax', 'numpy', 'modelx_tpu')]; print(bad); sys.exit(1 if bad else 0)")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=REPO_ROOT)
        assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the repairs the lint found --------------------------------------------------


def _port_findings(rule: str, file: str, scope_prefix: str):
    findings, _ = analyze_paths([file], root=REPO_ROOT)
    return [f for f in findings if f.rule == rule and f.scope.startswith(scope_prefix)]


@pytest.mark.parametrize("scope", ["ModelServer._argmax", "ModelServer.generate",
                                   "ModelServer._generate_ragged", "ModelServer._score"])
def test_model_server_waits_for_the_card_after_the_device_lock(scope):
    """These reads of the card's results waited under _device_lock (and
    the speculative path built its prompt list there); they now queue the
    copy under the lock and wait after its release."""
    assert _port_findings("blocking-under-lock", "modelx_tpu_torch/dl/serve.py", scope) == []


@pytest.fixture(scope="module")
def tiny_server(tmp_path_factory):
    import dataclasses

    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve as tserve
    from modelx_tpu_torch.models import llama

    d = tmp_path_factory.mktemp("analysis-model")
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=64), dtype=torch.float32)
    st.write_safetensors(str(d / "model.safetensors"),
                         llama.init_params(cfg, torch.Generator().manual_seed(0)))
    srv = tserve.ModelServer(str(d), dtype="float32", device="cpu", name="m", max_seq_len=64)
    srv.load()
    return srv


def test_host_reads_run_after_the_device_lock_is_released(tiny_server, monkeypatch):
    """Each read of a result (forward argmax, generate, scoring) waits with
    _device_lock free, and gives what a read under the lock gave."""
    from modelx_tpu_torch.dl import serve as tserve

    real = tserve.start_host_copy
    held = []

    def spy(t):
        get = real(t)

        def wait():
            held.append(tiny_server._device_lock.locked())
            return get()
        return wait

    tokens = np.array([[1, 2, 3, 4, 5]], np.int32)
    want_argmax = tiny_server.forward_argmax(tokens)
    want_gen = tiny_server.generate(tokens, max_new_tokens=4)
    want_score = tiny_server.score_logprobs([1, 2, 3], [4, 5], top_k=2)
    monkeypatch.setattr(tserve, "start_host_copy", spy)
    np.testing.assert_array_equal(tiny_server.forward_argmax(tokens), want_argmax)
    np.testing.assert_array_equal(tiny_server.generate(tokens, max_new_tokens=4), want_gen)
    got_score = tiny_server.score_logprobs([1, 2, 3], [4, 5], top_k=2)
    for g, w in zip(got_score, want_score):
        np.testing.assert_array_equal(g, w)
    assert held == [False] * 5  # argmax, generate, chosen + top ids + top logprobs


def test_start_host_copy_on_the_cpu_is_a_copy():
    import torch

    from modelx_tpu_torch.device import start_host_copy

    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    get = start_host_copy(t)
    t += 100
    np.testing.assert_array_equal(get(), np.arange(6, dtype=np.int32).reshape(2, 3))


def test_native_connection_finalizer_leaves_a_trace(caplog):
    """``NativeHTTPConnection.__del__`` swallowed a failed close silently
    (``except Exception: pass`` on a server path); it now logs it."""
    from modelx_tpu_torch.native import NativeHTTPConnection

    class Lib:
        def mx_http_close(self, conn):
            raise OSError("close failed")

    conn = object.__new__(NativeHTTPConnection)
    conn._lib, conn._conn = Lib(), 1
    with caplog.at_level(logging.DEBUG, logger="modelx.native"):
        conn.__del__()
    assert "native connection close failed" in caplog.text
    assert _port_findings("swallowed-exception", "modelx_tpu_torch/native/__init__.py",
                          "NativeHTTPConnection") == []
