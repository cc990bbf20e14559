"""The port's spans (modelx_tpu_torch.utils.trace) against the JAX package's,
on the CPU: the cases of tests/test_trace.py, each call sequence run
through both modules and the closed spans compared (paths, attributes,
errors, request ids, ring bounds and aggregates; durations only where a
case times its own sleep, within the same bound on both sides).

``torch_profile`` replaces ``jax_profile``: a CPU capture writes a Chrome
trace holding the ops run inside the window, and a profiler that cannot
write its trace warns instead of raising.
"""

import inspect
import json
import threading
import time

import numpy as np
import pytest

from modelx_tpu.utils import trace as jtrace
from modelx_tpu_torch.utils import trace as ttrace

TIMING = ("start_s", "duration_s")


@pytest.fixture(autouse=True)
def clean_tracers():
    for mod in (jtrace, ttrace):
        mod.tracer().clear()
    yield
    for mod in (jtrace, ttrace):
        mod.tracer().clear()


def _untimed(spans):
    return [{k: v for k, v in s.items() if k not in TIMING} for s in spans]


def both(scenario):
    """``scenario(module)`` for the JAX package's and the port's trace
    module; the two results must be equal. Returns the port's."""
    want, got = scenario(jtrace), scenario(ttrace)
    assert got == want
    return got


class TestSpan:
    def test_nested_paths(self):
        def run(m):
            with m.span("outer"):
                with m.span("inner", k=1):
                    pass
            return _untimed(m.tracer().spans())
        assert [s["path"] for s in both(run)] == ["outer/inner", "outer"]

    def test_attrs_and_duration(self):
        def run(m):
            with m.span("op", model="m") as rec:
                rec["extra"] = 42
            (s,) = m.tracer().spans("op")
            assert s["duration_s"] >= 0
            return _untimed([s])
        assert both(run) == [{"model": "m", "extra": 42, "path": "op"}]

    def test_error_captured_and_reraised(self):
        def run(m):
            with pytest.raises(ValueError):
                with m.span("boom"):
                    raise ValueError("nope")
            return _untimed(m.tracer().spans("boom"))
        assert both(run)[0]["error"] == "ValueError: nope"

    def test_traced_decorator(self):
        def run(m):
            @m.traced("fn.op")
            def f(x):
                return x + 1
            return f(1), _untimed(m.tracer().spans("fn.op"))
        assert both(run) == (2, [{"path": "fn.op"}])

    def test_prefix_filter(self):
        def run(m):
            with m.span("a.x"):
                pass
            with m.span("b.y"):
                pass
            return _untimed(m.tracer().spans("a.")), _untimed(m.spans("b."))
        assert both(run) == ([{"path": "a.x"}], [{"path": "b.y"}])

    def test_thread_isolation(self):
        def run(m):
            def worker():
                with m.span("w"):
                    pass
            with m.span("main"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
            return sorted(s["path"] for s in m.tracer().spans())
        assert both(run) == ["main", "w"]  # the worker's span never nests under main


class TestTracer:
    def test_ring_bound_and_dropped(self):
        def run(m):
            t = m.Tracer(max_spans=3)
            for i in range(5):
                t.record({"path": f"s{i}", "start_s": 0, "duration_s": 0})
            return [s["path"] for s in t.spans()], t.dropped, t.max_spans
        assert both(run) == (["s2", "s3", "s4"], 2, 3)
        assert ttrace.MAX_SPANS == jtrace.MAX_SPANS == 8192

    def test_summary_aggregates(self):
        def run(m):
            t = m.Tracer()
            for d in (0.1, 0.3):
                t.record({"path": "op", "start_s": 0, "duration_s": d})
            t.clear()
            for d in (0.1, 0.3):
                t.record({"path": "op", "start_s": 0, "duration_s": d})
            return t.summary(), t.summary("nope"), t.dropped
        agg, empty, dropped = both(run)
        assert agg["op"]["count"] == 2 and abs(agg["op"]["total_s"] - 0.4) < 1e-9
        assert agg["op"]["max_s"] == 0.3 and empty == {} and dropped == 0

    def test_export_json(self, tmp_path):
        def run(m):
            with m.span("x", n=1):
                pass
            p = tmp_path / f"{m.__name__}.json"
            m.export_json(str(p))
            return _untimed(json.loads(p.read_text()))
        assert both(run) == [{"n": 1, "path": "x"}]


class TestIntegration:
    def test_loader_emits_load_span(self, tmp_path):
        """The loader records one ``dl.load`` span with its counters, as
        the JAX package's loader does."""
        import ml_dtypes

        from modelx_tpu.dl import safetensors as st
        from modelx_tpu.dl.loader import LocalFileSource as JaxSource
        from modelx_tpu.dl.loader import load_safetensors as jax_load
        from modelx_tpu.dl.sharding import LLAMA_RULES
        from modelx_tpu.parallel.mesh import make_mesh
        from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors

        path = str(tmp_path / "m.safetensors")
        st.write_safetensors(path, {"model.norm.weight": np.ones((8,), ml_dtypes.bfloat16)})
        jax_load(JaxSource(path), make_mesh("dp=1"), LLAMA_RULES)
        src = LocalFileSource(path)
        try:
            load_safetensors(src, "cpu")
        finally:
            src.close()
        (j,) = jtrace.tracer().spans("dl.load")
        (t,) = ttrace.tracer().spans("dl.load")
        assert set(t) == set(j)
        assert (t["tensors"], t["bytes_to_device"]) == (j["tensors"], j["bytes_to_device"]) == (
            1, 16)

    def test_torch_profile_noop_on_failure(self, tmp_path):
        """An unwritable trace dir must not raise out of the context
        manager (jax_profile's contract), and the block still runs."""
        blocker = tmp_path / "file"
        blocker.write_text("")
        ran = []
        with ttrace.torch_profile(str(blocker / "trace")):
            ran.append(1)
        assert ran == [1]

    def test_torch_profile_writes_a_chrome_trace_on_the_cpu(self, tmp_path):
        import torch

        with ttrace.torch_profile(str(tmp_path)):
            torch.mm(torch.ones(64, 64), torch.ones(64, 64))
        with open(tmp_path / ttrace.TRACE_FILE) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::mm" for e in events)


class TestTracedWraps:
    def test_signature_and_metadata_preserved(self):
        def run(m):
            @m.traced("fn.sig")
            def f(a, b=2, *, c):
                """docs"""
                return a + b + c
            return (f.__name__, f.__doc__, list(inspect.signature(f).parameters), f(1, c=3))
        assert both(run) == ("f", "docs", ["a", "b", "c"], 6)

    def test_generator_span_covers_the_whole_iteration(self):
        def run(m):
            @m.traced("gen.op")
            def g():
                yield 1
                time.sleep(0.02)  # work after the first yield
                yield 2
            it = g()
            first = next(it)
            open_after_first = not m.tracer().spans("gen.op")
            rest = list(it)
            (s,) = m.tracer().spans("gen.op")
            return first, open_after_first, rest, s["duration_s"] >= 0.02
        assert both(run) == (1, True, [2], True)

    def test_generator_identity_preserved(self):
        def run(m):
            @m.traced("gen.id")
            def g(n):
                yield from range(n)
            return inspect.isgeneratorfunction(g), g.__name__, list(g(3))
        assert both(run) == (True, "g", [0, 1, 2])


class TestRequestContext:
    def test_spans_stamped_and_filterable(self):
        def run(m):
            ids = [m.current_request_id()]
            with m.request_context("req-42"):
                ids.append(m.current_request_id())
                with m.span("inside"):
                    pass
            ids.append(m.current_request_id())
            with m.span("outside"):
                pass
            return (ids, _untimed(m.tracer().spans(request_id="req-42")),
                    _untimed(m.tracer().spans("outside")))
        ids, inside, outside = both(run)
        assert ids == ["", "req-42", ""]
        assert inside == [{"path": "inside", "request_id": "req-42"}]
        assert outside == [{"path": "outside"}]

    def test_summary_filters_by_request_id(self):
        def run(m):
            for rid in ("req-a", "req-a", "req-b"):
                with m.request_context(rid):
                    with m.span("op"):
                        pass
            t = m.tracer()
            return (t.summary(request_id="req-a")["op"]["count"],
                    t.summary(request_id="req-b")["op"]["count"],
                    t.summary(request_id="req-zzz"), t.summary("op", "req-a")["op"]["count"])
        assert both(run) == (2, 1, {}, 2)

    def test_context_isolated_per_thread(self):
        def run(m):
            def worker():
                with m.span("w.op"):
                    pass
            with m.request_context("req-main"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
            return _untimed(m.tracer().spans("w.op"))
        assert both(run) == [{"path": "w.op"}]  # never inherits the main thread's id
