"""The port's Prometheus renderer (modelx_tpu_torch.utils.promexp) against the
JAX package's, on the CPU: the cases of tests/test_promexp.py, each run
through both modules on the same inputs.

Histogram snapshots must be equal dicts, ``wants_prometheus`` must give the
same answers, and ``render`` must be byte-identical on the same tree: key
order, float formatting, non-finite values, skipped strings, label
escaping, kind clashes and histogram lines. The port's output then passes
the strict parser of tests/test_promexp.py. The HTTP surfaces are the
port's registry (its counters through ``render``) and the pod's
``/metrics`` (JSON by default, the exposition on ``?format=prometheus`` or
``Accept: text/plain``).
"""

import json
import math
import urllib.request

import pytest

from modelx_tpu.utils import devmem as jdevmem
from modelx_tpu.utils import promexp as jp
from modelx_tpu.utils import tswheel as jtswheel
from modelx_tpu_torch.utils import devmem as tdevmem
from modelx_tpu_torch.utils import promexp as tp
from modelx_tpu_torch.utils import tswheel as ttswheel
from test_promexp import parse_exposition


def _render(tree_of, **kw) -> str:
    """``tree_of(module)`` rendered by both packages: byte-equal, the port's
    text returned."""
    want = jp.render(tree_of(jp), **kw)
    got = tp.render(tree_of(tp), **kw)
    assert got == want
    return got


def _hist(mod, buckets, values):
    h = mod.Histogram(buckets=buckets)
    for v in values:
        h.observe(v)
    return h.snapshot()


class TestHistogram:
    @pytest.mark.parametrize("buckets,values,want", [
        ((1, 5, 10), (0.5, 0.7, 3, 7), {"1": 2, "5": 3, "10": 4, "+Inf": 4}),
        ((1, 5), (100,), {"1": 0, "5": 0, "+Inf": 1}),
        ((1,), (float("nan"),), {"1": 0, "+Inf": 0}),
        ((10, 1), (2,), {"1": 0, "10": 1, "+Inf": 1}),
    ], ids=["cumulative", "overflow-in-inf", "nan-dropped", "bounds-sorted"])
    def test_snapshot_equal(self, buckets, values, want):
        snap = _hist(tp, buckets, values)
        assert snap == _hist(jp, buckets, values)
        assert snap["buckets"] == want

    def test_bounds_required(self):
        for mod in (jp, tp):
            with pytest.raises(ValueError):
                mod.Histogram(buckets=())

    def test_shape_detector(self):
        for snap in (tp.Histogram().snapshot(), jp.Histogram().snapshot()):
            assert tp.is_histogram_snapshot(snap) and jp.is_histogram_snapshot(snap)
        for node in ({"buckets": {}}, 3):
            assert not tp.is_histogram_snapshot(node) and not jp.is_histogram_snapshot(node)


class TestWantsPrometheus:
    @pytest.mark.parametrize("accept,fmt", [
        ("application/json", "prometheus"), (None, "text"), ("text/plain", "json"),
        ("text/plain; version=0.0.4", ""), ("application/json", ""), (None, None),
        ("*/*", ""), ("TEXT/PLAIN", None), (None, " Prometheus "),
    ])
    def test_same_answers(self, accept, fmt):
        assert tp.wants_prometheus(accept, fmt) == jp.wants_prometheus(accept, fmt)

    def test_content_type_and_escapes_equal(self):
        assert tp.CONTENT_TYPE == jp.CONTENT_TYPE
        ugly = 'u"rl\\with\nnewline'
        assert tp.escape_label_value(ugly) == jp.escape_label_value(ugly)
        assert tp.escape_help(ugly) == jp.escape_help(ugly)


class TestRender:
    def test_counters_and_gauges(self):
        fams = parse_exposition(_render(lambda m: {"requests_total": 3, "depth": 2.5}))
        assert fams["modelx_requests_total"]["type"] == "counter"
        assert fams["modelx_depth"]["samples"][0][2] == 2.5

    def test_label_levels_capture_dynamic_keys(self):
        tree = {"pods": {"http://a:8000": {"inflight": 1}, "http://b:8000": {"inflight": 2}}}
        fams = parse_exposition(_render(lambda m: tree, label_levels={("pods", "*"): "pod"}))
        assert {(s[1]["pod"], s[2]) for s in fams["modelx_pods_inflight"]["samples"]} == {
            ("http://a:8000", 1.0), ("http://b:8000", 2.0)}

    def test_label_level_never_rematches_children(self):
        tree = {"pods": {"http://a": {"queue": {"depth": 4}}}}
        fams = parse_exposition(_render(lambda m: tree, label_levels={("pods", "*"): "pod"}))
        (sample,) = fams["modelx_pods_queue_depth"]["samples"]
        assert sample[1] == {"pod": "http://a"} and sample[2] == 4

    def test_label_escaping_round_trips(self):
        ugly = 'u"rl\\with\nnewline'
        text = _render(lambda m: {"pods": {ugly: {"inflight": 1}}},
                       label_levels={("pods", "*"): "pod"})
        (sample,) = parse_exposition(text)["modelx_pods_inflight"]["samples"]
        assert sample[1]["pod"] == ugly

    def test_name_sanitization(self):
        fams = parse_exposition(_render(lambda m: {"a-b.c": 1, "1xx": 2, "é": 3}))
        assert {"modelx_a_b_c", "modelx_1xx", "modelx__"} <= set(fams)

    def test_histogram_family(self):
        tree_of = lambda m: {"m": {"queue_ms_hist": _hist(m, (1, 10), (0.5, 5))}}  # noqa: E731
        fams = parse_exposition(_render(tree_of, label_levels={("*",): "model"}))
        fam = fams["modelx_queue_ms_hist"]
        assert fam["type"] == "histogram"
        assert [v for n, _, v in fam["samples"] if n.endswith("_bucket")] == [1, 2, 2]
        assert [v for n, _, v in fam["samples"] if n.endswith("_count")] == [2]

    def test_kind_clash_demotes_to_gauge(self):
        tree_of = lambda m: {"a": {"lat": 3}, "b": {"lat": _hist(m, (1,), (0.5,))}}  # noqa: E731
        fams = parse_exposition(_render(tree_of, label_levels={("*",): "m"}))
        assert fams["modelx_lat"]["type"] == "gauge"
        assert {(s[1]["m"], s[2]) for s in fams["modelx_lat"]["samples"]} == {
            ("a", 3.0), ("b", 1.0)}

    def test_non_numeric_leaves_skipped(self):
        fams = parse_exposition(_render(lambda m: {
            "state": "READY", "urls": ["a"], "none": None, "up": True, "n": 1}))
        assert set(fams) == {"modelx_up", "modelx_n"}

    def test_empty_tree_renders_empty(self):
        assert _render(lambda m: {}) == ""

    def test_non_finite_and_float_formatting(self):
        """+/-Inf spell out, NaN leaves are skipped, integral floats print
        as integers below 1e15 and as repr above, others as repr."""
        text = _render(lambda m: {"inf": math.inf, "ninf": -math.inf, "nan": math.nan,
                                  "big": 1e15, "huge": 2.0**60, "third": 1 / 3, "neg": -0.0,
                                  "tiny": 5e-324, "whole": 42.0})
        assert "modelx_inf +Inf" in text and "modelx_ninf -Inf" in text
        assert "modelx_nan" not in text and "modelx_whole 42\n" in text

    def test_histogram_without_inf_bucket(self):
        snap = {"buckets": {"2.5": 1, "1": 0}, "sum": 2.0, "count": 1}
        text = _render(lambda m: {"lat": dict(snap)})
        assert 'modelx_lat_bucket{le="+Inf"} 1' in text
        assert text.index('le="1"') < text.index('le="2.5"')

    def test_every_line_is_comment_or_sample(self):
        def tree_of(m):
            return {
                "requests_total": 10,
                "router": {"sticky_entries": 5, "routes": {"p1": 7}},
                "pods": {"http://p:1": {"inflight": 0,
                                        "ttft_ms_hist": _hist(m, m.DEFAULT_MS_BUCKETS, (12.5,))}},
            }
        fams = parse_exposition(_render(tree_of, label_levels={
            ("router", "routes", "*"): "pod", ("pods", "*"): "pod"}))
        assert fams["modelx_pods_ttft_ms_hist"]["type"] == "histogram"


class TestWindowedRateFamilies:
    def test_rateset_snapshot_renders_as_gauges(self):
        def tree_of(m):
            t = [1000.0]
            ts = ttswheel if m is tp else jtswheel
            rs = ts.RateSet(("requests", "sheds"), _clock=lambda: t[0])
            for _ in range(30):
                rs.mark("requests")
            t[0] += 10
            return {"rates": rs.snapshot()}
        fams = parse_exposition(_render(tree_of))
        assert fams["modelx_rates_requests_per_s_1m"]["samples"][0][2] == 0.5

    def test_devmem_family_skips_source_string(self):
        """Each package's device sample renders through both renderers
        alike; the ``source`` string stays out of the text view."""
        for sample in (tdevmem.raw_sample(), jdevmem.raw_sample()):
            text = _render(lambda m: {"device": sample})
            fams = parse_exposition(text)
            assert fams["modelx_device_hbm_bytes_in_use"]["type"] == "gauge"
            assert not any("source" in name for name in fams)


def _get(url: str, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers["Content-Type"], r.read()


class TestRegistrySurface:
    def test_registry_metrics_parse_and_count(self):
        from modelx_tpu.registry.server import free_port
        from modelx_tpu_torch.registry.fs import MemoryFSProvider
        from modelx_tpu_torch.registry.server import Options, RegistryServer
        from modelx_tpu_torch.registry.store_fs import FSRegistryStore
        from modelx_tpu_torch.types import Digest

        srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"),
                             store=FSRegistryStore(MemoryFSProvider()))
        base = srv.serve_background()
        try:
            data = b"weights"
            req = urllib.request.Request(f"{base}/r/demo/blobs/{Digest.from_bytes(data)}",
                                         data=data, method="PUT")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 201
            ctype, raw = _get(f"{base}/metrics")
            assert ctype == jp.CONTENT_TYPE
            counters = dict(sorted(srv.registry.metrics.counters.items()))
            assert raw.decode() == jp.render(counters)
            fams = parse_exposition(raw.decode())
            assert fams["modelx_blob_put_total"]["samples"][0][2] == 1
            assert fams["modelx_blob_put_total"]["type"] == "counter"
        finally:
            srv.shutdown()


class TestPodSurface:
    def test_pod_metrics_negotiation_and_json_compat(self, tmp_path):
        """The pod's /metrics: JSON by default; the exposition, with the
        model as a label, on ?format=prometheus or Accept: text/plain; the
        JSON unchanged around it."""
        import numpy as np

        from modelx_tpu.dl import safetensors as jst
        from modelx_tpu.registry.server import free_port
        from modelx_tpu_torch.dl import serve_main
        from modelx_tpu_torch.models import gpt2

        import torch

        cfg = gpt2.GPT2Config.tiny()
        params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
        jst.write_safetensors(str(tmp_path / "model.safetensors"),
                              {k: v.numpy() for k, v in params.items()})
        sset, httpd = serve_main.start([
            "--model", f"g={tmp_path}", "--device", "cpu", "--dtype", "float32",
            "--listen", f"127.0.0.1:{free_port()}", "--trace-dir", str(tmp_path / "trace")])
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            req = urllib.request.Request(base + "/v1/forward", data=json.dumps(
                {"tokens": np.arange(5)[None].tolist()}).encode())
            urllib.request.urlopen(req, timeout=60).read()
            ctype, before = _get(base + "/metrics")
            assert ctype == "application/json"
            ctype, prom = _get(base + "/metrics?format=prometheus")
            assert ctype == jp.CONTENT_TYPE
            fams = parse_exposition(prom.decode())
            assert fams["modelx_requests"]["samples"] == [("modelx_requests", {"model": "g"}, 1)]
            # the top level is the model label (the JAX sidecar's rule), so
            # the pod-level trees read as model="rates", "pool", ...
            ((_, labels, rate),) = fams["modelx_requests_per_s_1m"]["samples"]
            assert labels == {"model": "rates"} and rate == round(1 / 60, 4)
            assert parse_exposition(_get(base + "/metrics",
                                         {"Accept": "text/plain"})[1].decode())
            after = json.loads(_get(base + "/metrics")[1])
            assert set(after) == set(json.loads(before)) >= {"g", "pool", "rates",
                                                             "control_plane", "device"}
        finally:
            httpd.shutdown()
            httpd.server_close()
