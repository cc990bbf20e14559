"""The port's model pool (modelx_tpu_torch.dl.lifecycle and the admin
surface of dl/serve.py) against the JAX package's, on the CPU.

A JAX ``ServerSet`` pod and a port pod, built as tests/test_lifecycle.py
builds them (tiny fp32 llamas, dp=1, ``max_seq_len`` 64, a prefix cache of
4), take the same sequence of admin calls and requests: footprint
estimates; load, route, drain and unload; validation 400/403/409; the
refusal to unload a model in transition or the last one; 503 +
``Retry-After`` on both surfaces while PULLING or LOADING (the loads held
at a gate); a crashed load that leaves the pool serving with the slot
retryable; concurrent boot loads, one faulting; admin auth 401/403; the
blob-cache-warm second pull through the port's registry; the retryable 507
of a registry outage; and the SIGTERM drain of ``serve_main`` in a child
process. The pods must answer equal statuses, headers and JSON bodies.

Masked, as clock or device readings: ``state_age_s`` and
``drain_seconds`` (lifecycle entries), ``hbm_bytes_measured``,
``hbm_measured_vs_reserved_delta`` and ``hbm_measured_source`` (the
device's own accounting: a live-buffer census in JAX on the CPU, no CUDA
context in the port), and the control-plane block's ``last_ok_age_s`` and
``last_failure_age_s``. Headers are compared without ``Date``,
``Content-Length`` (it follows the masked fields' lengths) and the JAX
sidecar's request-id, attempt and timing echo (the observability slice).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu.dl import initializer as jinit
from modelx_tpu.dl import lifecycle as jlc
from modelx_tpu.dl import manifest_cache as jmc
from modelx_tpu.dl import serve as jserve
from modelx_tpu.dl.blob_cache import BlobCache as JaxBlobCache
from modelx_tpu.registry.server import free_port
from modelx_tpu.testing import faults
from modelx_tpu_torch.dl import initializer as tinit
from modelx_tpu_torch.dl import lifecycle as tlc
from modelx_tpu_torch.dl import manifest_cache as tmc
from modelx_tpu_torch.dl import safetensors as tst
from modelx_tpu_torch.dl import serve as tserve
from modelx_tpu_torch.dl.blob_cache import BlobCache
from modelx_tpu_torch.registry.fs import LocalFSProvider
from modelx_tpu_torch.registry.server import Options, RegistryServer
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from tests.test_torch_serve import _write_tiny_fp32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MASKED = ("state_age_s", "drain_seconds", "hbm_bytes_measured",
          "hbm_measured_vs_reserved_delta", "hbm_measured_source",
          "last_ok_age_s", "last_failure_age_s")
PROMPT = [[1, 2, 3]]


def write_tiny(dirpath: str, seed: int = 0) -> None:
    """tests/test_lifecycle.py's write_tiny in fp32 with llama-3's
    rope_theta; ``seed`` varies the weights."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from modelx_tpu.dl import safetensors as jst
    from modelx_tpu.models import llama as jl

    if seed == 0:
        _write_tiny_fp32(dirpath)
        return
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), rope_theta=500000.0, dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    os.makedirs(dirpath, exist_ok=True)
    jst.write_safetensors(os.path.join(dirpath, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pool-models")
    dirs = {}
    for name, seed in (("a", 0), ("b", 1), ("c", 2)):
        write_tiny(str(root / name), seed)
        dirs[name] = str(root / name)
    # "bad": a valid safetensors file whose tensors match no family: the
    # pull succeeds, the load crashes
    (root / "bad").mkdir()
    tst.write_safetensors(str(root / "bad" / "model.safetensors"),
                          {"mystery.weight": np.zeros((4, 4), np.float32)})
    dirs["bad"] = str(root / "bad")
    (root / "empty").mkdir()
    dirs["empty"] = str(root / "empty")
    return dirs


@pytest.fixture(scope="module")
def registry(model_dirs, tmp_path_factory):
    """The port's registry on a local FS store; the JAX client pushes."""
    root = tmp_path_factory.mktemp("pool-registry")
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"),
                         store=FSRegistryStore(LocalFSProvider(str(root))))
    base = srv.serve_background()
    for name in ("a", "b", "bad"):
        JaxClient(base, quiet=True).push(f"library/{name}", "v1", model_dirs[name])
    yield base
    srv.shutdown()


def jax_server(model_dir, name):
    return jserve.ModelServer(model_dir, mesh_spec="dp=1", dtype="float32", max_seq_len=64,
                              name=name, prefix_cache_size=4)


def port_server(model_dir, name):
    return tserve.ModelServer(model_dir, dtype="float32", device="cpu", max_seq_len=64,
                              name=name, prefix_cache_size=4)


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in MASKED else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _http(port, method, path, body=None, headers=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    keep = {k: v for k, v in hdrs.items()
            if k not in ("Date", "Content-Length")
            and not k.startswith(("X-ModelX-Request-Id", "X-ModelX-Attempt", "X-ModelX-Timing-"))}
    ctype = hdrs.get("Content-Type", "")
    parsed = _mask(json.loads(raw)) if ctype == "application/json" else raw
    return status, keep, parsed


def _first_difference(got, want, where=""):
    """Where two JSON-like values first differ, for the assertion message."""
    if isinstance(got, dict) and isinstance(want, dict):
        if list(got) != list(want):
            return f"{where}: keys {list(got)} != {list(want)}"
        for k in want:
            if got[k] != want[k]:
                return _first_difference(got[k], want[k], f"{where}/{k}")
    if isinstance(got, (list, tuple)) and isinstance(want, (list, tuple)) and len(got) == len(
            want):
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                return _first_difference(g, w, f"{where}[{i}]")
    return f"{where}: {got!r} != {want!r}"


class Pair:
    """A JAX pod and a port pod over the same model dirs and options."""

    def __init__(self, jsset, tsset, load=True):
        self.j, self.t = jsset, tsset
        self.jhttpd = jserve.serve(jsset, listen=f"127.0.0.1:{free_port()}")
        self.thttpd = tserve.serve(tsset, listen=f"127.0.0.1:{free_port()}")
        self.ports = (self.jhttpd.server_address[1], self.thttpd.server_address[1])
        if load:
            jsset.load_all()
            tsset.load_all()

    @classmethod
    def build(cls, dirs, names=("a",), tmp=None, load=True, **kw):
        jkw, tkw = dict(kw), dict(kw)
        if tmp is not None:
            for side, d in (("jax", jkw), ("port", tkw)):
                d.setdefault("staging_root", str(tmp / f"{side}-staging"))
                if d.get("host_state_budget_bytes") or d.get("disk_state_budget_bytes"):
                    d.setdefault("state_spool_dir", str(tmp / f"{side}-spool"))
        jsset = jserve.ServerSet({n: jax_server(dirs[n], n) for n in names}, **jkw)
        tsset = tserve.ServerSet({n: port_server(dirs[n], n) for n in names}, **tkw)
        return cls(jsset, tsset, load=load)

    def both(self, method, path, body=None, headers=None):
        return tuple(_http(p, method, path, body, headers) for p in self.ports)

    def agree(self, method, path, body=None, headers=None):
        want, got = self.both(method, path, body, headers)
        assert got == want, (method, path, _first_difference(got, want))
        return got

    def pools(self):
        return self.j.pool, self.t.pool

    def close(self):
        for h in (self.jhttpd, self.thttpd):
            h.shutdown()
            h.server_close()


@pytest.fixture
def fresh_trackers():
    """Both packages' control-plane trackers from zero (process-wide)."""
    for h in (jmc.health(), tmc.health()):
        h.reset()
    yield
    for h in (jmc.health(), tmc.health()):
        h.reset()


def _wait_state(pools, name, state, timeout=60.0):
    """Wait for the entry's own state. ``states()`` is not polled: its
    reconciliation of a LOADING entry whose server just turned ready races
    the load thread's end, and the reference then drops the load."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        entries = [p.entries.get(name) for p in pools]
        if all(e is not None and e.state == state for e in entries):
            return
        time.sleep(0.02)
    raise AssertionError(f"{name} never reached {state}: {[p.states() for p in pools]}")


def test_a_status_read_racing_the_load_end_keeps_the_load(model_dirs, tmp_path, monkeypatch):
    """A GET /admin/models that lands between the server turning ready and
    the load thread marking it READY flips the entry READY itself. The
    reference's load thread then takes it for an unload race and frees the
    server (the name 404s while it reads READY); the port keeps it."""
    tsset = tserve.ServerSet({"a": port_server(model_dirs["a"], "a")}, allow_admin_load=True,
                             staging_root=str(tmp_path / "staging"))
    tsset.load_all()
    real = tserve.ModelServer.load

    def load_then_read(server):
        out = real(server)
        tsset.pool.states()  # the status read, inside the window
        return out

    monkeypatch.setattr(tserve.ModelServer, "load", load_then_read)
    snap = tsset.pool.request_load("b", model_dir=model_dirs["b"], wait=True)
    assert snap["b"]["state"] == "READY" and "b" in tsset.servers
    assert tsset.servers["b"].params is not None
    assert tsset.pool.states()["b"]["loads_total"] == 1


# -- footprint estimates --------------------------------------------------------------


def test_footprint_estimates_equal_jax(model_dirs, registry):
    for d in (model_dirs["a"], model_dirs["empty"]):
        assert tlc.estimate_dir_bytes(d) == jlc.estimate_dir_bytes(d)
    assert tlc.estimate_dir_bytes(model_dirs["a"]) == os.path.getsize(
        os.path.join(model_dirs["a"], "model.safetensors"))
    ref = f"{registry}/library/a@v1"
    assert tlc.estimate_ref_bytes(ref) == jlc.estimate_ref_bytes(ref) > 0


# -- load, route, drain, unload -----------------------------------------------------


def test_load_route_drain_unload_agrees(model_dirs, registry, tmp_path, fresh_trackers):
    """Serve a; admin-load b from the registry while a streams; route to
    b; DELETE a with a request held in flight (409 while draining, then
    404); every answer equal between the pods."""
    pair = Pair.build(model_dirs, tmp=tmp_path, allow_admin_load=True)
    try:
        pair.agree("GET", "/admin/models")
        assert pair.agree("POST", "/v1/b/generate",
                          {"tokens": PROMPT, "max_new_tokens": 2})[0] == 404
        streams = {}

        def stream(port):
            streams[port] = _http(port, "POST", "/v1/generate",
                                  {"tokens": PROMPT, "max_new_tokens": 12, "stream": True})

        threads = [threading.Thread(target=stream, args=(p,)) for p in pair.ports]
        for t in threads:
            t.start()
        got = pair.agree("POST", "/admin/models",
                         {"name": "b", "ref": f"{registry}/library/b@v1", "wait": True})
        assert got[0] == 200 and got[2]["b"]["state"] == "READY"
        assert got[2]["b"]["load_source"] == "registry"
        for t in threads:
            t.join(timeout=120)
        assert streams[pair.ports[0]] == streams[pair.ports[1]]
        assert streams[pair.ports[1]][0] == 200

        assert pair.agree("POST", "/v1/b/generate",
                          {"tokens": PROMPT, "max_new_tokens": 4})[0] == 200
        pair.agree("POST", "/v1/b/forward", {"tokens": PROMPT})
        pair.agree("POST", "/v1/completions", {"model": "b", "prompt": "x"})
        admin = pair.agree("GET", "/admin/models")[2]
        assert set(admin["serving"]) == {"a", "b"} and admin["pool"]["hbm_reserved_bytes"] > 0
        _models_agree(pair)

        # DELETE a with a request in flight: the drain waits for it
        for pool in pair.pools():
            pool.enter("a")
        deletes = {}

        def delete(port):
            deletes[port] = _http(port, "DELETE", "/admin/models/a")

        threads = [threading.Thread(target=delete, args=(p,)) for p in pair.ports]
        for t in threads:
            t.start()
        _wait_state(pair.pools(), "a", "DRAINING")
        got = pair.agree("POST", "/v1/a/generate", {"tokens": PROMPT, "max_new_tokens": 2})
        assert got[0] == 409 and "draining" in got[2]["error"]
        pair.agree("POST", "/v1/chat/completions",
                   {"model": "a", "messages": [{"role": "user", "content": "x"}]})
        pair.agree("GET", "/admin/models")
        for pool in pair.pools():
            pool.exit("a")
        for t in threads:
            t.join(timeout=60)
        assert deletes[pair.ports[0]] == deletes[pair.ports[1]]
        assert deletes[pair.ports[1]][2]["a"]["state"] == "UNLOADED"
        assert pair.agree("POST", "/v1/a/generate",
                          {"tokens": PROMPT, "max_new_tokens": 2})[0] == 404
        a_server = pair.t.pool.entries["a"].server
        assert a_server is None and "a" not in pair.t.servers and pair.t.default == "b"
        assert pair.agree("POST", "/v1/generate", {"tokens": PROMPT})[0] == 200
        pair.agree("GET", "/admin/models")
        _models_agree(pair)
        # the drained entry is history: the last serving model stays
        got = pair.agree("DELETE", "/admin/models/b")
        assert got[0] == 409 and "last serving model" in got[2]["error"]
        assert pair.agree("DELETE", "/admin/models/a")[2] == {"a": {"state": "DELETED"}}
        assert pair.agree("DELETE", "/admin/models/a")[0] == 404
    finally:
        pair.close()


def _models_agree(pair):
    """/v1/models: the lifecycle entries, the OpenAI rows and the default
    equal (the per-model load stats are each package's own)."""
    want, got = (_http(p, "GET", "/v1/models")[2] for p in pair.ports)
    assert got["data"] == want["data"] and got["default"] == want["default"]
    assert list(got["models"]) == list(want["models"])
    for n in want["models"]:
        assert got["models"][n].get("lifecycle") == want["models"][n].get("lifecycle"), n
        assert got["models"][n]["ready"] == want["models"][n]["ready"]
        assert got["models"][n].get("error") == want["models"][n].get("error")


def test_unloaded_model_freed_and_flags_inert(model_dirs, tmp_path):
    """The port's free path drops params, decoders, the speculative
    decoder and the prefix cache's KV; a runtime-loaded server inherits
    the boot set's template."""
    tsset = tserve.ServerSet({"a": port_server(model_dirs["a"], "a")}, allow_admin_load=True,
                             staging_root=str(tmp_path / "staging"))
    tsset.load_all()
    snap = tsset.pool.request_load("b", model_dir=model_dirs["b"], wait=True)
    assert snap["b"]["state"] == "READY" and snap["b"]["load_source"] == "dir"
    b = tsset.servers["b"]
    assert (b.device, b.max_seq_len, b.dtype, b._prefix_cache.capacity) == (
        tsset.servers["a"].device, 64, tsset.servers["a"].dtype, 4)
    list(b.generate_stream(np.asarray(PROMPT, np.int32), max_new_tokens=3, chunk_size=2))
    assert b._decoders and b._prefix_cache.stats()["entries"] == 1
    tsset.pool.request_unload("b", wait=True)
    assert b.params is None and not b.ready and not b._decoders
    assert b._spec_decoder is None and b._prefix_cache.stats()["entries"] == 0
    assert tsset.pool.states()["b"]["drain_seconds"] is not None


# -- routing during transitions -----------------------------------------------------


class _Gate:
    """Holds both packages' loads (or pulls) of one model name until
    released, so the PULLING/LOADING answers are deterministic."""

    def __init__(self, monkeypatch, name):
        self.release = threading.Event()
        self.name = name
        for cls in (jserve.ModelServer, tserve.ModelServer):
            real = cls.load

            def load(server, _real=real):
                if server.name == self.name:
                    assert self.release.wait(60)
                return _real(server)

            monkeypatch.setattr(cls, "load", load)
        for mod in (jinit, tinit):
            real_pull = mod.pull_model

            def pull(uri, dest, _real=real_pull, **kw):
                if f"/{self.name}@" in uri or self.name == "*":
                    assert self.release.wait(60)
                return _real(uri, dest, **kw)

            monkeypatch.setattr(mod, "pull_model", pull)


@pytest.mark.parametrize("how", ["model_dir", "ref"])
def test_pulling_and_loading_answer_503_retry_after_both_surfaces(
        model_dirs, registry, tmp_path, monkeypatch, how, fresh_trackers):
    pair = Pair.build(model_dirs, tmp=tmp_path, allow_admin_load=True)
    gate = _Gate(monkeypatch, "b")
    try:
        src = ({"model_dir": model_dirs["b"]} if how == "model_dir"
               else {"ref": f"{registry}/library/b@v1"})
        got = pair.agree("POST", "/admin/models", {"name": "b", **src})
        state = "LOADING" if how == "model_dir" else "PULLING"
        assert got[0] == 202 and got[2]["b"]["state"] == state
        got = pair.agree("POST", "/v1/b/generate", {"tokens": PROMPT, "max_new_tokens": 1})
        assert got[0] == 503 and got[1]["Retry-After"] == "2"
        assert state.lower() in got[2]["error"]
        got = pair.agree("POST", "/v1/completions", {"model": "b", "prompt": "hi"})
        assert got[0] == 503 and got[2]["error"]["type"] == "server_error"
        pair.agree("POST", "/v1/chat/completions",
                   {"model": "b", "messages": [{"role": "user", "content": "x"}],
                    "stream": True})
        pair.agree("GET", "/admin/models")
        _models_agree(pair)
        # a second load of a name in transition, and its unload: 409
        got = pair.agree("POST", "/admin/models", {"name": "b", **src})
        assert got[0] == 409
        got = pair.agree("DELETE", "/admin/models/b")
        assert got[0] == 409 and "wait for the load" in got[2]["error"]
        # the other tenant serves meanwhile
        assert pair.agree("POST", "/v1/a/forward", {"tokens": PROMPT})[0] == 200
        gate.release.set()
        _wait_state(pair.pools(), "b", "READY")
        pair.agree("GET", "/admin/models")
        assert pair.agree("POST", "/v1/b/forward", {"tokens": PROMPT})[0] == 200
    finally:
        gate.release.set()
        pair.close()


def test_boot_time_still_loading_503_and_unknown_404(model_dirs):
    """A pod whose boot set has not loaded: 503 + Retry-After on both
    surfaces and /healthz; an unknown name 404s."""
    pair = Pair.build(model_dirs, load=False)
    try:
        for path, body in (("/v1/generate", {"tokens": [[1]], "max_new_tokens": 1}),
                           ("/v1/completions", {"prompt": "hi"}),
                           ("/v1/nope/generate", {"tokens": [[1]]})):
            pair.agree("POST", path, body)
        got = pair.agree("GET", "/healthz")
        assert got[0] == 503 and got[1]["Retry-After"] == "2"
        pair.agree("GET", "/livez")
        pair.agree("GET", "/admin/models")
    finally:
        pair.close()


# -- validation, refusals, auth -------------------------------------------------------


def test_load_validation_400_403_409(model_dirs, tmp_path):
    pair = Pair.build(model_dirs, tmp=tmp_path, allow_admin_load=True)
    closed = Pair.build(model_dirs, load=False)
    try:
        for body in ({"name": "x"}, {"name": "x", "ref": "r", "model_dir": "d"},
                     {"name": "bad/name", "model_dir": model_dirs["a"]},
                     {"name": "", "model_dir": model_dirs["a"]},
                     {"name": "x", "model_dir": model_dirs["empty"]},
                     {"name": "x", "ref": "not a ref at all"},
                     {"name": "a", "model_dir": model_dirs["a"]}):
            got = pair.agree("POST", "/admin/models", body)
            assert got[0] in (400, 409), body
        # admin loading off: reads answer, mutations 403
        assert closed.agree("GET", "/admin/models")[0] == 200
        got = closed.agree("POST", "/admin/models", {"name": "b", "model_dir": "/x"})
        assert got[0] == 403
        assert closed.agree("DELETE", "/admin/models/a")[0] == 403
        assert closed.agree("DELETE", "/admin/nothing/a")[0] == 404
    finally:
        pair.close()
        closed.close()


def test_unload_refuses_transitional_and_last(model_dirs, tmp_path):
    """The reference test's sequence on both pools: a mid-load entry and
    the last serving model refuse (409), an unknown name 404s, a FAILED
    entry and a FAILED boot tenant's zombie server are deleted."""
    jsset = jserve.ServerSet({"a": jax_server(model_dirs["a"], "a")}, allow_admin_load=True,
                             staging_root=str(tmp_path / "j"))
    tsset = tserve.ServerSet({"a": port_server(model_dirs["a"], "a")}, allow_admin_load=True,
                             staging_root=str(tmp_path / "t"))
    for sset, mod, make in ((jsset, jlc, jax_server), (tsset, tlc, port_server)):
        sset.servers["a"].ready = True  # READY without paying a real load
        pool = sset.pool
        e = mod.ModelEntry("mid")
        e.to(mod.LOADING)
        pool.entries["mid"] = e
        outs = []
        for name in ("mid", "a", "ghost"):
            with pytest.raises(mod.PoolError) as ei:
                pool.request_unload(name)
            outs.append((ei.value.status, str(ei.value), ei.value.headers))
        del pool.entries["mid"]
        f = mod.ModelEntry("flop")
        f.to(mod.FAILED, error="boom")
        pool.entries["flop"] = f
        outs.append(pool.request_unload("flop"))
        z = make(model_dirs["b"], "z")
        sset.add_server("z", z)
        ze = mod.ModelEntry("z")
        ze.server = z
        ze.to(mod.FAILED, error="boom")
        pool.entries["z"] = ze
        outs.append(pool.request_unload("z"))
        assert "z" not in sset.servers and "z" not in pool.entries and "flop" not in pool.entries
        sset.outs = outs
    assert tsset.outs == jsset.outs
    assert [o[0] for o in tsset.outs[:3]] == [409, 409, 404]


def test_admin_auth_401_403(model_dirs, tmp_path):
    pair = Pair.build(model_dirs, tmp=tmp_path, load=False, allow_admin_load=True,
                      admin_tokens=("s3cret",))
    try:
        for method, path, body in (("GET", "/admin/models", None),
                                   ("POST", "/admin/models", {"name": "x"}),
                                   ("DELETE", "/admin/models/a", None),
                                   ("GET", "/debug/flightrec", None)):
            assert pair.agree(method, path, body)[0] == 401
            for token in ("wrong", "s3cre", "s3cret "):
                assert pair.agree(method, path, body,
                                  {"Authorization": f"Bearer {token}"})[0] == 401
        hdr = {"Authorization": "Bearer s3cret"}
        assert pair.agree("GET", "/admin/models", headers=hdr)[0] == 200
        assert pair.agree("POST", "/admin/models", {"name": "x"}, hdr)[0] == 400
        _models_agree(pair)  # the non-admin surface stays open
    finally:
        pair.close()


# -- budget, eviction, crashes ------------------------------------------------------


def test_budget_refuses_then_evicts_lru(model_dirs, registry, tmp_path, fresh_trackers):
    """A load over --hbm-budget-bytes refuses with 507; with evict_idle it
    evicts the least recently used idle model and lands READY."""
    pair = Pair.build(model_dirs, tmp=tmp_path, allow_admin_load=True)
    try:
        got = pair.agree("POST", "/admin/models",
                         {"name": "b", "ref": f"{registry}/library/b@v1", "wait": True})
        assert got[2]["b"]["state"] == "READY"
        est = tlc.estimate_dir_bytes(model_dirs["c"])
        for pool in pair.pools():
            pool.hbm_budget_bytes = pool.reserved_bytes() + est // 2
        got = pair.agree("POST", "/admin/models", {"name": "c", "model_dir": model_dirs["c"],
                                                    "wait": True})
        assert got[0] == 507 and "budget" in got[2]["error"] and "Retry-After" in got[1]
        # a load no demotion can make room for: the hard refusal
        for pool in pair.pools():
            pool.hbm_budget_bytes = 1
        got = pair.agree("POST", "/admin/models", {"name": "c", "model_dir": model_dirs["c"]})
        assert got[0] == 507 and "hard refusal" in got[2]["error"]
        assert "Retry-After" not in got[1]
        # b recently used, so a is the LRU victim
        pair.agree("POST", "/v1/b/forward", {"tokens": PROMPT})
        for pool in pair.pools():
            pool.hbm_budget_bytes = pool.reserved_bytes() + est // 2
            pool.evict_idle = True
        got = pair.agree("POST", "/admin/models", {"name": "c", "model_dir": model_dirs["c"],
                                                    "wait": True})
        assert got[0] == 200 and got[2]["c"]["state"] == "READY"
        admin = pair.agree("GET", "/admin/models")[2]
        assert admin["models"]["a"]["state"] == "UNLOADED"
        assert admin["models"]["a"]["evictions_total"] == 1
        assert admin["pool"]["evictions_total"] == 1
        assert pair.agree("POST", "/v1/a/forward", {"tokens": PROMPT})[0] == 404
        assert pair.agree("POST", "/v1/c/forward", {"tokens": PROMPT})[0] == 200
        _models_agree(pair)
    finally:
        pair.close()


def test_crashed_load_leaves_pool_serving_and_slot_retryable(model_dirs, tmp_path,
                                                              monkeypatch):
    """A load that crashes (a fault stub in both packages' load) lands
    FAILED with its reason while the pool serves; a re-POST retries the
    slot."""
    pair = Pair.build(model_dirs, tmp=tmp_path, allow_admin_load=True)
    for cls in (jserve.ModelServer, tserve.ModelServer):
        real = cls.load

        def load(server, _real=real):
            if server.name == "x" and server.model_dir == model_dirs["c"]:
                raise faults.InjectedCrash("mid-load fault")
            return _real(server)

        monkeypatch.setattr(cls, "load", load)
    try:
        got = pair.agree("POST", "/admin/models",
                         {"name": "x", "model_dir": model_dirs["c"], "wait": True})
        assert got[0] == 200 and got[2]["x"]["state"] == "FAILED"
        assert got[2]["x"]["error"] == "mid-load fault"
        assert pair.agree("POST", "/v1/generate", {"tokens": PROMPT})[0] == 200
        got = pair.agree("POST", "/v1/x/generate", {"tokens": PROMPT, "max_new_tokens": 1})
        assert got[0] == 503 and "failed to load" in got[2]["error"]
        pair.agree("POST", "/v1/completions", {"model": "x", "prompt": "hi"})
        got = pair.agree("GET", "/healthz")
        assert got[0] == 200 and got[2]["status"] == "degraded"
        _models_agree(pair)
        pair.agree("GET", "/admin/models")
        got = pair.agree("POST", "/admin/models",
                         {"name": "x", "model_dir": model_dirs["b"], "wait": True})
        assert got[2]["x"]["state"] == "READY"
        assert pair.agree("POST", "/v1/x/generate", {"tokens": PROMPT})[0] == 200
        assert pair.agree("GET", "/healthz")[2]["status"] == "ok"
    finally:
        pair.close()


def test_bad_checkpoint_fails_with_the_family_reason(model_dirs, registry, tmp_path,
                                                     fresh_trackers):
    """A checkpoint whose tensors match no family pulls and then fails to
    load. The FAILED reason is each package's family error, which lists
    its own supported families (the port serves llama and qwen2), so the
    reasons agree up to that list."""
    pair = Pair.build(model_dirs, tmp=tmp_path, allow_admin_load=True)
    try:
        want, got = pair.both("POST", "/admin/models",
                              {"name": "x", "ref": f"{registry}/library/bad@v1", "wait": True})
        assert got[0] == want[0] == 200
        reasons = [r[2]["x"].pop("error").split("; supported:")[0] for r in (want, got)]
        assert reasons[1] == reasons[0] and "cannot determine model family" in reasons[0]
        assert got == want
        assert pair.agree("POST", "/v1/generate", {"tokens": PROMPT})[0] == 200
    finally:
        pair.close()


def test_concurrent_load_fault_degrades_only_faulted(model_dirs, monkeypatch):
    """--concurrent-load with b's load faulting: only b is FAILED, /healthz
    reports the degraded set, a serves, b answers 503 with the reason."""
    for cls in (jserve.ModelServer, tserve.ModelServer):
        real = cls.load

        def load(server, _real=real):
            if server.name == "b":
                raise faults.InjectedCrash("mid-load fault")
            return _real(server)

        monkeypatch.setattr(cls, "load", load)
    pair = Pair.build(model_dirs, names=("a", "b"), load=False)
    try:
        for sset in (pair.j, pair.t):
            sset.load_all(concurrent=True)
            assert sset.servers["a"].ready and not sset.servers["b"].ready
            assert sset.servers["b"].params is None and sset.ready
        got = pair.agree("GET", "/healthz")
        assert got[0] == 200 and got[2]["failed"] == {"b": "mid-load fault"}
        _models_agree(pair)
        pair.agree("GET", "/admin/models")
        assert pair.agree("POST", "/v1/a/generate", {"tokens": PROMPT})[0] == 200
        got = pair.agree("POST", "/v1/b/generate", {"tokens": PROMPT})
        assert got[0] == 503 and "failed to load" in got[2]["error"]
    finally:
        pair.close()


def test_concurrent_load_all_ready_and_all_failing_raises(model_dirs, tmp_path):
    tsset = tserve.ServerSet({n: port_server(model_dirs[n], n) for n in ("a", "b")})
    stats = tsset.load_all(concurrent=True)
    assert set(stats) == {"a", "b"} and tsset.ready
    assert {s["state"] for s in tsset.pool.states().values()} == {"READY"}
    for mod, make in ((jserve, jax_server), (tserve, port_server)):
        sset = mod.ServerSet({"a": make(model_dirs["empty"], "a")})
        with pytest.raises(RuntimeError, match="failed"):
            sset.load_all()
        assert sset.pool.states()["a"]["state"] == "FAILED"


# -- registry: warm pulls and outages -------------------------------------------------


def test_pull_is_blob_cache_warm_second_time(registry, tmp_path):
    """pull_model through the port's registry, twice, into each package's
    blob cache: the same hit and admit counts, the same files."""
    import filecmp

    ref = f"{registry}/library/a@v1"
    outs = []
    for side, pull, cache_cls in (("jax", jinit.pull_model, JaxBlobCache),
                                  ("port", tinit.pull_model, BlobCache)):
        cache = cache_cls(str(tmp_path / side / "cache"))
        s1 = pull(ref, str(tmp_path / side / "d1"), cache=cache)
        s2 = pull(ref, str(tmp_path / side / "d2"), cache=cache)
        assert s1["cache_hits"] == 0 and s1["cache_admitted"] >= 1 and s2["cache_hits"] >= 1
        assert filecmp.cmp(str(tmp_path / side / "d1" / "model.safetensors"),
                           str(tmp_path / side / "d2" / "model.safetensors"), shallow=False)
        outs.append({k: (s1[k], s2[k]) for k in ("cache_hits", "cache_admitted", "source")})
    assert outs[1] == outs[0]


def test_pool_ref_load_uses_the_injected_cache(model_dirs, registry, tmp_path):
    tsset = tserve.ServerSet({"a": port_server(model_dirs["a"], "a")}, allow_admin_load=True,
                             staging_root=str(tmp_path / "staging"))
    tsset.pool.blob_cache = BlobCache(str(tmp_path / "cache"))
    tsset.load_all()
    snap = tsset.pool.request_load("b", ref=f"{registry}/library/b@v1", wait=True)
    assert snap["b"]["state"] == "READY"
    assert tsset.pool.blob_cache.stats["admitted"] >= 1
    assert not os.listdir(tmp_path / "staging") or all(
        n.startswith("b-") for n in os.listdir(tmp_path / "staging"))
    tsset.pool.request_unload("b", wait=True)
    assert not os.listdir(tmp_path / "staging")  # the pool-owned staging dir is removed


def test_registry_outage_is_the_retryable_507(model_dirs, tmp_path, fresh_trackers):
    """A ref whose registry does not answer: 507 + Retry-After 5 on both
    pods. The message ends in each HTTP library's own connection error
    (requests in JAX, http.client in the port), compared up to it."""
    pair = Pair.build(model_dirs, tmp=tmp_path, load=False, allow_admin_load=True)
    try:
        ref = f"http://127.0.0.1:{free_port()}/library/a@v1"
        want, got = pair.both("POST", "/admin/models", {"name": "x", "ref": ref})
        assert got[0] == want[0] == 507 and got[1] == want[1]
        assert got[1]["Retry-After"] == "5"
        prefix = f"registry unreachable and no pinned manifest for {ref!r}: UNKNOWN: request failed"
        assert got[2]["error"].startswith(prefix) and want[2]["error"].startswith(prefix)
        assert "x" not in pair.t.pool.entries and "x" not in pair.j.pool.entries
    finally:
        pair.close()


# -- the SIGTERM drain --------------------------------------------------------------


def _spawn_serve(model_dir, port, *extra):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "modelx_tpu_torch.dl.serve_main", "--model", f"m={model_dir}",
         "--device", "cpu", "--dtype", "float32", "--listen", f"127.0.0.1:{port}", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait_healthy(proc, port, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"serve_main exited {proc.returncode}: {proc.stdout.read()}")
        try:
            if _http(port, "GET", "/healthz", timeout=5)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("serve_main never became healthy")


class _SlowStream:
    """A streamed /v1/generate read one line at a time, slowly."""

    def __init__(self, port, n):
        body = json.dumps({"tokens": PROMPT, "max_new_tokens": n, "stream": True}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        self.resp = urllib.request.urlopen(req, timeout=120)
        self.first = self.resp.readline()

    def rest(self) -> bytes:
        return self.first + self.resp.read()


def test_sigterm_drains_the_in_flight_stream(model_dirs):
    """serve_main --drain-grace in a child process: SIGTERM mid-stream ->
    /healthz 503 "draining" without Retry-After, /livez 200, the stream
    completes byte-equal to an undrained one, and the exit code is 0."""
    port = free_port()
    proc = _spawn_serve(model_dirs["a"], port, "--drain-grace", "60", "--stream-chunk-size", "1")
    try:
        _wait_healthy(proc, port)
        status, _, whole = _http(port, "POST", "/v1/generate",
                                 {"tokens": PROMPT, "max_new_tokens": 40, "stream": True})
        assert status == 200
        stream = _SlowStream(port, 40)
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            status, headers, body = _http(port, "GET", "/healthz", timeout=5)
            if status == 503:
                break
            time.sleep(0.02)
        assert (status, body["status"]) == (503, "draining")
        assert "Retry-After" not in headers
        assert _http(port, "GET", "/livez", timeout=5)[:1] == (200,)
        assert stream.rest() == whole
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_sigterm_without_grace_sleeps_drain_seconds_and_sigint_cuts_it(model_dirs):
    port = free_port()
    proc = _spawn_serve(model_dirs["a"], port, "--drain-seconds", "60")
    try:
        _wait_healthy(proc, port)
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and _http(port, "GET", "/healthz")[0] != 503:
            time.sleep(0.02)
        assert _http(port, "GET", "/healthz")[2]["status"] == "draining"
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0 and time.monotonic() - t0 < 30
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- the flags ------------------------------------------------------------------------


def test_serve_main_parses_the_pool_flags(model_dirs, tmp_path, caplog):
    from modelx_tpu_torch.dl import serve_main

    sset, httpd = serve_main.start([
        "--model", f"a={model_dirs['a']}", "--device", "cpu", "--dtype", "float32",
        "--listen", f"127.0.0.1:{free_port()}", "--allow-admin-load", "--evict-idle",
        "--hbm-budget-bytes", "123456789", "--host-state-budget-bytes", "1000",
        "--disk-state-budget-bytes", "2000", "--state-spool-dir", str(tmp_path / "spool"),
        "--admin-token", "t1", "--admin-token", "t2", "--staging-dir", str(tmp_path / "st"),
        "--concurrent-load"])
    try:
        pool = sset.pool
        assert (pool.allow_admin_load, pool.evict_idle, pool.hbm_budget_bytes) == (
            True, True, 123456789)
        assert (pool.tiers.host_budget_bytes, pool.tiers.disk_budget_bytes,
                pool.tiers.spool_root) == (1000, 2000, str(tmp_path / "spool"))
        assert sset.admin_tokens == ("t1", "t2") and pool.staging_root == str(tmp_path / "st")
    finally:
        httpd.shutdown()
        httpd.server_close()
    args = serve_main.build_parser().parse_args(["--model", "m=/x"])
    serve_main._parse_numbers(serve_main.build_parser(), args)
    assert (args.drain_seconds, args.drain_grace, args.hbm_budget_bytes) == (5.0, 0.0, 0)


@pytest.mark.parametrize("argv,warning", [
    (["--evict-idle"], "--evict-idle is inert without --hbm-budget-bytes"),
    (["--state-spool-dir", "/tmp/x"], "--state-spool-dir is inert without "
                                      "--disk-state-budget-bytes"),
    (["--publish-kv"], "--publish-kv is inert without --prefix-cache"),
    (["--kv-fetch-through"], "--kv-fetch-through is inert without --prefix-cache"),
    (["--publish-outbox-dir", "/tmp/x"], "--publish-outbox-dir is inert without "
                                         "--publish-programs or --publish-kv"),
], ids=["evict-idle", "state-spool-dir", "publish-kv", "kv-fetch-through", "outbox-dir"])
def test_inert_flag_warnings_equal_jax(model_dirs, argv, warning, caplog):
    from modelx_tpu_torch.dl import serve_main

    with caplog.at_level("WARNING", logger="modelx.serve"):
        sset, httpd = serve_main.start(["--model", f"a={model_dirs['a']}", "--device", "cpu",
                                        "--dtype", "float32",
                                        "--listen", f"127.0.0.1:{free_port()}", *argv])
    httpd.shutdown()
    httpd.server_close()
    sset.pool.stop_kv()
    assert any(r.getMessage().startswith(warning) for r in caplog.records)
    with open(os.path.join(REPO, "modelx_tpu", "dl", "serve_main.py")) as f:
        src = f.read()
    assert warning.split(" is inert")[0] + " is inert without " in src


@pytest.mark.parametrize("argv", [
    ["--model", "a=/x", "--hbm-budget-bytes", "lots"],
    ["--model", "a=/x", "--drain-grace", "soon"],
    ["--model", "a=/x", "--host-state-budget-bytes", "1.5"],
], ids=["budget", "grace", "host"])
def test_pool_flag_usage_errors_equal_jax(argv, capsys):
    from click.testing import CliRunner

    from modelx_tpu.dl import serve_main as jax_serve_main
    from modelx_tpu_torch.dl import serve_main

    ran = CliRunner().invoke(jax_serve_main.main, argv + ["--no-compile-cache"])
    assert ran.exit_code == 2
    want = ran.output.strip().splitlines()[-1].removeprefix("Error: ")
    with pytest.raises(SystemExit) as exc:
        serve_main.start(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1] == want


# -- the derived-artifact hooks (dl/program_store.py, dl/kv_store.py, dl/outbox.py) ----


def test_serve_main_parses_the_publish_flags(model_dirs, tmp_path, caplog):
    from modelx_tpu_torch.dl import serve_main

    with caplog.at_level("WARNING", logger="modelx.serve"):
        sset, httpd = serve_main.start([
            "--model", f"a={model_dirs['a']}", "--device", "cpu", "--dtype", "float32",
            "--listen", f"127.0.0.1:{free_port()}", "--prefix-cache", "4", "--publish-programs",
            "--publish-kv", "--kv-publish-threshold", "3", "--kv-fetch-through",
            "--publish-outbox-dir", str(tmp_path / "ob"), "--outbox-max-entries", "5"])
    try:
        pool = sset.pool
        assert (pool.publish_programs, pool.publish_kv, pool.kv_publish_threshold,
                pool.kv_fetch_through) == (True, True, 3, True)
        assert pool.outbox.max_entries == 5 and pool.outbox.root == str(tmp_path / "ob")
        assert pool.outbox_drainer.snapshot()["running"]
        snap = pool.pool_snapshot()
        assert snap["outbox"]["depth"] == 0 and snap["kv_publisher"]["threshold"] == 3
        # publishes ride on runtime loads only, as the JAX sidecar warns
        assert any(r.getMessage().startswith("--publish-programs only fires on runtime "
                                             "(registry-ref) loads") for r in caplog.records)
    finally:
        httpd.shutdown()
        httpd.server_close()
        sset.pool.stop_kv()
        sset.pool.stop_outbox()
    assert not pool.outbox_drainer.snapshot()["running"]
    defaults = serve_main.build_parser().parse_args(["--model", "m=/x"])
    assert (defaults.publish_programs, defaults.publish_kv, defaults.kv_publish_threshold,
            defaults.kv_fetch_through, defaults.publish_outbox_dir,
            defaults.outbox_max_entries) == (False, False, 2, False, "", 0)


def _stream_raw(port, name, tokens):
    return _http(port, "POST", f"/v1/{name}/generate",
                 {"tokens": [tokens], "max_new_tokens": 4, "stream": True})


def _outbox_depth(pool, want: int, timeout_s: float = 30.0) -> int:
    """The pool's outbox depth once it reaches ``want`` (or the timeout):
    a runtime load enqueues its publish after turning READY."""
    deadline = time.monotonic() + timeout_s
    while pool.outbox.depth() != want and time.monotonic() < deadline:
        time.sleep(0.01)
    return pool.outbox.depth()


def test_runtime_loads_publish_install_and_fetch_through(model_dirs, registry, tmp_path,
                                                         monkeypatch, fresh_trackers):
    """A JAX pod and a port pod, each publishing into its own repo of the
    port's registry: the same streams make the same prefix hot, the KV
    publisher ships the same key through the outbox on both, a drain
    flushes one more; the port's runtime load also spools its kernel
    library. A second port load of the version installs both bundles at
    its load and attaches a fetch-through worker, which its unload stops."""
    from modelx_tpu.dl import kv_store as jkv
    from modelx_tpu_torch.dl import kv_store as tkv
    from modelx_tpu_torch.dl import program_store as tps
    from modelx_tpu_torch.kernels import build
    from modelx_tpu_torch.types import MediaTypeModelKVCache, MediaTypeModelProgram

    for side in ("jax", "port"):
        JaxClient(registry, quiet=True).push(f"library/pub-{side}", "v1", model_dirs["a"])
    monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc-a"))
    os.makedirs(build.build_dir())
    with open(build.library_path(), "wb") as f:
        f.write(b"a stand-in kernel library")
    pair = Pair.build(model_dirs, tmp=tmp_path, allow_admin_load=True)
    jpool, tpool = pair.pools()
    try:
        for side, pool in (("jax", jpool), ("port", tpool)):
            pool.attach_outbox(str(tmp_path / f"{side}-outbox"), start=False)
            pool.attach_kv_publisher(threshold=2, start=False)
        tpool.publish_programs = True
        for side, pool in (("jax", jpool), ("port", tpool)):
            snap = pool.request_load("p", ref=f"{registry}/library/pub-{side}@v1", wait=True)
            assert snap["p"]["state"] == "READY"
        # the library, spooled off the load's path: after READY, as the
        # reference does, so the wait for READY can return before it lands
        assert _outbox_depth(tpool, 1) == 1
        assert tpool.outbox_drainer.drain_once()
        blobs = tserve_manifest(registry, "library/pub-port")
        (prog,) = [b for b in blobs if b.media_type == MediaTypeModelProgram]
        assert prog.name == tps.bundle_name()
        # the same streams heat the same prefix on both pods
        hot = [5, 6, 7, 8, 9]
        for tokens in (hot, hot + [4], hot + [2]):
            pair.agree("POST", "/v1/p/generate", {"tokens": [tokens], "max_new_tokens": 4,
                                                  "stream": True})
        assert jpool.kv_publisher.flush() == tpool.kv_publisher.flush() == 1
        assert tpool.kv_publisher.snapshot() == jpool.kv_publisher.snapshot()
        spooled = {}
        for side, pool, mod in (("jax", jpool, jkv), ("port", tpool, tkv)):
            _seq, meta, data = pool.outbox.peek()
            assert meta["kind"] == "kvcache"
            spooled[side] = mod._bundle_meta(data)["tokens"]
            while pool.outbox_drainer.drain_once():
                pass
            assert pool.outbox.depth() == 0
        assert spooled["port"] == spooled["jax"] == hot
        assert tpool.pool_snapshot()["outbox"]["drained_kvcache_total"] == \
            jpool.pool_snapshot()["outbox"]["drained_kvcache_total"] == 1
        (enq,) = [e for e in tpool.flightrec.events() if e["event"] == "kv.publish_enqueued"]
        assert enq["bytes"] > 0 and enq["build_ms"] >= 0

        # a second load of the version installs both bundles at its load
        monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc-b"))
        tpool.kv_fetch_through = True
        assert tpool.request_load("q", ref=f"{registry}/library/pub-port@v1",
                                  wait=True)["q"]["state"] == "READY"
        q = pair.t.servers["q"]
        assert q.stats["programs"]["installed"] == 1 and q.stats["kv"]["installed"] == 1
        assert os.path.isfile(build.library_path())  # into the new build directory
        # its own publish of the same library is a registry no-op
        assert _outbox_depth(tpool, 1) == 1 and tpool.outbox_drainer.drain_once()
        assert [b for b in tserve_manifest(registry, "library/pub-port")
                if b.media_type == MediaTypeModelProgram] == [prog]
        status, _, raw = _stream_raw(pair.ports[1], "q", hot + [3])
        assert status == 200 and q._prefix_cache.hits_installed == 1
        assert tpool.pool_snapshot()["kv_fetchers"]["q"]["running"]
        fetcher = tpool._kv_fetchers["q"]
        assert q._prefix_cache.fetcher is fetcher

        # a drain flushes the publisher once more: a prefix hot since the sweep
        hot2 = [9, 8, 7, 6, 5]
        for tokens in (hot2, hot2 + [1], hot2 + [2]):
            pair.agree("POST", "/v1/p/generate", {"tokens": [tokens], "max_new_tokens": 4,
                                                  "stream": True})
        for pool in (jpool, tpool):
            pool.request_unload("p", wait=True)
            assert pool.outbox.depth() == 1
        assert tpool.kv_publisher.snapshot() == jpool.kv_publisher.snapshot()
        tpool.request_unload("q", wait=True)
        assert "q" not in tpool._kv_fetchers and not fetcher.snapshot()["running"]
        assert "kv_fetchers" not in tpool.pool_snapshot()
        kvs = [b for b in tserve_manifest(registry, "library/pub-port")
               if b.media_type == MediaTypeModelKVCache]
        assert len(kvs) == 1
    finally:
        pair.close()
        for pool in (jpool, tpool):
            pool.stop_kv()
            pool.stop_outbox()


def tserve_manifest(registry, repo):
    from modelx_tpu_torch.client.remote import RegistryClient

    client = RegistryClient(registry)
    try:
        return client.get_manifest(repo, "v1").blobs
    finally:
        client.close()
