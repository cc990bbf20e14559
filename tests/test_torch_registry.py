"""The port's registry (modelx_tpu_torch.registry) and registry client
(modelx_tpu_torch.client) against the JAX package's, in one process on the
CPU, across the HTTP boundary in both directions:

- the JAX client pushes a model (weights, modelx.yaml, a directory blob)
  into the port's RegistryServer, and the same push into the JAX
  RegistryServer gives byte-identical bodies (status, body and the
  validator headers) for the index, manifest, blob, range and error
  requests;
- the port's client pulls from the JAX server and from its own: the same
  tree as the pushed directory, file for file;
- the retry schedules (RetryPolicy on an injected rng, EndpointRotation,
  hedged_call on an injected wait) and the client's failover ladder equal
  the JAX package's;
- the port's client reuses its kept-alive connections.

Exact comparisons throughout (bytes; no tolerance)."""

import filecmp
import http.client
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from modelx_tpu import errors as jerrors
from modelx_tpu.client import remote as jremote
from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu.registry.fs import MemoryFSProvider as JaxMemoryFS
from modelx_tpu.registry.server import Options as JaxOptions
from modelx_tpu.registry.server import RegistryServer as JaxRegistryServer
from modelx_tpu.registry.server import free_port
from modelx_tpu.registry.store_fs import FSRegistryStore as JaxStore
from modelx_tpu.utils import retry as jretry
from modelx_tpu_torch import errors as terrors
from modelx_tpu_torch.client import remote as tremote
from modelx_tpu_torch.client.client import Client
from modelx_tpu_torch.registry.fs import MemoryFSProvider
from modelx_tpu_torch.registry.server import Options, RegistryServer
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.utils import retry as tretry
from tests.test_lifecycle import write_tiny

REPO = "library/tiny"


def write_model_dir(path) -> str:
    """A tiny llama checkpoint (tests/test_lifecycle.py:write_tiny) with a
    modelx.yaml, a loose file and a directory blob."""
    write_tiny(str(path))
    (path / "modelx.yaml").write_text("description: tiny\nframework: jax\n"
                                      "modelFiles: [model.safetensors, tokenizer]\n")
    (path / "notes.txt").write_text("not a model file\n")
    tok = path / "tokenizer"
    tok.mkdir()
    (tok / "vocab.txt").write_text("a\nb\n")
    rng = np.random.RandomState(1)
    (tok / "merges.bin").write_bytes(rng.bytes(4096))
    return str(path)


def start_port_registry(store=None):
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"),
                         store=store or FSRegistryStore(MemoryFSProvider()))
    return srv, srv.serve_background()


def start_jax_registry():
    srv = JaxRegistryServer(JaxOptions(listen=f"127.0.0.1:{free_port()}"),
                            store=JaxStore(JaxMemoryFS()))
    return srv, srv.serve_background()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_model_dir(tmp_path_factory.mktemp("tiny-model"))


@pytest.fixture(scope="module")
def registries(model_dir):
    """The same push into a JAX registry and into the port's."""
    jsrv, jbase = start_jax_registry()
    tsrv, tbase = start_port_registry()
    for base in (jbase, tbase):
        JaxClient(base, quiet=True).push(REPO, "v1", model_dir)
    yield jbase, tbase
    jsrv.shutdown()
    tsrv.shutdown()


def _call(base, method, path, body=None, headers=None):
    req = urllib.request.Request(base + path, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


VALIDATORS = ("Content-Type", "Content-Length", "Content-Range", "ETag",
              "Docker-Content-Digest", "Accept-Ranges")


def _blob_digest(base, name):
    manifest = Client(base).get_manifest(REPO, "v1")
    return next(b.digest for b in manifest.blobs if b.name == name)


_ZERO = "sha256:" + "0" * 64
REQUESTS = [
    ("GET", "/healthz", None, {}),
    ("GET", "/", None, {}),
    ("GET", "/?search=tin", None, {}),
    ("GET", "/?search=(", None, {}),
    ("GET", f"/{REPO}/index", None, {}),
    ("GET", f"/{REPO}/index?search=v", None, {}),
    ("GET", "/library/nope/index", None, {}),
    ("GET", f"/{REPO}/manifests/v1", None, {}),
    ("HEAD", f"/{REPO}/manifests/v1", None, {}),
    ("GET", f"/{REPO}/manifests/nope", None, {}),
    ("HEAD", f"/{REPO}/manifests/nope", None, {}),
    ("GET", f"/{REPO}/blobs/@model", None, {}),
    ("HEAD", f"/{REPO}/blobs/@model", None, {}),
    ("GET", f"/{REPO}/blobs/@model", None, {"Range": "bytes=8-1031"}),
    ("GET", f"/{REPO}/blobs/@model", None, {"Range": "bytes=100-"}),
    ("GET", f"/{REPO}/blobs/@model", None, {"Range": "bytes=99999999-"}),
    ("GET", f"/{REPO}/blobs/@model", None, {"Range": "lines=1-2"}),
    ("GET", f"/{REPO}/blobs/@model", None, {"If-None-Match": '"@model"'}),
    ("GET", f"/{REPO}/blobs/{_ZERO}", None, {}),
    ("HEAD", f"/{REPO}/blobs/{_ZERO}", None, {}),
    ("GET", f"/{REPO}/blobs/@model/locations/download", None, {}),
    ("PUT", f"/{REPO}/blobs/{_ZERO}", b"not these bytes", {"Content-Length": "15"}),
    ("PUT", f"/{REPO}/blobs/md5:{'0' * 32}", b"x", {"Content-Length": "1"}),
    ("PUT", f"/{REPO}/manifests/v2", b"{not json", {"Content-Type": "application/json"}),
    ("PUT", f"/{REPO}/manifests/v2",
     b'{"schemaVersion":1,"config":{},"blobs":[{"name":"w","digest":"' + _ZERO.encode()
     + b'","size":3}]}', {"Content-Type": "application/json"}),
    ("POST", f"/{REPO}/index", None, {}),
    ("GET", "/no/such/route/here", None, {}),
]


@pytest.mark.parametrize("method,path,body,headers", REQUESTS,
                         ids=[f"{i}-{m}{p}" for i, (m, p, _, _) in enumerate(REQUESTS)])
def test_bodies_identical_to_the_jax_registry(registries, method, path, body, headers):
    jbase, tbase = registries
    digest = _blob_digest(jbase, "model.safetensors")
    assert digest == _blob_digest(tbase, "model.safetensors")
    path = path.replace("@model", digest)
    headers = {k: v.replace("@model", digest) for k, v in headers.items()}
    want = _call(jbase, method, path, body, headers)
    got = _call(tbase, method, path, body, headers)
    assert got[0] == want[0]
    assert got[2] == want[2]
    for key in VALIDATORS:
        assert got[1].get(key) == want[1].get(key), key


def test_port_client_pulls_the_same_tree_from_both_registries(registries, model_dir, tmp_path):
    jbase, tbase = registries
    for base, name in ((jbase, "from-jax"), (tbase, "from-port")):
        dest = tmp_path / name
        manifest = Client(base, quiet=True).pull(REPO, "v1", str(dest))
        assert sorted(b.name for b in manifest.blobs) == [
            "model.safetensors", "notes.txt", "tokenizer"]
        cmp = filecmp.dircmp(model_dir, str(dest), ignore=[".modelx"])  # push's tgz cache
        assert cmp.left_only == [] and cmp.right_only == [] and cmp.diff_files == []
        sub = filecmp.dircmp(os.path.join(model_dir, "tokenizer"), str(dest / "tokenizer"))
        assert sub.diff_files == [] and sorted(sub.common_files) == ["merges.bin", "vocab.txt"]


def test_jax_client_pulls_what_it_pushed_into_the_port(registries, model_dir, tmp_path):
    _, tbase = registries
    JaxClient(tbase, quiet=True).pull(REPO, "v1", str(tmp_path / "out"))
    assert filecmp.cmp(os.path.join(model_dir, "model.safetensors"),
                       str(tmp_path / "out" / "model.safetensors"), shallow=False)
    assert JaxClient(tbase).get_config_content(REPO, "v1") == Client(
        tbase).get_config_content(REPO, "v1")


def test_metrics_identical_after_the_same_requests(model_dir):
    jsrv, jbase = start_jax_registry()
    tsrv, tbase = start_port_registry()
    try:
        for base in (jbase, tbase):
            JaxClient(base, quiet=True).push(REPO, "v1", model_dir)
            b"".join(Client(base).remote.get_blob_content(REPO, _blob_digest(base, "notes.txt")))
        want = _call(jbase, "GET", "/metrics")
        got = _call(tbase, "GET", "/metrics")
        assert got[0] == want[0] == 200 and got[2] == want[2]
        assert got[1]["Content-Type"] == want[1]["Content-Type"]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


@pytest.mark.parametrize("route", ["garbage-collect", "scrub"])
def test_gc_and_scrub_answer_a_typed_501(registries, route):
    _, tbase = registries
    status, _, body = _call(tbase, "POST", f"/{REPO}/{route}")
    assert status == 501
    err = terrors.ErrorInfo.decode(body, status)
    assert err.code == terrors.ErrCodeUnsupported and "control plane" in err.detail


def test_error_bodies_encode_as_the_jax_package(registries):
    for name in ("blob_unknown", "manifest_unknown", "name_unknown", "index_unknown"):
        assert getattr(terrors, name)("x").encode() == getattr(jerrors, name)("x").encode()
    assert terrors.commit_invalid(["a"], [{"d": 1}]).encode() == jerrors.commit_invalid(
        ["a"], [{"d": 1}]).encode()


def test_client_reuses_its_connections(registries, monkeypatch):
    _, tbase = registries
    digest = _blob_digest(tbase, "notes.txt")
    connects = []
    real = http.client.HTTPConnection.connect

    def counting(self):
        connects.append(1)
        return real(self)

    monkeypatch.setattr(http.client.HTTPConnection, "connect", counting)
    c = Client(tbase)
    for _ in range(10):
        c.get_manifest(REPO, "v1")
        assert c.remote.head_blob(REPO, digest)
        assert b"".join(c.remote.get_blob_content(REPO, digest)) == b"not a model file\n"
    assert len(connects) == 1


# -- retry schedules, against the JAX package's ---------------------------------


def _delays(mod):
    policy = mod.RetryPolicy(retries=5, backoff_s=0.2, retry_after_cap_s=5.0,
                             rng=lambda lo, hi: lo + 0.37 * (hi - lo))
    return [policy.delay_s(a, ra) for a in range(5)
            for ra in (None, "1", "30", "-2", "Wed, 21 Oct 2015 07:28:00 GMT", "x")]


def test_retry_policy_schedule_equals_jax():
    assert _delays(tretry) == _delays(jretry)
    slept = {}
    for mod in (jretry, tretry):
        out = []
        p = mod.RetryPolicy(retries=2, sleep=out.append, rng=lambda lo, hi: hi)
        for a in p.attempts():
            p.sleep(a, "0.1")
        slept[mod] = (out, [p.last(a) for a in range(3)])
    assert slept[tretry] == slept[jretry]
    assert [tretry.retriable_status(s) for s in range(400, 600)] == [
        jretry.retriable_status(s) for s in range(400, 600)]


def test_endpoint_rotation_equals_jax():
    orders = {}
    for mod in (jretry, tretry):
        r = mod.EndpointRotation(3)
        seq = [r.order()]
        for good in (2, 5, 1, -1, 0):
            r.mark_good(good)
            seq.append((r.order(), r.preferred))
        orders[mod] = seq
    assert orders[tretry] == orders[jretry]


def _hedge_runs(mod):
    import threading

    def instant(ev, timeout):  # the hedge delay 'elapses' at once
        return False if timeout is not None else ev.wait(5.0)

    def ticking(ev, timeout):
        return ev.wait(5.0)

    def dead():
        raise RuntimeError("down")

    release = threading.Event()

    def slow():
        release.wait(5.0)
        return "late"

    closed = []
    runs = [
        mod.hedged_call([lambda: "a", lambda: "b"], 60.0, wait=ticking),
        mod.hedged_call([dead, lambda: "b"], 60.0, wait=ticking),
        mod.hedged_call([slow, lambda: "b"], 60.0, on_loser=closed.append, wait=instant),
        mod.hedged_call([dead, dead, lambda: "c"], 60.0, wait=ticking),
    ]
    release.set()
    try:
        mod.hedged_call([dead, dead], 60.0, wait=ticking)
    except RuntimeError as e:
        runs.append(str(e))
    return runs


def test_hedged_call_outcomes_equal_jax():
    assert _hedge_runs(tretry) == _hedge_runs(jretry)


def _ladder(remote, errors, scenario):
    """Drive RegistryClient._request over [primary, mirror] with _send and
    the retry sleep stubbed; record sends, sleeps and last_source."""
    c = remote.RegistryClient("http://primary:1", mirrors=["http://mirror:2"])
    sends, sleeps = [], []
    c._retry_sleep = lambda attempt, ra: sleeps.append((attempt, ra))

    def send(method, url, params=None, data=None, headers=None, stream=False):
        sends.append((method, url))
        status = scenario(url)
        if status is None:
            return object()
        e = errors.ErrorInfo(http_status=status, code=errors.ErrCodeUnknown, message="x")
        e.retry_after = "2"
        raise e

    c._send = send
    out = []
    for method, path in (("GET", "/a"), ("GET", "/b"), ("DELETE", "/c"), ("HEAD", "/d")):
        try:
            c._request(method, path)
            out.append("ok")
        except errors.ErrorInfo as e:
            out.append(e.http_status)
    return out, sends, sleeps, c.last_source, c.last_endpoint


@pytest.mark.parametrize("scenario", [
    lambda url: 503 if "primary" in url else None,  # browned-out primary
    lambda url: 502,  # everything down
    lambda url: 404,  # deterministic: never fails over
    lambda url: None,  # healthy
], ids=["primary-503", "all-down", "404", "healthy"])
def test_failover_ladder_equals_jax(scenario):
    from modelx_tpu.dl import manifest_cache as jmc
    from modelx_tpu_torch.dl import manifest_cache as tmc

    try:
        assert _ladder(tremote, terrors, scenario) == _ladder(jremote, jerrors, scenario)
        assert tmc.health().status()["state"] == jmc.health().status()["state"]
    finally:
        jmc.health().reset()
        tmc.health().reset()
