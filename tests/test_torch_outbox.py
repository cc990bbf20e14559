"""The port's durable publish outbox (modelx_tpu_torch.dl.outbox) against
the JAX package's, on the CPU, with the outbox cases of tests/test_outage.py
and the kind routing of tests/test_kv_store.py:

- the same operations on a JAX ``Outbox``/``Drainer`` and a port one give
  equal results and equal snapshots (no tolerance: counters and strings);
- the spool layout is one: a spool written by either package is read,
  drained and extended by the other;
- the outage drill: with the port's registry running as a child process,
  a publish spooled while the registry is dead survives a new process
  generation of the outbox and lands once the registry restarts on the
  same address and data.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from modelx_tpu import errors as jerrors
from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu.dl import outbox as jox
from modelx_tpu.registry.server import free_port
from modelx_tpu.utils.flightrec import FlightRecorder as JaxFlightRecorder
from modelx_tpu_torch import errors as terrors
from modelx_tpu_torch.client.remote import RegistryClient
from modelx_tpu_torch.dl import kv_store, program_store
from modelx_tpu_torch.dl import outbox as tox
from modelx_tpu_torch.kernels import build
from modelx_tpu_torch.types import MediaTypeModelProgram
from modelx_tpu_torch.utils.flightrec import FlightRecorder
from tests.test_torch_registry import write_model_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = (("jax", jox, jerrors), ("port", tox, terrors))


def _both(tmp_path, **kw):
    return {name: mod.Outbox(str(tmp_path / name), **kw) for name, mod, _ in BOTH}


def _snap_equal(a: dict, b: dict) -> None:
    assert a == b, (a, b)


@pytest.mark.parametrize("ops", [
    [("enqueue", "programs", "http://r/library/a@v1", b"one"),
     ("enqueue", "programs", "http://r/library/b@v1", b"two")],
    [("enqueue", "programs", "r1", b"x"), ("enqueue", "programs", "r2", b"y"),
     ("enqueue", "kvcache", "r3", b"z" * 5)],
    [("enqueue", "programs", "r", b"x" * 8)],
], ids=["fifo", "full", "bytes"])
def test_the_same_enqueues_give_equal_results_and_snapshots(tmp_path, ops):
    obs = _both(tmp_path, max_entries=2, max_bytes=7)
    for op, kind, ref, data in ops:
        got = {name: ob.enqueue(kind, ref, data) for name, ob in obs.items()}
        assert got["port"] == got["jax"]
    _snap_equal(obs["port"].snapshot(), obs["jax"].snapshot())
    peeks = {name: ob.peek() for name, ob in obs.items()}
    if peeks["jax"] is None:
        assert peeks["port"] is None
        return
    (js, jm, jd), (ts, tm, td) = peeks["jax"], peeks["port"]
    assert (ts, td) == (js, jd)
    assert {k: v for k, v in tm.items() if k != "enqueued_at"} == \
        {k: v for k, v in jm.items() if k != "enqueued_at"}


def test_enqueue_peek_remove_fifo(tmp_path):
    ob = tox.Outbox(str(tmp_path / "ob"))
    assert ob.enqueue("programs", "http://r/library/a@v1", b"one")
    assert ob.enqueue("programs", "http://r/library/b@v1", b"two")
    assert ob.depth() == 2 and ob.pending_bytes() == 6
    seq, meta, data = ob.peek()
    assert meta["ref"].endswith("a@v1") and data == b"one"
    ob.remove(seq)
    _, _, data2 = ob.peek()
    assert data2 == b"two"


def test_full_spool_drops_not_blocks(tmp_path):
    obs = _both(tmp_path, max_entries=1)
    for ob in obs.values():
        assert ob.enqueue("programs", "r1", b"x")
        assert not ob.enqueue("programs", "r2", b"y")
        assert ob.stats["drop_full_total"] == 1 and ob.depth() == 1  # the older survives
    _snap_equal(obs["port"].snapshot(), obs["jax"].snapshot())


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_spool_of_one_package_is_read_and_extended_by_the_other(tmp_path, writer, reader):
    mods = {name: mod for name, mod, _ in BOTH}
    root = str(tmp_path / "ob")
    mods[writer].Outbox(root).enqueue("programs", "http://r/library/a@v1", b"bundle")
    # the restart: a fresh Outbox over the same spool dir, of the other package
    ob2 = mods[reader].Outbox(root)
    seq, meta, data = ob2.peek()
    assert data == b"bundle" and meta["kind"] == "programs" and seq == 0
    ob2.enqueue("kvcache", "http://r/library/b@v1", b"next")  # no seq collision
    assert ob2.depth() == 2
    assert sorted(os.listdir(root)) == ["00000000.bin", "00000000.json",
                                        "00000001.bin", "00000001.json"]


def test_orphan_payload_swept_on_construction(tmp_path):
    for name, mod, _ in BOTH:
        root = tmp_path / name
        root.mkdir()
        (root / "00000007.bin").write_bytes(b"torn")  # crash before the meta commit
        ob = mod.Outbox(str(root))
        assert ob.depth() == 0 and not (root / "00000007.bin").exists()
        assert ob.enqueue("programs", "r", b"x")
        assert (root / "00000000.json").exists()


def test_unreadable_entry_removed_on_peek(tmp_path):
    obs = _both(tmp_path)
    for name, ob in obs.items():
        ob.enqueue("programs", "r", b"x")
        seq, _, _ = ob.peek()
        os.unlink(tmp_path / name / f"{seq:08d}.bin")  # meta without payload
        assert ob.peek() is None and ob.depth() == 0
    _snap_equal(obs["port"].snapshot(), obs["jax"].snapshot())


def test_drain_once_success_removes_counts_and_records(tmp_path):
    obs = _both(tmp_path)
    got = {"jax": [], "port": []}
    recs = {"jax": JaxFlightRecorder(capacity=16), "port": FlightRecorder(capacity=16)}
    drs = {name: mod.Drainer(obs[name], lambda k, r, d, name=name: got[name].append((k, r, d)),
                             recorder=recs[name]) for name, mod, _ in BOTH}
    for name in obs:
        obs[name].enqueue("programs", "http://r/library/a@v1", b"bundle")
        assert drs[name].drain_once()
        assert got[name] == [("programs", "http://r/library/a@v1", b"bundle")]
        ev = [e for e in recs[name].events() if e["event"] == "outbox.drained"]
        assert [(e["ref"], e["kind"], e["depth"]) for e in ev] == [
            ("http://r/library/a@v1", "programs", 0)]
    # the port's event also carries the publish's bytes and seconds
    (ev,) = [e for e in recs["port"].events() if e["event"] == "outbox.drained"]
    assert ev["bytes"] == 6 and ev["seconds"] >= 0
    _snap_equal(drs["port"].snapshot(), drs["jax"].snapshot())


def test_failure_keeps_entry_and_backs_off_exponentially(tmp_path):
    obs = _both(tmp_path)
    drs = {}
    for name, mod, errs in BOTH:
        def handler(kind, ref, data, errs=errs):
            raise errs.ErrorInfo(http_status=502, message="registry down")

        obs[name].enqueue("programs", "r", b"x")
        drs[name] = mod.Drainer(obs[name], handler, backoff_s=0.5, backoff_cap_s=4.0)
        assert drs[name]._delay_s() == 0.0
        for want in (0.5, 1.0, 2.0, 4.0, 4.0):  # doubles, then caps
            assert not drs[name].drain_once()
            assert drs[name]._delay_s() == pytest.approx(want)
        assert obs[name].depth() == 1 and obs[name].stats["publish_failures_total"] == 5
    snap = drs["port"].snapshot()
    assert snap["consecutive_failures"] == 5 and "registry down" in snap["last_error"]
    _snap_equal(snap, drs["jax"].snapshot())


def test_success_after_failures_resets_backoff(tmp_path):
    obs = _both(tmp_path)
    live = {"up": False}

    def handler(kind, ref, data):
        if not live["up"]:
            raise OSError("connection refused")

    drs = {name: mod.Drainer(obs[name], handler, backoff_s=0.5) for name, mod, _ in BOTH}
    for ob in obs.values():
        ob.enqueue("programs", "r", b"x")
    for dr in drs.values():
        assert not dr.drain_once()
    _snap_equal(drs["port"].snapshot(), drs["jax"].snapshot())
    live["up"] = True
    for name, dr in drs.items():
        assert dr.drain_once() and dr._delay_s() == 0.0 and obs[name].depth() == 0
    _snap_equal(drs["port"].snapshot(), drs["jax"].snapshot())


def test_background_thread_drains_on_kick(tmp_path):
    ob = tox.Outbox(str(tmp_path / "ob"))
    drained = threading.Event()
    d = tox.Drainer(ob, lambda kind, ref, data: drained.set(), backoff_s=0.01,
                    sleeper=lambda ev, t: ev.wait(0.05))
    d.start()
    try:
        ob.enqueue("programs", "r", b"x")
        d.kick()
        assert drained.wait(5.0)
        deadline = time.monotonic() + 5.0
        while ob.depth() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ob.depth() == 0
    finally:
        d.stop()
    assert not d.snapshot()["running"]


# -- per-kind routing (tests/test_kv_store.py TestOutboxKinds) -----------------------


def test_kind_routes_to_registered_handler(tmp_path):
    obs = _both(tmp_path)
    for name, mod, _ in BOTH:
        ob = obs[name]
        assert ob.enqueue(kv_store.OUTBOX_KIND, "reg/m@v1", b"kv-bytes")
        got = []
        dr = mod.Drainer(ob, handler=lambda k, r, d: got.append(("fallback", k)))
        dr.register_handler(kv_store.OUTBOX_KIND, lambda k, r, d: got.append(("kv", k, r, d)))
        assert dr.drain_once()
        assert got == [("kv", "kvcache", "reg/m@v1", b"kv-bytes")]
        assert ob.snapshot()["drained_kvcache_total"] == 1
    _snap_equal(obs["port"].snapshot(), obs["jax"].snapshot())


def test_kindless_entry_drains_as_programs(tmp_path):
    for name, mod, _ in BOTH:
        ob = mod.Outbox(str(tmp_path / name))
        assert ob.enqueue("placeholder", "reg/m@v1", b"old-bytes")
        (_seq, meta_path, _bin) = ob._scan()[0]
        with open(meta_path) as f:
            meta = json.load(f)
        del meta["kind"]
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        got = []
        dr = mod.Drainer(ob, handler=None)
        dr.register_handler("programs", lambda k, r, d: got.append((k, d)))
        assert dr.drain_once() and got == [("programs", b"old-bytes")]


def test_unknown_kind_dropped_not_wedged(tmp_path):
    obs = _both(tmp_path)
    for name, mod, _ in BOTH:
        ob = obs[name]
        assert ob.enqueue("weird-artifact", "reg/m@v1", b"x")
        assert ob.enqueue(kv_store.OUTBOX_KIND, "reg/m@v1", b"y")
        got = []
        dr = mod.Drainer(ob, handler=None)
        dr.register_handler(kv_store.OUTBOX_KIND, lambda k, r, d: got.append(d))
        assert dr.drain_once() and ob.snapshot()["dropped_unknown_kind_total"] == 1
        assert dr.drain_once() and got == [b"y"] and ob.depth() == 0
    _snap_equal(obs["port"].snapshot(), obs["jax"].snapshot())


def test_kind_failure_counters_are_per_kind(tmp_path):
    obs = _both(tmp_path)
    drs = {}
    for name, mod, _ in BOTH:
        ob = obs[name]
        assert ob.enqueue(kv_store.OUTBOX_KIND, "reg/m@v1", b"x")
        drs[name] = mod.Drainer(ob, handler=None)
        drs[name].register_handler(
            kv_store.OUTBOX_KIND,
            lambda k, r, d: (_ for _ in ()).throw(RuntimeError("registry down")))
        assert not drs[name].drain_once()
        assert ob.snapshot()["publish_failures_kvcache_total"] == 1 and ob.depth() == 1
    _snap_equal(drs["port"].snapshot(), drs["jax"].snapshot())


# -- the outage drill against the port's registry in a child process ----------------


def _registry_child(port: int, data: str, log_path: str) -> subprocess.Popen:
    with open(log_path, "a") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "modelx_tpu_torch.registry.server_main",
             "--listen", f"127.0.0.1:{port}", "--data", data],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        assert proc.poll() is None, open(log_path).read()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2):
                return proc
        except OSError:
            time.sleep(0.1)
    proc.kill()
    raise AssertionError("the registry child did not answer /healthz")


def _stand_in_bundle(tmp_path) -> bytes:
    """A real program bundle around a stand-in library file (no nvcc here):
    publish parses the bundle's meta before it talks to the registry."""
    d = tmp_path / "build"
    d.mkdir()
    (d / build.library_name()).write_bytes(b"a stand-in kernel library")
    data = program_store.build_bundle(str(d))
    assert data
    return data


def test_outage_drill_spool_survives_and_drains_after_restart(tmp_path):
    bundle = _stand_in_bundle(tmp_path)
    port, data_dir, log = free_port(), str(tmp_path / "reg"), str(tmp_path / "reg.log")
    reg = _registry_child(port, data_dir, log)
    base = f"http://127.0.0.1:{port}"
    try:
        JaxClient(base, quiet=True).push("library/m", "v1", write_model_dir(tmp_path / "m"))
    finally:
        reg.kill()  # the registry dies with the publish still to come
        reg.wait()
    ref = f"{base}/library/m@v1"
    spool = str(tmp_path / "ob")
    ob = tox.Outbox(spool)
    assert ob.enqueue("programs", ref, bundle)
    d = tox.Drainer(ob, handler=None, backoff_s=0.05, backoff_cap_s=0.2)
    d.register_handler("programs", lambda _k, r, data: program_store.publish_bundle(r, data))
    assert not d.drain_once()
    assert ob.stats["publish_failures_total"] == 1 and d.snapshot()["consecutive_failures"] == 1
    # the pod dies too: a new process generation of the outbox over the spool
    ob2 = tox.Outbox(spool)
    assert ob2.depth() == 1
    d2 = tox.Drainer(ob2, handler=None)
    d2.register_handler("programs", lambda _k, r, data: program_store.publish_bundle(r, data))
    reg = _registry_child(port, data_dir, log)  # same address, same data
    try:
        assert d2.drain_once() and ob2.depth() == 0
        client = RegistryClient(base)
        blobs = client.get_manifest("library/m", "v1").blobs
        (prog,) = [b for b in blobs if b.media_type == MediaTypeModelProgram]
        assert prog.name == program_store.bundle_name() and prog.size == len(bundle)
        assert any(b.name == "model.safetensors" for b in blobs)  # merged, not replaced
        client.close()
    finally:
        reg.kill()
        reg.wait()


# -- the chaos soak (make chaos-torch: under the port's lockdep) -----------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_fleet_survives_registry_death(tmp_path):
    """tests/test_outage.py:720 on a port pod: 8 clients generate against
    the pod while the registry dies mid-traffic; a publish spooled during
    the outage fails; a concurrent swap-in of b loads offline from the
    pinned manifest and the blob cache; zero data-path errors; once the
    registry is back (the same address over the same store) the outbox
    drains, and the flight recorder holds the story."""
    from modelx_tpu_torch.dl import manifest_cache
    from modelx_tpu_torch.dl import serve as tserve
    from modelx_tpu_torch.dl.blob_cache import BlobCache
    from modelx_tpu_torch.registry.fs import MemoryFSProvider
    from modelx_tpu_torch.registry.server import Options, RegistryServer
    from modelx_tpu_torch.registry.store_fs import FSRegistryStore
    from modelx_tpu_torch.testing.faults import RegistryKillSwitch
    from tests.test_torch_lifecycle import write_tiny
    from tests.test_torch_program_store import stand_in

    manifest_cache.health().reset()
    manifest_cache.configure_default(str(tmp_path / "manifest-cache"))
    amodel, bmodel = str(tmp_path / "soak-a"), str(tmp_path / "soak-b")
    write_tiny(amodel, seed=0)
    write_tiny(bmodel, seed=1)
    store = FSRegistryStore(MemoryFSProvider())
    port = free_port()

    def start_registry():
        srv = RegistryServer(Options(listen=f"127.0.0.1:{port}"), store=store)
        return srv, srv.serve_background()

    srv, base = start_registry()
    JaxClient(base, quiet=True).push("library/a", "v1", amodel)
    JaxClient(base, quiet=True).push("library/b", "v1", bmodel)
    sset = tserve.ServerSet(
        {"a": tserve.ModelServer(amodel, dtype="float32", device="cpu", name="a",
                                 max_seq_len=64)},
        allow_admin_load=True, staging_root=str(tmp_path / "staging"))
    sset.pool.blob_cache = BlobCache(str(tmp_path / "blobs"))
    sset.pool.attach_outbox(str(tmp_path / "outbox"), backoff_s=0.1)
    sset.load_all()
    httpd = tserve.serve(sset, listen=f"127.0.0.1:{free_port()}")
    pod = httpd.server_address[1]
    switch = RegistryKillSwitch(srv)

    def http(method, path, body=None, timeout=300):
        req = urllib.request.Request(
            f"http://127.0.0.1:{pod}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    try:
        # warm the ladder: pull b once through the caches, then drop it
        st, body = http("POST", "/admin/models",
                        {"name": "b", "ref": f"{base}/library/b@v1", "wait": True})
        assert st == 200, body
        assert http("DELETE", "/admin/models/b")[0] == 200
        stop = threading.Event()
        errors_seen: list = []
        completed = [0] * 8

        def traffic(i: int) -> None:
            while not stop.is_set():
                try:
                    st, out = http("POST", "/v1/a/generate",
                                   {"tokens": [[1, 2, 3]], "max_new_tokens": 2}, timeout=120)
                    if st != 200:
                        errors_seen.append((i, st, out))
                        return
                    completed[i] += 1
                except Exception as e:  # any transport failure counts
                    errors_seen.append((i, type(e).__name__, str(e)))
                    return

        threads = [threading.Thread(target=traffic, args=(i,), daemon=True) for i in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30.0
        while sum(completed) < 8 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sum(completed) >= 8, "traffic never established"
        switch.kill()

        # a publish lands in the spool during the outage and fails
        lib = str(tmp_path / "lib")
        stand_in(lib)
        assert sset.pool.outbox.enqueue("programs", f"{base}/library/b@v1",
                                        program_store.build_bundle(lib))
        sset.pool.outbox_drainer.kick()

        # the concurrent swap-in, offline
        st, body = http("POST", "/admin/models",
                        {"name": "b", "ref": f"{base}/library/b@v1", "wait": True})
        assert st == 200, body
        assert body["b"]["state"] == "READY" and body["b"]["load_source"] == "cache"
        assert http("POST", "/v1/b/generate", {"tokens": [[1, 2, 3]], "max_new_tokens": 2})[0] \
            == 200
        st, hz = http("GET", "/healthz")
        assert hz["status"] == "ok" and hz["control_plane"]["state"] == "offline"

        stop.set()
        for t in threads:
            t.join(30)
        assert not errors_seen, errors_seen[:3]
        assert all(n > 0 for n in completed)
        assert sset.pool.outbox.depth() == 1

        srv2, _ = start_registry()
        try:
            sset.pool.outbox_drainer.kick()
            deadline = time.monotonic() + 30.0
            while sset.pool.outbox.depth() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert sset.pool.outbox.depth() == 0
            assert sset.pool.outbox.stats["drained_total"] >= 1
            m = RegistryClient(base).get_manifest("library/b", "v1")
            assert any(b.media_type == MediaTypeModelProgram for b in m.blobs)
        finally:
            srv2.shutdown()
        events = {e["event"] for e in sset.pool.flightrec.events()}
        assert {"ladder.source", "control_plane.transition", "outbox.drained"} <= events
    finally:
        switch.kill()
        sset.pool.stop_outbox()
        httpd.shutdown()
        sset.close()
        manifest_cache.health().reset()
        with manifest_cache._default_lock:
            manifest_cache._default = None
            manifest_cache._default_configured = False
