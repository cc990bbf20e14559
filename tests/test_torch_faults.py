"""The port's fault injection (modelx_tpu_torch/testing/faults.py) against
the JAX package's, on the CPU, and ``MODELX_FAULT_PLAN`` at the port's four
seams:

- the same plan JSON gives the same verdict (error, latency, truncation)
  at every one of 1,000 calls of each op, seeded error rates included;
- an ``engine.dispatch`` crash from the environment fails its request with
  the typed 503, the supervised engine restarts, and the next request
  returns the unfaulted tokens;
- a ``loader.read`` short read is retried by the port's loader, and the
  tensors come out whole;
- a ``FaultyFSProvider`` torn write is quarantined by the port's scrub as
  by the reference's, on twin stores;
- a ``store.manifest_persisted`` crash leaves the same stale index in
  both stores, and reconciliation recovers both the same way;
- the tier store takes its plan from the environment.

Tolerance: exact equality.
"""

import io
import json

import numpy as np
import pytest

from modelx_tpu.registry import scrub as jscrub
from modelx_tpu.registry.fs import LocalFSProvider as JLocal
from modelx_tpu.registry.store import BlobContent as JBlob
from modelx_tpu.registry.store import blob_digest_path as jblob_path
from modelx_tpu.registry.store_fs import FSRegistryStore as JStore
from modelx_tpu.testing import faults as jfaults
from modelx_tpu.types import Descriptor as JDesc
from modelx_tpu.types import Digest as JDigest
from modelx_tpu.types import Manifest as JManifest
from modelx_tpu_torch.registry import scrub as tscrub
from modelx_tpu_torch.registry.fs import LocalFSProvider as TLocal
from modelx_tpu_torch.registry.store import BlobContent as TBlob
from modelx_tpu_torch.registry.store import blob_digest_path as tblob_path
from modelx_tpu_torch.registry.store_fs import FSRegistryStore as TStore
from modelx_tpu_torch.testing import faults as tfaults
from modelx_tpu_torch.types import Descriptor as TDesc
from modelx_tpu_torch.types import Digest as TDigest
from modelx_tpu_torch.types import Manifest as TManifest

PLAN = {"seed": 11, "rules": [
    {"op": "engine.dispatch", "errors_at": [3, 700], "error": "chaos"},
    {"op": "engine.dispatch", "error_rate": 0.03, "horizon": 1000, "crash": True},
    {"op": "loader.read", "error_rate": 0.1, "horizon": 900, "latency_at": [5, 6],
     "latency_s": 0.0},
    {"op": "loader.read", "truncate_at": [2, 40, 999], "keep_bytes": 7},
    {"op": "fs.put", "error_rate": 0.2, "horizon": 1000, "truncate_at": [1], "keep_bytes": 0},
    {"op": "registry.accept", "errors_at": list(range(0, 1000, 97)), "error": "storm"},
]}
REPO = "library/faulted"


def _verdict(act) -> tuple:
    err = act.error
    return (None if err is None else (type(err).__name__, str(err)), act.latency_s,
            act.keep_bytes, act.clean)


def test_plan_verdicts_equal_over_1000_calls(monkeypatch):
    monkeypatch.setenv("MODELX_FAULT_PLAN", json.dumps(PLAN))
    jplan, tplan = jfaults.from_env(), tfaults.from_env()
    ops = ("engine.dispatch", "loader.read", "fs.put", "registry.accept", "fs.get")
    for i in range(1000):
        for op in ops:
            assert _verdict(tplan.fire(op)) == _verdict(jplan.fire(op)), (op, i)
    assert [tplan.count(op) for op in ops] == [jplan.count(op) for op in ops] == [1000] * 5
    assert [tplan.has(op) for op in ops] == [jplan.has(op) for op in ops]
    # a crash rule raises the port's own InjectedCrash
    fresh = tfaults.from_env()
    crash = next(a for a in (fresh.fire("engine.dispatch") for _ in range(1000))
                 if isinstance(a.error, tfaults.InjectedCrash))
    assert str(crash.error) == "injected crash"


def test_plan_from_a_file_and_unset(monkeypatch, tmp_path):
    monkeypatch.delenv("MODELX_FAULT_PLAN", raising=False)
    assert tfaults.from_env() is None and jfaults.from_env() is None
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(PLAN))
    monkeypatch.setenv("MODELX_FAULT_PLAN", f"@{p}")
    jplan, tplan = jfaults.from_env(), tfaults.from_env()
    for _ in range(50):
        assert _verdict(tplan.fire("fs.put")) == _verdict(jplan.fire("fs.put"))


def test_env_dispatch_crash_restarts_the_engine(monkeypatch):
    from modelx_tpu_torch.dl.continuous import ContinuousBatcher
    from modelx_tpu_torch.dl.serving_errors import EngineBrokenError
    from tests.test_torch_engine_faults import TOKENS, _wait

    srv = _tiny_server()
    expected = srv.generate(TOKENS, max_new_tokens=11)
    monkeypatch.setenv("MODELX_FAULT_PLAN", json.dumps({"seed": 1, "rules": [
        {"op": "engine.dispatch", "errors_at": [0], "crash": True, "error": "env chaos"}]}))
    cb = ContinuousBatcher(srv, max_slots=2, chunk_size=4, restart_backoff_s=0.05)
    try:
        assert getattr(cb._chunk, "__wrapped__", None) is not None
        with pytest.raises(EngineBrokenError, match="env chaos"):
            cb.generate(TOKENS, max_new_tokens=11)
        _wait(lambda: cb.snapshot()["engine_restarts"] >= 1 and cb.engine_state == "running")
        np.testing.assert_array_equal(cb.generate(TOKENS, max_new_tokens=11), expected)
        assert cb.snapshot()["engine_restarts"] == 1
    finally:
        cb.close()
    monkeypatch.delenv("MODELX_FAULT_PLAN")
    cb = ContinuousBatcher(srv, max_slots=2, chunk_size=4)  # unset: no wrapper
    try:
        assert getattr(cb._chunk, "__wrapped__", None) is None
    finally:
        cb.close()


_SERVER = []


def _tiny_server():
    if not _SERVER:
        import tempfile

        from modelx_tpu_torch.dl.serve import ModelServer
        from tests.test_torch_continuous import write_tiny_fp32

        d = tempfile.mkdtemp(prefix="faults-tiny-")
        write_tiny_fp32(d)
        srv = ModelServer(d, dtype="float32", device="cpu", max_seq_len=96)
        srv.load()
        _SERVER.append(srv)
    return _SERVER[0]


def test_env_short_read_is_retried_by_the_loader(monkeypatch, tmp_path):
    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors

    g = torch.Generator().manual_seed(0)
    want = {f"w{i}": torch.randn(33, 17, generator=g) for i in range(6)}
    want["ids"] = torch.arange(40, dtype=torch.int64)
    path = str(tmp_path / "model.safetensors")
    st.write_safetensors(path, want)
    # reads 0 and 1 are the header; 2 is the first tensor's range, 4 another
    monkeypatch.setenv("MODELX_FAULT_PLAN", json.dumps({"seed": 0, "rules": [
        {"op": "loader.read", "truncate_at": [2, 4], "keep_bytes": 5}]}))
    got, _ = load_safetensors(LocalFileSource(path), "cpu", concurrency=1)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def _twin_stores(tmp_path, plans=(None, None), faulty=False):
    jinner, tinner = JLocal(str(tmp_path / "j")), TLocal(str(tmp_path / "t"))
    jfs = jfaults.FaultyFSProvider(jinner, plans[0]) if faulty else jinner
    tfs = tfaults.FaultyFSProvider(tinner, plans[1]) if faulty else tinner
    return (jinner, tinner), (JStore(jfs, refresh_on_init=False),
                              TStore(tfs, refresh_on_init=False))


def test_torn_write_is_quarantined_by_both_scrubs(tmp_path):
    jplan, tplan = jfaults.FaultPlan(seed=3), tfaults.FaultPlan(seed=3)
    for plan in (jplan, tplan):
        # fs.put call 0 is the upload marker, call 1 the blob: tear the blob
        plan.add("fs.put", truncate_at=[1], keep_bytes=4)
    (jinner, tinner), (jstore, tstore) = _twin_stores(tmp_path, (jplan, tplan), faulty=True)
    data = b"weights that will tear"
    digest = str(JDigest.from_bytes(data))
    assert str(TDigest.from_bytes(data)) == digest
    with pytest.raises(jfaults.InjectedCrash) as je:
        jstore.put_blob(REPO, digest, JBlob(io.BytesIO(data), len(data), ""))
    with pytest.raises(tfaults.InjectedCrash) as te:
        tstore.put_blob(REPO, digest, TBlob(io.BytesIO(data), len(data), ""))
    assert str(te.value).replace(str(tmp_path / "t"), "") == \
        str(je.value).replace(str(tmp_path / "j"), "")
    assert tinner.get(tblob_path(REPO, digest)).read_all() == \
        jinner.get(jblob_path(REPO, digest)).read_all() == data[:4]
    jres = jscrub.scrub_repository(JStore(jinner), REPO)
    tres = tscrub.scrub_repository(TStore(tinner), REPO)
    assert tres.quarantined == jres.quarantined == [digest]
    assert tres.to_json() == jres.to_json()


def test_manifest_persisted_crash_recovers_the_same(tmp_path):
    out = []
    for mod_faults, Store, Local, Blob, Desc, Manifest, scrub, side in (
            (jfaults, JStore, JLocal, JBlob, JDesc, JManifest, jscrub, "j"),
            (tfaults, TStore, TLocal, TBlob, TDesc, TManifest, tscrub, "t")):
        inner = Local(str(tmp_path / side))
        plan = mod_faults.FaultPlan(seed=4)
        plan.add("store.manifest_persisted", errors_at=[1],
                 error=mod_faults.InjectedCrash("host died"))
        store = Store(inner, fault_plan=plan)
        for tag, data in (("v0", b"version zero"), ("v1", b"committed but unindexed")):
            digest = str(JDigest.from_bytes(data))
            store.put_blob(REPO, digest, Blob(io.BytesIO(data), len(data), ""))
            desc = Desc(name=f"w-{tag}.bin", digest=digest, size=len(data),
                        modified="2026-01-01T00:00:00Z")
            if tag == "v1":
                with pytest.raises(mod_faults.InjectedCrash, match="host died"):
                    store.put_manifest(REPO, tag, "", Manifest(blobs=[desc]))
            else:
                store.put_manifest(REPO, tag, "", Manifest(blobs=[desc]))
        stale = ([e.name for e in store.get_index(REPO).manifests], store.exists_manifest(
            REPO, "v1"), digest in store.active_uploads(REPO))
        restarted = Store(inner)
        results = scrub.reconcile(restarted, rehash=False)
        healed = (sorted(e.name for e in restarted.get_index(REPO).manifests),
                  [e.name for e in restarted.get_global_index().manifests],
                  [r.repository for r in results])
        restarted.put_manifest(REPO, "v1", "", Manifest(blobs=[desc]))
        out.append((stale, healed, digest in restarted.active_uploads(REPO)))
    assert out[1] == out[0]
    assert out[0] == ((["v0"], True, True), (["v0", "v1"], [REPO], [REPO]), False)


def test_the_tier_store_takes_the_env_plan(monkeypatch):
    from modelx_tpu_torch.dl.tiers import TierStore

    monkeypatch.setenv("MODELX_FAULT_PLAN", json.dumps({"seed": 2, "rules": [
        {"op": "tiers.demote", "errors_at": [0], "crash": True}]}))
    store = TierStore(host_budget_bytes=1 << 20)
    assert store.fault_plan is not None and store.fault_plan.has("tiers.demote")
    explicit = tfaults.FaultPlan()
    assert TierStore(fault_plan=explicit).fault_plan is explicit
    monkeypatch.delenv("MODELX_FAULT_PLAN")
    assert TierStore().fault_plan is None


def test_pod_kill_switch_and_wrappers_match(tmp_path):
    """``wrap_dispatch`` passes through and fires at its index; the byte
    source's short read lands the head in the caller's buffer first."""
    for mod in (jfaults, tfaults):
        plan = mod.FaultPlan(seed=0).add("engine.dispatch", errors_at=[1])
        fn = mod.wrap_dispatch(lambda x: x + 1, plan)
        assert fn(1) == 2
        with pytest.raises(OSError, match="injected fault on engine.dispatch"):
            fn(1)
        assert fn.__wrapped__(5) == 6
    p = tmp_path / "blob"
    p.write_bytes(bytes(range(64)))
    from modelx_tpu_torch.dl.loader import LocalFileSource

    plan = tfaults.FaultPlan().add("loader.read", truncate_at=[0], keep_bytes=6)
    src = tfaults.FaultyByteSource(LocalFileSource(str(p)), plan)
    buf = bytearray(16)
    with pytest.raises(OSError, match="short read: 6/16"):
        src.read_range(8, 16, buf)
    assert bytes(buf[:6]) == bytes(range(8, 14))
