"""The port's garbage collection and scrub (registry/gc.py,
registry/scrub.py) against the JAX package's, on the CPU: the same store
content (committed blobs, an orphan, a corrupt blob, a dangling manifest
reference, an in-flight upload marker) on the in-memory FS, the local FS
and S3 (tests/fake_s3.py) gives equal ``GCResult`` and ``ScrubResult``
JSON, for every grace, sample and seed tried; the registry's two routes
answer the JAX registry's bodies.

Tolerance: exact equality of the JSON.
"""

import io
import json
import urllib.request

import pytest

from modelx_tpu.registry import gc as jgc
from modelx_tpu.registry import scrub as jscrub
from modelx_tpu.registry.fs import LocalFSProvider as JLocalFS
from modelx_tpu.registry.fs import MemoryFSProvider as JMemoryFS
from modelx_tpu.registry.fs_s3 import S3Options as JS3Options
from modelx_tpu.registry.server import Options as JOptions
from modelx_tpu.registry.server import RegistryServer as JRegistryServer
from modelx_tpu.registry.store import BlobContent as JBlobContent
from modelx_tpu.registry.store_fs import FSRegistryStore as JFSStore
from modelx_tpu.registry.store_s3 import S3RegistryStore as JS3Store
from modelx_tpu.types import Manifest as JManifest
from modelx_tpu_torch.registry import gc as tgc
from modelx_tpu_torch.registry import scrub as tscrub
from modelx_tpu_torch.registry.fs import LocalFSProvider, MemoryFSProvider
from modelx_tpu_torch.registry.fs_s3 import S3Options
from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port
from modelx_tpu_torch.registry.store import BlobContent, quarantine_path
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.registry.store_s3 import S3RegistryStore
from modelx_tpu_torch.types import Digest, Manifest
from tests.fake_s3 import FakeS3

REPO = "library/gcdemo"
BLOBS = {name: bytes([i]) * (100 + 37 * i) for i, name in enumerate(
    ["w1.bin", "w2.bin", "orphan.bin", "corrupt.bin", "inflight.bin"])}


def _digest(data: bytes) -> str:
    return str(Digest.from_bytes(data))


def _populate(store, blob_content, manifest_cls, corrupt):
    """The same content through either package's store API: v1 commits
    w1, w2 and corrupt; v2 names a blob that was never uploaded; orphan and
    inflight are uploaded and never committed, inflight under a live
    upload marker; then ``corrupt(key)`` rewrites corrupt.bin's bytes."""
    for name, data in BLOBS.items():
        store.put_blob(REPO, _digest(data), blob_content(io.BytesIO(data), len(data)))
    for name in ("orphan.bin",):
        store.clear_upload(REPO, _digest(BLOBS[name]))
    descs = [{"name": n, "digest": _digest(BLOBS[n]), "size": len(BLOBS[n])}
             for n in ("w1.bin", "w2.bin", "corrupt.bin")]
    store.put_manifest(REPO, "v1", "", manifest_cls.from_json({"blobs": descs}))
    missing = {"name": "gone.bin", "digest": "sha256:" + "7" * 64, "size": 5}
    # v2 commits through the FS layer without verification (a torn store)
    store._commit_manifest(REPO, "v2", "", manifest_cls.from_json({"blobs": descs[:1] + [missing]}))
    store.mark_upload(REPO, _digest(BLOBS["inflight.bin"]))
    corrupt(_digest(BLOBS["corrupt.bin"]))


def _fs_backends(tmp_path):
    def memory():
        t, j = MemoryFSProvider(), JMemoryFS()

        def corrupt_t(d):
            t.put(f"{REPO}/blobs/sha256/{d.split(':')[1]}", io.BytesIO(b"bad!"), 4)

        def corrupt_j(d):
            j.put(f"{REPO}/blobs/sha256/{d.split(':')[1]}", io.BytesIO(b"bad!"), 4)

        return FSRegistryStore(t), JFSStore(j), corrupt_t, corrupt_j, None

    def local():
        troot, jroot = tmp_path / "t", tmp_path / "j"

        def corrupt(root):
            def fn(d):
                (root / REPO / "blobs" / "sha256" / d.split(":")[1]).write_bytes(b"bad!")
            return fn

        return (FSRegistryStore(LocalFSProvider(str(troot))), JFSStore(JLocalFS(str(jroot))),
                corrupt(troot), corrupt(jroot), None)

    def s3():
        # one fake each: the fake keys objects without their bucket
        fakes = [FakeS3(), FakeS3()]
        turl, jurl = (f.start() for f in fakes)
        t = S3RegistryStore(S3Options(url=turl, access_key="AK", secret_key="SK", bucket="b"))
        j = JS3Store(JS3Options(url=jurl, access_key="AK", secret_key="SK", bucket="b"))

        def corrupt(fake):
            def fn(d):
                key = f"registry/{REPO}/blobs/sha256/{d.split(':')[1]}"
                with fake.bucket.lock:
                    fake.bucket.objects[key] = (b"bad!", "")
            return fn

        return t, j, corrupt(fakes[0]), corrupt(fakes[1]), fakes

    return {"memory": memory, "local": local, "s3": s3}


@pytest.fixture(params=["memory", "local", "s3"])
def stores(request, tmp_path):
    t, j, ct, cj, fakes = _fs_backends(tmp_path)[request.param]()
    _populate(t, BlobContent, Manifest, ct)
    _populate(j, JBlobContent, JManifest, cj)
    yield t, j
    for fake in fakes or ():
        fake.stop()


def test_scrub_results_equal(stores):
    t, j = stores
    got = tscrub.scrub_repository(t, REPO).to_json()
    want = jscrub.scrub_repository(j, REPO).to_json()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["quarantined"] == [_digest(BLOBS["corrupt.bin"])]
    assert got["dangling"] and not got["clean"]
    assert t.fs.exists(quarantine_path(REPO, got["quarantined"][0]))
    assert not t.exists_blob(REPO, got["quarantined"][0])
    # quarantined: the address 404s; a second scrub finds it dangling
    again = tscrub.scrub_repository(t, REPO).to_json()
    assert again == jscrub.scrub_repository(j, REPO).to_json()
    assert again["quarantined"] == []


@pytest.mark.parametrize("sample,seed", [(1, 0), (2, 7), (3, 1), (99, 3)])
def test_sampled_scrub_results_equal(stores, sample, seed):
    t, j = stores
    got = tscrub.scrub_repository(t, REPO, sample=sample, seed=seed).to_json()
    want = jscrub.scrub_repository(j, REPO, sample=sample, seed=seed).to_json()
    assert got == want


@pytest.mark.parametrize("grace", [600.0, 0.0])
def test_gc_results_equal(stores, grace):
    t, j = stores
    got = tgc.gc_blobs(t, REPO, grace_s=grace).to_json()
    want = jgc.gc_blobs(j, REPO, grace_s=grace).to_json()
    assert got == want
    if grace == 0:
        assert sorted(got["deleted_digests"]) == sorted(
            [_digest(BLOBS["orphan.bin"]), _digest(BLOBS["inflight.bin"])])
    else:
        assert got["deleted"] == 0 and got["skipped_in_flight"] == 1
    assert sorted(t.list_blobs(REPO)) == sorted(j.list_blobs(REPO))


def test_gc_all_and_reconcile_equal(stores):
    t, j = stores
    got = [r.to_json() for r in tgc.gc_blobs_all(t, grace_s=0)]
    want = [r.to_json() for r in jgc.gc_blobs_all(j, grace_s=0)]
    assert got == want and got[0]["deleted"] == 2
    for rehash in (False, True):
        assert [r.to_json() for r in tscrub.reconcile(t, rehash=rehash)] == \
            [r.to_json() for r in jscrub.reconcile(j, rehash=rehash)]


def test_gc_of_an_unknown_repository():
    t, j = FSRegistryStore(MemoryFSProvider()), JFSStore(JMemoryFS())
    assert tgc.gc_blobs(t, "library/none").to_json() == jgc.gc_blobs(j, "library/none").to_json()
    assert tscrub.scrub_repository(t, "library/none").to_json() == \
        jscrub.scrub_repository(j, "library/none").to_json()


def _post(base: str, path: str) -> tuple[int, bytes]:
    req = urllib.request.Request(base + path, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("path", ["/garbage-collect", "/garbage-collect?grace=0",
                                  "/garbage-collect?grace=x", "/scrub", "/scrub?sample=2&seed=5",
                                  "/scrub?sample=z"])
def test_routes_answer_the_jax_registry_bodies(tmp_path, path):
    t, j, ct, cj, _ = _fs_backends(tmp_path)["memory"]()
    _populate(t, BlobContent, Manifest, ct)
    _populate(j, JBlobContent, JManifest, cj)
    tsrv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"), store=t)
    jsrv = JRegistryServer(JOptions(listen=f"127.0.0.1:{free_port()}"), store=j)
    tbase, jbase = tsrv.serve_background(), jsrv.serve_background()
    try:
        got, want = _post(tbase, f"/{REPO}{path}"), _post(jbase, f"/{REPO}{path}")
        assert got == want
        assert got[0] in (200, 400)
    finally:
        tsrv.shutdown()
        jsrv.shutdown()


# -- the chaos sweep (make chaos-torch: under the port's lockdep) ----------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_torn_push_storm_converges(tmp_path):
    """tests/test_scrub.py:205 on the port's store: many pushes with a
    seeded scatter of torn writes (same-length bit rot, so only the hash
    scrub can catch it); after a restart and a full scrub every address
    serves verified bytes or 404s."""
    import random

    from modelx_tpu_torch import errors
    from modelx_tpu_torch.registry.store import blob_digest_path
    from modelx_tpu_torch.types import Descriptor

    inner = LocalFSProvider(str(tmp_path / "reg"))
    rng = random.Random(1234)
    torn = []
    store = FSRegistryStore(inner, refresh_on_init=False)
    for i in range(20):
        data = b"model-shard-%03d" % i
        digest = str(Digest.from_bytes(data))
        if rng.random() < 0.3:
            junk = data[:6] + b"X" * (len(data) - 6)
            inner.put(blob_digest_path(REPO, digest), io.BytesIO(junk), len(junk), "")
            torn.append(digest)
        else:
            store.put_blob(REPO, digest, BlobContent(io.BytesIO(data), len(data), ""))
        desc = Descriptor(name=f"s{i}.bin", digest=digest, size=len(data))
        store.put_manifest(REPO, f"v{i}", "", Manifest(blobs=[desc]))
    assert torn, "the seed tears no write"
    restarted = FSRegistryStore(inner)
    result = tscrub.scrub_repository(restarted, REPO)
    assert sorted(result.quarantined) == sorted(torn)
    for i in range(20):
        data = b"model-shard-%03d" % i
        digest = str(Digest.from_bytes(data))
        if digest in torn:
            with pytest.raises(errors.ErrorInfo):
                restarted.get_blob(REPO, digest)
        else:
            assert restarted.get_blob(REPO, digest).content.read() == data
