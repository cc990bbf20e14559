"""The port's pull engine and offline ladder (modelx_tpu_torch.client.pull,
dl.manifest_cache, dl.initializer.pull_model) against the JAX package's,
on the CPU, with the cases of tests/test_outage.py:

- the puller's hash-skip downloads nothing into an up-to-date dest, a
  damaged file is fetched again, an interrupted download resumes its
  prefix, a directory blob extracts to the pushed tree;
- with the registry down and a pinned manifest, the manifest (and the
  modelx.yaml) serve from the manifest cache and ``pull_model``
  materialises from the blob cache; where it cannot, it raises
  ``OfflineUnavailableError`` in the same cases as the JAX package;
- mirror failover sets ``last_source`` and the control-plane state as the
  JAX client does;
- ``ControlPlaneHealth`` and ``ManifestCache`` give the JAX package's
  states and entries on the same events.

Files compare byte for byte (no tolerance)."""

import filecmp
import os

import pytest

from modelx_tpu import errors as jerrors
from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu.dl import blob_cache as jbc
from modelx_tpu.dl import initializer as jinit
from modelx_tpu.dl import manifest_cache as jmc
from modelx_tpu.registry.server import free_port
from modelx_tpu.types import Manifest as JaxManifest
from modelx_tpu_torch import errors as terrors
from modelx_tpu_torch.client.client import Client
from modelx_tpu_torch.client.pull import Puller
from modelx_tpu_torch.dl import blob_cache as tbc
from modelx_tpu_torch.dl import initializer as tinit
from modelx_tpu_torch.dl import manifest_cache as tmc
from modelx_tpu_torch.types import Manifest
from tests.test_torch_registry import start_port_registry, write_model_dir

REPO = "library/m"
PORT = {"client": Client, "mc": tmc, "bc": tbc, "init": tinit, "errors": terrors}
JAX = {"client": JaxClient, "mc": jmc, "bc": jbc, "init": jinit, "errors": jerrors}


@pytest.fixture(autouse=True)
def fresh_control_plane(tmp_path, monkeypatch):
    """Each test starts from clean health trackers and its own manifest
    caches (one per package), and leaves both packages unconfigured; the
    clients' retry backoff is 0 s (same attempts, no sleeping)."""
    for impl, name in ((PORT, "port"), (JAX, "jax")):
        monkeypatch.setattr(impl["client"]("http://127.0.0.1:1").remote.__class__,
                            "RETRY_BACKOFF_S", 0.0)
        mc = impl["mc"]
        mc.health().reset()
        mc.configure_default(str(tmp_path / f"manifest-cache-{name}"))
    yield
    for impl in (PORT, JAX):
        mc = impl["mc"]
        mc.health().reset()
        with mc._default_lock:
            mc._default = None
            mc._default_configured = False


@pytest.fixture
def model_dir(tmp_path_factory):
    return write_model_dir(tmp_path_factory.mktemp("pull-model"))


def _client(impl, base):
    c = impl["client"](base, quiet=True)
    c.remote._retry_sleep = lambda *a: None  # injected clock: no real backoff
    return c


def _sever(impl, client):
    """Drop the client's kept-alive sockets, as a dead registry would."""
    if impl is JAX:
        client.remote.session.close()
    else:
        client.remote.close()


def _registry(model_dir):
    srv, base = start_port_registry()
    JaxClient(base, quiet=True).push(REPO, "v1", model_dir)
    return srv, base


# -- the puller -----------------------------------------------------------------


def test_hash_skip_and_repair(model_dir, tmp_path):
    srv, base = _registry(model_dir)
    try:
        client = Client(base, quiet=True)
        dest = str(tmp_path / "dest")
        first = Puller(client.remote)
        first.pull(REPO, "v1", dest)
        assert first.stats["downloaded"] == 4 and first.stats["up_to_date"] == 0
        again = Puller(client.remote)
        again.pull(REPO, "v1", dest)
        assert again.stats == {"downloaded": 0, "downloaded_bytes": 0, "up_to_date": 4}
        with open(os.path.join(dest, "notes.txt"), "w") as f:
            f.write("damaged")
        repair = Puller(client.remote)
        repair.pull(REPO, "v1", dest)
        assert repair.stats["downloaded"] == 1 and repair.stats["up_to_date"] == 3
        assert filecmp.cmp(os.path.join(model_dir, "notes.txt"),
                           os.path.join(dest, "notes.txt"), shallow=False)
    finally:
        srv.shutdown()


def test_interrupted_download_resumes_its_prefix(model_dir, tmp_path):
    srv, base = _registry(model_dir)
    try:
        client = Client(base, quiet=True)
        manifest = client.get_manifest(REPO, "v1")
        desc = next(b for b in manifest.blobs if b.name == "model.safetensors")
        dest = tmp_path / "dest"
        dest.mkdir()
        import hashlib

        part = dest / (f".partial-{desc.digest.split(':', 1)[1][:16]}-"
                       f"{hashlib.sha256(desc.name.encode()).hexdigest()[:8]}")
        with open(os.path.join(model_dir, desc.name), "rb") as f:
            part.write_bytes(f.read(desc.size // 2))
        puller = Puller(client.remote)
        puller.pull_blobs(REPO, Manifest(blobs=[desc]), str(dest))
        assert puller.stats["downloaded_bytes"] == desc.size - desc.size // 2
        assert filecmp.cmp(os.path.join(model_dir, desc.name), str(dest / desc.name),
                           shallow=False)
        assert not part.exists()
    finally:
        srv.shutdown()


# -- the offline ladder, against the JAX package ------------------------------------


def _stale_manifest(impl, model_dir):
    srv, base = _registry(model_dir)
    try:
        client = _client(impl, base)
        live = client.get_manifest(REPO, "v1")
        config = client.get_config_content(REPO, "v1")
    finally:
        srv.shutdown()
    _sever(impl, client)
    cached = client.get_manifest(REPO, "v1")
    out = [cached.encode() == live.encode(), client.remote.last_source,
           client.get_config_content(REPO, "v1") == config]
    h = impl["mc"].health().status()
    out += [h["state"], h["offline_serves_total"] >= 1,
            impl["mc"].default_cache().stats["stale_served"]]
    with pytest.raises(impl["errors"].ErrorInfo):
        client.get_manifest("library/never-pulled", "v1")
    return out + [impl["mc"].health().state]


def test_pinned_manifest_serves_through_registry_death(model_dir):
    got = _stale_manifest(PORT, model_dir)
    assert got == _stale_manifest(JAX, model_dir)
    assert got[:2] == [True, "cache"] and got[3] == "offline"


def _offline_pull(impl, model_dir, tmp_path, warm: bool):
    cache = impl["bc"].BlobCache(str(tmp_path / f"blobs-{warm}"))
    srv, base = _registry(model_dir)
    try:
        if warm:
            first = impl["init"].pull_model(f"{base}/{REPO}@v1", str(tmp_path / "d1"),
                                            cache=cache)
            assert first["source"] == "registry"
        else:
            _client(impl, base).get_manifest(REPO, "v1")  # pin the manifest only
    finally:
        srv.shutdown()
    try:
        out = impl["init"].pull_model(f"{base}/{REPO}@v1", str(tmp_path / "d2"), cache=cache)
    except impl["mc"].OfflineUnavailableError as e:
        return ["OfflineUnavailableError", str(e).split(":")[0]]
    same = filecmp.cmp(str(tmp_path / "d1" / "model.safetensors"),
                       str(tmp_path / "d2" / "model.safetensors"), shallow=False)
    return [out["source"], out["cache_hits"], out["blobs"], same]


@pytest.mark.parametrize("warm", [True, False], ids=["warm-cache", "cold-cache"])
def test_offline_pull_equals_jax(model_dir, tmp_path, warm):
    """The model dir carries a directory blob: the JAX package refuses to
    materialise it offline, and so must the port; a model of file blobs
    only pulls fully offline from a warm cache."""
    got = _offline_pull(PORT, model_dir, tmp_path / "port", warm)
    want = _offline_pull(JAX, model_dir, tmp_path / "jax", warm)
    assert got == want


def test_warm_pull_of_file_blobs_completes_offline(model_dir, tmp_path):
    import shutil

    shutil.rmtree(os.path.join(model_dir, "tokenizer"))
    for impl, name in ((PORT, "port"), (JAX, "jax")):
        got = _offline_pull(impl, model_dir, tmp_path / name, warm=True)
        assert got == ["cache", 1, 1, True], name  # modelFiles selects the weights


def _mirror_failover(impl, model_dir):
    mirror, mbase = _registry(model_dir)
    primary_port = free_port()  # nothing listens: the primary is down
    try:
        c = impl["client"](f"http://127.0.0.1:{primary_port}", quiet=True)
        c.remote.endpoints.append(mbase)
        c.remote._rotation = type(c.remote._rotation)(2)
        c.remote._retry_sleep = lambda *a: None
        m = c.get_manifest(REPO, "v1")
        first = (c.remote.last_source, impl["mc"].health().state, len(m.blobs))
        c.get_manifest(REPO, "v1")
        return [first, c.remote.last_source, c.remote._rotation.preferred]
    finally:
        mirror.shutdown()


def test_mirror_failover_sets_last_source_as_jax(model_dir):
    got = _mirror_failover(PORT, model_dir)
    assert got == _mirror_failover(JAX, model_dir)
    assert got[0][:2] == ("mirror", "degraded") and got[1] == "mirror"


# -- health and manifest cache units, against the JAX package ---------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _health_trace(mc):
    clock = _Clock()
    h = mc.ControlPlaneHealth(clock=clock)
    out = [h.status()]
    for event, dt in (("note_ok", 1), ("note_failure", 2), ("note_ok", 5),
                      ("note_ok", 40), ("note_offline_serve", 1), ("mirror", 3),
                      ("note_ok", 31)):
        clock.t += dt
        if event == "mirror":
            h.note_ok(mirror=True)
        else:
            getattr(h, event)()
        out.append(h.status())
    return out


def test_control_plane_health_equals_jax():
    assert _health_trace(tmc) == _health_trace(jmc)


def test_manifest_cache_entries_equal_jax(tmp_path):
    from modelx_tpu.types import Descriptor as JD

    from modelx_tpu_torch.types import Descriptor as TD

    for mc, M, D, name in ((tmc, Manifest, TD, "port"), (jmc, JaxManifest, JD, "jax")):
        cache = mc.ManifestCache(str(tmp_path / name))
        m = M(blobs=[D(name="w", digest="sha256:" + "1" * 64, size=3)])
        cache.put("http://r/", REPO, "", m)
        cache.put("http://r", REPO, "latest", m, config_yaml=b"a: 1\n")
        cache.put("http://r", REPO, "v2", m)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 2
    tc, jc = tmc.ManifestCache(str(tmp_path / "port")), jmc.ManifestCache(str(tmp_path / "jax"))
    for ver in ("latest", "", "v2", "v3"):
        t, j = tc.lookup("http://r", REPO, ver), jc.lookup("http://r", REPO, ver)
        assert (t and t.encode()) == (j and j.encode())
        assert tc.lookup_config("http://r", REPO, ver) == jc.lookup_config("http://r", REPO, ver)
