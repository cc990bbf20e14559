"""The port's GCS provider (registry/fs_gcs.py, registry/store_gcs.py,
client/extension_gcs.py) on the CPU against tests/fake_gcs.py, as
tests/test_gcs.py holds the JAX package's: GOOG4-HMAC signing, signed
downloads, resumable uploads, the push/pull round trip with the bulk bytes
never crossing the registry, the initiation retry policy and the global
index over GCS listings; then both crossings of the wire against the JAX
package's GCS registry and client, and equal location JSON at one clock.

Tolerance: exact equality.
"""

import datetime
import io
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import requests

from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu.registry import sigv4 as jsig
from modelx_tpu.registry.fs_gcs import GCSOptions as JaxGCSOptions
from modelx_tpu.registry.server import Options as JaxOptions
from modelx_tpu.registry.server import RegistryServer as JaxRegistryServer
from modelx_tpu.registry.store_gcs import GCSRegistryStore as JaxGCSStore
from modelx_tpu_torch import errors
from modelx_tpu_torch.client.client import Client
from modelx_tpu_torch.client.extension_gcs import GCSExtension
from modelx_tpu_torch.registry import sigv4
from modelx_tpu_torch.registry.fs_gcs import GCSFSProvider, GCSOptions
from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port
from modelx_tpu_torch.registry.store import BlobContent
from modelx_tpu_torch.registry.store_gcs import GCSRegistryStore
from modelx_tpu_torch.types import (
    BlobLocation,
    BlobLocationPurposeDownload,
    BlobLocationPurposeUpload,
    Descriptor,
    Digest,
    Manifest,
)
from tests.fake_gcs import FakeGCS


@pytest.fixture
def gcs():
    srv = FakeGCS()
    url = srv.start()
    yield url
    srv.stop()


@pytest.fixture
def gcs_opts(gcs):
    return GCSOptions(url=gcs, access_key="GOOGAK", secret_key="GOOGSK", bucket="testbucket")


CREDS = sigv4.Credentials("AK", "SK", region="auto", service="storage")


class TestGoog4Signing:
    def test_goog4_spellings(self):
        url = sigv4.presign_url(CREDS, "GET", "https://storage.googleapis.com/b/k",
                                spec=sigv4.GOOG_SIG)
        assert "X-Goog-Algorithm=GOOG4-HMAC-SHA256" in url
        assert "X-Goog-Signature=" in url and "goog4_request" in url
        assert "X-Amz-" not in url

    def test_goog4_signed_headers_join_the_signature(self):
        url = sigv4.presign_url(CREDS, "POST", "https://storage.googleapis.com/b/k",
                                spec=sigv4.GOOG_SIG, signed_headers={"x-goog-resumable": "start"})
        assert "host%3Bx-goog-resumable" in url
        url2 = sigv4.presign_url(CREDS, "POST", "https://storage.googleapis.com/b/k",
                                 spec=sigv4.GOOG_SIG, signed_headers={"x-goog-resumable": "other"})
        assert url.rsplit("X-Goog-Signature=", 1)[1] != url2.rsplit("X-Goog-Signature=", 1)[1]

    def test_goog4_key_derivation_differs_from_aws(self):
        assert sigv4.signing_key(CREDS, "20260730") != sigv4.signing_key(
            CREDS, "20260730", spec=sigv4.GOOG_SIG)


class TestGCSFSProvider:
    def test_contract(self, gcs_opts):
        fs = GCSFSProvider(gcs_opts)
        fs.put("a/b.txt", io.BytesIO(b"hello"), 5, "text/plain")
        assert fs.exists("a/b.txt")
        assert fs.get("a/b.txt").read_all() == b"hello"
        assert fs.get("a/b.txt", offset=1, length=3).read_all() == b"ell"
        fs.put("a/c/d.txt", io.BytesIO(b"x"), 1)
        assert {m.name for m in fs.list("a", recursive=True)} == {"b.txt", "c/d.txt"}
        fs.remove("a/b.txt")
        assert not fs.exists("a/b.txt")


def _put(store, repo, data):
    digest = str(Digest.from_bytes(data))
    store.put_blob(repo, digest, BlobContent(io.BytesIO(data), len(data),
                                             "application/octet-stream"))
    return digest


class TestGCSStore:
    REPO = "library/gcsdemo"

    @pytest.fixture
    def store(self, gcs_opts):
        return GCSRegistryStore(gcs_opts)

    def test_upload_location_is_resumable(self, store):
        data = b"gcs blob"
        digest = str(Digest.from_bytes(data))
        loc = store.get_blob_location(self.REPO, digest, BlobLocationPurposeUpload,
                                      {"size": str(len(data))})
        assert loc.provider == "gcs"
        url = loc.properties["resumableUrl"]
        assert "X-Goog-Signature=" in url
        r = requests.post(url, headers={"x-goog-resumable": "start", "content-length": "0"})
        assert r.status_code == 201, r.text
        assert requests.put(r.headers["Location"], data=data).status_code == 200
        assert store.exists_blob(self.REPO, digest)

    def test_resumable_start_requires_signed_header(self, store):
        """A signed download URL is not replayable as an upload."""
        digest = _put(store, self.REPO, b"abc")
        loc = store.get_blob_location(self.REPO, digest, BlobLocationPurposeDownload, {})
        r = requests.post(loc.properties["url"], headers={"x-goog-resumable": "start"})
        assert r.status_code == 403

    def test_download_location_signed_get(self, store):
        data = bytes(range(256)) * 8
        digest = _put(store, self.REPO, data)
        loc = store.get_blob_location(self.REPO, digest, BlobLocationPurposeDownload, {})
        assert loc.provider == "gcs" and int(loc.properties["size"]) == len(data)
        assert requests.get(loc.properties["url"]).content == data
        r = requests.get(loc.properties["url"], headers={"Range": "bytes=3-6"})
        assert r.status_code == 206 and r.content == data[3:7]

    def test_commit_rejects_size_mismatch(self, store):
        digest = _put(store, self.REPO, b"short")
        bad = Descriptor(name="w.bin", digest=digest, size=10)
        with pytest.raises(errors.ErrorInfo):
            store.put_manifest(self.REPO, "v1", "", Manifest(blobs=[bad]))
        assert not store.exists_blob(self.REPO, digest)


def _model(tmp_path):
    src = tmp_path / "model"
    src.mkdir()
    (src / "modelx.yaml").write_text("framework: pytorch\n")
    (src / "weights.bin").write_bytes(bytes(range(256)) * 1024)  # 256 KiB
    return src


class TestGCSEndToEnd:
    def test_push_pull_round_trip(self, gcs_opts, tmp_path):
        store = GCSRegistryStore(gcs_opts)
        srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"), store=store)
        base = srv.serve_background()
        try:
            src = _model(tmp_path)
            client = Client(base, quiet=True)
            client.push("library/m", "v1", str(src))
            assert store.exists_blob("library/m",
                                     str(Digest.from_file(str(src / "weights.bin"))))
            out = tmp_path / "out"
            client.pull("library/m", "v1", str(out))
            assert (out / "weights.bin").read_bytes() == (src / "weights.bin").read_bytes()
            counters = srv.registry.metrics.counters
            assert counters.get("blob_put_bytes", 0) == counters.get("blob_get_bytes", 0) == 0
        finally:
            srv.shutdown()


def _counting_server(status: int):
    hits = [0]

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            hits[0] += 1
            self.send_response(status)
            self.send_header("Content-Length", "0")
            self.end_headers()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}/b/k", hits


@pytest.mark.parametrize("status,attempts", [(403, 1), (429, 3)], ids=["denied", "rate-limited"])
def test_initiation_retry_policy(status, attempts):
    """A deterministic 403 raises after one attempt; 429 retries to three."""
    httpd, url, hits = _counting_server(status)
    try:
        loc = BlobLocation(provider="gcs", purpose="upload", properties={"resumableUrl": url})
        with pytest.raises(errors.ErrorInfo) as ei:
            GCSExtension().upload(loc, Descriptor(size=3), io.BytesIO(b"abc"))
        assert ei.value.http_status == status
        assert hits[0] == attempts
    finally:
        httpd.shutdown()


def test_global_index_rebuilds_over_gcs_listings(gcs_opts):
    store = GCSRegistryStore(gcs_opts)
    data = b"one"
    digest = _put(store, "library/contract", data)
    store.put_manifest("library/contract", "v1", "",
                       Manifest(blobs=[Descriptor(name="a.bin", digest=digest, size=3)]))
    store.refresh_global_index()
    assert "library/contract" in {e.name for e in store.get_global_index().manifests}


# -- across the wire, against the JAX package ----------------------------------


def test_jax_client_pushes_to_the_port_gcs_registry_and_the_port_pulls(gcs_opts, tmp_path):
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"),
                         store=GCSRegistryStore(gcs_opts))
    base = srv.serve_background()
    try:
        src = _model(tmp_path)
        JaxClient(base, quiet=True).push("library/x", "v1", str(src))
        Client(base, quiet=True).pull("library/x", "v1", str(tmp_path / "out"))
        assert (tmp_path / "out" / "weights.bin").read_bytes() == \
            (src / "weights.bin").read_bytes()
    finally:
        srv.shutdown()


def test_port_client_pushes_to_the_jax_gcs_registry(gcs, tmp_path):
    store = JaxGCSStore(JaxGCSOptions(url=gcs, access_key="GOOGAK", secret_key="GOOGSK",
                                      bucket="testbucket"))
    srv = JaxRegistryServer(JaxOptions(listen=f"127.0.0.1:{free_port()}"), store=store)
    base = srv.serve_background()
    try:
        src = _model(tmp_path)
        Client(base, quiet=True).push("library/x", "v1", str(src))
        for name, cls in (("out", Client), ("jout", JaxClient)):
            cls(base, quiet=True).pull("library/x", "v1", str(tmp_path / name))
            assert (tmp_path / name / "weights.bin").read_bytes() == \
                (src / "weights.bin").read_bytes()
    finally:
        srv.shutdown()


def test_locations_equal_the_jax_gcs_registry(gcs, monkeypatch):
    now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
    monkeypatch.setattr(sigv4, "_now", lambda: now)
    monkeypatch.setattr(jsig, "_now", lambda: now)
    kw = dict(url=gcs, access_key="GOOGAK", secret_key="GOOGSK", bucket="shared")
    tsrv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"),
                          store=GCSRegistryStore(GCSOptions(**kw)))
    jsrv = JaxRegistryServer(JaxOptions(listen=f"127.0.0.1:{free_port()}"),
                             store=JaxGCSStore(JaxGCSOptions(**kw)))
    tbase, jbase = tsrv.serve_background(), jsrv.serve_background()
    try:
        data = b"gcs location"
        digest = str(Digest.from_bytes(data))
        up = f"/library/loc/blobs/{digest}/locations/upload?size={len(data)}"
        pair = [json.loads(urllib.request.urlopen(b + up, timeout=30).read())
                for b in (jbase, tbase)]
        assert pair[0] == pair[1] and "resumableUrl" in pair[0]["properties"]
        r = requests.post(pair[0]["properties"]["resumableUrl"],
                          headers={"x-goog-resumable": "start", "content-length": "0"})
        requests.put(r.headers["Location"], data=data)
        down = f"/library/loc/blobs/{digest}/locations/download"
        pair = [json.loads(urllib.request.urlopen(b + down, timeout=30).read())
                for b in (jbase, tbase)]
        assert pair[0] == pair[1]
    finally:
        tsrv.shutdown()
        jsrv.shutdown()
