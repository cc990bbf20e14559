"""The port's registry operations (modelx_tpu_torch/client/ops.py) against
the JAX client's, on the CPU, on the same registries (the port's registry
server over memory stores): ``copy_model`` between registries (the second
copy moves 0 bytes), ``diff_versions`` with and without tensor-index
annotations, ``verify_repo`` on a clean repository, across versions that
share blobs, and on a corrupted blob; a stream cut mid-blob is the same
typed 502. Tolerance: exact equality of the result dicts.
"""

import io

import numpy as np
import pytest

from modelx_tpu.client import ops as jops
from modelx_tpu.client.client import Client as JClient
from modelx_tpu_torch import errors as terrors
from modelx_tpu_torch.client import ops as tops
from modelx_tpu_torch.client.client import Client as TClient
from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.registry.fs import MemoryFSProvider
from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port
from modelx_tpu_torch.registry.store import blob_digest_path
from modelx_tpu_torch.registry.store_fs import FSRegistryStore


@pytest.fixture
def registries():
    servers, bases, stores = [], [], []
    for _ in range(3):
        store = FSRegistryStore(MemoryFSProvider())
        srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"), store=store)
        bases.append(srv.serve_background())
        servers.append(srv)
        stores.append(store)
    yield bases, stores
    for srv in servers:
        srv.shutdown()


def _dir(tmp_path, name, tensors=None, weights=b"W" * 8192):
    d = tmp_path / name
    d.mkdir()
    (d / "modelx.yaml").write_text("description: ops twin\n")
    (d / "weights.bin").write_bytes(weights)
    (d / "vocab.txt").write_text("a\nb\n")
    if tensors is not None:
        st.write_safetensors(str(d / "model.safetensors"), tensors)
    return str(d)


def _remotes(base):
    return JClient(base, quiet=True).remote, TClient(base, quiet=True).remote


def test_copy_equal_and_the_second_copy_moves_nothing(registries, tmp_path):
    (src, dst_j, dst_t), _ = registries
    TClient(src, quiet=True).push("library/m", "v1", _dir(tmp_path, "m"))
    TClient(src, quiet=True).push("library/m", "v2", _dir(tmp_path, "m2", weights=b"V" * 9000))
    js, ts = _remotes(src)
    jlog, tlog = [], []
    for ver in ("v1", "v2", "v2"):
        jout = jops.copy_model(js, "library/m", ver, JClient(dst_j, quiet=True).remote,
                               "library/m", ver, log=jlog.append)
        tout = tops.copy_model(ts, "library/m", ver, TClient(dst_t, quiet=True).remote,
                               "library/m", ver, log=tlog.append)
        assert tout == jout
    assert tlog == jlog
    assert tout["bytes"] == 0 and tout["skipped"] == tout["blobs"]
    jm = JClient(dst_j, quiet=True).get_manifest("library/m", "v2")
    tm = TClient(dst_t, quiet=True).get_manifest("library/m", "v2")
    assert tm.encode() == jm.encode()


def test_diff_equal(registries, tmp_path):
    (src, _, _), _ = registries
    c = TClient(src, quiet=True)
    c.push("library/t", "v1", _dir(tmp_path, "a", {"a": np.ones((2, 2), np.float32),
                                                   "b": np.ones((3,), np.float32)}))
    c.push("library/t", "v2", _dir(tmp_path, "b", {"a": np.ones((4, 2), np.float32),
                                                   "c": np.ones((3,), np.float32)},
                                   weights=b"X" * 10))
    c.push("library/t", "v3", _dir(tmp_path, "c"))
    js, ts = _remotes(src)
    for a, b in (("v1", "v2"), ("v2", "v1"), ("v1", "v1"), ("v1", "v3"), ("v3", "v2")):
        jout = jops.diff_versions(js, "library/t", a, js, "library/t", b)
        assert tops.diff_versions(ts, "library/t", a, ts, "library/t", b) == jout, (a, b)
    assert jops.diff_versions(js, "library/t", "v1", js, "library/t", "v2")["tensors"] == {
        "added": ["c"], "removed": ["b"], "layout_changed": ["a"]}


def test_verify_equal_clean_shared_and_corrupt(registries, tmp_path):
    (src, _, _), (store, _, _) = registries
    c = TClient(src, quiet=True)
    d = _dir(tmp_path, "m")
    c.push("library/m", "v1", d)
    c.push("library/m", "v2", d)  # the same blobs: hashed once
    js, ts = _remotes(src)
    for ver in ("", "v1"):
        jlog, tlog = [], []
        jout = jops.verify_repo(js, "library/m", ver, log=jlog.append)
        assert tops.verify_repo(ts, "library/m", ver, log=tlog.append) == jout
        assert tlog == jlog and jout["errors"] == []
    victim = next(b for b in c.get_manifest("library/m", "v1").blobs if b.name == "weights.bin")
    store.fs.put(blob_digest_path("library/m", victim.digest), io.BytesIO(b"X" * victim.size),
                 victim.size)
    jout = jops.verify_repo(js, "library/m")
    tout = tops.verify_repo(ts, "library/m")
    assert tout == jout and len(tout["errors"]) == 2
    assert "digest mismatch" in tout["errors"][0] and "weights.bin" in tout["errors"][0]


def test_a_cut_stream_is_the_typed_502():
    class Remote:
        def get_blob_content(self, repository, digest):
            yield b"head"
            raise ConnectionResetError("peer reset")

    from modelx_tpu_torch.types import Descriptor

    with pytest.raises(terrors.ErrorInfo) as e:
        tops._stream_and_hash(Remote(), "r", Descriptor(name="w.bin", digest="sha256:0"), None)
    assert e.value.http_status == 502 and "w.bin interrupted" in str(e.value)
