"""The port's program store (modelx_tpu_torch.dl.program_store): the flash
kernel's compiled library as the program bundle, on the CPU, mirroring
tests/test_program_store.py.

There is no nvcc here, so bundles carry a stand-in file under the
library's name (``kernels.build.library_name()``); the card's test,
``tests/test_torch_kernels_cuda.py::test_a_bundled_library_installs_and_launches``,
installs and launches a real one. Held here:

- a bundle is a deterministic tar, ``meta.json`` first, keyed by the
  environment (torch and CUDA versions, compute capability and arch, the
  port's code version, the mesh) and stamped with ``csrc/``'s digest;
- it installs into ``$MODELX_COMPILE_CACHE`` (else the package's
  ``_build/``), never over an existing library, and ``load_library`` then
  binds it without running nvcc (``subprocess.run`` made to fail), with
  origin ``"bundle"``;
- every hardening case of the reference's ``TestBundleHardening``
  (garbage, truncation, version skew, a tampered member, traversal and
  stray names, a wrong format, no overwrite) skips for the same reason in
  both packages (the reason's words before the first colon, member names
  masked), and the port skips a source or environment skew too;
- the registry round trip on the port's registry server: a real
  descriptor, merged by name, a republish that is a no-op, another
  environment that coexists, the commit-delta retry, the pull through the
  blob cache, an annotation skew skipped without fetching;
- ``ModelServer.load`` installs a pulled bundle before its warm-up.
"""

import hashlib
import io
import json
import os
import re
import shutil
import tarfile

import pytest
import torch

from modelx_tpu.dl import aot_cache
from modelx_tpu.dl import program_store as jps
from modelx_tpu_torch import errors
from modelx_tpu_torch.client.client import Client
from modelx_tpu_torch.dl import program_store as ps
from modelx_tpu_torch.dl.blob_cache import BlobCache
from modelx_tpu_torch.kernels import build
from modelx_tpu_torch.types import (
    AnnotationProgramCode,
    AnnotationProgramCount,
    AnnotationProgramMesh,
    Digest,
    MediaTypeModelProgram,
)
from tests.test_torch_registry import start_port_registry, write_model_dir

LIB = b"\x7fELF a stand-in kernel library"
REPO_NAME = "library/programs"


def stand_in(d, data: bytes = LIB) -> str:
    """A build directory holding a stand-in file under the library's name."""
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, build.library_name())
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.fixture
def bundle(tmp_path):
    stand_in(str(tmp_path / "src"))
    return ps.build_bundle(str(tmp_path / "src"))


@pytest.fixture
def fresh_build(monkeypatch):
    """The build module's per-process state, empty, restored afterwards."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_info", None)
    monkeypatch.setattr(build, "_origins", {})


# -- bundle units -------------------------------------------------------------------


def test_build_is_deterministic_meta_first(tmp_path, bundle):
    assert ps.build_bundle(str(tmp_path / "src")) == bundle
    with tarfile.open(fileobj=io.BytesIO(bundle), mode="r:") as tar:
        assert tar.getnames() == [ps.META_MEMBER, build.library_name()]
    meta = ps._bundle_meta(bundle)
    framework, backend, code, mesh = ps._env()
    assert (meta["jax"], meta["backend"], meta["codeVersion"], meta["mesh"]) == (
        framework, backend, code, "dp=1")
    assert framework == f"torch {torch.__version__} cuda {torch.version.cuda or 'none'}"
    assert meta["sourceDigest"] == build.source_digest() and meta["nvcc"] == ""
    assert meta["artifacts"] == [{"name": build.library_name(),
                                  "sha256": hashlib.sha256(LIB).hexdigest(),
                                  "size": len(LIB)}]
    assert ps.bundle_program_count(bundle) == 1


def test_empty_dir_or_other_files_build_nothing(tmp_path):
    assert ps.build_bundle(str(tmp_path / "empty")) is None
    d = tmp_path / "other"
    d.mkdir()
    (d / "flash_attention-nothex.so").write_bytes(b"x")
    (d / "notes.txt").write_bytes(b"x")
    assert ps.build_bundle(str(d)) is None


def test_keys_select_the_named_library(tmp_path):
    d = str(tmp_path / "src")
    stand_in(d)
    old = "flash_attention-" + "0" * 16 + ".so"
    with open(os.path.join(d, old), "wb") as f:
        f.write(b"a library of older sources")
    names = tarfile.open(fileobj=io.BytesIO(ps.build_bundle(d, keys=[build.library_name()])),
                         mode="r:").getnames()
    assert names == [ps.META_MEMBER, build.library_name()]
    assert len(tarfile.open(fileobj=io.BytesIO(ps.build_bundle(d)), mode="r:").getnames()) == 3


def test_install_into_the_compile_cache_and_idempotence(tmp_path, bundle, monkeypatch):
    monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc"))
    assert build.build_dir() == str(tmp_path / "cc")
    assert build.library_path() == os.path.join(str(tmp_path / "cc"), build.library_name())
    stats = ps.install_bundle(bundle, build.build_dir())
    assert (stats["installed"], stats["skipped"]) == (1, 0)
    with open(build.library_path(), "rb") as f:
        assert f.read() == LIB
    again = ps.install_bundle(bundle, build.build_dir())
    assert (again["installed"], again["present"]) == (0, 1)
    monkeypatch.delenv("MODELX_COMPILE_CACHE")
    assert build.build_dir() == build.BUILD_DIR  # the package's _build/


def test_install_never_overwrites_a_local_library(tmp_path, bundle):
    dst = str(tmp_path / "dst")
    stand_in(dst, b"built here")
    assert ps.install_bundle(bundle, dst)["present"] == 1
    with open(os.path.join(dst, build.library_name()), "rb") as f:
        assert f.read() == b"built here"


def test_load_library_binds_the_installed_file_without_nvcc(tmp_path, bundle, monkeypatch,
                                                           fresh_build):
    monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc"))

    def no_nvcc(*a, **k):
        raise AssertionError(f"nvcc ran: {a}")

    bound = []
    monkeypatch.setattr(build.subprocess, "run", no_nvcc)
    monkeypatch.setattr(build, "bind", lambda path: bound.append(path) or object())
    assert ps.install_bundle(bundle, build.build_dir())["installed"] == 1
    build.load_library()
    assert bound == [build.library_path()]
    assert build.library_info() == {"origin": "bundle", "path": build.library_path(),
                                    "nvcc_seconds": None}


def test_library_origin_is_cached_or_nvcc(tmp_path, monkeypatch, fresh_build):
    monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc"))
    monkeypatch.setattr(build, "bind", lambda path: object())
    stand_in(str(tmp_path / "cc"))  # on disk before this process: cached
    build.load_library()
    assert build.library_info()["origin"] == "cached"
    monkeypatch.setattr(build, "_lib", None)
    os.unlink(build.library_path())

    def fake_nvcc(source, out):
        stand_in(os.path.dirname(out))
        return "ptxas info: 0 bytes spill"

    monkeypatch.setattr(build, "compile_library", fake_nvcc)
    build.load_library()
    info = build.library_info()
    assert info["origin"] == "nvcc" and info["nvcc_seconds"] >= 0


def test_env_key_follows_torch_capability_code_and_mesh(monkeypatch):
    k0 = ps.env_key()
    assert ps.bundle_name() == f".programs-{k0}.tar" and ps.bundle_name().startswith(".")
    assert ps.env_key("dp=2") != k0
    monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    k1 = ps.env_key()
    assert k1 != k0
    monkeypatch.setattr(ps, "_capability", lambda: "sm_80")
    assert ps.env_key() not in (k0, k1)
    monkeypatch.setattr(ps, "_code_version", "f" * 16)
    assert ps.code_version() == "f" * 16


def test_capability_reads_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    assert ps._capability() == "sm_90"
    assert ps._env()[1] == "sm_90 sm_90a"


@pytest.mark.parametrize("skew", ["torch", "capability", "code", "source"])
def test_an_environment_or_source_skew_installs_nothing(tmp_path, bundle, monkeypatch, skew):
    if skew == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    elif skew == "capability":
        monkeypatch.setattr(ps, "_capability", lambda: "sm_80")
    elif skew == "code":
        monkeypatch.setattr(ps, "_code_version", "f" * 16)
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    stats = ps.install_bundle(bundle, str(tmp_path / "dst"))
    assert stats["installed"] == 0 and stats["skipped"] == 1
    want = "source skew" if skew == "source" else "version skew"
    assert stats["reasons"][0].startswith(want)
    assert not os.path.exists(tmp_path / "dst")


def test_mesh_skew_skips_and_the_same_mesh_installs(tmp_path):
    stand_in(str(tmp_path / "src"))
    data = ps.build_bundle(str(tmp_path / "src"), mesh="dp=2")
    stats = ps.install_bundle(data, str(tmp_path / "dst"))
    assert stats["installed"] == 0 and stats["reasons"][0].startswith("mesh skew")
    assert ps.install_bundle(data, str(tmp_path / "dst"), mesh="dp=2")["installed"] == 1


# -- the hardening ladder, against the JAX package ---------------------------------------


def _kinds(stats: dict) -> list:
    """Each skip reason's words before its first colon, member names masked."""
    out = []
    for r in stats["reasons"]:
        r = re.sub(r"artifact name '[^']*' rejected", "artifact name <name> rejected", r)
        r = re.sub(r"artifact (?!name )\S+ ", "artifact <name> ", r)
        out.append(r.split(":")[0])
    return out


def _jax_bundle(d) -> bytes:
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "aot-" + "ab" * 8 + ".bin"), "wb") as f:
        f.write(b"export-one")
    return jps.build_bundle(d)


def _evil_bundle(meta: dict, names: list) -> bytes:
    meta = dict(meta, artifacts=[{"name": n, "sha256": hashlib.sha256(b"x").hexdigest(),
                                  "size": 1} for n in names])
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.USTAR_FORMAT) as tar:
        for name, blob in [(ps.META_MEMBER, json.dumps(meta).encode())] + [
                (n, b"x") for n in names]:
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return buf.getvalue()


def _cut(data: bytes, where: str) -> bytes:
    """Cut a bundle mid-meta, mid-member-header or mid-member-data."""
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tar:
        first = tar.getmembers()[1]
    return data[:{"meta": 600, "header": first.offset + 100,
                  "data": first.offset_data + 5}[where]]


def _case(pkg, tmp_path, case: str, monkeypatch):
    """(bundle bytes, install dir) of one hardening case for one package."""
    d = str(tmp_path / pkg)
    if pkg == "jax":
        data = _jax_bundle(d + "-src")
        meta = jps._bundle_meta(data)
        skew = (aot_cache, "_code_version", "f" * 16)
        names = ["../evil.bin", "aot-UPPER.bin", "aot-" + "ab" * 8 + ".bin-atime"]
    else:
        stand_in(d + "-src")
        data = ps.build_bundle(d + "-src")
        meta = ps._bundle_meta(data)
        skew = (ps, "_code_version", "f" * 16)
        names = ["../evil.bin", "flash_attention-UPPER.so",
                 build.library_name() + "-atime"]
    if case == "garbage":
        data = b"this is not a tar archive"
    elif case.startswith("cut-"):
        data = _cut(data, case[4:])
    elif case == "skew":
        monkeypatch.setattr(*skew)
    elif case == "tampered":
        (member,) = [m for m in meta["artifacts"]]
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tar:
            off = tar.getmember(member["name"]).offset_data
        data = bytearray(data)
        data[off + 2] ^= 0xFF  # same length: only the sha256 can catch it
        data = bytes(data)
    elif case == "evil":
        data = _evil_bundle(meta, names)
    elif case == "format":
        data = data.replace(b'"formatVersion":1', b'"formatVersion":9')
    elif case == "present":
        ((pkg == "jax" and _jax_bundle) or (lambda x: stand_in(x, b"local")))(d)
    return data, d


@pytest.mark.parametrize("case", ["garbage", "cut-meta", "cut-header", "cut-data", "skew",
                                  "tampered", "evil", "format", "present"])
def test_every_hardening_case_skips_for_the_reference_reason(tmp_path, monkeypatch, case):
    got = {}
    for pkg, mod in (("jax", jps), ("port", ps)):
        with monkeypatch.context() as m:
            data, d = _case(pkg, tmp_path, case, m)
            got[pkg] = mod.install_bundle(data, d)
    assert _kinds(got["port"]) == _kinds(got["jax"])
    assert got["port"]["installed"] == got["jax"]["installed"] == 0
    assert bool(got["port"]["skipped"]) == bool(got["jax"]["skipped"])
    assert got["port"]["present"] == got["jax"]["present"]
    assert not (tmp_path / "evil.bin").exists()
    if case != "present":
        assert not os.path.exists(tmp_path / "port") or not os.listdir(tmp_path / "port")


def test_install_from_dir_aggregates(tmp_path, bundle):
    model = tmp_path / "model"
    model.mkdir()
    (model / ps.bundle_name()).write_bytes(bundle)
    (model / ".programs-deadbeef0000.tar").write_bytes(b"junk from another pod")
    total = ps.install_from_dir(str(model), str(tmp_path / "dst"))
    assert (total["bundles"], total["installed"], total["skipped"]) == (2, 1, 1)
    assert total["reasons"][0].startswith("unreadable bundle")


# -- registry round trip ---------------------------------------------------------------


@pytest.fixture
def pushed(tmp_path):
    from modelx_tpu.client.client import Client as JaxClient

    srv, base = start_port_registry()
    JaxClient(base, quiet=True).push(REPO_NAME, "v1", write_model_dir(tmp_path / "m"))
    client = Client(base, quiet=True)
    yield base, client
    client.remote.close()
    srv.shutdown()


def test_publish_is_a_real_descriptor(pushed, bundle):
    base, client = pushed
    before = client.get_manifest(REPO_NAME, "v1").blobs
    desc = ps.publish(client.remote, REPO_NAME, "v1", bundle)
    blobs = client.get_manifest(REPO_NAME, "v1").blobs
    (got,) = ps.program_descriptors(client.get_manifest(REPO_NAME, "v1"))
    assert (got.name, got.media_type, got.size) == (ps.bundle_name(), MediaTypeModelProgram,
                                                    len(bundle))
    assert str(got.digest) == str(Digest.from_bytes(bundle)) == str(desc.digest)
    assert got.annotations[AnnotationProgramCode] == ps.code_version()
    assert got.annotations[AnnotationProgramMesh] == "dp=1"
    assert got.annotations[AnnotationProgramCount] == "1"
    assert [b.name for b in blobs] == [b.name for b in before] + [got.name]  # merged


def test_republish_is_a_no_op_other_environments_coexist(pushed, bundle, tmp_path,
                                                        monkeypatch):
    base, client = pushed
    ps.publish(client.remote, REPO_NAME, "v1", bundle)
    first = client.get_manifest(REPO_NAME, "v1")
    uploads = []
    real = client.remote.upload_blob_content
    monkeypatch.setattr(client.remote, "upload_blob_content",
                        lambda *a, **k: uploads.append(a) or real(*a, **k))
    ps.publish(client.remote, REPO_NAME, "v1", bundle)
    assert uploads == []  # the blob is there (HEAD): nothing moves
    assert client.get_manifest(REPO_NAME, "v1").blobs == first.blobs
    monkeypatch.setattr(ps, "_capability", lambda: "sm_80")
    stand_in(str(tmp_path / "other"))
    ps.publish(client.remote, REPO_NAME, "v1", ps.build_bundle(str(tmp_path / "other")))
    assert len(ps.program_descriptors(client.get_manifest(REPO_NAME, "v1"))) == 2


def test_commit_delta_is_retried_once(pushed, bundle, monkeypatch):
    base, client = pushed
    digest = str(Digest.from_bytes(bundle))
    uploads, puts = [], []
    real_put, real_up = client.remote.put_manifest, client.remote.upload_blob_content

    def put(repo, version, manifest):
        puts.append(version)
        if len(puts) == 1:  # a GC sweep took the blob between upload and commit
            raise errors.ErrorInfo(400, errors.ErrCodeUnknown, "commit verification failed",
                                   detail={"missing": [digest]})
        real_put(repo, version, manifest)

    monkeypatch.setattr(client.remote, "put_manifest", put)
    monkeypatch.setattr(client.remote, "upload_blob_content",
                        lambda *a, **k: uploads.append(a[1].name) or real_up(*a, **k))
    ps.publish(client.remote, REPO_NAME, "v1", bundle)
    assert len(puts) == 2 and uploads == [ps.bundle_name()] * 2
    assert len(ps.program_descriptors(client.get_manifest(REPO_NAME, "v1"))) == 1
    other = errors.ErrorInfo(400, errors.ErrCodeUnknown, "bad", detail={"missing": ["x"]})
    monkeypatch.setattr(client.remote, "put_manifest",
                        lambda *a: (_ for _ in ()).throw(other))
    with pytest.raises(errors.ErrorInfo):  # a delta that is not ours is not retried
        ps.publish(client.remote, REPO_NAME, "v1", bundle)


def test_pull_and_install_through_the_blob_cache(pushed, bundle, tmp_path):
    base, client = pushed
    ps.publish(client.remote, REPO_NAME, "v1", bundle)
    bc = BlobCache(str(tmp_path / "bc"))
    manifest = client.get_manifest(REPO_NAME, "v1")
    s1 = ps.pull_and_install(client, REPO_NAME, manifest, str(tmp_path / "d1"), cache=bc)
    assert (s1["bundles"], s1["installed"]) == (1, 1) and bc.stats["admitted"] >= 1
    s2 = ps.pull_and_install(client, REPO_NAME, manifest, str(tmp_path / "d2"), cache=bc)
    assert s2["installed"] == 1 and bc.stats["hits"] >= 1  # the second pod is disk-warm


def test_annotation_skew_skips_without_fetching(pushed, bundle, tmp_path, monkeypatch):
    base, client = pushed
    ps.publish(client.remote, REPO_NAME, "v1", bundle)
    stand_in(str(tmp_path / "m2"))
    ps.publish(client.remote, REPO_NAME, "v1",
               ps.build_bundle(str(tmp_path / "m2"), mesh="dp=2"))
    manifest = client.get_manifest(REPO_NAME, "v1")
    fetches = []
    monkeypatch.setattr(client.remote, "get_blob_content",
                        lambda *a, **k: fetches.append(a) or iter(()))
    monkeypatch.setattr(ps, "_code_version", "f" * 16)
    stats = ps.pull_and_install(client, REPO_NAME, manifest, str(tmp_path / "dst"))
    assert stats["installed"] == 0 and not fetches
    assert sorted(r.split(": ")[1] for r in stats["reasons"]) == [
        "version skew (annotation)", "version skew (annotation)"]


def test_publish_for_server_and_the_pulled_bundle(pushed, tmp_path, monkeypatch):
    from modelx_tpu_torch.dl.initializer import pull_model

    base, client = pushed
    monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc"))

    class Srv:
        family = object()

    ref = f"{base}/{REPO_NAME}@v1"
    assert ps.publish_for_server(ref, Srv(), build.build_dir()) is None  # nothing built
    stand_in(build.build_dir())
    assert ps.bundle_for_server(f"{base}/{REPO_NAME}", Srv(), build.build_dir()) is None
    desc = ps.publish_for_server(ref, Srv(), build.build_dir())
    assert desc.name == ps.bundle_name()
    stats = pull_model(ref, str(tmp_path / "dest"))
    assert stats["program_blobs"] == 1 and os.path.isfile(tmp_path / "dest" / desc.name)


# -- the server's load ----------------------------------------------------------------


def test_model_server_installs_before_its_warm_up(tmp_path, bundle, monkeypatch):
    from modelx_tpu_torch.dl import serve
    from tests.test_torch_serve import _write_tiny_fp32

    monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc"))
    d = tmp_path / "m"
    _write_tiny_fp32(str(d))
    (d / ps.bundle_name()).write_bytes(bundle)
    seen = []
    # the warm-up forward (ModelServer._warm_up) runs the unspanned _argmax
    real = serve.ModelServer._argmax

    def warm_up(self, tokens):
        seen.append(os.path.exists(build.library_path()))
        return real(self, tokens)

    monkeypatch.setattr(serve.ModelServer, "_argmax", warm_up)
    server = serve.ModelServer(str(d), dtype="float32", device="cpu")
    stats = server.load()
    assert seen[0] is True  # installed before the warm-up forward
    assert {k: stats["programs"][k] for k in ("bundles", "installed", "skipped")} == {
        "bundles": 1, "installed": 1, "skipped": 0}
    assert "kernel_library" not in stats  # no card: nothing bound
    # a skewed bundle is counted and the load goes on (the nvcc path)
    shutil.rmtree(tmp_path / "cc")
    (d / ps.bundle_name()).write_bytes(b"junk")
    stats = serve.ModelServer(str(d), dtype="float32", device="cpu").load()
    assert stats["programs"]["skipped"] == 1 and stats["ready_seconds"] >= 0


# -- the chaos sweep (make chaos-torch: under the port's lockdep) ----------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_swap_publishes_then_next_swap_installs(tmp_path, monkeypatch):
    """tests/test_program_store.py:623 on the port's pool: pod 1 swap-loads
    a ref with ``publish_programs`` (its build directory holds the library,
    a stand-in here) and the manifest gains the bundle; pod 2, with an
    empty compile cache, swap-loads the same ref and installs it."""
    import time

    from modelx_tpu_torch.dl import serve as serve_mod
    from tests.test_torch_serve import _write_tiny_fp32

    srv, base = start_port_registry()
    client = Client(base, quiet=True)
    try:
        client.push(REPO_NAME, "v1", write_model_dir(tmp_path / "m"))
        ref = f"{base}/{REPO_NAME}@v1"

        def swap(tag: str, publish: bool) -> dict:
            cache = tmp_path / f"cache-{tag}"
            monkeypatch.setenv("MODELX_COMPILE_CACHE", str(cache))
            if publish:
                stand_in(str(cache))
            a_dir = tmp_path / f"a-{tag}"
            _write_tiny_fp32(str(a_dir))
            sset = serve_mod.ServerSet(
                {"a": serve_mod.ModelServer(str(a_dir), dtype="float32", device="cpu",
                                            max_seq_len=64, name="a")},
                allow_admin_load=True, staging_root=str(tmp_path / f"staging-{tag}"))
            try:
                sset.load_all()
                sset.pool.publish_programs = publish
                snap = sset.pool.request_load("b", ref=ref, wait=True)
                assert snap["b"]["state"] == "READY"
                return dict(sset.servers["b"].stats)
            finally:
                sset.close()

        swap("pub", publish=True)
        # the publish runs after READY, off the serving path
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            manifest = client.get_manifest(REPO_NAME, "v1")
            if ps.program_descriptors(manifest):
                break
            time.sleep(0.1)
        assert len(ps.program_descriptors(manifest)) == 1
        stats = swap("warm", publish=False)
        assert stats["programs"]["installed"] >= 1
        with open(os.path.join(str(tmp_path / "cache-warm"), build.library_name()), "rb") as f:
            assert f.read() == LIB
    finally:
        client.remote.close()
        srv.shutdown()
