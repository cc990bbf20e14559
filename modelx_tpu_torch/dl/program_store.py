"""Compiled-program registry: ship the kernel library with the weights
(counterpart of ``modelx_tpu/dl/program_store.py``).

What a pod compiles, the fleet can reuse. The JAX package ships serialized
``jax.export`` artifacts and the persistent-XLA-cache executables they
compile into. The port has no XLA: its only compiled program is the shared
library that ``kernels/build.py`` builds from ``csrc/`` with nvcc,
``flash_attention-<source digest[:16]>.so``, which every cache-free forward
launches. So that library is what a program bundle carries. A fresh pod
otherwise runs nvcc before its first cache-free forward (tens of seconds
on the card's host), and a pod without a CUDA toolkit cannot serve at all.
``dl/aot_cache.py`` and ``utils/jax_compat.py`` have no counterpart: there
is no trace, lowering or executable cache to warm.

The bundle is one deterministic tar (``meta.json`` first, then the
library), attached to the model version as a real manifest descriptor
under ``application/vnd.modelx.program.v1``, so sha256 verification,
scrub, quarantine and GC apply to it as to weight bytes. The first pod to
build publishes (``--publish-programs``); a later pod's pull brings
``.programs-<env_key>.tar`` next to the weights, and ``ModelServer.load``
installs it into the build directory (``$MODELX_COMPILE_CACHE``, else
``modelx_tpu_torch/_build/``) before anything can reach
``kernels.build.load_library``, which then binds it without running nvcc
(``library_info()["origin"] == "bundle"``). The store is an optimization,
never load-bearing: a miss, a skew or a corrupt bundle is logged, counted
and skipped, and the pod builds with nvcc as it would without it.

The environment key (``env_key``) is a digest of torch's version and its
CUDA version, the card's compute capability and the build's arch
(``sm_90a``), the port's code version (a sha256 over the
``modelx_tpu_torch`` sources) and the mesh string (``dp=1`` on one card).
The wire format keeps the JAX package's key names (``jax``, ``backend``,
``codeVersion``, ``mesh`` in ``meta.json``; the ``modelx.program.*``
annotations), with torch's version where the reference writes jax's: a
bundle of one package is then a version skew to the other, never an
install.

Trust boundary, and its known risk: loading a ``.so`` from the registry
runs native code in the serving process. The boundary is the reference's:
member names must match the library's name pattern, every member is
re-hashed against the bundle's own ``meta.json``, the environment must
match, and the registry is trusted. The ``sourceDigest`` check (the
bundle's library was built from the same ``csrc/`` tree as the local one)
defends against skew, not against a malicious registry. An existing
library is never overwritten, and installs are atomic (temp file, then
rename).

``plan_from_manifest`` and ``export_surface`` serve the CLI's
``modelx-torch programs push``: the first reads a version's family and
head_dim from its manifest (the tensor-index annotations, ranged header
reads where a blob has none, and the config.json blob), the second builds
the library those head_dims need, or finds it in the build directory.
Where there is no nvcc and no cached library, it raises
``ProgramExportError``: a push never publishes an empty bundle.
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import logging
import os
import re
import tarfile

from modelx_tpu_torch.types import (
    AnnotationProgramBackend,
    AnnotationProgramCode,
    AnnotationProgramCount,
    AnnotationProgramJax,
    AnnotationProgramMesh,
    Descriptor,
    Digest,
    Manifest,
    MediaTypeModelProgram,
)

logger = logging.getLogger("modelx.programs")

BUNDLE_FORMAT = 1
META_MEMBER = "meta.json"
# one card, no mesh: the serving layout the reference spells dp=1
MESH = "dp=1"
# the only member name a bundle may carry: the kernel library as
# kernels/build.py names it. Paths, traversal and stray files are rejected
_LIBRARY_RE = re.compile(r"^flash_attention-[0-9a-f]{16}\.so$")

_code_version: str | None = None  # digest of the package source, once


def _member_name_ok(name: str) -> bool:
    return bool(_LIBRARY_RE.match(name))


def code_version() -> str:
    """Digest of every ``modelx_tpu_torch`` source file (relative name and
    bytes), once per process: a bundle built by different code is skipped
    at install. Not git metadata: a deployed image has no .git."""
    global _code_version
    if _code_version is None:
        import modelx_tpu_torch

        root = os.path.dirname(os.path.abspath(modelx_tpu_torch.__file__))
        h = hashlib.sha256()
        for dirpath, dirnames, filenames in sorted(os.walk(root)):
            dirnames.sort()
            for name in sorted(filenames):
                if name.endswith(".py"):
                    p = os.path.join(dirpath, name)
                    h.update(os.path.relpath(p, root).encode())
                    with open(p, "rb") as f:
                        h.update(f.read())
        _code_version = h.hexdigest()[:16]
    return _code_version


def _capability() -> str:
    """The card's compute capability (``sm_90``), or ``cpu`` without one."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def _mesh_str(mesh=None) -> str:
    return mesh if isinstance(mesh, str) and mesh else MESH


def _env(mesh=None) -> tuple[str, str, str, str]:
    """(framework version, backend, code version, mesh): the bundle
    compatibility domain, in the reference's four fields."""
    import torch

    from modelx_tpu_torch.kernels import build

    framework = f"torch {torch.__version__} cuda {torch.version.cuda or 'none'}"
    backend = f"{_capability()} {build.ARCH}"
    return framework, backend, code_version(), _mesh_str(mesh)


def _env_key_of(framework: str, backend: str, code: str, mesh_s: str) -> str:
    h = hashlib.sha256(f"{framework}\x00{backend}\x00{code}\x00{mesh_s}".encode())
    return h.hexdigest()[:12]


def env_key(mesh=None) -> str:
    """Digest of the environment: one bundle per environment coexists in a
    manifest; republishing from the same environment replaces it."""
    return _env_key_of(*_env(mesh))


def bundle_name(mesh=None) -> str:
    """A dotfile on purpose, as the reference's: a model dir holding a
    pulled bundle re-pushes cleanly."""
    return f".programs-{env_key(mesh)}.tar"


def _tar(members: list[tuple[str, bytes]]) -> bytes:
    """A deterministic tar: the given order, zeroed mtimes and owners."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.USTAR_FORMAT) as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = 0
            info.uid = info.gid = 0
            info.uname = info.gname = ""
            info.mode = 0o644
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


# --- bundle build -------------------------------------------------------------


def build_bundle(cache_dir: str, keys=None, mesh=None) -> bytes | None:
    """Pack kernel libraries from ``cache_dir`` into a deterministic tar:
    the same library gives the same bytes, so republishing is a registry
    no-op. ``keys=None`` bundles every library in the dir; otherwise only
    the named files (missing ones are skipped). Returns None when there is
    nothing to ship."""
    from modelx_tpu_torch.kernels import build

    if keys is None:
        paths = sorted(glob.glob(os.path.join(cache_dir, "flash_attention-*.so")))
    else:
        paths = sorted(os.path.join(cache_dir, k) for k in dict.fromkeys(keys))
    artifacts = []
    members = []
    for path in paths:
        name = os.path.basename(path)
        if not _member_name_ok(name):
            continue
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            logger.warning("program bundle: skipping unreadable %s: %s", name, e)
            continue
        artifacts.append(
            {"name": name, "sha256": hashlib.sha256(data).hexdigest(), "size": len(data)})
        members.append((name, data))
    if not members:
        return None
    framework, backend, code, mesh_s = _env(mesh)
    meta = {
        "formatVersion": BUNDLE_FORMAT,
        "jax": framework,
        "backend": backend,
        "codeVersion": code,
        "mesh": mesh_s,
        "sourceDigest": build.source_digest(),
        "nvcc": build.nvcc_version(),
        "artifacts": artifacts,
    }
    meta_bytes = json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()
    return _tar([(META_MEMBER, meta_bytes)] + members)


# --- bundle install -----------------------------------------------------------


def install_bundle(data: bytes, cache_dir: str, mesh=None) -> dict:
    """Install a bundle's libraries into the build directory.

    Never raises: an undecodable tar, a missing or invalid meta, an
    environment or source skew, a tampered or truncated member are logged,
    counted and skipped, and the caller builds with nvcc. An existing
    library is never overwritten."""
    from modelx_tpu_torch.kernels import build

    stats = {"installed": 0, "present": 0, "skipped": 0, "reasons": []}

    def _skip(reason: str, n: int = 1) -> dict:
        stats["skipped"] += n
        stats["reasons"].append(reason)
        logger.warning("program install: %s", reason)
        return stats

    try:
        tar = tarfile.open(fileobj=io.BytesIO(data), mode="r:")
    except (tarfile.TarError, ValueError, EOFError) as e:
        return _skip(f"unreadable bundle: {e}")
    with tar:
        try:
            member = tar.getmember(META_MEMBER)
            meta = json.loads(tar.extractfile(member).read())
        except (KeyError, tarfile.TarError, ValueError, AttributeError, OSError) as e:
            return _skip(f"bundle meta unreadable: {e}")
        if not isinstance(meta, dict) or meta.get("formatVersion") != BUNDLE_FORMAT:
            return _skip(f"unsupported bundle format {meta.get('formatVersion')!r}"
                         if isinstance(meta, dict) else "bundle meta is not an object")
        framework, backend, code, mesh_s = _env(mesh)
        n_art = len(meta.get("artifacts") or ())
        got = (meta.get("jax"), meta.get("backend"), meta.get("codeVersion"))
        if got != (framework, backend, code):
            return _skip(
                "version skew: bundle built for jax=%s backend=%s code=%s, "
                "local jax=%s backend=%s code=%s" % (*got, framework, backend, code),
                n=n_art)
        got_mesh = meta.get("mesh")
        if got_mesh is not None and got_mesh != mesh_s:
            return _skip(f"mesh skew: bundle built for mesh={got_mesh}, local mesh={mesh_s}",
                         n=n_art)
        local_src = build.source_digest()
        if meta.get("sourceDigest") != local_src:
            # a library of other kernel sources would bind and then launch
            # another kernel than this tree's
            return _skip(f"source skew: bundle built from csrc {meta.get('sourceDigest')}, "
                         f"local csrc {local_src}", n=n_art)
        os.makedirs(cache_dir, exist_ok=True)
        for art in meta.get("artifacts") or ():
            name = art.get("name", "") if isinstance(art, dict) else ""
            if not _member_name_ok(name):
                _skip(f"artifact name {name!r} rejected")
                continue
            target = os.path.join(cache_dir, name)
            if os.path.exists(target):
                stats["present"] += 1
                continue
            try:
                blob = tar.extractfile(tar.getmember(name)).read()
            except (KeyError, tarfile.TarError, AttributeError, OSError) as e:
                _skip(f"artifact {name} unreadable: {e}")
                continue
            if (len(blob) != art.get("size")
                    or hashlib.sha256(blob).hexdigest() != art.get("sha256")):
                _skip(f"artifact {name} fails hash/size check; not installing")
                continue
            tmp = f"{target}.tmp.{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, target)  # atomic: racing installs and builds
            except OSError as e:
                _skip(f"artifact {name} write failed: {e}")
                try:
                    os.unlink(tmp)
                except OSError:
                    logger.debug("program install: tmp cleanup failed for %s", tmp)
                continue
            build.note_installed(target)
            stats["installed"] += 1
    return stats


def _merge(total: dict, stats: dict) -> None:
    for k in ("installed", "present", "skipped"):
        total[k] += stats[k]
    total["reasons"].extend(stats["reasons"])


def install_from_dir(model_dir: str, cache_dir: str, mesh=None) -> dict:
    """Install every pulled program bundle in a model dir (the load path:
    the pull drops ``.programs-*.tar`` next to the weights). Aggregated
    stats; never raises."""
    total = {"bundles": 0, "installed": 0, "present": 0, "skipped": 0, "reasons": []}
    for path in sorted(glob.glob(os.path.join(model_dir, ".programs-*.tar"))):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            total["reasons"].append(f"{os.path.basename(path)}: {e}")
            logger.warning("program install: cannot read %s: %s", path, e)
            continue
        total["bundles"] += 1
        _merge(total, install_bundle(data, cache_dir, mesh=mesh))
    return total


# --- registry plumbing --------------------------------------------------------


def program_descriptors(manifest: Manifest) -> list[Descriptor]:
    return [b for b in manifest.blobs if b.media_type == MediaTypeModelProgram]


def _bundle_meta(data: bytes) -> dict:
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tar:
        meta = json.loads(tar.extractfile(tar.getmember(META_MEMBER)).read())
    if not isinstance(meta, dict) or not isinstance(meta.get("artifacts"), list):
        raise ValueError("program bundle meta.json is not a bundle manifest")
    return meta


def _program_count(meta: dict) -> int:
    return sum(1 for a in meta.get("artifacts") or ()
               if isinstance(a, dict) and _LIBRARY_RE.match(a.get("name", "")))


def bundle_program_count(data: bytes) -> int:
    return _program_count(_bundle_meta(data))


def attach(remote, repository: str, version: str, desc: Descriptor, data: bytes) -> None:
    """Upload ``data`` as ``desc`` (content-addressed HEAD dedup) and
    re-PUT the version's manifest with the descriptor merged in by name.
    The server's commit verification re-checks every referenced digest; a
    400 naming ours gets one re-upload and one more commit."""
    from modelx_tpu_torch import errors
    from modelx_tpu_torch.client.push import commit_delta_digests

    if not remote.head_blob(repository, desc.digest):
        remote.upload_blob_content(repository, desc, data)
    manifest = remote.get_manifest(repository, version)
    manifest.blobs = [b for b in manifest.blobs if b.name != desc.name] + [desc]
    try:
        remote.put_manifest(repository, version, manifest)
    except errors.ErrorInfo as e:
        if str(desc.digest) not in commit_delta_digests(e):
            raise
        # our blob lost a race (a GC sweep or quarantine between upload and
        # commit): push it again and commit once more
        remote.upload_blob_content(repository, desc, data)
        remote.put_manifest(repository, version, manifest)


def publish(remote, repository: str, version: str, data: bytes) -> Descriptor:
    """Attach a bundle to an existing model version as a real descriptor:
    a republish from the same environment replaces it, other environments'
    bundles coexist. The name follows the bundle's own stamped environment,
    so a publish from another process (the outbox's drainer) names it the
    same."""
    meta = _bundle_meta(data)
    envk = _env_key_of(str(meta.get("jax")), str(meta.get("backend")),
                       str(meta.get("codeVersion")), str(meta.get("mesh") or MESH))
    desc = Descriptor(
        name=f".programs-{envk}.tar",
        media_type=MediaTypeModelProgram,
        digest=Digest.from_bytes(data),
        size=len(data),
        annotations={
            AnnotationProgramJax: str(meta["jax"]),
            AnnotationProgramBackend: str(meta["backend"]),
            AnnotationProgramCode: str(meta["codeVersion"]),
            AnnotationProgramMesh: str(meta.get("mesh") or MESH),
            AnnotationProgramCount: str(_program_count(meta)),
        },
    )
    attach(remote, repository, version, desc, data)
    return desc


def pull_and_install(client, repository: str, manifest: Manifest, cache_dir: str,
                     cache=None, mesh=None) -> dict:
    """Fetch the manifest's program bundles (blob cache first) and install
    them. A bundle whose annotations name another code version or mesh is
    skipped without moving its bytes; corrupt bytes are discarded. Never
    raises."""
    total = {"bundles": 0, "installed": 0, "present": 0, "skipped": 0, "reasons": []}
    env = _env(mesh)
    for desc in program_descriptors(manifest):
        code = desc.annotations.get(AnnotationProgramCode)
        if code is not None and code != env[2]:
            total["skipped"] += 1
            total["reasons"].append(f"{desc.name}: version skew (annotation)")
            continue
        bundle_mesh = desc.annotations.get(AnnotationProgramMesh)
        if bundle_mesh is not None and bundle_mesh != env[3]:
            total["skipped"] += 1
            total["reasons"].append(f"{desc.name}: mesh skew (annotation)")
            continue
        try:
            data = _read_blob(client, repository, desc, cache=cache)
        except Exception as e:
            total["reasons"].append(f"{desc.name}: {e}")
            logger.warning("program pull: %s unavailable: %s", desc.name, e)
            continue
        if data is None:
            total["reasons"].append(f"{desc.name}: digest mismatch")
            continue
        total["bundles"] += 1
        _merge(total, install_bundle(data, cache_dir, mesh=mesh))
    return total


def _read_blob(client, repository: str, desc: Descriptor, cache=None) -> bytes | None:
    """Blob bytes through the local blob cache when it holds them, the
    registry otherwise; always digest-verified (None = corrupt). Network
    reads are admitted into the cache."""
    if cache is not None and desc.digest:
        hit = cache.lookup(desc.digest, expected_size=desc.size or -1)
        if hit is not None:
            try:
                with open(hit, "rb") as f:
                    data = f.read()
                if str(Digest.from_bytes(data)) == str(desc.digest):
                    return data
                logger.warning("program pull: cached %s corrupt; refetching", desc.name)
            except OSError as e:
                logger.warning("program pull: cache read of %s failed: %s", desc.name, e)
    data = b"".join(client.remote.get_blob_content(repository, desc.digest))
    if str(Digest.from_bytes(data)) != str(desc.digest):
        logger.warning("program pull: %s/%s bytes do not match their address; discarding",
                       repository, desc.name)
        return None
    if cache is not None and desc.digest:
        _admit(cache, str(desc.digest), data)
    return data


def _admit(cache, digest: str, data: bytes) -> None:
    import tempfile

    try:
        fd, tmp = tempfile.mkstemp(dir=cache.root, prefix=".programs-admit-")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
    except OSError as e:
        logger.warning("program pull: blob-cache spool failed: %s", e)
        return
    if cache.admit_file(digest, tmp) is None:
        logger.warning("program pull: blob-cache admit refused %s", digest)


# --- server glue --------------------------------------------------------------


def bundle_for_server(ref: str, server, cache_dir: str) -> bytes | None:
    """The local half of a server publish: bundle the kernel library of
    this tree (when the build directory holds it) for the version ``ref``
    names. No network: the bytes are published now or spooled to the
    outbox. None when there is nothing to publish or the ref names no
    version."""
    from modelx_tpu_torch.client.reference import parse_reference
    from modelx_tpu_torch.kernels import build

    if not cache_dir or server.family is None:
        return None
    if not parse_reference(ref).version:
        # publishing must pin the exact version whose library this is
        logger.warning("programs publish skipped: %s names no version", ref)
        return None
    name = build.library_name()
    if not os.path.isfile(os.path.join(cache_dir, name)):
        return None
    return build_bundle(cache_dir, keys=[name])


def publish_bundle(ref: str, data: bytes) -> Descriptor:
    """The network half of a server publish, which the outbox's drainer
    replays after a registry outage: the bundle carries its own stamped
    environment, so a later publish equals one made now."""
    from modelx_tpu_torch.client.reference import parse_reference

    parsed = parse_reference(ref)
    client = parsed.client(quiet=True)
    desc = publish(client.remote, parsed.repository, parsed.version, data)
    logger.info("published compiled programs for %s (%s, %d bytes)", ref, desc.name, desc.size)
    return desc


def publish_for_server(ref: str, server, cache_dir: str) -> Descriptor | None:
    """Best-effort publish of a freshly loaded server's kernel library (the
    ``--publish-programs`` hook of ``dl/lifecycle.py`` without an outbox).
    None when there is nothing to publish."""
    data = bundle_for_server(ref, server, cache_dir)
    if data is None:
        return None
    return publish_bundle(ref, data)


# --- the CLI's export ------------------------------------------------------------


class ProgramExportError(ValueError):
    """``programs push`` cannot produce the kernel library: nvcc is not in
    reach and the build directory holds no cached library."""


def plan_from_manifest(client, repository: str, manifest: Manifest,
                       quantize: str | None = None, cache=None):
    """(family, cfg, head_dims, mesh) for a model known only by its
    manifest: the safetensors headers (the tensor-index annotations, ranged
    reads as the fallback) and the config.json sidecar determine the
    family and the head_dim its cache-free forwards hand the kernel, so
    ``programs push`` needs no weight byte. ``head_dims`` is empty for a
    family that launches no kernel (gpt2, bert). ``quantize`` changes no
    program: int8 linears leave attention's shapes as they are."""
    import struct

    from modelx_tpu_torch.dl import families as fam
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl.initializer import _blob_source
    from modelx_tpu_torch.dl.loader import fuse_expert_tensors
    from modelx_tpu_torch.types import AnnotationTensorIndex

    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    infos: dict = {}
    sidecar = None
    for blob in manifest.blobs:
        if blob.name == "config.json":
            try:
                raw = json.loads(b"".join(client.remote.get_blob_content(repository,
                                                                         blob.digest)))
            except ValueError:
                raw = None
            sidecar = raw if isinstance(raw, dict) else None
        if not blob.name.endswith(".safetensors"):
            continue
        if AnnotationTensorIndex in blob.annotations:
            parsed, _off = st.parse_index_annotation(blob.annotations[AnnotationTensorIndex])
        else:
            source = _blob_source(client, repository, blob, cache=cache)
            try:
                (hlen,) = struct.unpack("<Q", bytes(source.read_range(0, 8)))
                parsed = st.parse_header(bytes(source.read_range(8, hlen)))
            finally:
                if hasattr(source, "close"):
                    source.close()
        infos.update(parsed)
    if not infos:
        raise ValueError(f"{repository}: manifest has no safetensors blobs")
    family = fam.detect(list(infos))
    cfg = family.infer_config(fam.abstract_params(fuse_expert_tensors(infos)))
    if sidecar is not None:
        cfg = fam.apply_sidecar_config(cfg, sidecar, family.name)
    head_dim = getattr(cfg, "head_dim", None)
    return family, cfg, ([int(head_dim)] if head_dim else []), MESH


def export_surface(family, cfg, head_dims, mesh, cache_dir: str) -> list[str]:
    """The library file names (in bundle order) that serve ``head_dims``,
    present in ``cache_dir`` on return: one library holds every head_dim
    the kernel takes, so it is found there or built there with nvcc. An
    empty ``head_dims`` (the family runs no kernel) returns []. Raises
    ``ProgramExportError`` when nvcc is not in reach and ``cache_dir``
    holds no library; ``ValueError`` for a head_dim the kernel lacks."""
    from modelx_tpu_torch.kernels import build
    from modelx_tpu_torch.ops.attention import KERNEL_HEAD_DIMS

    if not head_dims:
        return []
    bad = sorted(set(head_dims) - set(KERNEL_HEAD_DIMS))
    if bad:
        raise ValueError(f"{family.name}: head_dim {bad} is not one the flash kernel takes "
                         f"({KERNEL_HEAD_DIMS})")
    name = build.library_name()
    path = os.path.join(cache_dir, name)
    if not os.path.isfile(path):
        try:
            build.nvcc_path()
        except RuntimeError as e:
            raise ProgramExportError(
                f"cannot build {name}: {e}, and {cache_dir} holds no cached library "
                f"(set MODELX_COMPILE_CACHE or --cache-dir to a directory that has it)"
            ) from None
        build.compile_library(build.CSRC, path)
    return [name]
