"""FS-backed RegistryStore over any FSProvider (counterpart of
``modelx_tpu/registry/store_fs.py``): index rebuilds serialized per
repository, a single-writer global index, index annotations from the newest
manifest, a manifest PUT that verifies every referenced blob (the commit
point), in-flight upload markers, the blob listing and deletion that
garbage collection sweeps with, the quarantine a scrub moves corrupt blobs
into, and the ``file`` download location for colocated clients.
"""

from __future__ import annotations

import io
import json
import posixpath
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

from modelx_tpu_torch import errors
from modelx_tpu_torch.registry.fs import FSNotFound, FSProvider
from modelx_tpu_torch.registry.store import (
    REGISTRY_INDEX_FILENAME,
    BlobContent,
    BlobMeta,
    StoreNotFound,
    blob_digest_path,
    index_path,
    manifest_path,
    quarantine_path,
    upload_marker_path,
)
from modelx_tpu_torch.types import (
    BlobLocation,
    Descriptor,
    Digest,
    Index,
    Manifest,
    MediaTypeModelIndexJson,
    MediaTypeModelManifestJson,
    sort_descriptors,
)

_INDEX_REBUILD_CONCURRENCY = 16


class FSRegistryStore:
    # Upload markers older than this are presumed abandoned pushes: GC may
    # reclaim their blobs and active_uploads() deletes the marker.
    UPLOAD_MARKER_TTL_S = 24 * 3600.0

    def __init__(
        self,
        fs: FSProvider,
        refresh_on_init: bool = True,
        local_redirect: bool = False,
        fault_plan=None,
    ) -> None:
        self.fs = fs
        self.local_redirect = local_redirect
        # testing/faults.FaultPlan (drills only): fires
        # ``store.manifest_persisted`` between manifest persist and index
        # refresh, so stale-index crash recovery is deterministic
        self.fault_plan = fault_plan
        self._index_locks: dict[str, threading.Lock] = {}
        self._index_locks_guard = threading.Lock()
        self._global_lock = threading.Lock()
        if refresh_on_init:
            self.refresh_global_index()

    # -- locks ----------------------------------------------------------------

    def _repo_lock(self, repository: str) -> threading.Lock:
        with self._index_locks_guard:
            return self._index_locks.setdefault(repository, threading.Lock())

    # -- index ----------------------------------------------------------------

    def get_global_index(self, search: str = "") -> Index:
        """The global index, filtered by a regex search."""
        try:
            data = self.fs.get(REGISTRY_INDEX_FILENAME).read_all()
            idx = Index.decode(data)
        except FSNotFound:
            idx = self.refresh_global_index()
        return _filter_index(idx, search)

    def get_index(self, repository: str, search: str = "") -> Index:
        try:
            data = self.fs.get(index_path(repository)).read_all()
            idx = Index.decode(data)
        except FSNotFound:
            # lazily rebuild; a repo with no manifests does not exist
            idx = self.refresh_index(repository)
            if not idx.manifests:
                raise errors.index_unknown(repository) from None
        return _filter_index(idx, search)

    def remove_index(self, repository: str) -> None:
        """Delete the whole repository subtree."""
        try:
            self.fs.remove(repository)
        except FSNotFound:
            raise errors.index_unknown(repository) from None
        self.refresh_global_index()

    def refresh_index(self, repository: str) -> Index:
        """Rebuild {repo}/index.json from manifests.

        Parallel manifest fetch; serialized per-repo so concurrent manifest
        PUTs can't interleave a stale read-modify-write.
        """
        with self._repo_lock(repository):
            manifests = self._list_manifest_refs(repository)

            def fetch(ref: str) -> Descriptor | None:
                try:
                    m = self.get_manifest(repository, ref)
                except (StoreNotFound, errors.ErrorInfo):
                    return None
                data = m.encode()
                from modelx_tpu_torch.types import Digest

                return Descriptor(
                    name=ref,
                    media_type=MediaTypeModelManifestJson,
                    digest=Digest.from_bytes(data),
                    size=sum(b.size for b in m.blobs) + m.config.size,
                    modified=_manifest_modified(m),
                    annotations=dict(m.annotations),
                )

            with ThreadPoolExecutor(max_workers=_INDEX_REBUILD_CONCURRENCY) as ex:
                descs = [d for d in ex.map(fetch, manifests) if d is not None]

            idx = Index(
                media_type=MediaTypeModelIndexJson,
                manifests=sort_descriptors(descs),
                annotations=_latest_annotations(descs),
            )
            data = idx.encode()
            self.fs.put(index_path(repository), io.BytesIO(data), len(data), MediaTypeModelIndexJson)
        self._refresh_global_entry(repository, idx)
        return idx

    def refresh_global_index(self) -> Index:
        """Rebuild the root index.json over all repositories
        Single-writer."""
        with self._global_lock:
            repos = self._list_repositories()

            def fetch(repo: str) -> Descriptor | None:
                try:
                    data = self.fs.get(index_path(repo)).read_all()
                    idx = Index.decode(data)
                except (FSNotFound, ValueError):
                    # repo has manifests but no index yet: build descriptor list lazily
                    refs = self._list_manifest_refs(repo)
                    if not refs:
                        return None
                    idx = Index(manifests=[Descriptor(name=r) for r in refs])
                if not idx.manifests:
                    return None
                return Descriptor(
                    name=repo,
                    media_type=MediaTypeModelIndexJson,
                    size=sum(m.size for m in idx.manifests),
                    modified=max((m.modified for m in idx.manifests), default=""),
                    annotations=dict(idx.annotations),
                )

            with ThreadPoolExecutor(max_workers=_INDEX_REBUILD_CONCURRENCY) as ex:
                descs = [d for d in ex.map(fetch, repos) if d is not None]
            gidx = Index(media_type=MediaTypeModelIndexJson, manifests=sort_descriptors(descs))
            data = gidx.encode()
            self.fs.put(REGISTRY_INDEX_FILENAME, io.BytesIO(data), len(data), MediaTypeModelIndexJson)
            return gidx

    def _refresh_global_entry(self, repository: str, idx: Index) -> None:
        """Update one repo's entry in the global index without a full rebuild —
        O(1) instead of an O(repos) fan-out on every manifest PUT."""
        with self._global_lock:
            try:
                gidx = Index.decode(self.fs.get(REGISTRY_INDEX_FILENAME).read_all())
            except (FSNotFound, ValueError):
                gidx = Index(media_type=MediaTypeModelIndexJson)
            gidx.manifests = [m for m in gidx.manifests if m.name != repository]
            if idx.manifests:
                gidx.manifests.append(
                    Descriptor(
                        name=repository,
                        media_type=MediaTypeModelIndexJson,
                        size=sum(m.size for m in idx.manifests),
                        modified=max((m.modified for m in idx.manifests), default=""),
                        annotations=dict(idx.annotations),
                    )
                )
            gidx.manifests = sort_descriptors(gidx.manifests)
            data = gidx.encode()
            self.fs.put(REGISTRY_INDEX_FILENAME, io.BytesIO(data), len(data), MediaTypeModelIndexJson)

    # -- manifests ------------------------------------------------------------

    def exists_manifest(self, repository: str, reference: str) -> bool:
        return self.fs.exists(manifest_path(repository, reference))

    def get_manifest(self, repository: str, reference: str) -> Manifest:
        try:
            data = self.fs.get(manifest_path(repository, reference)).read_all()
        except FSNotFound:
            raise errors.manifest_unknown(reference) from None
        try:
            return Manifest.decode(data)
        except ValueError as e:
            raise errors.manifest_invalid(str(e)) from None

    def put_manifest(
        self, repository: str, reference: str, content_type: str, manifest: Manifest
    ) -> None:
        """Manifest PUT is the commit point: mark
        every referenced blob in-flight, verify it exists with a matching
        size, persist, rebuild the repo index, then clear the markers.
        Verification failure is a structured 400 whose detail lists
        exactly the missing/mismatched digests (the delta the client must
        re-push, docs/api.md)."""
        self._mark_referenced(repository, manifest)
        self._verify_commit(repository, manifest)
        self._commit_manifest(repository, reference, content_type, manifest)

    def _mark_referenced(self, repository: str, manifest: Manifest) -> None:
        """Commit-intent markers, BEFORE verification: a blob the push
        dedup-skipped (HEAD said it exists) never saw a blob-PUT marker,
        so without this a sweep could reclaim it between verification and
        the index refresh — committing a manifest whose pulls 404. Failed
        commits leave markers behind; the TTL reclaims them."""
        for desc in manifest.all_descriptors():
            if desc.digest:
                self.mark_upload(repository, desc.digest)

    def _commit_manifest(
        self, repository: str, reference: str, content_type: str, manifest: Manifest
    ) -> None:
        """Persist + index refresh + marker clear, in exactly that order.
        Callers must have verified the manifest (``_verify_commit`` or a
        backend-specific equivalent) and marked its digests first."""
        data = manifest.encode()
        self.fs.put(
            manifest_path(repository, reference),
            io.BytesIO(data),
            len(data),
            content_type or MediaTypeModelManifestJson,
        )
        # crash point for the drills: the manifest is durable but markers
        # and indexes are stale; startup reconciliation must recover
        if self.fault_plan is not None:
            self.fault_plan.maybe_fail("store.manifest_persisted")
        self.refresh_index(repository)
        # markers clear ONLY after the index refresh: GC snapshots markers
        # before it reads the index, so marker-gone implies index-visible
        # and a sweep spanning this commit can never miss both (the
        # GC-vs-push race)
        for desc in manifest.all_descriptors():
            if desc.digest:
                self.clear_upload(repository, desc.digest)

    def _verify_commit(self, repository: str, manifest: Manifest) -> None:
        """Commit-point verification: every referenced descriptor must
        exist with a matching size. Collects ALL problems (not first-fail)
        so one round trip tells the client the whole re-push delta."""
        missing: list[str] = []
        mismatched: list[dict] = []
        for desc in manifest.all_descriptors():
            if not desc.digest:
                continue
            try:
                meta = self.get_blob_meta(repository, desc.digest)
            except errors.ErrorInfo:
                missing.append(str(desc.digest))
                continue
            if desc.size and meta.content_length != desc.size:
                mismatched.append(
                    {
                        "digest": str(desc.digest),
                        "expected": desc.size,
                        "stored": meta.content_length,
                    }
                )
        if missing or mismatched:
            raise errors.commit_invalid(missing, mismatched)

    def delete_manifest(self, repository: str, reference: str) -> None:
        try:
            self.fs.remove(manifest_path(repository, reference))
        except FSNotFound:
            raise errors.manifest_unknown(reference) from None
        self.refresh_index(repository)

    # -- blobs ----------------------------------------------------------------

    def get_blob(self, repository: str, digest: str, offset: int = 0, length: int = -1) -> BlobContent:
        try:
            c = self.fs.get(blob_digest_path(repository, digest), offset, length)
        except FSNotFound:
            raise errors.blob_unknown(digest) from None
        return BlobContent(content=c.reader, content_length=c.size, content_type=c.content_type)

    def put_blob(self, repository: str, digest: str, content: BlobContent) -> None:
        # marker FIRST: if the write below is slow (multi-GB push) the GC
        # must already know this digest is in flight, whatever its mtime
        self.mark_upload(repository, digest)
        self.fs.put(
            blob_digest_path(repository, digest),
            content.content,
            content.content_length,
            content.content_type,
        )

    def list_blobs(self, repository: str) -> list[str]:
        """All blob digests stored under a repository."""
        out: list[str] = []
        base = posixpath.join(repository, "blobs")
        for algo_meta in self.fs.list(base, recursive=False):
            algo = algo_meta.name
            for blob_meta in self.fs.list(posixpath.join(base, algo), recursive=False):
                out.append(f"{algo}:{blob_meta.name}")
        return out

    def exists_blob(self, repository: str, digest: str) -> bool:
        return self.fs.exists(blob_digest_path(repository, digest))

    def delete_blob(self, repository: str, digest: str) -> None:
        try:
            self.fs.remove(blob_digest_path(repository, digest))
        except FSNotFound:
            pass  # idempotent delete

    # -- in-flight upload markers (crash-safe GC) ------------------------------

    def mark_upload(self, repository: str, digest: str) -> None:
        """Record an in-flight push of ``digest``: touched at blob-PUT
        start and presign issue, cleared at manifest commit. GC excludes
        marked digests instead of trusting only the mtime grace window."""
        payload = json.dumps({"digest": digest, "at": time.time()}).encode()
        try:
            self.fs.put(
                upload_marker_path(repository, digest),
                io.BytesIO(payload),
                len(payload),
                "application/json",
            )
        except OSError:
            # a failed marker must not fail the push; GC degrades to the
            # mtime grace window for this digest
            pass

    def clear_upload(self, repository: str, digest: str) -> None:
        try:
            self.fs.remove(upload_marker_path(repository, digest))
        except (FSNotFound, OSError):
            pass  # idempotent; S3-style stores 204 on missing anyway

    def active_uploads(self, repository: str, ttl_s: float | None = None) -> set[str]:
        """Digests with a live upload marker. Markers older than the TTL
        are abandoned pushes: dropped from the result and deleted. A
        marker whose mtime the backend can't report is treated as live:
        an unknown age must never read as ancient."""
        ttl = self.UPLOAD_MARKER_TTL_S if ttl_s is None else ttl_s
        now = time.time()
        out: set[str] = set()
        base = posixpath.join(repository, "uploads")
        for meta in self.fs.list(base, recursive=True):
            digest = meta.name.replace("/", ":", 1)
            mtime = meta.last_modified or 0.0
            if mtime > 0 and now - mtime > ttl:
                self.clear_upload(repository, digest)
                continue
            out.add(digest)
        return out

    # -- corruption quarantine -------------------------------------------------

    def quarantine_blob(self, repository: str, digest: str) -> None:
        """Move a corrupt blob out of ``blobs/`` into ``quarantine/``: the
        content address 404s (instead of serving bad bytes) and becomes
        re-pushable, while the evidence stays inspectable on the store."""
        src = blob_digest_path(repository, digest)
        dst = quarantine_path(repository, digest)
        try:
            content = self.fs.get(src)
        except FSNotFound:
            raise errors.blob_unknown(digest) from None
        try:
            self.fs.put(dst, content.reader, content.size, content.content_type)
        finally:
            content.reader.close()
        self.fs.remove(src)

    def get_blob_meta(self, repository: str, digest: str) -> BlobMeta:
        try:
            m = self.fs.stat(blob_digest_path(repository, digest))
        except FSNotFound:
            raise errors.blob_unknown(digest) from None
        return BlobMeta(
            content_type=m.content_type, content_length=m.size, last_modified=m.last_modified
        )

    def get_blob_location(
        self, repository: str, digest: str, purpose: str, properties: dict[str, str]
    ) -> BlobLocation | None:
        """Load separation for colocated clients: when the store sits on a
        filesystem the client can also see (same host, or a shared pod
        volume — the modelxdl deployment shape), downloads redirect to the
        blob's path and bytes never cross the registry process at all.
        Clients that can't read the path fall back to the direct GET, so
        advertising it to a remote client costs one stat. Uploads still
        flow through the server: the manifest commit's digest verification
        needs them.
        """
        if not self.local_redirect or purpose != "download":
            return None
        local_path = getattr(self.fs, "local_path", None)
        if local_path is None:
            return None
        blob_path = blob_digest_path(repository, digest)
        path = local_path(blob_path)
        try:
            meta = self.fs.stat(blob_path)
        except FSNotFound:
            raise errors.blob_unknown(digest) from None
        return BlobLocation(
            provider="file",
            purpose=purpose,
            properties={"path": path, "size": meta.size},
        )

    # -- listing helpers ------------------------------------------------------

    def _list_manifest_refs(self, repository: str) -> list[str]:
        return [
            m.name
            for m in self.fs.list(posixpath.join(repository, "manifests"), recursive=False)
            if m.size > 0 or not _looks_like_dir(m)
        ]

    def _list_repositories(self) -> list[str]:
        """Repositories are two path levels deep ({project}/{name})."""
        out: list[str] = []
        for top in self.fs.list("", recursive=False):
            if top.name == REGISTRY_INDEX_FILENAME:
                continue
            for sub in self.fs.list(top.name, recursive=False):
                if sub.name == REGISTRY_INDEX_FILENAME:
                    continue
                repo = posixpath.join(top.name, sub.name)
                if self.fs.list(posixpath.join(repo, "manifests"), recursive=False):
                    out.append(repo)
        return sorted(out)


def _looks_like_dir(meta) -> bool:
    return meta.size == 0 and "." not in meta.name and ":" not in meta.name


def _filter_index(idx: Index, search: str) -> Index:
    """Regex search filter."""
    if not search:
        return idx
    try:
        pat = re.compile(search)
    except re.error:
        raise errors.ErrorInfo(400, errors.ErrCodeUnknown, f"invalid search regexp: {search}")
    return Index(
        schema_version=idx.schema_version,
        media_type=idx.media_type,
        manifests=[m for m in idx.manifests if pat.search(m.name)],
        annotations=idx.annotations,
    )


def _manifest_modified(m: Manifest) -> str:
    times = [d.modified for d in m.all_descriptors() if d.modified]
    return max(times) if times else ""


def _latest_annotations(descs: Iterable[Descriptor]) -> dict[str, str]:
    """Annotations of the newest manifest by modified time."""
    newest: Descriptor | None = None
    for d in descs:
        if newest is None or (d.modified or "") > (newest.modified or ""):
            newest = d
    return dict(newest.annotations) if newest else {}
