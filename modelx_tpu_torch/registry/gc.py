"""Garbage collection: mark-sweep of unreferenced blobs (counterpart of
``modelx_tpu/registry/gc.py``). ``gc_blobs`` sweeps one repository:
blobs referenced by no manifest go, unless a live upload marker or the
grace period (their age) protects them; ``gc_blobs_all`` sweeps every
repository of the global index, which the registry's GC cron calls.
"""

from __future__ import annotations

import dataclasses
import logging

from modelx_tpu_torch import errors
from modelx_tpu_torch.registry.store import RegistryStore

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GCResult:
    repository: str
    checked: int = 0
    deleted: int = 0
    deleted_digests: list[str] = dataclasses.field(default_factory=list)
    # unreferenced but protected: live upload marker / inside the grace
    # window / age unknowable — the next sweep reconsiders them
    skipped_in_flight: int = 0
    skipped_young: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_GRACE_S = 600.0


def gc_blobs(store: RegistryStore, repository: str, grace_s: float = DEFAULT_GRACE_S) -> GCResult:
    """Delete the blobs referenced by no manifest of the repository.

    Blobs younger than ``grace_s`` are skipped: a push uploads blobs first and
    commits the manifest last, so a sweep landing inside that window would
    otherwise delete the new version's blobs out from under it.
    """
    # in-flight upload markers (crash-safe GC): a marked digest is an
    # active push whatever its blob mtime says. Snapshot markers BEFORE
    # reading the index: the commit refreshes the index before clearing
    # markers, so marker-gone implies index-visible and a sweep spanning a
    # commit can never miss both. grace_s=0 is the explicit operator
    # override ("sweep everything unreferenced, now") and ignores markers
    # like it ignores the age heuristic.
    in_flight: set[str] = set()
    if grace_s > 0:
        active = getattr(store, "active_uploads", None)
        if active is not None:
            try:
                in_flight = active(repository)
            except Exception:
                logger.exception("gc: active_uploads failed; trusting mtimes only")

    in_use: set[str] = set()
    try:
        idx = store.get_index(repository)
    except errors.ErrorInfo as e:
        if e.http_status == 404:
            return GCResult(repository=repository)
        raise
    for entry in idx.manifests:
        try:
            manifest = store.get_manifest(repository, entry.name)
        except errors.ErrorInfo:
            continue
        for d in manifest.all_descriptors():
            if d.digest:
                in_use.add(d.digest)

    import time

    now = time.time()
    result = GCResult(repository=repository)
    for digest in store.list_blobs(repository):
        result.checked += 1
        if digest in in_use:
            continue
        if digest in in_flight:
            result.skipped_in_flight += 1
            continue
        if grace_s > 0:
            mtime = _blob_mtime(store, repository, digest)
            if mtime is None:
                # unknown age MUST read as young, never as ancient: a store
                # that can't report last_modified would otherwise see
                # age == now and delete blobs INSIDE the grace window
                result.skipped_young += 1
                continue
            if now - mtime < grace_s:
                result.skipped_young += 1
                continue  # possibly an in-flight push; next sweep gets it
        store.delete_blob(repository, digest)
        result.deleted += 1
        result.deleted_digests.append(digest)
        logger.info("gc: deleted %s/%s", repository, digest)
    return result


def _blob_mtime(store: RegistryStore, repository: str, digest: str) -> float | None:
    """The blob's last-modified time, or None when it cannot be known
    (backend without mtimes, or the blob vanished mid-sweep)."""
    try:
        meta = store.get_blob_meta(repository, digest)
    except errors.ErrorInfo:
        return None
    mtime = getattr(meta, "last_modified", 0.0) or 0.0
    return mtime if mtime > 0 else None


def gc_blobs_all(store: RegistryStore, grace_s: float = DEFAULT_GRACE_S) -> list[GCResult]:
    """GC every repository in the global index."""
    results = []
    for repo in store.get_global_index().manifests:
        results.append(gc_blobs(store, repo.name, grace_s=grace_s))
    return results
