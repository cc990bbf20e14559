"""Read-path integrity: blob scrub, corruption quarantine, reconciliation
(counterpart of ``modelx_tpu/registry/scrub.py``). The registry is the
trusted tier loaders stream from, so it must be able to prove its bytes:

- ``scrub_repository`` re-hashes stored blobs (all, or a seeded sample)
  and moves mismatches to ``quarantine/``, so the content address 404s and
  becomes re-pushable instead of serving corrupt bytes; it reports
  descriptors whose blob is gone (dangling) and manifests that no longer
  decode, then rebuilds the repository's index;
- ``reconcile`` rebuilds the global index from storage and runs an
  index-only pass over every repository: the registry's startup recovery
  from a crash between a manifest's persist and its index refresh, or
  with ``rehash`` a full scrub of everything.

Exposed as ``modelx-torch scrub <ref>``, ``POST /{repo}/scrub`` (behind
the server's auth filter) and the startup reconciliation.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import random

from modelx_tpu_torch import errors

logger = logging.getLogger(__name__)

_SCRUB_CHUNK = 4 * 1024 * 1024


@dataclasses.dataclass
class ScrubResult:
    repository: str
    checked: int = 0
    bytes_hashed: int = 0
    sampled: bool = False
    # digests moved to quarantine/ this pass (hash != content address)
    quarantined: list[str] = dataclasses.field(default_factory=list)
    # blobs that errored mid-read (transport/backend): NOT quarantined —
    # re-scrub decides; a flaky read must not destroy a good blob
    unreadable: list[str] = dataclasses.field(default_factory=list)
    # {"version", "name", "digest"} manifest references to absent blobs
    dangling: list[dict] = dataclasses.field(default_factory=list)
    # manifest references that no longer decode as manifests
    invalid_manifests: list[str] = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not (
            self.quarantined or self.unreadable or self.dangling or self.invalid_manifests
        )

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["clean"] = self.clean
        return d


def _rehash_ok(store, repository: str, digest: str) -> bool | None:
    """True = bytes match the address, False = corrupt, None = unreadable."""
    algo, _, hexpart = digest.partition(":")
    try:
        h = hashlib.new(algo)
    except ValueError:
        return False  # an address we cannot even hash is not servable
    try:
        blob = store.get_blob(repository, digest)
    except errors.ErrorInfo as e:
        if e.http_status == 404:
            return True  # vanished mid-scrub (GC/quarantine race): nothing to judge
        return None  # backend trouble at open: unreadable, never "clean"
    except OSError:
        return None
    try:
        reader = blob.content
        try:
            while chunk := reader.read(_SCRUB_CHUNK):
                h.update(chunk)
        finally:
            reader.close()
    except (OSError, errors.ErrorInfo):
        return None
    return h.hexdigest() == hexpart.lower()


def scrub_repository(
    store,
    repository: str,
    sample: int = 0,
    seed: int = 0,
    rehash: bool = True,
    check_refs: bool = True,
) -> ScrubResult:
    """Scrub one repository: re-hash blobs (all, or a seeded ``sample``),
    quarantine corruption, flag dangling descriptors and undecodable
    manifests (``check_refs``), then rebuild the repo index (which also
    refreshes the repo's global-index entry). ``rehash=False,
    check_refs=False`` is the cheap index-only pass boot reconciliation
    uses — no per-blob reads, no per-descriptor existence probes."""
    result = ScrubResult(repository=repository)

    if rehash:
        digests = sorted(store.list_blobs(repository))
        if sample and sample < len(digests):
            digests = sorted(random.Random(seed).sample(digests, sample))
            result.sampled = True
        for digest in digests:
            result.checked += 1
            ok = _rehash_ok(store, repository, digest)
            if ok is None:
                result.unreadable.append(digest)
                continue
            if ok:
                try:
                    result.bytes_hashed += store.get_blob_meta(
                        repository, digest
                    ).content_length
                except errors.ErrorInfo:
                    pass
                continue
            try:
                store.quarantine_blob(repository, digest)
                result.quarantined.append(digest)
                logger.warning("scrub: quarantined corrupt blob %s/%s", repository, digest)
            except (errors.ErrorInfo, OSError) as e:
                result.unreadable.append(digest)
                logger.warning("scrub: could not quarantine %s/%s: %s", repository, digest, e)

    # manifest/descriptor consistency — enumerate manifests from STORAGE,
    # not the index: a stale index (crash before refresh) must not hide a
    # manifest from the scrub
    refs = _manifest_refs(store, repository)
    if check_refs:
        for ref in refs:
            try:
                manifest = store.get_manifest(repository, ref)
            except errors.ErrorInfo as e:
                if e.http_status == 404:
                    continue  # deleted mid-scrub
                result.invalid_manifests.append(ref)
                continue
            for desc in manifest.all_descriptors():
                if not desc.digest:
                    continue
                if not store.exists_blob(repository, desc.digest):
                    result.dangling.append(
                        {"version": ref, "name": desc.name, "digest": str(desc.digest)}
                    )

    if refs:
        store.refresh_index(repository)
    return result


def _manifest_refs(store, repository: str) -> list[str]:
    lister = getattr(store, "_list_manifest_refs", None)
    if lister is not None:
        return lister(repository)
    try:
        return [m.name for m in store.get_index(repository).manifests]
    except errors.ErrorInfo:
        return []


def reconcile(store, rehash: bool = False, sample: int = 0, seed: int = 0) -> list[ScrubResult]:
    """Startup reconciliation: rebuild the global index from storage (so
    repositories whose commit crashed before the index refresh reappear),
    then rebuild every repo index. Index-only by default — no per-blob
    reads and no per-descriptor existence probes, so boot stays fast on
    object-store backends; ``rehash=True`` turns it into a full scrub
    (re-hash + dangling detection), the scrub route's job in steady state."""
    refresh = getattr(store, "refresh_global_index", None)
    if refresh is not None:
        refresh()
    results = []
    for entry in store.get_global_index().manifests:
        try:
            results.append(
                scrub_repository(store, entry.name, sample=sample, seed=seed,
                                 rehash=rehash, check_refs=rehash)
            )
        except Exception:
            logger.exception("reconcile: scrub of %s failed", entry.name)
    dirty = [r for r in results if not r.clean]
    if dirty:
        logger.warning(
            "reconcile: %d repositories need attention: %s",
            len(dirty),
            ", ".join(
                f"{r.repository} (quarantined={len(r.quarantined)} dangling={len(r.dangling)})"
                for r in dirty
            ),
        )
    return results
