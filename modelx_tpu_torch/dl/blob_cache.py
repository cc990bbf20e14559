"""Content-addressed local blob cache (counterpart of
``modelx_tpu/dl/blob_cache.py``): the middle tier between the registry and
the card. A re-deploy of a model the node has already served does not pay
the network again.

Cold loads wrap their network source in ``CachingByteSource``, which tees
every ranged read into a sparse spool file; when the reads cover the blob
(the loader reads each tensor's bytes exactly once; the header and padding
are backfilled), the spool is digest-verified and admitted. Warm loads find
the blob by digest and read it with local preads: zero network reads.

Entries are keyed by the manifest blob digest, and verification happens on
both ends: on admit (a corrupted transfer never enters the cache) and on
hit (a corrupted entry is evicted and the caller falls back to the
network), so the cache never serves bytes the registry did not sign off
on. Eviction is size-capped LRU over entry mtimes (hits touch the file),
run at admit time; ``max_bytes == 0`` means unbounded.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import threading
import time

logger = logging.getLogger("modelx.dl")

# how much of a blob may be missing after a load and still be backfilled
# from the network at finalize time (the safetensors header + alignment
# padding are never part of a tensor fetch plan when the manifest carries
# the tensor index, so a healthy cold load leaves a few KB of gaps)
BACKFILL_MAX_FRACTION = 0.05
BACKFILL_MAX_BYTES = 4 << 20

_ENV_DIR = "MODELX_BLOB_CACHE_DIR"
_ENV_MAX = "MODELX_BLOB_CACHE_MAX_BYTES"

_tmp_counter = itertools.count()


def _hasher_for(digest: str):
    algo = digest.partition(":")[0]
    try:
        return hashlib.new(algo)
    except (ValueError, TypeError):
        return None


def _file_digest_hex(path: str, digest: str) -> str | None:
    h = _hasher_for(digest)
    if h is None:
        return None
    with open(path, "rb") as f:
        while chunk := f.read(4 << 20):
            h.update(chunk)
    return h.hexdigest()


class BlobCache:
    """Directory of digest-named blob files with size-capped LRU eviction.

    ``lookup`` verifies the entry's content digest before handing it out
    (a warm load reads the file anyway; one extra page-cache pass buys
    never serving corrupted weights) — pass ``verify_on_hit=False`` to
    trade that for a size-only check on trusted local disks.
    """

    def __init__(self, root: str, max_bytes: int = 0, verify_on_hit: bool = True) -> None:
        self.root = root
        self.max_bytes = max(0, int(max_bytes))
        self.verify_on_hit = verify_on_hit
        self._lock = threading.Lock()
        self.stats: dict = {
            "hits": 0, "misses": 0, "admitted": 0, "evicted": 0,
            "corrupt_rejected": 0, "admit_rejected": 0,
            # the subset of corrupt_rejected where the hit-path DIGEST
            # re-check failed on a size-plausible resident entry: a
            # rising value means the cache volume itself is rotting
            # (bit flips / torn writes), not just truncated spools
            "cache_corrupt_evictions": 0,
            # seconds spent hashing entries on hits and spools on admits:
            # each is one sha256 pass over the blob
            "hit_verify_seconds": 0.0, "admit_verify_seconds": 0.0,
        }
        os.makedirs(root, exist_ok=True)
        self._sweep_stale_spools()

    def _sweep_stale_spools(self) -> None:
        """Delete spool files left by DEAD processes (a pod OOM-killed mid
        cold load never runs CachingByteSource.close). Spool names embed
        the writer's pid; a live pid's spool is left alone. Untracked
        spools would otherwise sit invisible to the LRU cap and fill the
        cache volume across crash loops."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if ".tmp-" not in name:
                continue
            try:
                pid = int(name.split(".tmp-", 1)[1].split("-", 1)[0])
                os.kill(pid, 0)  # existence probe, no signal delivered
            except (ValueError, IndexError, PermissionError):
                continue  # unparseable, or pid alive under another uid
            except ProcessLookupError:
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass

    def entry_path(self, digest: str) -> str:
        algo, _, hexv = str(digest).partition(":")
        return os.path.join(self.root, f"{algo}-{hexv}.blob")

    def lookup(self, digest: str, expected_size: int = -1) -> str | None:
        """Path of a verified cached blob, or None (miss / corrupt entry —
        corrupt entries are deleted so the network fallback repairs them)."""
        if _hasher_for(digest) is None:
            return None
        path = self.entry_path(digest)
        try:
            size = os.path.getsize(path)
        except OSError:
            with self._lock:
                self.stats["misses"] += 1
            return None
        ok = expected_size < 0 or size == expected_size
        digest_bad = False
        if ok and self.verify_on_hit:
            t0 = time.monotonic()
            digest_bad = (
                _file_digest_hex(path, digest) != str(digest).partition(":")[2]
            )
            with self._lock:
                self.stats["hit_verify_seconds"] += time.monotonic() - t0
            ok = not digest_bad
        if not ok:
            logger.warning("blob cache entry %s failed verification; evicting", path)
            try:
                os.unlink(path)
            except OSError:
                pass
            with self._lock:
                self.stats["corrupt_rejected"] += 1
                if digest_bad:
                    self.stats["cache_corrupt_evictions"] += 1
            # returning None routes the caller back to the network: the
            # next successful fetch re-admits a clean copy
            return None
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        with self._lock:
            self.stats["hits"] += 1
        return path

    def wrap(self, source, digest: str, size: int):
        """Tee ``source``'s ranged reads toward admission. Returns the
        source unchanged when the blob can't be cached (no usable digest
        or unknown size)."""
        if size is None or size <= 0 or _hasher_for(digest) is None:
            return source
        return CachingByteSource(source, self, digest, size)

    def admit_file(self, digest: str, tmp_path: str) -> str | None:
        """Verify + atomically install a fully-spooled blob; evicts LRU
        entries first so the cache lands under ``max_bytes``. A blob larger
        than the whole cap is refused outright — evicting everything to
        install an over-cap entry would leave the cache permanently over
        budget. (In-flight spools are NOT counted against the cap; size the
        volume with one blob of transient headroom per concurrent cold
        load.) The temp file is consumed either way."""
        try:
            size = os.path.getsize(tmp_path)
            if self.max_bytes and size > self.max_bytes:
                logger.warning(
                    "blob %s (%d bytes) exceeds the cache cap (%d); not admitting",
                    digest, size, self.max_bytes,
                )
                with self._lock:
                    self.stats["admit_rejected"] += 1
                os.unlink(tmp_path)
                return None
            t0 = time.monotonic()
            verified = _file_digest_hex(tmp_path, digest) == str(digest).partition(":")[2]
            with self._lock:
                self.stats["admit_verify_seconds"] += time.monotonic() - t0
            if not verified:
                logger.warning(
                    "blob %s spool failed digest verification; not admitting", digest
                )
                with self._lock:
                    self.stats["admit_rejected"] += 1
                os.unlink(tmp_path)
                return None
            final = self.entry_path(digest)
            # plan + perform eviction and the final rename OUTSIDE the
            # lock (lint: blocking-under-lock): the replace is atomic at
            # the FS level and entries are content-addressed, so a racing
            # admit of the same digest lands identical bytes; two racing
            # admits of different digests can transiently overshoot the
            # cap by one blob until the next admit's sweep — the cap is a
            # budget, not an invariant. The lock now guards only stats.
            evicted = self._evict_for(size, keep=final)
            os.replace(tmp_path, final)
            with self._lock:
                self.stats["evicted"] += evicted
                self.stats["admitted"] += 1
            return final
        except OSError:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
            return None

    def total_bytes(self) -> int:
        total = 0
        for name in self._entries():
            try:
                total += os.path.getsize(os.path.join(self.root, name))
            except OSError:
                pass
        return total

    def _entries(self) -> list[str]:
        try:
            return [n for n in os.listdir(self.root) if n.endswith(".blob")]
        except OSError:
            return []

    def _evict_for(self, incoming: int, keep: str = "") -> int:
        """LRU-evict (oldest mtime first) until incoming fits under the
        cap; returns the eviction count. Runs WITHOUT the lock — unlink
        is idempotent under races and the stats update happens in the
        caller's locked section."""
        if not self.max_bytes:
            return 0
        entries = []
        for name in self._entries():
            path = os.path.join(self.root, name)
            if path == keep:
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
        entries.sort()
        total = sum(size for _m, size, _p in entries)
        evicted = 0
        while entries and total + incoming > self.max_bytes:
            _mtime, size, path = entries.pop(0)
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            evicted += 1
        return evicted


class CachingByteSource:
    """Wraps a network ``ByteSource``; every ranged read is teed (pwrite)
    into a size-preallocated spool file. ``close()`` finalizes: small gaps
    (header/padding the fetch plan never touches) are backfilled from the
    network, then the spool is digest-verified and admitted to the cache.
    A load that fetched only a shard subset (multi-host) or died mid-way
    leaves gaps above the backfill bound and the spool is discarded —
    admission is all-or-nothing, the cache never holds partial blobs."""

    cache_state = "cold"

    def __init__(self, source, cache: BlobCache, digest: str, size: int) -> None:
        self.source = source
        self.cache = cache
        self.digest = str(digest)
        self._size = int(size)
        self.network_reads = 0
        self.network_bytes = 0
        self._lock = threading.Lock()
        self._spans: list[tuple[int, int]] = []  # merged, sorted coverage
        self._tmp = self.cache.entry_path(digest) + f".tmp-{os.getpid()}-{next(_tmp_counter)}"
        self._fd = os.open(self._tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        os.ftruncate(self._fd, self._size)
        self._closed = False
        self._dead = False  # tee failed (e.g. cache volume full): loads go on

    def read_range(self, offset: int, length: int, out=None):
        buf = self.source.read_range(offset, length, out)
        if not self._dead:
            try:
                os.pwrite(
                    self._fd,
                    buf[:length] if isinstance(buf, bytes) else memoryview(buf)[:length],
                    offset,
                )
            except OSError:
                # the cache is an optimization, never load-bearing: a full
                # or unwritable cache volume must not fail the deploy —
                # stop teeing, serve the bytes, discard the spool at close
                self._dead = True
                logger.warning(
                    "blob cache spool write failed for %s; continuing uncached",
                    self.digest, exc_info=True,
                )
            else:
                with self._lock:
                    self._add_span(offset, offset + length)
        with self._lock:
            self.network_reads += 1
            self.network_bytes += length
        return buf

    def size(self) -> int:
        return self._size

    def _add_span(self, start: int, end: int) -> None:
        """Insert + merge (the fetch plan's reads rarely touch, so the list
        stays short). Caller holds the lock."""
        spans = self._spans
        spans.append((start, end))
        spans.sort()
        merged = [spans[0]]
        for s, e in spans[1:]:
            ls, le = merged[-1]
            if s <= le:
                merged[-1] = (ls, max(le, e))
            else:
                merged.append((s, e))
        self._spans = merged

    def _gaps(self) -> list[tuple[int, int]]:
        gaps, pos = [], 0
        for s, e in self._spans:
            if s > pos:
                gaps.append((pos, s))
            pos = max(pos, e)
        if pos < self._size:
            gaps.append((pos, self._size))
        return gaps

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            gaps = self._gaps() if not self._dead else [(0, self._size)]
            missing = sum(e - s for s, e in gaps)
            budget = max(BACKFILL_MAX_BYTES, int(BACKFILL_MAX_FRACTION * self._size))
            # backfill only a LOAD's leftovers (header/padding): requiring
            # majority coverage keeps a header-only probe of a small blob
            # from turning its close() into a full synchronous download
            if missing and missing <= budget and missing < self._size - missing:
                for s, e in gaps:
                    data = self.source.read_range(s, e - s)
                    os.pwrite(self._fd, memoryview(data)[: e - s] if not isinstance(data, bytes) else data, s)
                missing = 0
            os.close(self._fd)
            self._fd = -1
            if missing == 0:
                self.cache.admit_file(self.digest, self._tmp)
            else:
                os.unlink(self._tmp)
        except OSError:
            logger.warning("blob cache spool for %s abandoned", self.digest, exc_info=True)
            try:
                if self._fd >= 0:
                    os.close(self._fd)
                os.unlink(self._tmp)
            except OSError:
                pass
        finally:
            if hasattr(self.source, "close"):
                self.source.close()


# -- process-default cache ----------------------------------------------------
#
# Deploy surfaces (modelx-serve, modelx dl, dl/ttft) configure one cache per
# process; the env vars let subprocess harnesses (bench legs, TTFT children)
# inherit it without threading a path through every argv.

_default: "BlobCache | None" = None
_default_set = False
_default_lock = threading.Lock()


def configure_default(root: str, max_bytes: int = 0) -> "BlobCache | None":
    """Install (or, with an empty root, disable) the process-default cache."""
    global _default, _default_set
    with _default_lock:
        _default = BlobCache(root, max_bytes=max_bytes) if root else None
        _default_set = True
        return _default


def default_cache() -> "BlobCache | None":
    """The configured process default, else one built from
    ``MODELX_BLOB_CACHE_DIR`` / ``MODELX_BLOB_CACHE_MAX_BYTES``, else None."""
    global _default, _default_set
    with _default_lock:
        if _default_set:
            return _default
        root = os.environ.get(_ENV_DIR, "")
        if root:
            try:
                _default = BlobCache(root, max_bytes=int(os.environ.get(_ENV_MAX, "0") or 0))
            except (OSError, ValueError):
                _default = None
            _default_set = True
        return _default
