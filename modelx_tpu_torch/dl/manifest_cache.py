"""Pinned-manifest cache and control-plane health (counterpart of
``modelx_tpu/dl/manifest_cache.py``).

Every successful manifest fetch is persisted on local disk (``{ref ->
manifest JSON, config yaml, fetched_at}``), and
``RegistryClient.get_manifest`` serves the pinned copy when every endpoint
is down: stale-while-revalidate, where stale is safe because blobs are
content-addressed and verify against their digests on use.

``ControlPlaneHealth`` is the pod's view of registry reachability, which
``/healthz`` reports as ``control_plane: ok|degraded|offline``. Readiness
never gates on it: a pod whose models are ready keeps serving through a
registry outage.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import tempfile
import threading
import time

logger = logging.getLogger("modelx.dl")

_ENV_DIR = "MODELX_MANIFEST_CACHE_DIR"


class OfflineUnavailableError(Exception):
    """The control plane is down and the local ladder (cached manifest +
    blob cache + tier store) cannot materialize the model. The lifecycle
    pool maps this to the retryable-507 contract: the pressure clears
    when the registry comes back."""


def _entry_key(registry: str, repository: str, version: str) -> str:
    ident = f"{registry.rstrip('/')}/{repository}@{version or 'latest'}"
    return hashlib.sha256(ident.encode()).hexdigest()


class ManifestCache:
    """Disk-persisted ``{ref -> pinned manifest}`` map, one JSON file per
    ref under ``root``. Writes are atomic (temp + rename) so a crashed
    pod never leaves a torn entry; reads tolerate garbage (a corrupt
    entry reads as a miss and the next successful fetch rewrites it)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self.stats = {"puts": 0, "hits": 0, "misses": 0, "stale_served": 0}

    def _path(self, registry: str, repository: str, version: str) -> str:
        return os.path.join(
            self.root, _entry_key(registry, repository, version) + ".json"
        )

    def put(self, registry: str, repository: str, version: str,
            manifest, config_yaml: bytes | None = None) -> None:
        """Persist a fetch that just succeeded. ``config_yaml`` (the
        modelx.yaml sidecar) is optional and merged into an existing
        entry when absent — manifest and config fetches happen at
        different call sites."""
        path = self._path(registry, repository, version)
        entry = {
            "registry": registry.rstrip("/"),
            "repository": repository,
            "version": version or "latest",
            "manifest": manifest.to_json(),
            "fetched_at": time.time(),
        }
        # all file I/O runs lock-free: the temp+rename write is atomic on
        # its own, and a racing manifest-put vs config-put for the same
        # ref at worst drops a config sidecar the next fetch rewrites
        if config_yaml is None:
            prev = self._read(path)
            if prev and "config_yaml_b64" in prev:
                entry["config_yaml_b64"] = prev["config_yaml_b64"]
        else:
            entry["config_yaml_b64"] = base64.b64encode(
                config_yaml).decode("ascii")
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".put-")
            with os.fdopen(fd, "w") as f:
                json.dump(entry, f)
            os.replace(tmp, path)
        except OSError as e:
            # a full/read-only disk must not fail the fetch that
            # succeeded — the cache just stays cold for this ref
            logger.warning("manifest cache write for %s/%s failed: %s",
                           repository, version, e)
            return
        with self._lock:
            self.stats["puts"] += 1

    @staticmethod
    def _read(path: str) -> dict | None:
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            return None
        return entry if isinstance(entry, dict) else None

    def lookup(self, registry: str, repository: str, version: str):
        """The pinned :class:`~modelx_tpu_torch.types.Manifest` for a ref, or
        None. Counts a hit/miss; the caller decides whether serving it is
        a ``stale_served`` event (see :meth:`note_stale_served`)."""
        from modelx_tpu_torch.types import Manifest

        entry = self._read(self._path(registry, repository, version))
        with self._lock:
            if entry is None or "manifest" not in entry:
                self.stats["misses"] += 1
                return None
            self.stats["hits"] += 1
        try:
            return Manifest.from_json(entry["manifest"])
        except (KeyError, TypeError, ValueError):
            return None

    def lookup_config(self, registry: str, repository: str,
                      version: str) -> bytes | None:
        """The cached modelx.yaml bytes for a ref (None when the entry or
        its config sidecar is absent)."""
        entry = self._read(self._path(registry, repository, version))
        if not entry or "config_yaml_b64" not in entry:
            return None
        try:
            return base64.b64decode(entry["config_yaml_b64"])
        except (ValueError, TypeError):
            return None

    def age_s(self, registry: str, repository: str,
              version: str) -> float | None:
        entry = self._read(self._path(registry, repository, version))
        if not entry:
            return None
        return max(0.0, time.time() - float(entry.get("fetched_at", 0)))

    def note_stale_served(self) -> None:
        with self._lock:
            self.stats["stale_served"] += 1


# -- process-wide default (the serving pod's cache) ---------------------------

_default_lock = threading.Lock()
_default: ManifestCache | None = None
_default_configured = False


def configure_default(root: str) -> ManifestCache | None:
    """Set the process-wide manifest cache (``--manifest-cache-dir``).
    Empty root disables it."""
    global _default, _default_configured
    with _default_lock:
        _default = ManifestCache(root) if root else None
        _default_configured = True
        return _default


def default_cache() -> ManifestCache | None:
    """The process default: whatever ``configure_default`` set, else the
    ``MODELX_MANIFEST_CACHE_DIR`` env var, else disabled."""
    global _default, _default_configured
    with _default_lock:
        if not _default_configured:
            root = os.environ.get(_ENV_DIR, "")
            _default = ManifestCache(root) if root else None
            _default_configured = True
        return _default


# -- control-plane health ------------------------------------------------------

OK = "ok"
DEGRADED = "degraded"
OFFLINE = "offline"

# how long after the last failure a clean primary success is still
# "degraded": one blip should read as a brownout for a beat, not flap
# ok/degraded per request
_DEGRADED_WINDOW_S = 30.0


class ControlPlaneHealth:
    """Event-driven registry reachability for one pod.

    - ``ok``: the most recent registry interaction succeeded on the
      primary endpoint, with no failure inside the degraded window;
    - ``degraded``: talking to the control plane, but not cleanly — the
      last success came off a mirror, or a failure happened recently;
    - ``offline``: the most recent interaction failed everywhere (or was
      served from the pinned-manifest cache).

    Readiness never gates on this block; it is an operator/rebalancer
    signal."""

    def __init__(self, clock=time.monotonic) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._last_ok_t = 0.0
            self._last_fail_t = 0.0
            self._last_ok_mirror = False
            self._state = OK
            self.stats = {"ok_total": 0, "mirror_ok_total": 0,
                          "failures_total": 0, "offline_serves_total": 0}

    def _transition(self, state: str) -> None:
        """Caller holds the lock."""
        prev = self._state
        if prev == state:
            return
        self._state = state
        logger.info("control plane %s -> %s", prev, state)

    def note_ok(self, mirror: bool = False) -> None:
        with self._lock:
            now = self._clock()
            self._last_ok_t = now
            self._last_ok_mirror = bool(mirror)
            self.stats["ok_total"] += 1
            if mirror:
                self.stats["mirror_ok_total"] += 1
            if mirror or now - self._last_fail_t < _DEGRADED_WINDOW_S:
                self._transition(DEGRADED)
            else:
                self._transition(OK)

    def note_failure(self) -> None:
        with self._lock:
            self._last_fail_t = self._clock()
            self.stats["failures_total"] += 1
            self._transition(OFFLINE)

    def note_offline_serve(self) -> None:
        """A pull/keying was served from the pinned cache because every
        endpoint was down — offline, but the data plane kept going."""
        with self._lock:
            self._last_fail_t = self._clock()
            self.stats["offline_serves_total"] += 1
            self._transition(OFFLINE)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def status(self) -> dict:
        with self._lock:
            out = {"state": self._state}
            out.update(self.stats)
            if self._last_ok_t:
                out["last_ok_age_s"] = round(self._clock() - self._last_ok_t, 3)
            if self._last_fail_t:
                out["last_failure_age_s"] = round(
                    self._clock() - self._last_fail_t, 3)
            return out


_health = ControlPlaneHealth()


def health() -> ControlPlaneHealth:
    """The process-wide tracker (one pod = one control-plane view)."""
    return _health
