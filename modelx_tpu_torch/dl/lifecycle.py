"""Dynamic model lifecycle: runtime load / drain / unload / evict
(counterpart of ``modelx_tpu/dl/lifecycle.py``).

A ``ModelPool`` owns every ``ModelServer`` behind a ``ServerSet`` and
drives each through an explicit state machine

    PULLING -> LOADING -> READY -> DRAINING -> UNLOADED
                  \\-> FAILED (slot retryable)

exposed on the serving HTTP surface (``dl/serve.py``, behind the admin
bearer-token filter) as

    GET    /admin/models          every entry's state + accounting
    POST   /admin/models          {"name", "ref"|"model_dir", "wait"?}
                                  pull a registry ref (through the blob
                                  cache) or point at a local dir, and load
                                  it while traffic to other models is live
    DELETE /admin/models/{name}   drain in-flight requests, stop admission,
                                  free device + host state

Request routing during transitions is typed (``dl/serving_errors.py``): a
model that is PULLING/LOADING answers 503 + ``Retry-After``, DRAINING 409,
FAILED 503 with the reason, UNLOADED/unknown 404, identically on the
native and OpenAI surfaces.

Device-memory budget: every load first estimates its footprint (the
manifest's ``.safetensors`` blob sizes for a registry ref, file sizes for a
local dir) and reserves it against ``hbm_budget_bytes``. A load that cannot
fit is refused with 507, unless ``evict_idle`` is set: then READY models
with no in-flight requests are evicted, least recently used first, until
the load fits. Beside the ledger, the card's own accounting
(``utils/devmem``) vetoes a load it cannot hold. A READY reservation
tightens to the server's ``stats["load_bytes"]``: the bytes that crossed
the link, so an int8 model over-reserves (the safe direction), as in the
reference. Evicted and unloaded models are demoted to host RAM or disk
(``dl/tiers.py``) when the tier budgets are set, and a reload of the same
content is promoted back. A load that hits ``torch.cuda.OutOfMemoryError``
demotes idle models and retries once.

The derived-artifact hooks ride on runtime (registry-ref) loads, as in
the reference: with ``publish_programs`` a load that turns READY publishes
the kernel library bundle to its model version (``dl/program_store.py``),
with ``attach_kv_publisher`` a background sweep ships hot prefix-KV entries
(``dl/kv_store.py``; flushed once more when a model drains), and with
``kv_fetch_through`` a prefix-cache miss consults the version's published
KV. With ``attach_outbox`` both publishes spool to disk and a drainer
pushes them (``dl/outbox.py``), so a registry outage never blocks a load.

``--hbm-budget-bytes`` is per device: on a weight-sharding mesh (tp, ep,
pp, fsdp) each device holds 1/factor of a model's bytes, so footprints are
divided by the mesh's weight-shard factor, rounding up (reference
``modelx_tpu/dl/lifecycle.py:177-189``). Without a mesh the factor is 1.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import logging
import os
import shutil
import threading
import time

from modelx_tpu_torch.dl import mesh_serve
from modelx_tpu_torch.dl.serving_errors import ServingError
from modelx_tpu_torch.utils import devmem

logger = logging.getLogger("modelx.lifecycle")

# -- lifecycle states ---------------------------------------------------------
PULLING = "PULLING"      # registry blobs streaming to the staging dir
LOADING = "LOADING"      # safetensors streaming onto the card + warm-up
READY = "READY"          # serving traffic
DRAINING = "DRAINING"    # admission stopped; in-flight requests finishing
UNLOADED = "UNLOADED"    # freed; the name 404s, the entry records history
FAILED = "FAILED"        # load crashed; slot retryable via re-POST

# states that hold (or are about to hold) device memory: their reservations
# count against the budget
_RESERVING = (PULLING, LOADING, READY, DRAINING)

# what pool_snapshot reports for the serving layout without a mesh: one
# device, which the reference spells as a dp=1 mesh
_MESH = "dp=1"


def _without_tracebacks(exc: BaseException) -> BaseException:
    """``exc`` with the tracebacks of it and its cause/context chain
    dropped (their frames' locals stay alive as long as they are)."""
    seen = 0
    cur = exc
    while cur is not None and seen < 8:
        cur.__traceback__ = None
        cur = cur.__cause__ or cur.__context__
        seen += 1
    return exc


class PoolError(Exception):
    """An admin-surface refusal with its HTTP status (the serving layer maps
    it 1:1 to a JSON error body). ``headers`` ride onto the response: a 507
    whose pressure could clear carries ``Retry-After``, a hard refusal
    carries none."""

    def __init__(self, status: int, message: str, headers: dict | None = None) -> None:
        super().__init__(message)
        self.status = status
        self.headers = dict(headers or {})


class ModelEntry:
    """One named model's lifecycle record. Lives for the pool's lifetime (an
    UNLOADED/FAILED entry keeps its counters and is re-usable: a re-POST of
    the same name retries into the same slot)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.state = LOADING
        self.state_since = time.monotonic()
        self.server = None          # ModelServer once LOADING starts
        self.error: str | None = None
        self.ref = ""               # registry uri when pulled at runtime
        self.model_dir = ""
        self.hbm_reserved_bytes = 0
        self.loads_total = 0
        self.evictions_total = 0
        self.drain_seconds: float | None = None  # last drain's duration
        self.inflight = 0
        self.last_used = time.monotonic()
        self._staged = False        # model_dir is pool-owned (safe to rm)
        self.tier_key = ""          # content digest into the tier store
        # which rung materialized the bytes:
        # "registry" | "mirror" | "cache" (offline) | "tier" | "dir"
        self.load_source = ""

    def to(self, state: str, error: str | None = None) -> None:
        self.state = state
        self.state_since = time.monotonic()
        self.error = error

    def snapshot(self) -> dict:
        """JSON-safe view for GET /admin/models and /v1/models."""
        snap = {
            "state": self.state,
            "state_age_s": round(time.monotonic() - self.state_since, 3),
            "hbm_reserved_bytes": int(self.hbm_reserved_bytes),
            "loads_total": self.loads_total,
            "evictions_total": self.evictions_total,
            "inflight": self.inflight,
        }
        if self.ref:
            snap["ref"] = self.ref
        if self.error:
            snap["error"] = self.error
        if self.load_source:
            snap["load_source"] = self.load_source
        if self.drain_seconds is not None:
            snap["drain_seconds"] = round(self.drain_seconds, 3)
        return snap


def estimate_dir_bytes(model_dir: str) -> int:
    """Device-footprint estimate for a local checkpoint dir: the summed
    ``*.safetensors`` file sizes."""
    total = 0
    for path in glob.glob(os.path.join(model_dir, "*.safetensors")):
        try:
            total += os.path.getsize(path)
        except OSError:
            pass
    return total


def estimate_ref_bytes(uri: str) -> int:
    """Device-footprint estimate for a registry ref, read from the
    manifest's ``.safetensors`` blob sizes before any byte is pulled, so an
    over-budget load is refused for free."""
    from modelx_tpu_torch.client.reference import parse_reference

    ref = parse_reference(uri)
    client = ref.client(quiet=True)
    manifest = client.get_manifest(ref.repository, ref.version)
    return sum((b.size or 0) for b in manifest.blobs if b.name.endswith(".safetensors"))


class ModelPool:
    """Owns the lifecycle of every model behind a ServerSet.

    The pool is always attached (``ServerSet`` creates one): it tracks
    states, in-flight counts and per-model accounting for the boot-time
    model set too. The admin load/unload surface additionally requires
    ``allow_admin_load`` (--allow-admin-load)."""

    # how long DELETE waits for in-flight requests before forcing the free
    DEFAULT_DRAIN_TIMEOUT_S = 30.0

    def __init__(self, sset, hbm_budget_bytes: int = 0, evict_idle: bool = False,
                 allow_admin_load: bool = False, staging_root: str = "",
                 drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
                 blob_cache=None, host_state_budget_bytes: int = 0,
                 disk_state_budget_bytes: int = 0, state_spool_dir: str = "",
                 mesh=None) -> None:
        self.sset = sset
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        # the serving mesh (ServerSet's): footprints meet the per-device
        # budget divided by its weight-shard factor; dp/sp replicate
        # weights, so a dp-only mesh keeps factor 1
        self.mesh = mesh
        self.weight_shard_factor = 1
        if mesh is not None:
            from modelx_tpu_torch.parallel.mesh import weight_shard_factor

            self.weight_shard_factor = max(1, weight_shard_factor(mesh))
        self.evict_idle = bool(evict_idle)
        self.allow_admin_load = bool(allow_admin_load)
        self.staging_root = staging_root
        # the local blob cache the pull path tees through (None = the
        # process default, dl/blob_cache.configure_default / --blob-cache-dir)
        self.blob_cache = blob_cache
        # --publish-programs: a ref-based load that reaches READY attaches
        # its kernel library to the model's registry version, so the next
        # puller binds it without nvcc (dl/program_store.py)
        self.publish_programs = False
        # --publish-kv: sweep live prefix caches for entries hot enough to
        # ship as kv bundles; --kv-fetch-through: a prefix-cache miss
        # consults the registry (dl/kv_store.py)
        self.publish_kv = False
        self.kv_publish_threshold = 2
        self.kv_fetch_through = False
        self.kv_publisher = None
        self._kv_fetchers: dict = {}
        self.drain_timeout_s = float(drain_timeout_s)
        # the pool's flight recorder: tier promotions and demotions, OOM
        # shed-and-retry, control-plane transitions (/debug/flightrec)
        from modelx_tpu_torch.utils.flightrec import FlightRecorder

        self.flightrec = FlightRecorder(capacity=256)
        # the durable publish outbox, when attached: program and kv
        # publishes spool to disk and a background drainer pushes them
        self.outbox = None
        self.outbox_drainer = None
        from modelx_tpu_torch.dl import manifest_cache

        manifest_cache.health().recorder = self.flightrec
        # demoted models' params staged in bounded host RAM / local disk,
        # so a re-load is a tier promotion, not a re-pull. Both budgets 0
        # (the default) keep the store inert
        from modelx_tpu_torch.dl import tiers as tiers_mod
        from modelx_tpu_torch.parallel.mesh import mesh_str

        # keyed by the mesh: a spool of another layout never promotes; on
        # a mesh every rank demotes and promotes its own slices
        self.tiers = tiers_mod.TierStore(
            host_budget_bytes=host_state_budget_bytes,
            disk_budget_bytes=disk_state_budget_bytes,
            spool_root=state_spool_dir, mesh_key=mesh_str(mesh) if mesh is not None else "",
            recorder=self.flightrec,
        )
        self._lock = threading.RLock()
        self._idle = threading.Condition(self._lock)  # inflight hit zero
        self.entries: dict[str, ModelEntry] = {}
        self.stats = {"loads_total": 0, "evictions_total": 0,
                      "load_failures_total": 0, "unloads_total": 0}
        for name, server in sset.servers.items():
            e = ModelEntry(name)
            e.server = server
            e.model_dir = server.model_dir
            self.entries[name] = e

    # -- derived-artifact publishes -------------------------------------------

    def attach_outbox(self, spool_dir: str, max_entries: int | None = None,
                      max_bytes: int | None = None, backoff_s: float | None = None,
                      start: bool = True) -> None:
        """Enable the durable publish outbox (``--publish-outbox-dir``):
        program and kv publishes enqueue to the on-disk spool and the
        background drainer replays them through the registry with backoff.
        Entries a previous process generation left drain too."""
        from modelx_tpu_torch.dl import kv_store, program_store
        from modelx_tpu_torch.dl import outbox as outbox_mod

        kwargs = {}
        if max_entries is not None:
            kwargs["max_entries"] = max_entries
        if max_bytes is not None:
            kwargs["max_bytes"] = max_bytes
        self.outbox = outbox_mod.Outbox(spool_dir, **kwargs)
        dkwargs = {"recorder": self.flightrec}
        if backoff_s is not None:
            dkwargs["backoff_s"] = backoff_s
        self.outbox_drainer = outbox_mod.Drainer(self.outbox, **dkwargs)
        # one spool, two artifact kinds: each entry replays through its own
        # publisher (kind-less entries default to "programs")
        self.outbox_drainer.register_handler(
            "programs", lambda _k, ref, data: program_store.publish_bundle(ref, data))
        self.outbox_drainer.register_handler(
            kv_store.OUTBOX_KIND, lambda _k, ref, data: kv_store.publish_bundle(ref, data))
        if start:
            self.outbox_drainer.start()

    def stop_outbox(self) -> None:
        if self.outbox_drainer is not None:
            self.outbox_drainer.stop()

    def attach_kv_publisher(self, threshold: int | None = None, interval_s: float = 5.0,
                            start: bool = True) -> None:
        """Enable the prefix-KV publisher (``--publish-kv``): a background
        sweep bundles hot PrefixKVCache entries of every ref-loaded model and
        hands them to the outbox (kind ``"kvcache"``) when one is attached,
        or publishes them directly."""
        from modelx_tpu_torch.dl import kv_store

        if threshold is not None:
            self.kv_publish_threshold = max(1, int(threshold))
        self.publish_kv = True

        def targets():
            with self._lock:
                return [(e.ref, e.server) for e in self.entries.values()
                        if e.ref and e.server is not None
                        and self._effective_state(e) in (READY, DRAINING)]

        def sink(ref: str, data: bytes) -> None:
            if self.outbox is not None:
                if not self.outbox.enqueue(kv_store.OUTBOX_KIND, ref, data):
                    raise RuntimeError("outbox refused kv bundle")
                if self.outbox_drainer is not None:
                    self.outbox_drainer.kick()
            else:
                kv_store.publish_bundle(ref, data)
            self.flightrec.record("kv.publish_enqueued", ref=ref, bytes=len(data),
                                  build_ms=round(self.kv_publisher.last_build_ms, 3))

        self.kv_publisher = kv_store.KVPublisher(
            targets, sink, threshold=self.kv_publish_threshold, interval_s=interval_s)
        if start:
            self.kv_publisher.start()

    def stop_kv(self) -> None:
        if self.kv_publisher is not None:
            self.kv_publisher.stop()
        with self._lock:
            fetchers = list(self._kv_fetchers.values())
            self._kv_fetchers.clear()
        for f in fetchers:
            f.stop()

    def _after_runtime_load(self, name: str, e: ModelEntry, server) -> None:
        """The derived-artifact hooks of a ref-based load that turned READY,
        off the serving path: a failure costs the next puller its shortcut,
        never this load."""
        if self.publish_programs and e.ref:
            from modelx_tpu_torch.dl import program_store
            from modelx_tpu_torch.kernels import build

            try:
                if self.outbox is not None:
                    data = program_store.bundle_for_server(e.ref, server, build.build_dir())
                    if data is not None:
                        self.outbox.enqueue("programs", e.ref, data)
                        if self.outbox_drainer is not None:
                            self.outbox_drainer.kick()
                else:
                    program_store.publish_for_server(e.ref, server, build.build_dir())
            except Exception:
                logger.exception("program publish for %s failed", name)
        if self.kv_fetch_through and e.ref and (self.mesh is None or self.mesh.size <= 1):
            # not on a mesh: a fetched bundle lands in rank 0's cache alone
            from modelx_tpu_torch.dl import kv_store

            try:
                fetcher = kv_store.fetcher_for_server(e.ref, server,
                                                      blob_cache=self.blob_cache)
                if fetcher is not None:
                    with self._lock:
                        self._kv_fetchers[name] = fetcher
                    self.flightrec.record("kv.fetch_through_attached", model=name)
            except Exception:
                logger.exception("kv fetch-through attach for %s failed", name)
        if self.kv_publisher is not None:
            self.kv_publisher.kick()

    # -- state transitions driven by ServerSet.load_all -----------------------

    def mark_loading(self, name: str) -> None:
        with self._lock:
            e = self.entries.get(name)
            if e is not None:
                e.to(LOADING)

    def _per_device(self, total_bytes: int) -> int:
        """Per-device footprint of ``total_bytes`` of weights on this
        pool's mesh (ceiling division: a budget must never round a
        footprint down to a free lunch)."""
        f = self.weight_shard_factor
        return int(total_bytes) if f <= 1 else -(-int(total_bytes) // f)

    def mark_ready(self, name: str) -> None:
        with self._lock:
            e = self.entries.get(name)
            if e is None:
                return
            e.to(READY)
            e.loads_total += 1
            self.stats["loads_total"] += 1
            if e.server is not None:
                e.hbm_reserved_bytes = self._per_device(
                    e.server.stats.get("load_bytes", 0) or 0) or e.hbm_reserved_bytes
            e.last_used = time.monotonic()

    def mark_failed(self, name: str, reason: str) -> None:
        with self._lock:
            e = self.entries.get(name)
            if e is None:
                return
            e.to(FAILED, error=reason)
            e.hbm_reserved_bytes = 0
            self.stats["load_failures_total"] += 1
            server = e.server
        if server is not None:
            # the crashed load may have landed some tensors on the card;
            # the reservation just went to zero, so they must free too or
            # the budget undercounts
            try:
                self._free_server(name, server)
            except Exception:
                logger.exception("freeing failed load of %s", name)

    # -- routing --------------------------------------------------------------

    def check_admission(self, name: str) -> None:
        """Raise the typed lifecycle error for a model that must not take
        new requests; no-op for READY (or a name the pool does not know).
        UNLOADED falls through: the server is gone from the ServerSet, so
        route resolution already answers 404."""
        from modelx_tpu_torch.dl.serving_errors import (
            ModelDrainingError, ModelFailedError, ModelLoadingError,
        )

        with self._lock:
            e = self.entries.get(name)
            if e is None:
                return
            state = self._effective_state(e)
            if state == DRAINING:
                raise ModelDrainingError(name)
            if state in (PULLING, LOADING):
                raise ModelLoadingError(name, state=state.lower(),
                                        retry_after=self._retry_after(e))
            if state == FAILED:
                raise ModelFailedError(name, e.error or "")

    def routing_error(self, name: str):
        """The typed error (or None) for a name that did not resolve to a
        live server: PULLING/LOADING entries have no server yet, so the 404
        path asks the pool before giving up."""
        from modelx_tpu_torch.dl.serving_errors import ServingError

        try:
            self.check_admission(name)
        except ServingError as e:
            return e
        return None

    def _retry_after(self, e: ModelEntry) -> float:
        # a load that just started gets a longer back-off than one that has
        # been running a while (it is presumably nearly done)
        age = time.monotonic() - e.state_since
        return 2.0 if age < 10.0 else 1.0

    def _effective_state(self, e: ModelEntry) -> str:
        """The entry's state, reconciled with direct-load paths that bypass
        the pool (a caller that runs ``server.load()`` itself): a LOADING
        entry whose server turned ready is READY."""
        if e.state == LOADING and e.server is not None and e.server.ready:
            e.to(READY)
            if not e.hbm_reserved_bytes:
                e.hbm_reserved_bytes = self._per_device(e.server.stats.get("load_bytes", 0) or 0)
        return e.state

    # -- in-flight accounting (drain + LRU recency) ---------------------------

    def enter(self, name: str) -> None:
        """Register one in-flight request. Raises when the model flipped to
        DRAINING (409) or all the way to UNLOADED (404) since the admission
        check, under the same lock the drain waits on: a request either
        counts (the drain waits for it) or is refused."""
        from modelx_tpu_torch.dl.serving_errors import ModelDrainingError, ModelUnloadedError

        with self._lock:
            e = self.entries.get(name)
            if e is None:
                return
            if e.state == DRAINING:
                raise ModelDrainingError(name)
            if e.state == UNLOADED:
                raise ModelUnloadedError(name)
            e.inflight += 1
            e.last_used = time.monotonic()

    def exit(self, name: str) -> None:
        with self._lock:
            e = self.entries.get(name)
            if e is not None:
                e.inflight = max(0, e.inflight - 1)
                e.last_used = time.monotonic()
                if e.inflight == 0:
                    self._idle.notify_all()

    # -- observability --------------------------------------------------------

    def states(self) -> dict:
        """{name: snapshot} for GET /admin/models and /v1/models."""
        with self._lock:
            out = {}
            for name, e in self.entries.items():
                st = self._effective_state(e)
                snap = e.snapshot()
                if self.tiers.enabled:
                    snap["tier"] = ("hbm" if st in _RESERVING
                                    else self.tiers.tier_of(e.tier_key) or "none")
                out[name] = snap
            return out

    def reserved_bytes(self) -> int:
        with self._lock:
            return sum(e.hbm_reserved_bytes for e in self.entries.values()
                       if self._effective_state(e) in _RESERVING)

    def pool_snapshot(self) -> dict:
        snap = dict(self.stats)
        snap["hbm_reserved_bytes"] = self.reserved_bytes()
        if self.hbm_budget_bytes:
            snap["hbm_budget_bytes"] = self.hbm_budget_bytes
        snap["evict_idle"] = self.evict_idle
        if self.mesh is not None:
            from modelx_tpu_torch.parallel.mesh import mesh_str

            snap["mesh"] = mesh_str(self.mesh)
            snap["mesh_devices"] = int(self.mesh.size)
        else:
            snap["mesh"] = _MESH
            snap["mesh_devices"] = 1
        snap["weight_shard_factor"] = self.weight_shard_factor
        # the card's own accounting beside the reservation ledger's
        # file-size estimates: the delta is the estimator's running error
        dm = devmem.sample()
        snap["hbm_bytes_measured"] = dm["hbm_bytes_in_use"]
        snap["hbm_measured_vs_reserved_delta"] = dm["hbm_bytes_in_use"] - snap["hbm_reserved_bytes"]
        snap["hbm_measured_source"] = dm["source"]
        if self.tiers.enabled:
            snap["tiers"] = self.tiers.snapshot()
        if self.outbox is not None:
            snap["outbox"] = (self.outbox_drainer.snapshot() if self.outbox_drainer is not None
                              else self.outbox.snapshot())
        if self.kv_publisher is not None:
            snap["kv_publisher"] = self.kv_publisher.snapshot()
        with self._lock:
            fetchers = dict(self._kv_fetchers)
        if fetchers:
            snap["kv_fetchers"] = {n: f.snapshot() for n, f in fetchers.items()}
        return snap

    def failed(self) -> dict[str, str]:
        """{name: reason} for every FAILED entry (/healthz's degraded set)."""
        with self._lock:
            return {name: (e.error or "load failed") for name, e in self.entries.items()
                    if self._effective_state(e) == FAILED}

    # -- admin: load ----------------------------------------------------------

    def request_load(self, name: str, ref: str = "", model_dir: str = "",
                     wait: bool = False, wait_timeout_s: float = 600.0) -> dict:
        """Admit a load request: validate the name, estimate + reserve the
        footprint (evicting idle models if allowed and needed), then run
        PULLING -> LOADING -> READY on a background thread. ``wait`` blocks
        until the entry leaves the transient states. Returns the entry
        snapshot."""
        if not self.allow_admin_load:
            raise PoolError(403, "admin model loading is disabled "
                                 "(start with --allow-admin-load)")
        if not name or not all(c.isalnum() or c in "._-" for c in name):
            raise PoolError(400, "name must be [A-Za-z0-9._-]+")
        if bool(ref) == bool(model_dir):
            raise PoolError(400, "send exactly one of ref or model_dir")

        # estimate before mutating any state: an unreachable ref or an
        # empty dir refuses cleanly, reserving nothing. The (name, size)
        # pairs that sum to the estimate are the tier key material, so a
        # tier hit is decided before any weight byte moves
        from modelx_tpu_torch.dl import tiers as tiers_mod

        try:
            pairs = tiers_mod.ref_pairs(ref) if ref else tiers_mod.dir_pairs(model_dir)
        except Exception as e:
            # a registry outage with no pinned manifest is transient: it
            # gets the retryable 507, not the 400 a bad ref earns
            from modelx_tpu_torch import errors as _errors
            from modelx_tpu_torch.utils.retry import retriable_status

            if isinstance(e, _errors.ErrorInfo) and retriable_status(e.http_status):
                raise PoolError(
                    507,
                    f"registry unreachable and no pinned manifest for "
                    f"{ref or model_dir!r}: {e}",
                    headers={"Retry-After": "5"},
                ) from e
            raise PoolError(400, f"cannot estimate footprint for "
                                 f"{ref or model_dir!r}: {e}") from e
        est = sum(p[1] for p in pairs)
        if est <= 0:
            raise PoolError(400, f"no safetensors found under {ref or model_dir!r}")
        tier_key = self.tiers.key_for(pairs) if self.tiers.enabled else ""
        # checkpoint file sizes are TOTAL weight bytes; the budget admits
        # what one device will actually hold on this pool's mesh
        est = self._per_device(est)

        frees: list = []
        try:
            with self._lock:
                e = self.entries.get(name)
                if e is not None:
                    state = self._effective_state(e)
                    if state not in (UNLOADED, FAILED):
                        raise PoolError(409, f"model {name!r} is {state}")
                self._ensure_budget(est, loading=name, frees=frees)
                if e is None:
                    e = self.entries[name] = ModelEntry(name)
                e.server = None
                e.ref = ref
                e.model_dir = model_dir
                e.load_source = "" if ref else "dir"
                e.hbm_reserved_bytes = est
                e.drain_seconds = None
                e.tier_key = tier_key
                e.to(PULLING if ref else LOADING)
        finally:
            # evicted victims' params and staging free outside the lock
            # (their routing entries already flipped UNLOADED), also when
            # the budget still refused after a partial eviction
            for art in frees:
                self._finish_free(art)
        t = threading.Thread(target=self._do_load, args=(e,), daemon=True,
                             name=f"model-load-{name}")
        t.start()
        if wait:
            deadline = time.monotonic() + wait_timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    if e.state in (READY, FAILED, UNLOADED):
                        break
                time.sleep(0.02)
        with self._lock:
            return {name: e.snapshot()}

    def _measured_shortfall(self, est: int) -> bool:
        """Does the card's own accounting say ``est`` more bytes will not
        fit, whatever the reservation ledger believes? Only the
        ``memory_stats`` source counts: without a CUDA context the sample
        reports nothing and never vetoes a load the ledger admitted."""
        dm = devmem.sample()
        return dm["source"] == "memory_stats" and est > dm["hbm_bytes_reservable"]

    def _fits(self, est: int, reserved: int) -> bool:
        if self.hbm_budget_bytes and reserved + est > self.hbm_budget_bytes:
            return False
        return not self._measured_shortfall(est)

    def _ensure_budget(self, est: int, loading: str = "", frees: list | None = None) -> None:
        """Caller holds the lock. Refuse (507) or LRU-evict until ``est``
        fits both the reservation ledger and the card's measured free
        memory; evicted victims' heavy artifacts land in ``frees`` for the
        caller to release after the lock."""
        if not self.hbm_budget_bytes and not self._measured_shortfall(est):
            return
        reserved = self.reserved_bytes()  # RLock: safe under the lock
        if self._fits(est, reserved):
            return
        if self.evict_idle:
            # LRU order over READY models with nothing in flight; never the
            # model being (re)loaded
            victims = sorted(
                (e for e in self.entries.values()
                 if self._effective_state(e) == READY and e.inflight == 0
                 and e.name != loading),
                key=lambda e: e.last_used,
            )
            for victim in victims:
                if len(self._serving_names()) <= 1:
                    # as request_unload: never empty the node; if the
                    # incoming load then FAILED, nothing would serve
                    break
                dm = devmem.sample()
                logger.info(
                    "evicting idle model %s (%d bytes reserved) for the budget; "
                    "device measures %d bytes in use (source=%s, delta=%+d vs %d "
                    "reserved pool-wide)",
                    victim.name, victim.hbm_reserved_bytes, dm["hbm_bytes_in_use"],
                    dm["source"], dm["hbm_bytes_in_use"] - reserved, reserved,
                )
                art = self._free_entry_locked(victim, evicted=True)
                if frees is not None:
                    frees.append(art)
                reserved = self.reserved_bytes()
                if self._fits(est, reserved):
                    return
        # the 507 contract: when pressure could clear (busy victims whose
        # drain would free enough bytes) the refusal says so and carries
        # Retry-After; otherwise it is a hard refusal
        could_free = sum(
            e.hbm_reserved_bytes for e in self.entries.values()
            if self._effective_state(e) in (READY, DRAINING) and e.name != loading
        )
        budget = self.hbm_budget_bytes
        free_now = (budget - reserved) if budget else 0
        if budget and est <= free_now + could_free:
            raise PoolError(
                507,
                f"load needs ~{est} bytes but only {free_now} of the "
                f"{budget}-byte HBM budget is free; demoting busy models "
                f"could free {could_free} more — retry after in-flight "
                "work drains"
                + ("" if self.evict_idle else
                   " (--evict-idle is off; unload a model first)"),
                headers={"Retry-After": "2"},
            )
        if budget:
            raise PoolError(
                507,
                f"load needs ~{est} bytes but only {free_now} of the "
                f"{budget}-byte HBM budget is free, and no demotion can "
                "make room (hard refusal)"
                + ("" if self.evict_idle else
                   " (--evict-idle is off; unload a model first)"),
            )
        dm = devmem.sample()
        raise PoolError(
            507,
            f"load needs ~{est} bytes but the device measures only "
            f"{dm['hbm_bytes_reservable']} bytes reservable "
            f"(source={dm['source']})"
            + ("; demotion could make room — retry after in-flight work "
               "drains" if could_free else " (hard refusal)"),
            headers={"Retry-After": "2"} if could_free else None,
        )

    def _staging_dir(self, name: str) -> str:
        root = self.staging_root or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "modelx-pool-staging")
        # per-load generation counter: a retry after FAILED must not trip
        # over a half-pulled previous attempt
        gen = int(time.monotonic() * 1e3) % 1_000_000
        return os.path.join(root, f"{name}-{gen}")

    def _do_load(self, e: ModelEntry) -> None:
        name = e.name
        # a dir load's checkpoint, which a mesh's followers read their
        # slices from (a promotion stages only the sidecars)
        source_dir = e.model_dir
        try:
            # tier promotion: a host/disk hit puts the demoted tensors back
            # on the card, skipping the registry pull and the safetensors
            # parse; a miss falls through to the pull path
            promo = self.tiers.promote(e.tier_key) if e.tier_key else None
            if promo is not None:
                dest = self._staging_dir(name)
                if promo.sidecar_dir:
                    # tokenizer/config sidecars preserved at demotion time
                    shutil.copytree(promo.sidecar_dir, dest, dirs_exist_ok=True)
                else:
                    os.makedirs(dest, exist_ok=True)
                stale = False
                with self._lock:
                    if e.state not in (PULLING, LOADING):  # raced an unload
                        stale = True
                    else:
                        e.model_dir = dest
                        e._staged = True
                        e.load_source = "tier"
                        e.to(LOADING)
                self.flightrec.record("ladder.source", model=name, source="tier",
                                      tier=promo.tier)
                if stale:
                    shutil.rmtree(dest, ignore_errors=True)
                    return
            elif e.ref:
                dest = self._staging_dir(name)
                from modelx_tpu_torch.dl.initializer import pull_model
                from modelx_tpu_torch.utils import trace

                with trace.span("lifecycle.pull", model=name, ref=e.ref):
                    pulled = pull_model(e.ref, dest, cache=self.blob_cache, quiet=True)
                # which rung served the bytes: registry, a read mirror, or
                # (offline) the pinned manifest + blob cache
                source = pulled.get("source", "registry")
                stale = False
                with self._lock:
                    if e.state != PULLING:  # raced an unload/retry
                        stale = True
                    else:
                        e.model_dir = source_dir = dest
                        e._staged = True
                        e.load_source = source
                        e.to(LOADING)
                self.flightrec.record("ladder.source", model=name, source=source,
                                      cache_hits=pulled.get("cache_hits", 0))
                if source == "cache":
                    logger.warning("model %s materialized OFFLINE from the pinned "
                                   "manifest + blob cache", name)
                if stale:
                    # the staging rmtree runs outside the pool lock: other
                    # tenants' admission must not stall behind it
                    shutil.rmtree(dest, ignore_errors=True)
                    return
            from modelx_tpu_torch.dl.serve import ModelServer

            kwargs = dict(self.sset.server_defaults)
            oplog = self.sset.oplog

            def attempt():
                server = ModelServer(e.model_dir, name=name, **kwargs)
                with self._lock:
                    e.server = server
                with contextlib.ExitStack() as held:
                    if oplog is not None:
                        # rank 0 of a mesh: every rank loads (its own slices,
                        # or its own tier's) under the one device lock, and
                        # the warm-up's collectives meet
                        server._device_lock = self.sset.device_lock
                        held.enter_context(server._device_lock)
                        seq = oplog.post("admin_load", name, tier_key=e.tier_key or "",
                                         source_dir=source_dir)
                        held.enter_context(mesh_serve.guarded(oplog, seq))
                    if promo is not None:
                        server.load_from_tier(promo)
                    else:
                        server.load()
                if oplog is not None:
                    server.attach_oplog(oplog, self.sset.device_lock)
                return server

            oom = None
            try:
                server = attempt()
            except Exception as exc:
                from modelx_tpu_torch.dl import tiers as tiers_mod

                if not tiers_mod.is_resource_exhausted(exc):
                    raise
                oom = _without_tracebacks(exc)
            if oom is not None:
                # out of device memory mid-load (the ledger admitted an
                # estimate the card could not honor): free the partial
                # tensors, demote idle victims, retry once; a second
                # failure lands FAILED through the normal path. The error's
                # tracebacks are dropped first: their frames hold the
                # failed load's tensors
                partial = e.server
                if partial is not None:
                    self._free_server(name, partial)
                gc.collect()
                freed = self.shed_idle_for_bytes(e.hbm_reserved_bytes, exclude=name)
                self.flightrec.record("pool.oom_retry", model=name, freed_bytes=freed)
                if freed <= 0:
                    raise oom
                logger.warning("load of %s ran out of device memory; demoted %d reserved "
                               "bytes of idle state, retrying once", name, freed)
                server = attempt()
            aborted = False
            with self._lock:
                # raced an unload/retry mid-load. READY with this server is
                # no race: a status read (_effective_state) saw the server
                # ready before this thread got the lock (the reference
                # aborts that load; the port keeps it)
                if e.state != LOADING and not (e.state == READY and e.server is server):
                    aborted = True
                else:
                    self.sset.add_server(name, server)
                    self.mark_ready(name)
            if aborted:
                self._free_server(name, server)  # outside the lock
                return
            logger.info("model %s loaded at runtime (%s)%s", name, e.ref or e.model_dir,
                        f" [promoted from {promo.tier} tier]" if promo else "")
            self._after_runtime_load(name, e, server)
        except BaseException as exc:  # FAILED is a state, not a crash
            from modelx_tpu_torch.dl.manifest_cache import OfflineUnavailableError

            if isinstance(exc, OfflineUnavailableError):
                # the bottom of the ladder: nothing local can serve this
                # ref until the registry recovers (slot retryable)
                self.flightrec.record("ladder.offline_unavailable", model=name)
            logger.warning("runtime load of %s failed: %s", name, exc)
            staged = ""
            with self._lock:
                if e._staged and e.model_dir:
                    staged = e.model_dir
                    e.model_dir = ""
                    e._staged = False
            if staged:
                shutil.rmtree(staged, ignore_errors=True)
            self.mark_failed(name, str(exc))

    # -- admin: unload / evict ------------------------------------------------

    def request_unload(self, name: str, wait: bool = True,
                       drain_timeout_s: float | None = None) -> dict:
        """Drain then free one model: admission stops at once (new requests
        409), in-flight requests get up to ``drain_timeout_s`` to finish,
        then device and host state free and the entry lands UNLOADED (the
        name 404s). FAILED/UNLOADED entries delete their record outright."""
        timeout = self.drain_timeout_s if drain_timeout_s is None else drain_timeout_s
        deleted_art = None
        with self._lock:
            e = self.entries.get(name)
            if e is None:
                raise PoolError(404, f"model {name!r} not found")
            state = self._effective_state(e)
            if state in (UNLOADED, FAILED):
                # delete the record outright, a FAILED boot tenant's zombie
                # server included (it would answer 503 forever)
                server, batcher, cb = self.sset.remove_server(name, close=False)
                staged = e.model_dir if e._staged else ""
                del self.entries[name]
                deleted_art = (name, server, batcher, cb, staged, e.tier_key, e.model_dir)
            elif state == DRAINING:
                raise PoolError(409, f"model {name!r} is already draining")
            elif state in (PULLING, LOADING):
                raise PoolError(409, f"model {name!r} is {state}; "
                                     "wait for the load to finish")
            elif len(self._serving_names()) <= 1:
                raise PoolError(409, "refusing to unload the last serving "
                                     "model (delete the pod instead)")
            else:
                e.to(DRAINING)
                t0 = time.monotonic()
        if deleted_art is not None:
            self._finish_free(deleted_art)  # outside the lock, as always
            return {name: {"state": "DELETED"}}

        def _drain() -> None:
            if self.kv_publisher is not None:
                # the last call before the prefix cache frees: an entry past
                # the threshold ships now (the outbox owns it from here, so
                # a dead registry cannot block the drain)
                try:
                    self.kv_publisher.flush()
                except Exception:
                    logger.exception("kv flush on drain of %s failed", name)
            with self._lock:
                deadline = time.monotonic() + timeout
                while e.inflight > 0 and time.monotonic() < deadline:
                    self._idle.wait(timeout=min(0.5, timeout))
                if e.inflight > 0:
                    logger.warning("drain of %s timed out with %d in flight; freeing "
                                   "anyway", name, e.inflight)
                e.drain_seconds = time.monotonic() - t0
                art = self._free_entry_locked(e, evicted=False)
            # the heavy part (batcher close, demotion, params release,
            # staging rmtree) runs outside the lock
            self._finish_free(art)

        if wait:
            _drain()
        else:
            threading.Thread(target=_drain, daemon=True, name=f"model-drain-{name}").start()
        with self._lock:
            snap = e.snapshot()
        return {name: snap}

    def _serving_names(self) -> list[str]:
        return [n for n, e in self.entries.items()
                if self._effective_state(e) in (READY, DRAINING)]

    def _free_entry_locked(self, e: ModelEntry, evicted: bool) -> tuple:
        """Caller holds the lock. The bookkeeping half of freeing a model:
        out of routing, the entry UNLOADED, the reservation released.
        Returns the heavy artifacts for ``_finish_free``, run after the
        lock is released."""
        name = e.name
        server, batcher, cb = self.sset.remove_server(name, close=False)
        staged = e.model_dir if e._staged else ""
        # demotion material: the key (computed at load admission, or lazily
        # off-lock from the dir) and the dir whose sidecars the tier entry
        # preserves
        sidecar_src = e.model_dir
        tier_key = e.tier_key
        if e._staged:
            e.model_dir = ""
            e._staged = False
        e.server = None
        e.hbm_reserved_bytes = 0
        e.to(UNLOADED)
        if evicted:
            e.evictions_total += 1
            self.stats["evictions_total"] += 1
        else:
            self.stats["unloads_total"] += 1
        logger.info("model %s %s", name, "evicted" if evicted else "unloaded")
        return name, server, batcher, cb, staged, tier_key, sidecar_src

    def _finish_free(self, art: tuple) -> None:
        """The heavy half of freeing a model: the batcher and the
        continuous engine close (the engine's KV state released), the
        server is demoted, then freed, then the staging dir is removed.
        Never called under the pool lock."""
        name, server, batcher, cb, staged, tier_key, sidecar_src = art
        with self._lock:
            fetcher = self._kv_fetchers.pop(name, None)
        if fetcher is not None:
            fetcher.stop()
        if batcher is not None:
            batcher.close()
        if cb is not None:
            cb.close()
            cb.release_device_state()
        if server is not None:
            oplog = self.sset.oplog
            if oplog is not None and oplog.failed is None:
                # the followers demote their slices under the same key, then
                # free them
                if self.tiers.enabled and not tier_key and sidecar_src:
                    from modelx_tpu_torch.dl import tiers as tiers_mod

                    tier_key = self.tiers.key_for(tiers_mod.dir_pairs(sidecar_src))
                with self.sset.device_lock, contextlib.suppress(ServingError):
                    oplog.post("admin_unload", name, tier_key=tier_key or "")
            # demotion instead of discard: stage the params into host RAM
            # or disk before _free_server drops them
            self._demote_server(name, server, tier_key, sidecar_src)
            self._free_server(name, server)
        if staged:
            shutil.rmtree(staged, ignore_errors=True)

    def _demote_server(self, name: str, server, tier_key: str, sidecar_src: str) -> None:
        """Offer a freed server's params to the tier store (no pool lock:
        the device->host copy is the heavy half of eviction). Never raises:
        a failed demotion degrades to a discard."""
        if not self.tiers.enabled or server.params is None:
            return
        try:
            if not tier_key and sidecar_src:
                # boot-time entries never went through request_load: key
                # them from the checkpoint dir at first demotion
                from modelx_tpu_torch.dl import tiers as tiers_mod

                tier_key = self.tiers.key_for(tiers_mod.dir_pairs(sidecar_src))
            if not tier_key:
                return
            self.tiers.offer(tier_key, name, server.params, family=server.family,
                             cfg=server.cfg, sidecar_src=sidecar_src)
            with self._lock:
                e = self.entries.get(name)
                if e is not None and not e.tier_key:
                    e.tier_key = tier_key  # a re-POST of the dir promotes
        except Exception:
            logger.exception("demotion of %s failed; state discarded", name)

    def shed_idle_for_bytes(self, need: int, exclude: str = "") -> int:
        """Demote idle READY victims (LRU first) until ``need`` reserved
        bytes are freed: the out-of-memory recovery path of loads (``need <=
        0`` frees one victim). Returns the reserved bytes freed; 0 when
        nothing was sheddable. Victims are idle, so no in-flight request is
        dropped."""
        frees: list = []
        freed = 0
        with self._lock:
            victims = sorted(
                (e for e in self.entries.values()
                 if self._effective_state(e) == READY and e.inflight == 0
                 and e.name != exclude),
                key=lambda e: e.last_used,
            )
            for victim in victims:
                if len(self._serving_names()) <= 1:
                    break  # never empty the node (request_unload's stance)
                freed += victim.hbm_reserved_bytes
                frees.append(self._free_entry_locked(victim, evicted=True))
                if need <= 0 or freed >= need:
                    break
        for art in frees:
            self._finish_free(art)
        return freed

    @staticmethod
    def _free_server(name: str, server) -> None:
        """Drop every device reference a ModelServer holds (params, stream
        decoders, the speculative decoder, the prefix cache's KV) so the
        tensors free once the last in-flight use of them ends."""
        server.ready = False
        with server._decoders_lock:
            server.params = None
            server._decoders.clear()
            server._spec_decoder = None
        if server._prefix_cache is not None:
            server._prefix_cache.clear()
