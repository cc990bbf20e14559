"""Multi-tier live model state: device memory -> host RAM -> local disk
(counterpart of ``modelx_tpu/dl/tiers.py``).

When the model pool evicts or unloads a model, its params are not
discarded: demotion copies them off the card into a bounded host-RAM tier,
host-tier overflow spools them to a bounded local-disk tier, and a later
load of the same content is a tier PROMOTION: the tensors go straight back
to the card (``ModelServer.load_from_tier``), with no fetch and no
safetensors parse.

Keying: entries are addressed by a digest over the checkpoint's sorted
``(safetensors name, size, salt)`` triples (``content_key``). A registry
ref salts with each blob's manifest digest, a local dir with each file's
mtime_ns, so two same-shaped checkpoints key apart and a rewritten file
misses. The port serves one device, so its mesh key is "".

The params dict is flattened into leaves: a tensor is one leaf, an int8
``ops/quant.QTensor`` two (its codes and its scales), rebuilt on promotion.
A card's leaves demote into views of one pinned host buffer per entry: on
an H100 the 16 GB buffer's allocation takes ~5.4 s, but the copies run at
~48-55 GB/s each way against 0.7-6.7 GB/s through pageable memory, so a
demotion costs less than a pageable one and a promotion from host ~7x
less (the smoke's ``pool`` phase measures both ways). The host tier's
budget bounds the host RAM this locks. CPU leaves (a model served on the
CPU) are plain copies. The disk tier spools each leaf as raw bytes beside
a ``meta.json`` of dtype names and shapes (bf16 has no numpy dtype), read
back with ``torch.frombuffer`` and ``view``.

The store is process-local live state: a restart falls back to the blob
cache and the registry. Entries are kept on promotion (weights are
immutable), so re-demoting an unchanged model only bumps its LRU clock.

Concurrency: one small lock covers the maps and byte accounting; the
device->host copy, the spool write and read, the sidecar copy and
directory removal run outside it, guarded by per-entry busy marks. A
demotion that crashes mid-copy (fault point ``tiers.demote`` of a
``fault_plan``: any object with ``maybe_fail(op)``; by default
``MODELX_FAULT_PLAN``'s) unregisters its
half-built entry and deletes its partial spool: the model is either fully
tiered or fully freed, never half.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time

import torch

logger = logging.getLogger("modelx.tiers")

__all__ = [
    "TierStore", "Promotion", "content_key", "dir_pairs", "ref_pairs",
    "is_resource_exhausted", "flatten_params", "unflatten_params",
]

# tier names as they appear in snapshots, events, and /admin/models
HOST = "host"
DISK = "disk"

# fault-plan ops: seeded crash points for the demotion drills
OP_DEMOTE = "tiers.demote"
OP_PROMOTE = "tiers.promote"
OP_SPILL = "tiers.spill"


def is_resource_exhausted(exc: BaseException | None) -> bool:
    """Is this exception (or anything in its cause/context chain) a device
    allocator failure? ``torch.cuda.OutOfMemoryError`` and a "CUDA out of
    memory" message anywhere in the chain, and the reference's XLA
    ``RESOURCE_EXHAUSTED`` spellings (matched by type name and text)."""
    seen = 0
    while exc is not None and seen < 8:
        name = type(exc).__name__
        text = str(exc)
        if isinstance(exc, torch.cuda.OutOfMemoryError) or "CUDA out of memory" in text:
            return True
        if "RESOURCE_EXHAUSTED" in text:
            return True
        if name in ("XlaRuntimeError", "ResourceExhausted", "ResourceExhaustedError"):
            low = text.lower()
            if "out of memory" in low or "allocat" in low:
                return True
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return False


def dir_pairs(model_dir: str) -> list[tuple[str, int, str]]:
    """Sorted ``(basename, size, mtime_ns)`` of every ``*.safetensors``
    under a local checkpoint dir: the content-key material for dir loads
    (an unchanged dir re-keys identically, a rewritten checkpoint misses)."""
    import glob

    pairs = []
    for path in glob.glob(os.path.join(model_dir, "*.safetensors")):
        try:
            st = os.stat(path)
            pairs.append((os.path.basename(path), int(st.st_size), str(st.st_mtime_ns)))
        except OSError:
            logger.debug("stat %s failed for tier key", path, exc_info=True)
    return sorted(pairs)


def ref_pairs(uri: str) -> list[tuple[str, int, str]]:
    """Sorted ``(blob name, size, digest)`` of a registry ref's
    ``.safetensors`` blobs, read from the manifest before any weight byte
    moves, so a tier hit skips the pull entirely."""
    from modelx_tpu_torch.client.reference import parse_reference

    ref = parse_reference(uri)
    client = ref.client(quiet=True)
    manifest = client.get_manifest(ref.repository, ref.version)
    return sorted(
        (b.name, int(b.size or 0), str(b.digest or ""))
        for b in manifest.blobs if b.name.endswith(".safetensors")
    )


def content_key(pairs: list[tuple[str, int, str]], mesh_key: str = "") -> str:
    """Digest of sorted ``(name, size, salt)`` triples + the mesh key.
    Empty when there is nothing to key (no safetensors)."""
    if not pairs:
        return ""
    h = hashlib.sha256()
    h.update(mesh_key.encode())
    for name, size, salt in sorted(pairs):
        h.update(b"\0")
        h.update(name.encode())
        h.update(str(int(size)).encode())
        h.update(b"\0")
        h.update(str(salt).encode())
    return h.hexdigest()[:16]


def flatten_params(params: dict) -> tuple[list, list]:
    """(leaves, treedef) of a params dict: each tensor one leaf, each
    ``QTensor`` two (codes, scales). ``treedef`` is ``[(name, kind)]``."""
    from modelx_tpu_torch.ops.quant import QTensor

    leaves: list = []
    treedef: list = []
    for name, value in params.items():
        if isinstance(value, QTensor):
            treedef.append((name, "qtensor"))
            leaves += [value.q, value.scale]
        else:
            treedef.append((name, "tensor"))
            leaves.append(value)
    return leaves, treedef


def unflatten_params(treedef: list, leaves: list) -> dict:
    from modelx_tpu_torch.ops.quant import QTensor

    out: dict = {}
    it = iter(leaves)
    for name, kind in treedef:
        if kind == "qtensor":
            q = next(it)
            out[name] = QTensor(q=q, scale=next(it))
        else:
            out[name] = next(it)
    return out


_HOST_ALIGN = 64  # each leaf's offset in a pinned entry buffer


def _host_copies(leaves: list) -> list:
    """Host copies of the leaves: views of one pinned buffer when they live
    on a card (one allocation, non-blocking copies, one synchronize), plain
    copies otherwise, so the tier never aliases a server's tensors."""
    if not any(leaf.is_cuda for leaf in leaves):
        return [leaf.detach().to("cpu", copy=True) for leaf in leaves]
    offsets, total = [], 0
    for leaf in leaves:
        offsets.append(total)
        total += -(-leaf.nbytes // _HOST_ALIGN) * _HOST_ALIGN
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    out = []
    for leaf, off in zip(leaves, offsets):
        view = buf[off:off + leaf.nbytes].view(leaf.dtype).view(leaf.shape)
        view.copy_(leaf, non_blocking=True)
        out.append(view)
    for dev in {leaf.device for leaf in leaves if leaf.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """A CPU tensor's bytes, without a copy when it is contiguous."""
    flat = t.contiguous().reshape(-1)
    if flat.numel() == 0:
        return memoryview(b"")
    return memoryview(flat.view(torch.uint8).numpy())


class Promotion:
    """What ``TierStore.promote`` hands the load path: host leaves and what
    it needs to rebuild the server without touching checkpoint bytes (one
    card: no sharding to restore, no abstract params to precompile)."""

    __slots__ = ("key", "tier", "leaves", "treedef", "family", "cfg", "sidecar_dir",
                 "nbytes")

    def __init__(self, key, tier, leaves, treedef, family, cfg, sidecar_dir, nbytes) -> None:
        self.key = key
        self.tier = tier
        self.leaves = leaves
        self.treedef = treedef
        self.family = family
        self.cfg = cfg
        self.sidecar_dir = sidecar_dir
        self.nbytes = nbytes


class _Entry:
    __slots__ = ("key", "name", "state", "treedef", "leaves", "spool_dir", "sidecar_dir",
                 "nbytes", "family", "cfg", "last_used", "hits", "busy", "dropped")

    def __init__(self, key: str, name: str) -> None:
        self.key = key
        self.name = name            # last model name staged under this key
        self.state = "staging"      # staging -> host -> disk (or dropped)
        self.treedef = None
        self.leaves: list | None = None   # host-RAM CPU tensors
        self.spool_dir = ""               # disk tier raw-byte spool
        self.sidecar_dir = ""             # tokenizer/config sidecars
        self.nbytes = 0
        self.family = None
        self.cfg = None
        self.last_used = time.monotonic()
        self.hits = 0
        self.busy = 0               # promotions/demotions in flight
        self.dropped = False        # delete deferred until busy drains


class TierStore:
    """Bounded host-RAM + local-disk staging for demoted model state.

    ``host_budget_bytes``/``disk_budget_bytes`` bound each tier (0 disables
    that tier; both 0 disables the store: ``offer`` and ``promote`` become
    no-ops and the pool discards evicted state). LRU within each tier: host
    overflow spills the least-recently-used host entry to disk, disk
    overflow drops the oldest spool.
    """

    def __init__(self, host_budget_bytes: int = 0, disk_budget_bytes: int = 0,
                 spool_root: str = "", mesh_key: str = "",
                 recorder=None, fault_plan=None) -> None:
        self.host_budget_bytes = int(host_budget_bytes)
        self.disk_budget_bytes = int(disk_budget_bytes)
        self.spool_root = spool_root or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "modelx-state-spool"
        )
        self.mesh_key = mesh_key
        self.recorder = recorder      # utils/flightrec.FlightRecorder or None
        if fault_plan is None:
            from modelx_tpu_torch.testing import faults

            fault_plan = faults.from_env()
        self.fault_plan = fault_plan  # anything with maybe_fail(op), or None
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        self.stats = {
            "host_hits": 0, "disk_hits": 0, "misses": 0,
            "demotions_host": 0, "demotions_disk": 0, "demotions_dropped": 0,
            "demotion_failures": 0, "promotions_host": 0,
            "promotions_disk": 0, "spills": 0, "spill_failures": 0,
        }

    @property
    def enabled(self) -> bool:
        return self.host_budget_bytes > 0 or self.disk_budget_bytes > 0

    def key_for(self, pairs: list[tuple[str, int]]) -> str:
        return content_key(pairs, self.mesh_key)

    def _record(self, event: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.record(event, **fields)

    def _fire(self, op: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.maybe_fail(op)

    # -- accounting (caller holds the lock) -----------------------------------

    def _tier_bytes(self, state: str) -> int:
        return sum(e.nbytes for e in self._entries.values() if e.state == state)

    def _touch(self, e: _Entry) -> None:
        e.last_used = time.monotonic()

    def _lru(self, state: str, exclude: str = "") -> "_Entry | None":
        live = [e for e in self._entries.values()
                if e.state == state and not e.busy and not e.dropped
                and e.key != exclude]
        return min(live, key=lambda e: e.last_used) if live else None

    # -- demotion -------------------------------------------------------------

    def offer(self, key: str, name: str, params, *, family=None, cfg=None,
              sidecar_src: str = "") -> bool:
        """Stage one model's live params into the tier ladder; called by
        the pool's free path off the pool lock. Returns True when the state
        landed (or was already staged). Never raises: a demotion failure
        degrades to a discard."""
        if not self.enabled or not key or params is None:
            return False
        with self._lock:
            cur = self._entries.get(key)
            if cur is not None:
                if cur.state in (HOST, DISK):
                    # weights are immutable: same key == same bytes; the
                    # existing entry just gets younger
                    self._touch(cur)
                    return True
                return False  # a demotion for this key is already staging
            e = self._entries[key] = _Entry(key, name)
        try:
            return self._demote(e, params, family, cfg, sidecar_src)
        except BaseException as exc:
            # mid-demotion crash (injected or real): fully freed, never
            # half; unregister the entry and delete any partial spool
            self._discard_partial(e)
            with self._lock:
                self.stats["demotion_failures"] += 1
            self._record("tier.demote.failed", model=name, error=str(exc))
            logger.warning("demotion of %s to tiers failed: %s", name, exc)
            return False

    def _demote(self, e: _Entry, params, family, cfg, sidecar_src: str) -> bool:
        """The heavy half of a demotion (no store lock held): fault point,
        device->host copy, sidecar preservation, then finalize under the
        lock and resolve any budget overflow."""
        self._fire(OP_DEMOTE)
        t0 = time.monotonic()
        leaves, treedef = flatten_params(params)
        nbytes = sum(int(leaf.nbytes) for leaf in leaves)
        fits_host = 0 < nbytes <= self.host_budget_bytes
        fits_disk = 0 < nbytes <= self.disk_budget_bytes
        if not fits_host and not fits_disk:
            self._discard_partial(e)
            with self._lock:
                self.stats["demotions_dropped"] += 1
            self._record("tier.demote.dropped", model=e.name, bytes=nbytes)
            return False
        host = _host_copies(leaves)
        sidecar = self._preserve_sidecar(e.key, sidecar_src)
        e.treedef = treedef
        e.nbytes = nbytes
        e.family = family
        e.cfg = cfg
        e.sidecar_dir = sidecar
        if fits_host:
            e.leaves = host
            spill_victims = self._finalize(e, HOST, "demotions_host")
        else:
            # straight to disk: the host tier is too small (or off). A full
            # disk (ENOSPC) drops this entry; the demotion path itself must
            # never crash over a spool write
            try:
                self._fire(OP_SPILL)
                self._spool(e, host)
            except OSError as exc:
                logger.warning("disk spool of %s failed (%s); dropping entry", e.name, exc)
                self._discard_partial(e)
                with self._lock:
                    self.stats["spill_failures"] += 1
                    self.stats["demotions_dropped"] += 1
                self._record("tier.spill.failed", model=e.name, bytes=nbytes, error=str(exc))
                return False
            spill_victims = self._finalize(e, DISK, "demotions_disk")
        self._resolve_spills(spill_victims)
        self._record(
            "tier.demote", model=e.name, tier=e.state, bytes=nbytes,
            ms=round((time.monotonic() - t0) * 1e3, 1),
        )
        logger.info("model %s demoted to %s tier (%d bytes)", e.name, e.state, nbytes)
        return True

    def _finalize(self, e: _Entry, state: str, stat: str) -> list:
        """Flip a staged entry live and collect LRU overflow victims
        (returned for the caller to resolve off the lock)."""
        with self._lock:
            e.state = state
            self._touch(e)
            self.stats[stat] += 1
            return self._overflow_locked(exclude=e.key)

    def _overflow_locked(self, exclude: str = "") -> list:
        """Caller holds the lock: pick (victim, action) pairs until both
        tiers fit their budgets; victims are marked busy. Actions: ``spill``
        (host -> disk) or ``drop``."""
        plan = []
        guard = 0
        while guard < 64:
            guard += 1
            host_bytes = self._tier_bytes(HOST)
            if self.host_budget_bytes and host_bytes > self.host_budget_bytes:
                v = self._lru(HOST, exclude=exclude)
                if v is None:
                    break
                v.busy += 1
                # spill when its bytes could ever fit the disk budget, else drop
                act = "spill" if 0 < v.nbytes <= self.disk_budget_bytes else "drop"
                if act == "spill":
                    v.state = DISK  # counts against disk from now on
                plan.append((v, act))
                continue
            disk_bytes = self._tier_bytes(DISK)
            if self.disk_budget_bytes and disk_bytes > self.disk_budget_bytes:
                v = self._lru(DISK, exclude=exclude)
                if v is None:
                    break
                v.busy += 1
                plan.append((v, "drop"))
                continue
            break
        return plan

    def _resolve_spills(self, plan: list) -> None:
        """Perform overflow actions off the lock: spool host victims to
        disk, delete dropped victims' artifacts."""
        for victim, action in plan:
            if action == "spill":
                try:
                    self._fire(OP_SPILL)
                    self._spool(victim, victim.leaves or [])
                    with self._lock:
                        victim.leaves = None
                        victim.busy -= 1
                        self.stats["spills"] += 1
                        more = self._overflow_locked()
                    self._record("tier.spill", model=victim.name, bytes=victim.nbytes)
                except BaseException as exc:
                    logger.warning("spill of %s to disk failed: %s", victim.name, exc)
                    with self._lock:
                        victim.busy -= 1
                        victim.dropped = True
                        self.stats["spill_failures"] += 1
                        more = []
                    self._reap(victim)
                    self._record("tier.spill.failed", model=victim.name,
                                 bytes=victim.nbytes, error=str(exc))
                self._resolve_spills(more)
            else:
                with self._lock:
                    victim.busy -= 1
                    victim.dropped = True
                    self.stats["demotions_dropped"] += 1
                self._reap(victim)
                self._record("tier.drop", model=victim.name, bytes=victim.nbytes)

    def _spool(self, e: _Entry, host_leaves: list) -> None:
        """Write each leaf's raw bytes under the spool root, with a
        ``meta.json`` of dtype names and shapes to view them back (a disk
        promote skips the safetensors parse: it reads and puts)."""
        spool = os.path.join(self.spool_root, e.key, "leaves")
        os.makedirs(spool, exist_ok=True)
        meta = []
        for i, leaf in enumerate(host_leaves):
            with open(os.path.join(spool, f"{i:05d}.raw"), "wb") as f:
                f.write(_raw_bytes(leaf))
            meta.append({"dtype": str(leaf.dtype).removeprefix("torch."),
                         "shape": list(leaf.shape)})
        with open(os.path.join(spool, "meta.json"), "w") as f:
            json.dump(meta, f)
        e.spool_dir = spool

    def _preserve_sidecar(self, key: str, src: str) -> str:
        """Copy the checkpoint dir's small non-safetensors files
        (tokenizer.json, config sidecars), so a promotion can rebuild a
        working ModelServer after the staged dir is removed. Weight files
        are not copied: the tiers hold those as tensors."""
        if not src or not os.path.isdir(src):
            return ""
        dest = os.path.join(self.spool_root, key, "sidecar")
        try:
            os.makedirs(dest, exist_ok=True)
            for fn in os.listdir(src):
                if fn.endswith(".safetensors"):
                    continue
                s = os.path.join(src, fn)
                if os.path.isfile(s):
                    shutil.copy2(s, os.path.join(dest, fn))
            return dest
        except OSError as exc:
            logger.warning("sidecar preserve from %s failed: %s", src, exc)
            return ""

    def _discard_partial(self, e: _Entry) -> None:
        """Unregister a half-built entry and remove anything it spooled
        (fully tiered or fully gone)."""
        with self._lock:
            self._entries.pop(e.key, None)
        shutil.rmtree(os.path.join(self.spool_root, e.key), ignore_errors=True)

    def _reap(self, e: _Entry) -> None:
        """Delete a dropped entry's disk artifacts and unregister it (host
        leaves free by losing the reference)."""
        with self._lock:
            if e.busy > 0:
                return  # the busy holder reaps on release
            self._entries.pop(e.key, None)
            e.leaves = None
        if e.spool_dir or e.sidecar_dir:
            shutil.rmtree(os.path.join(self.spool_root, e.key), ignore_errors=True)

    # -- promotion ------------------------------------------------------------

    def promote(self, key: str) -> Promotion | None:
        """Materialize a staged entry for the load path (host leaves ready
        for the card); None on a miss. The entry stays in its tier: weights
        are immutable, so the next demotion of the same content is free."""
        if not self.enabled or not key:
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.dropped or e.state not in (HOST, DISK):
                self.stats["misses"] += 1
                return None
            e.busy += 1
            self._touch(e)
            tier = e.state
        try:
            self._fire(OP_PROMOTE)
            t0 = time.monotonic()
            if tier == HOST:
                leaves = list(e.leaves or [])
            else:
                leaves = self._unspool(e)
            promo = Promotion(key, tier, leaves, e.treedef, e.family, e.cfg, e.sidecar_dir,
                              e.nbytes)
            with self._lock:
                e.hits += 1
                self.stats[f"{tier}_hits"] += 1
                self.stats[f"promotions_{tier}"] += 1
            self._record(
                "tier.promote", model=e.name, tier=tier, bytes=e.nbytes,
                ms=round((time.monotonic() - t0) * 1e3, 1),
            )
            return promo
        except BaseException as exc:
            logger.warning("promotion of %s from %s tier failed: %s", e.name, tier, exc)
            return None
        finally:
            dropped = False
            with self._lock:
                e.busy -= 1
                dropped = e.dropped and e.busy == 0
            if dropped:
                self._reap(e)

    def _unspool(self, e: _Entry) -> list:
        with open(os.path.join(e.spool_dir, "meta.json")) as f:
            meta = json.load(f)
        leaves = []
        for i, m in enumerate(meta):
            dtype = getattr(torch, m["dtype"])
            path = os.path.join(e.spool_dir, f"{i:05d}.raw")
            size = os.path.getsize(path)
            if size == 0:
                leaves.append(torch.empty(m["shape"], dtype=dtype))
                continue
            buf = bytearray(size)
            with open(path, "rb") as f:
                if f.readinto(buf) != size:
                    raise OSError(f"short read of {path}")
            flat = torch.frombuffer(buf, dtype=torch.uint8)
            leaves.append(flat.view(dtype).reshape(m["shape"]))
        return leaves

    # -- operational controls -------------------------------------------------

    def spill_host(self) -> int:
        """Push every host-tier entry to disk (the smoke's disk leg and a
        pre-shutdown spill). Returns how many entries moved."""
        moved = 0
        while True:
            with self._lock:
                e = self._lru(HOST)
                if e is None:
                    return moved
                e.busy += 1
            try:
                self._fire(OP_SPILL)
                self._spool(e, e.leaves or [])
                with self._lock:
                    e.state = DISK
                    e.leaves = None
                    e.busy -= 1
                    self.stats["spills"] += 1
                    plan = self._overflow_locked()
                moved += 1
                self._resolve_spills(plan)
            except BaseException as exc:
                logger.warning("spill of %s failed: %s", e.name, exc)
                with self._lock:
                    e.busy -= 1
                    e.dropped = True
                    self.stats["spill_failures"] += 1
                self._reap(e)
                self._record("tier.spill.failed", model=e.name, bytes=e.nbytes, error=str(exc))

    def drop(self, key: str) -> bool:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return False
            e.dropped = True
            busy = e.busy > 0
        if not busy:
            self._reap(e)
        return True

    def tier_of(self, key: str) -> str | None:
        if not key:
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.dropped or e.state not in (HOST, DISK):
                return None
            return e.state

    def close(self) -> None:
        """Drop everything (tests and shutdown): host tensors by reference,
        spools by removing each entry's directory."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.leaves = None
            if e.spool_dir or e.sidecar_dir:
                shutil.rmtree(os.path.join(self.spool_root, e.key), ignore_errors=True)

    def snapshot(self) -> dict:
        """Per-tier budgets/bytes/entries + hit/promotion/demotion counters
        for ``pool_snapshot()`` and ``/admin/models``."""
        with self._lock:
            host_entries = [e for e in self._entries.values() if e.state == HOST]
            disk_entries = [e for e in self._entries.values() if e.state == DISK]
            snap = {
                "host": {
                    "budget_bytes": self.host_budget_bytes,
                    "bytes": sum(e.nbytes for e in host_entries),
                    "entries": len(host_entries),
                    "hits": self.stats["host_hits"],
                    "demotions": self.stats["demotions_host"],
                    "promotions": self.stats["promotions_host"],
                },
                "disk": {
                    "budget_bytes": self.disk_budget_bytes,
                    "bytes": sum(e.nbytes for e in disk_entries),
                    "entries": len(disk_entries),
                    "hits": self.stats["disk_hits"],
                    "demotions": self.stats["demotions_disk"],
                    "promotions": self.stats["promotions_disk"],
                },
                "misses": self.stats["misses"],
                "spills": self.stats["spills"],
                "demotions_dropped": self.stats["demotions_dropped"],
                "demotion_failures": self.stats["demotion_failures"],
            }
        return snap
