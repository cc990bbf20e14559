"""Content-addressed prefix-KV store: ship hot prefix caches with the model
(counterpart of ``modelx_tpu/dl/kv_store.py``).

A pod's prefix cache (``models/decode.py PrefixKVCache``) dies with the
pod, and a popular shared system prompt is prefilled once per replica.
This module ships a hot entry through the registry: it serializes into one
deterministic tar (``meta.json`` first, then raw little-endian leaf buffers
``leaf-NNNNN.bin``) attached to the model version as a real manifest
descriptor under ``application/vnd.modelx.kvcache.v1``, so sha256
verification, scrub, quarantine and GC apply to it with no registry code
of its own. The format is the reference's: the same leaves bundled by both
packages give the same member names, leaf bytes and meta, apart from the
environment fields. Leaves go in the JAX pytree order of the entry dict
(sorted keys); a bf16 leaf is written as its 2-byte words and never goes
through fp32.

Keying: ``.kv-<env_key>-<prefix_hash>.tar``, where ``env_key`` is
``dl/program_store.py``'s environment digest (torch and CUDA versions, the
card's compute capability and arch, the code version, the mesh) and
``prefix_hash`` is sha256(model content key x env_key x the exact token
ids). Same prefix, same weights, same world: same name, and a republish is
a registry no-op.

Flow: pods count per-key hits and publish entries crossing a threshold
through the outbox (``dl/outbox.py``, kind ``"kvcache"``); pulls drop
``.kv-*.tar`` next to the weights and the server installs them at load; a
prefix-cache miss can fetch through to the registry (``KVFetcher``),
bounded by ``--prefix-cache-max-bytes``. Installed leaves land on the
server's device in one copy each, from a pinned host buffer on the card.
KV is a function of the token prefix, so a decode resumed from installed
KV equals a locally prefilled one, greedy and sampled.

Trust boundary, as program_store's: member names must match
``leaf-NNNNN.bin``, every member is re-hashed against the bundle's own
meta.json, leaf shapes and dtypes must be those the family's
``init_kv_cache`` gives for that length, and an install never overwrites
a local entry. Any miss, skew, truncation or corruption is logged, counted
and skipped: the caller prefills cold.
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
import threading
import time

import torch

from modelx_tpu_torch.dl import program_store as _ps
from modelx_tpu_torch.types import (
    AnnotationKVCode,
    AnnotationKVMesh,
    AnnotationKVModel,
    AnnotationKVPrefix,
    AnnotationKVTokens,
    Descriptor,
    Digest,
    Manifest,
    MediaTypeModelKVCache,
)

logger = logging.getLogger("modelx.kv")

BUNDLE_FORMAT = 1
META_MEMBER = "meta.json"
OUTBOX_KIND = "kvcache"
# the only member name a kv bundle may carry: a raw leaf buffer
_LEAF_RE = re.compile(r"^leaf-\d{5}\.bin$")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}  # the serving dtypes

# a KV layout's compatibility domain is the kernel library's
env_key = _ps.env_key
_env_key_of = _ps._env_key_of


def prefix_hash(model_key: str, envk: str, ids) -> str:
    """Digest naming one cached prefix within one (weights, environment)
    world: the token ids are the content, the model key scopes equal
    prompts across weights, the env key across environments."""
    payload = json.dumps([int(t) for t in ids], separators=(",", ":"))
    h = hashlib.sha256(f"{model_key}\x00{envk}\x00{payload}".encode())
    return h.hexdigest()[:16]


def bundle_name(envk: str, phash: str) -> str:
    """A dotfile on purpose, as program_store's."""
    return f".kv-{envk}-{phash}.tar"


def model_key_for_ref(ref: str) -> str:
    """Content key of the weights a registry ref names, salted by the
    blobs' digests (``dl/tiers.ref_pairs``), so every pod serving the same
    version derives the same key. "" when the manifest is unreachable:
    publishing retries later, installing skips the check."""
    from modelx_tpu_torch.dl import tiers as tiers_mod

    try:
        return tiers_mod.content_key(tiers_mod.ref_pairs(ref))
    except Exception as e:
        logger.warning("kv model key for %s unavailable: %s", ref, e)
        return ""


def _leaves(entry) -> list:
    """An entry's leaves in JAX's pytree order of a dict: sorted keys."""
    if isinstance(entry, dict):
        return [entry[k] for k in sorted(entry)]
    return []


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_bytes(leaf: torch.Tensor) -> bytes:
    """A leaf's little-endian bytes, copied to the host once; 2-byte
    dtypes go as their words (no trip through fp32)."""
    host = leaf.detach().to("cpu").contiguous()
    if host.element_size() == 2:
        host = host.view(torch.int16)
    return host.numpy().tobytes()


# --- bundle build -------------------------------------------------------------


def build_bundle(ids, entry, model_key: str = "", mesh=None) -> bytes | None:
    """Pack one PrefixKVCache entry into a deterministic tar: the same
    tokens and KV bytes give the same content address. None when there is
    nothing to ship or a leaf refuses to reach the host (publishing never
    breaks serving)."""
    ids = [int(t) for t in ids]
    leaves = _leaves(entry)
    if not ids or not leaves:
        return None
    framework, backend, code, mesh_s = _ps._env(mesh)
    envk = _env_key_of(framework, backend, code, mesh_s)
    members = []
    recorded = []
    for i, leaf in enumerate(leaves):
        name = f"leaf-{i:05d}.bin"
        try:
            data = _host_bytes(leaf)
        except Exception as e:
            logger.warning("kv bundle: leaf %d refused to materialize: %s", i, e)
            return None
        recorded.append({
            "name": name,
            "dtype": _dtype_name(leaf.dtype),
            "shape": [int(d) for d in leaf.shape],
            "spec": None,  # one card: no sharding to record
            "sha256": hashlib.sha256(data).hexdigest(),
            "size": len(data),
        })
        members.append((name, data))
    try:
        stored_len = int(recorded[0]["shape"][1])
    except IndexError:
        logger.warning("kv bundle: leaf 0 has no sequence axis; not bundling")
        return None
    meta = {
        "formatVersion": BUNDLE_FORMAT,
        "jax": framework,
        "backend": backend,
        "codeVersion": code,
        "mesh": mesh_s,
        "modelKey": model_key,
        "prefixHash": prefix_hash(model_key, envk, ids),
        "tokens": ids,
        "storedLen": stored_len,
        "leaves": recorded,
    }
    meta_bytes = json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()
    return _ps._tar([(META_MEMBER, meta_bytes)] + members)


def _bundle_meta(data: bytes) -> dict:
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tar:
        meta = json.loads(tar.extractfile(tar.getmember(META_MEMBER)).read())
    if not isinstance(meta, dict) or not isinstance(meta.get("leaves"), list):
        raise ValueError("kv bundle meta.json is not a kv bundle manifest")
    return meta


# --- bundle install -----------------------------------------------------------


def install_bundle(data: bytes, init_kv_cache, cache, mesh=None, model_key: str = "") -> dict:
    """Install one bundle into a live PrefixKVCache.

    Never raises: an undecodable tar, a missing or invalid meta, an
    environment, mesh or model skew, a tampered or truncated leaf, a leaf
    layout the family's ``init_kv_cache`` disowns, an entry that alone
    busts the cache's byte cap: each is logged, counted and skipped. An
    existing entry is never overwritten, and an installed one lands with
    origin "installed" (never republished, its hits counted apart).

    ``init_kv_cache(1, storedLen)`` is the shape oracle and the
    destination: its tensors (on the server's device) receive the leaves,
    one copy each, from a pinned host buffer when the device is a card."""
    stats = {"installed": 0, "present": 0, "skipped": 0, "reasons": []}

    def _skip(reason: str, n: int = 1) -> dict:
        stats["skipped"] += n
        stats["reasons"].append(reason)
        logger.warning("kv install: %s", reason)
        return stats

    try:
        tar = tarfile.open(fileobj=io.BytesIO(data), mode="r:")
    except (tarfile.TarError, ValueError, EOFError) as e:
        return _skip(f"unreadable bundle: {e}")
    with tar:
        try:
            meta = json.loads(tar.extractfile(tar.getmember(META_MEMBER)).read())
        except (KeyError, tarfile.TarError, ValueError, AttributeError, OSError) as e:
            return _skip(f"bundle meta unreadable: {e}")
        if not isinstance(meta, dict) or meta.get("formatVersion") != BUNDLE_FORMAT:
            return _skip(f"unsupported bundle format {meta.get('formatVersion')!r}"
                         if isinstance(meta, dict) else "bundle meta is not an object")
        framework, backend, code, mesh_s = _ps._env(mesh)
        got = (meta.get("jax"), meta.get("backend"), meta.get("codeVersion"))
        if got != (framework, backend, code):
            # the KV layout follows the code that produced it
            return _skip(
                "version skew: bundle built for jax=%s backend=%s code=%s, "
                "local jax=%s backend=%s code=%s" % (*got, framework, backend, code))
        if meta.get("mesh") != mesh_s:
            return _skip(f"mesh skew: bundle built for mesh={meta.get('mesh')!r}, "
                         f"local mesh={mesh_s}")
        got_model = meta.get("modelKey") or ""
        if model_key and got_model and got_model != model_key:
            return _skip(f"model skew: bundle keyed {got_model}, local {model_key}")
        ids = meta.get("tokens")
        if (not isinstance(ids, list) or not ids
                or not all(isinstance(t, int) for t in ids)):
            return _skip("bundle tokens missing or malformed")
        recorded = meta.get("leaves")
        if not isinstance(recorded, list) or not recorded:
            return _skip("bundle has no leaves")
        if cache.entry_origin(ids) is not None:
            stats["present"] += 1
            return stats
        stored_len = meta.get("storedLen")
        if not isinstance(stored_len, int) or stored_len < 1:
            return _skip(f"bundle storedLen {stored_len!r} invalid")
        # the model family is the shape oracle: a cache of this length has
        # exactly these leaves, in this order, with these shapes and dtypes
        try:
            want = init_kv_cache(1, stored_len)
        except Exception as e:
            return _skip(f"init_kv_cache refused length {stored_len}: {e}")
        want_leaves = _leaves(want)
        if len(want_leaves) != len(recorded):
            return _skip(f"bundle has {len(recorded)} leaves, model wants "
                         f"{len(want_leaves)}")
        total = sum(int(a.get("size", 0)) for a in recorded if isinstance(a, dict))
        if cache.max_bytes and total > cache.max_bytes:
            return _skip(f"entry ({total} bytes) exceeds prefix-cache byte cap "
                         f"({cache.max_bytes})")
        pinned = any(t.device.type == "cuda" for t in want_leaves)
        host_leaves = []
        for art, want_leaf in zip(recorded, want_leaves):
            name = art.get("name", "") if isinstance(art, dict) else ""
            if not _LEAF_RE.match(name):
                return _skip(f"leaf name {name!r} rejected")
            try:
                member = tar.getmember(name)
                f = tar.extractfile(member)
                # read straight into the staging buffer (pinned on the card)
                buf = torch.empty(member.size, dtype=torch.uint8, pin_memory=pinned)
                got_n = f.readinto(memoryview(buf.numpy()))
            except (KeyError, tarfile.TarError, AttributeError, OSError) as e:
                return _skip(f"leaf {name} unreadable: {e}")
            if (got_n != art.get("size") or member.size != art.get("size")
                    or hashlib.sha256(buf.numpy()).hexdigest() != art.get("sha256")):
                return _skip(f"leaf {name} fails hash/size check; not installing")
            try:
                dtype = _DTYPES[str(art.get("dtype"))]
                shape = tuple(int(d) for d in art.get("shape") or ())
                host = buf.view(dtype).reshape(shape)
            except (KeyError, TypeError, ValueError, RuntimeError) as e:
                return _skip(f"leaf {name} undecodable: {e!r}")
            if shape != tuple(want_leaf.shape) or dtype != want_leaf.dtype:
                return _skip(f"leaf {name} shape/dtype {shape}/{_dtype_name(dtype)} does "
                             f"not match model cache layout "
                             f"{tuple(want_leaf.shape)}/{_dtype_name(want_leaf.dtype)}")
            host_leaves.append(host)
        try:
            for dst, host in zip(want_leaves, host_leaves):
                dst.copy_(host, non_blocking=True)
            if pinned:
                # the pinned buffers must outlive their copies
                torch.cuda.synchronize(want_leaves[0].device)
        except Exception as e:
            return _skip(f"device placement failed: {e}")
        cache.put(ids, want, origin="installed")
        stats["installed"] += 1
        logger.info("kv install: %d-token prefix installed (%d leaves, %d bytes)",
                    len(ids), len(recorded), total)
    return stats


def install_from_dir(model_dir: str, init_kv_cache, cache, mesh=None,
                     model_key: str = "") -> dict:
    """Install every pulled kv bundle in a model dir (the load path: the
    pull drops ``.kv-*.tar`` next to the weights). Aggregated stats; never
    raises."""
    total = {"bundles": 0, "installed": 0, "present": 0, "skipped": 0, "reasons": []}
    for path in sorted(glob.glob(os.path.join(model_dir, ".kv-*.tar"))):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            total["reasons"].append(f"{os.path.basename(path)}: {e}")
            logger.warning("kv install: cannot read %s: %s", path, e)
            continue
        total["bundles"] += 1
        _ps._merge(total, install_bundle(data, init_kv_cache, cache, mesh=mesh,
                                         model_key=model_key))
    return total


# --- registry plumbing --------------------------------------------------------


def kv_descriptors(manifest: Manifest) -> list[Descriptor]:
    return [b for b in manifest.blobs if b.media_type == MediaTypeModelKVCache]


def publish(remote, repository: str, version: str, data: bytes) -> Descriptor:
    """Attach a kv bundle to an existing model version as a real
    descriptor, merged by name: a republished prefix replaces itself,
    other prefixes and environments coexist. The commit-delta retry is
    program_store's."""
    meta = _bundle_meta(data)
    envk = _env_key_of(str(meta.get("jax")), str(meta.get("backend")),
                       str(meta.get("codeVersion")), str(meta.get("mesh")))
    desc = Descriptor(
        name=bundle_name(envk, str(meta.get("prefixHash"))),
        media_type=MediaTypeModelKVCache,
        digest=Digest.from_bytes(data),
        size=len(data),
        annotations={
            AnnotationKVCode: str(meta.get("codeVersion")),
            AnnotationKVMesh: str(meta.get("mesh")),
            AnnotationKVModel: str(meta.get("modelKey") or ""),
            AnnotationKVTokens: str(len(meta.get("tokens") or ())),
            AnnotationKVPrefix: str(meta.get("prefixHash")),
        },
    )
    _ps.attach(remote, repository, version, desc, data)
    return desc


def publish_bundle(ref: str, data: bytes) -> Descriptor:
    """The network half of a kv publish, which the outbox's drainer
    replays for kind ``"kvcache"``: the bundle carries its own stamped
    environment and prefix hash."""
    from modelx_tpu_torch.client.reference import parse_reference

    parsed = parse_reference(ref)
    if not parsed.version:
        raise ValueError(f"kv publish needs an exact version, got {ref!r}")
    client = parsed.client(quiet=True)
    desc = publish(client.remote, parsed.repository, parsed.version, data)
    logger.info("published prefix KV for %s (%s, %d bytes)", ref, desc.name, desc.size)
    return desc


def _annotation_skew(desc: Descriptor, env: tuple) -> str:
    """"version" or "mesh" when the descriptor's stamp names another
    environment, else ""."""
    code = desc.annotations.get(AnnotationKVCode)
    if code is not None and code != env[2]:
        return "version"
    bundle_mesh = desc.annotations.get(AnnotationKVMesh)
    if bundle_mesh is not None and bundle_mesh != env[3]:
        return "mesh"
    return ""


def pull_and_install(client, repository: str, manifest: Manifest, init_kv_cache, cache,
                     blob_cache=None, mesh=None, model_key: str = "") -> dict:
    """Fetch the manifest's kv bundles (blob cache first) and install them
    into a live PrefixKVCache. An annotation skew skips without moving blob
    bytes; corrupt bytes are discarded. Never raises."""
    total = {"bundles": 0, "installed": 0, "present": 0, "skipped": 0, "reasons": []}
    env = _ps._env(mesh)
    for desc in kv_descriptors(manifest):
        skew = _annotation_skew(desc, env)
        if skew:
            total["skipped"] += 1
            total["reasons"].append(f"{desc.name}: {skew} skew (annotation)")
            continue
        try:
            data = _ps._read_blob(client, repository, desc, cache=blob_cache)
        except Exception as e:
            total["reasons"].append(f"{desc.name}: {e}")
            logger.warning("kv pull: %s unavailable: %s", desc.name, e)
            continue
        if data is None:
            total["reasons"].append(f"{desc.name}: digest mismatch")
            continue
        total["bundles"] += 1
        _ps._merge(total, install_bundle(data, init_kv_cache, cache, mesh=mesh,
                                         model_key=model_key))
    return total


# --- publisher (threshold -> outbox) ------------------------------------------


class KVPublisher:
    """Periodic sweep of live prefix caches for entries hot enough to ship.
    ``targets()`` yields ``(ref, server)`` pairs of ref-loaded serving
    models; each hot entry builds a bundle and goes to ``sink(ref, data)``,
    which the pool wires to the outbox (kind ``"kvcache"``), so durability
    and backoff are the drainer's. ``flush()`` runs one sweep now (the
    drain path's last call before an unload frees the cache)."""

    def __init__(self, targets, sink, threshold: int = 2, interval_s: float = 5.0,
                 sleeper=None) -> None:
        self.targets = targets  # () -> iterable of (ref, server)
        self.sink = sink        # (ref, data) -> None, may raise
        self.threshold = max(1, int(threshold))
        self.interval_s = float(interval_s)
        self._sleeper = sleeper or threading.Event.wait
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._keys: dict[str, str] = {}  # ref -> memoized model key
        self._lock = threading.Lock()
        self.stats = {"published_total": 0, "build_failures_total": 0,
                      "sink_failures_total": 0}
        # the last bundle's build time (device->host copy, hashing, tar),
        # which the sink may record beside its bytes
        self.last_build_ms = 0.0

    def _model_key(self, ref: str) -> str:
        key = self._keys.get(ref)
        if not key:
            key = model_key_for_ref(ref)
            if key:
                self._keys[ref] = key
        return key

    def flush(self) -> int:
        """One synchronous sweep; returns how many bundles left here."""
        shipped = 0
        for ref, server in list(self.targets()):
            cache = getattr(server, "_prefix_cache", None)
            if cache is None or not ref:
                continue
            for ids, entry in cache.take_publishable(self.threshold):
                model_key = self._model_key(ref)
                t0 = time.monotonic()
                data = build_bundle(ids, entry, model_key=model_key)
                self.last_build_ms = (time.monotonic() - t0) * 1e3
                if data is None:
                    with self._lock:
                        self.stats["build_failures_total"] += 1
                    continue
                try:
                    self.sink(ref, data)
                except Exception as e:
                    with self._lock:
                        self.stats["sink_failures_total"] += 1
                    logger.warning("kv publish sink for %s failed: %s", ref, e)
                    continue
                shipped += 1
                with self._lock:
                    self.stats["published_total"] += 1
        return shipped

    def kick(self) -> None:
        self._wake.set()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True, name="kv-publisher")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.flush()
            except Exception:
                # the sweep never dies quietly: the taken keys stay marked,
                # new heat still ships next interval
                logger.exception("kv publisher sweep failed")
            self._wake.clear()
            self._sleeper(self._wake, self.interval_s)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
        out["running"] = self._thread is not None
        out["threshold"] = self.threshold
        return out


# --- fetch-through (miss -> registry) -----------------------------------------


class KVFetcher:
    """On-demand install of published prefix KV at a prefix-cache miss.

    ``PrefixKVCache.lookup`` calls ``on_miss(ids)`` (outside its lock): the
    miss enqueues into a small dedup queue and a worker matches it against
    the version's kv descriptors by annotation alone until a hash matches,
    so a miss costs one cached manifest read and a few sha256s, not blob
    bytes. A matched bundle is pulled digest-verified through the blob
    cache and installed under the normal trust boundary; the next lookup
    of that prompt hits. Tried digests are remembered, so a bad bundle is
    not refetched on every miss."""

    MAX_QUEUE = 16
    MANIFEST_TTL_S = 5.0

    def __init__(self, ref: str, init_kv_cache, cache, mesh=None, model_key: str = "",
                 blob_cache=None, sleeper=None) -> None:
        self.ref = ref
        self.init_kv_cache = init_kv_cache
        self.cache = cache
        self.mesh = mesh
        self.model_key = model_key
        self.blob_cache = blob_cache
        self._sleeper = sleeper or threading.Event.wait
        self._lock = threading.Lock()
        self._pending: list[tuple] = []
        self._tried: set[str] = set()   # descriptor digests already pulled
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._manifest = None
        self._manifest_at = 0.0
        self.stats = {"misses_seen_total": 0, "fetched_total": 0,
                      "installed_total": 0, "errors_total": 0, "install_ms_total": 0.0}

    def on_miss(self, ids) -> None:
        """O(1) bounded dedup enqueue; never blocks or raises."""
        key = tuple(int(t) for t in ids)
        with self._lock:
            self.stats["misses_seen_total"] += 1
            if key in self._pending or len(self._pending) >= self.MAX_QUEUE:
                return
            self._pending.append(key)
        self._wake.set()

    def _get_manifest(self, client, repository: str, version: str):
        now = time.monotonic()
        if self._manifest is not None and now - self._manifest_at < self.MANIFEST_TTL_S:
            return self._manifest
        self._manifest = client.get_manifest(repository, version)
        self._manifest_at = now
        return self._manifest

    def drain_once(self) -> bool:
        """Process one queued miss; True when one was consumed."""
        with self._lock:
            if not self._pending:
                return False
            ids = self._pending.pop(0)
        try:
            self._fetch_for(ids)
        except Exception as e:
            with self._lock:
                self.stats["errors_total"] += 1
            logger.warning("kv fetch-through for %s failed: %s", self.ref, e)
        return True

    def _fetch_for(self, ids: tuple) -> None:
        from modelx_tpu_torch.client.reference import parse_reference

        parsed = parse_reference(self.ref)
        if not parsed.version:
            return
        client = parsed.client(quiet=True)
        manifest = self._get_manifest(client, parsed.repository, parsed.version)
        env = _ps._env(self.mesh)
        envk = _env_key_of(*env)
        for desc in kv_descriptors(manifest):
            if _annotation_skew(desc, env):
                continue
            try:
                length = int(desc.annotations.get(AnnotationKVTokens, "0"))
            except ValueError:
                continue
            # strict prefix: the suffix prefill needs >= 1 real token
            if length < 1 or length >= len(ids):
                continue
            want = desc.annotations.get(AnnotationKVPrefix, "")
            got = prefix_hash(desc.annotations.get(AnnotationKVModel, ""), envk, ids[:length])
            if not want or want != got:
                continue
            digest = str(desc.digest)
            with self._lock:
                if digest in self._tried:
                    continue
                self._tried.add(digest)
            data = _ps._read_blob(client, parsed.repository, desc, cache=self.blob_cache)
            if data is None:
                continue
            with self._lock:
                self.stats["fetched_total"] += 1
            t0 = time.monotonic()
            stats = install_bundle(data, self.init_kv_cache, self.cache, mesh=self.mesh,
                                   model_key=self.model_key)
            with self._lock:
                self.stats["installed_total"] += stats["installed"]
                self.stats["install_ms_total"] += (time.monotonic() - t0) * 1e3

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True, name="kv-fetcher")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.drain_once():
                continue
            self._wake.clear()
            self._sleeper(self._wake, None)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["pending"] = len(self._pending)
        out["running"] = self._thread is not None
        return out


# --- server glue --------------------------------------------------------------


def _server_init(server):
    """The server's family cache allocator on its device, or None."""
    if server.family is None or server.family.decode_fns is None or server.params is None:
        return None
    try:
        return server.family.decode_fns(server.params, server.cfg)[1]
    except Exception as e:
        logger.warning("kv: decode fns unavailable: %s", e)
        return None


def install_for_server(server, model_dir: str, model_key: str = "") -> dict | None:
    """Install every pulled kv bundle in ``model_dir`` into a freshly
    loaded server's prefix cache (the tail of ``ModelServer.load``, once
    the family is known). Never raises; None when the server has no prefix
    cache or no decode fns."""
    cache = getattr(server, "_prefix_cache", None)
    init = _server_init(server) if cache is not None else None
    if init is None:
        return None
    return install_from_dir(model_dir, init, cache, model_key=model_key)


def fetcher_for_server(ref: str, server, blob_cache=None,
                       model_key: str = "") -> KVFetcher | None:
    """Build, attach and start a fetch-through worker for a ref-loaded
    server: its prefix-cache misses then consult the registry. None when
    the server has no prefix cache or no decode fns."""
    cache = getattr(server, "_prefix_cache", None)
    init = _server_init(server) if cache is not None and ref else None
    if init is None:
        return None
    fetcher = KVFetcher(ref, init, cache, model_key=model_key, blob_cache=blob_cache)
    cache.fetcher = fetcher
    fetcher.start()
    return fetcher
