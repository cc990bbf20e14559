"""Deploy-time storage initializer, the ``modelxdl`` of the port
(counterpart of ``modelx_tpu/dl/initializer.py``): pull a model version, or
the part of it that ``modelFiles`` selects, into a volume, and with
``device_put`` stream its safetensors blobs from the registry onto the card
and report GB/s.

Each blob's bytes take the best transport on a fixed ladder
(``_blob_source``): the registry's ``file`` location (a colocated store),
then a digest-verified blob-cache entry, then the presigned URL, then the
registry's ranged blob GET; the last two tee into the blob cache for the
next deploy. One card: a ``modelx.shard.mesh`` or ``modelx.shard.spec``
annotation is read and has nothing to place.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import time

import torch

from modelx_tpu_torch import errors
from modelx_tpu_torch.client.model_config import ModelConfig
from modelx_tpu_torch.client.pull import Puller
from modelx_tpu_torch.client.reference import parse_reference
from modelx_tpu_torch.types import (
    AnnotationShardSpec,
    AnnotationTensorIndex,
    BlobLocationPurposeDownload,
    Manifest,
    MediaTypeModelDirectoryTarGz,
    MediaTypeModelKVCache,
    MediaTypeModelProgram,
)
from modelx_tpu_torch.utils import trace
from modelx_tpu_torch.utils.retry import retriable_status

logger = logging.getLogger("modelx.dl")


def filter_blobs(manifest: Manifest, model_files: list[str]) -> Manifest:
    """Keep only blobs selected by modelFiles. An entry matches a blob when
    the blob is the entry itself or the entry's first path element (nested
    files live inside directory blobs). Program and KV bundles always ride
    along."""
    if not model_files:
        return manifest
    wanted: set[str] = set()
    for entry in model_files:
        entry = entry.strip("/")
        if entry:
            wanted.add(entry)
            wanted.add(entry.split("/", 1)[0])  # top-level dir blob
    blobs = [
        b for b in manifest.blobs
        if b.name in wanted
        or b.media_type in (MediaTypeModelProgram, MediaTypeModelKVCache)
    ]
    return Manifest(
        schema_version=manifest.schema_version,
        media_type=manifest.media_type,
        config=manifest.config,
        blobs=blobs,
        annotations=manifest.annotations,
    )


def _resolve_selected(uri: str, quiet: bool):
    """Parse the reference, fetch the manifest and its modelx.yaml, apply
    the ``modelFiles`` filter. Returns (ref, client, config, selected
    manifest). A modelx.yaml that is unavailable offline, invalid, or
    outside the reader's subset selects every blob."""
    ref = parse_reference(uri)
    client = ref.client(quiet=quiet)
    with trace.span("dl.manifest", uri=uri):
        manifest = client.get_manifest(ref.repository, ref.version)
        config = ModelConfig()
        if manifest.config.digest:
            try:
                raw = client.get_config_content(ref.repository, ref.version)
            except errors.ErrorInfo as e:
                if not retriable_status(e.http_status):
                    raise
                logger.warning("modelx.yaml for %s unavailable offline; pulling everything",
                               uri)
                raw = b""
            if raw:
                try:
                    config = ModelConfig.from_yaml(raw)
                except ValueError as e:
                    logger.warning("invalid modelx.yaml in %s (%s); pulling everything", uri, e)
    return ref, client, config, filter_blobs(manifest, config.model_files)


def run_initializer(
    uri: str,
    dest: str,
    device_put: bool = False,
    device: str | torch.device | None = None,
    quiet: bool = False,
    blob_cache_dir: str = "",
    blob_cache_max_bytes: int = 0,
) -> dict:
    """Pull ``uri`` into ``dest``; with ``device_put``, then load its
    safetensors blobs onto ``device`` (``cuda`` unless the caller asks for
    another). Returns a summary dict (timings, GB/s); ``load["arrays"]``
    holds the loaded tensors."""
    from modelx_tpu_torch.device import resolve_device

    cache = None
    if device_put:
        from modelx_tpu_torch.dl import blob_cache as bc

        device = resolve_device(device)  # raises before any byte moves
        cache = (bc.BlobCache(blob_cache_dir, max_bytes=blob_cache_max_bytes)
                 if blob_cache_dir else bc.default_cache())
    t0 = time.monotonic()
    ref, client, config, selected = _resolve_selected(uri, quiet)
    puller = Puller(client.remote, quiet=quiet)
    with trace.span("dl.pull", blobs=len(selected.blobs)):
        puller.pull_blobs(ref.repository, selected, dest)
    pull_seconds = time.monotonic() - t0
    summary: dict = {
        "uri": uri,
        "dest": dest,
        "blobs": len(selected.blobs),
        "bytes": sum(b.size for b in selected.blobs),
        "pull_seconds": round(pull_seconds, 3),
        "pull": dict(puller.stats),
    }
    if device_put:
        summary["load"] = load_to_device(client, ref.repository, selected, device,
                                         quiet=quiet, cache=cache)
        if cache is not None:
            summary["blob_cache"] = dict(cache.stats)
    summary["total_seconds"] = round(time.monotonic() - t0, 3)
    return summary


def _link_or_copy(src: str, dst: str) -> None:
    """``dst`` as a hard link of ``src`` when both lie on one filesystem,
    else a copy: a cache hit materializes without a second copy of the
    bytes on disk. Safe because nothing writes a pulled file in place (the
    puller replaces files whole)."""
    tmp = f"{dst}.link-{os.getpid()}"
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, dst)
        return
    os.replace(tmp, dst)


def pull_model(uri: str, dest: str, cache=None, quiet: bool = True) -> dict:
    """Pull a registry ref into ``dest`` through the local blob cache: file
    blobs the cache holds are hard-linked from it (copied across
    filesystems; zero network reads; the puller's hash-skip then finds
    them up to date), and freshly pulled blobs are admitted for the next
    load the same way.

    When the manifest came off the pinned cache because every registry
    endpoint is down (``last_source == "cache"``), the pull runs offline:
    every weight/tokenizer blob must come digest-verified out of the blob
    cache, program and KV bundles are skipped, and a blob the node does
    not hold raises ``OfflineUnavailableError``."""
    from modelx_tpu_torch.dl import blob_cache as bc
    from modelx_tpu_torch.dl.manifest_cache import OfflineUnavailableError

    if cache is None:
        cache = bc.default_cache()
    t0 = time.monotonic()
    ref, client, _config, selected = _resolve_selected(uri, quiet)
    # "registry" | "mirror" | "cache": "cache" means every endpoint was
    # down and this pull must be offline
    source = getattr(client.remote, "last_source", "registry")
    offline = source == "cache"
    os.makedirs(dest, exist_ok=True)
    file_blobs = [
        b for b in selected.blobs
        if b.digest and b.media_type != MediaTypeModelDirectoryTarGz
    ]
    cache_hits = 0
    offline_skipped_programs = 0
    if cache is not None:
        for blob in file_blobs:
            hit = cache.lookup(blob.digest, expected_size=blob.size or -1)
            if hit is None:
                if offline:
                    if blob.media_type in (MediaTypeModelProgram, MediaTypeModelKVCache):
                        offline_skipped_programs += 1  # boot cold, don't fail
                        continue
                    raise OfflineUnavailableError(
                        f"registry unreachable and blob {blob.name!r} "
                        f"({blob.digest}) is not in the local blob cache")
                continue
            target = os.path.join(dest, blob.name)
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            try:
                _link_or_copy(hit, target)
                os.chmod(target, blob.mode or 0o644)
                cache_hits += 1
            except OSError:
                if offline:
                    raise OfflineUnavailableError(
                        f"registry unreachable and cached blob {blob.name!r} "
                        "vanished mid-copy (concurrent eviction)")
                # a racing LRU eviction unlinked the entry: the puller
                # fetches it over the network like any miss
    if offline:
        missing_dirs = [
            b.name for b in selected.blobs
            if b.digest and b.media_type == MediaTypeModelDirectoryTarGz
        ]
        if missing_dirs:
            raise OfflineUnavailableError(
                "registry unreachable and directory blobs cannot be "
                f"materialized from the blob cache: {missing_dirs}")
        if cache is None:
            raise OfflineUnavailableError(
                "registry unreachable and no local blob cache is configured")
        logger.warning("registry unreachable; %s materialized offline from "
                       "the pinned manifest + blob cache (%d blobs)", uri, cache_hits)
    else:
        with trace.span("dl.pull", blobs=len(selected.blobs)):
            Puller(client.remote, quiet=quiet).pull_blobs(ref.repository, selected, dest)
    admitted = 0
    if cache is not None:
        for blob in file_blobs:
            target = os.path.join(dest, blob.name)
            if not os.path.isfile(target) or os.path.isfile(cache.entry_path(blob.digest)):
                continue  # absent, or already cached (don't churn the LRU clock)
            try:
                # a unique spool per admit: concurrent loads in one
                # process must not overwrite each other's copies
                fd, tmp = tempfile.mkstemp(dir=cache.root, prefix=".pull-admit-")
                os.close(fd)
                _link_or_copy(target, tmp)
            except OSError:
                continue
            if cache.admit_file(blob.digest, tmp) is not None:
                admitted += 1
    return {
        "uri": uri,
        "dest": dest,
        "blobs": len(selected.blobs),
        "bytes": sum(b.size for b in selected.blobs),
        "program_blobs": sum(
            1 for b in selected.blobs if b.media_type == MediaTypeModelProgram
        ),
        "kv_blobs": sum(
            1 for b in selected.blobs if b.media_type == MediaTypeModelKVCache
        ),
        "cache_hits": cache_hits,
        "cache_admitted": admitted,
        "source": source,
        "offline_skipped_programs": offline_skipped_programs,
        "pull_seconds": round(time.monotonic() - t0, 3),
    }


def blob_index(blob):
    """The blob's tensor index from its annotation, or (None, None); a
    shard-spec annotation must parse, and has nothing to place on one card."""
    from modelx_tpu_torch.dl import safetensors as st

    if AnnotationShardSpec in blob.annotations:
        json.loads(blob.annotations[AnnotationShardSpec])
    if AnnotationTensorIndex in blob.annotations:
        return st.parse_index_annotation(blob.annotations[AnnotationTensorIndex])
    return None, None


def weight_blobs(manifest: Manifest) -> list:
    """The safetensors blobs a load puts on the device; program and KV
    bundles are pulled as files and not loaded."""
    return [b for b in manifest.blobs if b.name.endswith(".safetensors")
            and b.media_type not in (MediaTypeModelProgram, MediaTypeModelKVCache)]


def load_to_device(client, repository: str, manifest: Manifest, device,
                   quiet: bool = False, cache=None) -> dict:
    """Stream every safetensors blob of the manifest onto ``device``, in the
    checkpoint's dtypes. Returns {"device", "tensors", "bytes", "seconds",
    "gbps", "transfer_seconds", "transfer_gbps", "network_bytes",
    "transports", "arrays"}: ``seconds`` includes the blob cache's sha256
    passes (the re-verify of a hit, the verify of an admit) and
    ``transfer_seconds`` only the loads; ``network_bytes`` is what came
    over HTTP, ``transports`` the ladder rung each blob took."""
    from modelx_tpu_torch.dl.loader import load_safetensors

    device = torch.device(device)
    out: dict = {"device": str(device), "tensors": 0, "bytes": 0, "gbps": 0.0}
    total_bytes = network_bytes = 0
    transfer_s = 0.0
    transports: dict[str, str] = {}
    arrays: dict = {}
    t0 = time.monotonic()
    for blob in weight_blobs(manifest):
        tensors, data_offset = blob_index(blob)
        source = _blob_source(client, repository, blob, cache=cache)  # a hit re-verifies
        transports[blob.name] = source.transport
        try:
            loaded, stats = load_safetensors(source, device, tensors=tensors,
                                             data_offset=data_offset)
            transfer_s += stats.total_seconds
        finally:
            source.close()  # a teed spool is verified and admitted here
        arrays.update(loaded)
        out["tensors"] += stats.tensors
        total_bytes += stats.bytes_to_device
        if source.transport in ("url", "registry"):
            network_bytes += stats.bytes_fetched
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.monotonic() - t0
    out["bytes"] = total_bytes
    out["seconds"] = round(seconds, 3)
    out["gbps"] = round(total_bytes / max(seconds, 1e-9) / 1e9, 6)
    # the bytes' move alone, without the blob cache's sha256 passes
    out["transfer_seconds"] = round(transfer_s, 3)
    out["transfer_gbps"] = round(total_bytes / max(transfer_s, 1e-9) / 1e9, 6)
    out["network_bytes"] = network_bytes
    out["transports"] = transports
    out["arrays"] = arrays
    return out


def _blob_source(client, repository: str, blob, cache=None,
                 prefer_local: bool | None = None):
    """The best transport for a blob, rung by rung: a readable ``file``
    location (colocated registry / shared volume; preads cost no round
    trips), then the local blob cache (a digest-verified copy, zero network
    reads), then the presigned URL, then the registry's blob endpoint; the
    last two tee into the cache for the next deploy. ``transport`` on the
    source names the rung: "file", "cache", "url" or "registry".

    ``prefer_local=False`` (or env MODELX_DL_NO_LOCAL_REDIRECT=1) skips the
    colocated-file redirect: a remote pod against a colocated registry."""
    from modelx_tpu_torch.client.extension import LocationUnreachable, usable_file_path
    from modelx_tpu_torch.dl.loader import HTTPSource, LocalFileSource

    if prefer_local is None:
        prefer_local = os.environ.get("MODELX_DL_NO_LOCAL_REDIRECT", "") not in ("1", "true")
    location = client.remote.get_blob_location(repository, blob, BlobLocationPurposeDownload)
    if prefer_local and location is not None and location.provider == "file":
        try:
            src = LocalFileSource(usable_file_path(location, blob.size or -1))
        except LocationUnreachable:
            pass  # advertised for a colocated client; we're not one
        else:
            src.transport = "file"
            return src
    if cache is not None and blob.digest:
        hit = cache.lookup(blob.digest, expected_size=blob.size or -1)
        if hit is not None:
            try:
                src = LocalFileSource(hit)
            except OSError:
                # a concurrent admit's LRU eviction can unlink the entry
                # between lookup and open: fall through to the network
                pass
            else:
                src.transport = "cache"
                src.cache_state = "warm"
                return src
    if location is not None and location.properties.get("url"):
        src = HTTPSource(location.properties["url"])
        transport = "url"
    else:
        headers = {}
        if client.remote.authorization:
            headers["Authorization"] = client.remote.authorization
        url = f"{client.remote.registry}/{repository}/blobs/{blob.digest}"
        src = HTTPSource(url, headers=headers)
        transport = "registry"
    if cache is not None and blob.digest:
        src = cache.wrap(src, blob.digest, blob.size or 0)
    src.transport = transport
    return src
