"""Push engine: directory -> manifest -> blobs -> manifest PUT (the commit).
Counterpart of ``modelx_tpu/client/push.py``, with the same semantics:

- the directory walk builds the manifest: ``modelx.yaml`` becomes the
  config descriptor, directories become deterministic tar.gz blobs, files
  become file blobs, dotfiles and empty files are skipped;
- per blob: the digest (the native engine's GIL-free sha256 when built),
  a HEAD dedup skip, then the upload through the server's ``BlobLocation``
  and the provider's extension (presigned S3 multipart, GCS resumable), or
  the direct PUT through the registry when the store has no location;
- the manifest PUT last is the commit; a commit the server refuses with
  the missing or mismatched digests re-pushes just those and retries.

Safetensors blobs carry their tensor index (``modelx.tensor.index``) and
the family's shard layout (``modelx.shard.spec``), and a ``modelx.yaml``
that pins ``serving.mesh`` stamps ``modelx.shard.mesh``: a manifest built
here is byte-identical to the JAX package's for the same directory, so the
same checkpoint pushed by either package gets one manifest digest.
"""

from __future__ import annotations

import json
import os
from typing import Callable

from modelx_tpu_torch import errors
from modelx_tpu_torch.client import helper
from modelx_tpu_torch.client.extension import get_extension
from modelx_tpu_torch.client.progress import PULL_PUSH_CONCURRENCY, NullBar, run_jobs
from modelx_tpu_torch.client.remote import RegistryClient
from modelx_tpu_torch.types import (
    AnnotationShardMesh,
    AnnotationShardSpec,
    AnnotationTensorIndex,
    BlobLocationPurposeUpload,
    Descriptor,
    Manifest,
    MediaTypeModelConfigYaml,
    MediaTypeModelFile,
)

MODEL_CONFIG_FILENAME = "modelx.yaml"
MODELX_CACHE_DIR = ".modelx"
# manifests are capped at 1 MiB server-side: a larger tensor index is
# left out rather than break the push
TENSOR_INDEX_CAP = 256 * 1024


def parse_manifest_from_dir(directory: str, cache_dir: str | None = None):
    """Walk the directory into a manifest. Returns (manifest, tgz_paths),
    tgz_paths mapping a directory blob's digest to its packed archive in
    the cache."""
    cache = cache_dir or os.path.join(directory, MODELX_CACHE_DIR)
    config = None
    blobs: list[Descriptor] = []
    tgz_paths: dict[str, str] = {}
    for entry in sorted(os.scandir(directory), key=lambda e: e.name):
        if entry.name.startswith("."):
            continue  # dotfiles and the .modelx cache
        if entry.is_dir():
            dest = os.path.join(cache, entry.name + ".tar.gz")
            desc = helper.tgz(entry.path, dest)
            tgz_paths[desc.digest] = dest
            blobs.append(desc)
        elif entry.is_file():
            if entry.stat().st_size == 0:
                continue
            if entry.name == MODEL_CONFIG_FILENAME:
                config = helper.descriptor_for_file(entry.path, entry.name, MediaTypeModelConfigYaml)
            else:
                desc = helper.descriptor_for_file(entry.path, entry.name, MediaTypeModelFile)
                _annotate_safetensors(entry.path, desc)
                blobs.append(desc)
    manifest = Manifest(config=config or Descriptor(), blobs=blobs)
    _annotate_mesh(directory, manifest)
    return manifest, tgz_paths


def _annotate_mesh(directory: str, manifest: Manifest) -> None:
    """Stamp the manifest with the checkpoint's pinned serving mesh
    (``modelx.yaml`` serving.mesh), when one exists."""
    path = os.path.join(directory, MODEL_CONFIG_FILENAME)
    if not os.path.isfile(path):
        return
    try:
        from modelx_tpu_torch.client.model_config import ModelConfig

        config = ModelConfig.load(path)
    except Exception:
        return  # an invalid sidecar fails later with a real diagnostic
    if config.serving.mesh:
        manifest.annotations[AnnotationShardMesh] = config.serving.mesh


def _annotate_safetensors(path: str, desc: Descriptor) -> None:
    """Attach the safetensors tensor index and the family's shard-layout
    rules as annotations, so a loader plans its ranged reads from the
    manifest alone."""
    if not path.endswith(".safetensors"):
        return
    try:
        from modelx_tpu_torch.dl.safetensors import read_header_from_file

        header, data_offset = read_header_from_file(path)
    except Exception:
        return
    index = {
        name: {"dtype": t.dtype, "shape": t.shape, "data_offsets": [t.start, t.end]}
        for name, t in header.items()
    }
    payload = json.dumps({"data_offset": data_offset, "tensors": index}, sort_keys=True)
    if len(payload) <= TENSOR_INDEX_CAP:
        desc.annotations[AnnotationTensorIndex] = payload
    # the rules are plain JSON and a few hundred bytes, so they always fit;
    # an unrecognized layout annotates nothing
    from modelx_tpu_torch.dl.sharding import encode_rules, infer_family, rules_for_family

    family = infer_family(list(header))
    if family:
        desc.annotations[AnnotationShardSpec] = encode_rules(rules_for_family(family))


class Pusher:
    # rounds of commit -> parse delta -> re-push before giving up: one
    # retry fixes the common cases (collected mid-push, a quarantined
    # stored copy), a second covers a delta racing another sweep
    COMMIT_RETRIES = 2

    def __init__(self, remote: RegistryClient, quiet: bool = False,
                 concurrency: int | None = None):
        self.remote = remote
        self.quiet = quiet
        self.concurrency = concurrency or PULL_PUSH_CONCURRENCY

    def push(self, repository: str, version: str, directory: str) -> None:
        manifest, tgz_paths = parse_manifest_from_dir(directory)

        def blob_path(desc: Descriptor) -> str:
            return tgz_paths.get(desc.digest) or os.path.join(directory, desc.name)

        def job(desc: Descriptor, force: bool = False) -> Callable[[], None]:
            def run() -> None:
                self.push_blob(repository, desc, blob_path(desc), force=force)

            return run

        jobs = [job(d) for d in manifest.blobs]
        if manifest.config.digest:
            jobs.append(job(manifest.config))
        run_jobs(jobs, self.concurrency)
        # the commit: the server verifies every referenced blob and a
        # refusal names the exact delta; re-push just that and retry
        for attempt in range(self.COMMIT_RETRIES + 1):
            try:
                self.remote.put_manifest(repository, version, manifest)
                return
            except errors.ErrorInfo as e:
                delta = commit_delta_digests(e)
                if not delta or attempt == self.COMMIT_RETRIES:
                    raise
                retriable = [d for d in manifest.all_descriptors() if d.digest in delta]
                if not retriable:
                    raise  # the server wants digests this manifest doesn't carry
                run_jobs([job(d, force=True) for d in retriable], self.concurrency)

    def push_blob(self, repository: str, desc: Descriptor, path: str,
                  force: bool = False) -> None:
        from modelx_tpu_torch.utils import trace

        with trace.span("push.blob", blob=desc.name, bytes=desc.size):
            self._push_blob(repository, desc, path, NullBar(), force=force)

    def _push_blob(self, repository: str, desc: Descriptor, path: str, bar,
                   force: bool = False) -> None:
        # ``force`` skips the dedup probe: the server just said this digest
        # is missing or mismatched, so "exists" is not to be trusted
        if not force and self.remote.head_blob(repository, desc.digest):
            bar.done("exists")
            return
        location = self.remote.get_blob_location(repository, desc, BlobLocationPurposeUpload)
        if location is not None:
            ext = get_extension(location.provider)
            with open(path, "rb") as f:
                ext.upload(location, desc, f, progress=bar)
            bar.done()
            return
        # no location: the direct PUT through the server
        with open(path, "rb") as f:
            self.remote.upload_blob_content(repository, desc, _ProgressReader(f, bar.update))
        bar.done()


def commit_delta_digests(e: errors.ErrorInfo) -> set[str]:
    """Digests the server's commit-verification 400 wants re-pushed:
    ``detail`` carries ``{"missing": [...], "sizeMismatch": [{"digest":
    ...}]}``. Empty set = not a delta-shaped error."""
    if e.http_status != 400 or not isinstance(e.detail, dict):
        return set()
    out = {d for d in e.detail.get("missing", ()) if isinstance(d, str)}
    for m in e.detail.get("sizeMismatch", ()):
        if isinstance(m, dict) and isinstance(m.get("digest"), str):
            out.add(m["digest"])
    return out


class _ProgressReader:
    """A reader that counts bytes as they are read."""

    def __init__(self, f, cb: Callable[[int], None]) -> None:
        self._f, self._cb = f, cb

    def read(self, n: int = -1) -> bytes:
        data = self._f.read(n)
        if data:
            self._cb(len(data))
        return data

    def seek(self, *a):
        return self._f.seek(*a)

    def tell(self):
        return self._f.tell()
