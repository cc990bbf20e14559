"""RegistryStore interface + the on-storage path scheme (counterpart of
``modelx_tpu/registry/store.py``). Layout:

    index.json                          global index (repositories)
    {repo}/index.json                   per-repo index (versions)
    {repo}/manifests/{reference}        manifest JSON
    {repo}/blobs/{algorithm}/{hex}      blob bytes (content-addressed)
    {repo}/uploads/{algorithm}/{hex}    in-flight upload markers
    {repo}/quarantine/{algorithm}/{hex} corrupt blobs a scrub moved aside
"""

from __future__ import annotations

import dataclasses
import posixpath
from typing import BinaryIO, Protocol, runtime_checkable

from modelx_tpu_torch.types import BlobLocation, Index, Manifest

REGISTRY_INDEX_FILENAME = "index.json"


class StoreNotFound(KeyError):
    """A store object that does not exist."""


@dataclasses.dataclass
class BlobContent:
    content: BinaryIO
    content_length: int
    content_type: str = ""


@dataclasses.dataclass
class BlobMeta:
    content_type: str
    content_length: int
    last_modified: float = 0.0


@runtime_checkable
class RegistryStore(Protocol):
    """The store contract the HTTP handlers call."""

    def get_global_index(self, search: str = "") -> Index: ...

    def get_index(self, repository: str, search: str = "") -> Index: ...

    def remove_index(self, repository: str) -> None: ...

    def exists_manifest(self, repository: str, reference: str) -> bool: ...

    def get_manifest(self, repository: str, reference: str) -> Manifest: ...

    def put_manifest(
        self, repository: str, reference: str, content_type: str, manifest: Manifest
    ) -> None: ...

    def delete_manifest(self, repository: str, reference: str) -> None: ...

    def get_blob(self, repository: str, digest: str, offset: int = 0, length: int = -1) -> BlobContent: ...

    def put_blob(self, repository: str, digest: str, content: BlobContent) -> None: ...

    def list_blobs(self, repository: str) -> list[str]: ...

    def exists_blob(self, repository: str, digest: str) -> bool: ...

    def delete_blob(self, repository: str, digest: str) -> None: ...

    def get_blob_meta(self, repository: str, digest: str) -> BlobMeta: ...

    def get_blob_location(
        self, repository: str, digest: str, purpose: str, properties: dict[str, str]
    ) -> BlobLocation | None: ...


def blob_digest_path(repository: str, digest: str) -> str:
    algo, _, hexpart = digest.partition(":")
    return posixpath.join(repository, "blobs", algo, hexpart)


def index_path(repository: str) -> str:
    return posixpath.join(repository, REGISTRY_INDEX_FILENAME)


def manifest_path(repository: str, reference: str) -> str:
    return posixpath.join(repository, "manifests", reference)


def upload_marker_path(repository: str, digest: str) -> str:
    """In-flight upload marker: touched when a blob PUT starts (or a
    presigned upload location is issued), cleared at manifest commit. GC
    treats marked digests as active pushes regardless of blob mtime."""
    algo, _, hexpart = digest.partition(":")
    return posixpath.join(repository, "uploads", algo, hexpart)


def quarantine_path(repository: str, digest: str) -> str:
    """Where the scrubber parks corrupt blob bytes: outside ``blobs/``, so
    the digest 404s (and becomes re-pushable) while the evidence stays
    inspectable."""
    algo, _, hexpart = digest.partition(":")
    return posixpath.join(repository, "quarantine", algo, hexpart)
