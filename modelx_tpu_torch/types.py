"""Core data model: Index / Manifest / Descriptor / BlobLocation.

Counterpart of ``modelx_tpu/types.py`` (the reference keeps these types
free of jax; the port keeps its own copy, as it keeps nothing of that
package). The schema is wire-compatible with the modelx registry: same JSON
keys, same media types, and ``canonical_json`` gives the JAX package's
bytes for the same manifest or index. The annotations the JAX package
writes ride along unchanged:

- ``modelx.shard.mesh``   (manifest annotation): device-mesh spec, e.g.
  ``"dp=2,tp=4"``; one card has no mesh, so the port reads it as a hint only;
- ``modelx.shard.spec``   (blob annotation): JSON map tensor-name ->
  PartitionSpec; parsed and ignored on one card;
- ``modelx.tensor.index`` (blob annotation): JSON map tensor-name ->
  {dtype, shape, data_offsets}, a mirror of the safetensors header so the
  loader plans its ranged reads without fetching the header first.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, BinaryIO, Iterator

# --- media types -------------------------------------------------------------

MediaTypeModelIndexJson = "application/vnd.modelx.model.index.v1.json"
MediaTypeModelManifestJson = "application/vnd.modelx.model.manifest.v1.json"
MediaTypeModelConfigYaml = "application/vnd.modelx.model.config.v1.yaml"
MediaTypeModelFile = "application/vnd.modelx.model.file.v1"
MediaTypeModelDirectoryTarGz = "application/vnd.modelx.model.directory.v1.tar+gzip"
# derived bundles attached to a model version (compiled programs, prefix-KV
# entries; dl/program_store.py, dl/kv_store.py): pulled as files next to the
# weights and installed at load, never loaded as weights
MediaTypeModelProgram = "application/vnd.modelx.program.v1"
MediaTypeModelKVCache = "application/vnd.modelx.kvcache.v1"

# --- annotation keys (see module docstring) ---------------------------------

AnnotationShardSpec = "modelx.shard.spec"
AnnotationTensorIndex = "modelx.tensor.index"
# program-bundle environment stamp (dl/program_store.py): lets a puller pick
# the matching bundle from the manifest alone; the install re-verifies
# against the bundle's own meta.json regardless. The keys are the JAX
# package's; the port writes its torch version where it writes the jax one
AnnotationProgramJax = "modelx.program.jax"
AnnotationProgramBackend = "modelx.program.backend"
AnnotationProgramCode = "modelx.program.code"
AnnotationProgramCount = "modelx.program.artifacts"
AnnotationProgramMesh = "modelx.program.mesh"
# kv-bundle stamp (dl/kv_store.py): code and mesh as for programs, the
# weight content key, the prefix length and its hash: enough for a puller
# to match a missed prompt against the manifest without fetching a blob
AnnotationKVCode = "modelx.kv.code"
AnnotationKVMesh = "modelx.kv.mesh"
AnnotationKVModel = "modelx.kv.model"
AnnotationKVTokens = "modelx.kv.tokens"
AnnotationKVPrefix = "modelx.kv.prefix"

# --- blob location purposes -------------------------------------------------

BlobLocationPurposeDownload = "download"


# --- digest ------------------------------------------------------------------

_DIGEST_RE = re.compile(r"^[a-z0-9]+(?:[.+_-][a-z0-9]+)*:[0-9a-f]{32,}$")


class Digest(str):
    """A content digest in ``algorithm:hex`` form (go-digest compatible).

    Subclasses ``str`` so digests serialize/compare as plain strings, matching
    the reference's `digest.Digest` (an alias of string).
    """

    __slots__ = ()

    @property
    def algorithm(self) -> str:
        return self.partition(":")[0]

    @property
    def hex(self) -> str:
        return self.partition(":")[2]

    def validate(self) -> None:
        if not _DIGEST_RE.match(self):
            raise ValueError(f"invalid digest: {self!r}")

    @classmethod
    def from_bytes(cls, data: bytes) -> "Digest":
        return cls("sha256:" + hashlib.sha256(data).hexdigest())

    @classmethod
    def from_reader(cls, reader: BinaryIO, chunk_size: int = 4 * 1024 * 1024) -> "Digest":
        """Streaming sha256 (reference: pkg/client/push.go:149-161)."""
        h = hashlib.sha256()
        while chunk := reader.read(chunk_size):
            h.update(chunk)
        return cls("sha256:" + h.hexdigest())

    @classmethod
    def from_file(cls, path: str, chunk_size: int = 4 * 1024 * 1024) -> "Digest":
        with open(path, "rb") as f:
            return cls.from_reader(f, chunk_size)


def _drop_empty(d: dict[str, Any]) -> dict[str, Any]:
    """omitempty semantics: drop None / '' / 0 / {} / [] like Go's json tags."""
    return {k: v for k, v in d.items() if v not in (None, "", 0, {}, [])}


# --- descriptors -------------------------------------------------------------


@dataclasses.dataclass
class Descriptor:
    """types.go:28-37. Describes one blob (or manifest, inside an Index)."""

    name: str = ""
    media_type: str = ""
    digest: str = ""
    size: int = 0
    mode: int = 0  # unix file mode bits (reference stores os.FileMode)
    urls: list[str] = dataclasses.field(default_factory=list)
    modified: str = ""  # RFC3339 timestamp; empty == omitted
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"name": self.name}
        out.update(
            _drop_empty(
                {
                    "mediaType": self.media_type,
                    "digest": self.digest,
                    "size": self.size,
                    "mode": self.mode,
                    "urls": self.urls,
                    "modified": self.modified,
                    "annotations": self.annotations,
                }
            )
        )
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Descriptor":
        if not isinstance(d, dict):
            raise ValueError(f"descriptor must be an object, got {type(d).__name__}")
        return cls(
            name=d.get("name", ""),
            media_type=d.get("mediaType", ""),
            digest=d.get("digest", ""),
            size=int(d.get("size", 0) or 0),
            mode=int(d.get("mode", 0) or 0),
            urls=list(d.get("urls", []) or []),
            modified=d.get("modified", "") or "",
            annotations=dict(d.get("annotations", {}) or {}),
        )


@dataclasses.dataclass
class Index:
    """types.go:53-58. Per-repo index (manifests = versions) or the global
    index (manifests = repositories)."""

    schema_version: int = 1
    media_type: str = MediaTypeModelIndexJson
    manifests: list[Descriptor] = dataclasses.field(default_factory=list)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"schemaVersion": self.schema_version}
        out.update(_drop_empty({"mediaType": self.media_type}))
        out["manifests"] = [m.to_json() for m in self.manifests]
        out.update(_drop_empty({"annotations": self.annotations}))
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Index":
        return cls(
            schema_version=int(d.get("schemaVersion", 1) or 1),
            media_type=d.get("mediaType", "") or "",
            manifests=[Descriptor.from_json(m) for m in d.get("manifests", []) or []],
            annotations=dict(d.get("annotations", {}) or {}),
        )

    def encode(self) -> bytes:
        return canonical_json(self.to_json())

    @classmethod
    def decode(cls, data: bytes) -> "Index":
        return cls.from_json(json.loads(data))


@dataclasses.dataclass
class Manifest:
    """types.go:60-66. One model version: config descriptor + blob list."""

    schema_version: int = 1
    media_type: str = MediaTypeModelManifestJson
    config: Descriptor = dataclasses.field(default_factory=Descriptor)
    blobs: list[Descriptor] = dataclasses.field(default_factory=list)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"schemaVersion": self.schema_version}
        out.update(_drop_empty({"mediaType": self.media_type}))
        out["config"] = self.config.to_json()
        out["blobs"] = [b.to_json() for b in self.blobs]
        out.update(_drop_empty({"annotations": self.annotations}))
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Manifest":
        if not isinstance(d, dict):
            raise ValueError(f"manifest must be an object, got {type(d).__name__}")
        config = d.get("config")
        if config is None:
            config = {}
        blobs = d.get("blobs")
        if blobs is None:
            blobs = []
        if not isinstance(blobs, list):
            raise ValueError("manifest blobs must be a list")
        return cls(
            schema_version=int(d.get("schemaVersion", 1) or 1),
            media_type=d.get("mediaType", "") or "",
            config=Descriptor.from_json(config),
            blobs=[Descriptor.from_json(b) for b in blobs],
            annotations=dict(d.get("annotations", {}) or {}),
        )

    def encode(self) -> bytes:
        return canonical_json(self.to_json())

    @classmethod
    def decode(cls, data: bytes) -> "Manifest":
        return cls.from_json(json.loads(data))

    def all_descriptors(self) -> Iterator[Descriptor]:
        if self.config.name or self.config.digest:
            yield self.config
        yield from self.blobs


@dataclasses.dataclass
class BlobLocation:
    """types.go:20-26. Tells the client *where/how* to move blob bytes:
    provider selects a client-side extension (e.g. ``s3``), properties carry
    presigned URLs etc. The pluggable-protocol seam of the whole design."""

    provider: str = ""
    purpose: str = ""
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return _drop_empty(
            {"provider": self.provider, "purpose": self.purpose, "properties": self.properties}
        )

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "BlobLocation":
        return cls(
            provider=d.get("provider", "") or "",
            purpose=d.get("purpose", "") or "",
            properties=dict(d.get("properties", {}) or {}),
        )


def canonical_json(obj: Any) -> bytes:
    """Deterministic JSON encoding (sorted keys, no whitespace).

    The reference relies on Go's deterministic struct-order marshaling for
    stable index/manifest bytes; we get determinism via sorted keys instead.
    """
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def sort_descriptors(descs: list[Descriptor]) -> list[Descriptor]:
    """types.go:49-51 SortDescriptorName."""
    return sorted(descs, key=lambda d: d.name)
