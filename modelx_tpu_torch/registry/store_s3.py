"""S3 presign layer, the load-separation store (counterpart of
``modelx_tpu/registry/store_s3.py``). It wraps the FS store over an S3
FSProvider and adds ``get_blob_location``, so the bulk blob bytes flow
between client and bucket while the registry only coordinates:

- upload: a presigned PUT for small blobs; presigned multipart above
  ``MULTIPART_THRESHOLD`` (an uploadId created, or reused so an interrupted
  push resumes, and one presigned URL per part of ``plan_parts``);
- the manifest PUT is the commit: pending multipart uploads are completed
  (``ListParts`` and a size check) and single-part blobs size-verified; a
  mismatch deletes the bad blob unless a committed manifest references it,
  and every problem of the manifest comes back in one structured 400;
- download: one presigned GET, which clients read with parallel ranged
  GETs.

Part count and sizes travel in the location's properties, so client and
server ranges always agree.
"""

from __future__ import annotations

from modelx_tpu_torch import errors
from modelx_tpu_torch.registry.fs import FSNotFound
from modelx_tpu_torch.registry.fs_s3 import S3FSProvider, S3Options
from modelx_tpu_torch.registry.store import blob_digest_path
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.types import (
    BlobLocation,
    BlobLocationPurposeDownload,
    BlobLocationPurposeUpload,
    Manifest,
)

MULTIPART_THRESHOLD = 64 * 1024 * 1024  # many ~64 MiB parts keep the pipe full
TARGET_PART_SIZE = 64 * 1024 * 1024
MIN_PART_SIZE = 5 * 1024 * 1024  # S3 hard minimum (except last part)
MAX_PARTS = 10_000  # S3 hard maximum


def plan_parts(size: int, target_part_size: int | None = None, min_part_size: int | None = None) -> list[tuple[int, int]]:
    """Split ``size`` bytes into (offset, length) parts.

    The server-side source of truth for part ranges: the client receives
    the same plan in the location's properties, so the two can't disagree.
    """
    if size <= 0:
        return [(0, 0)]
    if target_part_size is None:
        target_part_size = TARGET_PART_SIZE
    if min_part_size is None:
        min_part_size = MIN_PART_SIZE
    part = max(target_part_size, min_part_size)
    while size / part > MAX_PARTS:
        part *= 2
    out = []
    off = 0
    while off < size:
        n = min(part, size - off)
        out.append((off, n))
        off += n
    return out


class S3RegistryStore(FSRegistryStore):
    """FSRegistryStore + presign. Accepts either a
    registry ``Options`` (server bootstrap) or an ``S3Options``."""

    provider = "s3"  # BlobLocation provider name (store_gcs subclasses)

    def __init__(self, opts, refresh_on_init: bool = True, enable_redirect: bool = True) -> None:
        if not isinstance(opts, S3Options):
            enable_redirect = bool(getattr(opts, "enable_redirect", True))
            opts = S3Options(
                url=opts.s3_url,
                access_key=opts.s3_access_key,
                secret_key=opts.s3_secret_key,
                bucket=opts.s3_bucket,
                region=opts.s3_region,
                presign_expire_s=getattr(opts, "s3_presign_expire_s", 3600),
            )
        self.enable_redirect = enable_redirect
        self.s3 = S3FSProvider(opts)
        self.client = self.s3.client
        super().__init__(self.s3, refresh_on_init=refresh_on_init)

    # -- load separation ------------------------------------------------------

    def _blob_key(self, repository: str, digest: str) -> str:
        return self.s3.prefix + blob_digest_path(repository, digest)

    def get_blob_location(
        self, repository: str, digest: str, purpose: str, properties: dict[str, str]
    ) -> BlobLocation | None:
        """Returns None (the client falls back to moving the bytes through
        the registry) unless redirect is enabled."""
        if not self.enable_redirect:
            return None
        key = self._blob_key(repository, digest)
        size = int(properties.get("size", 0) or 0)
        content_type = properties.get("mediaType", "") or "application/octet-stream"
        if purpose == BlobLocationPurposeUpload:
            # presign issue = upload start: mark so GC never reclaims a
            # digest mid-transfer, however long the client takes
            self.mark_upload(repository, digest)
            if size > MULTIPART_THRESHOLD:
                return self._upload_location_multipart(key, size, content_type)
            return BlobLocation(
                provider=self.provider,
                purpose=purpose,
                properties={"url": self.client.presign("PUT", key)},
            )
        if purpose == BlobLocationPurposeDownload:
            # single presigned GET; client parallelizes with ranged GETs
            try:
                head = self.client.head_object(key)
                total = int(head.get("Content-Length", 0) or 0)
            except FSNotFound:
                raise errors.blob_unknown(digest) from None
            return BlobLocation(
                provider=self.provider,
                purpose=purpose,
                properties={"url": self.client.presign("GET", key), "size": total},
            )
        raise errors.ErrorInfo(400, errors.ErrCodeUnknown, f"unknown purpose: {purpose}")

    def _upload_location_multipart(self, key: str, size: int, content_type: str) -> BlobLocation:
        """Create or *reuse* an in-progress uploadId so
        an interrupted push resumes instead of restarting."""
        uploads = self.client.list_multipart_uploads(key)
        upload_id = uploads.get(key) or self.client.create_multipart_upload(key, content_type)
        done_parts = {n for n, _etag, _size in self.client.list_parts(key, upload_id)}
        parts = []
        for i, (offset, length) in enumerate(plan_parts(size), start=1):
            parts.append(
                {
                    "partNumber": i,
                    "offset": offset,
                    "length": length,
                    "done": i in done_parts,
                    "url": self.client.presign(
                        "PUT", key, query={"partNumber": str(i), "uploadId": upload_id}
                    ),
                }
            )
        return BlobLocation(
            provider=self.provider,
            purpose=BlobLocationPurposeUpload,
            properties={"uploadId": upload_id, "size": size, "parts": parts},
        )

    # -- manifest PUT = commit point ------------------------------------------

    def put_manifest(
        self, repository: str, reference: str, content_type: str, manifest: Manifest
    ) -> None:
        """Before committing, finish multipart uploads and
        verify blob sizes; a size mismatch quarantine-deletes the bad blob and
        fails. A blob already referenced by a committed
        manifest is never deleted — otherwise one bad descriptor from any
        client with push rights could destroy blobs other versions depend on.
        Problems are COLLECTED over the whole manifest (not first-fail) and
        raised as one structured 400, so a single round trip tells the client
        the exact re-push delta. This loop IS the commit verification for
        object stores — it commits via ``_commit_manifest`` directly so the
        FS layer's ``_verify_commit`` doesn't re-HEAD every blob."""
        self._mark_referenced(repository, manifest)
        in_use: set[str] | None = None
        missing: list[str] = []
        mismatched: list[dict] = []
        for desc in manifest.all_descriptors():
            if not desc.digest:
                continue
            key = self._blob_key(repository, desc.digest)
            uploads = self.client.list_multipart_uploads(key)
            if key in uploads:
                self._complete_multipart(key, uploads[key], desc.size, desc.digest)
                continue
            try:
                head = self.client.head_object(key)
            except FSNotFound:
                missing.append(str(desc.digest))
                continue
            actual = int(head.get("Content-Length", 0) or 0)
            if desc.size and actual != desc.size:
                if in_use is None:
                    in_use = self._referenced_digests(repository)
                if desc.digest not in in_use:
                    self.client.delete_object(key)  # the bad upload goes
                mismatched.append(
                    {"digest": str(desc.digest), "expected": desc.size, "stored": actual}
                )
        if missing or mismatched:
            raise errors.commit_invalid(missing, mismatched)
        self._commit_manifest(repository, reference, content_type, manifest)

    def _referenced_digests(self, repository: str) -> set[str]:
        """Digests referenced by any committed manifest of the repository."""
        out: set[str] = set()
        try:
            idx = self.get_index(repository)
        except errors.ErrorInfo:
            return out
        for entry in idx.manifests:
            try:
                m = self.get_manifest(repository, entry.name)
            except errors.ErrorInfo:
                continue
            out.update(d.digest for d in m.all_descriptors() if d.digest)
        return out

    def _complete_multipart(self, key: str, upload_id: str, expected_size: int, digest: str) -> None:
        """Complete one multipart upload after checking its parts' total."""
        parts = self.client.list_parts(key, upload_id)
        total = sum(size for _n, _etag, size in parts)
        if expected_size and total != expected_size:
            self.client.abort_multipart_upload(key, upload_id)
            raise errors.size_invalid(
                f"blob {digest}: multipart parts total {total}, expected {expected_size}"
            )
        self.client.complete_multipart_upload(key, upload_id, [(n, etag) for n, etag, _ in parts])
