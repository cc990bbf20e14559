"""Google Cloud Storage FSProvider (counterpart of
``modelx_tpu/registry/fs_gcs.py``). GCS's XML API speaks the S3 REST
surface (object CRUD, Range, ListObjectsV2) under HMAC keys; only the V4
signature's spelling differs (GOOG4-HMAC-SHA256, ``X-Goog-*`` parameters,
the ``storage`` service, ``goog4_request``; ``sigv4.GOOG_SIG``). So the
provider subclasses the S3 client and provider and swaps the signature
spec, and adds one GCS-shaped call: presigning a resumable upload's
initiation (a signed POST carrying ``x-goog-resumable: start``), GCS's
answer to S3 multipart.
"""

from __future__ import annotations

import dataclasses

from modelx_tpu_torch.registry import sigv4
from modelx_tpu_torch.registry.fs_s3 import (
    DEFAULT_KEY_PREFIX,
    PRESIGN_EXPIRE_S,
    S3Client,
    S3FSProvider,
    S3Options,
)


@dataclasses.dataclass
class GCSOptions:
    """Mirror of S3Options with GCS defaults. ``url`` stays explicit (the
    fake-GCS tests and private endpoints need it); production points it at
    https://storage.googleapis.com. ``access_key``/``secret_key`` are GCS
    HMAC keys (interoperability credentials)."""

    url: str
    access_key: str
    secret_key: str
    bucket: str = "registry"
    region: str = "auto"  # GCS V4 scope region for HMAC signing
    key_prefix: str = DEFAULT_KEY_PREFIX
    presign_expire_s: int = PRESIGN_EXPIRE_S

    def as_s3(self) -> S3Options:
        return S3Options(
            url=self.url, access_key=self.access_key, secret_key=self.secret_key,
            bucket=self.bucket, region=self.region, key_prefix=self.key_prefix,
            presign_expire_s=self.presign_expire_s,
        )


class GCSClient(S3Client):
    sig_spec = sigv4.GOOG_SIG
    service = "storage"

    def presign_resumable_start(self, key: str, expires_s: int | None = None) -> str:
        """Signed URL initiating a resumable upload: the client POSTs it
        with ``x-goog-resumable: start`` (signed — a URL thief can't turn
        it into a plain overwrite) and receives the upload session URI in
        the Location header; session PUTs need no further auth."""
        return self.presign(
            "POST", key, expires_s=expires_s,
            signed_headers={"x-goog-resumable": "start"},
        )


class GCSFSProvider(S3FSProvider):
    """FSProvider over GCS: registry metadata (indexes, manifests) and
    server-side blob writes ride the same code paths as S3 — only the
    signature spelling differs."""

    def __init__(self, opts: GCSOptions) -> None:
        self.opts = opts.as_s3()
        self.client = GCSClient(self.opts)
        self.prefix = self.opts.key_prefix
