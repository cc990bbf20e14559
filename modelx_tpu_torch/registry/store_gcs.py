"""GCS signed-URL layer, load separation over Google Cloud Storage
(counterpart of ``modelx_tpu/registry/store_gcs.py``). It subclasses the
S3 store, whose commit-point verification, download locations and index
handling hold over GCS's S3-compatible XML surface; what differs is the
signature spelling and the upload: a signed resumable-initiation URL
(POST + ``x-goog-resumable: start`` -> a session URI -> unauthenticated
PUTs) serves every blob size. ``modelxd-torch --gcs-url ...`` selects it
as ``--s3-url`` selects the S3 store.
"""

from __future__ import annotations

from modelx_tpu_torch.registry.fs_gcs import GCSFSProvider, GCSOptions
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.registry.store_s3 import S3RegistryStore
from modelx_tpu_torch.types import BlobLocation, BlobLocationPurposeUpload


class GCSRegistryStore(S3RegistryStore):
    provider = "gcs"

    def __init__(self, opts, refresh_on_init: bool = True, enable_redirect: bool = True) -> None:
        if not isinstance(opts, GCSOptions):
            enable_redirect = bool(getattr(opts, "enable_redirect", True))
            opts = GCSOptions(
                url=opts.gcs_url,
                access_key=opts.gcs_access_key,
                secret_key=opts.gcs_secret_key,
                bucket=opts.gcs_bucket,
                region=getattr(opts, "gcs_region", "auto") or "auto",
                presign_expire_s=getattr(opts, "s3_presign_expire_s", 3600),
            )
        self.enable_redirect = enable_redirect
        self.gcs = GCSFSProvider(opts)
        self.s3 = self.gcs  # the inherited S3 code paths address self.s3
        self.client = self.gcs.client
        # skip S3RegistryStore.__init__ (it would build an S3 provider)
        FSRegistryStore.__init__(self, self.gcs, refresh_on_init=refresh_on_init)

    def get_blob_location(
        self, repository: str, digest: str, purpose: str, properties: dict[str, str]
    ) -> BlobLocation | None:
        if purpose == BlobLocationPurposeUpload and self.enable_redirect:
            key = self._blob_key(repository, digest)
            # resumable-session issue = upload start (crash-safe GC marker,
            # same contract as the S3 presign path)
            self.mark_upload(repository, digest)
            return BlobLocation(
                provider=self.provider,
                purpose=purpose,
                properties={
                    # the client POSTs this with x-goog-resumable: start
                    # (signed) and streams the body to the session URI
                    "resumableUrl": self.client.presign_resumable_start(key),
                    "size": int(properties.get("size", 0) or 0),
                },
            )
        return super().get_blob_location(repository, digest, purpose, properties)
