"""Client facade (counterpart of ``modelx_tpu/client/client.py``, pull side)."""

from __future__ import annotations

from modelx_tpu_torch import errors
from modelx_tpu_torch.client.pull import Puller
from modelx_tpu_torch.client.remote import RegistryClient, set_insecure
from modelx_tpu_torch.types import Manifest
from modelx_tpu_torch.utils.retry import retriable_status


class Client:
    def __init__(self, registry: str, authorization: str = "", quiet: bool = False,
                 insecure: bool | None = None):
        """``insecure=True`` disables TLS verification process-wide, as the
        JAX client's does: presigned transfers go through transports a
        per-client toggle cannot reach."""
        if insecure:
            set_insecure(True)
        self.remote = RegistryClient(registry, authorization, insecure=insecure)
        self.quiet = quiet

    def pull(self, repository: str, version: str, directory: str) -> Manifest:
        return Puller(self.remote, quiet=self.quiet).pull(repository, version, directory)

    def get_manifest(self, repository: str, version: str = "") -> Manifest:
        return self.remote.get_manifest(repository, version)

    def get_config_content(self, repository: str, version: str = "") -> bytes:
        """The config blob (modelx.yaml) of a version. It rides in the
        pinned-manifest cache entry: a fetch persists it, and when the
        registry is unreachable the cached copy serves the call."""
        from modelx_tpu_torch.dl import manifest_cache

        manifest = self.remote.get_manifest(repository, version)
        if not manifest.config.digest:
            return b""
        cache = manifest_cache.default_cache()
        ver = version or "latest"
        try:
            data = b"".join(
                self.remote.get_blob_content(repository, manifest.config.digest))
        except (errors.ErrorInfo, OSError) as e:
            # OSError covers mid-body failures (truncation, reset)
            if isinstance(e, errors.ErrorInfo) and not retriable_status(e.http_status):
                raise
            cached = (cache.lookup_config(self.remote.registry, repository, ver)
                      if cache else None)
            if cached is None:
                raise
            manifest_cache.health().note_offline_serve()
            return cached
        if cache is not None:
            cache.put(self.remote.registry, repository, ver, manifest,
                      config_yaml=data)
        return data
