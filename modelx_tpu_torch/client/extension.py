"""Data-plane extensions: transfer protocols keyed by
``BlobLocation.provider`` (counterpart of ``modelx_tpu/client/extension.py``,
download side). The registry hands back a location and the client picks
the matching extension to move the bytes: ``http`` for a presigned URL,
``file`` for a path on a filesystem this client may share with the
registry. Uploads through locations (S3/GCS) come with the control-plane
slice.
"""

from __future__ import annotations

import http.client
import os
import urllib.parse
from typing import BinaryIO, Callable, Protocol

from modelx_tpu_torch import errors
from modelx_tpu_torch.types import BlobLocation, Descriptor

# provider name -> extension instance
GLOBAL_EXTENSIONS: dict[str, "Extension"] = {}


class Extension(Protocol):
    def download(
        self,
        location: BlobLocation,
        desc: Descriptor,
        writer: BinaryIO,
        progress: Callable[[int], None] | None = None,
    ) -> None: ...


def register_extension(provider: str, ext: Extension) -> None:
    GLOBAL_EXTENSIONS[provider] = ext


def get_extension(provider: str) -> Extension:
    try:
        return GLOBAL_EXTENSIONS[provider]
    except KeyError:
        raise errors.unsupported(f"no client extension for provider {provider!r}") from None


def http_download(
    url: str,
    writer: BinaryIO,
    headers: dict[str, str] | None = None,
    progress: Callable[[int], None] | None = None,
    chunk_size: int = 1024 * 1024,
) -> int:
    """Stream a (presigned) GET into ``writer``; redirects are not followed."""
    from modelx_tpu_torch.client.remote import insecure_default, ssl_context

    u = urllib.parse.urlsplit(url)
    if u.scheme == "https":
        conn = http.client.HTTPSConnection(u.hostname or "", u.port or 443, timeout=300,
                                           context=ssl_context(insecure_default()))
    else:
        conn = http.client.HTTPConnection(u.hostname or "", u.port or 80, timeout=300)
    try:
        try:
            conn.request("GET", (u.path or "/") + (f"?{u.query}" if u.query else ""),
                         headers=headers or {})
            r = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"request failed: {e}") from e
        if r.status >= 400:
            raise errors.ErrorInfo.decode(r.read(), r.status)
        n = 0
        while chunk := r.read(chunk_size):
            writer.write(chunk)
            n += len(chunk)
            if progress:
                progress(len(chunk))
        return n
    finally:
        conn.close()


class RawHTTPExtension:
    """Plain-HTTP provider: location.properties = {"url": ..., "headers": {...}}."""

    def download(self, location, desc, writer, progress=None) -> None:
        url = location.properties.get("url", "")
        http_download(url, writer, headers=location.properties.get("headers"), progress=progress)


class FileExtension:
    """``file`` provider: the registry advertised the blob's path on a
    filesystem this client can (maybe) see, a colocated store or a shared
    pod volume. Download reads the file directly, so bytes never cross the
    registry process. ``LocationUnreachable`` (an OSError) tells the pull
    engine to fall back to the direct GET."""

    def download(self, location, desc, writer, progress=None, chunk_size=4 * 1024 * 1024) -> None:
        path = usable_file_path(location, desc.size or -1)
        try:
            f = open(path, "rb")
        except OSError as e:
            raise LocationUnreachable(str(e)) from e
        with f:
            while chunk := f.read(chunk_size):
                writer.write(chunk)
                if progress:
                    progress(len(chunk))


class LocationUnreachable(OSError):
    """A blob location this client cannot use (e.g. a ``file`` path on
    another host). Callers fall back to the direct server GET."""


def usable_file_path(location: BlobLocation, expect_size: int = -1) -> str:
    """Validate a ``file`` location for this host: the path, or
    LocationUnreachable when it can't be stat'd or its size disagrees with
    the advertised blob size (a committed content-addressed blob never
    changes size)."""
    path = location.properties.get("path", "")
    want = int(location.properties.get("size", expect_size))
    try:
        st_size = os.stat(path).st_size
    except OSError as e:
        raise LocationUnreachable(str(e)) from e
    if want >= 0 and st_size != want:
        raise LocationUnreachable(f"{path}: size {st_size} != advertised {want}")
    return path


register_extension("http", RawHTTPExtension())
register_extension("file", FileExtension())
