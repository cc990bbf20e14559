"""Data-plane extensions: transfer protocols keyed by
``BlobLocation.provider`` (counterpart of ``modelx_tpu/client/extension.py``).
The registry hands back a location and the client picks the matching
extension to move the bytes straight between itself and the storage, so
they never pass through the registry ("load separation"): ``http`` for a
presigned URL, ``file`` for a path on a filesystem this client may share
with the registry, ``s3`` and ``gcs`` (``extension_s3.py``,
``extension_gcs.py``) for object stores.

The transfers run on ``http.client`` where the JAX package uses
``requests``: kept-alive connections pooled per origin, a PUT body
streamed from a file under its exact ``Content-Length``, and no header a
presigned URL did not sign beyond ``Host`` and ``Content-Length`` (no
``Accept-Encoding``, no ``User-Agent``), all through
``remote.send_request``. An error body is decoded as the
registry's JSON or an object store's XML ``<Error>``. Redirects are not
followed.
"""

from __future__ import annotations

import http.client
import os
import re
import threading
import time
import urllib.parse
from typing import BinaryIO, Callable, Protocol

from modelx_tpu_torch import errors
from modelx_tpu_torch.client.remote import (
    ConnectionPool, Response, body_size, insecure_default, send_request,
)
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

    def upload(
        self,
        location: BlobLocation,
        desc: Descriptor,
        reader: BinaryIO,
        progress: Callable[[int], None] | None = None,
    ) -> None: ...


def register_extension(provider: str, ext: Extension) -> None:
    GLOBAL_EXTENSIONS[provider] = ext


def get_extension(provider: str) -> Extension:
    try:
        return GLOBAL_EXTENSIONS[provider]
    except KeyError:
        raise errors.unsupported(f"no client extension for provider {provider!r}") from None


# -- HTTP transfer primitives -------------------------------------------------

TIMEOUT_S = 300
# origin and TLS choice -> its kept-alive connections
_pools: dict[tuple[str, bool], ConnectionPool] = {}
_pools_lock = threading.Lock()


def _pool(url: str) -> ConnectionPool:
    u = urllib.parse.urlsplit(url)
    key = (f"{u.scheme}://{u.netloc}", insecure_default())
    with _pools_lock:
        pool = _pools.get(key)
        if pool is None:
            pool = _pools[key] = ConnectionPool(key[0], (10, TIMEOUT_S), key[1])
        return pool


def http_request(method: str, url: str, data=None, headers: dict[str, str] | None = None,
                 stream: bool = False) -> Response:
    """One request on a kept-alive connection to ``url``'s origin
    (``remote.send_request``). The body is read whole (``content``) unless
    ``stream``; a streamed response read to its end gives its connection
    back, ``close`` drops it. Transport failures raise OSError or
    ``http.client.HTTPException``."""
    resp = send_request(_pool(url), method, url, headers or {}, data)
    if not stream:
        resp.content
    return resp


_XML_FIELD = re.compile(rb"<(Code|Message)>([^<]*)</\1>")


def decode_error(body: bytes, status: int) -> errors.ErrorInfo:
    """An error answer as ``ErrorInfo``: the registry's JSON, or an object
    store's XML ``<Error><Code>..</Code><Message>..</Message></Error>``."""
    if body.lstrip().startswith(b"<"):
        fields = {k.decode(): v.decode(errors="replace") for k, v in _XML_FIELD.findall(body)}
        if fields:
            code = {401: errors.ErrCodeUnauthorized, 403: errors.ErrCodeDenied,
                    429: errors.ErrCodeTooManyRequests}.get(status, errors.ErrCodeUnknown)
            message = ": ".join(v for v in (fields.get("Code"), fields.get("Message")) if v)
            return errors.ErrorInfo(status, code, message or f"HTTP {status}")
    return errors.ErrorInfo.decode(body, status)


def http_download(
    url: str,
    writer: BinaryIO,
    headers: dict[str, str] | None = None,
    progress: Callable[[int], None] | None = None,
    chunk_size: int = 1024 * 1024,
) -> int:
    """Stream a (presigned) GET into ``writer``; redirects are not followed."""
    try:
        r = http_request("GET", url, headers=headers, stream=True)
    except (OSError, http.client.HTTPException) as e:
        raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"request failed: {e}") from e
    try:
        if r.status >= 400:
            raise decode_error(r.read(), r.status)
        n = 0
        while chunk := r.read(chunk_size):
            writer.write(chunk)
            n += len(chunk)
            if progress:
                progress(len(chunk))
        return n
    finally:
        r.close()


def http_upload(
    url: str,
    data,
    headers: dict[str, str] | None = None,
    method: str = "",
    retries: int = 3,
    progress: Callable[[int], None] | None = None,
) -> str:
    """PUT/POST bytes or a file (from its position to its end) to a
    (presigned) URL, with retries that rewind the body; returns the ETag
    (a multipart completion needs it). Presigned S3 URLs carry
    ``X-Amz-Credential`` and take PUT; everything else POSTs."""
    if not method:
        method = "PUT" if "X-Amz-Credential" in url or "X-Amz-Signature" in url else "POST"
    start = data.tell() if hasattr(data, "tell") else 0
    last: Exception | None = None
    for attempt in range(retries):
        try:
            if hasattr(data, "seek"):
                data.seek(start)  # rewind for the retry
            size = body_size(data)
            r = http_request(method, url, data=data, headers=headers)
            if r.status >= 400:
                raise decode_error(r.content, r.status)
            if progress:
                progress(size)
            return r.headers.get("ETag", "")
        except (errors.ErrorInfo, OSError, http.client.HTTPException) as e:
            last = e
            if attempt < retries - 1:
                time.sleep(0.2 * (2 ** attempt))
    assert last is not None
    if isinstance(last, errors.ErrorInfo):
        raise last
    raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"request failed: {last}") from last


class RawHTTPExtension:
    """Plain-HTTP provider: location.properties = {"url": ..., "headers": {...}}."""

    def download(self, location, desc, writer, progress=None) -> None:
        url = location.properties.get("url", "")
        http_download(url, writer, headers=location.properties.get("headers"), progress=progress)

    def upload(self, location, desc, reader, progress=None) -> None:
        url = location.properties.get("url", "")
        http_upload(url, reader, headers=location.properties.get("headers"), progress=progress)


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

    def upload(self, location, desc, reader, progress=None) -> None:
        raise errors.unsupported("file locations are download-only")


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
