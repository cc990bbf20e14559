"""S3 client extension: the presigned data plane (counterpart of
``modelx_tpu/client/extension_s3.py``).

- upload: part ranges come from the server's location properties (an
  explicit offset and length per part), uploaded in parallel with per-part
  retry; parts the server already holds (a resumed push, found by
  ``ListParts``) are skipped;
- download: parallel ranged GETs on the one presigned URL into a
  preallocated file; an endpoint that ignores ``Range`` (answers 200) is
  re-read as one stream.

Transfers ride ``extension.http_request``: kept-alive connections pooled
per origin, no header the presign did not sign.
"""

from __future__ import annotations

import http.client
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Callable

from modelx_tpu_torch import errors
from modelx_tpu_torch.client.extension import (
    decode_error, http_request, http_upload, register_extension,
)
from modelx_tpu_torch.types import BlobLocation, Descriptor

UPLOAD_PART_CONCURRENCY = 8
DOWNLOAD_PART_CONCURRENCY = 8
DOWNLOAD_RANGE_SIZE = 32 * 1024 * 1024
_RANGED_THRESHOLD = 64 * 1024 * 1024


class S3Extension:
    def upload(
        self,
        location: BlobLocation,
        desc: Descriptor,
        reader: BinaryIO,
        progress: Callable[[int], None] | None = None,
    ) -> None:
        props = location.properties
        parts = props.get("parts")
        if not parts:
            # single presigned PUT
            http_upload(props["url"], reader, method="PUT", progress=progress)
            return
        lock = threading.Lock()
        # per-part state for a fragment-aware progress bar
        frag = getattr(progress, "fragment", None)
        if getattr(progress, "set_fragments", None):
            progress.set_fragments(len(parts))

        def upload_part(item: tuple[int, dict]) -> None:
            i, part = item
            if part.get("done"):
                if progress:
                    progress(part["length"])
                if frag:
                    frag(i, "done")
                return  # resume: the server already has this part
            if frag:
                frag(i, "active")
            with lock:
                reader.seek(part["offset"])
                data = reader.read(part["length"])
            http_upload(part["url"], data, method="PUT", retries=3)
            if progress:
                progress(len(data))
            if frag:
                frag(i, "done")

        with ThreadPoolExecutor(max_workers=UPLOAD_PART_CONCURRENCY) as pool:
            list(pool.map(upload_part, enumerate(parts)))  # propagates the first error

    def download(
        self,
        location: BlobLocation,
        desc: Descriptor,
        writer: BinaryIO,
        progress: Callable[[int], None] | None = None,
    ) -> None:
        url = location.properties["url"]
        size = int(location.properties.get("size", 0) or desc.size or 0)
        seekable = hasattr(writer, "seek") and _is_seekable(writer)
        if size < _RANGED_THRESHOLD or not seekable:
            _stream_get(url, writer, progress)
            return
        # parallel ranged GETs into a preallocated file
        writer.seek(size - 1)
        writer.write(b"\0")
        lock = threading.Lock()
        ranges = [
            (off, min(DOWNLOAD_RANGE_SIZE, size - off))
            for off in range(0, size, DOWNLOAD_RANGE_SIZE)
        ]

        range_ignored = threading.Event()
        reported = [0]

        def report(n: int) -> None:
            if progress:
                with lock:
                    reported[0] += n
                progress(n)

        frag = getattr(progress, "fragment", None)
        if getattr(progress, "set_fragments", None):
            progress.set_fragments(len(ranges))

        def fetch(item: tuple[int, tuple[int, int]]) -> None:
            i, (off, ln) = item
            last: Exception | None = None
            if frag:
                frag(i, "active")
            for _ in range(3):
                if range_ignored.is_set():
                    return
                try:
                    # the status is read before the body: a Range-ignoring
                    # endpoint answers 200 with the whole blob, which must
                    # not be read into memory here
                    r = http_request("GET", url, headers={"Range": f"bytes={off}-{off + ln - 1}"},
                                     stream=True)
                    try:
                        if r.status == 200:
                            range_ignored.set()
                            return
                        if r.status >= 400:
                            raise decode_error(r.read(), r.status)
                        data = r.read()
                    finally:
                        r.close()
                    if len(data) != ln:
                        raise OSError(f"range {off}-{off + ln - 1}: got {len(data)} bytes")
                    with lock:
                        writer.seek(off)
                        writer.write(data)
                    report(len(data))
                    if frag:
                        frag(i, "done")
                    return
                except (errors.ErrorInfo, OSError, http.client.HTTPException) as e:
                    last = e
                    if frag:
                        frag(i, "retry")
            assert last is not None
            raise last

        with ThreadPoolExecutor(max_workers=DOWNLOAD_PART_CONCURRENCY) as pool:
            list(pool.map(fetch, enumerate(ranges)))
        if range_ignored.is_set():
            if progress and reported[0]:
                progress(-reported[0])  # rewind the bar; re-streaming from 0
            writer.seek(0)
            writer.truncate()
            _stream_get(url, writer, progress)


def _is_seekable(writer) -> bool:
    try:
        return writer.seekable()
    except AttributeError:
        return False


def _stream_get(url: str, writer, progress) -> None:
    r = http_request("GET", url, stream=True)
    try:
        if r.status >= 400:
            raise decode_error(r.read(), r.status)
        while chunk := r.read(1024 * 1024):
            writer.write(chunk)
            if progress:
                progress(len(chunk))
    finally:
        r.close()


register_extension("s3", S3Extension())
