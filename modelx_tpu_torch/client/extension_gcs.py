"""GCS client extension, the third signed-URL protocol (counterpart of
``modelx_tpu/client/extension_gcs.py``), registered as ``gcs`` beside
``file``, ``http`` and ``s3``.

- upload: GCS's resumable protocol. POST the server-issued signed
  initiation URL with ``x-goog-resumable: start`` (the header is part of
  the signature) to open an upload session, then PUT the body to the
  session URI with no further auth. 408, 429 and 5xx initiation answers
  retry; any other 4xx (an expired or denied signature) raises at once.
- download: the s3 provider's (one signed GET, parallel ranged GETs).
"""

from __future__ import annotations

import http.client
import time
from typing import BinaryIO, Callable

from modelx_tpu_torch import errors
from modelx_tpu_torch.client.extension import (
    decode_error, http_request, http_upload, register_extension,
)
from modelx_tpu_torch.client.extension_s3 import S3Extension
from modelx_tpu_torch.types import BlobLocation, Descriptor


class _Transient(Exception):
    """Wraps a retryable initiation failure (5xx, 408, 429, a malformed
    answer); deterministic 4xx answers raise straight through."""


class GCSExtension(S3Extension):
    def upload(
        self,
        location: BlobLocation,
        desc: Descriptor,
        reader: BinaryIO,
        progress: Callable[[int], None] | None = None,
    ) -> None:
        props = location.properties
        start_url = props.get("resumableUrl")
        if not start_url:
            # plain signed PUT
            http_upload(props["url"], reader, method="PUT", progress=progress)
            return
        last: Exception | None = None
        for attempt in range(3):
            try:
                try:
                    # signed header: sent exactly as promised
                    r = http_request("POST", start_url,
                                     headers={"x-goog-resumable": "start", "content-length": "0"})
                except (OSError, http.client.HTTPException) as e:
                    raise _Transient(e) from e
                if r.status >= 400:
                    err = decode_error(r.content, r.status)
                    if r.status < 500 and r.status not in (408, 429):
                        raise err
                    raise _Transient(err)
                session = r.headers.get("Location", "")
                if not session:
                    raise _Transient(OSError("resumable start returned no session URI"))
                break
            except _Transient as e:
                last = e.args[0]
                if attempt < 2:
                    time.sleep(0.2 * (2 ** attempt))
        else:
            assert last is not None
            if isinstance(last, errors.ErrorInfo):
                raise last
            raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"request failed: {last}")
        headers = {}
        if desc.size:
            headers["content-length"] = str(desc.size)
        # http_upload rewinds the reader per attempt, so a failed session
        # PUT restarts the body (GCS accepts a full re-PUT on a session)
        http_upload(session, reader, headers=headers, method="PUT", progress=progress)


register_extension("gcs", GCSExtension())
