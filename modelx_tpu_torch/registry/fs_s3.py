"""S3 FSProvider and the registry's S3 client (counterpart of
``modelx_tpu/registry/fs_s3.py``): path-style addressing (minio speaks
it), the key prefix ``registry/``, paginated ListObjectsV2, the multipart
control calls the presign store needs, and SigV4 (``sigv4.py``) for both
header-signed calls and presigned URLs.

The JAX package's client rides ``requests``; this one rides
``http.client`` through ``client/remote.send_request``, the sender the
client's presigned transfers use: a PUT body streamed from a file under
its exact ``Content-Length``, kept-alive connections pooled across the
registry's request threads (one thread at a time on each connection), the
``Host`` header sent exactly as it was signed and no ``Accept-Encoding``,
and error answers read as S3's XML ``<Error>`` (code and message in the
raised ``OSError``).
"""

from __future__ import annotations

import dataclasses
import urllib.parse
import xml.etree.ElementTree as ET
from typing import BinaryIO

from modelx_tpu_torch.client.remote import ConnectionPool, Response, send_request
from modelx_tpu_torch.registry import sigv4
from modelx_tpu_torch.registry.fs import FSContent, FSMeta, FSNotFound

DEFAULT_KEY_PREFIX = "registry/"
PRESIGN_EXPIRE_S = 3600
_CHUNK = 4 * 1024 * 1024


@dataclasses.dataclass
class S3Options:
    url: str  # endpoint, e.g. http://minio:9000
    access_key: str
    secret_key: str
    bucket: str = "registry"
    region: str = "us-east-1"
    key_prefix: str = DEFAULT_KEY_PREFIX
    presign_expire_s: int = PRESIGN_EXPIRE_S


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _xml_find(el: ET.Element, name: str) -> str:
    for child in el.iter():
        if _strip_ns(child.tag) == name:
            return child.text or ""
    return ""


def _error_text(body: bytes) -> str:
    """An S3 error body as ``Code: Message`` (its raw text when it is not
    S3's XML)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        return body[:500].decode(errors="replace")
    parts = [_xml_find(root, "Code"), _xml_find(root, "Message")]
    return ": ".join(p for p in parts if p) or body[:500].decode(errors="replace")


class S3Client:
    """Minimal S3 REST client: object CRUD, ListObjectsV2, multipart,
    presign; path-style addressing throughout."""

    # provider-specific V4 spelling; the GCS subclass swaps in GOOG_SIG
    sig_spec = sigv4.AWS_SIG
    service = "s3"

    def __init__(self, opts: S3Options) -> None:
        self.opts = opts
        self.creds = sigv4.Credentials(
            access_key=opts.access_key, secret_key=opts.secret_key,
            region=opts.region, service=self.service,
        )
        self.endpoint = opts.url.rstrip("/")
        self._pool = ConnectionPool(self.endpoint, timeout=(10, 300), insecure=False)

    # -- plumbing -------------------------------------------------------------

    def _url(self, key: str, query: dict[str, str] | None = None) -> str:
        path = f"/{self.opts.bucket}/{urllib.parse.quote(key, safe='/-_.~')}"
        url = self.endpoint + path
        if query:
            url += "?" + sigv4.canonical_query(query)
        return url

    def _request(
        self,
        method: str,
        key: str,
        query: dict[str, str] | None = None,
        data=None,
        headers: dict[str, str] | None = None,
        stream: bool = False,
    ) -> Response:
        url = self._url(key, query)
        headers = dict(headers or {})
        if data is not None and "content-length" not in headers and not hasattr(data, "read"):
            headers["content-length"] = str(memoryview(data).nbytes)
        signed = sigv4.sign_headers(self.creds, method, url, headers=headers, spec=self.sig_spec)
        if data is not None and hasattr(data, "read") and "content-length" not in headers:
            data = data.read()  # a reader of unknown length: the body whole
            signed["content-length"] = str(len(data))
        resp = send_request(self._pool, method, url, signed, data, _CHUNK)
        if resp.status == 404:
            resp.close()
            raise FSNotFound(key)
        if resp.status >= 400:
            body = b"" if method == "HEAD" else resp.content
            resp.close()
            raise OSError(f"s3 {method} {key}: HTTP {resp.status}: {_error_text(body)}")
        if method == "HEAD":
            resp.content  # no body: marks the response complete
        elif not stream:
            resp.content
        return resp

    # -- object CRUD ----------------------------------------------------------

    def put_object(self, key: str, data: BinaryIO | bytes, size: int = -1, content_type: str = "") -> None:
        headers = {}
        if content_type:
            headers["content-type"] = content_type
        if size >= 0:
            headers["content-length"] = str(size)
        self._request("PUT", key, data=data, headers=headers)

    def get_object(self, key: str, offset: int = 0, length: int = -1) -> Response:
        headers = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            headers["range"] = f"bytes={offset}-{end}"
        return self._request("GET", key, headers=headers, stream=True)

    def head_object(self, key: str) -> dict[str, str]:
        r = self._request("HEAD", key)
        return dict(r.headers)

    def delete_object(self, key: str) -> None:
        try:
            self._request("DELETE", key)
        except FSNotFound:
            pass

    def list_objects(self, prefix: str, delimiter: str = "") -> tuple[list[FSMeta], list[str]]:
        """ListObjectsV2 with pagination. Returns (objects, common_prefixes)."""
        out: list[FSMeta] = []
        prefixes: list[str] = []
        token = ""
        while True:
            query = {"list-type": "2", "prefix": prefix, "max-keys": "1000"}
            if delimiter:
                query["delimiter"] = delimiter
            if token:
                query["continuation-token"] = token
            r = self._request("GET", "", query=query)
            root = ET.fromstring(r.content)
            for el in root:
                tag = _strip_ns(el.tag)
                if tag == "Contents":
                    out.append(
                        FSMeta(
                            name=_xml_find(el, "Key"),
                            size=int(_xml_find(el, "Size") or 0),
                            content_type="",
                        )
                    )
                elif tag == "CommonPrefixes":
                    prefixes.append(_xml_find(el, "Prefix"))
            if _xml_find(root, "IsTruncated") == "true":
                token = _xml_find(root, "NextContinuationToken")
                if not token:
                    break
            else:
                break
        return out, prefixes

    # -- multipart ------------------------------------------------------------

    def create_multipart_upload(self, key: str, content_type: str = "") -> str:
        headers = {"content-type": content_type} if content_type else {}
        r = self._request("POST", key, query={"uploads": ""}, headers=headers)
        upload_id = _xml_find(ET.fromstring(r.content), "UploadId")
        if not upload_id:
            raise OSError(f"s3: no UploadId in CreateMultipartUpload response for {key}")
        return upload_id

    def list_multipart_uploads(self, prefix: str) -> dict[str, str]:
        """key -> uploadId of the uploads in progress."""
        r = self._request("GET", "", query={"uploads": "", "prefix": prefix})
        root = ET.fromstring(r.content)
        out = {}
        for el in root:
            if _strip_ns(el.tag) == "Upload":
                out[_xml_find(el, "Key")] = _xml_find(el, "UploadId")
        return out

    def list_parts(self, key: str, upload_id: str) -> list[tuple[int, str, int]]:
        """[(part_number, etag, size)], sorted."""
        r = self._request("GET", key, query={"uploadId": upload_id})
        root = ET.fromstring(r.content)
        parts = []
        for el in root:
            if _strip_ns(el.tag) == "Part":
                parts.append(
                    (
                        int(_xml_find(el, "PartNumber")),
                        _xml_find(el, "ETag").strip('"'),
                        int(_xml_find(el, "Size") or 0),
                    )
                )
        return sorted(parts)

    def complete_multipart_upload(self, key: str, upload_id: str, parts: list[tuple[int, str]]) -> None:
        body = "<CompleteMultipartUpload>"
        for number, etag in sorted(parts):
            body += f"<Part><PartNumber>{number}</PartNumber><ETag>\"{etag}\"</ETag></Part>"
        body += "</CompleteMultipartUpload>"
        self._request("POST", key, query={"uploadId": upload_id}, data=body.encode())

    def abort_multipart_upload(self, key: str, upload_id: str) -> None:
        try:
            self._request("DELETE", key, query={"uploadId": upload_id})
        except FSNotFound:
            pass

    # -- presign --------------------------------------------------------------

    def presign(self, method: str, key: str, expires_s: int | None = None,
                query: dict[str, str] | None = None,
                signed_headers: dict[str, str] | None = None) -> str:
        url = self._url(key)
        if query:
            url += "?" + sigv4.canonical_query(query)
        return sigv4.presign_url(
            self.creds, method, url,
            expires_s=expires_s or self.opts.presign_expire_s,
            spec=self.sig_spec, signed_headers=signed_headers,
        )


class S3FSProvider:
    """FSProvider over S3: the registry's metadata objects (indexes,
    manifests) and server-side blob writes."""

    def __init__(self, opts: S3Options) -> None:
        self.opts = opts
        self.client = S3Client(opts)
        self.prefix = opts.key_prefix

    def _key(self, path: str) -> str:
        return self.prefix + path.strip("/")

    def put(self, path: str, content: BinaryIO, size: int = -1, content_type: str = "") -> None:
        data = content.read() if size < 0 else content
        self.client.put_object(self._key(path), data, size=size, content_type=content_type)

    def get(self, path: str, offset: int = 0, length: int = -1) -> FSContent:
        r = self.client.get_object(self._key(path), offset, length)
        size = int(r.headers.get("Content-Length", 0) or 0)
        return FSContent(reader=r, size=size, content_type=r.headers.get("Content-Type", ""))

    def stat(self, path: str) -> FSMeta:
        h = self.client.head_object(self._key(path))
        mtime = 0.0
        if h.get("Last-Modified"):
            from email.utils import parsedate_to_datetime

            try:
                mtime = parsedate_to_datetime(h["Last-Modified"]).timestamp()
            except (TypeError, ValueError):
                pass
        return FSMeta(
            name=path.strip("/"),
            size=int(h.get("Content-Length", 0) or 0),
            content_type=h.get("Content-Type", ""),
            last_modified=mtime,
        )

    def remove(self, path: str) -> None:
        key = self._key(path)
        # an object or a whole prefix
        objs, _ = self.client.list_objects(key + "/")
        if objs:
            for o in objs:
                self.client.delete_object(o.name)
            return
        self.client.delete_object(key)

    def exists(self, path: str) -> bool:
        try:
            self.client.head_object(self._key(path))
            return True
        except FSNotFound:
            return False

    def list(self, prefix: str, recursive: bool = False) -> list[FSMeta]:
        key = self._key(prefix)
        if key and not key.endswith("/"):
            key += "/"
        if recursive:
            objs, _ = self.client.list_objects(key)
            return [
                FSMeta(name=o.name[len(key):], size=o.size)
                for o in objs
                if o.name != key
            ]
        objs, prefixes = self.client.list_objects(key, delimiter="/")
        out = [FSMeta(name=o.name[len(key):], size=o.size) for o in objs if o.name != key]
        out += [FSMeta(name=p[len(key):].rstrip("/"), size=0) for p in prefixes]
        return sorted(out, key=lambda m: m.name)

