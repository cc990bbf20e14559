"""Registry HTTP server: router, handlers, filters (counterpart of
``modelx_tpu/registry/server.py``, the local-FS store). Route table
(identical paths and bodies):

    GET     /healthz
    GET     /metrics                                     prometheus text
    GET     /                                            global index (?search=)
    GET     /{repository}/index                          repo index (?search=)
    DELETE  /{repository}/index
    GET     /{repository}/manifests/{reference}
    PUT     /{repository}/manifests/{reference}          (body capped 1 MiB)
    DELETE  /{repository}/manifests/{reference}
    HEAD    /{repository}/manifests/{reference}
    HEAD    /{repository}/blobs/{digest}
    GET     /{repository}/blobs/{digest}                 (supports Range)
    PUT     /{repository}/blobs/{digest}
    GET     /{repository}/blobs/{digest}/locations/{purpose}
    POST    /{repository}/garbage-collect                typed 501 (later slice)
    POST    /{repository}/scrub                          typed 501 (later slice)

Blob PUT bodies stream through sha256 and a mismatch is refused with a
typed 400 before the blob is visible; a manifest PUT verifies every
referenced blob; blob GET/HEAD carry ``Docker-Content-Digest``/``ETag``
and honor ``If-None-Match`` with 304; blob GETs go out with ``sendfile``;
boot rebuilds the indexes from storage. S3/GCS stores, auth and garbage
collection come with the control-plane slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import re
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import BinaryIO, Callable
from urllib.parse import parse_qs, unquote, urlparse

from modelx_tpu_torch import errors
from modelx_tpu_torch.registry import scrub as scrubmod
from modelx_tpu_torch.registry.fs import LocalFSProvider
from modelx_tpu_torch.registry.store import BlobContent, RegistryStore
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.types import Manifest

logger = logging.getLogger("modelx.registry")

# route regexes
NAME_REGEXP = r"[a-zA-Z0-9]+(?:[._-][a-zA-Z0-9]+)*/(?:[a-zA-Z0-9]+(?:[._-][a-zA-Z0-9]+)*)"
REFERENCE_REGEXP = r"[a-zA-Z0-9_][a-zA-Z0-9._-]{0,127}"
DIGEST_REGEXP = r"[A-Za-z][A-Za-z0-9]*(?:[-_+.][A-Za-z][A-Za-z0-9]*)*:[0-9a-fA-F]{32,}"

MAX_BYTES_READ = 1 << 20  # 1 MiB manifest cap
# the slice that brings garbage collection, scrub, S3/GCS and auth
LATER_SLICE = "control plane"


@dataclasses.dataclass
class Options:
    listen: str = ":8080"
    data_dir: str = "data/registry"
    tls_cert: str = ""
    tls_key: str = ""
    # FS store: advertise blobs' local paths as ``file`` download locations so
    # colocated clients (shared volume / same host) read them directly instead
    # of streaming through this process. Clients that can't see the path fall
    # back to the direct GET, so this is safe to leave on.
    local_redirect: bool = True
    # startup reconciliation: rebuild repo + global indexes from storage
    # before taking traffic (crash recovery for a manifest persisted
    # without its index refresh)
    reconcile_on_start: bool = True


class Metrics:
    """Minimal process-local counters exposed at /metrics (prometheus text)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def render(self) -> str:
        """Prometheus text 0.0.4 through the pod's renderer (``_total`` keys
        are counters, the rest gauges), as the JAX registry renders it."""
        from modelx_tpu_torch.utils import promexp

        with self._lock:
            counters = dict(sorted(self.counters.items()))
        return promexp.render(counters)


class Registry:
    """The handler set bound to a RegistryStore."""

    def __init__(self, store: RegistryStore, opts: Options | None = None) -> None:
        self.store = store
        self.opts = opts or Options()
        self.metrics = Metrics()
        # method, compiled path regex, handler(req, **groups)
        name, ref, dig = NAME_REGEXP, REFERENCE_REGEXP, DIGEST_REGEXP
        self.routes: list[tuple[str, re.Pattern, Callable]] = [
            ("GET", re.compile(r"^/healthz$"), self.healthz),
            ("GET", re.compile(r"^/metrics$"), self.get_metrics),
            ("GET", re.compile(r"^/$"), self.get_global_index),
            ("POST", re.compile(rf"^/(?P<name>{name})/garbage-collect$"), self.garbage_collect),
            ("POST", re.compile(rf"^/(?P<name>{name})/scrub$"), self.scrub),
            ("GET", re.compile(rf"^/(?P<name>{name})/index$"), self.get_index),
            ("DELETE", re.compile(rf"^/(?P<name>{name})/index$"), self.delete_index),
            ("GET", re.compile(rf"^/(?P<name>{name})/manifests/(?P<reference>{ref})$"), self.get_manifest),
            ("PUT", re.compile(rf"^/(?P<name>{name})/manifests/(?P<reference>{ref})$"), self.put_manifest),
            ("DELETE", re.compile(rf"^/(?P<name>{name})/manifests/(?P<reference>{ref})$"), self.delete_manifest),
            ("HEAD", re.compile(rf"^/(?P<name>{name})/blobs/(?P<digest>{dig})$"), self.head_blob),
            ("HEAD", re.compile(rf"^/(?P<name>{name})/manifests/(?P<reference>{ref})$"), self.head_manifest),
            ("GET", re.compile(rf"^/(?P<name>{name})/blobs/(?P<digest>{dig})/locations/(?P<purpose>\w+)$"), self.get_blob_location),
            ("GET", re.compile(rf"^/(?P<name>{name})/blobs/(?P<digest>{dig})$"), self.get_blob),
            ("PUT", re.compile(rf"^/(?P<name>{name})/blobs/(?P<digest>{dig})$"), self.put_blob),
        ]

    # -- handlers (each returns (status, headers, body|reader)) ---------------

    def healthz(self, req: "Request") -> "Response":
        return Response(200, body=b"ok")

    def get_metrics(self, req: "Request") -> "Response":
        from modelx_tpu_torch.utils import promexp

        return Response(200, body=self.metrics.render().encode(),
                        content_type=promexp.CONTENT_TYPE)

    def get_global_index(self, req: "Request") -> "Response":
        idx = self.store.get_global_index(req.query_one("search"))
        return Response.json(200, idx.to_json())

    def get_index(self, req: "Request", name: str) -> "Response":
        idx = self.store.get_index(name, req.query_one("search"))
        return Response.json(200, idx.to_json())

    def delete_index(self, req: "Request", name: str) -> "Response":
        self.store.remove_index(name)
        return Response(200)

    def get_manifest(self, req: "Request", name: str, reference: str) -> "Response":
        m = self.store.get_manifest(name, reference)
        return Response.json(200, m.to_json())

    def put_manifest(self, req: "Request", name: str, reference: str) -> "Response":
        if req.content_length > MAX_BYTES_READ:
            raise errors.manifest_invalid(f"manifest exceeds {MAX_BYTES_READ} bytes")
        body = req.read_body(MAX_BYTES_READ)
        try:
            manifest = Manifest.decode(body)
        except (ValueError, KeyError, AttributeError, TypeError) as e:
            raise errors.manifest_invalid(str(e)) from None
        self.store.put_manifest(name, reference, req.content_type, manifest)
        self.metrics.inc("manifest_put_total")
        return Response(201)

    def delete_manifest(self, req: "Request", name: str, reference: str) -> "Response":
        self.store.delete_manifest(name, reference)
        return Response(200)

    def head_manifest(self, req: "Request", name: str, reference: str) -> "Response":
        if not self.store.exists_manifest(name, reference):
            raise errors.manifest_unknown(reference)
        return Response(200, head_only=True)

    def head_blob(self, req: "Request", name: str, digest: str) -> "Response":
        if not self.store.exists_blob(name, digest):
            raise errors.blob_unknown(digest)
        meta = self.store.get_blob_meta(name, digest)
        return Response(
            200,
            headers={
                "Content-Length": str(meta.content_length),
                "Content-Type": meta.content_type or "application/octet-stream",
                **_blob_validators(digest),
            },
            head_only=True,
        )

    def get_blob(self, req: "Request", name: str, digest: str) -> "Response":
        # content addressing makes the digest a perfect validator: a client
        # (puller / blob cache) holding matching bytes revalidates for free
        inm = req.headers.get("If-None-Match", "")
        if inm and _etag_matches(inm, digest):
            if not self.store.exists_blob(name, digest):
                raise errors.blob_unknown(digest)
            self.metrics.inc("blob_get_revalidated_total")
            return Response(304, headers=_blob_validators(digest), head_only=True)
        offset, length, is_range = 0, -1, False
        rng = req.headers.get("Range", "")
        total = None
        if rng:
            m = re.match(r"^bytes=(\d+)-(\d*)$", rng)
            if not m:
                raise errors.ErrorInfo(416, errors.ErrCodeUnknown, f"unsupported range: {rng}")
            total = self.store.get_blob_meta(name, digest).content_length
            offset = int(m.group(1))
            end = int(m.group(2)) if m.group(2) else total - 1
            if offset >= total or end < offset:
                raise errors.ErrorInfo(416, errors.ErrCodeUnknown, f"range not satisfiable: {rng} of {total}")
            length = end - offset + 1
            is_range = True
        blob = self.store.get_blob(name, digest, offset=offset, length=length)
        headers = {
            "Content-Type": blob.content_type or "application/octet-stream",
            "Accept-Ranges": "bytes",
            **_blob_validators(digest),
        }
        status = 200
        if is_range:
            status = 206
            headers["Content-Range"] = f"bytes {offset}-{offset + blob.content_length - 1}/{total}"
        self.metrics.inc("blob_get_total")
        self.metrics.inc("blob_get_bytes", blob.content_length)
        return Response(status, headers=headers, body=blob.content, body_length=blob.content_length)

    def put_blob(self, req: "Request", name: str, digest: str) -> "Response":
        """Verified write: the body streams through sha256 on its way into
        the store; a digest or Content-Length mismatch aborts the write
        BEFORE the blob becomes visible (the verifier raises on the final
        read, so the FS temp file is discarded un-renamed and an existing
        good blob at the same address is never replaced)."""
        verifier = _VerifyingReader(req.body_stream(), digest, req.content_length)
        content = BlobContent(
            content=verifier,
            content_length=req.content_length,
            content_type=req.content_type or "application/octet-stream",
        )
        try:
            self.store.put_blob(name, digest, content)
        except errors.ErrorInfo:
            self.metrics.inc("blob_put_rejected_total")
            raise
        verifier.ensure_verified()  # zero-read store paths still verify
        self.metrics.inc("blob_put_total")
        self.metrics.inc("blob_put_bytes", max(req.content_length, 0))
        return Response(201)

    def get_blob_location(self, req: "Request", name: str, digest: str, purpose: str) -> "Response":
        properties = {k: v[0] for k, v in req.query.items()}
        location = self.store.get_blob_location(name, digest, purpose, properties)
        if location is None:
            raise errors.unsupported("blob location not supported by this store")
        self.metrics.inc("presign_issued_total")
        return Response.json(200, location.to_json())

    def garbage_collect(self, req: "Request", name: str) -> "Response":
        raise errors.ErrorInfo(501, errors.ErrCodeUnsupported, "the operation is unsupported",
                               f"garbage collection comes with the {LATER_SLICE} slice")

    def scrub(self, req: "Request", name: str) -> "Response":
        raise errors.ErrorInfo(501, errors.ErrCodeUnsupported, "the operation is unsupported",
                               f"scrub comes with the {LATER_SLICE} slice")

    # -- dispatch -------------------------------------------------------------

    def dispatch(self, req: "Request") -> "Response":
        path_matched = False
        for m, pattern, handler in self.routes:
            match = pattern.match(req.path)
            if not match:
                continue
            path_matched = True
            if m == req.method:
                return handler(req, **match.groupdict())
        if path_matched:
            raise errors.unsupported(f"{req.method} not allowed on {req.path}")
        raise errors.ErrorInfo(404, errors.ErrCodeUnknown, f"no route: {req.method} {req.path}")


def _blob_validators(digest: str) -> dict[str, str]:
    """Revalidation headers for content-addressed blobs: the digest IS the
    strong validator, in both the OCI spelling and the HTTP one."""
    return {"Docker-Content-Digest": digest, "ETag": f'"{digest}"'}


def _etag_matches(if_none_match: str, digest: str) -> bool:
    if if_none_match.strip() == "*":
        return True
    etag = f'"{digest}"'
    for candidate in if_none_match.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == etag or candidate == digest:
            return True
    return False


class _VerifyingReader(io.RawIOBase):
    """Stream a request body through its claimed hash on the way into the
    store. The moment the declared Content-Length has been consumed (or
    the stream ends early) the digest and size are checked and a typed
    400 raised — BEFORE the final chunk is handed to the store, so an
    atomic-rename backend never makes the bad object visible and a
    read-all backend never reaches its commit."""

    def __init__(self, inner: BinaryIO, digest: str, content_length: int) -> None:
        algo, _, hexpart = digest.partition(":")
        try:
            self._hash = hashlib.new(algo)
        except (ValueError, TypeError):
            raise errors.digest_invalid(digest, f"unsupported digest algorithm: {algo}") from None
        if len(hexpart) != self._hash.digest_size * 2:
            raise errors.digest_invalid(
                digest, f"{algo} digests are {self._hash.digest_size * 2} hex chars"
            )
        if content_length < 0:
            raise errors.size_invalid("Content-Length required for blob upload")
        self._inner = inner
        self._digest = digest
        self._want_hex = hexpart.lower()
        self._expected = content_length
        self._consumed = 0
        self._verified = False

    def read(self, n: int = -1) -> bytes:  # type: ignore[override]
        if self._verified:
            return b""
        if n is None or n < 0:
            # read-all semantics: loop to true EOF so a short underlying
            # read (socket closed early) still reaches the verification
            parts = []
            while not self._verified:
                chunk = self._read1(1 << 20)
                if chunk:
                    parts.append(chunk)
            return b"".join(parts)
        return self._read1(n)

    def _read1(self, n: int) -> bytes:
        data = self._inner.read(n)
        if data:
            self._hash.update(data)
            self._consumed += len(data)
        if not data or self._consumed >= self._expected:
            self._verify()
        return data

    def readable(self) -> bool:
        return True

    def ensure_verified(self) -> None:
        """Force the EOF check for store paths that never read (empty
        bodies on zero-touch backends). Drains any unread remainder first
        so verification always judges the whole declared body."""
        while not self._verified:
            self.read(1 << 20)

    def _verify(self) -> None:
        self._verified = True
        if self._consumed != self._expected:
            raise errors.size_invalid(
                f"body was {self._consumed} bytes, Content-Length declared {self._expected}"
            )
        got = self._hash.hexdigest()
        if got != self._want_hex:
            raise errors.digest_invalid(
                self._digest, f"body hashes to {self._digest.partition(':')[0]}:{got}"
            )


@dataclasses.dataclass
class Request:
    method: str
    path: str
    query: dict[str, list[str]]
    headers: dict[str, str]
    rfile: BinaryIO
    content_length: int = 0

    consumed: int = 0

    def query_one(self, key: str, default: str = "") -> str:
        vals = self.query.get(key)
        return vals[0] if vals else default

    @property
    def content_type(self) -> str:
        return self.headers.get("Content-Type", "")

    def read_body(self, limit: int) -> bytes:
        n = min(self.content_length, limit) if self.content_length >= 0 else limit
        data = self.rfile.read(n)
        self.consumed += len(data)
        return data

    def body_stream(self) -> BinaryIO:
        if self.content_length >= 0:
            return _Limited(self.rfile, self.content_length, self)
        return self.rfile

    def drain(self, cap: int = 4 * 1024 * 1024) -> bool:
        """Discard the unread request body so HTTP/1.1 keep-alive stays in
        sync after an error response. Returns False (caller should close the
        connection) when more than ``cap`` bytes remain."""
        remaining = self.content_length - self.consumed
        if remaining <= 0:
            return True
        if remaining > cap:
            return False
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 20))
            if not chunk:
                break
            remaining -= len(chunk)
        return True


class _Limited(io.RawIOBase):
    def __init__(self, f: BinaryIO, limit: int, req: "Request | None" = None) -> None:
        self._f, self._remaining, self._req = f, limit, req

    def read(self, n: int = -1) -> bytes:  # type: ignore[override]
        if self._remaining <= 0:
            return b""
        if n < 0 or n > self._remaining:
            n = self._remaining
        data = self._f.read(n)
        self._remaining -= len(data)
        if self._req is not None:
            self._req.consumed += len(data)
        return data

    def readable(self) -> bool:
        return True


@dataclasses.dataclass
class Response:
    status: int
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    body: bytes | BinaryIO = b""
    body_length: int | None = None
    content_type: str = ""
    head_only: bool = False

    @classmethod
    def json(cls, status: int, obj) -> "Response":
        return cls(status, body=json.dumps(obj).encode(), content_type="application/json")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    registry: Registry  # set on subclass

    # -- logging -> dispatch -----------------------------------------------------

    def _serve(self) -> None:
        start = time.monotonic()
        parsed = urlparse(self.path)
        req = Request(
            method=self.command,
            path=unquote(parsed.path) or "/",
            query=parse_qs(parsed.query),
            headers={k: v for k, v in self.headers.items()},
            rfile=self.rfile,
            content_length=int(self.headers.get("Content-Length", 0) or 0),
        )
        status = 500
        try:
            resp = self.registry.dispatch(req)
            status = resp.status
            self._write(resp, head_only=req.method == "HEAD" or resp.head_only)
        except errors.ErrorInfo as e:
            status = e.http_status
            # keep-alive stays usable only if the unread body is drained;
            # huge leftovers mean closing is cheaper than draining
            if not req.drain():
                self.close_connection = True
            self._write_error(e, head_only=req.method == "HEAD")
        except (BrokenPipeError, ConnectionResetError):
            status = 499
            self.close_connection = True
        except Exception as e:  # internal error
            logger.exception("internal error on %s %s", req.method, req.path)
            status = 500
            if not req.drain():
                self.close_connection = True
            self._write_error(errors.internal(str(e)), head_only=req.method == "HEAD")
        finally:
            # method, path, status, cost
            cost_ms = (time.monotonic() - start) * 1000
            logger.info("%s %s %d %.1fms", self.command, self.path, status, cost_ms)

    def _write(self, resp: Response, head_only: bool = False) -> None:
        self.send_response(resp.status)
        headers = dict(resp.headers)
        if resp.content_type:
            headers.setdefault("Content-Type", resp.content_type)
        body = resp.body
        if isinstance(body, bytes):
            headers.setdefault("Content-Length", str(len(body)))
        elif resp.body_length is not None:
            headers.setdefault("Content-Length", str(resp.body_length))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        if head_only:
            if not isinstance(body, bytes):
                body.close()
            return
        if isinstance(body, bytes):
            self.wfile.write(body)
        else:
            try:
                if not self._try_sendfile(body, resp.body_length):
                    while chunk := body.read(4 * 1024 * 1024):
                        self.wfile.write(chunk)
            finally:
                body.close()

    def _try_sendfile(self, body, length: int | None) -> bool:
        """Zero-copy blob streaming: kernel sendfile from the store file to
        the socket. Python write loops top out near ~1 GB/s per stream; the
        registry->device path needs better."""
        if length is None or isinstance(self.connection, ssl.SSLSocket):
            return False
        f = getattr(body, "raw_file", body)
        try:
            fd = f.fileno()
            offset = f.tell()
        except (AttributeError, OSError, ValueError):
            return False
        self.wfile.flush()
        import os as _os

        sent_total = 0
        while sent_total < length:
            sent = _os.sendfile(self.connection.fileno(), fd, offset + sent_total, length - sent_total)
            if sent == 0:
                break
            sent_total += sent
        return True

    def _write_error(self, e: errors.ErrorInfo, head_only: bool = False) -> None:
        try:
            body = e.encode()
            self.send_response(e.http_status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if not head_only:
                self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def log_message(self, fmt: str, *args) -> None:  # quiet default stderr log
        pass

    do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _serve


class RegistryServer:
    """Bootstrap, serve, graceful shutdown."""

    def __init__(self, opts: Options, store: RegistryStore | None = None) -> None:
        self.opts = opts
        if store is None:
            store = new_store(opts)
        self.registry = Registry(store, opts)
        if opts.reconcile_on_start:
            # a crash between manifest persist and index refresh leaves the
            # indexes stale: rebuild them from storage before taking traffic
            try:
                scrubmod.reconcile(store)
            except Exception:
                logger.exception("startup reconciliation failed; serving anyway")
        handler = type("BoundHandler", (_Handler,), {"registry": self.registry})
        host, _, port = opts.listen.rpartition(":")
        self.httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port)), handler)
        self.httpd.daemon_threads = True
        if opts.tls_cert and opts.tls_key:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(opts.tls_cert, opts.tls_key)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket, server_side=True)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        if isinstance(host, bytes):
            host = host.decode()
        scheme = "https" if (self.opts.tls_cert and self.opts.tls_key) else "http"
        return f"{scheme}://{host if host != '0.0.0.0' else '127.0.0.1'}:{port}"

    def serve_background(self) -> str:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.address

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def new_store(opts: Options) -> RegistryStore:
    """The local FS store under ``opts.data_dir``."""
    return FSRegistryStore(LocalFSProvider(opts.data_dir), local_redirect=opts.local_redirect)

