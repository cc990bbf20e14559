"""Typed HTTP client for the registry REST API (counterpart of
``modelx_tpu/client/remote.py``), on ``http.client`` instead of
``requests``: the same endpoints, the same error-body decoding into
``ErrorInfo``, ``latest`` version defaulting, the blob-location query
carrying size/name/media-type/annotations, retries with backoff and
``Retry-After``, read mirrors walked in a sticky rotation, hedged ranged
blob GETs, and stale-while-revalidate manifests through the pinned
manifest cache. The write half (manifest PUT, blob PUT through
the server) serves the pusher (``client/push.py``) and the derived-artifact
publishes; ``garbage_collect`` and ``scrub`` serve the CLI.

Connections are kept alive and reused per endpoint (``ConnectionPool``),
as a ``requests.Session`` pools them: a pull of many blobs, or many ranged
GETs, costs one TCP handshake per concurrent stream, not one per request.
"""

from __future__ import annotations

import http.client
import io
import logging
import os
import ssl
import threading
import urllib.parse
from typing import Any, BinaryIO, Iterator

from modelx_tpu_torch import errors
from modelx_tpu_torch.types import BlobLocation, Descriptor, Index, Manifest
from modelx_tpu_torch.utils.retry import (
    EndpointRotation, RetryPolicy, hedged_call, retriable_status,
)

logger = logging.getLogger("modelx.client")

_INSECURE = False  # process-wide default, set by --insecure


def set_insecure(insecure: bool = True) -> None:
    """Skip TLS certificate verification for every client transport built
    after the call: RegistryClient connections, the extensions' presigned
    transfers and the loader's ranged HTTPS sources."""
    global _INSECURE
    _INSECURE = insecure


def insecure_default() -> bool:
    return _INSECURE


def ssl_context(insecure: bool) -> ssl.SSLContext:
    ctx = ssl.create_default_context()
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


_MIRRORS: list[str] = []  # process-wide default, set by --registry-mirror


def set_mirrors(mirrors) -> None:
    """Set the process-wide read-mirror list (``--registry-mirror``).
    Mirrors are equivalent read replicas of the primary registry: GET/HEAD
    fail over to them (and ranged blob GETs hedge across them); writes
    always go to the primary. Every client built after the call sees them."""
    global _MIRRORS
    _MIRRORS = [m.rstrip("/") for m in mirrors if m and m.strip()]


def default_mirrors() -> list[str]:
    return list(_MIRRORS)


# transport failures that mean a kept-alive connection went stale under us
STALE_ERRORS = (http.client.RemoteDisconnected, http.client.CannotSendRequest,
          http.client.BadStatusLine, ConnectionResetError, BrokenPipeError)


class ConnectionPool:
    """Idle keep-alive connections to one ``scheme://host:port`` (the
    registry client's, and the registry's own S3 client's)."""

    MAX_IDLE = 16

    def __init__(self, base: str, timeout: tuple[float, float], insecure: bool) -> None:
        u = urllib.parse.urlsplit(base)
        self.https = u.scheme == "https"
        self.host = u.hostname or ""
        self.port = u.port or (443 if self.https else 80)
        self.timeout = timeout
        self.insecure = insecure
        self._idle: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def get(self) -> tuple[http.client.HTTPConnection, bool]:
        """A connection and whether it was reused (a reused one may have
        been closed by the server since)."""
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
        connect_s, read_s = self.timeout
        if self.https:
            conn = http.client.HTTPSConnection(self.host, self.port, timeout=connect_s,
                                               context=ssl_context(self.insecure))
        else:
            conn = http.client.HTTPConnection(self.host, self.port, timeout=connect_s)
        conn.connect()
        conn.sock.settimeout(read_s)
        return conn, False

    def put(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self.MAX_IDLE:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class Response:
    """One HTTP response: ``status``, ``headers``, and the body, read whole
    (``content``, ``json``) or streamed (``iter_content``, ``read``).
    The connection goes back to its pool once the body is read to its end;
    ``close`` before that drops it."""

    def __init__(self, resp: http.client.HTTPResponse, conn, pool: ConnectionPool) -> None:
        self.status = resp.status
        self.headers = resp.headers
        self._resp = resp
        self._conn = conn
        self._pool = pool
        self._content: bytes | None = None

    def _release(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if self._resp.isclosed() and not self._resp.will_close:
            self._pool.put(conn)
        else:
            conn.close()

    @property
    def content(self) -> bytes:
        if self._content is None:
            try:
                self._content = self._resp.read()
            except (OSError, http.client.HTTPException) as e:
                self.close()
                raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"response read failed: {e}") from e
            self._release()
        return self._content

    def json(self) -> Any:
        import json

        return json.loads(self.content)

    def read(self, n: int = -1) -> bytes:
        """The next ``n`` bytes of the body (the rest when ``n`` < 0)."""
        data = self._resp.read() if n is None or n < 0 else self._resp.read(n)
        if self._resp.isclosed():
            self._release()
        return data

    def iter_content(self, chunk_size: int | None = 1024 * 1024) -> Iterator[bytes]:
        """The body in pieces of ``chunk_size`` bytes, or with ``None`` in
        pieces as they arrive (a stream's chunks, each as soon as the
        server sends it)."""
        try:
            while True:
                chunk = (self._resp.read1(64 * 1024) if chunk_size is None
                         else self._resp.read(chunk_size))
                if not chunk:
                    break
                yield chunk
        finally:
            if self._resp.isclosed():
                self._release()
            else:
                self.close()

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


def body_size(data) -> int:
    """Bytes of a request body: a bytes-like object's length, or a
    reader's from its position to its end."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return memoryview(data).nbytes
    pos = data.tell()
    end = data.seek(0, os.SEEK_END)
    data.seek(pos)
    return end - pos


def send_request(pool: ConnectionPool, method: str, url: str, headers: dict[str, str],
                 data=None, chunk_size: int = 4 * 1024 * 1024,
                 read_timeout: float | None = None) -> Response:
    """One request on a connection of ``pool``: ``Host`` as the URL spells
    it (what a signature covers), the caller's headers, an exact
    ``Content-Length`` and the body, bytes or a reader streamed in pieces
    (a caller's ``content-length`` sizes a reader; else it runs to its
    end). No ``Accept-Encoding`` is added. A reused connection found stale
    is redialed once when the body can be sent again (none, bytes, or a
    seekable reader). ``read_timeout`` replaces the pool's read timeout
    for this request, on a reused connection too. Transport failures
    raise OSError or ``http.client.HTTPException``. The presigned
    transfers (``client/extension.py``), the registry's S3 client
    (``registry/fs_s3.py``) and the fleet router (``router/http.py``)
    send through it."""
    u = urllib.parse.urlsplit(url)
    target = (u.path or "/") + (f"?{u.query}" if u.query else "")
    given = next((v for k, v in headers.items() if k.lower() == "content-length"), None)
    size = 0 if data is None else int(given) if given is not None else body_size(data)
    seekable = getattr(data, "seekable", lambda: False)()
    start = data.tell() if seekable else 0
    replayable = data is None or seekable or isinstance(data, (bytes, bytearray, memoryview))
    for attempt in range(2):
        conn, reused = pool.get()
        if read_timeout is not None:
            conn.sock.settimeout(read_timeout)
        try:
            conn.putrequest(method, target, skip_host=True, skip_accept_encoding=True)
            conn.putheader("Host", u.netloc)
            for k, v in headers.items():
                if k.lower() != "content-length":
                    conn.putheader(k, v)
            if data is not None or method in ("PUT", "POST"):
                conn.putheader("Content-Length", str(size))
            conn.endheaders()
            if isinstance(data, (bytes, bytearray, memoryview)):
                conn.send(data)
            else:
                remaining = size if data is not None else 0
                while remaining > 0:
                    piece = data.read(min(chunk_size, remaining))
                    if not piece:
                        raise OSError(f"body ended {remaining} bytes short of its "
                                      f"Content-Length")
                    conn.send(piece)
                    remaining -= len(piece)
            resp = conn.getresponse()
        except STALE_ERRORS:
            conn.close()
            if reused and replayable and attempt == 0:
                if seekable:
                    data.seek(start)
                continue
            raise
        except BaseException:
            conn.close()
            raise
        return Response(resp, conn, pool)
    raise AssertionError("unreachable")


class RegistryClient:
    # (connect, read) timeouts: generous read for blob streams, bounded
    # connect so unreachable hosts fail instead of hanging
    DEFAULT_TIMEOUT = (10, 300)
    # retry policy for IDEMPOTENT requests (GET/HEAD): exponential backoff
    # with jitter; a server Retry-After wins when longer, capped
    RETRIES = 3
    RETRY_BACKOFF_S = 0.2
    RETRY_AFTER_CAP_S = 5.0
    # how long a ranged blob GET waits on the primary before hedging the
    # same range against a mirror (first response wins, loser closed)
    HEDGE_DELAY_S = 0.25

    def __init__(self, registry: str, authorization: str = "", timeout=None,
                 insecure: bool | None = None, retries: int | None = None,
                 mirrors: list[str] | None = None) -> None:
        self.registry = registry.rstrip("/")
        self.authorization = authorization
        self.timeout = timeout or self.DEFAULT_TIMEOUT
        # None = follow the process-wide flag at connection time
        self._insecure = insecure
        self.retries = self.RETRIES if retries is None else max(1, int(retries))
        # endpoint 0 is the primary; the rest are read mirrors. None =
        # follow the process-wide --registry-mirror default.
        if mirrors is None:
            mirrors = default_mirrors()
        self.endpoints = [self.registry] + [
            m.rstrip("/") for m in mirrors
            if m and m.rstrip("/") != self.registry
        ]
        self._rotation = EndpointRotation(len(self.endpoints))
        self._pools: dict[str, ConnectionPool] = {}
        self._pools_lock = threading.Lock()
        # where the last successful fetch came from, for ladder reporting:
        # "registry" | "mirror" | "cache" (stale-while-revalidate serve)
        self.last_endpoint = self.registry
        self.last_source = "registry"

    # -- plumbing -------------------------------------------------------------

    def _headers(self, extra: dict[str, str] | None = None) -> dict[str, str]:
        h: dict[str, str] = {}
        if self.authorization:
            h["Authorization"] = self.authorization
        if extra:
            h.update(extra)
        return h

    def _pool(self, base: str) -> ConnectionPool:
        with self._pools_lock:
            pool = self._pools.get(base)
            if pool is None:
                insecure = self._insecure if self._insecure is not None else _INSECURE
                pool = self._pools[base] = ConnectionPool(base, self.timeout, insecure)
            return pool

    def close(self) -> None:
        """Close every idle pooled connection."""
        with self._pools_lock:
            pools = list(self._pools.values())
        for pool in pools:
            pool.close()

    def _retry_sleep(self, attempt: int, retry_after: str | None) -> None:
        RetryPolicy(
            retries=self.retries, backoff_s=self.RETRY_BACKOFF_S,
            retry_after_cap_s=self.RETRY_AFTER_CAP_S,
        ).sleep(attempt, retry_after)

    @staticmethod
    def _health():
        from modelx_tpu_torch.dl import manifest_cache

        return manifest_cache.health()

    def _send(
        self,
        method: str,
        url: str,
        params: dict[str, str] | None = None,
        data: Any = None,
        headers: dict[str, str] | None = None,
        stream: bool = False,
    ) -> Response:
        """One HTTP attempt against one absolute URL; every failure raises
        typed ErrorInfo (transport errors become a synthetic 502, which is
        retriable by :func:`retriable_status`). A server ``Retry-After``
        rides on the raised error for the retry loop to honor. A kept-alive
        connection found stale is replaced once when the body can be sent
        again."""
        u = urllib.parse.urlsplit(url)
        base = f"{u.scheme}://{u.netloc}"
        target = u.path or "/"
        if params:
            target += "?" + urllib.parse.urlencode(params)
        pool = self._pool(base)
        hdrs = self._headers(headers)
        if isinstance(data, (bytes, bytearray)):
            hdrs.setdefault("Content-Length", str(len(data)))
        elif data is None and method in ("PUT", "POST"):
            hdrs.setdefault("Content-Length", "0")
        replayable = data is None or isinstance(data, (bytes, bytearray))
        for attempt in range(2):
            try:
                conn, reused = pool.get()
            except OSError as e:
                raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"request failed: {e}") from e
            try:
                conn.request(method, target, body=data, headers=hdrs)
                raw = conn.getresponse()
            except STALE_ERRORS as e:
                conn.close()
                if reused and replayable and attempt == 0:
                    continue
                raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"request failed: {e}") from e
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                raise errors.ErrorInfo(502, errors.ErrCodeUnknown, f"request failed: {e}") from e
            break
        if method == "HEAD":
            raw.read()  # no body; marks the response complete
        resp = Response(raw, conn, pool)
        if resp.status >= 400:
            body = b"" if method == "HEAD" else resp.content
            if body:
                err = errors.ErrorInfo.decode(body, resp.status)
            else:
                # HEAD responses carry no body: synthesize from status
                code = {
                    401: errors.ErrCodeUnauthorized,
                    403: errors.ErrCodeDenied,
                    404: errors.ErrCodeUnknown,
                    405: errors.ErrCodeUnsupported,
                    429: errors.ErrCodeTooManyRequests,
                }.get(resp.status, errors.ErrCodeUnknown)
                err = errors.ErrorInfo(resp.status, code, f"{method} {url}: HTTP {resp.status}")
            err.retry_after = resp.headers.get("Retry-After")
            resp._release()
            raise err
        if method == "HEAD":
            resp._release()
        elif not stream:
            resp.content  # read whole; the connection goes back to the pool
        return resp

    def _request_endpoint(
        self,
        method: str,
        base: str,
        path: str,
        params: dict[str, str] | None = None,
        data: Any = None,
        headers: dict[str, str] | None = None,
        stream: bool = False,
    ) -> Response:
        """The per-endpoint retry loop: GET/HEAD retry on connection errors
        and 5xx/429 (idempotent by contract); writes never retry here."""
        attempts = self.retries if method in ("GET", "HEAD") else 1
        for attempt in range(attempts):
            try:
                return self._send(method, base + path, params, data, headers, stream)
            except errors.ErrorInfo as e:
                if attempt == attempts - 1 or not retriable_status(e.http_status):
                    raise
                self._retry_sleep(attempt, getattr(e, "retry_after", None))
        raise AssertionError("unreachable")  # every path above returns/raises

    def _request(
        self,
        method: str,
        path: str,
        params: dict[str, str] | None = None,
        data: Any = None,
        headers: dict[str, str] | None = None,
        stream: bool = False,
    ) -> Response:
        """Endpoint failover: idempotent reads walk the endpoint rotation
        (primary first, then mirrors, starting from the last endpoint that
        worked) with the full per-endpoint retry policy; writes go to the
        primary only. A deterministic 4xx raises immediately; only transient
        trouble fails over. Every outcome lands on the control-plane health
        tracker."""
        read = method in ("GET", "HEAD")
        order = self._rotation.order() if read and len(self.endpoints) > 1 else [0]
        last_err: errors.ErrorInfo | None = None
        for ei in order:
            try:
                resp = self._request_endpoint(
                    method, self.endpoints[ei], path, params, data, headers, stream)
            except errors.ErrorInfo as e:
                last_err = e
                if not retriable_status(e.http_status):
                    # the registry answered: the control plane is up
                    self._health().note_ok(mirror=ei != 0)
                    raise
                if ei != order[-1]:
                    logger.warning("registry endpoint %s failed (%s); trying next",
                                   self.endpoints[ei], e)
                continue
            self._rotation.mark_good(ei)
            self.last_endpoint = self.endpoints[ei]
            self.last_source = "mirror" if ei else "registry"
            self._health().note_ok(mirror=ei != 0)
            return resp
        self._health().note_failure()
        assert last_err is not None
        raise last_err

    # -- index ----------------------------------------------------------------

    def get_global_index(self, search: str = "") -> Index:
        params = {"search": search} if search else None
        return Index.from_json(self._request("GET", "/", params=params).json())

    def get_index(self, repository: str, search: str = "") -> Index:
        params = {"search": search} if search else None
        return Index.from_json(self._request("GET", f"/{repository}/index", params=params).json())

    # -- manifests -------------------------------------------------------------

    @staticmethod
    def _version(version: str) -> str:
        return version or "latest"

    def get_manifest(self, repository: str, version: str = "") -> Manifest:
        """Manifest fetch with stale-while-revalidate: a success pins the
        manifest to the local disk cache; when every endpoint is down, the
        digest-pinned cached copy serves the call instead. Stale is safe:
        the manifest names content-addressed blob digests, and every blob
        verifies against its digest on use."""
        from modelx_tpu_torch.dl import manifest_cache

        ver = self._version(version)
        cache = manifest_cache.default_cache()
        try:
            r = self._request("GET", f"/{repository}/manifests/{ver}")
        except errors.ErrorInfo as e:
            if not retriable_status(e.http_status):
                raise  # a deterministic answer (e.g. 404): the cache must not mask it
            cached = cache.lookup(self.registry, repository, ver) if cache else None
            if cached is None:
                raise
            cache.note_stale_served()
            manifest_cache.health().note_offline_serve()
            self.last_source = "cache"
            logger.warning(
                "registry unreachable (%s); serving pinned manifest for %s/%s "
                "(age %.0fs)", e, repository, ver,
                cache.age_s(self.registry, repository, ver) or 0)
            return cached
        manifest = Manifest.from_json(r.json())
        if cache is not None:
            cache.put(self.registry, repository, ver, manifest)
        return manifest

    def put_manifest(self, repository: str, version: str, manifest: Manifest) -> None:
        self._request(
            "PUT",
            f"/{repository}/manifests/{self._version(version)}",
            data=manifest.encode(),
            headers={"Content-Type": manifest.media_type},
        )

    def exists_manifest(self, repository: str, version: str = "") -> bool:
        try:
            self._request("HEAD", f"/{repository}/manifests/{self._version(version)}")
            return True
        except errors.ErrorInfo as e:
            if e.http_status == 404:
                return False
            raise

    # -- blobs -----------------------------------------------------------------

    def head_blob(self, repository: str, digest: str) -> bool:
        try:
            self._request("HEAD", f"/{repository}/blobs/{digest}")
            return True
        except errors.ErrorInfo as e:
            if e.http_status == 404:
                return False
            raise

    def get_blob_content(self, repository: str, digest: str, offset: int = 0,
                         length: int = -1) -> Iterator[bytes]:
        """Streaming GET; optional Range for ranged/resumed reads. With
        mirrors configured the fetch is hedged: the preferred endpoint gets
        :attr:`HEDGE_DELAY_S` of head start, then the same range races
        against the next replica; the first response wins and the loser's
        stream is closed unread."""
        path = f"/{repository}/blobs/{digest}"
        headers = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        if len(self.endpoints) > 1:
            order = self._rotation.order()
            calls = [
                (lambda base=self.endpoints[ei]:
                 self._send("GET", base + path, headers=headers, stream=True))
                for ei in order
            ]
            try:
                pos, resp = hedged_call(
                    calls, self.HEDGE_DELAY_S, on_loser=lambda r: r.close())
            except errors.ErrorInfo:
                # every endpoint refused its single hedge shot; the
                # sequential path below still has the full retry budget
                resp = None
            if resp is not None:
                ei = order[pos]
                self._rotation.mark_good(ei)
                self.last_endpoint = self.endpoints[ei]
                self.last_source = "mirror" if ei else "registry"
                self._health().note_ok(mirror=ei != 0)
                return resp.iter_content(chunk_size=1024 * 1024)
        resp = self._request("GET", path, headers=headers, stream=True)
        return resp.iter_content(chunk_size=1024 * 1024)

    def upload_blob_content(self, repository: str, desc: Descriptor,
                            content: BinaryIO | bytes) -> None:
        """Direct PUT through the server, streamed in 1 MiB pieces under
        the descriptor's Content-Length."""
        if isinstance(content, bytes):
            content = io.BytesIO(content)
        self._request(
            "PUT",
            f"/{repository}/blobs/{desc.digest}",
            data=_sized_iter(content, desc.size),
            headers={
                "Content-Type": desc.media_type or "application/octet-stream",
                "Content-Length": str(desc.size),
            },
        )

    def get_blob_location(
        self, repository: str, desc: Descriptor, purpose: str
    ) -> BlobLocation | None:
        """None when the server answers UNSUPPORTED (a store with no
        location), so callers fall back to direct PUT/GET."""
        params = {
            "size": str(desc.size),
            "name": desc.name,
            "mediaType": desc.media_type,
        }
        for k, v in desc.annotations.items():
            params[f"annotation-{k}"] = v
        try:
            r = self._request(
                "GET", f"/{repository}/blobs/{desc.digest}/locations/{purpose}", params=params
            )
        except errors.ErrorInfo as e:
            if e.code == errors.ErrCodeUnsupported or e.http_status == 405:
                return None
            raise
        return BlobLocation.from_json(r.json())

    # -- registry maintenance ---------------------------------------------------

    def garbage_collect(self, repository: str, grace_s: float | None = None) -> dict:
        """Server-side mark-sweep of the repository's unreferenced blobs;
        ``grace_s`` None = the server's configured window."""
        params = {"grace": str(grace_s)} if grace_s is not None else None
        return self._request("POST", f"/{repository}/garbage-collect", params=params).json()

    def scrub(self, repository: str, sample: int = 0, seed: int = 0) -> dict:
        """Server-side integrity scrub: re-hash stored blobs (all, or a
        seeded sample), quarantine corruption, report dangling references."""
        params: dict[str, str] = {}
        if sample:
            params["sample"] = str(sample)
        if seed:
            params["seed"] = str(seed)
        return self._request("POST", f"/{repository}/scrub", params=params or None).json()


def _sized_iter(f: BinaryIO, size: int, chunk: int = 1024 * 1024) -> Iterator[bytes]:
    remaining = size
    while remaining > 0:
        data = f.read(min(chunk, remaining))
        if not data:
            break
        remaining -= len(data)
        yield data
