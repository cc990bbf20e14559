"""Shared HTTP plumbing for the router modules (counterpart of
``modelx_tpu/router/http.py``).

The registry poller, the rebalancer and the front door each talk to pods
through one ``LazySession`` and authenticate against the pods' admin
surface with the same bearer token. Where the reference keeps one
``requests.Session``, the port keeps, per thread, one
``client/remote.ConnectionPool`` per pod origin and sends through
``client/remote.send_request``: keep-alive connections are reused, and a
stream's chunks reach the router as the pod sends them
(``iter_content(chunk_size=None)``), never as a whole body.

Transport failures surface as the two classes ``requests`` gives the
reference: ``ReadTimeout`` (the pod accepted and is slower than the read
timeout: the request's problem, not the pod's) and ``TransportError``
(the pod could not be reached or its connection died), both ``OSError``.
"""

from __future__ import annotations

import http.client
import json as _json
import threading
import urllib.parse

from modelx_tpu_torch.client.remote import ConnectionPool, send_request


class TransportError(OSError):
    """A pod could not be reached, or its connection died mid-response."""


class ReadTimeout(TransportError):
    """The pod accepted the request but did not answer within the read
    timeout."""


class _DialError(OSError):
    """Raised by ``_PodPool.get`` when the TCP connect itself failed, so a
    connect timeout is told apart from a read timeout."""


class _PodPool(ConnectionPool):
    def get(self):
        try:
            return super().get()
        except OSError as e:
            raise _DialError(f"connect {self.host}:{self.port}: {e}") from e


def _classify(e: BaseException) -> TransportError:
    if isinstance(e, TransportError):
        return e
    if isinstance(e, TimeoutError) and not isinstance(e, _DialError):
        return ReadTimeout(f"read timed out: {e}")
    return TransportError(f"{type(e).__name__}: {e}")


_FAILURES = (OSError, http.client.HTTPException, ValueError)


class PodResponse:
    """One pod response with the fields the router reads of a
    ``requests`` response: ``status_code``, ``headers`` (case-insensitive
    ``get``, ``items`` as sent), ``content``, ``json()``,
    ``iter_content`` and ``close``."""

    def __init__(self, resp) -> None:
        self._resp = resp
        self.status_code = resp.status
        self.headers = resp.headers
        self._content: bytes | None = None

    @property
    def content(self) -> bytes:
        if self._content is None:
            try:
                self._content = self._resp.read()
            except _FAILURES as e:
                self._resp.close()
                raise _classify(e) from e
        return self._content

    def json(self):
        return _json.loads(self.content)

    def iter_content(self, chunk_size: int | None = None):
        it = self._resp.iter_content(chunk_size)
        while True:
            try:
                chunk = next(it)
            except StopIteration:
                return
            except _FAILURES as e:
                self._resp.close()
                raise _classify(e) from e
            yield chunk

    def close(self) -> None:
        self._resp.close()


class LazySession:
    """The router's pod transport, with the reference's injection seam:
    ``preset`` (any object with ``request(method, url, ...)``) replaces it
    entirely, the tests' fake-transport hook. Otherwise each thread keeps
    one keep-alive pool per pod origin."""

    def __init__(self, preset=None) -> None:
        self._preset = preset
        self._local = threading.local()

    def get(self):
        return self._preset if self._preset is not None else self

    def _pool(self, url: str, connect_s: float) -> ConnectionPool:
        u = urllib.parse.urlsplit(url)
        key = (u.scheme, u.netloc, connect_s)
        pools = getattr(self._local, "pools", None)
        if pools is None:
            pools = self._local.pools = {}
        pool = pools.get(key)
        if pool is None:
            pool = pools[key] = _PodPool(f"{u.scheme}://{u.netloc}", (connect_s, connect_s),
                                         insecure=False)
        return pool

    def request(self, method: str, url: str, headers: dict | None = None, data=None,
                json=None, timeout=5.0, stream: bool = False) -> PodResponse:
        """One request; ``timeout`` is seconds or ``(connect, read)``. The
        body is read whole before returning unless ``stream``."""
        connect_s, read_s = timeout if isinstance(timeout, tuple) else (timeout, timeout)
        headers = dict(headers or {})
        if json is not None:
            data = _json.dumps(json).encode()
            headers.setdefault("Content-Type", "application/json")
        try:
            resp = PodResponse(send_request(self._pool(url, float(connect_s)), method, url,
                                            headers, data, read_timeout=float(read_s)))
        except _FAILURES as e:
            raise _classify(e) from e
        if not stream:
            resp.content  # noqa: B018  (read the body now, as requests does)
        return resp


def bearer_headers(token: str) -> dict[str, str]:
    """The pods' admin-surface auth header (empty token = anonymous)."""
    return {"Authorization": f"Bearer {token}"} if token else {}
