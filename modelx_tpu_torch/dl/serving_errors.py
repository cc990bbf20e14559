"""Typed serving errors, the deadline and priority headers and the resume
wire contract (the part of ``modelx_tpu/dl/serving_errors.py`` this port
serves; a copy, since the port imports nothing of the JAX package).

``X-ModelX-Deadline-Ms`` carries the caller's remaining budget: a request
whose budget is already gone answers 504 before any work, on the native
and the OpenAI surface alike. ``X-ModelX-Priority`` names its class; both
reach only the continuous engine (``dl/continuous.py``): a live budget
clamps its per-request expiry, and batch-class rows queue behind
interactive ones. The engine's own refusals keep the reference's statuses:
a full backlog 429 + ``Retry-After``, a quarantined request 400, a dead or
restarting engine 503.

The model pool's lifecycle errors (``dl/lifecycle.py``) keep the
reference's statuses and bodies on both surfaces: PULLING/LOADING 503 +
``Retry-After``, DRAINING 409, FAILED 503 with the reason, UNLOADED 404.

A ``resume`` block continues a severed stream: the emitted token ids and
the original seed, as the native ``resume`` field or as the
``X-ModelX-Resume-*`` headers. Continuing one needs the continuous engine,
so without ``--continuous-batch`` a well-formed resume is refused exactly
as the JAX sidecar refuses it.

Every POST carries an end-to-end request id: a client's
``X-ModelX-Request-Id`` is honored when it is well formed, else the pod
mints one; it is echoed on the response with ``X-ModelX-Attempt``, stamps
the request's spans and its access-log line, and joins the engine ticket.
A JSON answer also carries its phase breakdown as ``X-ModelX-Timing-*``
headers (``timing_headers``).
"""

from __future__ import annotations

DEADLINE_HEADER = "X-ModelX-Deadline-Ms"
PRIORITY_HEADER = "X-ModelX-Priority"
RESUME_EMITTED_HEADER = "X-ModelX-Resume-Emitted"
RESUME_SEED_HEADER = "X-ModelX-Resume-Seed"
CLIENT_HEADER = "X-ModelX-Client"
REQUEST_ID_HEADER = "X-ModelX-Request-Id"
ATTEMPT_HEADER = "X-ModelX-Attempt"
TIMING_HEADER_PREFIX = "X-ModelX-Timing-"

PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"

# the id alphabet is closed: the id rides in headers and JSON log lines, so
# a hostile client-supplied id must not inject header or log structure
_REQUEST_ID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.:")
_REQUEST_ID_MAX = 128


def mint_request_id() -> str:
    """A fresh request id: 16 hex chars of OS entropy under a fixed prefix,
    minted by the first hop that sees the request without one."""
    import secrets

    return "req-" + secrets.token_hex(8)


def parse_request_id(value) -> str | None:
    """Client-supplied ``X-ModelX-Request-Id`` -> the id to honor, or None
    when absent or unusable (the receiver mints instead). Strict: a closed
    alphabet and a length cap, because the id is reflected verbatim into
    response headers and access logs."""
    if not value:
        return None
    rid = str(value).strip()
    if not rid or len(rid) > _REQUEST_ID_MAX:
        return None
    if not all(c in _REQUEST_ID_CHARS for c in rid):
        return None
    return rid


def parse_attempt(value) -> int:
    """``X-ModelX-Attempt`` header value -> attempt ordinal (>= 1); absent
    or malformed reads as attempt 1, the first try."""
    try:
        return max(1, int(str(value).strip()))
    except (TypeError, ValueError):
        return 1


def client_identity(headers, client_address) -> str:
    """The hashed client identity of a request for the access log: the API
    token, else the explicit ``X-ModelX-Client`` header, else the source IP.
    A token is hashed before it becomes a log key: the log must not leak a
    bearer credential."""
    import hashlib

    auth = str(headers.get("Authorization", "") or "")
    if auth.startswith("Bearer ") and auth[len("Bearer "):].strip():
        digest = hashlib.sha256(auth[len("Bearer "):].strip().encode()).hexdigest()
        return "tok:" + digest[:12]
    explicit = str(headers.get(CLIENT_HEADER, "") or "").strip()
    if explicit:
        return "hdr:" + explicit[:64]
    host = client_address[0] if client_address else ""
    return "ip:" + (host or "unknown")


def timing_headers(timing: dict) -> dict[str, str]:
    """A timing breakdown dict -> ``X-ModelX-Timing-*`` response headers.
    ``{"queue_ms": 1.25}`` becomes ``X-ModelX-Timing-Queue-Ms: 1.25``;
    non-numeric values are skipped, so a partly filled breakdown never
    breaks the response."""
    out: dict[str, str] = {}
    for key, val in (timing or {}).items():
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            continue
        name = TIMING_HEADER_PREFIX + "-".join(
            p.capitalize() for p in str(key).split("_") if p)
        out[name] = f"{val:g}" if isinstance(val, float) else str(val)
    return out


def parse_priority(value) -> str:
    """Header value -> priority class; anything but an explicit "batch"
    is interactive (the default class must be the safe one)."""
    return PRIORITY_BATCH if str(value or "").strip().lower() == PRIORITY_BATCH \
        else PRIORITY_INTERACTIVE


def parse_deadline_ms(value) -> float | None:
    """``X-ModelX-Deadline-Ms`` header value -> remaining seconds (>= 0.0;
    0.0 = the caller's budget is already gone), or None when the header is
    absent or malformed (no propagated deadline)."""
    if not value:
        return None
    try:
        return max(0, int(float(value))) / 1000.0
    except (TypeError, ValueError, OverflowError):
        # "inf"/"1e400" parse as float but refuse int(): malformed too
        return None


def deadline_kwargs(timeout_s: float | None, priority: str) -> dict:
    """Engine-call kwargs for a propagated deadline/priority, included
    only when actually stamped."""
    kw: dict = {}
    if timeout_s is not None:
        kw["timeout_s"] = timeout_s
    if priority != PRIORITY_INTERACTIVE:
        kw["priority"] = priority
    return kw


class ServingError(RuntimeError):
    """Base for typed serving failures; ``http_status`` is the status every
    transport answers with, ``api_type`` the OpenAI ``error.type``."""

    http_status = 500
    api_type = "server_error"

    def headers(self) -> dict[str, str]:
        return {}


class DeadlineExceededError(ServingError):
    """The request's budget ran out (504)."""

    http_status = 504

    def __init__(self, state: str, timeout_s: float) -> None:
        super().__init__(
            f"request deadline exceeded while {state} "
            f"(--request-timeout {timeout_s:g}s)"
        )
        self.state = state


class QueueFullError(ServingError):
    """Admission backlog is at --max-queue-depth: shed NOW with 429 so the
    client backs off, instead of queueing into unbounded latency."""

    http_status = 429
    api_type = "rate_limit_error"

    def __init__(self, depth: int, limit: int, retry_after: float = 1.0,
                 message: str | None = None) -> None:
        super().__init__(
            message
            or f"admission queue full ({depth} waiting, limit {limit}); retry later"
        )
        self.retry_after = max(1, int(retry_after))

    def headers(self) -> dict[str, str]:
        return {"Retry-After": str(self.retry_after)}


class PoisonedRequestError(ServingError):
    """This exact request crashed the engine loop repeatedly; it is
    quarantined and rejected up front: re-admitting it would turn one bad
    request into a restart livelock."""

    http_status = 400
    api_type = "invalid_request_error"

    def __init__(self, crashes: int) -> None:
        super().__init__(
            f"request quarantined: it crashed the engine {crashes} times"
        )


class EngineBrokenError(ServingError):
    """The engine loop died while this request was in flight (or the
    circuit breaker opened). 503: the supervisor restarts the engine, so
    a retry against this pod (or another) is the right client move."""

    http_status = 503

    def __init__(self, message: str = "serving engine failed") -> None:
        super().__init__(message)


class ModelLoadingError(ServingError):
    """The model is mid-materialization (PULLING its blobs or LOADING them
    onto the device): 503 + ``Retry-After``, so load balancers and retrying
    clients back off instead of hammering a model that will be READY
    shortly."""

    http_status = 503

    def __init__(self, name: str, state: str = "loading",
                 retry_after: float = 2.0) -> None:
        super().__init__(f"model {name!r} is still {state}; retry later")
        self.model = name
        self.state = state
        self.retry_after = max(1, int(retry_after))

    def headers(self) -> dict[str, str]:
        return {"Retry-After": str(self.retry_after)}


class ModelUnloadedError(ServingError):
    """The model was unloaded (or evicted): the name no longer serves. 404,
    as the routing layer answers unknown names; raised when a request slips
    past the admission check just as the free completes, so it never runs
    against a freed server."""

    http_status = 404
    api_type = "not_found_error"

    def __init__(self, name: str) -> None:
        super().__init__(f"model {name!r} is not loaded")
        self.model = name


class ModelDrainingError(ServingError):
    """The model is DRAINING (an unload or eviction is letting its
    in-flight requests finish). 409: new admissions are refused; once the
    drain completes the name 404s."""

    http_status = 409
    api_type = "invalid_request_error"

    def __init__(self, name: str) -> None:
        super().__init__(f"model {name!r} is draining (being unloaded)")
        self.model = name


class ModelFailedError(ServingError):
    """The model's load crashed (FAILED in the pool). 503: the slot stays
    retryable (an admin re-POST of the name retries the load), and the
    reason rides in the message."""

    http_status = 503

    def __init__(self, name: str, reason: str = "") -> None:
        super().__init__(
            f"model {name!r} failed to load" + (f": {reason}" if reason else "")
        )
        self.model = name
        self.reason = reason


class NoReadyPodError(ServingError):
    """The fleet router found no READY pod for the model: every candidate
    is loading, draining, quarantined, or shed the request. 503 +
    ``Retry-After``: pods poll back to health, so the client backs off and
    retries, as a single pod's ``ModelLoadingError`` asks."""

    http_status = 503

    def __init__(self, model: str, detail: str = "",
                 retry_after: float = 2.0) -> None:
        super().__init__(
            f"no ready pod serves model {model!r}"
            + (f" ({detail})" if detail else "") + "; retry later"
        )
        self.model = model
        self.retry_after = max(1, int(retry_after))

    def headers(self) -> dict[str, str]:
        return {"Retry-After": str(self.retry_after)}


class UpstreamSeveredError(ServingError):
    """A pod died while the router was relaying its stream and the
    continuation was exhausted: the status cannot change with bytes on the
    wire, so the router writes this typed payload as the stream's last
    event (502 in the payload), never a silently truncated 200."""

    http_status = 502

    def __init__(self, pod: str, detail: str = "") -> None:
        super().__init__(
            f"upstream pod {pod} died mid-stream"
            + (f": {detail}" if detail else "")
            + "; response is incomplete — retry the request"
        )
        self.pod = pod


class MalformedResumeError(ServingError):
    """A resume block the pod cannot honor as stated (400): the caller must
    not silently restart a stream the client already holds k tokens of."""

    http_status = 400
    api_type = "invalid_request_error"

    def __init__(self, detail: str) -> None:
        super().__init__(f"malformed resume: {detail}")


class ResumeExhaustedError(ServingError):
    """The resume frontier is at or past the request's end (422): every
    budgeted token, or a stop token, was already emitted."""

    http_status = 422
    api_type = "invalid_request_error"

    def __init__(self, detail: str) -> None:
        super().__init__(f"resume exhausted: {detail}")


def parse_resume(emitted_value, seed_value):
    """Resume block -> ``(emitted token ids, seed)``, or None when absent.
    ``emitted_value`` is the header's comma-separated string or the native
    field's id list; ``seed_value`` the header string or native int.
    Anything not honorable as stated raises ``MalformedResumeError``."""
    if emitted_value is None and seed_value is None:
        return None
    if emitted_value is None or seed_value is None:
        raise MalformedResumeError(
            "resume requires both the emitted tokens and the original seed"
        )
    try:
        seed = int(str(seed_value).strip())
    except (TypeError, ValueError):
        raise MalformedResumeError(
            f"resume seed {seed_value!r} is not an integer"
        ) from None
    if not 0 <= seed < 2**31:
        raise MalformedResumeError(f"resume seed {seed} out of [0, 2^31)")
    if isinstance(emitted_value, str):
        parts = [p for p in emitted_value.split(",") if p.strip()]
    elif isinstance(emitted_value, (list, tuple)):
        parts = list(emitted_value)
    else:
        raise MalformedResumeError("resume emitted must be a token id list")
    if not parts:
        raise MalformedResumeError("resume emitted is empty: nothing to resume")
    emitted = []
    for p in parts:
        try:
            t = int(str(p).strip())
        except (TypeError, ValueError):
            raise MalformedResumeError(
                f"resume emitted token {p!r} is not an integer"
            ) from None
        if t < 0:
            raise MalformedResumeError(f"resume emitted token {t} is negative")
        emitted.append(t)
    return emitted, seed


def resume_headers(emitted, seed) -> dict[str, str]:
    """The resume block as headers: what the fleet router stamps on a
    continuation attempt (the original body is re-sent verbatim)."""
    return {
        RESUME_EMITTED_HEADER: ",".join(str(int(t)) for t in emitted),
        RESUME_SEED_HEADER: str(int(seed)),
    }
