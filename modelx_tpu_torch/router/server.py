"""The fleet front door: one HTTP surface, many pods behind it (counterpart
of ``modelx_tpu/router/server.py``, on ``http.server`` and the router's
``http.client`` transport, ``router/http.py``).

Speaks the pods' native (``/v1/generate``, ``/v1/{model}/...``) and
OpenAI (``/v1/completions``, ``/v1/chat/completions``) surfaces
UNCHANGED — clients cannot tell the router from a pod by request or
response shape, including streaming: SSE/NDJSON bodies relay
chunk-for-chunk, so the routed byte stream is identical to the pod's.

Per request:

1. resolve the model (path segment, OpenAI ``model`` field, or the
   router default) and compute the sticky key (policy.sticky_key);
2. build the failover plan: sticky pod first, then READY candidates by
   effective load (poll-time queue depth + the router's own live
   in-flight counts), never DRAINING/quarantined pods;
3. dispatch down the plan within the request deadline — a connection
   error quarantines the pod (and drops its sticky assignments: the
   prefix cache died with it) and moves on; a 429/503 (bounded-admission
   backpressure, engine restarting) moves on and, when every candidate
   shed, relays the LAST backpressure response verbatim — Retry-After
   included — and feeds the rebalancer's pressure signal;
4. streaming: the first body chunk is pulled BEFORE the 200 commits, so
   an immediately-dying pod still fails over invisibly; after bytes are
   on the wire a native single-row token stream whose pod dies (or
   announces draining) is CONTINUED: the router re-plans within the
   remaining deadline and retry budget and re-issues the request with
   the ``X-ModelX-Resume-*`` block set to the tokens already relayed —
   the pod re-prefills prompt + emitted and rejoins the original
   (seed, step) sample stream, so the spliced body is byte-identical to
   the uninterrupted one. Only when continuation is exhausted (budget
   dry, deadline gone, no candidate, resume refused) does the client
   see the typed in-stream error payload (``UpstreamSeveredError``, 502
   in the payload) — never a silently truncated 200. OpenAI SSE streams
   keep the typed-502 behavior (text deltas are not splice-exact across
   a re-decode; the pod-side resume contract covers that surface for
   direct callers).

Non-streaming requests whose pod died mid-body retry FROM SCRATCH on the
next candidate: nothing was committed to the client, generation is
re-runnable (greedy is deterministic; sampled requests carry their seed),
so the client sees one complete answer or one typed error, never a drop.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from modelx_tpu_torch.dl.serving_errors import (
    ATTEMPT_HEADER,
    REQUEST_ID_HEADER,
    DeadlineExceededError,
    ModelDrainingError,
    ModelUnloadedError,
    NoReadyPodError,
    QueueFullError,
    ServingError,
    UpstreamSeveredError,
    mint_request_id,
    parse_attempt,
    parse_request_id,
    parse_resume,
    resume_headers,
)
from modelx_tpu_torch.router.admission import (
    DEADLINE_HEADER,
    PRIORITY_HEADER,
    AdmissionController,
    BreakerBoard,
    RetryBudget,
    client_key,
    parse_deadline_ms,
    parse_priority,
)
from modelx_tpu_torch.router.http import LazySession, ReadTimeout, TransportError
from modelx_tpu_torch.router.policy import StickyTable, plan_route, sticky_keys
from modelx_tpu_torch.router.registry import PodRegistry
from modelx_tpu_torch.utils import accesslog, promexp, trace, tswheel

logger = logging.getLogger("modelx.router")

# native + OpenAI routes the router proxies; everything else 404s here
# (the /admin lifecycle surface is per-pod by design — the rebalancer is
# the only fleet-level writer, and it acts on pods directly)
_OPENAI_PATHS = ("/v1/completions", "/v1/chat/completions")
_PLAIN_PATHS = ("/v1/generate", "/v1/forward")
# statuses that mean "this pod can't take it right now, another might":
# 429 bounded-admission shed, 503 loading/restarting/broken
_BACKPRESSURE = (429, 503)
_HOP_HEADERS = ("content-type", "retry-after")  # relayed from pod responses


class _HTTPServer(ThreadingHTTPServer):
    """The standard server with a listen backlog of 128, as the port's pods
    have (``dl/serve.py``): the stdlib's 5 resets connections under a
    burst."""

    request_queue_size = 128


class RouterMetrics:
    """Counter surface for GET /metrics; one lock, no I/O under it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests_total = 0
        self.routes: dict[str, int] = {}          # pod url -> relayed responses
        self.model_routes: dict[str, int] = {}    # model -> relayed responses
        self.failovers_total = 0                  # candidate skipped mid-plan
        self.severed_streams_total = 0            # client-visible severed streams
        self.streams_continued_total = 0          # mid-stream failovers spliced
        self.continuation_attempts_total = 0      # continuation dispatches
        self.continuation_failed_total = 0        # continuation exhausted
        self.drain_handoffs_total = 0             # proactive DRAINING hand-offs
        self.backpressure_relayed_total = 0       # plan exhausted on 429/503
        self.no_pod_total = 0                     # NoReadyPodError answered
        self.upstream_attempts_total = 0          # dispatches, retries included
        self.retry_budget_exhausted_total = 0     # failover stopped by budget
        self.breaker_skipped_total = 0            # candidates skipped while open
        self.admission_shed_total = 0             # 429s the admission layer sent

    def count(self, attr: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, attr, getattr(self, attr) + n)

    def routed(self, pod_url: str, model: str) -> None:
        with self._lock:
            self.routes[pod_url] = self.routes.get(pod_url, 0) + 1
            self.model_routes[model] = self.model_routes.get(model, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "routes": dict(self.routes),
                "model_routes": dict(self.model_routes),
                "failovers_total": self.failovers_total,
                "severed_streams_total": self.severed_streams_total,
                "streams_continued_total": self.streams_continued_total,
                "continuation_attempts_total": self.continuation_attempts_total,
                "continuation_failed_total": self.continuation_failed_total,
                "drain_handoffs_total": self.drain_handoffs_total,
                "backpressure_relayed_total": self.backpressure_relayed_total,
                "no_pod_total": self.no_pod_total,
                "upstream_attempts_total": self.upstream_attempts_total,
                "retry_budget_exhausted_total": self.retry_budget_exhausted_total,
                "breaker_skipped_total": self.breaker_skipped_total,
                "admission_shed_total": self.admission_shed_total,
            }


class FleetRouter:
    """Routing state shared by every handler thread."""

    def __init__(self, registry: PodRegistry, sticky: StickyTable | None = None,
                 rebalancer=None, default_model: str = "default",
                 request_timeout_s: float = 60.0,
                 connect_timeout_s: float = 5.0,
                 sticky_window_tokens: int = 0,
                 admission: AdmissionController | None = None,
                 retry_budget: RetryBudget | None = None,
                 breakers: BreakerBoard | None = None,
                 session=None, access_log: str = "",
                 access_log_max_bytes: int = 0) -> None:
        from modelx_tpu_torch.router.policy import DEFAULT_WINDOW_TOKENS

        self.registry = registry
        self.sticky = sticky or StickyTable()
        self.rebalancer = rebalancer
        self.default_model = default_model
        self.request_timeout_s = float(request_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.sticky_window_tokens = int(sticky_window_tokens) or DEFAULT_WINDOW_TOKENS
        # the overload-protection layer (router/admission.py): per-client
        # fair admission, Finagle-style retry budget, per-pod breakers —
        # the zero-knob defaults are all observe-only (accounting runs,
        # nothing queues, sheds, or skips)
        self.admission = admission or AdmissionController()
        self.retry_budget = retry_budget or RetryBudget()
        self.breakers = breakers or BreakerBoard()
        self.metrics = RouterMetrics()
        # windowed fleet rates: the counters above only ever
        # grow; these 1-s wheels answer "how fast RIGHT NOW" over 1m/5m
        self.rates = tswheel.RateSet(("requests", "http_5xx", "sheds"))
        # opt-in JSON-lines access log: one line per routed
        # request, request id as the join key against the pod's log
        self.access = accesslog.open_log(access_log,
                                         max_bytes=access_log_max_bytes)
        self._session = LazySession(session)
        self._inflight: dict[str, int] = {}
        self._inflight_lock = threading.Lock()
        self._stop = threading.Event()
        self._maint: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self.registry.start()
        if self.rebalancer is not None:
            self._maint = threading.Thread(
                target=self._maintenance, name="router-rebalance", daemon=True
            )
            self._maint.start()

    def close(self) -> None:
        self._stop.set()
        self.registry.stop()
        if self._maint is not None:
            self._maint.join(timeout=2.0)
        if self.access is not None:
            self.access.close()

    def _maintenance(self) -> None:
        while not self._stop.wait(self.registry.poll_interval_s):
            try:
                self.rebalancer.maybe_step()
            except Exception:
                # rebalancing is an optimization: a failed step must never
                # kill the loop (the action error counters carry the signal)
                logger.exception("rebalance step failed")

    # -- plumbing -------------------------------------------------------------

    def http(self):
        return self._session.get()

    def enter(self, pod_url: str) -> None:
        with self._inflight_lock:
            self._inflight[pod_url] = self._inflight.get(pod_url, 0) + 1

    def exit(self, pod_url: str) -> None:
        with self._inflight_lock:
            n = self._inflight.get(pod_url, 1)
            self._inflight[pod_url] = max(0, n - 1)

    def inflight(self) -> dict[str, int]:
        with self._inflight_lock:
            return dict(self._inflight)

    def pod_died(self, pod_url: str, reason: str) -> None:
        """Data-path death: quarantine + drop sticky assignments (the
        pod's prefix cache died with it). The breaker entry resets too —
        quarantine owns recovery now, and a stale OPEN state must not
        block the pod's first routed request after the poll restores it.

        Forgets are classified before dropping: a model whose prefix KV
        is registry-published (any pod's serving block shows
        published_total > 0, the dying pod's last row included) loses
        only placement, not state — the next pod installs the shared
        prefix from the registry (dl/kv_store.py) instead of
        re-prefilling it."""
        recoverable = {
            model
            for pod in self.registry.pods()
            for model in pod.serving
            if pod.kv_published(model)
        }
        self.registry.quarantine(pod_url, reason)
        self.sticky.forget_pod(pod_url, recoverable_models=recoverable)
        self.breakers.forget(pod_url)

    def budget_for(self, headers) -> float:
        """This request's total budget in seconds: the router's own
        --request-timeout, CLAMPED by an incoming ``X-ModelX-Deadline-Ms``
        (a chained router, or a client that knows its own patience) — the
        budget only ever shrinks as it crosses hops."""
        incoming = parse_deadline_ms(headers.get(DEADLINE_HEADER))
        if incoming is None:  # absent/malformed: the router's budget stands
            return self.request_timeout_s
        return min(self.request_timeout_s, incoming)

    def resolve_model(self, path: str, req: dict) -> str | None:
        """The model a request addresses; None = unroutable path."""
        if path in _OPENAI_PATHS:
            return str(req.get("model") or self.default_model)
        if path in _PLAIN_PATHS:
            return self.default_model
        parts = path.split("/")
        if (len(parts) == 4 and parts[1] == "v1"
                and parts[3] in ("generate", "forward") and parts[2]):
            return parts[2]
        return None

    def snapshot(self) -> dict:
        out = {
            "router": dict(self.metrics.snapshot(), **self.sticky.stats()),
            "pods": self.registry.snapshot(),
            "inflight": self.inflight(),
            "admission": self.admission.snapshot(),
            "retry_budget": self.retry_budget.snapshot(),
            "breakers": self.breakers.snapshot(),
            "rates": self.rates.snapshot(),
        }
        if self.rebalancer is not None:
            out["rebalance"] = self.rebalancer.snapshot()
        return out


def _error_body(path: str, e: ServingError) -> bytes:
    """One typed error, shaped for the surface it crosses: OpenAI paths
    get the ``{"error": {...}}`` object, native paths the flat form —
    identical to what a single pod would have answered."""
    if path in _OPENAI_PATHS:
        return json.dumps({"error": {
            "message": str(e), "type": e.api_type, "code": e.http_status,
        }}).encode()
    return json.dumps({"error": str(e)}).encode()


def _stream_error_payload(content_type: str, path: str, e: ServingError) -> bytes:
    body = _error_body(path, e)
    if "text/event-stream" in content_type:
        return b"data: " + body + b"\n\n"
    return body + b"\n"


def _query_param(path: str, name: str) -> str:
    """One query parameter from a request path ("" when absent)."""
    from urllib.parse import parse_qs, urlparse

    vals = parse_qs(urlparse(path).query).get(name)
    return vals[0] if vals else ""


# which snapshot-tree levels become Prometheus labels on GET /metrics
# (everything else flattens into the metric name)
_METRIC_LABELS = {
    ("router", "routes", "*"): "pod",
    ("router", "model_routes", "*"): "model",
    ("pods", "*"): "pod",
    ("inflight", "*"): "pod",
    ("breakers", "pods", "*"): "pod",
    ("admission", "clients", "*"): "client",
}


class _StreamSession:
    """Client side of ONE committed continuable stream, shared by every
    upstream attempt that feeds it (the original dispatch and any
    continuations after a sever).

    Continuable streams are the native single-row NDJSON token streams:
    the pod emits one ``{"tokens": [[t]]}`` line per token, so relaying
    COMPLETE lines only — partial lines buffer here and die with their
    upstream — keeps the client's wire at a token boundary at all times,
    and ``emitted`` is exactly the resume block a continuation must
    carry. A spliced stream is then byte-identical to an uninterrupted
    one. In-stream ``{"error": ...}`` lines from the pod (engine broke
    mid-decode, pod-side expiry) are HELD rather than relayed: a
    continuation may still save the stream, and the held line is the
    honest fallback when it can't."""

    def __init__(self, handler, path: str, seed: int,
                 base_emitted: list[int] | None = None) -> None:
        self._handler = handler
        self.path = path
        self.seed = int(seed)
        # the client's OWN resume block (it is continuing a stream some
        # earlier connection severed): those tokens are on the client's
        # wire already, so OUR continuations must prepend them
        self.base_emitted = [int(t) for t in (base_emitted or [])]
        self.committed = False
        self.content_type = "application/json"
        self.client_gone = False
        self.done = False              # the done line reached the client
        self.severed = False           # current upstream died mid-stream
        self.deadline_hit = False      # upstream read outran the deadline
        self.drain_handoff = False     # sever was a proactive drain pickup
        self.continued = False         # >= 1 continuation attempt relayed
        self.sever_pod = ""            # last pod that severed (for the 502)
        self.pod_error: bytes | None = None  # held in-stream error line
        self.emitted: list[int] = []   # token ids on the client's wire
        self._buf = b""

    def commit(self, content_type: str, extra_headers=()) -> None:
        if self.committed:
            return
        self.committed = True
        self.content_type = content_type
        h = self._handler
        h.send_response(200)
        h.send_header("Content-Type", content_type)
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Transfer-Encoding", "chunked")
        # the router's observability echo: the end-to-end request id and
        # the attempt number of the upstream actually feeding the client
        rid = getattr(h, "_rid", "")
        if rid:
            h.send_header(REQUEST_ID_HEADER, rid)
            h.send_header(ATTEMPT_HEADER, str(getattr(h, "_attempt_sent", 1)))
        for k, v in extra_headers:
            h.send_header(k, v)
        h.end_headers()

    def write(self, payload: bytes) -> None:
        if not payload or self.client_gone:
            return
        try:
            self._handler.wfile.write(f"{len(payload):x}\r\n".encode())
            self._handler.wfile.write(payload + b"\r\n")
        except OSError:
            self.client_gone = True

    def reset_for_attempt(self) -> None:
        """A new upstream is about to feed this stream: drop the dead
        upstream's partial line and sever mark (the client wire state —
        ``emitted``/``done`` — is exactly what carries over)."""
        self.severed = False
        self.pod_error = None
        self._buf = b""

    def feed(self, data: bytes) -> None:
        self._buf += data
        while not self.severed:
            line, sep, rest = self._buf.partition(b"\n")
            if not sep:
                break
            self._buf = rest
            self._feed_line(line + sep)

    def _feed_line(self, line: bytes) -> None:
        try:
            obj = json.loads(line)
        except ValueError:
            obj = None
        if isinstance(obj, dict) and "error" in obj:
            self.pod_error = line
            self.severed = True
            return
        if isinstance(obj, dict) and obj.get("done"):
            self.done = True
        elif isinstance(obj, dict) and isinstance(obj.get("tokens"), list):
            for row in obj["tokens"]:
                self.emitted.extend(int(t) for t in row)
        self.write(line)

    def resume_block(self) -> dict[str, str]:
        """The continuation headers: every token the CLIENT has, original
        effective seed — the pod re-prefills and rejoins the stream."""
        return resume_headers(self.base_emitted + self.emitted, self.seed)


def route_serve(router: FleetRouter, listen: str = ":8100") -> ThreadingHTTPServer:
    """Start the front door (mirrors dl/serve.serve: returns the live
    ThreadingHTTPServer; caller owns shutdown)."""
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def send_response(self, code, message=None):
            # captured for the access log: whatever status last went on
            # the wire is what the client saw
            self._resp_status = code
            super().send_response(code, message)

        def _obs_headers(self) -> None:
            """Echo the request id + attempt on router-authored responses
            (relayed pod responses carry the pod's own echo instead)."""
            rid = getattr(self, "_rid", "")
            if rid:
                self.send_header(REQUEST_ID_HEADER, rid)
                self.send_header(ATTEMPT_HEADER,
                                 str(getattr(self, "_attempt_sent", 1)))

        def _json(self, status: int, obj, headers: dict | None = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self._obs_headers()
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(body)
            except OSError:
                pass  # client went away; nothing to salvage

        def _text(self, status: int, text: str, content_type: str) -> None:
            body = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except OSError:
                pass

        def _serving_error(self, path: str, e: ServingError) -> None:
            body = _error_body(path, e)
            self.send_response(e.http_status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self._obs_headers()
            for k, v in e.headers().items():
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(body)
            except OSError:
                pass

        # -- reads ------------------------------------------------------------

        def do_GET(self):
            # keep-alive hygiene: a GET after a routed POST on the same
            # connection must not inherit that request's identity
            self._rid = ""
            self._resp_status = 0
            if self.path == "/healthz":
                ready = [p for p in router.registry.pods()
                         if p.healthy and p.ready_models()]
                if ready:
                    self._json(200, {"status": "ok", "ready_pods": len(ready)})
                else:
                    # the fleet may be booting/draining through a poll:
                    # tell the LB when to look again, like a pod would
                    self._json(503, {"status": "no-ready-pods"},
                               headers={"Retry-After": "2"})
            elif self.path == "/livez":
                # the router holds no device state and self-heals by
                # polling: alive as long as the process answers
                self._json(200, {"status": "ok"})
            elif self.path.split("?", 1)[0] == "/metrics":
                # content negotiation: Prometheus text format
                # on Accept: text/plain or ?format=prometheus, the JSON
                # snapshot otherwise
                payload = router.snapshot()
                fmt = _query_param(self.path, "format")
                if promexp.wants_prometheus(self.headers.get("Accept"), fmt):
                    self._text(200,
                               promexp.render(payload,
                                              label_levels=_METRIC_LABELS),
                               promexp.CONTENT_TYPE)
                else:
                    self._json(200, payload)
            elif self.path.split("?", 1)[0] == "/v1/trace":
                # span summary, pod-parity: ?prefix= narrows by span name,
                # ?request_id= narrows to one request's timeline
                self._json(200, trace.tracer().summary(
                    prefix=_query_param(self.path, "prefix"),
                    request_id=_query_param(self.path, "request_id")))
            elif self.path == "/v1/models":
                fleet = router.registry.models()
                self._json(200, {
                    "object": "list",
                    "data": [{"id": name, "object": "model"}
                             for name in sorted(fleet)],
                    "default": router.default_model,
                    "models": fleet,
                })
            else:
                self._json(404, {"error": "not found"})

        # -- proxy ------------------------------------------------------------

        def do_POST(self):
            router.metrics.count("requests_total")
            # end-to-end request identity: honor a well-formed
            # client-supplied id (a chained router, a client correlating
            # its own logs), mint otherwise; every upstream dispatch for
            # this request carries the SAME id with an incrementing
            # attempt counter
            self._rid = (parse_request_id(self.headers.get(REQUEST_ID_HEADER))
                         or mint_request_id())
            self._attempt_next = parse_attempt(self.headers.get(ATTEMPT_HEADER))
            self._attempt_sent = self._attempt_next
            self._resp_status = 0
            self._decision = ""
            self._pod_url = ""
            self._log_model = ""
            t0 = time.monotonic()
            try:
                with trace.request_context(self._rid), \
                        trace.span("router.request", http_path=self.path):
                    self._do_POST()
            finally:
                # windowed rates: outcome classes off the
                # committed status, same capture point as the access log
                router.rates.mark("requests")
                if self._resp_status >= 500:
                    router.rates.mark("http_5xx")
                elif self._resp_status == 429:
                    router.rates.mark("sheds")
                if router.access is not None:
                    router.access.write(
                        request_id=self._rid,
                        attempt=self._attempt_sent,
                        client=client_key(self.headers, self.client_address),
                        path=self.path,
                        model=self._log_model,
                        status=self._resp_status,
                        ms=round((time.monotonic() - t0) * 1e3, 3),
                        route=self._decision or "unrouted",
                        pod=self._pod_url,
                    )

        def _do_POST(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length) if length else b""
            try:
                req = json.loads(raw) if raw else {}
            except ValueError as e:
                return self._json(400, {"error": f"bad request: {e}"})
            if not isinstance(req, dict):
                return self._json(400, {"error": "request body must be a JSON object"})
            model = router.resolve_model(self.path, req)
            if model is None:
                return self._json(404, {"error": "not found"})
            self._log_model = model
            # the overload-protection front gate: fairness identity +
            # priority class feed the admission controller BEFORE any pod
            # sees the request; the deadline clamps to an incoming
            # X-ModelX-Deadline-Ms so a chained hop never re-grants budget
            client = client_key(self.headers, self.client_address)
            priority = parse_priority(self.headers.get(PRIORITY_HEADER))
            budget = router.budget_for(self.headers)
            deadline = time.monotonic() + budget
            try:
                router.admission.admit(client, priority=priority,
                                       deadline=deadline, budget_s=budget)
            except ServingError as e:
                # 429 = overload shed; 504 = the caller's own budget
                # expired while queued (same status the routing loop
                # would answer a moment later)
                if isinstance(e, QueueFullError):
                    router.metrics.count("admission_shed_total")
                return self._serving_error(self.path, e)
            try:
                self._route(model, req, raw, deadline, budget, priority)
            except ServingError as e:
                self._serving_error(self.path, e)
            finally:
                router.admission.release(client)

        def _route(self, model: str, req: dict, raw: bytes,
                   deadline: float, budget: float, priority: str) -> None:
            """Walk the failover plan until one pod's response is relayed.
            Raises typed ServingErrors (mapped by the caller); relays pod
            statuses — success AND deterministic errors — verbatim.
            Failover attempts beyond the first draw from the retry
            budget, and candidates with an OPEN breaker are skipped."""
            keys = sticky_keys(model, req, self.path,
                               window_tokens=router.sticky_window_tokens)
            stream = bool(req.get("stream", False))
            # mid-stream failover continuation applies to the native
            # single-row NDJSON token stream: the pod frames one token
            # per line, so the router can account exactly which ids are
            # on the client's wire and resume token-exactly. The
            # effective seed is the request's (or its own resume block's
            # — a client continuing an already-continued stream).
            sess = None
            if stream and self.path not in _OPENAI_PATHS:
                toks = req.get("tokens")
                continuable = isinstance(toks, list) and len(toks) == 1
                seed, base = 0, []
                if continuable:
                    try:
                        seed = int(req.get("seed", 0) or 0)
                        rz = req.get("resume")
                        if isinstance(rz, dict):
                            parsed = parse_resume(rz.get("emitted"),
                                                  rz.get("seed"))
                            if parsed is not None:
                                base, seed = list(parsed[0]), parsed[1]
                    except (ServingError, TypeError, ValueError):
                        # the pod types the 400; nothing to continue
                        continuable = False
                if continuable:
                    sess = _StreamSession(self, self.path, seed,
                                          base_emitted=base)
            plan = plan_route(model, router.registry.candidates(model),
                              router.sticky, keys, router.inflight())
            # for the access log's route decision: was the served pod the
            # sticky assignment, a load-balanced pick, or a failover?
            sticky_url = router.sticky.lookup(keys, [p.url for p in plan])
            if not plan:
                # mirror the single-pod routing contract: a name no
                # pod has ever heard of 404s; DRAINING everywhere is 409;
                # LOADING/PULLING/FAILED — or READY on pods that are all
                # demoted right now — is the retryable 503 + Retry-After
                state = router.registry.known_state(model)
                if state is None:
                    # typed so the OpenAI surface gets its error OBJECT
                    # shape (a pod's 404 is oai.APIError-shaped there)
                    raise ModelUnloadedError(model)
                if state == "DRAINING":
                    raise ModelDrainingError(model)
                router.metrics.count("no_pod_total")
                raise NoReadyPodError(model, detail=f"fleet state: {state}")
            last_bp = None  # (status, body, headers) of the last 429/503
            attempted = False
            for pod in plan:
                if not router.breakers.allow(pod.url):
                    # breaker OPEN: this pod is mid-5xx-burst; skip it
                    # without spending deadline or a retry token on it
                    router.metrics.count("breaker_skipped_total")
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # the 504 names the budget that ACTUALLY applied —
                    # which an incoming deadline header may have clamped
                    # below the router's own --request-timeout
                    raise DeadlineExceededError("routing", budget)
                was_first = not attempted
                if not attempted:
                    router.retry_budget.record_attempt()
                elif not router.retry_budget.allow_retry():
                    # brownout protection: sustained failover is capped at
                    # the budget's ratio of recent traffic — degrade to
                    # ~one upstream attempt per request, no retry storms
                    router.metrics.count("retry_budget_exhausted_total")
                    break
                attempted = True
                router.enter(pod.url)
                try:
                    status, bp = self._try_pod(pod, raw, stream, remaining,
                                               priority, sess)
                finally:
                    router.exit(pod.url)
                if status is not None:
                    self._pod_url = pod.url
                    if not was_first:
                        self._decision = "failover"
                    elif pod.url == sticky_url:
                        self._decision = "sticky"
                    else:
                        self._decision = "balanced"
                    router.metrics.routed(pod.url, model)
                    live = router.registry.pod(pod.url)
                    if status == 200 and live is not None and live.healthy:
                        # only successful work on a still-live pod warms
                        # its prefix cache; a relayed 400/404 — or a 200
                        # whose stream the pod severed (it is quarantined
                        # by now) — must not pin the conversation there
                        router.sticky.assign(keys, pod.url)
                    if sess is not None and sess.committed:
                        # a continuable stream's endgame: continue a
                        # severed one within the remaining deadline +
                        # retry budget, then write the one terminator
                        self._finish_stream(model, keys, sess, raw,
                                            deadline, budget, priority)
                    return
                if bp is not None:
                    last_bp = bp
                router.metrics.count("failovers_total")
            # plan exhausted: backpressure propagates verbatim (the pods'
            # Retry-After is the fleet's honest answer); pure connection
            # failure becomes the typed no-pod 503
            if router.rebalancer is not None:
                router.rebalancer.observe_shed(model)
            if last_bp is not None:
                status, body, headers = last_bp
                router.metrics.count("backpressure_relayed_total")
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except OSError:
                    pass
                return
            router.metrics.count("no_pod_total")
            raise NoReadyPodError(model, detail="every candidate failed")

        def _try_pod(self, pod, raw: bytes, stream: bool, remaining: float,
                     priority: str, sess=None):
            """One dispatch. Returns (status, backpressure): ``status``
            non-None when a response (any status outside the backpressure
            set) went to the client; ``backpressure`` carries a 429/503
            for the exhausted-plan path. (None, None) = connection-level
            failure, pod quarantined.

            Every attempt stamps the REMAINING deadline budget
            (X-ModelX-Deadline-Ms) and the priority class upstream: a
            failover attempt never re-grants the pod a fresh full
            timeout, and the pod's engine stops decoding for callers
            whose budget is gone (dl/serve.py honors the header)."""
            router.metrics.count("upstream_attempts_total")
            attempt = self._attempt_next
            self._attempt_next += 1
            self._attempt_sent = attempt
            try:
                resp = router.http().request(
                    "POST", pod.url + self.path, data=raw,
                    headers={
                        "Content-Type": "application/json",
                        DEADLINE_HEADER: str(max(1, int(remaining * 1000))),
                        PRIORITY_HEADER: priority,
                        REQUEST_ID_HEADER: self._rid,
                        ATTEMPT_HEADER: str(attempt),
                    },
                    stream=True,
                    timeout=(router.connect_timeout_s, remaining),
                )
            except ReadTimeout:
                # the pod ACCEPTED and is just slower than the remaining
                # deadline: the request's problem, not the pod's — no
                # quarantine (that would cascade a slow query into
                # fleet-wide sticky-cache loss); the plan loop's deadline
                # check turns this into the client's 504
                return None, None
            except TransportError as e:
                router.pod_died(pod.url, f"dispatch: {e}")
                return None, None
            try:
                if resp.status_code in _BACKPRESSURE:
                    try:
                        body = resp.content
                    except TransportError as e:
                        # the pod died while we read its 429/503 body:
                        # that's a connection failure, not backpressure
                        router.pod_died(pod.url, f"backpressure body: {e}")
                        return None, None
                    bp = (
                        resp.status_code,
                        body,
                        [(k, v) for k, v in resp.headers.items()
                         if k.lower() in _HOP_HEADERS],
                    )
                    # a 429/503 is a pod working CORRECTLY under load:
                    # backpressure must never trip the 5xx breaker
                    router.breakers.record(pod.url, True)
                    return None, bp
                if stream and resp.status_code == 200:
                    if sess is not None:
                        ok = self._relay_continuable(pod, resp, sess)
                    else:
                        ok = self._relay_stream(pod, resp)
                else:
                    ok = self._relay_buffered(pod, resp)
                if ok:
                    # unexpected 5xx answers feed the pod's breaker (the
                    # non-connection failure signal quarantine can't see).
                    # 504 is exempt like 429/503: a pod expiring requests
                    # whose PROPAGATED budget ran out is honoring this
                    # PR's deadline contract, not malfunctioning — tight
                    # caller deadlines must not open a healthy breaker.
                    # Relay-failure paths settle elsewhere — death
                    # quarantines + forgets, a slow read stays neutral
                    router.breakers.record(
                        pod.url,
                        resp.status_code < 500 or resp.status_code == 504)
                return (resp.status_code if ok else None), None
            finally:
                resp.close()

        def _relay_buffered(self, pod, resp) -> bool:
            """Non-streaming relay: buffer the whole pod body first — a
            pod death mid-body lands HERE, before anything commits to the
            client, so the caller can retry the next candidate (zero
            dropped non-streaming requests under pod kill)."""
            try:
                body = resp.content
            except ReadTimeout:
                # slow pod, not dead pod: no quarantine; nothing committed,
                # so the plan loop's deadline check answers the 504
                return False
            except TransportError as e:
                router.pod_died(pod.url, f"body read: {e}")
                return False
            self.send_response(resp.status_code)
            relayed = set()
            for k, v in resp.headers.items():
                kl = k.lower()
                # x-modelx-* responses carry the pod's observability echo
                # (request id, attempt, per-phase timing): the router is
                # transparent to it, like the body
                if kl in _HOP_HEADERS or kl.startswith("x-modelx-"):
                    self.send_header(k, v)
                    relayed.add(kl)
            if REQUEST_ID_HEADER.lower() not in relayed:
                self._obs_headers()  # pod predates the echo: router's own
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except OSError:
                pass  # client went away after the pod did its work
            return True

        def _relay_stream(self, pod, resp) -> bool:
            """Streaming relay, chunk-for-chunk. The FIRST chunk is pulled
            before the 200 commits (immediate pod death still fails over);
            after commitment a severed pod writes the typed
            UpstreamSeveredError payload in-stream, then the terminator —
            the client always learns the stream is incomplete."""
            content_type = resp.headers.get("Content-Type", "application/json")
            it = resp.iter_content(chunk_size=None)
            try:
                first = next(it, b"")
            except TransportError as e:
                router.pod_died(pod.url, f"stream open: {e}")
                return False
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            relayed = set()
            for k, v in resp.headers.items():
                if k.lower().startswith("x-modelx-"):
                    self.send_header(k, v)
                    relayed.add(k.lower())
            if REQUEST_ID_HEADER.lower() not in relayed:
                self._obs_headers()
            self.end_headers()

            def write_chunk(payload: bytes) -> None:
                if not payload:
                    return
                self.wfile.write(f"{len(payload):x}\r\n".encode())
                self.wfile.write(payload + b"\r\n")

            try:
                try:
                    write_chunk(first)
                    for chunk in it:
                        write_chunk(chunk)
                except ReadTimeout:
                    # the pod is alive but a token gap outran the deadline:
                    # typed in-stream 504, no quarantine (the pod keeps its
                    # warm caches; only THIS stream is over budget)
                    err = DeadlineExceededError(
                        "streaming", router.request_timeout_s)
                    write_chunk(_stream_error_payload(
                        content_type, self.path, err))
                except TransportError as e:
                    # the pod died with bytes already relayed: typed error
                    # event, quarantine, count — NEVER a silent truncation
                    router.pod_died(pod.url, f"mid-stream: {e}")
                    router.metrics.count("severed_streams_total")
                    err = UpstreamSeveredError(pod.url, type(e).__name__)
                    logger.warning("stream severed: %s", err)
                    write_chunk(_stream_error_payload(
                        content_type, self.path, err))
            except OSError:
                pass  # client went away mid-relay
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
            return True

        # -- stream continuation -------------------------------

        def _relay_continuable(self, pod, resp, sess) -> bool:
            """One upstream attempt feeding a continuable stream. The
            first chunk is pulled before the 200 commits (an immediately
            dying pod still fails over from scratch); after that the
            session relays complete token lines and this method only
            CLASSIFIES how the attempt ended — sever, drain hand-off,
            deadline — for ``_finish_stream``/``_continue_stream`` to
            act on. Returns False only when nothing was relayed and the
            pod died opening the stream."""
            content_type = resp.headers.get("Content-Type",
                                            "application/json")
            it = resp.iter_content(chunk_size=None)
            try:
                first = next(it, b"")
            except TransportError as e:
                router.pod_died(pod.url, f"stream open: {e}")
                return False
            skip = (REQUEST_ID_HEADER.lower(), ATTEMPT_HEADER.lower())
            sess.commit(content_type, extra_headers=[
                (k, v) for k, v in resp.headers.items()
                if k.lower().startswith("x-modelx-")
                and k.lower() not in skip])
            sess.reset_for_attempt()
            try:
                sess.feed(first)
                for chunk in it:
                    if sess.severed or sess.client_gone or sess.done:
                        break
                    live = router.registry.pod(pod.url)
                    if (live is not None and live.status == "draining"
                            and not sess.done):
                        # coordinated drain: the pod asked to be relieved
                        # (SIGTERM -> /healthz "draining"); hand its live
                        # stream off NOW instead of waiting for either
                        # completion or the socket to die
                        sess.severed = True
                        sess.drain_handoff = True
                        sess.sever_pod = pod.url
                        router.metrics.count("drain_handoffs_total")
                        break
                    sess.feed(chunk)
            except ReadTimeout:
                # alive-but-slow: the deadline is gone; no continuation
                # could finish in time, and no quarantine (the pod keeps
                # its warm caches)
                sess.deadline_hit = True
            except TransportError as e:
                router.pod_died(pod.url, f"mid-stream: {e}")
                sess.severed = True
                sess.sever_pod = pod.url
            return True

        def _finish_stream(self, model: str, keys, sess, raw: bytes,
                           deadline: float, budget: float,
                           priority: str) -> None:
            """Endgame of a committed continuable stream: run the
            continuation loop if the upstream severed, then write
            whatever typed payload is still owed and the ONE chunked
            terminator."""
            if sess.severed and not sess.done:
                self._continue_stream(model, keys, sess, raw, deadline,
                                      priority)
            if sess.continued:
                self._decision = "continuation"
            if sess.done:
                if sess.continued:
                    router.metrics.count("streams_continued_total")
            elif sess.deadline_hit and not sess.client_gone:
                err = DeadlineExceededError("streaming", budget)
                sess.write(_stream_error_payload(
                    sess.content_type, self.path, err))
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

        def _continue_stream(self, model: str, keys, sess, raw: bytes,
                             deadline: float, priority: str) -> None:
            """The stream severed with bytes committed: re-plan within
            the REMAINING deadline and the shared retry budget (a
            continuation IS a failover attempt — it spends the budget,
            never bypasses it), re-issue the ORIGINAL body with the
            resume block set to the tokens already on the client's wire,
            and let the session splice the continuation line-for-line.
            Loops on repeated severs until the stream completes or
            continuation is exhausted — only then does the client see
            the typed severed payload (or the pod's own held in-stream
            error, which is the more honest story when the pod reported
            one before dying)."""
            reason = "exhausted"
            while sess.severed and not sess.done and not sess.client_gone:
                if deadline - time.monotonic() <= 0:
                    reason = "deadline expired"
                    break
                if not router.retry_budget.allow_retry():
                    router.metrics.count("retry_budget_exhausted_total")
                    reason = "retry budget exhausted"
                    break
                plan = plan_route(model, router.registry.candidates(model),
                                  router.sticky, keys, router.inflight())
                hdrs = sess.resume_block()
                outcome = "none"
                for pod in plan:
                    if not router.breakers.allow(pod.url):
                        router.metrics.count("breaker_skipped_total")
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    router.enter(pod.url)
                    try:
                        outcome = self._try_continue(pod, raw, sess,
                                                     remaining, priority,
                                                     hdrs)
                    finally:
                        router.exit(pod.url)
                    if outcome == "complete":
                        # resume refused with 422: the original stream
                        # already emitted its LAST token — every byte the
                        # client is owed is on its wire; finish it
                        sess.write(b'{"done": true}\n')
                        sess.done = True
                        sess.continued = True
                        router.metrics.routed(pod.url, model)
                        break
                    if outcome == "relayed":
                        sess.continued = True
                        router.metrics.routed(pod.url, model)
                        if not sess.severed:
                            live = router.registry.pod(pod.url)
                            if live is not None and live.healthy:
                                # the continuation pod holds the warm
                                # prefix now; pin the conversation there
                                router.sticky.assign(keys, pod.url)
                        break
                    if outcome == "refused":
                        break
                    # "next": this candidate shed/died before relaying
                    # anything; the sess is untouched — try another
                if outcome == "refused":
                    # a 400 on the resume block is deterministic: every
                    # other pod speaks the same contract, retrying would
                    # just burn the budget
                    reason = "resume refused"
                    break
                if outcome == "none":
                    reason = "no candidate"
                    break
            if sess.done or sess.client_gone:
                return
            if sess.deadline_hit:
                return  # _finish_stream writes the typed 504
            router.metrics.count("continuation_failed_total")
            router.metrics.count("severed_streams_total")
            if sess.pod_error is not None:
                sess.write(sess.pod_error)
                return
            err = UpstreamSeveredError(sess.sever_pod or "fleet",
                                       f"continuation {reason}")
            logger.warning("stream severed: %s", err)
            sess.write(_stream_error_payload(
                sess.content_type, self.path, err))

        def _try_continue(self, pod, raw: bytes, sess, remaining: float,
                          priority: str, hdrs: dict) -> str:
            """One continuation dispatch. Returns ``"relayed"`` (the
            attempt fed the stream — the sess says how it ended),
            ``"complete"`` (422: the original stream was already done),
            ``"refused"`` (400: the resume block itself is rejected —
            deterministic, stop), or ``"next"`` (shed/died before
            relaying anything; another candidate may serve)."""
            router.metrics.count("upstream_attempts_total")
            router.metrics.count("continuation_attempts_total")
            # a continuation is a failover attempt of the SAME request:
            # same id, next attempt number — the pods' logs and span
            # timelines join on the id across the splice
            attempt = self._attempt_next
            self._attempt_next += 1
            self._attempt_sent = attempt
            try:
                resp = router.http().request(
                    "POST", pod.url + self.path, data=raw,
                    headers={
                        "Content-Type": "application/json",
                        DEADLINE_HEADER: str(max(1, int(remaining * 1000))),
                        PRIORITY_HEADER: priority,
                        REQUEST_ID_HEADER: self._rid,
                        ATTEMPT_HEADER: str(attempt),
                        **hdrs,
                    },
                    stream=True,
                    timeout=(router.connect_timeout_s, remaining),
                )
            except ReadTimeout:
                return "next"  # slow, not dead: the loop's deadline
                # check settles it; no quarantine
            except TransportError as e:
                router.pod_died(pod.url, f"continuation dispatch: {e}")
                return "next"
            try:
                if resp.status_code in _BACKPRESSURE:
                    router.breakers.record(pod.url, True)
                    return "next"
                if resp.status_code == 422:
                    router.breakers.record(pod.url, True)
                    return "complete"
                if resp.status_code != 200:
                    # 400 malformed resume — or any other deterministic
                    # refusal: the contract is broken, not the pod
                    router.breakers.record(pod.url, resp.status_code < 500)
                    return "refused"
                return ("relayed"
                        if self._relay_continuable(pod, resp, sess)
                        else "next")
            finally:
                resp.close()

    host, _, port = listen.rpartition(":")
    httpd = _HTTPServer((host or "0.0.0.0", int(port)), Handler)
    httpd.daemon_threads = True
    # tighter shutdown poll than the stdlib default: the router restarts
    # (and test teardowns) should not idle half a second per instance
    t = threading.Thread(target=lambda: httpd.serve_forever(poll_interval=0.1),
                         name="router-http", daemon=True)
    t.start()
    return httpd
