"""PyTorch serving sidecar (counterpart of ``modelx_tpu/dl/serve.py``).

Loads one or more checkpoints onto one device and serves:

    GET  /healthz               readiness (200 once every model is loaded)
    GET  /v1/models             model inventory + per-model stats
    POST /v1/forward            default model      {"tokens": [[...]]}
                                -> {"logits_argmax": [[...]]}
    POST /v1/generate           default model      + {"max_new_tokens": N}
                                -> {"tokens": [[prompt + generated]]}
    POST /v1/{model}/forward    named model
    POST /v1/{model}/generate   named model

Requests are checked as the JAX sidecar checks them (2-D non-empty token
ids inside the vocab, ``max_new_tokens`` in [1, limit], text and tokens
never together) and answered with the same keys, so a client sees the same
JSON from either package. What later slices port answers a typed 501
that names the slice: sampling (``temperature`` > 0), ``stream`` and
resume, text in/out, the OpenAI routes and the admin routes. Dynamic and
continuous batching have no flag yet: requests run one at a time.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from modelx_tpu_torch.device import parse_dtype, resolve_device
from modelx_tpu_torch.dl import families as fam

logger = logging.getLogger("modelx.serve")

# /v1/generate decode budget an unauthenticated client may request; bounds
# the KV cache a single request allocates
MAX_NEW_TOKENS_LIMIT = 1024

_MODEL_ROUTE = re.compile(r"^/v1/(?P<model>[A-Za-z0-9._-]+)/(?P<verb>forward|generate)$")


class NotPortedError(Exception):
    """A request for something a later slice of the port brings."""

    http_status = 501

    def __init__(self, feature: str, slice_name: str) -> None:
        super().__init__(
            f"{feature} is not ported to modelx_tpu_torch yet; it comes with "
            f"the {slice_name} slice"
        )
        self.feature = feature
        self.slice_name = slice_name

    def payload(self) -> dict:
        return {"error": str(self), "type": "not_ported", "slice": self.slice_name}


class ModelServer:
    """One loaded model: params on one device and its entry points."""

    # the shape a lone first request is padded to upstream (seq to a
    # multiple of 16): one cache-free forward at load builds the attention
    # kernel and warms the allocator, so the first request meets them ready
    WARMUP_TOKEN_SHAPES = ((1, 16),)

    def __init__(self, model_dir: str, dtype: str = "bfloat16", device=None,
                 max_seq_len: int = 2048, name: str = "default") -> None:
        self.name = name
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.dtype = parse_dtype(dtype)
        self.max_seq_len = int(max_seq_len)
        self.ready = False
        self.load_error: str | None = None
        self.stats: dict = {"requests": 0, "tokens_generated": 0}
        self.cfg = None
        self.family: fam.Family | None = None
        self.params: dict | None = None
        # one request at a time on the device: concurrent handler threads
        # would interleave on the stream and stack their activations
        self._device_lock = threading.Lock()

    def load(self) -> dict:
        """Load every *.safetensors under model_dir onto the device; the
        checkpoint headers determine the architecture."""
        from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors
        from modelx_tpu_torch.dl.safetensors import read_header_from_file

        t0 = time.monotonic()
        paths = sorted(glob.glob(os.path.join(self.model_dir, "*.safetensors")))
        if not paths:
            raise FileNotFoundError(f"no safetensors under {self.model_dir}")
        infos_all: dict = {}
        for path in paths:
            infos, _ = read_header_from_file(path)
            infos_all.update(infos)
        self.family = fam.detect(list(infos_all))
        abstract = {
            n: (t.to(self.dtype) if t.is_floating_point() else t)
            for n, t in fam.abstract_params(infos_all).items()
        }
        self.cfg = self.family.infer_config(abstract)
        # rope_theta overrides apply; unimplemented rope_scaling refuses
        # BEFORE the weights stream to the device
        sidecar = fam.sidecar_config(self.model_dir)
        if sidecar is not None:
            self.cfg = fam.apply_sidecar_config(self.cfg, sidecar, self.family.name)
        params: dict = {}
        total = 0
        for path in paths:
            src = LocalFileSource(path)
            try:
                arrays, lstats = load_safetensors(src, self.device, dtype=self.dtype)
            finally:
                src.close()
            params.update(arrays)
            total += lstats.bytes_to_device
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.params = params
        seconds = time.monotonic() - t0
        self.stats["family"] = self.family.name
        self.stats["device"] = str(self.device)
        self.stats["dtype"] = str(self.dtype).removeprefix("torch.")
        self.stats["load_seconds"] = round(seconds, 3)
        self.stats["load_bytes"] = total
        self.stats["load_gbps"] = round(total / max(seconds, 1e-9) / 1e9, 3)
        for shape in self.WARMUP_TOKEN_SHAPES:
            self.forward_argmax(np.zeros(shape, np.int64))
        self.stats["ready_seconds"] = round(time.monotonic() - t0, 3)
        self.ready = True
        return dict(self.stats)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)

    def forward_argmax(self, tokens: np.ndarray) -> np.ndarray:
        """Argmax of the cache-free forward's logits, [B, S]."""
        with self._device_lock, torch.inference_mode():
            logits = self.family.forward(self.params, self._tokens(tokens), self.cfg)
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16) -> np.ndarray:
        """Greedy decode; returns [B, S + max_new_tokens] (prompt + new).
        Sampling comes with the sampling/streaming slice."""
        if self.family.generate is None:
            raise ValueError(f"family {self.family.name} is not generative")
        with self._device_lock, torch.inference_mode():
            out = self.family.generate(self.params, self._tokens(tokens), self.cfg,
                                       max_new_tokens=max_new_tokens)
            out = out.to(torch.int32).cpu().numpy()
        self.stats["tokens_generated"] += int(out.shape[0] * max_new_tokens)
        return out

    def generate_ragged(self, tokens: np.ndarray, row_lens: np.ndarray,
                        max_new_tokens: int) -> np.ndarray:
        """Ragged-batch greedy decode: right-padded rows [B, S] with per-row
        real lengths. Returns generated tokens only, [B, max_new_tokens]."""
        if self.family.generate_ragged is None:
            raise ValueError(f"family {self.family.name} has no ragged decode")
        with self._device_lock, torch.inference_mode():
            out = self.family.generate_ragged(
                self.params, self._tokens(tokens),
                torch.as_tensor(np.asarray(row_lens, np.int64), device=self.device),
                self.cfg, max_new_tokens=max_new_tokens)
            return out.to(torch.int32).cpu().numpy()


class ServerSet:
    """Named ModelServers behind one HTTP front."""

    def __init__(self, servers: dict[str, ModelServer], default: str | None = None) -> None:
        if not servers:
            raise ValueError("no models")
        self.servers = servers
        for name, s in servers.items():
            s.name = name  # route key and server identity must agree
        self.default = default or next(iter(servers))

    @property
    def ready(self) -> bool:
        return all(s.ready for s in self.servers.values())

    def load_all(self) -> dict:
        """Load every model in turn; a model that fails is reported on
        /healthz and /v1/models while the others serve. Raises only when
        every model failed."""
        errs = {}
        for name, s in self.servers.items():
            try:
                s.load()
            except Exception as e:
                logger.exception("loading %s failed", name)
                s.load_error = f"{type(e).__name__}: {e}"
                errs[name] = e
        if errs and len(errs) == len(self.servers):
            name, err = next(iter(errs.items()))
            raise RuntimeError(f"loading {name} failed: {err}") from err
        return {n: dict(s.stats, **({"error": s.load_error} if s.load_error else {}))
                for n, s in self.servers.items()}

    def resolve(self, path: str) -> tuple[ModelServer | None, str | None]:
        """(server, verb) for a POST path; (None, None) if unroutable."""
        if path in ("/v1/forward", "/v1/generate"):
            server = self.servers.get(self.default)
            return server, (path.rsplit("/", 1)[1] if server else None)
        m = _MODEL_ROUTE.match(path)
        if m and m.group("model") in self.servers:
            return self.servers[m.group("model")], m.group("verb")
        return None, None

    def models_payload(self) -> dict:
        models = {}
        for n, s in self.servers.items():
            d = {"ready": s.ready, **s.stats}
            if s.load_error:
                d["error"] = s.load_error
            models[n] = d
        return {
            "default": self.default,
            "models": models,
            "object": "list",
            "data": [{"id": n, "object": "model", "owned_by": "modelx"}
                     for n in self.servers],
        }


def _check_generate(req: dict, tokens: np.ndarray, vocab: int, server: ModelServer):
    """(max_new_tokens, stop ids) of a generate request, or (status, body)."""
    try:
        n = int(req.get("max_new_tokens", 16))
    except (TypeError, ValueError):
        return None, (400, {"error": "max_new_tokens must be an integer"})
    if not (1 <= n <= MAX_NEW_TOKENS_LIMIT):
        return None, (400, {"error": f"max_new_tokens must be in [1, {MAX_NEW_TOKENS_LIMIT}]"})
    if tokens.shape[1] + n > server.max_seq_len:
        return None, (400, {"error": f"prompt ({tokens.shape[1]}) + max_new_tokens ({n}) "
                                     f"exceeds --max-seq-len {server.max_seq_len}"})
    try:
        samp = {
            "temperature": float(req.get("temperature", 0.0)),
            "top_k": int(req.get("top_k", 0)),
            "top_p": float(req.get("top_p", 1.0)),
            "seed": int(req.get("seed", 0)),
        }
    except (TypeError, ValueError):
        return None, (400, {"error": "temperature/top_k/top_p/seed must be numbers"})
    if (
        not (0.0 <= samp["temperature"] <= 100.0)
        or not (0 <= samp["top_k"] < 2**31)
        or not (0.0 < samp["top_p"] <= 1.0)
        or not (0 <= samp["seed"] < 2**31)
    ):
        return None, (400, {"error": "temperature in [0,100], top_k/seed in "
                                     "[0, 2^31), top_p in (0,1] required"})
    stop_ids = req.get("stop_token_ids")
    if stop_ids is not None and (
        not isinstance(stop_ids, list)
        or len(stop_ids) > 16
        or not all(isinstance(t, int) and not isinstance(t, bool)
                   and 0 <= t < (vocab or 2**31) for t in stop_ids)
    ):
        return None, (400, {"error": "stop_token_ids must be a list of up "
                                     "to 16 in-vocab token ids"})
    if samp["temperature"] > 0:
        raise NotPortedError("sampling (temperature > 0)", "sampling/streaming")
    if req.get("resume") is not None:
        raise NotPortedError("stream resume", "sampling/streaming")
    if bool(req.get("stream", False)):
        raise NotPortedError("stream", "sampling/streaming")
    return (n, stop_ids), None


def serve(servers: ModelServer | ServerSet, listen: str = ":8000") -> ThreadingHTTPServer:
    """Start the HTTP front on a daemon thread; returns the server (call
    ``shutdown()`` to stop it)."""
    sset = servers if isinstance(servers, ServerSet) else ServerSet({servers.name: servers})

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, status: int, obj, headers: dict | None = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                failed = {n: s.load_error for n, s in sset.servers.items() if s.load_error}
                if sset.ready:
                    self._json(200, {"status": "ok"})
                elif failed and all(s.ready or s.load_error for s in sset.servers.values()):
                    ok = len(failed) < len(sset.servers)
                    self._json(200 if ok else 503,
                               {"status": "degraded" if ok else "failed", "failed": failed})
                else:
                    self._json(503, {"status": "loading"}, headers={"Retry-After": "2"})
            elif self.path == "/v1/models":
                self._json(200, sset.models_payload())
            elif self.path.startswith("/admin/"):
                e = NotPortedError("the admin surface", "registry deploy")
                self._json(e.http_status, e.payload())
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            if self.path.startswith("/admin/"):
                e = NotPortedError("the admin surface", "registry deploy")
                return self._json(e.http_status, e.payload())
            self._json(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            try:
                req = json.loads(self.rfile.read(length)) if length else {}
            except ValueError as e:
                return self._json(400, {"error": f"bad request: {e}"})
            if not isinstance(req, dict):
                return self._json(400, {"error": "request body must be a JSON object"})
            path = self.path.split("?", 1)[0]
            if path.startswith("/admin/"):
                e = NotPortedError("the admin surface", "registry deploy")
                return self._json(e.http_status, e.payload())
            if path in ("/v1/completions", "/v1/chat/completions"):
                e = NotPortedError("the OpenAI surface", "sampling/streaming")
                return self._json(e.http_status, e.payload())
            server, verb = sset.resolve(path)
            if server is None:
                return self._json(404, {"error": "not found"})
            if "text" in req and "tokens" in req:
                return self._json(400, {"error": "send either text or tokens, not both"})
            if "text" in req and verb != "generate":
                return self._json(400, {"error": "text is only supported on generate"})
            if "text" in req:
                e = NotPortedError("text in/out (tokenizer.json)", "sampling/streaming")
                return self._json(e.http_status, e.payload())
            try:
                tokens = np.asarray(req["tokens"], np.int32)
                if tokens.ndim != 2 or tokens.shape[0] < 1 or tokens.shape[1] < 1:
                    raise ValueError(
                        f"tokens must be non-empty 2-D [batch, seq], got shape {tokens.shape}"
                    )
            except (ValueError, KeyError, TypeError, OverflowError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            if server.load_error:
                return self._json(503, {"error": f"model {server.name} failed to load: "
                                                 f"{server.load_error}"})
            if not server.ready:
                return self._json(503, {"error": f"model {server.name} is loading"},
                                  headers={"Retry-After": "2"})
            vocab = getattr(server.cfg, "vocab_size", 0) or 0
            if vocab and (int(tokens.min()) < 0 or int(tokens.max()) >= vocab):
                # the embedding gather would raise on the card (JAX's clamps)
                return self._json(400, {"error": f"token ids must be in [0, {vocab})"})
            server.stats["requests"] += 1
            try:
                if verb == "forward":
                    if tokens.shape[1] > server.max_seq_len:
                        return self._json(400, {
                            "error": f"prompt length {tokens.shape[1]} exceeds "
                                     f"--max-seq-len {server.max_seq_len}"})
                    out = server.forward_argmax(tokens)
                    return self._json(200, {"logits_argmax": out.tolist()})
                checked, err = _check_generate(req, tokens, vocab, server)
                if err is not None:
                    return self._json(*err)
                n, stop_ids = checked
                rows = server.generate(tokens, max_new_tokens=n).tolist()
                if stop_ids:
                    # trim each row's GENERATED part at its first stop (inclusive)
                    from modelx_tpu_torch.models.decode import stop_cut

                    stops, plen = set(stop_ids), tokens.shape[1]
                    trimmed = []
                    for row in rows:
                        gen_part = row[plen:]
                        cut = stop_cut(gen_part, stops)
                        trimmed.append(row[:plen] + (gen_part if cut is None else gen_part[:cut]))
                    rows = trimmed
                self._json(200, {"tokens": rows})
            except NotPortedError as e:
                self._json(e.http_status, e.payload())
            except ValueError as e:  # e.g. generate on a non-generative family
                self._json(400, {"error": str(e)})
            except Exception as e:  # surface inference errors as 500 JSON
                logger.exception("inference error")
                self._json(500, {"error": str(e)})

    host, _, port = listen.rpartition(":")
    httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port)), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
