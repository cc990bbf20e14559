"""PyTorch serving sidecar (counterpart of ``modelx_tpu/dl/serve.py``).

Loads one or more checkpoints onto one device and serves:

    GET  /healthz               readiness (200 once every model is loaded)
    GET  /v1/models             model inventory + per-model stats
    POST /v1/forward            default model      {"tokens": [[...]]}
                                -> {"logits_argmax": [[...]]}
    POST /v1/generate           default model      + {"max_new_tokens": N}
                                -> {"tokens": [[prompt + generated]]}
                                sampled with temperature/top_k/top_p/seed;
                                "stream": true -> NDJSON token lines
    POST /v1/{model}/forward    named model
    POST /v1/{model}/generate   named model

Requests are checked as the JAX sidecar checks them (2-D non-empty token
ids inside the vocab, ``max_new_tokens`` in [1, limit], text and tokens
never together, sampling controls in range, ``stop_token_ids`` with a
stream on one row only, a ``resume`` block refused as the JAX sidecar
without the continuous engine refuses it) and answered with the same JSON
or NDJSON bytes. What later slices port answers a typed 501 that names the
slice: text in/out, the OpenAI routes, ``include_timing`` on a stream and
the admin routes. Dynamic and continuous batching have no flag yet:
requests take the device one at a time, a stream one chunk at a time.
"""

from __future__ import annotations

import glob
import itertools
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
from modelx_tpu_torch.dl.serving_errors import (
    RESUME_EMITTED_HEADER,
    RESUME_SEED_HEADER,
    MalformedResumeError,
    ResumeExhaustedError,
    ServingError,
    parse_resume,
)
from modelx_tpu_torch.models.decode import ChunkedDecoder, PrefixKVCache, pad_seq_len, stop_cut

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
                 max_seq_len: int = 2048, name: str = "default",
                 prefix_cache_size: int = 0, prefix_cache_max_bytes: int = 0) -> None:
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
        # one request (or one stream chunk) at a time on the device:
        # concurrent handler threads would interleave on the stream and
        # stack their activations
        self._device_lock = threading.Lock()
        # > 0 keeps the prefill KV of the last N single-row stream prompts
        # on the device (models/decode.PrefixKVCache), byte-capped by
        # prefix_cache_max_bytes when that is > 0
        self._prefix_cache = (
            PrefixKVCache(int(prefix_cache_size), max_bytes=int(prefix_cache_max_bytes))
            if int(prefix_cache_size) > 0 else None)
        self._decoders: dict[int, ChunkedDecoder] = {}  # chunk_size -> decoder
        self._decoders_lock = threading.Lock()

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

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """Greedy by default; temperature > 0 samples per row. Returns
        [B, S + max_new_tokens] (prompt + new). The prompt is padded to the
        16-bucket and decoded as a ragged batch, the shapes a stream of the
        same request runs, so the two give the same tokens."""
        if self.family.generate_ragged is None:
            raise ValueError(f"family {self.family.name} is not generative")
        tokens = np.asarray(tokens, np.int32)
        b, s = tokens.shape
        gen = self.generate_ragged(
            _pad_prompt(tokens), np.full((b,), s, np.int32), max_new_tokens,
            **_row_controls(b, temperature, top_k, top_p, seed))
        self.stats["tokens_generated"] += int(b * max_new_tokens)
        return np.concatenate([tokens, gen], axis=1)

    def generate_ragged(self, tokens: np.ndarray, row_lens: np.ndarray,
                        max_new_tokens: int, temperature=None, top_k=None, top_p=None,
                        seeds=None) -> np.ndarray:
        """Ragged-batch decode: right-padded rows [B, S] with per-row real
        lengths and per-row sampling vectors (None = greedy / filter off).
        Returns generated tokens only, [B, max_new_tokens]."""
        if self.family.generate_ragged is None:
            raise ValueError(f"family {self.family.name} has no ragged decode")
        with self._device_lock, torch.inference_mode():
            out = self.family.generate_ragged(
                self.params, self._tokens(tokens), np.asarray(row_lens, np.int64), self.cfg,
                max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
                top_p=top_p, seeds=seeds)
            return out.to(torch.int32).cpu().numpy()

    def _decoder(self, chunk_size: int) -> ChunkedDecoder:
        dec = self._decoders.get(chunk_size)
        if dec is None:
            with self._decoders_lock:
                dec = self._decoders.get(chunk_size)
                if dec is None:  # double-checked: concurrent first streams
                    fwd, init = self.family.decode_fns(self.params, self.cfg)
                    dec = self._decoders[chunk_size] = ChunkedDecoder(
                        fwd, init, chunk_size, prefix_cache=self._prefix_cache)
        return dec

    def generate_stream(self, tokens: np.ndarray, max_new_tokens: int = 16,
                        temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                        seed: int = 0, chunk_size: int = 8, stop_token_ids=None):
        """Yields [B, k] arrays of new tokens (k <= chunk_size) as they
        decode; concatenated they equal ``generate``'s new tokens. The
        device lock is held for one chunk at a time, so a slow client
        stalls only its own stream."""
        if self.family.decode_fns is None:
            raise ValueError(f"family {self.family.name} does not support streaming")
        tokens = np.asarray(tokens, np.int32)
        b, s = tokens.shape
        dec = self._decoder(chunk_size)
        pieces = dec.stream(
            self.params, self._tokens(_pad_prompt(tokens)), np.full((b,), s, np.int32),
            max_new_tokens, stop_token_ids=stop_token_ids,
            **_row_controls(b, temperature, top_k, top_p, seed))
        try:
            while True:
                with self._device_lock, torch.inference_mode():
                    piece = next(pieces, None)
                if piece is None:
                    return
                # account as chunks leave: a client disconnect must not
                # erase the decode work the device already did
                self.stats["tokens_generated"] += int(piece.size)
                yield piece
        finally:
            pieces.close()  # frees the stream's KV cache at once


def _pad_prompt(tokens: np.ndarray) -> np.ndarray:
    """Right-pad [B, S] prompts to the 16-bucket (models/decode.pad_seq_len)."""
    b, s = tokens.shape
    padded = np.zeros((b, pad_seq_len(s)), np.int32)
    padded[:, :s] = tokens
    return padded


def _row_controls(b: int, temperature: float, top_k: int, top_p: float, seed: int) -> dict:
    """One request's sampling controls as per-row vectors: greedy (no
    vectors) at temperature 0; filters None when off, so the sampler does
    no filter work for them; distinct seeds per row, so B samples of one
    prompt are B different completions."""
    if temperature <= 0:
        return {}
    return {
        "temperature": np.full((b,), temperature, np.float32),
        "top_k": np.full((b,), top_k, np.int32) if top_k > 0 else None,
        "top_p": np.full((b,), top_p, np.float32) if top_p < 1.0 else None,
        "seeds": ((seed + np.arange(b)) % (2**31)).astype(np.int32),
    }


class ServerSet:
    """Named ModelServers behind one HTTP front."""

    def __init__(self, servers: dict[str, ModelServer], default: str | None = None,
                 stream_chunk_size: int = 8) -> None:
        if not servers:
            raise ValueError("no models")
        self.servers = servers
        self.stream_chunk_size = int(stream_chunk_size)
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
            if s._prefix_cache is not None:
                d["prefix_cache"] = s._prefix_cache.stats()
            models[n] = d
        return {
            "default": self.default,
            "models": models,
            "object": "list",
            "data": [{"id": n, "object": "model", "owned_by": "modelx"}
                     for n in self.servers],
        }


    def stream_source(self, server: ModelServer, tokens, n: int, samp: dict,
                      stop_token_ids=None):
        """The token-chunk iterator behind a streamed /v1/generate, chunked
        by ``stream_chunk_size``."""
        return server.generate_stream(tokens, max_new_tokens=n,
                                      chunk_size=self.stream_chunk_size,
                                      stop_token_ids=stop_token_ids, **samp)


def _check_generate(req: dict, headers, tokens: np.ndarray, vocab: int, server: ModelServer):
    """Check a generate request as the JAX sidecar does. Returns
    ``((n, samp, stop_ids), None)`` or ``(None, (status, body))``. A resume
    block raises its typed ``ServingError``: continuing a stream needs the
    continuous engine, which is not ported, so a well-formed resume gets
    the 400 the JAX sidecar without ``--continuous-batch`` answers."""
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
    # the resume block: headers win over the native field, each
    # both-or-neither
    hdr_e, hdr_s = headers.get(RESUME_EMITTED_HEADER), headers.get(RESUME_SEED_HEADER)
    if hdr_e is not None or hdr_s is not None:
        resume = parse_resume(hdr_e, hdr_s)
    else:
        rz = req.get("resume")
        if rz is not None and not isinstance(rz, dict):
            raise MalformedResumeError("resume must be an object with emitted + seed")
        resume = None if rz is None else parse_resume(rz.get("emitted"), rz.get("seed"))
    if resume is not None:
        emitted, _seed = resume
        if not bool(req.get("stream", False)) or tokens.shape[0] != 1:
            raise MalformedResumeError("resume requires a single-row streaming request")
        if vocab and max(emitted) >= vocab:
            raise MalformedResumeError(f"emitted token ids must be in [0, {vocab})")
        if len(emitted) >= n:
            raise ResumeExhaustedError(
                f"{len(emitted)} tokens already emitted of a {n}-token budget")
        if stop_ids and any(t in stop_ids for t in emitted):
            raise ResumeExhaustedError("a stop token was already emitted")
        raise MalformedResumeError("resume requires the continuous engine (single-row stream)")
    return (n, samp, stop_ids), None


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

        def _stream_chunks(self, content_type: str, payloads, error_payload) -> None:
            """Commit a 200 with chunked transfer encoding and write each
            bytes payload. A mid-stream error (the status already sent)
            writes ``error_payload(e)``; the terminator always goes out."""
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(payload: bytes) -> None:
                self.wfile.write(f"{len(payload):x}\r\n".encode())
                self.wfile.write(payload + b"\r\n")

            try:
                for payload in payloads:
                    write_chunk(payload)
            except Exception as e:
                logger.exception("stream error")
                try:
                    write_chunk(error_payload(e))
                except OSError:
                    pass  # client went away
            finally:
                try:
                    self.wfile.write(b"0\r\n\r\n")  # chunked terminator
                except OSError:
                    pass

        def _stream_generate(self, server, tokens, n, samp, stop_ids) -> None:
            """NDJSON token stream, then {"done": true}; concatenated it
            equals the non-streamed result. A single row streams ONE token
            per line ({"tokens": [[t]]}), several rows one line per chunk."""
            gen = sset.stream_source(server, tokens, n, samp, stop_token_ids=stop_ids)
            try:
                # pull the first chunk BEFORE committing a 200: a bad
                # request must still be a 4xx
                try:
                    first = next(gen, None)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})

                def payloads():
                    if first is not None:
                        for piece in itertools.chain([first], gen):
                            rows = piece.tolist()
                            if len(rows) == 1:
                                for t in rows[0]:
                                    yield json.dumps({"tokens": [[t]]}).encode() + b"\n"
                            else:
                                yield json.dumps({"tokens": rows}).encode() + b"\n"
                    yield b'{"done": true}\n'

                self._stream_chunks(
                    "application/x-ndjson", payloads(),
                    lambda e: json.dumps({"error": str(e)}).encode() + b"\n")
            finally:
                gen.close()  # a client that went away frees the stream now

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
                e = NotPortedError("the OpenAI surface", "text and OpenAI")
                return self._json(e.http_status, e.payload())
            server, verb = sset.resolve(path)
            if server is None:
                return self._json(404, {"error": "not found"})
            if "text" in req and "tokens" in req:
                return self._json(400, {"error": "send either text or tokens, not both"})
            if "text" in req and verb != "generate":
                return self._json(400, {"error": "text is only supported on generate"})
            if "text" in req:
                e = NotPortedError("text in/out (tokenizer.json)", "text and OpenAI")
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
                checked, err = _check_generate(req, self.headers, tokens, vocab, server)
                if err is not None:
                    return self._json(*err)
                n, samp, stop_ids = checked
                if bool(req.get("stream", False)):
                    if stop_ids and tokens.shape[0] > 1:
                        # per-row early stop breaks the [B, k]-aligned stream
                        return self._json(400, {
                            "error": "stop_token_ids with stream is single-row only"})
                    if bool(req.get("include_timing", False)):
                        raise NotPortedError("include_timing", "observability")
                    return self._stream_generate(server, tokens, n, samp, stop_ids)
                rows = server.generate(tokens, max_new_tokens=n, **samp).tolist()
                if stop_ids:
                    # trim each row's GENERATED part at its first stop (inclusive)
                    stops, plen = set(stop_ids), tokens.shape[1]
                    trimmed = []
                    for row in rows:
                        gen_part = row[plen:]
                        cut = stop_cut(gen_part, stops)
                        trimmed.append(row[:plen] + (gen_part if cut is None else gen_part[:cut]))
                    rows = trimmed
                self._json(200, {"tokens": rows})
            except ServingError as e:  # the resume refusals (400, 422)
                self._json(e.http_status, {"error": str(e)}, headers=e.headers())
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
