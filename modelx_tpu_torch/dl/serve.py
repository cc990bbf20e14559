"""PyTorch serving sidecar (counterpart of ``modelx_tpu/dl/serve.py``).

Loads one or more checkpoints onto one device and serves:

    GET  /healthz               readiness: ok, degraded (some models FAILED),
                                loading, failed or draining (SIGTERM), with
                                the registry's ``control_plane`` health
    GET  /livez                 liveness (200 while the process serves)
    GET  /metrics               per-model stats, the engine's snapshot, the
                                prefix cache, lifecycle, pool, rates,
                                control plane and measured device memory;
                                JSON, or Prometheus text with
                                ``?format=prometheus`` / ``Accept: text/plain``
    GET  /v1/models             model inventory + per-model stats and
                                lifecycle states
    GET  /v1/trace              span summary (``utils/trace.py``), sliced by
                                ``?prefix=`` and ``?request_id=``
    POST /v1/profile            {"seconds": N} -> a torch.profiler capture
                                (CPU, and CUDA kernels on the card) written
                                as a Chrome trace into the trace dir
    POST /v1/forward            default model      {"tokens": [[...]]}
                                -> {"logits_argmax": [[...]]}
    POST /v1/generate           default model      + {"max_new_tokens": N}
                                -> {"tokens": [[prompt + generated]]}
                                sampled with temperature/top_k/top_p/seed;
                                "stream": true -> NDJSON token lines;
                                {"text": "..."} -> + "text" (tokenizer.json)
    POST /v1/{model}/forward    named model
    POST /v1/{model}/generate   named model
    POST /v1/completions        OpenAI surface (dl/openai_api.py), JSON or
    POST /v1/chat/completions   SSE with "stream": true
    GET  /admin/models          the model pool (dl/lifecycle.py): states,
    POST /admin/models          accounting, runtime loads ({"name",
    DELETE /admin/models/{name} "ref"|"model_dir"}) and drained unloads,
                                behind bearer tokens (--admin-token)
    GET  /debug/flightrec       the pool's and the continuous engines'
                                flight recorders (admin-gated)
    POST /admin/profile         {"duration_s": N} -> a capture into a fresh
                                dir under the trace dir, the newest
                                ``MAX_PROFILE_CAPTURES`` kept (admin-gated)

Requests are checked as the JAX sidecar checks them (2-D non-empty token
ids inside the vocab, ``max_new_tokens`` in [1, limit], text and tokens
never together, sampling controls in range, ``stop_token_ids`` with a
stream on one row only, an expired ``X-ModelX-Deadline-Ms`` answered 504
before any work, a ``resume`` block refused as the JAX sidecar without the
continuous engine refuses it) and answered with the same JSON, NDJSON or
SSE bytes. Text goes through the model's own ``tokenizer.json``, read by
``dl/tokenizer.py`` (the ``tokenizers`` package is not a dependency), and
chat through the chat template of its ``tokenizer_config.json``. A
tokenizer.json component the reader does not implement answers a typed
501 that names the open item bringing it. The encoder (bert) answers
``/v1/forward`` (the argmax over its features) and refuses every generate
as the JAX sidecar does; a forward longer than its position table answers
400 before any device work, where the JAX sidecar serves NaN features.

Every POST gets a request id (the client's ``X-ModelX-Request-Id`` when
well formed, else a minted one), echoed with ``X-ModelX-Attempt`` on every
answer; a JSON answer also carries its phase breakdown as
``X-ModelX-Timing-*`` headers. The id stamps the ``serve.request`` span and
every span beneath it, and the ``--access-log`` line written when the
request ends. Spans time host work only; ``/v1/profile`` sees the card.

Every request passes the model pool: a model that is PULLING or LOADING
answers 503 + ``Retry-After``, DRAINING 409, FAILED 503 with the reason,
and the pool counts each request in flight until its last byte, so an
unload drains it and a SIGTERM'd pod (``ServerSet.draining``) waits for it.

The one-device serving options of the JAX sidecar: ``quantize="int8"``
(weight-only int8 linears, ``ops/quant.py``), ``lora_dir`` (a PEFT adapter
merged at load, ``dl/lora.py``), ``speculative_k`` (prompt-lookup
speculation for single-row requests, ``models/speculative.py``) and, on
the ``ServerSet``, ``dynamic_batch``: concurrent requests coalesce in a
``Batcher`` window into one padded forward or one ragged decode.

On a mesh of processes (``mesh``; ``dl/mesh_serve.py``) every option
serves for llama and qwen2: int8 with global scales, LoRA merged into each
rank's slices, speculation (rank 0's proposals posted with each verify
step), the prefix cache (rank 0 decides hits and evictions), ``logprobs``
(the vocab-parallel logits gathered whole for the fp32 log-softmax), the
window batcher (a group is one posted call), the continuous engine and
admin load and unload. The other families answer a typed 501.

``continuous_batch`` puts every generate and single-row stream through the
model's continuous engine (``dl/continuous.py``): requests join a running
decode at chunk boundaries, with paged KV, chunked prefill, pipelined
dispatch, bounded admission and deadlines, in-engine speculation and
supervision. Then a stream can ``resume`` (the emitted tokens and the seed
rejoin the row's sample stream at step k) and report its phases
(``include_timing``); the engine's state rides on ``/healthz`` (503 while
it restarts or once its breaker opened), ``/livez`` (503 when broken),
``/metrics``, ``/admin/models`` and ``/debug/flightrec``. Without it,
requests take the device one at a time, a stream one chunk at a time,
``include_timing`` reports the handler's total and token count, and
``resume`` is refused (400) as the JAX sidecar refuses it.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import logging
import os
import queue
import re
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from modelx_tpu_torch.device import parse_dtype, resolve_device, start_host_copy
from modelx_tpu_torch.dl import families as fam
from modelx_tpu_torch.dl import manifest_cache
from modelx_tpu_torch.dl.lifecycle import ModelPool, PoolError, _without_tracebacks
from modelx_tpu_torch.dl.serving_errors import (
    ATTEMPT_HEADER,
    DEADLINE_HEADER,
    PRIORITY_HEADER,
    REQUEST_ID_HEADER,
    RESUME_EMITTED_HEADER,
    RESUME_SEED_HEADER,
    DeadlineExceededError,
    EngineBrokenError,
    MalformedResumeError,
    ModelLoadingError,
    ResumeExhaustedError,
    ServingError,
    client_identity,
    deadline_kwargs,
    mint_request_id,
    parse_attempt,
    parse_deadline_ms,
    parse_priority,
    parse_request_id,
    parse_resume,
    timing_headers,
)
from modelx_tpu_torch.dl.tokenizer import LATER_SLICE, Tokenizer, UnsupportedTokenizerError
from modelx_tpu_torch.models.decode import (ChunkedDecoder, PrefixKVCache, key_digest,
                                            pad_seq_len, stop_cut)
from modelx_tpu_torch.parallel.mesh import mesh_str, weight_shard_factor
from modelx_tpu_torch.utils import accesslog, devmem, promexp, trace, tswheel

logger = logging.getLogger("modelx.serve")

# /v1/generate decode budget an unauthenticated client may request; bounds
# the KV cache a single request allocates
DEFAULT_MAX_NEW_TOKENS_LIMIT = 1024
# /v1/profile holds the handler thread and the profiler for this long at most
MAX_PROFILE_SECONDS = 60
# /admin/profile captures kept on disk; older ones are pruned before each
# capture, so the on-demand profiler never fills the pod's disk
MAX_PROFILE_CAPTURES = 4

_UNSET = object()  # tokenizer / chat template not probed yet (absent is cached as None)

# the slice that brings the families a mesh of more than one rank refuses (501)
MESH_FAMILY_SLICE = "multi-device families"
# the families the mesh forward serves (models/llama.py)
MESH_FAMILIES = ("llama", "qwen2")

_MODEL_ROUTE = re.compile(r"^/v1/(?P<model>[A-Za-z0-9._-]+)/(?P<verb>forward|generate)$")
_ADMIN_MODEL_ROUTE = re.compile(r"^/admin/models/(?P<model>[A-Za-z0-9._-]+)(?:\?.*)?$")


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


class ChatTemplateRejected(Exception):
    """A model chat template called raise_exception(msg) on the request's
    messages: a client error (the OpenAI layer maps it to 400)."""


_EOS_CANDIDATES = (
    # the end-of-sequence spellings of the supported families' tokenizers:
    # llama2/mistral, gpt2/gpt-j, llama3, chatml/qwen2, llama3 base, gemma
    "</s>", "<|endoftext|>", "<|eot_id|>", "<|im_end|>", "<|end_of_text|>",
    "<eos>", "<|end|>",
)


def _eos_from_config(model_dir: str, tok) -> tuple[int, ...] | None:
    """Explicit end-of-sequence ids from the checkpoint's sidecar configs:
    generation_config.json > config.json ``eos_token_id``, then
    tokenizer_config.json's ``eos_token`` spelling resolved through the
    vocab. None = no explicit declaration (callers fall back to the
    well-known-spelling probe). An explicit id beats the probe because
    vocabs can carry probe spellings as non-eos specials."""

    def ids_from(val) -> tuple[int, ...] | None:
        if isinstance(val, bool):
            return None
        if isinstance(val, int):
            return (int(val),)
        if (
            isinstance(val, list) and val
            and all(isinstance(v, int) and not isinstance(v, bool) for v in val)
        ):
            return tuple(dict.fromkeys(int(v) for v in val))
        return None

    for fname in ("generation_config.json", "config.json"):
        path = os.path.join(model_dir, fname)
        if not os.path.isfile(path):
            continue
        try:
            with open(path, encoding="utf-8") as f:
                got = ids_from(json.load(f).get("eos_token_id"))
        except (OSError, ValueError):
            continue  # a malformed sidecar must not kill the tokenizer load
        if got:
            return got
    path = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.isfile(path):
        try:
            with open(path, encoding="utf-8") as f:
                eos = json.load(f).get("eos_token")
        except (OSError, ValueError):
            eos = None
        if isinstance(eos, dict):  # added-token object form
            eos = eos.get("content")
        if isinstance(eos, str):
            tid = tok.token_to_id(eos)
            if tid is not None:
                return (int(tid),)
    return None


class _Tokenizer:
    """list[int]-in/str-out facade over a ``dl/tokenizer.Tokenizer``.

    ``eos_override``: explicit eos ids from the model's config sidecars
    (_eos_from_config); when present the spelling probe is skipped."""

    def __init__(self, tok: Tokenizer, eos_override: tuple[int, ...] | None = None) -> None:
        self._tok = tok
        self._eos: tuple[int, ...] | None = eos_override

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        # chat-template renders carry their own special tokens (bos etc.),
        # so that path encodes raw: the HF apply_chat_template convention
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids) -> str:
        # keep special tokens: clients watch for e.g. "</s>" in the text
        return self._tok.decode(list(ids), skip_special_tokens=False)

    def eos_ids(self) -> tuple[int, ...]:
        """End-of-sequence token ids: the config sidecars' explicit
        declaration when the model ships one, otherwise the vocab's
        well-known spellings. Empty = unknown: callers then keep
        budget-only decode; ``ignore_eos`` is the per-request escape hatch."""
        if self._eos is None:
            ids = []
            for cand in _EOS_CANDIDATES:
                tid = self._tok.token_to_id(cand)
                if tid is not None:
                    ids.append(int(tid))
            self._eos = tuple(dict.fromkeys(ids))
        return self._eos


class ModelServer:
    """One loaded model: params on one device (or this rank's slices of
    them on a mesh) and its entry points."""

    # the shape a lone first request is padded to upstream (seq to a
    # multiple of 16): one cache-free forward at load builds the attention
    # kernel and warms the allocator, so the first request meets them ready
    WARMUP_TOKEN_SHAPES = ((1, 16),)

    def __init__(self, model_dir: str, dtype: str = "bfloat16", device=None,
                 max_seq_len: int = 2048, name: str = "default",
                 quantize: str | None = None, speculative_k: int = 0, lora_dir: str = "",
                 prefix_cache_size: int = 0, prefix_cache_max_bytes: int = 0,
                 mesh=None, attention_impl: str = "auto") -> None:
        self.name = name
        self.model_dir = model_dir
        self.quantize = quantize
        self.lora_dir = lora_dir
        # > 0 turns on prompt-lookup speculative decoding for single-row
        # requests (models/speculative.py)
        self.speculative_k = int(speculative_k)
        self._spec_decoder = None
        # a live mesh (parallel/mesh.py): this process is one rank of it,
        # computing on the mesh's device; None serves on ``device`` alone
        self.mesh = mesh
        # the sequence-parallel attention of a mesh forward: "auto" (ring
        # when sp > 1), "ring" or "ulysses"
        self.attention_impl = attention_impl
        # rank 0's op log (dl/mesh_serve.py), attached once the models are
        # loaded: every device call is posted to the followers first;
        # ``_posted`` is the sequence number of the current call's post
        self.oplog = None
        self._posted: int | None = None
        self._stream_ids = itertools.count()
        self.device = (mesh.device if mesh is not None and mesh.device is not None
                       else resolve_device(device))
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
        # text state, loaded on first use under double-checked locking
        self._tokenizer_lock = threading.Lock()
        self._tokenizer: object = _UNSET
        self._chat_template: object = _UNSET
        # what a mesh of more than one rank cannot serve yet (a family the
        # mesh forward does not run): every request answers this typed 501
        self._mesh_refusal: NotPortedError | None = None
        # a follower of a mesh: its continuous engine's replica, its
        # speculative decodes' sessions (by rank 0's id)
        self._engine_replica = None
        self._spec_sessions: dict = {}

    @property
    def mesh_size(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def _check_refusal(self) -> None:
        if self._mesh_refusal is not None:
            raise self._mesh_refusal

    def _mesh_kw(self) -> dict:
        """The family entry points' mesh arguments: none without a mesh, and
        none for a family the mesh forward does not serve (a one-rank mesh
        runs it as one card)."""
        if self.mesh is None or self.family is None or self.family.name not in MESH_FAMILIES:
            return {}
        return {"mesh": self.mesh, "attention_impl": self.attention_impl}

    def _post(self, op: str, tokens=None, **fields) -> None:
        """Rank 0: post a device call to the followers (under the lock)."""
        if self.oplog is not None:
            self._posted = self.oplog.post(op, self.name, tokens, **fields)

    def attach_oplog(self, oplog, lock) -> None:
        """Rank 0 of a mesh, once the model is loaded: every later device
        call is posted to ``oplog`` under ``lock`` (the one device lock of
        every model of the pod), and each prefix-cache eviction too, so
        the followers' replicas drop the same entries."""
        self._device_lock = lock
        self.oplog = oplog
        if self._prefix_cache is not None:
            def evicted(digests, server=self):
                server._post("prefix_evict", digests=list(digests))

            self._prefix_cache.on_evict = evicted

    def follow_mesh(self) -> None:
        """A follower of a mesh: its prefix cache becomes a replica of rank
        0's (it stores and drops only what rank 0's op log says)."""
        if self._prefix_cache is not None:
            self._prefix_cache.replica = True

    @contextlib.contextmanager
    def _mesh_guard(self):
        """Rank 0 of a mesh: a device call that fails after its post may
        leave the followers out of step (or one of them is gone), so the
        mesh is marked failed and the request answers 503; unless the error
        is one the request causes on every rank alike and every follower
        finished the op (``mesh_serve.OpLog.in_step``): then the request
        answers that error and the mesh serves on."""
        if self.oplog is None:
            yield
            return
        from modelx_tpu_torch.dl.mesh_serve import MeshFailedError, request_error

        self._posted = None
        try:
            yield
        except (MeshFailedError, NotPortedError):
            raise
        except Exception as e:
            if self._posted is None or (request_error(e)
                                        and self.oplog.in_step(self._posted)):
                raise
            self.oplog.fail(f"{type(e).__name__}: {e}")
            raise MeshFailedError(f"serving mesh failed: {e}") from e

    def load(self) -> dict:
        """Load every *.safetensors under model_dir onto the device; the
        checkpoint headers determine the architecture."""
        with trace.span("serve.load", model=self.name, dir=self.model_dir):
            return self._load()

    def _load(self) -> dict:
        from modelx_tpu_torch.dl.loader import (LocalFileSource, fuse_expert_tensors,
                                                load_safetensors)
        from modelx_tpu_torch.dl.safetensors import read_header_from_file

        t0 = time.monotonic()
        paths = sorted(glob.glob(os.path.join(self.model_dir, "*.safetensors")))
        if not paths:
            raise FileNotFoundError(f"no safetensors under {self.model_dir}")
        self._install_program_bundles()
        infos_all: dict = {}
        for path in paths:
            infos, _ = read_header_from_file(path)
            infos_all.update(infos)
        self.family = fam.detect(list(infos_all))
        # the loader's expert fusion: header shapes as the params arrive
        # (stacked [E, ...] experts)
        infos_all = fuse_expert_tensors(infos_all)
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
        self.stats["mesh"] = mesh_str(self.mesh) if self.mesh is not None else "dp=1"
        self.stats["mesh_devices"] = self.mesh_size
        self.stats["weight_shard_factor"] = (weight_shard_factor(self.mesh)
                                             if self.mesh is not None else 1)
        if self.mesh_size > 1 and self.family.name not in MESH_FAMILIES:
            self._mesh_refusal = NotPortedError(
                f"the {self.family.name} family under a mesh", MESH_FAMILY_SLICE)
        if self._mesh_refusal is not None:
            # nothing to place: every request answers the 501
            self.stats["family"] = self.family.name
            self.ready = True
            return dict(self.stats)
        index = None
        if self.mesh_size > 1:
            from modelx_tpu_torch.models import llama

            if not self.mesh.live:
                raise ValueError(f"mesh {mesh_str(self.mesh)} has no process group: "
                                 "a mesh of more than one rank serves from a live group")

            # this rank reads only its slices' bytes
            index = llama.sharding_ctx(self.cfg, self.mesh).param_index
        params: dict = {}
        total = resident = 0
        for path in paths:
            src = LocalFileSource(path)
            try:
                arrays, lstats = load_safetensors(
                    src, self.device, dtype=self.dtype, quantize=self.quantize, index=index,
                    amax_reduce=None if index is None else self._tp_amax)
            finally:
                src.close()
            params.update(arrays)
            total += lstats.bytes_to_device
            resident += lstats.bytes_resident
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.params = params
        if self.lora_dir:
            from modelx_tpu_torch.dl import lora

            # merged before the warm-up forward; merging into int8 is
            # rejected (serve_main refuses the combination up front)
            tm = time.monotonic()
            with trace.span("serve.lora", model=self.name, dir=self.lora_dir):
                self.params = lora.merge_adapter(self.params, self.lora_dir, index=index)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.stats["lora_dir"] = self.lora_dir
            self.stats["lora_merge_seconds"] = round(time.monotonic() - tm, 3)
        seconds = time.monotonic() - t0
        self.stats["family"] = self.family.name
        self.stats["device"] = str(self.device)
        self.stats["dtype"] = str(self.dtype).removeprefix("torch.")
        self.stats["load_seconds"] = round(seconds, 3)
        self.stats["load_bytes"] = total  # over the link
        self.stats["device_bytes"] = resident  # kept on the device
        self.stats["load_gbps"] = round(total / max(seconds, 1e-9) / 1e9, 3)
        if index is not None:
            # the model's bytes, as the reference counts a mesh load (the
            # pool divides them by the weight-shard factor), beside the
            # bytes this rank read
            self.stats["rank_load_bytes"] = total
            self.stats["load_bytes"] = sum(info.nbytes for info in infos_all.values())
        self._warm_up()
        self.stats["ready_seconds"] = round(time.monotonic() - t0, 3)
        self.ready = True
        self._install_kv_bundles()
        return dict(self.stats)

    def _tp_amax(self, amax: torch.Tensor) -> torch.Tensor:
        """The per-channel absolute maxima of a weight whose input dim is
        split over tp, over every rank's columns: the global int8 scale's
        input (``dl/loader.py``)."""
        return self.mesh.all_reduce(amax, "tp", op="max")

    def _warm_up(self) -> None:
        """One cache-free forward per warm-up shape: on the card it binds
        (or builds) the kernel library, the ``serve.compile`` span, and
        warms the allocator, so the first request meets them ready. The
        JAX sidecar's ``serve.precompile`` span times its AOT compile of
        the same shapes."""
        for shape in self.WARMUP_TOKEN_SHAPES:
            with trace.span("serve.precompile", model=self.name, shape=str(shape)):
                self._argmax(np.zeros(shape, np.int64))
        self._note_kernel_library()

    def _install_program_bundles(self) -> None:
        """Install kernel-library bundles pulled next to the weights
        (``.programs-*.tar``, ``dl/program_store.py``) into the build
        directory BEFORE the warm-up forward can reach
        ``kernels.build.load_library``, which then binds the installed
        library without running nvcc. An optimization only: any failure is
        logged and counted, and the library builds with nvcc."""
        from modelx_tpu_torch.dl import program_store
        from modelx_tpu_torch.kernels import build

        t0 = time.monotonic()
        try:
            pstats = program_store.install_from_dir(
                self.model_dir, build.build_dir(),
                mesh=mesh_str(self.mesh) if self.mesh is not None else None)
        except Exception as e:
            logger.warning("program bundle install failed: %s", e)
            return
        if pstats["bundles"] or pstats["skipped"]:
            self.stats["programs"] = {
                k: pstats[k] for k in ("bundles", "installed", "present", "skipped")}
            self.stats["programs"]["ms"] = round((time.monotonic() - t0) * 1e3, 3)

    def _note_kernel_library(self) -> None:
        """Where the bound kernel library came from ("nvcc", "bundle" or
        "cached") and nvcc's seconds, once a forward on the card bound it."""
        from modelx_tpu_torch.kernels import build

        info = build.library_info()
        if info is not None:
            self.stats["kernel_library"] = {"origin": info["origin"],
                                            "nvcc_seconds": info["nvcc_seconds"]}

    def _install_kv_bundles(self) -> None:
        """Install prefix-KV bundles pulled next to the weights
        (``.kv-*.tar``, ``dl/kv_store.py``) into the prefix cache, once the
        family is known (its ``init_kv_cache`` validates the leaves). An
        optimization only: any failure is logged and the prompt prefills
        cold."""
        if self._prefix_cache is None:
            return
        if self._kv_ctx() is not None:
            # the byte cap counts whole entries, as the reference does
            self._prefix_cache.kv_heads = self.cfg.num_kv_heads
        from modelx_tpu_torch.dl import kv_store

        t0 = time.monotonic()
        try:
            kstats = kv_store.install_for_server(self, self.model_dir)
        except Exception as e:
            logger.warning("kv bundle install failed: %s", e)
            return
        if kstats and (kstats["bundles"] or kstats["skipped"]):
            self.stats["kv"] = {
                k: kstats[k] for k in ("bundles", "installed", "present", "skipped")}
            self.stats["kv"]["ms"] = round((time.monotonic() - t0) * 1e3, 3)

    def _kv_ctx(self):
        """The llama placement whose kv heads a prefix entry's leaves hold
        on this mesh, or None when every rank holds every head."""
        if self.mesh_size <= 1 or self.family.name not in MESH_FAMILIES:
            return None
        from modelx_tpu_torch.models import llama

        ctx = llama.sharding_ctx(self.cfg, self.mesh)
        return ctx if ctx.cache_heads() != list(range(self.cfg.num_kv_heads)) else None

    def whole_kv(self, ids, entry: dict) -> tuple[dict, list] | None:
        """A prefix entry's leaves as the whole cache, and each one's spec
        in sorted leaf order (``dl/kv_store.build_bundle``): this rank's
        leaves off a mesh; on one, every tp rank's kv heads gathered (an op
        every rank meets, leaf by leaf in sorted order) from the entry
        stored under ``ids`` when the gather is posted. None when a put
        evicted it since it was taken: the followers dropped it too."""
        names = sorted(entry)
        ctx = self._kv_ctx()
        if ctx is None:
            return {n: entry[n] for n in names}, [None] * len(names)
        with self._device_lock, torch.inference_mode(), self._mesh_guard():
            entry = self._prefix_cache.get(ids)
            if entry is None:
                return None
            names = sorted(entry)
            self._post("kv_gather", digest=key_digest(ids))
            whole = {n: self._gather_heads(entry[n], ctx) for n in names}
        return whole, [ctx.cache_spec()] * len(names)

    def _gather_heads(self, leaf: torch.Tensor, ctx) -> torch.Tensor:
        """[1, S, Hkv, D] from every tp rank's [1, S, h, D] leaf."""
        parts = self.mesh.all_gather(leaf.contiguous(), "tp", dim=2)
        out = leaf.new_zeros(leaf.shape[:2] + (self.cfg.num_kv_heads,) + leaf.shape[3:])
        at = 0
        for r in range(self.mesh.axis_size("tp")):
            heads = ctx.cache_heads(r)
            out[:, :, heads] = parts[:, :, at:at + len(heads)]
            at += len(heads)
        return out

    def kv_shard(self, host: torch.Tensor) -> torch.Tensor:
        """This rank's kv heads of a whole [1, S, Hkv, D] bundle leaf."""
        ctx = self._kv_ctx()
        return host if ctx is None else host[:, :, ctx.cache_heads()]

    def load_from_tier(self, promo) -> dict:
        """Materialize a demoted model from a tier promotion
        (``dl/tiers.Promotion``) instead of the checkpoint files: the host
        or disk tensors go to the device, with no fetch and no safetensors
        parse, then the same warm-up forward as ``load`` (through the flash
        kernel on the card)."""
        with trace.span("serve.load_from_tier", model=self.name, tier=promo.tier):
            return self._load_from_tier(promo)

    def _load_from_tier(self, promo) -> dict:
        from modelx_tpu_torch.dl.tiers import unflatten_params

        t0 = time.monotonic()
        self.family = promo.family
        self.cfg = promo.cfg
        # non-blocking from the host tier's pinned buffer; the synchronize
        # below makes the tensors whole before the buffer may be touched
        leaves = [leaf.to(self.device, copy=True, non_blocking=True) for leaf in promo.leaves]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.params = unflatten_params(promo.treedef, leaves)
        seconds = time.monotonic() - t0
        self.stats["family"] = self.family.name
        self.stats["device"] = str(self.device)
        self.stats["dtype"] = str(self.dtype).removeprefix("torch.")
        self.stats["load_seconds"] = round(seconds, 3)
        self.stats["load_bytes"] = promo.nbytes
        self.stats["device_bytes"] = promo.nbytes
        self.stats["load_gbps"] = round(promo.nbytes / max(seconds, 1e-9) / 1e9, 3)
        self.stats["tier"] = promo.tier
        self._warm_up()
        self.stats["ready_seconds"] = round(time.monotonic() - t0, 3)
        self.ready = True
        self._install_kv_bundles()
        return dict(self.stats)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)

    def forward_argmax(self, tokens: np.ndarray) -> np.ndarray:
        """Argmax of the cache-free forward's logits, [B, S]."""
        self._check_refusal()
        with trace.span("serve.forward", model=self.name, batch=int(tokens.shape[0])):
            return self._argmax(tokens)

    def _argmax(self, tokens: np.ndarray) -> np.ndarray:
        # the device work and its copy to the host queue under the lock;
        # the wait for the copy comes after the release, so the next
        # request's launches queue while the card still runs this one
        with self._device_lock, torch.inference_mode(), self._mesh_guard():
            self._post("forward", tokens)
            logits = self.family.forward(self.params, self._tokens(tokens), self.cfg,
                                         **self._mesh_kw())
            fetch = start_host_copy(torch.argmax(logits, dim=-1).to(torch.int32))
        return fetch()

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """Greedy by default; temperature > 0 samples per row. Returns
        [B, S + max_new_tokens] (prompt + new). The prompt is padded to the
        16-bucket and decoded as a ragged batch, the shapes a stream of the
        same request runs, so the two give the same tokens. With
        ``speculative_k``, a single row speculates at any temperature:
        greedy acceptance is token-exact, sampled acceptance is modified
        rejection."""
        self._check_refusal()
        if self.family.generate_ragged is None:
            raise ValueError(f"family {self.family.name} is not generative")
        tokens = np.asarray(tokens, np.int32)
        b, s = tokens.shape
        if self.speculative_k > 0 and b == 1 and self.family.decode_fns is not None:
            with trace.span("serve.generate_spec", model=self.name,
                            new_tokens=max_new_tokens):
                dec = self._speculative_decoder()
                prompt = tokens[0].tolist()
                stats = {"device_steps": 0, "proposed": 0, "accepted": 0}
                with self._device_lock, torch.inference_mode(), self._mesh_guard():
                    sid = next(self._stream_ids)
                    try:
                        pieces = list(dec.stream(self.params, prompt, max_new_tokens,
                                                 stats=stats, temperature=temperature,
                                                 top_k=top_k, top_p=top_p, seed=seed,
                                                 on_step=self._spec_poster(sid)))
                    finally:
                        self._close_spec(sid)
                new = np.concatenate(pieces, axis=1)
                self.stats["tokens_generated"] += int(new.size)
                self._record_spec_stats(stats)
                return np.concatenate([tokens, new], axis=1)
        with trace.span("serve.generate", model=self.name, new_tokens=max_new_tokens):
            # the JAX sidecar's sampled path runs (and spans) its ragged
            # decode, its greedy path the family's plain generate
            ragged = self.generate_ragged if temperature > 0 else self._generate_ragged
            gen = ragged(_pad_prompt(tokens), np.full((b,), s, np.int32), max_new_tokens,
                         **_row_controls(b, temperature, top_k, top_p, seed))
        self.stats["tokens_generated"] += int(b * max_new_tokens)
        return np.concatenate([tokens, gen], axis=1)

    def generate_ragged(self, tokens: np.ndarray, row_lens: np.ndarray,
                        max_new_tokens: int, temperature=None, top_k=None, top_p=None,
                        seeds=None) -> np.ndarray:
        """Ragged-batch decode: right-padded rows [B, S] with per-row real
        lengths and per-row sampling vectors (None = greedy / filter off).
        Returns generated tokens only, [B, max_new_tokens]."""
        self._check_refusal()
        with trace.span("serve.generate_ragged", model=self.name, rows=int(tokens.shape[0]),
                        new_tokens=max_new_tokens):
            return self._generate_ragged(tokens, row_lens, max_new_tokens, temperature=temperature,
                                         top_k=top_k, top_p=top_p, seeds=seeds)

    def _generate_ragged(self, tokens: np.ndarray, row_lens: np.ndarray, max_new_tokens: int,
                         temperature=None, top_k=None, top_p=None, seeds=None) -> np.ndarray:
        if self.family.generate_ragged is None:
            raise ValueError(f"family {self.family.name} has no ragged decode")

        def listed(x):
            return None if x is None else np.asarray(x).tolist()

        with self._device_lock, torch.inference_mode(), self._mesh_guard():
            self._post("generate", tokens, row_lens=listed(row_lens), n=int(max_new_tokens),
                       temperature=listed(temperature), top_k=listed(top_k),
                       top_p=listed(top_p), seeds=listed(seeds))
            out = self.family.generate_ragged(
                self.params, self._tokens(tokens), np.asarray(row_lens, np.int64), self.cfg,
                max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
                top_p=top_p, seeds=seeds, **self._mesh_kw())
            fetch = start_host_copy(out.to(torch.int32))
        return fetch()

    def score_logprobs_rows(self, rows, top_k: int = 0) -> list:
        """Per-token log-probabilities for completed generations: a
        cache-free forward over [prompt + generated] (the flash kernel on
        the card) and an fp32 log-softmax gather, the values the decode saw
        when it picked each token. ``rows`` is [(ids, new_ids), ...]; rows
        sharing a 16-bucketed length score as one batched forward, padded
        to a power-of-two batch. Returns, per row, (token_logprobs [m],
        top_ids [m, top_k], top_logprobs [m, top_k]); the top_* pair is None
        when top_k == 0."""
        self._check_refusal()
        empty = (np.zeros((0,), np.float32),) + (
            (np.zeros((0, top_k), np.int32), np.zeros((0, top_k), np.float32))
            if top_k else (None, None))
        out: list = [empty] * len(rows)
        groups: dict[int, list[int]] = {}
        for i, (ids, new_ids) in enumerate(rows):
            if new_ids:
                groups.setdefault(pad_seq_len(len(ids) + len(new_ids)), []).append(i)
        for lb, idxs in groups.items():
            bb = 1 << (len(idxs) - 1).bit_length()  # pow2 batch bucket
            padded = np.zeros((bb, lb), np.int64)
            for r, i in enumerate(idxs):
                full = list(rows[i][0]) + list(rows[i][1])
                padded[r, : len(full)] = full
            chosen, top_id, top_lp = self._score(padded, int(top_k))
            for r, i in enumerate(idxs):
                ids, new_ids = rows[i]
                lo, hi = len(ids) - 1, len(ids) + len(new_ids) - 1
                out[i] = (chosen[r, lo:hi],) + (
                    (top_id[r, lo:hi], top_lp[r, lo:hi]) if top_k else (None, None))
        return out

    def _score(self, tokens: np.ndarray, top_k: int):
        """(chosen [B, S], top ids, top logprobs) of one scoring forward;
        position j scores token j + 1. On a mesh every rank runs the
        forward on its heads, and the vocab-parallel head's logits are
        gathered whole for the fp32 log-softmax and the top-k."""
        with self._device_lock, torch.inference_mode(), self._mesh_guard():
            self._post("score", tokens, top_k=int(top_k))
            toks = self._tokens(tokens)
            logits = self.family.forward(self.params, toks, self.cfg, **self._mesh_kw())
            lp = torch.log_softmax(logits.float(), dim=-1)
            nxt = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], dim=1)
            fetches = [start_host_copy(torch.gather(lp, -1, nxt[..., None])[..., 0])]
            if top_k:
                top_lp, top_id = torch.topk(lp, top_k, dim=-1)
                fetches += [start_host_copy(top_id.to(torch.int32)), start_host_copy(top_lp)]
        # the host waits past the lock's release (as _argmax)
        chosen, *top = (f() for f in fetches)
        return (chosen, *top) if top_k else (chosen, None, None)

    def score_logprobs(self, ids: list[int], new_ids: list[int], top_k: int = 0):
        """Single-row convenience over score_logprobs_rows."""
        return self.score_logprobs_rows([(ids, new_ids)], top_k=top_k)[0]

    def tokenizer(self) -> _Tokenizer | None:
        """The model's tokenizer (``tokenizer.json`` beside the weights), or
        None when there is none. Loaded lazily. A file that fails to load
        raises RuntimeError and is retried next time; a component the
        reader does not implement raises ``NotPortedError`` (501)."""
        if self._tokenizer is _UNSET:
            with self._tokenizer_lock:
                if self._tokenizer is _UNSET:
                    path = os.path.join(self.model_dir, "tokenizer.json")
                    if not os.path.isfile(path):
                        self._tokenizer = None  # genuinely absent: cache it
                    else:
                        try:
                            raw = Tokenizer.from_file(path)
                        except UnsupportedTokenizerError as e:
                            self._tokenizer = e  # the file will not change: cache it
                        except Exception as e:
                            # not cached: a transient read error must surface
                            # as a load failure, not as "no tokenizer.json"
                            raise RuntimeError(
                                f"tokenizer.json exists but failed to load: {e}") from e
                        else:
                            self._tokenizer = _Tokenizer(
                                raw, eos_override=_eos_from_config(self.model_dir, raw))
        if isinstance(self._tokenizer, UnsupportedTokenizerError):
            raise NotPortedError(f"tokenizer.json component {self._tokenizer.component}",
                                 LATER_SLICE)
        return self._tokenizer

    def chat_template(self) -> dict | None:
        """The model's own chat template from ``tokenizer_config.json``, or
        None: ``{"template", "compiled", "bos_token", "eos_token"}``. The
        string form and the named-list form (a "default" entry only);
        special tokens as strings or AddedToken dicts. Compiled once, in a
        sandboxed jinja environment with HF's conveniences (loop controls,
        ``strftime_now``, ``raise_exception``). Any problem, a missing
        jinja2 included, degrades to None (the generic role template) with
        one warning."""
        if self._chat_template is _UNSET:
            with self._tokenizer_lock:
                if self._chat_template is _UNSET:
                    self._chat_template = self._load_chat_template()
        return self._chat_template

    def _load_chat_template(self) -> dict | None:
        path = os.path.join(self.model_dir, "tokenizer_config.json")
        if not os.path.isfile(path):
            return None
        try:
            with open(path, encoding="utf-8") as f:
                cfg = json.load(f)
            tpl = cfg.get("chat_template")
            if isinstance(tpl, list):  # [{name, template}, ...]
                by_name = {t.get("name"): t.get("template") for t in tpl if isinstance(t, dict)}
                tpl = by_name.get("default")
                if tpl is None and by_name:
                    logger.warning(
                        "tokenizer_config.json has named chat templates %s but no "
                        "'default'; using the generic role template",
                        sorted(k for k in by_name if k))
                    return None
            if not (isinstance(tpl, str) and tpl.strip()):
                return None
            try:
                from jinja2.sandbox import ImmutableSandboxedEnvironment
            except ImportError:
                logger.warning("model ships a chat_template but jinja2 is not installed; "
                               "using the generic role template")
                return None
            env = ImmutableSandboxedEnvironment(
                trim_blocks=True, lstrip_blocks=True,
                extensions=["jinja2.ext.loopcontrols"])
            import datetime as _dt

            env.globals["strftime_now"] = lambda fmt: _dt.datetime.now().strftime(fmt)

            def _raise(msg):
                raise ChatTemplateRejected(str(msg))

            env.globals["raise_exception"] = _raise

            def token_str(v) -> str:
                if isinstance(v, dict):  # AddedToken form
                    return str(v.get("content", ""))
                return v if isinstance(v, str) else ""

            return {
                "template": tpl,
                "compiled": env.from_string(tpl),
                "bos_token": token_str(cfg.get("bos_token")),
                "eos_token": token_str(cfg.get("eos_token")),
            }
        except Exception as e:
            logger.warning("tokenizer_config.json unusable for chat templating (%s); "
                           "falling back to the generic role template", e)
            return None

    def _speculative_decoder(self):
        self._check_refusal()
        if self._spec_decoder is None:
            with self._decoders_lock:  # double-checked, like the stream decoders
                if self._spec_decoder is None:
                    from modelx_tpu_torch.models.speculative import SpeculativeDecoder

                    fwd, init = self.family.decode_fns(self.params, self.cfg,
                                                       **self._mesh_kw())
                    self._spec_decoder = SpeculativeDecoder(fwd, init, k=self.speculative_k)
        return self._spec_decoder

    def _spec_poster(self, sid: int):
        """Rank 0 of a mesh: the speculative decoder's ``on_step`` that
        posts each step (rank 0's proposals and rolled-back offset) for the
        followers' session ``sid``; None off a mesh."""
        if self.oplog is None:
            return None

        def post(kind: str, inputs: dict) -> None:
            self._post(f"spec_{kind}", sid=sid, **inputs)

        return post

    def _close_spec(self, sid: int) -> None:
        """Free the followers' session ``sid`` (rank 0 holds the lock)."""
        if self.oplog is not None and self.oplog.failed is None:
            with contextlib.suppress(ServingError):
                self.oplog.post("spec_close", self.name, sid=sid)

    def _record_spec_stats(self, stats: dict) -> None:
        for key in ("device_steps", "proposed", "accepted"):
            self.stats[f"spec_{key}"] = self.stats.get(f"spec_{key}", 0) + stats[key]

    def _decoder(self, chunk_size: int) -> ChunkedDecoder:
        dec = self._decoders.get(chunk_size)
        if dec is None:
            with self._decoders_lock:
                dec = self._decoders.get(chunk_size)
                if dec is None:  # double-checked: concurrent first streams
                    fwd, init = self.family.decode_fns(self.params, self.cfg, **self._mesh_kw())
                    dec = self._decoders[chunk_size] = ChunkedDecoder(
                        fwd, init, chunk_size, prefix_cache=self._prefix_cache,
                        agree=None if self.mesh is None else self.mesh.broadcast_from_leader)
        return dec

    def generate_stream(self, tokens: np.ndarray, max_new_tokens: int = 16,
                        temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                        seed: int = 0, chunk_size: int = 8, stop_token_ids=None):
        """Yields [B, k] arrays of new tokens (k <= chunk_size) as they
        decode; concatenated they equal ``generate``'s new tokens. The
        device lock is held for one chunk at a time, so a slow client
        stalls only its own stream. With ``speculative_k`` a single-row
        stream flushes one chunk per device step instead (the accepted run
        and the bonus token, up to speculative_k + 1 tokens)."""
        self._check_refusal()
        if self.family.decode_fns is None:
            raise ValueError(f"family {self.family.name} does not support streaming")
        tokens = np.asarray(tokens, np.int32)
        b, s = tokens.shape
        if self.speculative_k > 0 and b == 1:
            yield from self._generate_stream_speculative(
                tokens, max_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, stop_token_ids=stop_token_ids)
            return
        opened = None
        if self.oplog is not None:
            opened = {"n": int(max_new_tokens), "temperature": float(temperature),
                      "top_k": int(top_k), "top_p": float(top_p), "seed": int(seed),
                      "chunk_size": int(chunk_size),
                      "stop_token_ids": [int(t) for t in stop_token_ids or ()] or None}
        with trace.span("serve.generate_stream", model=self.name, new_tokens=max_new_tokens):
            def pieces(hit):
                return self._stream_pieces(tokens, max_new_tokens, temperature, top_k, top_p,
                                           seed, chunk_size, stop_token_ids, hit=hit)

            for piece in self._locked_pieces(pieces, tokens, opened, chunk_size=chunk_size):
                # account as chunks leave: a client disconnect must not erase
                # the decode work the device already did
                self.stats["tokens_generated"] += int(piece.size)
                yield piece

    def _stream_pieces(self, tokens: np.ndarray, max_new_tokens: int, temperature: float = 0.0,
                       top_k: int = 0, top_p: float = 1.0, seed: int = 0, chunk_size: int = 8,
                       stop_token_ids=None, hit=None):
        """The chunked decoder's (lazy) piece generator for one stream,
        from the prefix-cache hit decided for it (``_decide_hit``)."""
        b, s = tokens.shape
        return self._decoder(chunk_size).stream(
            self.params, self._tokens(_pad_prompt(tokens)), np.full((b,), s, np.int32),
            max_new_tokens, stop_token_ids=stop_token_ids, hit=hit,
            **_row_controls(b, temperature, top_k, top_p, seed))

    def _decide_hit(self, tokens: np.ndarray, chunk_size: int):
        """The prefix-cache hit of a stream's prompt (rank 0's lookup, under
        the device lock), or None: single-row streams only."""
        if self._prefix_cache is None or tokens.shape[0] != 1:
            return None
        return self._decoder(chunk_size).resolve(np.asarray(tokens)[0])

    def _generate_stream_speculative(self, tokens: np.ndarray, max_new_tokens: int,
                                     temperature: float = 0.0, top_k: int = 0,
                                     top_p: float = 1.0, seed: int = 0, stop_token_ids=None):
        stats = {"device_steps": 0, "proposed": 0, "accepted": 0}
        stops = set(stop_token_ids or ())
        sid = next(self._stream_ids)
        pieces = self._speculative_decoder().stream(
            self.params, tokens[0].tolist(), max_new_tokens, stats=stats,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            on_step=self._spec_poster(sid))
        try:
            with trace.span("serve.generate_stream_spec", model=self.name,
                            new_tokens=max_new_tokens):
                for piece in self._locked_pieces(pieces, spec_sid=sid):
                    cut = stop_cut(piece[0].tolist(), stops)
                    if cut is not None:
                        piece = piece[:, :cut]  # emit through the stop, then end
                    self.stats["tokens_generated"] += int(piece.size)
                    yield piece
                    if cut is not None:
                        return
        finally:
            # a consumer that stops early (a stop match, a client gone) closes
            # this mid-loop; the device work done still shows in the stats
            self._record_spec_stats(stats)

    def _locked_pieces(self, pieces, tokens=None, opened: dict | None = None,
                       chunk_size: int = 8, spec_sid: int | None = None):
        """Pull ``pieces`` one at a time under the device lock. A callable
        ``pieces`` is made at the first pull from the prefix-cache hit
        decided then. On a mesh (``opened``: the stream's arguments) each
        pull is posted first: the first opens the stream on the followers
        with the hit (its entry's digest and length), the rest advance it,
        and the close frees it there too (``spec_sid``: a speculative
        stream's session)."""
        sid = None
        gen = None if callable(pieces) else pieces
        try:
            while True:
                with self._device_lock, torch.inference_mode(), self._mesh_guard():
                    if gen is None:
                        hit = self._decide_hit(tokens, chunk_size)
                        gen = pieces(hit)
                        if opened is not None:
                            sid = next(self._stream_ids)
                            plen = hit[0] if hit is not None else 0
                            self._post("stream_open", tokens, sid=sid, plen=plen,
                                       hit=key_digest(tokens[0, :plen])
                                       if hit is not None else None, **opened)
                    elif sid is not None:
                        self._post("stream_next", sid=sid)
                    piece = next(gen, None)
                if piece is None:
                    return
                yield piece
        finally:
            if gen is not None:
                gen.close()  # frees the stream's KV cache at once
            if self.oplog is not None and self.oplog.failed is None:
                if sid is not None:
                    with self._device_lock, contextlib.suppress(ServingError):
                        self.oplog.post("stream_close", self.name, sid=sid)
                if spec_sid is not None:
                    with self._device_lock:
                        self._close_spec(spec_sid)


# what a follower's replica engine needs to hold rank 0's device state
REPLICA_ENGINE_KWARGS = ("max_slots", "chunk_size", "max_len", "page_size",
                         "max_live_tokens", "paged_attention", "speculative_k")


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


class Batcher:
    """Dynamic batching: concurrent requests arriving within a small window
    coalesce into one device call: forward requests into one padded
    forward, generate requests into one ragged decode (per-row prompt
    lengths and sampling controls, ``ModelServer.generate_ragged``).

    Right-padding preserves outputs only for causal models (later
    positions never influence earlier ones), so ``ServerSet`` routes only
    generative families through a batcher. Rows pad to the group's longest
    sequence (a multiple of 16) and the batch to the next power of two, and
    decode lengths round up to a power of two; results are sliced back per
    request."""

    def __init__(self, server: ModelServer, max_batch: int = 32, window_ms: float = 3.0) -> None:
        self.server = server
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()
        # decodes run for seconds; running them off the window thread keeps
        # it collecting the next group meanwhile (on the device a forward
        # group still waits for the decode's lock). One worker keeps decode
        # groups in order.
        self._gen_pool = ThreadPoolExecutor(max_workers=1)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self.batches = 0  # device calls issued

    def _submit(self, kind: str, tokens: np.ndarray, n: int, samp=None):
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2 or tokens.shape[0] < 1 or tokens.shape[1] < 1:
            # validate before enqueueing: a malformed request inside _run
            # would fail every other request coalesced into its group
            raise ValueError(
                f"tokens must be non-empty 2-D [batch, seq], got shape {tokens.shape}")
        fut: Future = Future()
        # enqueue under the close lock, so a racing close() cannot consume
        # the sentinel and exit between our check and our put
        with self._close_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put((kind, tokens, n, samp, fut))
        return fut.result()

    def forward_argmax(self, tokens: np.ndarray) -> np.ndarray:
        return self._submit("fwd", tokens, 0)

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """Returns [B, S + max_new_tokens] (prompt + generated), as
        ``ModelServer.generate``. A coalesced batch can mix greedy and
        sampled rows."""
        return self._submit("gen", tokens, max_new_tokens,
                            (float(temperature), int(top_k), float(top_p), int(seed)))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._drain_closed()
                return
            group = [item]
            deadline = time.monotonic() + self.window_s
            while len(group) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run(group)
                    self._drain_closed()
                    return
                group.append(nxt)
            self._run(group)

    def _drain_closed(self) -> None:
        """Fail anything that raced past close() rather than hang its waiter."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[-1].set_exception(RuntimeError("batcher is closed"))

    def _run(self, group: list) -> None:
        fwd = [(t, f) for kind, t, _n, _s, f in group if kind == "fwd"]
        gen = [(t, n, s, f) for kind, t, n, s, f in group if kind == "gen"]
        if gen:
            # off the window thread: a long decode must not stop the next
            # window from collecting
            try:
                self._gen_pool.submit(self._run_generate, gen)
            except RuntimeError:  # pool shut down by a racing close(): inline
                self._run_generate(gen)
        if fwd:
            self._run_forward(fwd)

    @staticmethod
    def _pack(token_rows: list) -> tuple:
        """Right-pad a list of [b, s] token arrays into one batch: seq to a
        multiple of 16, rows to a power of two. Returns (batch,
        spans=[(start, b, s)])."""
        rows = sum(t.shape[0] for t in token_rows)
        pad_s = pad_seq_len(max(t.shape[1] for t in token_rows))
        batch = np.zeros((1 << (rows - 1).bit_length(), pad_s), np.int32)
        r = 0
        spans = []
        for tokens in token_rows:
            b, s = tokens.shape
            batch[r : r + b, :s] = tokens
            spans.append((r, b, s))
            r += b
        return batch, spans

    def _run_forward(self, group: list) -> None:
        try:
            batch, spans = self._pack([t for t, _f in group])
            out = self.server.forward_argmax(batch)
            self.batches += 1
            for (_tokens, fut), (start, b, s) in zip(group, spans):
                fut.set_result(out[start : start + b, :s])
        except Exception as e:
            for _tokens, fut in group:
                if not fut.done():
                    fut.set_exception(e)

    def _run_generate(self, group: list) -> None:
        """One ragged decode for the group: rows pad right to a common
        16-aligned length, decode steps round up to a power of two (at least
        8), each request slices back its rows and first n tokens.
        Per-request sampling controls become per-row vectors; an all-greedy
        group decodes greedy."""
        try:
            batch, spans = self._pack([t for t, _n, _s, _f in group])
            new_bucket = 1 << max(3, (max(n for _t, n, _s, _f in group) - 1).bit_length())
            pad_b = batch.shape[0]
            row_lens = np.ones(pad_b, np.int32)  # pad rows decode harmlessly
            for start, b, s in spans:
                row_lens[start : start + b] = s
            sampling: dict = {}
            if any(samp[0] > 0 for _t, _n, samp, _f in group):
                temp = np.zeros(pad_b, np.float32)
                seeds = np.zeros(pad_b, np.int32)
                # filters only when a request that samples asked for one: a
                # greedy request's stray filter values must not add filter work
                use_k = any(samp[0] > 0 and samp[1] > 0 for _t, _n, samp, _f in group)
                use_p = any(samp[0] > 0 and samp[2] < 1.0 for _t, _n, samp, _f in group)
                top_k = np.zeros(pad_b, np.int32) if use_k else None
                top_p = np.ones(pad_b, np.float32) if use_p else None
                for (_t, _n, samp, _f), (start, b, _s) in zip(group, spans):
                    temp[start : start + b] = samp[0]
                    if use_k:
                        top_k[start : start + b] = samp[1]
                    if use_p:
                        top_p[start : start + b] = samp[2]
                    # distinct per-row streams within a multi-row request
                    seeds[start : start + b] = (samp[3] + np.arange(b)) % (2**31)
                sampling = {"temperature": temp, "top_k": top_k, "top_p": top_p,
                            "seeds": seeds}
            out = self.server.generate_ragged(batch, row_lens, new_bucket, **sampling)
            self.batches += 1
            # the padded rows and the bucket rounding are implementation
            # details: account only the tokens requests asked for
            self.server.stats["tokens_generated"] += sum(
                b * n for (_t, n, _ss, _f), (_r, b, _s) in zip(group, spans))
            for (tokens, n, _samp, fut), (start, b, _s) in zip(group, spans):
                fut.set_result(np.concatenate([tokens, out[start : start + b, :n]], axis=1))
        except Exception as e:
            for _tokens, _n, _samp, fut in group:
                if not fut.done():
                    fut.set_exception(e)

    def close(self) -> None:
        with self._close_lock:
            self._closed = True
            self._q.put(None)
        # let an in-flight decode finish delivering its futures
        self._gen_pool.shutdown(wait=False)


class ServerSet:
    """Named ModelServers behind one HTTP front, and the model pool that
    owns their lifecycle (``dl/lifecycle.ModelPool``, always built)."""

    # the decode budget a request may ask for (native and OpenAI surfaces)
    max_new_tokens_limit = DEFAULT_MAX_NEW_TOKENS_LIMIT

    def __init__(self, servers: dict[str, ModelServer], default: str | None = None,
                 stream_chunk_size: int = 8, dynamic_batch: bool = False,
                 max_batch: int = 32, batch_window_ms: float = 3.0,
                 hbm_budget_bytes: int = 0, evict_idle: bool = False,
                 allow_admin_load: bool = False, admin_tokens: tuple[str, ...] = (),
                 staging_root: str = "", host_state_budget_bytes: int = 0,
                 disk_state_budget_bytes: int = 0, state_spool_dir: str = "",
                 continuous_batch: bool = False, max_slots: int = 8,
                 kv_page_size: int = 0, kv_live_tokens: int = 0,
                 kv_attention: str = "gather", pipeline_depth: int = 2,
                 dispatch_depth: int = 0, burst_window_ms: float = 1.0,
                 prefill_chunk: int = 0, prefill_budget: int = 0,
                 max_queue_depth: int = 0, request_timeout_s: float = 0.0,
                 boundary_watchdog_s: float = 0.0, flight_recorder: bool = True,
                 flightrec_capacity: int = 0, flight_dump_dir: str = "",
                 trace_dir: str = "", device_telemetry: bool = True, mesh=None) -> None:
        if not servers:
            raise ValueError("no models")
        self.servers = servers
        # the serving mesh every tenant shares (None: one device), and on
        # its rank 0 the op log the other ranks replay (serve_main)
        self.mesh = mesh
        self.oplog = None
        # on a mesh, the one device lock of every model (followers replay
        # one op log in order, so rank 0's calls are ordered across models)
        self.device_lock = threading.RLock()
        # the model set changes at runtime (the pool's loads and unloads):
        # every structural change goes through add_server/remove_server
        # under this lock
        self._servers_lock = threading.RLock()
        self.stream_chunk_size = int(stream_chunk_size)
        self._dynamic_batch = bool(dynamic_batch)
        self.max_batch = int(max_batch)
        self.batch_window_ms = float(batch_window_ms)
        self._batcher_lock = threading.Lock()
        self.batchers: dict[str, Batcher] = {}
        # the continuous engine's knobs (dl/continuous.py, its parameter
        # names), one engine per model, built on first use under a per-model lock
        self._continuous_batch = bool(continuous_batch)
        self.engine_kwargs = dict(
            max_slots=int(max_slots), page_size=int(kv_page_size),
            max_live_tokens=int(kv_live_tokens), paged_attention=str(kv_attention),
            pipeline_depth=int(pipeline_depth), dispatch_depth=int(dispatch_depth),
            burst_window_ms=float(burst_window_ms), prefill_chunk=int(prefill_chunk),
            prefill_budget=int(prefill_budget), max_queue_depth=int(max_queue_depth),
            request_timeout_s=float(request_timeout_s),
            boundary_watchdog_s=float(boundary_watchdog_s),
            flight_recorder=bool(flight_recorder), flightrec_capacity=int(flightrec_capacity),
            flight_dump_dir=str(flight_dump_dir or ""))
        self.cbatchers: dict = {}
        self._engine_locks: dict[str, threading.Lock] = {}
        for name, s in servers.items():
            s.name = name  # route key and server identity must agree
        self.default = default or next(iter(servers))
        # the template for runtime-loaded ModelServers (the pool's admin
        # loads): the boot set's device, dtype, context budget,
        # quantization and cache knobs
        first = next(iter(servers.values()))
        self.server_defaults: dict = {
            "device": first.device,
            "dtype": str(first.dtype).removeprefix("torch."),
            "max_seq_len": first.max_seq_len,
            "quantize": first.quantize,
            "speculative_k": first.speculative_k,
        }
        if mesh is not None:
            self.server_defaults.update(mesh=mesh, attention_impl=first.attention_impl)
        if first._prefix_cache is not None:
            self.server_defaults.update(
                prefix_cache_size=first._prefix_cache.capacity,
                prefix_cache_max_bytes=first._prefix_cache.max_bytes,
            )
        # bearer tokens gating the /admin surface (empty = anonymous admin,
        # for single-tenant dev pods and tests)
        self.admin_tokens = tuple(admin_tokens)
        # profiler captures: /v1/profile writes into trace_dir, /admin/profile
        # into numbered dirs under trace_dir/captures (the newest
        # MAX_PROFILE_CAPTURES kept); one capture at a time across both
        self.trace_dir = trace_dir or os.path.join(os.getcwd(), "torch-trace")
        self._profiling = threading.Lock()
        self._capture_seq = 0
        self._capture_lock = threading.Lock()
        # measured device memory (utils/devmem) in the /metrics device family
        self.device_telemetry = bool(device_telemetry)
        # windowed pod rates (utils/tswheel): requests/s, 5xx/s, sheds/s
        # over 1m/5m, marked once per completed POST in the handler
        self.rates = tswheel.RateSet(("requests", "http_5xx", "sheds"))
        # set on SIGTERM: /healthz answers 503 "draining" so load balancers
        # stop routing here while in-flight requests finish
        self.draining = False
        # live POST count (streams included, until their last byte): the
        # SIGTERM drain in serve_main waits for it to reach zero
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.pool = ModelPool(
            self, hbm_budget_bytes=hbm_budget_bytes, evict_idle=evict_idle,
            allow_admin_load=allow_admin_load, staging_root=staging_root,
            host_state_budget_bytes=host_state_budget_bytes,
            disk_state_budget_bytes=disk_state_budget_bytes,
            state_spool_dir=state_spool_dir, mesh=mesh,
        )

    @property
    def mesh_size(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def request_began(self) -> None:
        with self._inflight_lock:
            self._inflight += 1

    def request_ended(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def next_capture_dir(self) -> str:
        """A fresh numbered capture dir under ``trace_dir/captures`` for one
        on-demand profiler run; prunes all but the newest
        ``MAX_PROFILE_CAPTURES - 1`` existing captures first (the new one
        brings the total back to the cap)."""
        import shutil

        root = os.path.join(self.trace_dir, "captures")
        with self._capture_lock:
            self._capture_seq += 1
            seq = self._capture_seq
        os.makedirs(root, exist_ok=True)
        keep = MAX_PROFILE_CAPTURES - 1
        old = sorted((d for d in os.listdir(root)
                      if d.startswith("cap-") and os.path.isdir(os.path.join(root, d))),
                     key=lambda d: os.path.getmtime(os.path.join(root, d)))
        for name in old[:max(0, len(old) - keep)]:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        path = os.path.join(root, "cap-%d-%d" % (int(time.time()), seq))
        os.makedirs(path, exist_ok=True)
        return path

    def metrics_payload(self) -> dict:
        """The ``GET /metrics`` tree, as the JAX sidecar builds it: per model
        its stats with the continuous engine's snapshot, the prefix cache
        and its lifecycle gauges; pool entries without a server yet; the
        pool, the windowed rates, the control plane and, with device
        telemetry on, the measured device memory."""
        payload: dict = {}
        lifecycle = self.pool.states()
        for n, s in list(self.servers.items()):
            d = dict(s.stats)
            cb = self.cbatchers.get(n)
            if cb is not None:
                d["continuous"] = cb.snapshot()
            if s._prefix_cache is not None:
                d["prefix_cache"] = s._prefix_cache.stats()
            if n in lifecycle:
                d["lifecycle"] = lifecycle[n]
            payload[n] = d
        for n, st in lifecycle.items():
            if n not in payload:  # PULLING/UNLOADED: no server yet
                payload[n] = {"lifecycle": st}
        if "pool" not in payload:
            payload["pool"] = self.pool.pool_snapshot()
        payload["rates"] = self.rates.snapshot()
        payload["control_plane"] = manifest_cache.health().status()
        if self.device_telemetry:
            payload["device"] = devmem.sample()
        return payload

    def add_server(self, name: str, server: ModelServer) -> None:
        """Insert a runtime-loaded model into the routing set (the pool's
        READY transition)."""
        with self._servers_lock:
            server.name = name
            self.servers[name] = server

    def remove_server(self, name: str, close: bool = True):
        """Remove a model from routing; returns ``(server, batcher,
        engine)``. With ``close`` the window batcher and the continuous
        engine close here and the engine's KV state is released; the pool
        passes ``close=False`` and closes them outside its lock."""
        with self._servers_lock:
            server = self.servers.pop(name, None)
            with self._batcher_lock:
                batcher = self.batchers.pop(name, None)
                cb = self.cbatchers.pop(name, None)
                self._engine_locks.pop(name, None)
            if self.default == name and self.servers:
                ready = [n for n, s in self.servers.items() if s.ready]
                self.default = (ready or list(self.servers))[0]
        if close:
            if batcher is not None:
                batcher.close()
            if cb is not None:
                cb.close()
                cb.release_device_state()
        return server, batcher, cb

    @property
    def ready(self) -> bool:
        """Readiness over the healthy set: models whose load crashed are
        FAILED (reported on /healthz and /v1/models) but do not hold the
        pod un-ready while the others serve. Empty, all-failed or draining
        is not ready."""
        if self.draining:
            return False
        with self._servers_lock:
            healthy = [s for s in self.servers.values() if s.load_error is None]
        return bool(healthy) and all(s.ready for s in healthy)

    def serving_stats(self) -> dict:
        """Per-model load and locality for GET /admin/models:
        ``queue_depth``/``active``/``waiting`` and ``engine_state`` from the
        continuous engine (0s when it is off: the plain path has no
        backlog), and the prefix cache's counters."""
        with self._servers_lock:
            pairs = [(n, s, self.cbatchers.get(n)) for n, s in self.servers.items()]
        out: dict = {}
        for name, s, cb in pairs:
            d: dict = {"queue_depth": 0, "active": 0, "waiting": 0}
            if cb is not None:
                snap = cb.snapshot()
                d["queue_depth"] = int(snap.get("queue_depth", 0))
                d["active"] = int(snap.get("active", 0))
                d["waiting"] = int(snap.get("waiting", 0))
                d["engine_state"] = snap.get("engine_state", "running")
            if s._prefix_cache is not None:
                d["prefix_cache"] = s._prefix_cache.stats()
            out[name] = d
        return out

    def load_all(self, concurrent: bool = False) -> dict:
        """Load every model, driving the pool's LOADING -> READY | FAILED;
        ``concurrent`` overlaps the loads. A model that fails is FAILED
        (reported on /healthz and /v1/models) while the others serve.
        Raises only when every model failed."""
        def _load(s: ModelServer, catch=Exception) -> None:
            self.pool.mark_loading(s.name)
            try:
                s.load()
            except catch as e:
                s.load_error = str(e)
                errs[s.name] = e
                self.pool.mark_failed(s.name, str(e))
                logger.error("loading %s failed (tenant marked FAILED, others keep "
                             "serving): %s", s.name, e)
            else:
                self.pool.mark_ready(s.name)

        errs: dict[str, BaseException] = {}
        servers = list(self.servers.values())
        if concurrent and len(servers) > 1:
            # worker threads catch BaseException: a crash surfaces as a
            # FAILED tenant, not a silently dead thread
            threads = [threading.Thread(target=_load, args=(s, BaseException), daemon=True)
                       for s in servers]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            # on the main thread: Exception only, so a Ctrl-C still aborts
            for s in servers:
                _load(s)
        if errs and len(errs) == len(servers):
            name, err = next(iter(errs.items()))
            raise RuntimeError(f"loading {name} failed: {err}") from err
        return {n: dict(s.stats, **({"error": s.load_error} if s.load_error else {}))
                for n, s in self.servers.items()}

    def resolve(self, path: str) -> tuple[ModelServer | None, str | None]:
        """(server, verb) for a POST path; (None, None) if unroutable."""
        with self._servers_lock:
            if path in ("/v1/forward", "/v1/generate"):
                server = self.servers.get(self.default)
                return server, (path.rsplit("/", 1)[1] if server else None)
            m = _MODEL_ROUTE.match(path)
            if m and m.group("model") in self.servers:
                return self.servers[m.group("model")], m.group("verb")
        return None, None

    def route_name(self, path: str) -> str | None:
        """The model name a POST path addresses, resolved or not: the 404
        path asks the pool about it, so a PULLING/LOADING model answers 503
        + Retry-After instead of 404."""
        if path in ("/v1/forward", "/v1/generate"):
            return self.default
        m = _MODEL_ROUTE.match(path)
        return m.group("model") if m else None

    def batcher_for(self, server: ModelServer) -> Batcher | None:
        """The model's window batcher, created on first use once the model
        is loaded; None without ``dynamic_batch`` or for a family that is
        not generative (right-padding changes an encoder's outputs)."""
        if (not self._dynamic_batch or server.family is None
                or server.family.generate_ragged is None):
            return None
        b = self.batchers.get(server.name)
        if b is None:
            with self._batcher_lock:
                b = self.batchers.get(server.name)
                if b is None:
                    b = self.batchers[server.name] = Batcher(
                        server, max_batch=self.max_batch, window_ms=self.batch_window_ms)
        return b

    def continuous_for(self, server: ModelServer):
        """The model's continuous engine, created on first use (cached
        decode families only; None without ``continuous_batch``). When on
        it takes every generate and single-row stream. Construction (the
        whole KV allocation) runs under a PER-MODEL lock so other tenants'
        traffic never waits behind it; an out-of-memory allocation demotes
        idle tenants (``ModelPool.shed_idle_for_bytes``) and retries once."""
        if (not self._continuous_batch or server.family is None
                or server.family.decode_fns is None):
            return None
        cb = self.cbatchers.get(server.name)
        if cb is not None:
            return cb
        with self._batcher_lock:
            lk = self._engine_locks.setdefault(server.name, threading.Lock())
        with lk:
            cb = self.cbatchers.get(server.name)
            if cb is None:
                from modelx_tpu_torch.dl import tiers as tiers_mod
                from modelx_tpu_torch.dl.continuous import ContinuousBatcher

                max_len = server.max_seq_len
                n_pos = getattr(server.cfg, "n_positions", 0) or 0
                if n_pos:  # gpt2: no wpe row past n_positions
                    max_len = min(max_len, n_pos)
                page_size = self.engine_kwargs["page_size"]
                if page_size > 0 and max_len % page_size:
                    # clamp max_len DOWN to a page multiple (losing < one
                    # page of context) rather than degrade the page size
                    clamped = (max_len // page_size) * page_size
                    if clamped <= 0:
                        logger.warning("kv_page_size %d exceeds max_len %d for %s; "
                                       "paged KV disabled", page_size, max_len, server.name)
                        page_size = 0
                    else:
                        logger.warning("max_len %d -> %d for %s (kv_page_size %d multiple)",
                                       max_len, clamped, server.name, page_size)
                        max_len = clamped

                def build():
                    # --speculative-k composes: the engine speculates
                    # whenever exactly one greedy row is active
                    kwargs = {**self.engine_kwargs, "page_size": page_size,
                              "chunk_size": self.stream_chunk_size, "max_len": max_len,
                              "speculative_k": server.speculative_k}
                    with contextlib.ExitStack() as held:
                        if server.oplog is not None:
                            # the followers build the same device state
                            held.enter_context(server._device_lock)
                            server._post("engine_open", **{
                                k: kwargs[k] for k in REPLICA_ENGINE_KWARGS})
                        return ContinuousBatcher(
                            server, **kwargs, prefix_cache=server._prefix_cache,
                            device_telemetry=self.device_telemetry)

                try:
                    cb = build()
                except Exception as exc:
                    if not tiers_mod.is_resource_exhausted(exc):
                        raise
                    # the partial allocation's frames must not keep its
                    # tensors alive through the retry
                    _without_tracebacks(exc)
                    freed = self.pool.shed_idle_for_bytes(0, exclude=server.name)
                    self.pool.flightrec.record("engine.alloc_oom_retry", model=server.name,
                                               freed_bytes=freed)
                    if freed <= 0:
                        raise EngineBrokenError(
                            f"KV allocation for {server.name} ran out of device memory "
                            "and no idle model could be demoted") from exc
                    logger.warning("KV allocation for %s ran out of device memory; demoted "
                                   "%d reserved bytes of idle state, retrying once",
                                   server.name, freed)
                    try:
                        cb = build()
                    except Exception as exc2:
                        raise EngineBrokenError(
                            f"KV allocation for {server.name} failed after demoting "
                            "idle state") from exc2
                self.cbatchers[server.name] = cb
        return cb

    def engine_health(self) -> str | None:
        """Worst continuous-engine state across tenants, or None when every
        engine is healthy: "engine-broken" (the breaker opened: the pod
        needs a restart) beats "engine-restarting" (mid-backoff)."""
        worst = None
        for cb in list(self.cbatchers.values()):
            state = getattr(cb, "engine_state", "running")
            if state == "broken":
                return "engine-broken"
            if state == "restarting":
                worst = "engine-restarting"
        return worst

    def engine_for(self, server: ModelServer, n_rows: int, temperature: float):
        """The generate-routing policy, as the JAX sidecar's: the
        continuous engine when on (it speculates itself under
        ``speculative_k``), then speculation for a single row (greedy
        token-exact, sampled by modified rejection), then the window
        batcher, then the plain server."""
        cb = self.continuous_for(server)
        if cb is not None:
            return cb
        if server.speculative_k > 0 and n_rows == 1 and server.family.decode_fns is not None:
            return server
        return self.batcher_for(server) or server

    def close(self) -> None:
        """Close the window batchers and the continuous engines (their
        waiters fail, not hang)."""
        with self._batcher_lock:
            batchers, self.batchers = list(self.batchers.values()), {}
            engines, self.cbatchers = list(self.cbatchers.values()), {}
        for b in batchers:
            b.close()
        for cb in engines:
            cb.close()

    def stream_source(self, server: ModelServer, tokens, n: int, samp: dict,
                      stop_token_ids=None, timeout_s: float | None = None,
                      priority: str = "interactive", resume_step: int = 0,
                      request_id: str = "", timing: dict | None = None):
        """The token-chunk iterator behind a stream, chunked by
        ``stream_chunk_size``. Single-row streams join the continuous
        engine when it is on; ``timeout_s``/``priority`` (a propagated
        deadline remainder and priority class), ``resume_step`` (continue a
        severed stream at step k), ``request_id`` (joins the engine
        ticket) and ``timing`` (the phase breakdown, filled when the stream
        ends) reach only it. The plain path has no deadline machinery (the
        handler's up-front expiry check is its whole contract), no
        per-request phases and no per-step streams to rejoin, so a resume
        without the engine is refused (400)."""
        cb = self.continuous_for(server)
        if cb is not None and tokens.shape[0] == 1:
            return cb.stream(tokens, max_new_tokens=n, stop_token_ids=stop_token_ids,
                             timeout_s=timeout_s, priority=priority,
                             resume_step=resume_step, request_id=request_id,
                             timing=timing, **samp)
        if resume_step:
            raise MalformedResumeError("resume requires the continuous engine (single-row stream)")
        return server.generate_stream(tokens, max_new_tokens=n,
                                      chunk_size=self.stream_chunk_size,
                                      stop_token_ids=stop_token_ids, **samp)


def _query_param(path: str, name: str) -> str:
    """One query-string value from a raw request path ("" when absent)."""
    from urllib.parse import parse_qs, urlparse

    vals = parse_qs(urlparse(path).query).get(name)
    return vals[0] if vals else ""


def _check_generate(req: dict, headers, tokens: np.ndarray, vocab: int, server: ModelServer,
                    limit: int):
    """Check a generate request as the JAX sidecar does. Returns
    ``((n, samp, stop_ids, resume), None)`` or ``(None, (status, body))``;
    ``resume`` is the parsed ``(emitted, seed)`` pair or None. A malformed
    or exhausted resume block raises its typed ``ServingError`` (400 /
    422); a well-formed one is continued by the continuous engine, or
    refused by ``stream_source`` without it."""
    try:
        n = int(req.get("max_new_tokens", 16))
    except (TypeError, ValueError):
        return None, (400, {"error": "max_new_tokens must be an integer"})
    if not (1 <= n <= limit):
        return None, (400, {"error": f"max_new_tokens must be in [1, {limit}]"})
    n_pos = getattr(server.cfg, "n_positions", 0) or 0
    if n_pos and tokens.shape[1] + n > n_pos:
        # absolute-position families (gpt2): no wpe row past n_positions
        return None, (400, {"error": f"prompt ({tokens.shape[1]}) + max_new_tokens ({n}) "
                                     f"exceeds the model's {n_pos}-position context"})
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
    return (n, samp, stop_ids, resume), None


def serve(servers: ModelServer | ServerSet, listen: str = ":8000", access_log: str = "",
          access_log_max_bytes: int = 0) -> ThreadingHTTPServer:
    """Start the HTTP front on a daemon thread; returns the server (call
    ``shutdown()`` to stop it). ``access_log`` names a JSON-lines file that
    gets one line per completed POST (rotated to ``.1`` past
    ``access_log_max_bytes`` when that is > 0)."""
    from modelx_tpu_torch.dl import openai_api as oai

    sset = servers if isinstance(servers, ServerSet) else ServerSet({servers.name: servers})
    access = accesslog.open_log(access_log, max_bytes=access_log_max_bytes)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def send_response(self, code, message=None):
            # the committed status, for the rates and the access-log line
            # (one capture point covers _json and the streaming 200)
            self._resp_status = code
            super().send_response(code, message)

        def _obs_headers(self) -> None:
            """Echo the request id and attempt on every answer of a POST
            (JSON and streamed); GETs bind none."""
            rid = getattr(self, "_rid", "")
            if rid:
                self.send_header(REQUEST_ID_HEADER, rid)
                self.send_header(ATTEMPT_HEADER, str(self._attempt))

        def _json(self, status: int, obj, headers: dict | None = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self._obs_headers()
            if getattr(self, "_rid", ""):
                # whatever phases the request reached ride as
                # X-ModelX-Timing-* headers: a 504 still reports its queue time
                timing = dict(self._timing)
                timing["total_ms"] = round((time.monotonic() - self._t0) * 1e3, 3)
                for k, v in timing_headers(timing).items():
                    self.send_header(k, v)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _text(self, status: int, text: str, content_type: str) -> None:
            body = text.encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
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
            self._obs_headers()
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

        def _stream_generate(self, server, tokens, n, samp, stop_ids,
                             timeout_s=None, priority="interactive", resume_step=0,
                             include_timing=False) -> None:
            """NDJSON token stream, then {"done": true}; concatenated it
            equals the non-streamed result. A single row streams ONE token
            per line ({"tokens": [[t]]}), several rows one line per chunk.
            ``include_timing`` adds a {"timing": ...} line before the done
            line: the engine's phase breakdown (none without the engine) and
            the handler's total."""
            kw = deadline_kwargs(timeout_s, priority)
            if resume_step:
                kw["resume_step"] = resume_step
            timing: dict = self._timing
            gen = sset.stream_source(server, tokens, n, samp, stop_token_ids=stop_ids,
                                     request_id=self._rid, timing=timing, **kw)
            try:
                # pull the first chunk BEFORE committing a 200: a bad
                # request must still be a 4xx
                try:
                    first = next(gen, None)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except NotPortedError as e:
                    return self._json(e.http_status, e.payload())
                except ServingError as e:
                    return self._json(e.http_status, {"error": str(e)}, headers=e.headers())

                def payloads():
                    emitted = 0
                    if first is not None:
                        for piece in itertools.chain([first], gen):
                            rows = piece.tolist()
                            if len(rows) == 1:
                                for t in rows[0]:
                                    emitted += 1
                                    yield json.dumps({"tokens": [[t]]}).encode() + b"\n"
                            else:
                                emitted += sum(len(r) for r in rows)
                                yield json.dumps({"tokens": rows}).encode() + b"\n"
                    if include_timing:
                        # closing the source runs the engine's finally, so
                        # the breakdown is complete
                        gen.close()
                        yield json.dumps({"timing": self._finish_timing(timing, emitted)}
                                         ).encode() + b"\n"
                    yield b'{"done": true}\n'

                self._stream_chunks(
                    "application/x-ndjson", payloads(),
                    lambda e: json.dumps({"error": str(e)}).encode() + b"\n")
            finally:
                gen.close()  # a client that went away frees the stream now

        def _finish_timing(self, timing: dict, emitted: int) -> dict:
            """A phase breakdown completed with the handler's view: wall
            total, emitted count and the decode rate (tokens after the
            first over the post-TTFT wall time)."""
            t = dict(timing)
            total_ms = round((time.monotonic() - self._t0) * 1e3, 3)
            t["total_ms"] = total_ms
            t["tokens"] = emitted
            ttft = t.get("ttft_ms")
            if ttft is not None and emitted > 1 and total_ms > ttft:
                t["decode_tps"] = round((emitted - 1) / ((total_ms - ttft) / 1e3), 2)
            self._timing.update(t)  # the access-log line sees it too
            return t

        def _openai(self, req: dict, chat: bool) -> None:
            """/v1/completions + /v1/chat/completions (openai_api.py). SSE
            for stream=true; errors use the OpenAI {"error": {...}} shape."""
            # the lifecycle gate, in the OpenAI error shape: the same typed
            # errors the native surface maps
            name = str(req.get("model") or sset.default)
            self._log_model = name
            try:
                sset.pool.check_admission(name)
                sset.pool.enter(name)  # raises 409 if a drain raced in
            except ServingError as e:
                api = oai.api_error_for(e)
                return self._json(api.status, api.payload, headers=e.headers())
            # an expired budget answers 504 in the OpenAI shape before any work
            timeout_s = parse_deadline_ms(self.headers.get(DEADLINE_HEADER))
            priority = parse_priority(self.headers.get(PRIORITY_HEADER))
            if timeout_s is not None and timeout_s <= 0:
                e = DeadlineExceededError("admitting", timeout_s)
                api = oai.api_error_for(e)
                sset.pool.exit(name)
                return self._json(api.status, api.payload, headers=e.headers())
            try:
                # the resume block: headers win over the native field, each
                # both-or-neither (the same wire block as the native surface)
                resume = None
                hdr_e = self.headers.get(RESUME_EMITTED_HEADER)
                hdr_s = self.headers.get(RESUME_SEED_HEADER)
                if hdr_e is not None or hdr_s is not None:
                    resume = parse_resume(hdr_e, hdr_s)
                else:
                    rz = req.get("resume")
                    if rz is not None:
                        if not isinstance(rz, dict):
                            raise MalformedResumeError(
                                "resume must be an object with emitted + seed")
                        resume = parse_resume(rz.get("emitted"), rz.get("seed"))
                if resume is not None and not bool(req.get("stream", False)):
                    raise MalformedResumeError("resume requires a streaming request")
                if bool(req.get("stream", False)):
                    events = oai.stream_completion(sset, req, chat, timeout_s=timeout_s,
                                                   priority=priority, resume=resume,
                                                   request_id=self._rid, timing=self._timing)
                    try:
                        try:
                            # validation and decode errors must surface as a
                            # real status: pull the first event before the 200
                            first = next(events, None)
                        except ValueError as e:
                            raise oai.APIError(400, str(e)) from e

                        def payloads():
                            if first is not None:
                                yield oai.sse_encode(first)
                                for ev in events:
                                    yield oai.sse_encode(ev)
                            yield oai.SSE_DONE

                        return self._stream_chunks(
                            "text/event-stream", payloads(),
                            # typed serving errors keep their one payload
                            # after the 200 is on the wire
                            lambda e: oai.sse_encode(
                                oai.api_error_for(e).payload
                                if isinstance(e, ServingError)
                                else {"error": {"message": str(e), "type": "server_error"}}))
                    finally:
                        events.close()  # a client that went away frees the stream now
                return self._json(200, oai.run_completion(sset, req, chat, timeout_s=timeout_s,
                                                          priority=priority, timing=self._timing))
            except oai.APIError as e:
                return self._json(e.status, e.payload, headers=e.headers)
            except ValueError as e:
                return self._json(400, oai.APIError(400, str(e)).payload)
            except ServingError as e:
                api = oai.api_error_for(e)
                return self._json(api.status, api.payload, headers=e.headers())
            except NotPortedError as e:
                api = oai.APIError(e.http_status, str(e), "not_ported")
                return self._json(api.status, api.payload)
            except Exception as e:
                logger.exception("openai api error")
                return self._json(500, oai.APIError(500, str(e), "server_error").payload)
            finally:
                sset.pool.exit(name)

        def _admin_auth(self) -> bool:
            """Bearer-token filter for the /admin surface (--admin-token);
            no tokens = anonymous admin. Returns False after writing the
            401."""
            if not sset.admin_tokens:
                return True
            import hmac

            authz = self.headers.get("Authorization", "")
            presented = authz[len("Bearer "):] if authz.startswith("Bearer ") else ""
            # constant time per candidate: the token gates model load/unload
            if any(hmac.compare_digest(presented, t) for t in sset.admin_tokens):
                return True
            self._json(401, {"error": "invalid or missing bearer token"})
            return False

        def do_GET(self):
            # GETs share keep-alive connections with POSTs: clear the
            # per-request state a previous POST bound
            self._rid = ""
            self._resp_status = 0
            if self.path == "/healthz":
                engine = sset.engine_health()
                failed = sset.pool.failed()
                # registry reachability rides beside readiness, never in it:
                # a pod serving through a registry outage stays 200
                cp = manifest_cache.health().status()
                if engine is not None:
                    # a restarting or circuit-broken engine flips readiness
                    # so load balancers drain instead of routing into it
                    self._json(503, {"status": engine, "control_plane": cp})
                elif sset.ready:
                    # degraded: some tenants FAILED, the rest serve
                    if failed:
                        self._json(200, {"status": "degraded", "failed": failed,
                                         "control_plane": cp})
                    else:
                        self._json(200, {"status": "ok", "control_plane": cp})
                else:
                    status = "draining" if sset.draining else (
                        "failed" if failed else "loading")
                    body = {"status": status, "control_plane": cp}
                    if failed:
                        body["failed"] = failed
                    # loading resolves on its own: say when to look again
                    headers = {} if sset.draining else {"Retry-After": "2"}
                    self._json(503, body, headers=headers)
            elif self.path == "/livez":
                # liveness, apart from readiness: fails ONLY once an
                # engine's breaker opened (a restart is the cure); loading,
                # draining and a supervised restart are all alive
                if sset.engine_health() == "engine-broken":
                    self._json(503, {"status": "engine-broken"})
                else:
                    self._json(200, {"status": "ok"})
            elif self.path == "/admin/models":
                if not self._admin_auth():
                    return
                self._json(200, {
                    "models": sset.pool.states(),
                    "pool": sset.pool.pool_snapshot(),
                    "serving": sset.serving_stats(),
                    "control_plane": manifest_cache.health().status(),
                })
            elif self.path.split("?", 1)[0] == "/metrics":
                payload = sset.metrics_payload()
                # the same tree as Prometheus text on Accept: text/plain or
                # ?format=prometheus; model names and device indices become
                # labels, not metric-name fragments
                if promexp.wants_prometheus(self.headers.get("Accept"),
                                            _query_param(self.path, "format")):
                    self._text(200, promexp.render(payload, label_levels={
                        ("*",): "model", ("*", "devices", "*"): "device"}),
                        promexp.CONTENT_TYPE)
                else:
                    self._json(200, payload)
            elif self.path == "/v1/models":
                # one body, two contracts: the native {default, models} keys
                # plus OpenAI's {object: "list", data: [...]}
                self._json(200, oai.models_payload(sset))
            elif self.path.split("?", 1)[0] == "/v1/trace":
                # ?request_id= slices one request's timeline, ?prefix= a
                # span path (both optional)
                self._json(200, trace.tracer().summary(
                    prefix=_query_param(self.path, "prefix"),
                    request_id=_query_param(self.path, "request_id")))
            elif self.path.split("?", 1)[0] == "/debug/flightrec":
                # the engines' and the pool's flight-recorder rings,
                # admin-gated (events carry request ids), with
                # ?request_id= slicing
                if not self._admin_auth():
                    return
                rid = _query_param(self.path, "request_id") or None
                body = {}
                for n, cb in list(sset.cbatchers.items()):
                    if cb.flightrec is not None:
                        body[n] = cb.flightrec.summary(rid)
                body["pool"] = sset.pool.flightrec.summary(rid)
                self._json(200, body)
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            """DELETE /admin/models/{name}: stop admission (new requests 409
            while draining, 404 once gone), drain in-flight requests, then
            free params, decoders and pool-owned staging. ``?wait=0``
            answers 202 at once and drains in the background."""
            m = _ADMIN_MODEL_ROUTE.match(self.path)
            if m is None:
                return self._json(404, {"error": "not found"})
            if not self._admin_auth():
                return
            if not sset.pool.allow_admin_load:
                return self._json(403, {
                    "error": "admin model unloading is disabled "
                             "(start with --allow-admin-load)"})
            wait = _query_param(self.path, "wait") not in ("0", "false")
            try:
                snap = sset.pool.request_unload(m.group("model"), wait=wait)
            except PoolError as e:
                return self._json(e.status, {"error": str(e)}, headers=e.headers or None)
            return self._json(200 if wait else 202, snap)

        def do_POST(self):
            # pod-level in-flight count for the SIGTERM drain: a request
            # counts until its last byte (streams included)
            sset.request_began()
            # the end-to-end request id: the client's when well formed,
            # else minted here; it binds every span this thread closes, is
            # echoed on the answer and joins the engine ticket
            self._rid = (parse_request_id(self.headers.get(REQUEST_ID_HEADER))
                         or mint_request_id())
            self._attempt = parse_attempt(self.headers.get(ATTEMPT_HEADER))
            self._timing = {}
            self._resp_status = 0
            self._log_model = ""
            self._t0 = time.monotonic()
            path = self.path.split("?", 1)[0]
            try:
                with trace.request_context(self._rid), \
                        trace.span("serve.request", http_path=path, attempt=self._attempt):
                    self._do_POST()
            finally:
                sset.request_ended()
                # windowed rates: one mark per request, plus its outcome class
                sset.rates.mark("requests")
                if self._resp_status >= 500:
                    sset.rates.mark("http_5xx")
                elif self._resp_status == 429:
                    sset.rates.mark("sheds")
                if access is not None:
                    access.write(
                        request_id=self._rid, attempt=self._attempt,
                        client=client_identity(self.headers, self.client_address),
                        path=path, model=self._log_model, status=self._resp_status,
                        ms=round((time.monotonic() - self._t0) * 1e3, 3), timing=self._timing)

        def _do_POST(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            try:
                req = json.loads(self.rfile.read(length)) if length else {}
            except ValueError as e:
                return self._json(400, {"error": f"bad request: {e}"})
            if not isinstance(req, dict):
                return self._json(400, {"error": "request body must be a JSON object"})
            path = self.path.split("?", 1)[0]
            if self.path == "/v1/profile":
                try:
                    seconds = float(req.get("seconds", 3))
                except (TypeError, ValueError):
                    seconds = -1.0
                if not (0 <= seconds <= MAX_PROFILE_SECONDS):
                    return self._json(400, {
                        "error": f"seconds must be a number in [0, {MAX_PROFILE_SECONDS}]"})
                if not sset._profiling.acquire(blocking=False):
                    return self._json(409, {"error": "profile already running"})
                try:
                    # the window records what other requests run meanwhile:
                    # it holds no device lock
                    with trace.torch_profile(sset.trace_dir):
                        time.sleep(seconds)
                finally:
                    sset._profiling.release()
                return self._json(200, {"trace_dir": sset.trace_dir})
            if self.path == "/admin/profile":
                # the same one-at-a-time lock as /v1/profile, admin-gated,
                # into a fresh capped capture dir
                if not self._admin_auth():
                    return
                try:
                    seconds = float(req.get("duration_s", 3))
                except (TypeError, ValueError):
                    seconds = -1.0
                if not (0 < seconds <= MAX_PROFILE_SECONDS):
                    return self._json(400, {
                        "error": f"duration_s must be a number in (0, {MAX_PROFILE_SECONDS}]"})
                if not sset._profiling.acquire(blocking=False):
                    return self._json(409, {"error": "profile already running"})
                try:
                    capture_dir = sset.next_capture_dir()
                    with trace.torch_profile(capture_dir):
                        time.sleep(seconds)
                finally:
                    sset._profiling.release()
                return self._json(200, {"capture_dir": capture_dir, "duration_s": seconds})
            if self.path == "/admin/models":
                # a runtime load: pull a registry ref (or point at a local
                # dir) and load it while traffic is live
                if not self._admin_auth():
                    return
                wait = bool(req.get("wait", False))
                try:
                    snap = sset.pool.request_load(
                        str(req.get("name") or ""), ref=str(req.get("ref") or ""),
                        model_dir=str(req.get("model_dir") or ""), wait=wait)
                except PoolError as e:
                    # a 507 that demotion could clear carries Retry-After
                    return self._json(e.status, {"error": str(e)}, headers=e.headers or None)
                return self._json(200 if wait else 202, snap)
            if path in ("/v1/completions", "/v1/chat/completions"):
                return self._openai(req, chat=path.endswith("chat/completions"))
            server, verb = sset.resolve(path)
            if server is not None:
                self._log_model = server.name
            if server is None:
                # a name the routing set does not know may still be a pool
                # entry: PULLING/LOADING 503 + Retry-After, FAILED 503 + the
                # reason; only unknown names 404
                name = sset.route_name(path)
                err = sset.pool.routing_error(name) if name else None
                if err is not None:
                    return self._json(err.http_status, {"error": str(err)},
                                      headers=err.headers())
                return self._json(404, {"error": "not found"})
            try:
                # DRAINING models still sit in the routing set while their
                # in-flight requests finish, but admit no new ones (409)
                sset.pool.check_admission(server.name)
            except ServingError as e:
                return self._json(e.http_status, {"error": str(e)}, headers=e.headers())
            # an already-expired propagated budget answers 504 before any
            # tokenization or engine work
            timeout_s = parse_deadline_ms(self.headers.get(DEADLINE_HEADER))
            priority = parse_priority(self.headers.get(PRIORITY_HEADER))
            if timeout_s is not None and timeout_s <= 0:
                e = DeadlineExceededError("admitting", timeout_s)
                return self._json(e.http_status, {"error": str(e)}, headers=e.headers())
            if "text" in req and "tokens" in req:
                return self._json(400, {"error": "send either text or tokens, not both"})
            if "text" in req and verb != "generate":
                return self._json(400, {"error": "text is only supported on generate"})
            try:
                tok = None
                if "text" in req:
                    # text in, text out: needs the model's tokenizer.json
                    if not isinstance(req["text"], str) or not req["text"]:
                        raise ValueError("text must be a non-empty string")
                    if bool(req.get("stream", False)):
                        return self._json(400, {
                            "error": "text with stream is not supported; send token ids"})
                    try:
                        tok = server.tokenizer()
                    except RuntimeError as e:  # the file exists, its load failed
                        return self._json(503, {"error": str(e)})
                    except NotPortedError as e:
                        return self._json(e.http_status, e.payload())
                    if tok is None:
                        return self._json(400, {
                            "error": "model has no tokenizer.json; send token ids"})
                    ids = tok.encode(req["text"])
                    if not ids:
                        raise ValueError("text tokenized to zero tokens")
                    tokens = np.asarray([ids], np.int32)
                else:
                    tokens = np.asarray(req["tokens"], np.int32)
                if tokens.ndim != 2 or tokens.shape[0] < 1 or tokens.shape[1] < 1:
                    raise ValueError(
                        f"tokens must be non-empty 2-D [batch, seq], got shape {tokens.shape}"
                    )
            except (ValueError, KeyError, TypeError, OverflowError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            if not server.ready:
                e = ModelLoadingError(server.name)
                return self._json(e.http_status, {"error": str(e)}, headers=e.headers())
            vocab = getattr(server.cfg, "vocab_size", 0) or 0
            if vocab and (int(tokens.min()) < 0 or int(tokens.max()) >= vocab):
                # the embedding gather would raise on the card (JAX's clamps)
                return self._json(400, {"error": f"token ids must be in [0, {vocab})"})
            n_pos = getattr(server.cfg, "n_positions", 0) or 0
            if not n_pos and verb == "forward":
                # bert's learned positions: the JAX sidecar answers 200 with
                # NaN features past its table (a known gap of the reference);
                # on the card that gather is a device-side assert, which ends
                # the CUDA context, so the port refuses it with gpt2's 400
                n_pos = getattr(server.cfg, "max_position_embeddings", 0) or 0
            if n_pos and tokens.shape[1] > n_pos:
                # absolute-position families (gpt2): no wpe row past n_positions
                return self._json(400, {"error": f"prompt length {tokens.shape[1]} exceeds "
                                                 f"the model's {n_pos}-position context"})
            server.stats["requests"] += 1
            try:
                # in flight until the last byte is written: an unload drains
                # this request before it frees the model; a drain that began
                # since the admission check refuses here (409)
                sset.pool.enter(server.name)
            except ServingError as e:
                return self._json(e.http_status, {"error": str(e)}, headers=e.headers())
            try:
                if verb == "forward":
                    out = (sset.batcher_for(server) or server).forward_argmax(tokens)
                    return self._json(200, {"logits_argmax": out.tolist()})
                checked, err = _check_generate(req, self.headers, tokens, vocab, server,
                                               sset.max_new_tokens_limit)
                if err is not None:
                    return self._json(*err)
                n, samp, stop_ids, resume = checked
                resume_step = 0
                if resume is not None:
                    # re-prefill prompt + emitted and continue the ORIGINAL
                    # (seed, step) stream at step k; resume.seed pins the seed
                    emitted, rseed = resume
                    samp["seed"] = int(rseed)
                    resume_step = len(emitted)
                    tokens = np.concatenate([tokens, np.asarray([emitted], np.int32)], axis=1)
                    n -= resume_step
                if bool(req.get("stream", False)):
                    if stop_ids and tokens.shape[0] > 1:
                        # per-row early stop breaks the [B, k]-aligned stream
                        return self._json(400, {
                            "error": "stop_token_ids with stream is single-row only"})
                    return self._stream_generate(
                        server, tokens, n, samp, stop_ids, timeout_s=timeout_s,
                        priority=priority, resume_step=resume_step,
                        include_timing=bool(req.get("include_timing", False)))
                engine = sset.engine_for(server, tokens.shape[0], samp["temperature"])
                if engine is sset.continuous_for(server):
                    # the engine frees each row's slot at its stop token,
                    # honors the propagated deadline remainder and fills the
                    # phase breakdown the timing headers carry
                    rows = engine.generate(tokens, max_new_tokens=n, stop_token_ids=stop_ids,
                                           timeout_s=timeout_s, priority=priority,
                                           timing=self._timing, **samp).tolist()
                else:
                    rows = engine.generate(tokens, max_new_tokens=n, **samp).tolist()
                if stop_ids:
                    # trim each row's GENERATED part at its first stop (inclusive)
                    stops, plen = set(stop_ids), tokens.shape[1]
                    trimmed = []
                    for row in rows:
                        gen_part = row[plen:]
                        cut = stop_cut(gen_part, stops)
                        trimmed.append(row[:plen] + (gen_part if cut is None else gen_part[:cut]))
                    rows = trimmed
                resp = {"tokens": rows}
                if tok is not None:  # a text request: decode the new tokens
                    resp["text"] = tok.decode(rows[0][tokens.shape[1]:])
                self._json(200, resp)
            except ServingError as e:
                # typed serving failures carry their status: 429 (queue
                # full, + Retry-After), 504 (deadline), 503 (engine broken
                # or restarting), 400 (quarantined, malformed resume), 422
                self._json(e.http_status, {"error": str(e)}, headers=e.headers())
            except NotPortedError as e:
                self._json(e.http_status, e.payload())
            except ValueError as e:  # e.g. generate on a non-generative family
                self._json(400, {"error": str(e)})
            except Exception as e:  # surface inference errors as 500 JSON
                logger.exception("inference error")
                self._json(500, {"error": str(e)})
            finally:
                sset.pool.exit(server.name)

    host, _, port = listen.rpartition(":")
    httpd = _HTTPServer((host or "0.0.0.0", int(port)), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 resets connections
    # when more clients than that connect at once, the traffic the window
    # batcher exists for
    request_queue_size = 128
