"""`modelx-serve-torch` console entrypoint (counterpart of
``modelx_tpu/dl/serve_main.py``).

    modelx-serve-torch --model m=/mnt/model
    modelx-serve-torch --model-dir /mnt/models   # served as "default"
    modelx-serve-torch --model a=/mnt/a --model b=/mnt/b --listen :8000
    modelx-serve-torch --model m=/mnt/m --dynamic-batch --quantize int8
    modelx-serve-torch --model m=/mnt/m --speculative-k 8 --lora m=/mnt/adapter
    modelx-serve-torch --model m=/mnt/m --continuous-batch --max-slots 32 \
        --kv-page-size 16 --kv-live-tokens 32768 --prefill-chunk 256
    modelx-serve-torch --model m=/mnt/m --allow-admin-load \
        --hbm-budget-bytes 40000000000 --evict-idle \
        --host-state-budget-bytes 20000000000 --drain-grace 30
    modelx-serve-torch --model m=/mnt/m --allow-admin-load --continuous-batch \
        --prefix-cache 4 --publish-programs --publish-kv --kv-fetch-through \
        --publish-outbox-dir /var/modelx/outbox
    modelx-serve-torch --model m=/mnt/m --trace-dir /var/modelx/trace \
        --access-log /var/modelx/access.jsonl --access-log-max-bytes 100000000
    modelx-serve-torch --model m=/mnt/m --mesh tp=4     # one process per card
    torchrun --nproc-per-node 4 -m modelx_tpu_torch.dl.serve_main \
        --model m=/mnt/m --mesh dp=2,tp=2

The HTTP front answers 503 on /healthz while the checkpoints load, then
serves them on the card (``--device cpu`` serves on the host instead).
With ``--allow-admin-load`` models load and unload at runtime through
``/admin/models`` (``dl/lifecycle.py``), under ``--hbm-budget-bytes`` with
LRU eviction (``--evict-idle``) into the host and disk state tiers. With
``--continuous-batch`` every generate and single-row stream goes through
the model's continuous engine (``dl/continuous.py``) and its knobs below.
Runtime loads can publish their kernel library and hot prefix KV to the
model version and install what other pods published (``--publish-*``,
``--kv-fetch-through``; ``dl/program_store.py``, ``dl/kv_store.py``),
through a durable outbox (``--publish-outbox-dir``). ``/metrics``,
``/v1/trace`` and the profiler captures (``--trace-dir``) read the pod;
``--access-log`` writes one JSON line per request.

``--mesh`` serves across a mesh of processes, one per card. Without it the
pod serves on one device with no group, also on a host with more cards:
the reference's default (dp over every local card) waits until the
continuous engine, the serving options and the other families serve
under a mesh. Started alone, this process is rank 0: it starts the other
ranks itself (one per local card, ``cuda:r``) and binds HTTP;
under torchrun's environment (or the ``MODELX_*`` variables of
``parallel/distributed.py``) each process joins the group instead, and
ranks other than 0 follow rank 0's device calls (``dl/mesh_serve.py``). A
mesh that needs more cards than the host has exits non-zero naming both
counts, and a ``--device`` that names one card (``cuda:N``) is refused on a
mesh of more than one rank, whose rank r takes ``cuda:r``. A rank that dies
or stalls past ``--mesh-timeout-s`` fails rank 0's requests with 503, and
rank 0 exits non-zero; a request that fails the same way on every rank
(out of memory, a bad argument) answers its error and the mesh serves on.

On SIGTERM the pod drains: ``/healthz`` answers 503 "draining", then it
waits for its in-flight requests (up to ``--drain-grace`` seconds) or
sleeps ``--drain-seconds``, closes the batchers and engines and exits 0
(on a mesh, after telling the other ranks to exit). SIGINT cuts the wait
short.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import signal
import subprocess
import sys
import threading
import time

from modelx_tpu_torch.client import remote
from modelx_tpu_torch.dl import blob_cache, manifest_cache
from modelx_tpu_torch.dl.serve import ModelServer, ServerSet, serve


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="modelx-serve-torch",
        description="Serve safetensors checkpoints with the PyTorch/CUDA port.",
    )
    ap.add_argument("--model-dir", default="",
                    help="volume with *.safetensors (from modelxdl-torch), served as the "
                         "model named 'default'")
    ap.add_argument("--model", dest="models", action="append", default=[],
                    metavar="NAME=DIR",
                    help="model name and a directory of *.safetensors; repeatable "
                         "(the first is the default model)")
    ap.add_argument("--listen", default=":8000", help="host:port to serve on")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="dtype the floating weights are served in")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); cuda raises when absent")
    ap.add_argument("--mesh", default="",
                    help='mesh spec, e.g. "dp=1,tp=8": one process per card (default: '
                         "one device, no mesh)")
    ap.add_argument("--sp-attention", default="auto", choices=["auto", "ring", "ulysses"],
                    help="sequence-parallel attention on a mesh's sp axis (auto: ring when "
                         "sp > 1)")
    ap.add_argument("--mesh-timeout-s", type=float, default=300.0,
                    help="how long a mesh collective waits on a rank before the request "
                         "fails (503) and the pod exits")
    ap.add_argument("--max-seq-len", type=int, default=2048,
                    help="sequence length the continuous engine plans for; the plain "
                         "path serves longer requests, as the JAX sidecar's does")
    ap.add_argument("--blob-cache-dir", default="",
                    help="content-addressed local blob cache for registry-backed "
                         "loads (dl/blob_cache.py): warm restarts of an "
                         "already-served checkpoint skip the network")
    ap.add_argument("--blob-cache-max-bytes", type=int, default=0,
                    help="blob cache size cap; LRU eviction (0 = unbounded)")
    ap.add_argument("--registry-mirror", dest="registry_mirrors", action="append",
                    default=[], metavar="URL",
                    help="read mirror(s) of the registry (comma list; repeatable): "
                         "manifest/blob GETs fail over to them and ranged blob reads "
                         "hedge across them")
    ap.add_argument("--manifest-cache-dir", default="",
                    help="pin every fetched manifest to this dir: when the registry "
                         "AND all mirrors are down, digest-pinned cached manifests + "
                         "the blob cache serve pulls offline (control_plane: offline "
                         "on /healthz; readiness is never gated on it)")
    ap.add_argument("--publish-programs", action="store_true",
                    help="after a runtime (registry-ref) load reaches READY, attach the "
                         "pod's kernel library to the model version as a program bundle "
                         "(application/vnd.modelx.program.v1) so the next puller binds "
                         "it without running nvcc")
    ap.add_argument("--publish-kv", action="store_true",
                    help="sweep the prefix caches of runtime (registry-ref) loaded models "
                         "for entries hit at least --kv-publish-threshold times and attach "
                         "them to the model version as kv bundles "
                         "(application/vnd.modelx.kvcache.v1) so replicas skip "
                         "re-prefilling shared prompt prefixes")
    ap.add_argument("--kv-publish-threshold", type=int, default=2,
                    help="prefix-cache hit count at which an entry becomes hot enough to "
                         "publish (with --publish-kv)")
    ap.add_argument("--kv-fetch-through", action="store_true",
                    help="on a prefix-cache miss, consult the model version's published kv "
                         "bundles and install a matching prefix (bounded by "
                         "--prefix-cache-max-bytes; runtime loads only)")
    ap.add_argument("--publish-outbox-dir", default="",
                    help="durable publish outbox: --publish-programs and --publish-kv "
                         "bundles spool here and a background drainer pushes them with "
                         "backoff, so a registry outage never blocks or fails a load "
                         "(pending entries survive pod restarts)")
    ap.add_argument("--outbox-max-entries", type=int, default=0,
                    help="outbox spool bound; a full spool drops new publishes with a "
                         "counted warning (0 = default 64)")
    ap.add_argument("--stream-chunk-size", type=int, default=8,
                    help="tokens decoded per flush on streaming responses")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="keep the prefill KV of the last N single-row stream prompts "
                         "on the device: multi-turn chats that re-send their history "
                         "prefill only the new suffix (0 = off)")
    ap.add_argument("--prefix-cache-max-bytes", type=int, default=0,
                    help="additional byte cap on the prefix cache's stored KV "
                         "(0 = entry cap only)")
    ap.add_argument("--dynamic-batch", action="store_true",
                    help="coalesce concurrent forward requests into one device call")
    ap.add_argument("--continuous-batch", action="store_true",
                    help="iteration-level (in-flight) batching: generate/stream requests "
                         "join a running decode at chunk boundaries (supersedes "
                         "--dynamic-batch for generate traffic; composes with "
                         "--speculative-k: a lone greedy row speculates inside the engine)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="continuous batching: concurrent decode slots (KV cache rows "
                         "held on the device)")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="continuous batching: paged KV: the engine state becomes a pool "
                         "of PAGE_SIZE-token pages + a block table, so device memory "
                         "scales with live tokens instead of max_slots x max_seq_len (use "
                         "with --max-slots 16+; 0 = dense)")
    ap.add_argument("--kv-live-tokens", type=int, default=0,
                    help="paged KV: pool capacity in tokens (default max_slots x "
                         "max_seq_len / 4)")
    ap.add_argument("--kv-attention", default="gather", choices=["gather", "in-place"],
                    help="paged KV chunk attention: 'gather' (default) builds each "
                         "layer's dense view of the pages, the same logits as every other "
                         "decode path; 'in-place' reads the page pools directly (blockwise "
                         "softmax, per-step transient = one page block; sampled rows may "
                         "flip at bf16 near-ties)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="continuous batching: decode chunks kept in flight before "
                         "syncing the oldest, hiding the dispatch/fetch round-trip behind "
                         "device work (stop and disconnect exits lag by up to DEPTH "
                         "chunks of wasted compute; 1 = lockstep)")
    ap.add_argument("--dispatch-depth", type=int, default=0,
                    help="continuous batching: decode chunks per dispatch in steady "
                         "decode (no admission, prefill piece or first token due); any "
                         "pending boundary event snaps back to one. EOS/cancel/deadline "
                         "detection lags by up to the dispatch's span (wasted compute, "
                         "never wrong tokens). 0 = auto (4 in steady decode); 1 = one "
                         "chunk per dispatch")
    ap.add_argument("--burst-window-ms", type=float, default=1.0,
                    help="continuous batching: when a request hits an IDLE engine, wait "
                         "this long for co-arrivals so the burst admits as one prefill "
                         "and decodes in step (0 = off)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous batching: chunked prefill: prompts longer than this "
                         "many tokens (16-bucketed) land piece by piece between decode "
                         "chunks instead of as one monolithic admission prefill, bounding "
                         "the stall a long admission inflicts on the running batch "
                         "(0 = off)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="chunked prefill: per-boundary token budget: decode rows spend "
                         "chunk_size each first, prefill pieces pack into the remainder "
                         "(the head piece always lands; 0 = one piece per filling row per "
                         "boundary)")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="continuous batching: bound the admission backlog: a submit past "
                         "this many not-yet-admitted rows is shed with 429 + Retry-After "
                         "instead of queueing into unbounded latency (0 = unbounded)")
    ap.add_argument("--request-timeout", type=float, default=0.0,
                    help="continuous batching: per-request deadline in seconds: a request "
                         "older than this expires with 504 at the next chunk boundary, "
                         "queued, prefilling or decoding (0 = no deadline)")
    ap.add_argument("--boundary-watchdog-s", type=float, default=0.0,
                    help="continuous batching: treat a dispatch that makes no "
                         "chunk-boundary progress for this many seconds as a crash: the "
                         "engine's restart/breaker machinery applies and waiters get a "
                         "typed 503 instead of hanging (0 = off)")
    ap.add_argument("--flight-dump-dir", default="",
                    help="continuous batching: on an engine crash, watchdog fire or "
                         "circuit-break, write the flight recorder's last events + "
                         "per-slot state as a JSON-lines black-box file here (the live "
                         "ring is GET /debug/flightrec; empty = no dump files)")
    ap.add_argument("--flightrec-capacity", type=int, default=0,
                    help="flight recorder ring size in events (0 = default 512)")
    ap.add_argument("--flight-recorder", action=argparse.BooleanOptionalAction, default=True,
                    help="record structured engine events (admission, dispatch, "
                         "readback, preemption, EOS, deadline, crash) into a bounded "
                         "in-memory ring")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="dynamic batching: max requests coalesced per device call")
    ap.add_argument("--batch-window-ms", type=float, default=3.0,
                    help="dynamic batching: how long a request waits for companions "
                         "(latency/throughput dial)")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="weight-only int8: half the device memory for the big matmuls")
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="prompt-lookup speculative decoding for single-row greedy "
                         "requests: verify up to K proposed tokens per device step "
                         "(token-exact; 0 = off)")
    ap.add_argument("--lora", dest="loras", action="append", default=[],
                    metavar="NAME=ADAPTER_DIR",
                    help="merge a PEFT-style LoRA adapter into model NAME at load; "
                         "repeatable")
    ap.add_argument("--concurrent-load", action="store_true",
                    help="overlap multi-model loads")
    # the numbers below parse in start(), so a bad value is the usage error
    # the JAX sidecar's click gives
    ap.add_argument("--hbm-budget-bytes", default="0",
                    help="model lifecycle pool: PER-DEVICE memory budget — a runtime "
                         "load whose estimated footprint (safetensors sizes) does not "
                         "fit is refused with 507, or makes room by LRU-evicting idle "
                         "models under --evict-idle (0 = unbudgeted)")
    ap.add_argument("--evict-idle", action="store_true",
                    help="with --hbm-budget-bytes: LRU-evict READY models that have no "
                         "in-flight requests to make room for a new load instead of "
                         "refusing it")
    ap.add_argument("--host-state-budget-bytes", default="0",
                    help="tiered live state (dl/tiers.py): bound for the host-RAM tier "
                         "that evicted/unloaded models' params demote into instead of "
                         "being discarded — a later load of the same content is a tier "
                         "promotion (no pull/parse). LRU within the tier; overflow "
                         "spills to the disk tier (0 = host tier off)")
    ap.add_argument("--disk-state-budget-bytes", default="0",
                    help="bound for the local-disk tier (raw-tensor spool under "
                         "--state-spool-dir) that host-tier overflow spills into; disk "
                         "overflow drops oldest (0 = disk tier off; both 0 = tiering "
                         "off, eviction discards)")
    ap.add_argument("--state-spool-dir", default="",
                    help="where the disk tier spools tensors — put it next to "
                         "--blob-cache-dir (default: $TMPDIR/modelx-state-spool)")
    ap.add_argument("--allow-admin-load", action="store_true",
                    help="enable the runtime lifecycle surface: POST /admin/models "
                         "pulls+loads a registry ref (or a local dir) while traffic is "
                         "live, DELETE /admin/models/{name} drains and frees one (GET "
                         "/admin/models always reports states)")
    ap.add_argument("--admin-token", dest="admin_tokens", action="append", default=[],
                    help="bearer token accepted on the /admin surface (repeatable; "
                         "none = anonymous admin — dev pods only)")
    ap.add_argument("--staging-dir", default="",
                    help="where runtime-pulled model blobs land before loading "
                         "(default: $TMPDIR/modelx-pool-staging)")
    ap.add_argument("--drain-seconds", default="5.0",
                    help="on SIGTERM, serve 503 on /healthz for this long (so load "
                         "balancers drain) before stopping")
    ap.add_argument("--trace-dir", default="",
                    help="torch.profiler output dir (/v1/profile; /admin/profile captures "
                         "under its captures/; default ./torch-trace)")
    ap.add_argument("--access-log", default="",
                    help="append one JSON line per request (request id, hashed client "
                         "identity, model, status, per-phase timing) to this path; "
                         "empty = off")
    ap.add_argument("--access-log-max-bytes", type=int, default=0,
                    help="rotate the access log once it exceeds this many bytes "
                         "(renamed to <path>.1, one generation kept; 0 = never)")
    ap.add_argument("--device-telemetry", action=argparse.BooleanOptionalAction, default=True,
                    help="sample measured device memory (torch.cuda.mem_get_info and the "
                         "caching allocator) into /metrics and the engine snapshots")
    ap.add_argument("--drain-grace", default="0.0",
                    help="coordinated drain: on SIGTERM, stop admission and wait for "
                         "in-flight requests (streams included, to their last byte) to "
                         "reach zero, up to this many seconds, instead of the fixed "
                         "--drain-seconds sleep (0 = fixed-sleep drain)")
    return ap


_INT_FLAGS = ("hbm_budget_bytes", "host_state_budget_bytes", "disk_state_budget_bytes")
_FLOAT_FLAGS = ("drain_seconds", "drain_grace")


def _parse_numbers(ap: argparse.ArgumentParser, args) -> None:
    """The pool and drain numbers, with click's usage error for a bad one."""
    for dest, kind, word in ([(d, int, "integer") for d in _INT_FLAGS]
                             + [(d, float, "float") for d in _FLOAT_FLAGS]):
        raw = getattr(args, dest)
        if isinstance(raw, str):
            try:
                setattr(args, dest, kind(raw))
            except ValueError:
                flag = "--" + dest.replace("_", "-")
                ap.error(f"Invalid value for '{flag}': {raw!r} is not a valid {word}.")


def _parse_models(specs: list[str]) -> dict[str, str]:
    models: dict[str, str] = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--model wants NAME=DIR, got {spec!r}")
        if name in models:
            raise SystemExit(f"--model {name} given twice")
        models[name] = path
    return models


def _parse_loras(ap: argparse.ArgumentParser, specs: list[str], models: dict,
                 quantize: str | None) -> dict[str, str]:
    """``--lora NAME=ADAPTER_DIR`` specs; usage errors as the JAX sidecar's."""
    lora_dirs: dict[str, str] = {}
    for spec in specs:
        name, _, path = spec.partition("=")
        if not path:
            ap.error(f"--lora wants NAME=ADAPTER_DIR, got {spec!r}")
        if name not in models:
            ap.error(f"--lora {name!r}: no such --model")
        lora_dirs[name] = path
    if lora_dirs and quantize:
        # int8 quantizes exactly the 2-D proj weights LoRA targets; fail
        # before the base streams to the device, not after
        ap.error("--lora cannot combine with --quantize "
                 "(adapters merge into full-precision weights)")
    return lora_dirs


def configure_registry(args) -> None:
    """The process-wide registry defaults the flags set, as the JAX
    sidecar's: the blob cache, the read mirrors (comma lists and repeats
    both accepted) and the pinned-manifest cache."""
    if args.blob_cache_dir:
        blob_cache.configure_default(args.blob_cache_dir, max_bytes=args.blob_cache_max_bytes)
    if args.registry_mirrors:
        flat = [p.strip() for m in args.registry_mirrors for p in m.split(",")]
        remote.set_mirrors([m for m in flat if m])
    if args.manifest_cache_dir:
        manifest_cache.configure_default(args.manifest_cache_dir)


def configure_publishes(sset: ServerSet, args) -> None:
    """The derived-artifact flags on the pool, with the JAX sidecar's
    warnings for the combinations that do nothing."""
    log = logging.getLogger("modelx.serve")
    pool = sset.pool
    if (args.publish_programs or args.publish_kv) and args.publish_outbox_dir:
        pool.attach_outbox(args.publish_outbox_dir,
                           max_entries=args.outbox_max_entries or None)
    if args.publish_programs:
        pool.publish_programs = True
        if not args.allow_admin_load:
            log.warning("--publish-programs only fires on runtime (registry-ref) loads; "
                        "without --allow-admin-load none happen")
    if args.publish_kv:
        pool.attach_kv_publisher(threshold=args.kv_publish_threshold)
        if not args.prefix_cache:
            log.warning("--publish-kv is inert without --prefix-cache "
                        "(there is no prefix KV to publish)")
    if args.kv_fetch_through:
        pool.kv_fetch_through = True
        if not args.prefix_cache:
            log.warning("--kv-fetch-through is inert without --prefix-cache "
                        "(there is no prefix cache to install into)")
    if args.publish_outbox_dir and not (args.publish_programs or args.publish_kv):
        log.warning("--publish-outbox-dir is inert without --publish-programs or "
                    "--publish-kv (only derived-artifact publishes spool through "
                    "the outbox)")


def start(argv=None):
    """Parse ``argv``, start the HTTP front, load every model, and return
    ``(server_set, httpd)`` with the front serving. ``main`` runs this and
    then waits for SIGTERM/SIGINT."""
    return _start(argv)[:2]


def _parse(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    _parse_numbers(ap, args)
    if not args.model_dir and not args.models:
        ap.error("need --model-dir or at least one --model name=dir")
    if args.mesh:
        from modelx_tpu_torch.parallel.mesh import parse_mesh_spec

        try:
            spec = parse_mesh_spec(args.mesh)
        except ValueError as e:
            ap.error(f"--mesh: {e}")
        index = _device_index(args.device)
        if index is not None and (spec.size != 1):
            ap.error(f"--device {args.device} names one card, but the mesh {args.mesh} "
                     "runs one rank per card (rank r on cuda:r): drop the index")
    return ap, args


def _device_index(device: str) -> int | None:
    import torch

    try:
        return torch.device(device).index
    except RuntimeError:
        return None  # not a device name: ModelServer says so


def _build_servers(ap, args, mesh=None) -> dict[str, ModelServer]:
    models = _parse_models(([f"default={args.model_dir}"] if args.model_dir else [])
                           + args.models)
    lora_dirs = _parse_loras(ap, args.loras, models, args.quantize)
    return {
        name: ModelServer(path, dtype=args.dtype, device=args.device,
                          max_seq_len=args.max_seq_len, name=name,
                          quantize=args.quantize, speculative_k=args.speculative_k,
                          lora_dir=lora_dirs.get(name, ""),
                          prefix_cache_size=args.prefix_cache,
                          prefix_cache_max_bytes=args.prefix_cache_max_bytes,
                          mesh=mesh, attention_impl=args.sp_attention)
        for name, path in models.items()
    }


def _local_cards(device: str) -> int:
    import torch

    if not device.startswith("cuda"):
        return 0
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def join_mesh(args, argv=None):
    """The serving mesh of this process, or None (no ``--mesh``: one device
    and no group): ``(mesh, followers)``, where ``followers`` are the rank
    processes this process started (rank 0 started alone)."""
    from modelx_tpu_torch.parallel import distributed
    from modelx_tpu_torch.parallel.mesh import make_mesh, resolve_axes

    spec = args.mesh
    if not spec:
        return None, []
    cards = _local_cards(args.device)
    env = os.environ
    children = []
    if not (env.get("MODELX_PROCESS_ID") or env.get("RANK") not in (None, "")):
        # started alone: this is rank 0, and it starts the others
        fixed = cards if args.device.startswith("cuda") else None
        try:
            axes = resolve_axes(spec, fixed if fixed is not None else _spec_size(spec))
        except ValueError as e:
            raise SystemExit(f"modelx-serve-torch: {e}") from None
        total = math.prod(axes.values())
        port = _free_port()
        argv = list(sys.argv[1:] if argv is None else argv)
        for rank in range(1, total):
            child_env = dict(env, MODELX_COORDINATOR=f"127.0.0.1:{port}",
                             MODELX_NUM_PROCESSES=str(total), MODELX_PROCESS_ID=str(rank),
                             LOCAL_RANK=str(rank))
            children.append(subprocess.Popen(
                [sys.executable, "-m", "modelx_tpu_torch.dl.serve_main", *argv], env=child_env))
            print(f"modelx-serve-torch: mesh rank {rank} pid {children[-1].pid}", flush=True)
        distributed.initialize(f"127.0.0.1:{port}", total, 0, device=args.device,
                               timeout_s=args.mesh_timeout_s)
    else:
        distributed.initialize(device=args.device, timeout_s=args.mesh_timeout_s)
    return make_mesh(spec), children


def _spec_size(spec: str) -> int:
    """A CPU mesh's size: the product of its sizes (-1 counts one)."""
    from modelx_tpu_torch.parallel.mesh import parse_mesh_spec

    return math.prod(max(v, 1) for v in parse_mesh_spec(spec).axes.values())


def _start(argv=None, mesh=None, followers=()):
    ap, args = _parse(argv)
    configure_registry(args)
    servers = _build_servers(ap, args, mesh)
    if args.stream_chunk_size < 1:
        raise SystemExit("--stream-chunk-size must be >= 1")
    log = logging.getLogger("modelx.serve")
    if args.continuous_batch and args.speculative_k:
        log.info("--continuous-batch + --speculative-k: the engine speculates "
                 "whenever a single greedy row has the device to itself")
    if args.prefill_chunk and not args.continuous_batch:
        log.warning("--prefill-chunk is inert without --continuous-batch "
                    "(chunked prefill is the continuous engine's admission policy)")
    if (args.max_queue_depth or args.request_timeout) and not args.continuous_batch:
        log.warning("--max-queue-depth/--request-timeout are inert without "
                    "--continuous-batch (bounded admission is the continuous "
                    "engine's submit policy)")
    if args.prefix_cache and args.speculative_k and not args.continuous_batch:
        # the speculative decoder owns single-row streams before the
        # ChunkedDecoder (the prefix cache's stream seam) is consulted;
        # under --continuous-batch the engine's admission uses the cache
        log.warning("--prefix-cache is inert under --speculative-k "
                    "(the speculative decoder handles the streams it would accelerate)")
    if args.evict_idle and not args.hbm_budget_bytes:
        log.warning("--evict-idle is inert without --hbm-budget-bytes "
                    "(eviction only runs to fit a load under the budget)")
    if args.state_spool_dir and not args.disk_state_budget_bytes:
        log.warning("--state-spool-dir is inert without --disk-state-budget-bytes "
                    "(nothing spools to a 0-byte disk tier)")
    sset = ServerSet(servers, stream_chunk_size=args.stream_chunk_size,
                     dynamic_batch=args.dynamic_batch, max_batch=args.max_batch,
                     batch_window_ms=args.batch_window_ms,
                     hbm_budget_bytes=args.hbm_budget_bytes, evict_idle=args.evict_idle,
                     allow_admin_load=args.allow_admin_load,
                     admin_tokens=tuple(args.admin_tokens), staging_root=args.staging_dir,
                     host_state_budget_bytes=args.host_state_budget_bytes,
                     disk_state_budget_bytes=args.disk_state_budget_bytes,
                     state_spool_dir=args.state_spool_dir,
                     continuous_batch=args.continuous_batch, max_slots=args.max_slots,
                     kv_page_size=args.kv_page_size, kv_live_tokens=args.kv_live_tokens,
                     kv_attention=args.kv_attention, pipeline_depth=args.pipeline_depth,
                     dispatch_depth=args.dispatch_depth,
                     burst_window_ms=args.burst_window_ms,
                     prefill_chunk=args.prefill_chunk, prefill_budget=args.prefill_budget,
                     max_queue_depth=args.max_queue_depth,
                     request_timeout_s=args.request_timeout,
                     boundary_watchdog_s=args.boundary_watchdog_s,
                     flight_recorder=args.flight_recorder,
                     flightrec_capacity=args.flightrec_capacity,
                     flight_dump_dir=args.flight_dump_dir, trace_dir=args.trace_dir,
                     device_telemetry=args.device_telemetry, mesh=mesh)
    configure_publishes(sset, args)
    if mesh is not None:
        from modelx_tpu_torch.parallel.mesh import mesh_str, weight_shard_factor

        log.info("serving mesh %s (%d device(s), weight shard factor %d)",
                 mesh_str(mesh), mesh.size, weight_shard_factor(mesh))
    httpd = serve(sset, listen=args.listen, access_log=args.access_log,
                  access_log_max_bytes=args.access_log_max_bytes)  # 503 while loading
    try:
        # every rank loads the models in the same order (their warm-up
        # forwards meet in collectives): no concurrent loads on a mesh
        stats = sset.load_all(concurrent=args.concurrent_load and mesh is None)
    except BaseException:
        httpd.shutdown()
        httpd.server_close()
        raise
    log.info("loaded: %s", stats)
    if mesh is not None and mesh.size > 1:
        from modelx_tpu_torch.dl.mesh_serve import OpLog
        from modelx_tpu_torch.parallel import distributed

        sset.oplog = OpLog(distributed.control_store(), followers, world=mesh.size,
                           timeout_s=args.mesh_timeout_s)
        # one device lock for every model: the followers replay one log in
        # order, so rank 0's calls (and their collectives) must be ordered
        # across models too
        lock = threading.Lock()
        for server in servers.values():
            server.oplog = sset.oplog
            server._device_lock = lock
    return sset, httpd, args


def follow(argv, mesh) -> int:
    """A follower rank: load the same models, then replay rank 0's device
    calls until it says ``shutdown`` (or is gone)."""
    from modelx_tpu_torch.dl.mesh_serve import OpLog
    from modelx_tpu_torch.dl.mesh_serve import follow as replay
    from modelx_tpu_torch.parallel import distributed

    ap, args = _parse(argv)
    configure_registry(args)
    servers = _build_servers(ap, args, mesh)
    for server in servers.values():
        server.load()
    return replay(servers, OpLog(distributed.control_store(), rank=mesh.rank,
                                 world=mesh.size, timeout_s=args.mesh_timeout_s))


def drain(sset: ServerSet, drain_seconds: float, drain_grace: float,
          abort: threading.Event) -> None:
    """The SIGTERM drain: /healthz flips to 503 "draining" (``ready`` is
    False), then wait for the pod's in-flight requests to reach zero, up
    to ``drain_grace`` seconds, or (``drain_grace`` 0) sleep
    ``drain_seconds``. ``abort`` (SIGINT) cuts the wait short."""
    log = logging.getLogger("modelx.serve")
    sset.draining = True
    if not abort.is_set() and drain_grace > 0:
        log.info("draining: waiting up to %.0fs for %d in-flight request(s)",
                 drain_grace, sset.inflight)
        deadline = time.monotonic() + drain_grace
        while sset.inflight > 0 and time.monotonic() < deadline:
            if abort.wait(timeout=0.05):
                break  # Ctrl-C mid-drain: exit now
        if sset.inflight > 0:
            log.warning("drain grace expired with %d request(s) still in flight",
                        sset.inflight)
    elif not abort.is_set() and drain_seconds > 0:
        log.info("draining for %.0fs before shutdown", drain_seconds)
        deadline = time.monotonic() + drain_seconds
        while time.monotonic() < deadline and not abort.wait(timeout=0.05):
            pass


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    _, args = _parse(argv)
    mesh, followers = join_mesh(args, argv)
    if mesh is not None and not mesh.is_leader:
        from modelx_tpu_torch.parallel import distributed

        try:
            if mesh.coord is None:  # past the mesh's prefix of the world
                logging.getLogger("modelx.serve").info(
                    "rank %d is outside the mesh %s; exiting", mesh.rank, mesh)
                return 0
            return follow(argv, mesh)
        finally:
            distributed.shutdown()
    try:
        sset, httpd, args = _start(argv, mesh, followers)
    except BaseException:
        _stop_followers(followers)
        raise
    oplog = sset.oplog
    stop = threading.Event()
    abort = threading.Event()  # SIGINT: skip or cut short the drain window

    def _on_signal(num, _frame):
        if num == signal.SIGINT:
            abort.set()
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    host, port = httpd.server_address[:2]
    print(f"modelx-serve-torch: serving {sorted(sset.servers)} on {host}:{port}", flush=True)
    # short timed waits: a signal the kernel hands to another thread runs
    # its handler only when the main thread next executes Python code, and
    # an untimed wait would not return to do so
    failed = False
    while not stop.wait(timeout=0.2):
        if oplog is not None and oplog.failed_event.is_set():
            failed = True  # a rank is gone: the 503s went out, the pod exits
            break
    if failed:
        drain(sset, 0.0, 2.0, abort)
    else:
        drain(sset, args.drain_seconds, args.drain_grace, abort)
    sset.close()
    # pending outbox entries stay on disk; the next generation's drainer
    # publishes them (that persistence is the point)
    sset.pool.stop_kv()
    sset.pool.stop_outbox()
    httpd.shutdown()
    httpd.server_close()
    if mesh is not None:
        if oplog is not None and not failed:
            oplog.post("shutdown")
        _stop_followers(followers, grace_s=0.0 if failed else 30.0)
        from modelx_tpu_torch.parallel import distributed

        if not failed:
            distributed.shutdown()
    if failed:
        logging.getLogger("modelx.serve").error("exiting: %s", oplog.failed)
        logging.shutdown()
        # the group has a dead or stalled member: tearing it down could
        # wait on that member, so the process ends here
        os._exit(1)
    return 0


def _stop_followers(followers, grace_s: float = 30.0) -> None:
    """Wait up to ``grace_s`` for the rank processes this one started to
    exit, then end them."""
    deadline = time.monotonic() + grace_s
    for p in followers:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.terminate()
    for p in followers:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


if __name__ == "__main__":
    raise SystemExit(main())
