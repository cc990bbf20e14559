"""`modelx-serve-torch` console entrypoint (counterpart of
``modelx_tpu/dl/serve_main.py``).

    modelx-serve-torch --model m=/mnt/model
    modelx-serve-torch --model a=/mnt/a --model b=/mnt/b --listen :8000
    modelx-serve-torch --model m=/mnt/m --dynamic-batch --quantize int8
    modelx-serve-torch --model m=/mnt/m --speculative-k 8 --lora m=/mnt/adapter
    modelx-serve-torch --model m=/mnt/m --allow-admin-load \
        --hbm-budget-bytes 40000000000 --evict-idle \
        --host-state-budget-bytes 20000000000 --drain-grace 30

The HTTP front answers 503 on /healthz while the checkpoints load, then
serves them on the card (``--device cpu`` serves on the host instead).
With ``--allow-admin-load`` models load and unload at runtime through
``/admin/models`` (``dl/lifecycle.py``), under ``--hbm-budget-bytes`` with
LRU eviction (``--evict-idle``) into the host and disk state tiers.

On SIGTERM the pod drains: ``/healthz`` answers 503 "draining", then it
waits for its in-flight requests (up to ``--drain-grace`` seconds) or
sleeps ``--drain-seconds``, closes the batchers and exits 0. SIGINT cuts
the wait short.
"""

from __future__ import annotations

import argparse
import logging
import signal
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
    ap.add_argument("--model", dest="models", action="append", required=True,
                    metavar="NAME=DIR",
                    help="model name and a directory of *.safetensors; repeatable "
                         "(the first is the default model)")
    ap.add_argument("--listen", default=":8000", help="host:port to serve on")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="dtype the floating weights are served in")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); cuda raises when absent")
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


def start(argv=None):
    """Parse ``argv``, start the HTTP front, load every model, and return
    ``(server_set, httpd)`` with the front serving. ``main`` runs this and
    then waits for SIGTERM/SIGINT."""
    return _start(argv)[:2]


def _start(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    _parse_numbers(ap, args)
    configure_registry(args)
    models = _parse_models(args.models)
    lora_dirs = _parse_loras(ap, args.loras, models, args.quantize)
    servers = {
        name: ModelServer(path, dtype=args.dtype, device=args.device,
                          max_seq_len=args.max_seq_len, name=name,
                          quantize=args.quantize, speculative_k=args.speculative_k,
                          lora_dir=lora_dirs.get(name, ""),
                          prefix_cache_size=args.prefix_cache,
                          prefix_cache_max_bytes=args.prefix_cache_max_bytes)
        for name, path in models.items()
    }
    if args.stream_chunk_size < 1:
        raise SystemExit("--stream-chunk-size must be >= 1")
    log = logging.getLogger("modelx.serve")
    if args.prefix_cache and args.speculative_k:
        # the speculative decoder owns single-row streams before the
        # ChunkedDecoder (the prefix cache's stream seam) is consulted
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
                     state_spool_dir=args.state_spool_dir)
    httpd = serve(sset, listen=args.listen)  # answers 503 while loading
    try:
        stats = sset.load_all(concurrent=args.concurrent_load)
    except BaseException:
        httpd.shutdown()
        httpd.server_close()
        raise
    log.info("loaded: %s", stats)
    return sset, httpd, args


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
    sset, httpd, args = _start(argv)
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
    while not stop.wait(timeout=0.2):
        pass
    drain(sset, args.drain_seconds, args.drain_grace, abort)
    sset.close()
    httpd.shutdown()
    httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
