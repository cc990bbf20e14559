"""`modelx-serve-torch` console entrypoint (counterpart of
``modelx_tpu/dl/serve_main.py``).

    modelx-serve-torch --model m=/mnt/model
    modelx-serve-torch --model a=/mnt/a --model b=/mnt/b --listen :8000
    modelx-serve-torch --model m=/mnt/m --dynamic-batch --quantize int8
    modelx-serve-torch --model m=/mnt/m --speculative-k 8 --lora m=/mnt/adapter

The HTTP front answers 503 on /healthz while the checkpoints load, then
serves them on the card (``--device cpu`` serves on the host instead).
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

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
    return ap


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
    ap = build_parser()
    args = ap.parse_args(argv)
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
    if args.prefix_cache and args.speculative_k:
        # the speculative decoder owns single-row streams before the
        # ChunkedDecoder (the prefix cache's stream seam) is consulted
        logging.getLogger("modelx.serve").warning(
            "--prefix-cache is inert under --speculative-k "
            "(the speculative decoder handles the streams it would accelerate)")
    sset = ServerSet(servers, stream_chunk_size=args.stream_chunk_size,
                     dynamic_batch=args.dynamic_batch, max_batch=args.max_batch,
                     batch_window_ms=args.batch_window_ms)
    httpd = serve(sset, listen=args.listen)  # answers 503 while loading
    try:
        stats = sset.load_all()
    except BaseException:
        httpd.shutdown()
        httpd.server_close()
        raise
    logging.getLogger("modelx.serve").info("loaded: %s", stats)
    return sset, httpd


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    sset, httpd = start(argv)
    stop = threading.Event()

    def _on_signal(_num, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    host, port = httpd.server_address[:2]
    print(f"modelx-serve-torch: serving {sorted(sset.servers)} on {host}:{port}", flush=True)
    stop.wait()
    httpd.shutdown()
    httpd.server_close()
    sset.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
