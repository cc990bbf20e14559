"""One deploy-latency (TTFT) measurement in a fresh process (counterpart of
``modelx_tpu/dl/ttft.py``).

    python -m modelx_tpu_torch.dl.ttft http://registry:8080 library/llama [--version v1]
        [--blob-cache-dir DIR] [--device cuda]

Prints one JSON line of stage timings for: registry request -> manifest ->
weights on the card (registry -> device load, with the flash-attention
kernel library built, or loaded from its hash-keyed cache, on a thread
beside it) -> first token (the cache-free forward's argmax at the last
position of a 4-token prompt, which runs the flash kernel once per layer).

Clock discipline, as the reference's: the runtime (CUDA context, imports)
is up before the clock starts; the metric is the registry + loader +
kernel path. Each measurement is a fresh process: the kernel library cache
(``kernels/build.py``) and the blob cache (``--blob-cache-dir``) are what
survive a restart.

Fields that keep the reference's meaning keep its names (``ttft_ms``,
``plan_ms``, ``load_ms``, ``first_exec_ms``, ``weights_ready_ms``,
``bytes_to_device``, ``warm_blobs``); the reference's XLA compile fields
become ``kernel_thread_ms`` (the library build or load on its thread, for
``compile_thread_ms``) and ``kernel_join_ms`` (the wait for it after the
load, for ``compile_join_ms``). ``flash_launches`` counts the first
token's kernel launches.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

PROMPT = [[1, 2, 3, 4]]


def measure_once(base: str, repo: str, version: str = "v1", blob_cache_dir: str = "",
                 device: str | None = None) -> dict:
    import torch

    from modelx_tpu_torch.client.client import Client
    from modelx_tpu_torch.device import resolve_device
    from modelx_tpu_torch.dl import blob_cache as bc
    from modelx_tpu_torch.dl import families as fam
    from modelx_tpu_torch.dl.initializer import _blob_source, blob_index, weight_blobs
    from modelx_tpu_torch.dl.loader import fuse_expert_tensors, load_safetensors, read_index
    from modelx_tpu_torch.ops import attention as attn

    # pre-clock: the pod runtime boots before the model request reaches
    # the registry (CUDA context, the serving imports)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    blob_cache = bc.BlobCache(blob_cache_dir) if blob_cache_dir else bc.default_cache()

    t0 = time.monotonic()
    client = Client(base, quiet=True)
    manifest = client.get_manifest(repo, version)
    infos: dict = {}
    blobs = []
    for blob in weight_blobs(manifest):
        parsed, off = blob_index(blob)
        if parsed is None:
            # no tensor-index annotation: two small ranged header reads
            source = _blob_source(client, repo, blob, cache=blob_cache)
            try:
                parsed, off = read_index(source)
            finally:
                source.close()
        infos.update(parsed)
        blobs.append((blob, parsed, off))
    family = fam.detect(list(infos))
    cfg = family.infer_config(fam.abstract_params(fuse_expert_tensors(infos)))
    t_plan = time.monotonic()

    kernel: dict = {}

    def _build():
        tk = time.monotonic()
        try:
            from modelx_tpu_torch.kernels import build

            build.load_library()
        except BaseException as e:
            kernel["error"] = e
        kernel["secs"] = time.monotonic() - tk

    th = None
    if dev.type == "cuda":
        th = threading.Thread(target=_build, daemon=True, name="kernel-build")
        th.start()
    params: dict = {}
    bytes_to_device = 0
    warm_blobs = 0
    transfer_s = 0.0
    for blob, parsed, off in blobs:
        source = _blob_source(client, repo, blob, cache=blob_cache)
        warm_blobs += source.transport == "cache"
        try:
            arrays, stats = load_safetensors(source, dev, tensors=parsed, data_offset=off)
            transfer_s += stats.total_seconds
        finally:
            source.close()
        params.update(arrays)
        bytes_to_device += stats.bytes_to_device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_load = time.monotonic()
    if th is not None:
        th.join()
        if "error" in kernel:
            raise RuntimeError("flash-attention kernel build failed") from kernel["error"]
    t_join = time.monotonic()
    attn.flash_attention.launches = 0
    with torch.inference_mode():
        logits = family.forward(params, torch.tensor(PROMPT, device=dev), cfg)
        first = int(torch.argmax(logits[:, -1], dim=-1)[0])  # waits for the device
    t_token = time.monotonic()
    return {
        "ttft_ms": round((t_token - t0) * 1e3, 1),
        "plan_ms": round((t_plan - t0) * 1e3, 1),
        "load_ms": round((t_load - t_plan) * 1e3, 1),
        "kernel_join_ms": round((t_join - t_load) * 1e3, 1),
        "first_exec_ms": round((t_token - t_join) * 1e3, 1),
        "kernel_thread_ms": round(kernel["secs"] * 1e3, 1) if "secs" in kernel else None,
        "weights_ready_ms": round((t_load - t0) * 1e3, 1),
        "bytes_to_device": bytes_to_device,
        "load_gbps": round(bytes_to_device / max(t_load - t_plan, 1e-9) / 1e9, 3),
        # the loads alone; load_ms - transfer_ms is the blob cache's sha256
        # (a hit's re-verify, a cold admit's verify)
        "transfer_ms": round(transfer_s * 1e3, 1),
        # safetensors blobs the local blob cache served (zero network
        # reads); == the blob count on a fully warm restart
        "warm_blobs": warm_blobs,
        "blobs": len(blobs),
        "first_token": first,
        "flash_launches": attn.flash_attention.launches,
        "num_layers": cfg.num_layers,
        "device": str(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m modelx_tpu_torch.dl.ttft",
                                 description="One deploy TTFT measurement.")
    ap.add_argument("registry")
    ap.add_argument("repo")
    ap.add_argument("--version", default="v1")
    ap.add_argument("--blob-cache-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); cuda raises when absent")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = measure_once(args.registry, args.repo, version=args.version,
                       blob_cache_dir=args.blob_cache_dir, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
