"""`modelxdl-torch`: the deploy-time puller (counterpart of the JAX CLI's
``modelx dl``).

    modelxdl-torch http://registry:8080/library/llama@v1 /mnt/model
    modelxdl-torch REF DEST --device-put --blob-cache-dir /var/cache/modelx

Pulls the model version (the ``modelFiles`` of its modelx.yaml, when it
names them) into DEST. With ``--device-put`` it then streams every
safetensors blob from the registry onto the card (``--device``, ``cuda``
by default, which raises without one) and reports the load's GB/s. Prints
one JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import sys

from modelx_tpu_torch import errors
from modelx_tpu_torch.dl.initializer import run_initializer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="modelxdl-torch",
                                 description="Pull (a subset of) a model into DEST.")
    ap.add_argument("uri")
    ap.add_argument("dest")
    ap.add_argument("--device-put", action="store_true",
                    help="after pulling, load the safetensors blobs onto the device "
                         "and report timings")
    ap.add_argument("--device", default="cuda",
                    help="torch device for --device-put (cuda, cuda:N or cpu); cuda "
                         "raises when absent")
    ap.add_argument("--blob-cache-dir", default="",
                    help="content-addressed local blob cache for the --device-put "
                         "load: cold loads tee to disk, warm re-deploys of an "
                         "already-served checkpoint skip the network")
    ap.add_argument("--blob-cache-max-bytes", type=int, default=0,
                    help="blob cache size cap; LRU eviction (0 = unbounded)")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv`` and deploy; the summary, with the loaded tensors
    under ``summary["load"]["arrays"]``."""
    args = build_parser().parse_args(argv)
    return run_initializer(args.uri, args.dest, device_put=args.device_put,
                           device=args.device, blob_cache_dir=args.blob_cache_dir,
                           blob_cache_max_bytes=args.blob_cache_max_bytes)


def main(argv=None) -> int:
    try:
        summary = run(argv)
    except (errors.ErrorInfo, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if "load" in summary:
        summary["load"] = {k: v for k, v in summary["load"].items() if k != "arrays"}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
