"""`modelx-serve-torch` console entrypoint (counterpart of
``modelx_tpu/dl/serve_main.py``).

    modelx-serve-torch --model m=/mnt/model
    modelx-serve-torch --model a=/mnt/a --model b=/mnt/b --listen :8000

The HTTP front answers 503 on /healthz while the checkpoints load, then
serves them on the card (``--device cpu`` serves on the host instead).
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

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
                    help="longest prompt (+ max_new_tokens) a request may ask for")
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


def start(argv=None):
    """Parse ``argv``, start the HTTP front, load every model, and return
    ``(server_set, httpd)`` with the front serving. ``main`` runs this and
    then waits for SIGTERM/SIGINT."""
    args = build_parser().parse_args(argv)
    models = _parse_models(args.models)
    servers = {
        name: ModelServer(path, dtype=args.dtype, device=args.device,
                          max_seq_len=args.max_seq_len, name=name)
        for name, path in models.items()
    }
    sset = ServerSet(servers)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
