"""Run the port's registry server (counterpart of the JAX CLI's ``serve``).

    python -m modelx_tpu_torch.registry.server_main --listen :8123 --data /srv/registry

Serves the local FS store under ``--data`` until SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from modelx_tpu_torch.registry.server import Options, RegistryServer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m modelx_tpu_torch.registry.server_main",
                                 description="Run the registry over a local FS store.")
    ap.add_argument("--listen", default=":8080", help="listen address")
    ap.add_argument("--data", dest="data_dir", default="data/registry",
                    help="local FS store path")
    ap.add_argument("--tls-cert", default="")
    ap.add_argument("--tls-key", default="")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    srv = RegistryServer(Options(**vars(args)))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    srv.serve_background()
    print(f"modelx registry: serving {args.data_dir} on {srv.address}", flush=True)
    stop.wait()
    srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
