"""`modelxd-torch`: run the port's registry server (counterpart of the JAX
CLI's ``modelx serve``, with its flags, names and defaults).

    modelxd-torch --listen :8123 --data /srv/registry
    modelxd-torch --listen :8123 --s3-url http://minio:9000 --s3-bucket registry \\
        --enable-redirect --auth-token "$TOKEN"

Serves the local FS store under ``--data``, or the S3 (``--s3-url``) or
GCS (``--gcs-url``) store, until SIGTERM or SIGINT. With
``--enable-redirect`` an object store hands out presigned locations, so
blob bytes flow between clients and the bucket, never through the
registry. ``--auth-token`` (repeatable) and ``--oidc-issuer`` guard every
route but ``/healthz``; ``--gc-interval`` runs a GC sweep of every
repository each that many seconds.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from modelx_tpu_torch.registry.server import Options, RegistryServer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="modelxd-torch", description="Run the registry daemon.")
    env = os.environ.get
    ap.add_argument("--listen", default=":8080", help="listen address")
    ap.add_argument("--data", dest="data_dir", default="data/registry",
                    help="local FS store path")
    ap.add_argument("--tls-cert", default="")
    ap.add_argument("--tls-key", default="")
    ap.add_argument("--s3-url", default="", help="S3 endpoint; presence selects the S3 store")
    ap.add_argument("--s3-access-key", default=env("S3_ACCESS_KEY", ""))
    ap.add_argument("--s3-secret-key", default=env("S3_SECRET_KEY", ""))
    ap.add_argument("--s3-bucket", default="registry")
    ap.add_argument("--s3-region", default="us-east-1")
    ap.add_argument("--gcs-url", default="",
                    help="GCS endpoint (e.g. https://storage.googleapis.com); presence "
                         "selects the GCS store (HMAC keys)")
    ap.add_argument("--gcs-access-key", default=env("GCS_ACCESS_KEY", ""))
    ap.add_argument("--gcs-secret-key", default=env("GCS_SECRET_KEY", ""))
    ap.add_argument("--gcs-bucket", default="registry")
    ap.add_argument("--enable-redirect", action="store_true",
                    help="presigned load separation")
    ap.add_argument("--local-redirect", action=argparse.BooleanOptionalAction, default=True,
                    help="FS store: redirect colocated clients to blob paths")
    ap.add_argument("--auth-token", dest="auth_tokens", action="append", default=[],
                    help="accepted bearer token (repeatable)")
    ap.add_argument("--oidc-issuer", default="", help="OIDC issuer URL for JWT bearer auth")
    ap.add_argument("--gc-interval", dest="gc_interval_s", type=float, default=0.0,
                    help="seconds between GC sweeps (0=off)")
    ap.add_argument("--reconcile-on-start", action=argparse.BooleanOptionalAction, default=True,
                    help="rebuild repo + global indexes from storage at boot (crash "
                         "recovery; index-only, deep audits via scrub)")
    return ap


def options(argv=None) -> Options:
    args = vars(build_parser().parse_args(argv))
    args["auth_tokens"] = tuple(args["auth_tokens"])
    return Options(**args)


def main(argv=None) -> int:
    opts = options(argv)
    logging.getLogger("modelx.registry").setLevel(logging.INFO)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    srv = RegistryServer(opts)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    srv.serve_background()
    store = (f"s3 {opts.s3_url}/{opts.s3_bucket}" if opts.s3_url else
             f"gcs {opts.gcs_url}/{opts.gcs_bucket}" if opts.gcs_url else opts.data_dir)
    print(f"modelx registry: serving {store} on {srv.address}", flush=True)
    stop.wait()
    srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
