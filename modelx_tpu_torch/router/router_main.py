"""``modelx-route-torch``: the fleet front door's command (counterpart of
``modelx_tpu/router/router_main.py``, with its flags, names and defaults,
on argparse where the reference uses click).

    modelx-route-torch --pod http://pod-a:8000 --pod http://pod-b:8000 \\
        --pod http://pod-c:8000 --listen :8100

No torch anywhere on this path: the router runs on boxes with no
accelerator and starts in milliseconds. It is a proxy and a placement
table, not a compute node. ``modelx-torch route`` hands its arguments
over to ``main``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from modelx_tpu_torch.router.admission import (
    AdmissionController,
    BreakerBoard,
    RetryBudget,
)
from modelx_tpu_torch.router.policy import DEFAULT_WINDOW_TOKENS, StickyTable
from modelx_tpu_torch.router.rebalance import Rebalancer
from modelx_tpu_torch.router.registry import PodRegistry
from modelx_tpu_torch.router.server import FleetRouter, route_serve

PROG = "modelx-route-torch"


def build_parser(prog: str = PROG) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=prog, description="Run the fleet router: a prefix-sticky, lifecycle-aware "
                               "HTTP front door over many serving pods.")
    ap.add_argument("--pod", dest="pods", action="append", required=True,
                    help="backend pod base URL (repeatable): a modelx-serve-torch instance "
                         "whose /healthz + /admin/models this router polls and whose /v1 "
                         "surface it proxies")
    ap.add_argument("--listen", default=":8100", help="listen address")
    ap.add_argument("--default-model", default="default",
                    help="model served for /v1/generate|forward and OpenAI requests that "
                         "omit 'model'")
    ap.add_argument("--poll-interval", default=2.0, type=float,
                    help="seconds between placement-table polls; data-path connection "
                         "failures quarantine a pod immediately, this is only how fast it "
                         "comes BACK")
    ap.add_argument("--poll-timeout", default=5.0, type=float,
                    help="per-poll HTTP timeout against one pod")
    ap.add_argument("--request-timeout", default=60.0, type=float,
                    help="end-to-end deadline for one proxied request, failover attempts "
                         "included; exceeding it answers 504")
    ap.add_argument("--connect-timeout", default=5.0, type=float,
                    help="per-attempt TCP connect timeout to a pod")
    ap.add_argument("--sticky-entries", default=4096, type=int,
                    help="conversations remembered for prefix-sticky routing (LRU; eviction "
                         "costs one suffix re-prefill, never correctness)")
    ap.add_argument("--sticky-window", default=DEFAULT_WINDOW_TOKENS, type=int,
                    help="tokens of prompt head hashed into the sticky key (chars are "
                         "windowed at 4x this)")
    ap.add_argument("--pod-admin-token", default="",
                    help="bearer token for the pods' /admin surface (polling reads it; "
                         "rebalancing writes it)")
    ap.add_argument("--allow-rebalance", action="store_true",
                    help="let the router drive the pods' lifecycle API: spread a hot model "
                         "to an underloaded pod, unload an idle model to make room after a "
                         "507. Off = observe-only. The pods must run --allow-admin-load")
    ap.add_argument("--rebalance-queue-high", default=4, type=int,
                    help="pressure (relayed sheds + aggregate queue depth per model between "
                         "steps) at which a model counts as hot")
    ap.add_argument("--rebalance-interval", default=10.0, type=float,
                    help="minimum seconds between rebalance steps")
    ap.add_argument("--rebalance-cooldown", default=60.0, type=float,
                    help="per (pod, model) cooldown after an action")
    ap.add_argument("--fair-share", default=0, type=int,
                    help="concurrent upstream slots granted by the weighted fair scheduler "
                         "(0 = observe-only)")
    ap.add_argument("--client-rate", default=0.0, type=float,
                    help="per-client request ceiling (req/s, burst 2x) keyed by API token / "
                         "X-ModelX-Client / source IP (0 = off)")
    ap.add_argument("--max-router-backlog", default=0, type=int,
                    help="requests the fair scheduler may hold waiting for an upstream "
                         "slot; a full backlog sheds 429, batch class first (0 = unbounded)")
    ap.add_argument("--retry-budget", default=0.0, type=float,
                    help="failover retry budget ratio: first attempts deposit this many "
                         "tokens, each failover attempt withdraws 1 (0 = unlimited retries)")
    ap.add_argument("--breaker-threshold", default=0, type=int,
                    help="consecutive non-connection 5xx answers that OPEN a per-pod "
                         "circuit breaker (0 = observe-only)")
    ap.add_argument("--breaker-cooldown", default=10.0, type=float,
                    help="seconds an OPEN breaker waits before letting one half-open probe "
                         "request through")
    ap.add_argument("--access-log", default="",
                    help="append one JSON line per routed request to this path; empty = off")
    ap.add_argument("--access-log-max-bytes", default=0, type=int,
                    help="rotate the access log once it exceeds this many bytes (renamed to "
                         "<path>.1, one generation kept; 0 = never)")
    return ap


def build_router(args) -> FleetRouter:
    """The FleetRouter the parsed flags describe (not started)."""
    registry = PodRegistry(
        list(args.pods), poll_interval_s=args.poll_interval,
        poll_timeout_s=args.poll_timeout, admin_token=args.pod_admin_token,
    )
    rebalancer = Rebalancer(
        registry, allow=args.allow_rebalance, queue_high=args.rebalance_queue_high,
        interval_s=args.rebalance_interval, cooldown_s=args.rebalance_cooldown,
        admin_token=args.pod_admin_token,
    )
    return FleetRouter(
        registry, sticky=StickyTable(max_entries=args.sticky_entries),
        rebalancer=rebalancer, default_model=args.default_model,
        request_timeout_s=args.request_timeout, connect_timeout_s=args.connect_timeout,
        sticky_window_tokens=args.sticky_window,
        admission=AdmissionController(
            fair_share=args.fair_share, client_rate=args.client_rate,
            max_backlog=args.max_router_backlog,
        ),
        retry_budget=RetryBudget(ratio=args.retry_budget),
        breakers=BreakerBoard(threshold=args.breaker_threshold,
                              cooldown_s=args.breaker_cooldown),
        access_log=args.access_log,
        access_log_max_bytes=args.access_log_max_bytes,
    )


def main(argv=None, prog: str = PROG) -> int:
    args = build_parser(prog).parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    router = build_router(args)
    router.start()
    httpd = route_serve(router, listen=args.listen)
    logging.getLogger("modelx.router").info(
        "routing %d pods on %s (rebalance %s)", len(args.pods), args.listen,
        "enabled" if args.allow_rebalance else "observe-only",
    )
    stop = threading.Event()

    def _on_signal(num, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    # timed waits: a signal runs its handler only between the main
    # thread's bytecodes
    while not stop.wait(timeout=0.2):
        pass
    httpd.shutdown()
    router.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
