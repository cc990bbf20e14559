"""Fleet router: a prefix-sticky, lifecycle-aware front door over many
serving pods (counterpart of ``modelx_tpu/router``).

PRs 3–7 hardened ONE pod — typed backpressure, runtime model lifecycle,
pipelined decode. The millions-of-users story needs the layer above: a
lightweight HTTP router that speaks the same native + OpenAI surfaces,
spreads load across pods, keeps conversations on the pod whose prefix
cache already holds them (ServerlessLLM's locality argument: route to
where live state resides), honors 429/503/Retry-After backpressure with
in-deadline failover, and — behind ``--allow-rebalance`` — drives the
pods' admin lifecycle API to spread hot models.

Layering (no torch anywhere in this package — the front door starts in
milliseconds and runs on boxes with no accelerator; its HTTP is
``http.server`` and ``router/http.py`` on ``client/remote``):

- ``registry``  — PodRegistry: polls each pod's ``/healthz`` +
  ``/admin/models`` into a placement table; demotes on poll failure;
  immediate quarantine when the data path sees a connection die.
- ``policy``    — sticky keys (the PrefixKVCache fingerprint idea lifted
  to the HTTP layer) + the pick order: sticky first, then bounded-load
  rendezvous anchor on a miss (two router replicas agree without shared
  state), then least queue depth among READY pods, never DRAINING/broken.
- ``admission`` — overload protection (observe-only by default):
  per-client weighted fair admission with drain-rate Retry-After,
  Finagle-style retry budgets, per-pod 5xx circuit breakers, and the
  deadline/priority header contract the pods honor.
- ``server``    — the HTTP front door: proxies native + OpenAI bodies,
  streams SSE/NDJSON chunk-for-chunk (byte-identical), fails over within
  the request deadline (stamping the remaining budget upstream per
  attempt), surfaces mid-stream pod death as a typed error.
- ``rebalance`` — queue-pressure driven lifecycle actions (POST/DELETE
  ``/admin/models``), planning split from execution so the policy is
  unit-testable.
- ``router_main`` — the ``modelx-torch route`` / ``modelx-route-torch`` CLI.
"""

from modelx_tpu_torch.router.admission import (
    AdmissionController,
    BreakerBoard,
    RetryBudget,
)
from modelx_tpu_torch.router.policy import StickyTable, sticky_keys
from modelx_tpu_torch.router.registry import PodRegistry, PodState
from modelx_tpu_torch.router.server import FleetRouter, route_serve

__all__ = [
    "AdmissionController",
    "BreakerBoard",
    "FleetRouter",
    "PodRegistry",
    "PodState",
    "RetryBudget",
    "StickyTable",
    "route_serve",
    "sticky_keys",
]
