"""Lifecycle rebalancing: spread hot models, make room on full pods
(counterpart of ``modelx_tpu/router/rebalance.py``).

SLINFER's framing (PAPERS.md): placement should follow OBSERVED traffic,
not static assignment. The router already sees the two signals that
matter — per-model backpressure it had to relay (429/503 failover
exhaustion) and per-model queue depth from the placement table — so when
a model runs hot it POSTs ``/admin/models {"name", "ref"}`` to an
underloaded READY pod that does not serve it yet (the pods' admin
surface does the pull/load; re-swaps are blob-cache-warm). When that load
is refused 507 (HBM budget), the next step DELETEs a READY + idle model
from the refusing pod to make room, then retries the load a step later.

Deliberately conservative:

- everything is gated behind ``--allow-rebalance`` (the mutations need
  the pods started with ``--allow-admin-load`` too);
- only models whose placement row carries a ``ref`` spread — a pod
  serving from a local directory has nothing another pod could pull;
- one load action per step, cooldown per (pod, model), so a pressure
  spike cannot fan out into a load storm;
- planning (:func:`plan_actions`, pure) is split from execution
  (:meth:`Rebalancer.step`, HTTP) so the policy is unit-testable without
  a fleet.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from modelx_tpu_torch.router.http import LazySession, TransportError, bearer_headers

logger = logging.getLogger("modelx.router")

READY = "READY"


class Action:
    """One planned lifecycle mutation."""

    __slots__ = ("kind", "pod", "model", "ref", "reason", "kv_prewarm")

    def __init__(self, kind: str, pod: str, model: str, ref: str = "",
                 reason: str = "", kv_prewarm: bool = False) -> None:
        self.kind = kind      # "load" | "unload"
        self.pod = pod        # target pod base URL
        self.model = model
        self.ref = ref        # registry uri (load only)
        self.reason = reason
        # the model has registry-published prefix KV (dl/kv_store.py):
        # the new replica installs the shared prefix at load instead of
        # serving its first hot prompts cold
        self.kv_prewarm = bool(kv_prewarm)

    def snapshot(self) -> dict:
        out = {"action": self.kind, "pod": self.pod, "model": self.model,
               "reason": self.reason}
        if self.ref:
            out["ref"] = self.ref
        if self.kv_prewarm:
            out["kv_prewarm"] = True
        return out


def model_ref(pods, model: str) -> str:
    """The registry uri some pod pulled ``model`` from ('' when every
    serving pod loaded it from a local dir — nothing to spread)."""
    for p in pods:
        ref = p.models.get(model, {}).get("ref", "")
        if ref:
            return str(ref)
    return ""


def _pod_load(pod) -> int:
    return sum(pod.queue_depth(m) for m in pod.models)


def fleet_kv_signals(pods) -> tuple[dict[str, float], set[str]]:
    """Per-model prefix-cache signals aggregated across the fleet: the
    summed 1m hit rate (how much prefix reuse the model sees RIGHT NOW)
    and the set of models with registry-published KV bundles (a spread
    replica of those pre-installs the shared prefix at load)."""
    rates: dict[str, float] = {}
    published: set[str] = set()
    for pod in pods:
        for model in pod.serving:
            rate = pod.prefix_hit_rate(model)
            if rate:
                rates[model] = rates.get(model, 0.0) + rate
            if pod.kv_published(model):
                published.add(model)
    return rates, published


def plan_actions(pods, pressure: dict[str, int], *, queue_high: int = 4,
                 make_room_on: dict[str, str] | None = None,
                 hit_rates: dict[str, float] | None = None,
                 kv_published: set[str] | None = None) -> list[Action]:
    """Decide at most one load (and the unloads that make room for it).

    ``pods``: PodState list (the placement table). ``pressure``: per-model
    hotness — relayed sheds plus aggregate queue depth since the last
    step. ``make_room_on``: pod URL -> model whose load that pod refused
    with 507 last step; an idle READY model there gets unloaded first.
    ``hit_rates``: per-model fleet prefix-cache hit rate — a
    tiebreak among equally-pressured models: between two models at the
    same backlog, spreading the one whose traffic actually reuses
    prefixes buys more (its replica starts with the shared KV
    installed). ``kv_published``: models whose prefix KV is in the
    registry; their spread actions are marked ``kv_prewarm``.
    """
    actions: list[Action] = []
    # make room where a previous spread attempt was refused for space
    for pod_url, wanted in (make_room_on or {}).items():
        pod = next((p for p in pods if p.url == pod_url and p.healthy), None)
        if pod is None or pod.serves(wanted):
            continue
        donors = [
            m for m, snap in pod.models.items()
            if m != wanted and snap.get("state") == READY
            and int(snap.get("inflight", 0)) == 0 and pod.queue_depth(m) == 0
        ]
        if donors:
            # fewest-loads donor: the model this pod has re-loaded least is
            # the cheapest bet to give up (blob-cache-warm either way)
            donor = min(donors, key=lambda m: (
                int(pod.models[m].get("loads_total", 0)), m))
            actions.append(Action(
                "unload", pod.url, donor,
                reason=f"make room for hot model {wanted!r} (507 last step)",
            ))
    # spread the hottest model that has somewhere to go
    hit_rates = hit_rates or {}
    kv_published = kv_published or set()
    hot = sorted(
        (m for m, n in pressure.items() if n >= queue_high),
        key=lambda m: (-pressure[m], -hit_rates.get(m, 0.0), m),
    )
    for model in hot:
        ref = model_ref(pods, model)
        if not ref:
            continue  # local-dir model: nothing another pod could pull
        targets = [p for p in pods if p.healthy and not p.serves(model)
                   and model not in p.models]
        if not targets:
            continue
        target = min(targets, key=lambda p: (_pod_load(p), p.url))
        reason = f"pressure {pressure[model]} >= {queue_high}"
        prewarm = model in kv_published
        if prewarm:
            reason += "; shared prefix KV published, replica pre-installs it"
        actions.append(Action(
            "load", target.url, model, ref=ref,
            reason=reason, kv_prewarm=prewarm,
        ))
        break  # one spread per step: no load storms
    return actions


class Rebalancer:
    """Executes the plan against the pods' admin API.

    Fed by the front door (``observe_shed``) and driven from the poll
    cadence (``maybe_step``). Disabled (observe-only) unless ``allow`` —
    pressure still accumulates into /metrics so an operator can see what
    WOULD rebalance before turning it on."""

    def __init__(self, registry, allow: bool = False, queue_high: int = 4,
                 interval_s: float = 10.0, cooldown_s: float = 60.0,
                 admin_token: str = "", session=None,
                 history: int = 64) -> None:
        self.registry = registry
        self.allow = bool(allow)
        self.queue_high = max(1, int(queue_high))
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.admin_token = admin_token
        self._session = LazySession(session)
        self._lock = threading.Lock()
        self._sheds: dict[str, int] = {}          # model -> relayed sheds
        self._room: dict[str, str] = {}            # pod -> model refused 507
        self._cooldown: dict[tuple, float] = {}    # (pod, model) -> until
        self._last_step = 0.0
        self.actions_total = 0
        self.action_errors_total = 0
        self.offline_skipped_steps = 0  # steps skipped: registry offline
        self.kv_prewarm_spreads_total = 0  # spreads of KV-published models
        self._history: deque = deque(maxlen=history)

    # -- signals --------------------------------------------------------------

    def observe_shed(self, model: str) -> None:
        """The front door relayed a 429/503 for ``model`` after exhausting
        failover — the fleet-level pressure signal."""
        with self._lock:
            self._sheds[model] = self._sheds.get(model, 0) + 1

    def pressure(self) -> dict[str, int]:
        """Sheds since last step plus the table's aggregate queue depth."""
        with self._lock:
            out = dict(self._sheds)
        for pod in self.registry.pods():
            for model in pod.models:
                depth = pod.queue_depth(model)
                if depth:
                    out[model] = out.get(model, 0) + depth
        return out

    # -- stepping -------------------------------------------------------------

    def maybe_step(self) -> list[dict]:
        """Rate-limited step; returns executed action snapshots."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_step < self.interval_s:
                return []
            self._last_step = now
        return self.step()

    def step(self) -> list[dict]:
        pressure = self.pressure()
        if not self.allow:
            # observe-only: keep the shed counters accumulating so
            # /metrics shows what WOULD rebalance — don't flush them
            return []
        # Fleet control-plane gate: when every healthy pod that
        # reports a registry-health view says "offline", a spread load
        # would point the target at a dead registry — it could only
        # succeed from a cache the target may not have warmed. Go
        # observe-only (sheds keep accumulating, no flush, no error
        # spam) until some pod sees the registry again. Load refs are
        # not the problem — they come from the placement table's
        # last-known rows, which survive dead polls — the PULL is.
        cp_states = {str(p.control_plane.get("state", ""))
                     for p in self.registry.pods()
                     if p.healthy and p.control_plane}
        if cp_states and cp_states <= {"offline"}:
            with self._lock:
                self.offline_skipped_steps += 1
            logger.info("rebalance: fleet reports control plane offline; "
                        "observing only")
            return []
        with self._lock:
            self._sheds.clear()
            room = dict(self._room)
            self._room.clear()
            now = time.monotonic()
            cooled = {k for k, until in self._cooldown.items() if until > now}
        fleet = self.registry.pods()
        hit_rates, kv_published = fleet_kv_signals(fleet)
        plan = [
            a for a in plan_actions(
                fleet, pressure,
                queue_high=self.queue_high, make_room_on=room,
                hit_rates=hit_rates, kv_published=kv_published,
            )
            if (a.pod, a.model) not in cooled
        ]
        done: list[dict] = []
        for action in plan:
            snap = self._execute(action)
            with self._lock:
                if not (action.kind == "load" and snap.get("status") == 507):
                    # a 507-refused load sets NO cooldown: the make-room
                    # flow owns its pacing, and cooling (pod, model) here
                    # would block the very retry the unload enables
                    self._cooldown[(action.pod, action.model)] = (
                        time.monotonic() + self.cooldown_s
                    )
                if (action.kv_prewarm and action.kind == "load"
                        and int(snap.get("status", 599)) < 400):
                    self.kv_prewarm_spreads_total += 1
                self._history.append(snap)
            done.append(snap)
        return done

    def _execute(self, action: Action) -> dict:
        snap = action.snapshot()
        headers = bearer_headers(self.admin_token)
        try:
            if action.kind == "load":
                resp = self._session.get().request(
                    "POST", action.pod + "/admin/models",
                    json={"name": action.model, "ref": action.ref},
                    headers=headers, timeout=10.0,
                )
            else:
                resp = self._session.get().request(
                    "DELETE", f"{action.pod}/admin/models/{action.model}?wait=0",
                    headers=headers, timeout=10.0,
                )
            snap["status"] = resp.status_code
            if action.kind == "load" and resp.status_code == 507:
                # budget refusal: remember to make room next step
                with self._lock:
                    self._room[action.pod] = action.model
            if resp.status_code >= 400:
                self.action_errors_total += 1
            else:
                self.actions_total += 1
            resp.close()
        except TransportError as e:
            snap["error"] = str(e)[:200]
            self.action_errors_total += 1
            self.registry.quarantine(action.pod, f"rebalance {action.kind}: {e}")
        logger.info("rebalance: %s", snap)
        return snap

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.allow,
                "actions_total": self.actions_total,
                "action_errors_total": self.action_errors_total,
                "offline_skipped_steps": self.offline_skipped_steps,
                "kv_prewarm_spreads_total": self.kv_prewarm_spreads_total,
                "pending_pressure": dict(self._sheds),
                "recent_actions": list(self._history),
            }
