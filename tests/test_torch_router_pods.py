"""Where the port's pods meet the fleet router, on the CPU: a JAX pod
(``modelx_tpu`` ``ServerSet``) and a port pod serve the same tiny fp32 model
with the continuous engine and a prefix cache, take the same requests, and
are polled by both packages' ``PodRegistry``. Every field the router reads
comes out of the port's pod as out of the JAX pod: health and status, each
model's lifecycle state, ``serves``, ``queue_depth``, ``prefix_hit_rate``,
``kv_published`` and the rebalancer's ``ref``, ``inflight`` and
``loads_total``. The rebalancer's ``POST`` and ``DELETE /admin/models``
(a spread load from the registry, then an unload) answer the same statuses
and leave both pods in the same states. Tolerance: exact equality.
"""

import time

import pytest

from modelx_tpu.router import rebalance as jreb
from modelx_tpu.router import registry as jreg
from modelx_tpu_torch.router import rebalance as treb
from modelx_tpu_torch.router import registry as treg
from tests.test_torch_lifecycle import (Pair, fresh_trackers, model_dirs,  # noqa: F401  (fixtures)
                                        registry)

# both packages' process-wide control-plane trackers start from zero: a
# registry failure noted by an earlier test in the same process would
# otherwise read as one pod's "degraded" control plane
pytestmark = pytest.mark.usefixtures("fresh_trackers")

BASE = [[5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 9, 5, 1, 7, 3, 8, 2]]


def _reads(state, model: str) -> dict:
    """What the router reads of one pod row for ``model``."""
    snap = state.models.get(model, {})
    return {
        "healthy": state.healthy, "status": state.status, "error": state.error,
        "state": snap.get("state"), "ref": snap.get("ref", ""),
        "inflight": snap.get("inflight"), "loads_total": snap.get("loads_total"),
        "serves": state.serves(model), "queue_depth": state.queue_depth(model),
        "prefix_hit_rate": state.prefix_hit_rate(model),
        "kv_published": state.kv_published(model), "ready": state.ready_models(),
        "control_plane": state.control_plane.get("state", ""),
    }


def _poll(pair, models=("a", "b")):
    """Both packages' registries over the JAX pod and the port pod: for each
    registry, (JAX pod reads, port pod reads)."""
    urls = [f"http://127.0.0.1:{p}" for p in pair.ports]
    out = {}
    for name, reg in (("jax", jreg), ("port", treg)):
        r = reg.PodRegistry(urls, poll_interval_s=60.0)
        r.poll_once()
        out[name] = tuple({m: _reads(r.pod(u), m) for m in models} for u in urls)
    return out


def _agree(pair, models=("a", "b")):
    polled = _poll(pair, models)
    for name, (jpod, tpod) in polled.items():
        assert tpod == jpod, name
    assert polled["port"] == polled["jax"]
    return polled["port"][1]


def test_poll_reads_equal_and_rebalance_acts_the_same(model_dirs, registry, tmp_path):  # noqa: F811
    pair = Pair.build(model_dirs, ("a",), tmp=tmp_path, allow_admin_load=True,
                      continuous_batch=True, max_slots=4)
    try:
        reads = _agree(pair)
        assert reads["a"]["serves"] and reads["a"]["prefix_hit_rate"] == 0.0
        # a base and two branches off it: prefix-cache hits on both pods
        for extra in ([], [4, 1], [6, 3]):
            pair.agree("POST", "/v1/a/generate", {"tokens": [BASE[0] + extra],
                                                  "max_new_tokens": 3})
        reads = _agree(pair)
        assert reads["a"]["prefix_hit_rate"] > 0 and not reads["a"]["kv_published"]

        # the rebalancer spreads b to both pods from the registry, then
        # unloads it again
        urls = [f"http://127.0.0.1:{p}" for p in pair.ports]
        ref = f"{registry}/library/b@v1"
        snaps = {}
        for name, reb, reg in (("jax", jreb, jreg), ("port", treb, treg)):
            registry_ = reg.PodRegistry(urls, poll_interval_s=60.0)
            r = reb.Rebalancer(registry_, allow=True)
            snaps[name] = [r._execute(reb.Action("load", u, f"b-{name}", ref=ref,
                                                 reason="spread")) for u in urls]
            assert r.snapshot()["action_errors_total"] == 0
        assert [s["status"] for s in snaps["port"]] == [s["status"] for s in snaps["jax"]]
        for side in ("jax", "port"):
            _wait_ready(pair, f"b-{side}")
        reads = _agree(pair, ("a", "b-jax", "b-port"))
        assert reads["b-port"]["state"] == "READY" and reads["b-port"]["ref"] == ref
        for name, reb, reg in (("jax", jreb, jreg), ("port", treb, treg)):
            r = reb.Rebalancer(reg.PodRegistry(urls, poll_interval_s=60.0), allow=True)
            snaps[name] = [r._execute(reb.Action("unload", u, f"b-{name}")) for u in urls]
        assert [s["status"] for s in snaps["port"]] == [s["status"] for s in snaps["jax"]]
        for side in ("jax", "port"):
            _wait_gone(pair, f"b-{side}")
        reads = _agree(pair, ("a", "b-jax", "b-port"))
        assert not reads["b-port"]["serves"] and reads["a"]["serves"]
    finally:
        pair.close()


def _entry_states(pair, name):
    return [p.entries.get(name) and p.entries[name].state for p in pair.pools()]


def _wait_ready(pair, name, timeout=120.0):
    deadline = time.monotonic() + timeout
    while _entry_states(pair, name) != ["READY", "READY"]:
        assert time.monotonic() < deadline, _entry_states(pair, name)
        time.sleep(0.02)


def _wait_gone(pair, name, timeout=120.0):
    deadline = time.monotonic() + timeout
    while any(s not in (None, "UNLOADED") for s in _entry_states(pair, name)):
        assert time.monotonic() < deadline, _entry_states(pair, name)
        time.sleep(0.02)


@pytest.mark.parametrize("reg", [jreg, treg], ids=["jax-registry", "port-registry"])
def test_an_unreachable_and_a_draining_pod_read_the_same(model_dirs, tmp_path, reg):  # noqa: F811
    """A pod SIGTERM'd (draining) and a pod gone read the same rows."""
    pair = Pair.build(model_dirs, ("a",), tmp=tmp_path)
    try:
        pair.j.draining = pair.t.draining = True
        assert _agree(pair, ("a",))["a"]["status"] == "draining"
    finally:
        pair.close()
    urls = [f"http://127.0.0.1:{p}" for p in pair.ports]
    r = reg.PodRegistry(urls, poll_interval_s=60.0)
    r.retry.backoff_s = 0.0
    r.poll_once()
    rows = [r.pod(u) for u in urls]
    assert [(s.status, s.healthy, s.consecutive_failures) for s in rows] == \
        [("unreachable", False, 1)] * 2
