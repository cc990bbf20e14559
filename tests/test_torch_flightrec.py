"""The port's flight recorder (modelx_tpu_torch.utils.flightrec, a copy)
against the JAX package's, on the CPU: the same records, resets, request-id
slices, summaries and black-box dumps give equal events, with the clock
readings (each event's monotonic ``t``, the dump header's wall-clock
``ts``, the dump file name's pid and milliseconds) masked; and the model
pool's ring as ``GET /debug/flightrec`` serves it (admin-gated,
``?request_id=`` slicing) equals the JAX pod's."""

import json
import os
import threading

import pytest

from modelx_tpu.utils import flightrec as jflightrec
from modelx_tpu_torch.utils import flightrec
from tests.test_torch_lifecycle import (  # noqa: F401 (fresh_trackers is a fixture)
    Pair,
    fresh_trackers,
    write_tiny,
)


def _masked(events):
    return [{k: ("<masked>" if k in ("t", "ts", "ms") else v) for k, v in e.items()}
            for e in events]


def both(capacity=8):
    return jflightrec.FlightRecorder(capacity=capacity), flightrec.FlightRecorder(capacity=capacity)


def drive(fr):
    fr.record("admit", slot=0, request_id="r-1", prompt_len=6)
    fr.record("dispatch", depth=2, n_steps=8)
    fr.record("eos", request_id="r-1", reason="stop")
    fr.record("admit", slot=-1, request_id="r-2")
    for i in range(7):
        fr.record("e", n=i)


@pytest.mark.parametrize("capacity", [1, 4, 8, 64])
def test_records_summaries_and_slices_equal_jax(capacity):
    recorders = both(capacity)
    for fr in recorders:
        drive(fr)
    j, t = recorders
    assert _masked(t.events()) == _masked(j.events())
    for rid in (None, "r-1", "r-2", "nope"):
        js, ts = j.summary(rid), t.summary(rid)
        js["events"], ts["events"] = _masked(js["events"]), _masked(ts["events"])
        assert ts == js
    assert t.total == j.total == 11
    assert t.events()[0]["t"] <= t.events()[-1]["t"]


def test_reset_copies_and_capacity_as_jax():
    for fr in both(4):
        fr.record("crash")
        fr.reset()
        assert fr.events() == [] and fr.total == 0
        fr.record("rebuild", request_id="a")
        assert fr.events()[0]["seq"] == 0
        fr.events()[0]["event"] = "tampered"
        assert fr.events()[0]["event"] == "rebuild"
    for cls in (jflightrec.FlightRecorder, flightrec.FlightRecorder):
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            cls(capacity=0)
    assert flightrec.DEFAULT_CAPACITY == jflightrec.DEFAULT_CAPACITY


def test_concurrent_appends_never_tear():
    fr = flightrec.FlightRecorder(capacity=64)

    def spin(tag):
        for i in range(200):
            fr.record("e", tag=tag, i=i)

    threads = [threading.Thread(target=spin, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fr.total == 800
    assert [e["seq"] for e in fr.events()] == list(range(736, 800))


@pytest.mark.parametrize("reason", ["crash", "circuit break"])
def test_dump_format_equals_jax(tmp_path, reason):
    lines = []
    for side, fr in zip(("jax", "port"), both(8)):
        fr.record("admit", slot=0, request_id="r-1")
        fr.record("crash", request_id="r-1", error="RuntimeError('x')")
        path = fr.dump(str(tmp_path / side / "deep"), reason,
                       meta={"model": "default", "restarts": 1},
                       slots=[{"slot": 0, "state": "decoding", "request_id": "r-1"}])
        assert os.path.basename(path).startswith(f"flightrec-{os.getpid()}-")
        assert path.endswith("-" + reason.replace(" ", "-") + ".jsonl")
        with open(path, encoding="utf-8") as f:
            lines.append(_masked([json.loads(s) for s in f.read().splitlines()]))
    assert lines[1] == lines[0]
    assert lines[1][0]["kind"] == "flightrec" and lines[1][1]["kind"] == "slot"


def test_dump_failure_returns_empty_not_raises(tmp_path):
    target = tmp_path / "not-a-dir"
    target.write_text("file in the way")
    for fr in both(2):
        fr.record("crash")
        assert fr.dump(str(target), "crash") == ""


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("flightrec-models")
    dirs = {}
    for name, seed in (("a", 0), ("b", 1)):
        write_tiny(str(root / name), seed)
        dirs[name] = str(root / name)
    return dirs


def test_debug_flightrec_serves_the_pool_ring_as_jax(model_dirs, tmp_path, fresh_trackers):
    """Demote and promote b on both pods; /debug/flightrec answers the pool
    ring ({"pool": summary}) behind the admin token, sliced by request id."""
    pair = Pair.build(model_dirs, names=("a", "b"), tmp=tmp_path, allow_admin_load=True,
                      admin_tokens=("tok",), host_state_budget_bytes=1 << 30)
    hdr = {"Authorization": "Bearer tok"}
    try:
        pair.agree("DELETE", "/admin/models/b", headers=hdr)
        pair.agree("POST", "/admin/models", {"name": "b", "model_dir": model_dirs["b"],
                                             "wait": True}, hdr)
        assert pair.agree("GET", "/debug/flightrec")[0] == 401
        for query in ("", "?request_id=none", "?request_id="):
            want, got = pair.both("GET", "/debug/flightrec" + query, headers=hdr)
            assert got[0] == want[0] == 200 and list(got[2]) == ["pool"]
            for side in (want, got):
                side[2]["pool"]["events"] = _masked(side[2]["pool"]["events"])
            assert got == want
        events = got[2]["pool"]["events"]
        assert [e["event"] for e in events] == ["tier.demote", "tier.promote", "ladder.source"]
        assert got[2]["pool"]["capacity"] == 256
    finally:
        pair.close()
