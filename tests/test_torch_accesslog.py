"""The port's access log (modelx_tpu_torch.utils.accesslog) against the JAX
package's, on the CPU: the same writes go to a log of each package and the
files must hold the same lines (``ts``, the wall clock, masked): rotation
past ``max_bytes`` into one ``.1`` generation, no rotation at 0,
``open_log``'s plumbing, concurrent writers that never tear a line,
unserializable records dropped and a write failure that disables the log
without raising.
"""

import json
import os
import threading

import pytest

from modelx_tpu.utils import accesslog as jlog
from modelx_tpu_torch.utils import accesslog as tlog


def _lines(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        out = [json.loads(s) for s in f.read().splitlines()]
    for rec in out:
        assert isinstance(rec.pop("ts"), float)
    return out


def both(tmp_path, run):
    """``run(module, path)`` with each package's module on its own file;
    the files (and their ``.1`` generations) must hold equal lines."""
    got = {}
    for name, mod in (("jax", jlog), ("port", tlog)):
        path = str(tmp_path / f"{name}.log")
        run(mod, path)
        got[name] = (_lines(path), _lines(path + ".1"))
    assert got["port"] == got["jax"]
    return got["port"]


def test_rotates_past_cap_and_keeps_one_generation(tmp_path):
    def run(mod, path):
        log = mod.AccessLog(path, max_bytes=200)
        for i in range(20):
            log.write(request_id=f"r-{i}", status=200)
        log.close()
    current, rotated = both(tmp_path, run)
    ids = [r["request_id"] for r in rotated + current]
    assert rotated and ids == [f"r-{i}" for i in range(20 - len(ids), 20)]


def test_zero_cap_never_rotates(tmp_path):
    def run(mod, path):
        log = mod.AccessLog(path)
        for i in range(50):
            log.write(i=i)
        log.close()
    current, rotated = both(tmp_path, run)
    assert rotated == [] and len(current) == 50


def test_open_log_plumbs_max_bytes(tmp_path):
    for mod in (jlog, tlog):
        log = mod.open_log(str(tmp_path / f"{mod.__name__}.log"), max_bytes=7)
        assert log.max_bytes == 7
        log.close()
        assert mod.open_log("", max_bytes=7) is None and mod.open_log(None) is None


def test_appends_to_an_existing_file_and_counts_its_size(tmp_path):
    def run(mod, path):
        with open(path, "w") as f:
            f.write(json.dumps({"ts": 1.0, "old": True}) + "\n")
        log = mod.AccessLog(path, max_bytes=60)
        log.write(request_id="new", status=201)  # past the cap with the old line
        log.close()
    current, rotated = both(tmp_path, run)
    assert current == [] and rotated == [{"old": True}, {"request_id": "new", "status": 201}]


def test_concurrent_writers_never_tear_a_line(tmp_path):
    def run(mod, path):
        log = mod.AccessLog(path)
        threads = [threading.Thread(target=lambda k=k: [log.write(t=k, i=i) for i in range(50)])
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        log.close()
    for name, mod in (("jax", jlog), ("port", tlog)):
        path = str(tmp_path / f"{name}.log")
        run(mod, path)
        lines = _lines(path)
        assert sorted((r["t"], r["i"]) for r in lines) == [
            (k, i) for k in range(8) for i in range(50)]


def test_unserializable_dropped_and_failure_disables(tmp_path):
    class Loop:
        def __repr__(self):
            return "loop"

    def run(mod, path):
        log = mod.AccessLog(path)
        circular: dict = {}
        circular["self"] = circular
        log.write(bad=circular)  # dropped with a warning
        log.write(obj=Loop(), ok=1)  # default=str
        log._fh.close()
        log._fh = open("/dev/full", "a", buffering=1)  # a full disk: the log disables itself
        log.write(after=1)
        log.write(after=2)
        log.close()
    current, rotated = both(tmp_path, run)
    assert current == [{"obj": "loop", "ok": 1}] and rotated == []


@pytest.mark.parametrize("fields", [
    {"request_id": "req-1", "attempt": 1, "client": "ip:127.0.0.1", "path": "/v1/forward",
     "model": "m", "status": 200, "ms": 1.5, "timing": {"total_ms": 1.5}},
    {"unicode": "héllo ✓", "nested": {"a": [1, 2.5, None, True]}},
], ids=["serving-line", "unicode"])
def test_lines_equal(tmp_path, fields):
    def run(mod, path):
        log = mod.AccessLog(path)
        log.write(**fields)
        log.close()
    current, _ = both(tmp_path, run)
    assert current == [fields]
    with open(tmp_path / "port.log", encoding="utf-8") as f, \
            open(tmp_path / "jax.log", encoding="utf-8") as g:
        strip = [json.dumps({k: v for k, v in json.loads(x).items() if k != "ts"})
                 for x in (f.read(), g.read())]
    assert strip[0] == strip[1]
