"""The port's runtime lockdep (modelx_tpu_torch/analysis/lockdep.py and its
pytest plugin) on the CPU.

- The cases of tests/test_lockdep.py against the port: a seeded two-thread
  lock inversion the graph must flag (its pacing from the port's
  ``testing/faults.FaultPlan``), the ordered negative control, a three-lock
  cycle, one report per site set, RLock re-entry, same-site instances,
  Condition over an instrumented RLock, a failed non-blocking acquire,
  the worst hold kept, the env gate, install/uninstall and idempotence.
- Parity: one scripted sequence of acquisitions on the reference's
  ``LockGraph`` and the port's gives the same edges and the same cycles.
- The plugin: loaded with ``-p modelx_tpu_torch.analysis.pytest_lockdep``
  (``make chaos-torch``), beside the JAX package's plugin that a conftest
  registers, a seeded inversion in a pytest subprocess gives ONE cycle
  report, from the port's graph alone, and exit 1.
- A drill on the port's own code: lockdep installed, a tiny CPU
  ``ModelServer`` in a ``ServerSet`` takes an admin load and unload of a
  second model while ``/v1/forward`` runs; no cycle, and the pool's and the
  server's lock classes are in the graph.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request

import pytest

from modelx_tpu.analysis import lockdep as jlockdep
from modelx_tpu_torch.analysis import lockdep
from modelx_tpu_torch.testing.faults import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(fn) -> threading.Thread:
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


class TestInversionDrill:
    def test_seeded_lock_inversion_is_flagged(self):
        """Thread 1 takes pool->servers, thread 2 servers->pool, strictly
        one after the other: one cycle naming both sites, with both stacks,
        and both paced holds past the 10 ms threshold."""
        graph = lockdep.LockGraph(hold_threshold_ms=10.0)
        pool_lock = lockdep.make_lock(graph, site="lifecycle.py:pool._lock")
        servers_lock = lockdep.make_lock(graph, site="serve.py:sset._servers_lock")
        plan = FaultPlan(seed=7)
        plan.add("drill.hold", latency_at=[0, 1], latency_s=0.02)

        def t1():
            with pool_lock:
                plan.maybe_fail("drill.hold")
                with servers_lock:
                    pass

        def t2():
            with servers_lock:
                plan.maybe_fail("drill.hold")
                with pool_lock:
                    pass

        for fn in (t1, t2):
            th = _run(fn)
            th.join(timeout=5)
            assert not th.is_alive()
        cycles = graph.cycles
        assert len(cycles) == 1
        sites = set(cycles[0].path_sites)
        assert sites == {"lifecycle.py:pool._lock", "serve.py:sset._servers_lock"}
        report = graph.render_report()
        assert "potential deadlock" in report
        assert "earlier lock acquired at" in report
        assert "cycle-closing acquire at" in report
        holds = graph.long_holds
        assert {h.site for h in holds} == sites
        assert all(h.acquire_stack and h.release_stack for h in holds)
        assert graph.hold_counts() == {s: 1 for s in sites}

    def test_negative_control_ordered_acquisition_stays_quiet(self):
        graph = lockdep.LockGraph(hold_threshold_ms=10_000.0)
        pool_lock = lockdep.make_lock(graph, site="pool")
        servers_lock = lockdep.make_lock(graph, site="servers")
        plan = FaultPlan(seed=7)
        plan.add("drill.hold", latency_at=[0, 1], latency_s=0.01)

        def worker():
            with pool_lock:
                plan.maybe_fail("drill.hold")
                with servers_lock:
                    pass

        threads = [_run(worker), _run(worker)]
        for t in threads:
            t.join(timeout=5)
            assert not t.is_alive()
        assert graph.cycles == []
        assert graph.long_holds == []
        assert "clean" in graph.render_report()
        assert graph.edges() == {"pool": {"servers"}}
        assert graph.classes == {"pool", "servers"}

    def test_three_lock_cycle(self):
        graph = lockdep.LockGraph()
        a = lockdep.make_lock(graph, site="A")
        b = lockdep.make_lock(graph, site="B")
        c = lockdep.make_lock(graph, site="C")
        for first, second in ((a, b), (b, c), (c, a)):
            with first:
                with second:
                    pass
        cycles = graph.cycles
        assert len(cycles) == 1
        assert set(cycles[0].path_sites) == {"A", "B", "C"}

    def test_cycle_reported_once_per_site_set(self):
        graph = lockdep.LockGraph()
        a = lockdep.make_lock(graph, site="A")
        b = lockdep.make_lock(graph, site="B")
        for _ in range(3):
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
        assert len(graph.cycles) == 1


class TestLockSemantics:
    def test_rlock_reentry_is_not_a_cycle(self):
        graph = lockdep.LockGraph()
        rl = lockdep.make_rlock(graph, site="R")
        with rl:
            with rl:
                pass
        assert graph.cycles == []

    def test_same_site_different_instances_not_a_cycle(self):
        graph = lockdep.LockGraph()
        repo_a = lockdep.make_lock(graph, site="store_fs.py:76")
        repo_b = lockdep.make_lock(graph, site="store_fs.py:76")
        with repo_a:
            with repo_b:
                pass
        assert graph.cycles == []

    def test_condition_with_instrumented_rlock(self):
        """The ModelPool shape: Condition(RLock) with wait/notify across
        threads; wait() fully releases and the protocol methods keep the
        Condition working."""
        graph = lockdep.LockGraph()
        lock = lockdep.make_rlock(graph, site="pool")
        cv = threading.Condition(lock)
        ready = []

        def waiter():
            with cv:
                while not ready:
                    cv.wait(timeout=2)
                ready.append("seen")

        t = _run(waiter)
        time.sleep(0.05)
        with cv:
            ready.append("go")
            cv.notify_all()
        t.join(timeout=5)
        assert not t.is_alive()
        assert "seen" in ready
        assert graph.cycles == []

    def test_nonblocking_acquire_failure_records_nothing(self):
        graph = lockdep.LockGraph()
        lk = lockdep.make_lock(graph, site="L")
        assert lk.acquire()
        got = [None]

        def contender():
            got[0] = lk.acquire(blocking=False)

        t = _run(contender)
        t.join(timeout=5)
        assert got[0] is False
        lk.release()
        assert graph.acquisitions == 1

    def test_hold_report_keeps_worst_duration(self):
        graph = lockdep.LockGraph(hold_threshold_ms=5.0)
        lk = lockdep.make_lock(graph, site="L")
        for wait in (0.01, 0.03, 0.02):
            with lk:
                time.sleep(wait)
        holds = graph.long_holds
        assert len(holds) == 1
        assert holds[0].duration_s >= 0.03
        assert graph.hold_counts() == {"L": 3}


def _not_installed():
    if lockdep._saved is not None:
        pytest.skip("the port's lockdep is installed for this run (MODELX_LOCKDEP=1)")


class TestInstall:
    def test_env_gate(self, monkeypatch):
        monkeypatch.delenv(lockdep.ENV_VAR, raising=False)
        assert not lockdep.enabled()
        assert lockdep.install_from_env() is None
        monkeypatch.setenv(lockdep.ENV_VAR, "0")
        assert not lockdep.enabled()
        monkeypatch.setenv(lockdep.ENV_VAR, "1")
        assert lockdep.enabled()
        # the same variable as the reference's gate
        assert lockdep.ENV_VAR == jlockdep.ENV_VAR and lockdep.ENV_HOLD_MS == jlockdep.ENV_HOLD_MS

    def test_install_instruments_new_locks_and_uninstall_restores(self):
        _not_installed()
        real_lock_factory = threading.Lock
        graph = lockdep.install()
        try:
            assert lockdep.owns_factories()
            a = threading.Lock()
            b = threading.RLock()
            assert isinstance(a, lockdep.InstrumentedLock)
            assert isinstance(b, lockdep.InstrumentedRLock)
            with a:
                with b:
                    pass
            assert graph.acquisitions >= 1
            import queue

            q = queue.Queue()
            q.put(1)
            assert q.get() == 1
        finally:
            lockdep.uninstall()
        assert threading.Lock is real_lock_factory
        assert not lockdep.owns_factories()
        with a:
            pass

    def test_install_is_idempotent(self):
        _not_installed()
        g1 = lockdep.install()
        try:
            g2 = lockdep.install()
            assert g1 is g2
        finally:
            lockdep.uninstall()
            lockdep.uninstall()

    def test_a_second_patch_is_seen(self):
        """A factory patched again after the install (another lockdep) no
        longer feeds this graph; ``owns_factories`` says so."""
        _not_installed()
        lockdep.install()
        try:
            ours = threading.Lock
            threading.Lock = lambda: ours()
            assert not lockdep.owns_factories()
            threading.Lock = ours
            assert lockdep.owns_factories()
        finally:
            lockdep.uninstall()


# -- parity with the reference's graph -------------------------------------------

SCRIPT = [("A", "B"), ("B", "C"), ("A", "C"), ("D", "A"), ("C", "A"), ("B", "D"),
          ("E", "E2"), ("E2", "E"), ("A", "B"), ("C", "D")]


def test_one_script_gives_the_reference_edges_and_cycles():
    """The same acquisitions, in the same order, on both graphs (single
    thread, then a second thread for the last pairs)."""
    seen = {}
    for name, mod in (("ref", jlockdep), ("port", lockdep)):
        graph = mod.LockGraph()
        locks = {s: mod.make_lock(graph, site=s) for s in {x for p in SCRIPT for x in p}}
        rl = mod.make_rlock(graph, site="R")

        def run(pairs, locks=locks, rl=rl):
            for outer, inner in pairs:
                with locks[outer]:
                    with rl:
                        with locks[inner]:
                            pass

        run(SCRIPT[:6])
        t = _run(lambda: run(SCRIPT[6:]))
        t.join(timeout=5)
        cycles = sorted(sorted(c.path_sites) for c in graph.cycles)
        seen[name] = ({a: set(b) for a, b in graph._edges.items()}, cycles,
                      graph.acquisitions)
    assert seen["port"] == seen["ref"]
    assert seen["port"][1]  # the script closes cycles


# -- the plugin ------------------------------------------------------------------

SEEDED = """
    import threading

    def test_seeded_inversion():
        from modelx_tpu_torch.analysis import lockdep
        a = threading.Lock()
        b = threading.Lock()  # another line: another lock class
        # the port's wrapper, around a raw lock: no second instrumentation
        assert type(a) is lockdep.InstrumentedLock
        assert type(a._inner).__module__ in ("_thread", "builtins")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
"""

CLEAN = """
    import threading

    def test_ordered():
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(2):
            with a:
                with b:
                    pass
"""


def _pytest(tmp_path, body: str, args: list, conftest: bool):
    (tmp_path / "test_seeded.py").write_text(textwrap.dedent(body))
    if conftest:
        # the repo's tests/conftest.py registers the JAX plugin this way
        (tmp_path / "conftest.py").write_text(
            'pytest_plugins = ["modelx_tpu.analysis.pytest_lockdep"]\n')
    env = dict(os.environ, MODELX_LOCKDEP="1", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist", *args, "test_seeded.py"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)


PORT_PLUGIN = ["-p", "modelx_tpu_torch.analysis.pytest_lockdep"]
JAX_PLUGIN = ["-p", "modelx_tpu.analysis.pytest_lockdep"]


@pytest.mark.parametrize("how", ["conftest", "jax-first", "jax-last"])
def test_one_graph_decides_when_both_plugins_load(tmp_path, how):
    """A seeded inversion with the port's plugin and the reference's plugin
    both loaded: one ``modelx_tpu_torch lockdep`` report with one cycle,
    no report from the reference's plugin, exit 1."""
    args = {"conftest": PORT_PLUGIN, "jax-first": JAX_PLUGIN + PORT_PLUGIN,
            "jax-last": PORT_PLUGIN + JAX_PLUGIN}[how]
    proc = _pytest(tmp_path, SEEDED, args, conftest=how == "conftest")
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "1 passed" in out
    assert out.count("modelx_tpu_torch lockdep") == 1
    assert " modelx lockdep " not in out  # the reference plugin's section
    assert out.count("potential deadlock") == 1
    assert "lockdep: 1 cycle(s)" in out


def test_reference_plugin_alone_reports_under_its_own_section(tmp_path):
    """The control for the case above: without the port's plugin the
    reference's installs and reports (so its absence there is the port's
    doing)."""
    proc = _pytest(tmp_path, CLEAN, [], conftest=True)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert " modelx lockdep " in out and "modelx_tpu_torch lockdep" not in out


def test_port_plugin_alone_clean_run_exits_0(tmp_path):
    proc = _pytest(tmp_path, CLEAN, PORT_PLUGIN, conftest=False)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "modelx_tpu_torch lockdep" in out and "lockdep: clean" in out


def test_plugin_off_without_the_env(tmp_path):
    (tmp_path / "test_seeded.py").write_text(textwrap.dedent(SEEDED).replace(
        "assert type(a) is lockdep.InstrumentedLock", "assert type(a) is not lockdep.InstrumentedLock"
    ).replace('assert type(a._inner).__module__ in ("_thread", "builtins")', ""))
    env = {k: v for k, v in os.environ.items() if k != "MODELX_LOCKDEP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist", *PORT_PLUGIN, "test_seeded.py"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lockdep" not in proc.stdout.split("passed")[-1]


def test_chaos_torch_loads_the_port_plugin():
    """The counterpart of the reference's conftest check: ``make
    chaos-torch`` runs the port's chaos sweeps under the port's plugin."""
    with open(os.path.join(REPO, "Makefile"), encoding="utf-8") as f:
        text = f.read()
    target = text.split("\nchaos-torch:", 1)[1].split("\n\n", 1)[0]
    assert "MODELX_LOCKDEP=1" in target
    assert "-p modelx_tpu_torch.analysis.pytest_lockdep" in target
    assert "-m chaos" in target and "tests/test_torch_" in target
    lint_target = text.split("\nlint-torch:", 1)[1].split("\n\n", 1)[0]
    assert "-m modelx_tpu_torch.analysis" in lint_target


# -- a drill on the port's pool --------------------------------------------------


def _post(port: int, path: str, body: dict, method: str = "POST"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=json.dumps(body).encode() if body is not None else None,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_lockdep_over_an_admin_load_and_unload_while_forward_runs(tmp_path):
    """Locks are instrumented only when made after the install, so the
    server, the pool and the HTTP front are built after it. A second
    model is admin-loaded and unloaded while /v1/forward traffic runs on
    the first; the graph must hold no cycle, and hold the pool's and the
    server's lock classes."""
    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve as tserve
    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.registry.server import free_port

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=64), dtype=torch.float32)
    dirs = {}
    for name, seed in (("a", 0), ("b", 1)):
        d = tmp_path / name
        d.mkdir()
        st.write_safetensors(str(d / "model.safetensors"),
                             llama.init_params(cfg, torch.Generator().manual_seed(seed)))
        dirs[name] = str(d)

    ours = lockdep._saved is None
    graph = lockdep.install(lockdep.LockGraph(hold_threshold_ms=10_000.0))
    httpd = sset = None
    t0 = time.monotonic()
    try:
        server = tserve.ModelServer(dirs["a"], dtype="float32", device="cpu", name="a",
                                    max_seq_len=64)
        sset = tserve.ServerSet({"a": server}, allow_admin_load=True,
                                staging_root=str(tmp_path / "staging"))
        sset.load_all()
        httpd = tserve.serve(sset, listen=f"127.0.0.1:{free_port()}")
        port = httpd.server_address[1]
        want = _post(port, "/v1/forward", {"tokens": [[1, 2, 3, 4]]})[1]["logits_argmax"]
        stop = threading.Event()
        failures, done = [], [0]

        def traffic():
            while not stop.is_set():
                try:
                    status, body = _post(port, "/v1/a/forward", {"tokens": [[1, 2, 3, 4]]})
                    if status != 200 or body["logits_argmax"] != want:
                        failures.append((status, body))
                    done[0] += 1
                except Exception as e:  # any transport failure counts
                    failures.append(repr(e))
                    return

        t = _run(traffic)
        status, body = _post(port, "/admin/models",
                             {"name": "b", "model_dir": dirs["b"], "wait": True})
        assert status == 200 and body["b"]["state"] == "READY", body
        assert _post(port, "/v1/b/forward", {"tokens": [[5, 6]]})[0] == 200
        status, body = _post(port, "/admin/models/b", None, method="DELETE")
        assert status == 200, body
        stop.set()
        t.join(timeout=30)
        assert not failures, failures[:3]
        assert done[0] >= 1
        pool_site, device_site = sset.pool._lock.site, server._device_lock.site
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if sset is not None:
            sset.close()
        if ours:
            lockdep.uninstall()
    assert graph.cycles == [], graph.render_report()
    assert os.path.join("dl", "lifecycle.py") in pool_site
    assert os.path.join("dl", "serve.py") in device_site
    assert {pool_site, device_site} <= graph.classes
    assert time.monotonic() - t0 < 10.0
