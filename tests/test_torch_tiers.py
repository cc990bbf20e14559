"""The port's state tiers (modelx_tpu_torch.dl.tiers, through the model
pool) against the JAX package's, on the CPU, as tests/test_tiers.py runs
the reference's:

- content keys, ``dir_pairs`` and ``is_resource_exhausted`` equal the
  reference's (the port's also matches ``torch.cuda.OutOfMemoryError`` and
  "CUDA out of memory" anywhere in the cause chain);
- the same offers, promotions, spills and fault-stub crashes on a port
  ``TierStore`` and a JAX one leave equal tiers and equal ``snapshot()``s,
  and the promoted tensors equal the demoted ones bit for bit (bf16 and
  int8 ``QTensor`` leaves through the disk spool included);
- a JAX pod and a port pod with the tier budgets set: an unloaded or
  evicted model demotes to host RAM, spills to disk, and a reload promotes
  it with token-exact generation; an injected out-of-memory error on a
  load recovers by demotion (the port's as ``torch.cuda.OutOfMemoryError``),
  one with nothing to shed ends FAILED; the 507 is retryable or hard. The
  pods' ``/admin/models`` bodies are equal with tests/test_torch_lifecycle.py's
  fields masked; the flight recorders' events equal with ``t`` and ``ms``
  masked.
"""

import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from modelx_tpu.dl import serve as jserve
from modelx_tpu.dl import tiers as jtiers
from modelx_tpu.dl.lifecycle import PoolError as JaxPoolError
from modelx_tpu.dl.lifecycle import estimate_dir_bytes
from modelx_tpu.testing.faults import FaultPlan, InjectedCrash
from modelx_tpu_torch.dl import serve as tserve
from modelx_tpu_torch.dl import tiers
from modelx_tpu_torch.dl.lifecycle import PoolError
from modelx_tpu_torch.ops.quant import QTensor
from tests.test_torch_lifecycle import (  # noqa: F401 (fresh_trackers is a fixture)
    PROMPT,
    Pair,
    _models_agree,
    fresh_trackers,
    write_tiny,
)

PARAMS_SHAPE = (8, 4)


@pytest.fixture(autouse=True)
def _fresh_trackers(fresh_trackers):
    """Both packages' control-plane trackers from zero for every test."""


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tier-models")
    dirs = {}
    for name, seed in (("a", 0), ("b", 1), ("c", 2)):
        write_tiny(str(root / name), seed)
        dirs[name] = str(root / name)
    return dirs


def stores(tmp_path, host=1 << 30, disk=1 << 30, fault_plan=None):
    """(JAX store, port store) with the same budgets and fault plan."""
    return (jtiers.TierStore(host_budget_bytes=host, disk_budget_bytes=disk,
                             spool_root=str(tmp_path / "jspool"), fault_plan=fault_plan),
            tiers.TierStore(host_budget_bytes=host, disk_budget_bytes=disk,
                            spool_root=str(tmp_path / "tspool"), fault_plan=fault_plan))


def tiny_params(seed=0, n=3, shape=PARAMS_SHAPE):
    """(JAX params, port params) of the same values."""
    rng = np.random.RandomState(seed)
    arrays = {f"w{i}": rng.rand(*shape).astype(np.float32) for i in range(n)}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


def params_nbytes(seed=0):
    return sum(int(v.nbytes) for v in tiny_params(seed)[1].values())


def both(pair_of_stores, op, *args, **kw):
    """Run ``op`` on both stores; JAX gets the JAX params, the port the
    port's, when the first argument after the key and name is a pair."""
    out = []
    for i, store in enumerate(pair_of_stores):
        a = [x[i] if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], dict)
             else x for x in args]
        out.append(getattr(store, op)(*a, **kw))
    return out


def assert_tiers_equal(js, ts, keys):
    assert ts.snapshot() == js.snapshot()
    assert [ts.tier_of(k) for k in keys] == [js.tier_of(k) for k in keys]


# -- keying ---------------------------------------------------------------------------


def test_content_key_equals_jax():
    pairs = [("b.safetensors", 10, "d1"), ("a.safetensors", 20, "d2")]
    assert tiers.content_key(pairs) == jtiers.content_key(pairs) == tiers.content_key(pairs[::-1])
    assert len(tiers.content_key(pairs)) == 16
    assert tiers.content_key(pairs, "dp=2") == jtiers.content_key(pairs, "dp=2")
    assert tiers.content_key([("m.safetensors", 10, "d1")]) != tiers.content_key(
        [("m.safetensors", 10, "d2")])
    assert tiers.content_key([]) == jtiers.content_key([]) == ""


def test_dir_pairs_equal_jax_and_salt_with_mtime(tmp_path):
    p = tmp_path / "model.safetensors"
    p.write_bytes(b"x" * 64)
    (tmp_path / "other.txt").write_text("not a weight")
    before = tiers.dir_pairs(str(tmp_path))
    assert before == jtiers.dir_pairs(str(tmp_path)) and before[0][:2] == ("model.safetensors", 64)
    os.utime(p, ns=(1, 1))
    assert tiers.content_key(before) != tiers.content_key(tiers.dir_pairs(str(tmp_path)))


def test_ref_pairs_equal_jax(model_dirs, tmp_path):
    from modelx_tpu.client.client import Client as JaxClient
    from modelx_tpu.registry.server import free_port
    from modelx_tpu_torch.registry.fs import LocalFSProvider
    from modelx_tpu_torch.registry.server import Options, RegistryServer
    from modelx_tpu_torch.registry.store_fs import FSRegistryStore

    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"),
                         store=FSRegistryStore(LocalFSProvider(str(tmp_path / "reg"))))
    base = srv.serve_background()
    try:
        JaxClient(base, quiet=True).push("library/a", "v1", model_dirs["a"])
        ref = f"{base}/library/a@v1"
        got = tiers.ref_pairs(ref)
        assert got == jtiers.ref_pairs(ref) and got[0][2].startswith("sha256:")
    finally:
        srv.shutdown()


@pytest.mark.parametrize("make,want", [
    (lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"), True),
    (lambda: type("XlaRuntimeError", (RuntimeError,), {})("out of memory while allocating 1g"),
     True),
    (lambda: ValueError("bad dtype"), False),
    (lambda: None, False),
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     True),
    (lambda: RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), True),
    (lambda: RuntimeError("CUDA error: an illegal memory access"), False),
], ids=["status-text", "xla-type", "ordinary", "none", "torch-oom", "cuda-oom-text",
        "other-cuda"])
def test_is_resource_exhausted(make, want):
    exc = make()
    assert tiers.is_resource_exhausted(exc) is want
    if not isinstance(exc, torch.cuda.OutOfMemoryError) and "CUDA" not in str(exc):
        assert jtiers.is_resource_exhausted(exc) is want  # the reference's own cases
    if exc is not None:
        try:  # anywhere in the cause chain
            raise RuntimeError("load failed") from exc
        except RuntimeError as outer:
            assert tiers.is_resource_exhausted(outer) is want


# -- the store ------------------------------------------------------------------------


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(t)


def _restored(store, key, device="cpu"):
    promo = store.promote(key)
    assert promo is not None
    return promo, tiers.unflatten_params(promo.treedef, [x.to(device) for x in promo.leaves])


def test_disabled_store_is_inert(tmp_path):
    js, ts = stores(tmp_path, host=0, disk=0)
    params = tiny_params()
    assert not ts.enabled and not js.enabled
    assert both((js, ts), "offer", "k", "m", params) == [False, False]
    assert ts.promote("k") is None and js.promote("k") is None


def test_offer_promote_round_trip_host(tmp_path):
    js, ts = stores(tmp_path)
    params = tiny_params(seed=3)
    assert both((js, ts), "offer", "k1", "m", params) == [True, True]
    assert_tiers_equal(js, ts, ["k1"])
    promo, restored = _restored(ts, "k1")
    assert promo.tier == "host" and promo.nbytes == params_nbytes(3)
    for k, v in params[1].items():
        assert torch.equal(restored[k], v)
    assert js.promote("k1").tier == "host"
    assert_tiers_equal(js, ts, ["k1"])


def test_keep_on_promote_and_free_redemote(tmp_path):
    js, ts = stores(tmp_path)
    both((js, ts), "offer", "k1", "m", tiny_params())
    assert ts.promote("k1") is not None and js.promote("k1") is not None
    assert both((js, ts), "offer", "k1", "m", tiny_params()) == [True, True]
    assert ts.snapshot()["host"]["demotions"] == 1
    assert_tiers_equal(js, ts, ["k1"])


def test_host_leaves_are_copies(tmp_path):
    _, ts = stores(tmp_path)
    params = tiny_params()[1]
    ts.offer("k1", "m", params)
    params["w0"].zero_()  # the served tensor changes; the tier copy does not
    _, restored = _restored(ts, "k1")
    assert torch.equal(restored["w0"], tiny_params()[1]["w0"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8-qtensor", "scalar"])
def test_disk_round_trip_is_bit_exact(tmp_path, dtype):
    """Raw bytes + meta.json: bf16 (no numpy dtype), fp32, an int8 QTensor
    (codes and scales) and a 0-d leaf come back bit for bit."""
    _, ts = stores(tmp_path, host=0)
    base = torch.arange(24, dtype=torch.float32).reshape(6, 4) / 7
    if dtype == "bfloat16":
        params = {"w": base.to(torch.bfloat16)}
    elif dtype == "float32":
        params = {"w": base}
    elif dtype == "scalar":
        params = {"w": torch.tensor(1.5), "e": torch.zeros((0, 3))}
    else:
        from modelx_tpu_torch.ops.quant import quantize_tensor

        params = {"w": quantize_tensor(base), "norm": base[0]}
    assert ts.offer("k1", "m", params)
    assert ts.tier_of("k1") == "disk"
    promo, restored = _restored(ts, "k1")
    assert promo.tier == "disk"
    meta_path = os.path.join(ts.spool_root, "k1", "leaves", "meta.json")
    assert os.path.exists(meta_path)
    for k, v in params.items():
        got = restored[k]
        if isinstance(v, QTensor):
            assert isinstance(got, QTensor)
            assert torch.equal(got.q, v.q) and torch.equal(got.scale, v.scale)
            assert got.q.dtype == torch.int8
        else:
            assert got.dtype == v.dtype and got.shape == v.shape
            assert np.array_equal(_np(got).reshape(-1).view(np.uint8),
                                  _np(v).reshape(-1).view(np.uint8))
    if dtype == "bfloat16":
        # the reference's disk tier gives the same bf16 values
        js, _ = stores(tmp_path / "j", host=0)
        jparams = {"w": jnp.asarray(base.numpy()).astype(jnp.bfloat16)}
        assert js.offer("k1", "m", jparams)
        jleaf = np.asarray(js.promote("k1").leaves[0])
        assert np.array_equal(jleaf.view(np.uint16), _np(restored["w"]).view(np.uint16))


def test_host_overflow_spills_lru_to_disk(tmp_path):
    js, ts = stores(tmp_path, host=int(params_nbytes() * 1.5))
    both((js, ts), "offer", "k1", "m1", tiny_params(1))
    both((js, ts), "offer", "k2", "m2", tiny_params(2))  # k1 (older) spills
    assert ts.tier_of("k1") == "disk" and ts.tier_of("k2") == "host"
    assert ts.snapshot()["spills"] == 1
    assert_tiers_equal(js, ts, ["k1", "k2"])
    _, restored = _restored(ts, "k1")
    assert torch.equal(restored["w0"], tiny_params(1)[1]["w0"])


def test_disk_overflow_drops_oldest(tmp_path):
    js, ts = stores(tmp_path, host=0, disk=int(params_nbytes() * 1.5))
    both((js, ts), "offer", "k1", "m1", tiny_params(1))
    both((js, ts), "offer", "k2", "m2", tiny_params(2))  # k1 (older) drops
    assert ts.tier_of("k1") is None and ts.tier_of("k2") == "disk"
    assert ts.snapshot()["demotions_dropped"] == 1
    assert not os.path.exists(os.path.join(ts.spool_root, "k1"))
    assert_tiers_equal(js, ts, ["k1", "k2"])


def test_oversized_offer_is_dropped_whole(tmp_path):
    one = params_nbytes()
    js, ts = stores(tmp_path, host=one // 2, disk=one // 2)
    assert both((js, ts), "offer", "k1", "m", tiny_params()) == [False, False]
    assert ts.tier_of("k1") is None and ts.snapshot()["demotions_dropped"] == 1
    assert_tiers_equal(js, ts, ["k1"])


def test_spill_host_moves_everything(tmp_path):
    js, ts = stores(tmp_path)
    both((js, ts), "offer", "k1", "m1", tiny_params(1))
    both((js, ts), "offer", "k2", "m2", tiny_params(2))
    assert ts.spill_host() == js.spill_host() == 2
    assert_tiers_equal(js, ts, ["k1", "k2"])
    assert ts.promote("k1").tier == "disk"


def test_crash_mid_demotion_is_fully_freed(tmp_path):
    """A fault stub's crash at ``tiers.demote``: no entry and no partial
    spool; the next offer of the key succeeds."""
    outs = []
    for side in ("j", "t"):
        plan = FaultPlan(seed=7).add(tiers.OP_DEMOTE, errors_at=[0],
                                     error=InjectedCrash("died mid-demote"))
        js, ts = stores(tmp_path / side, fault_plan=plan)
        store, params = (js, tiny_params()[0]) if side == "j" else (ts, tiny_params()[1])
        assert not store.offer("k1", "m", params)
        assert store.tier_of("k1") is None
        assert not os.path.exists(os.path.join(store.spool_root, "k1"))
        assert store.offer("k1", "m", params)
        outs.append(store.snapshot())
    assert outs[1] == outs[0] and outs[1]["demotion_failures"] == 1


def test_crash_mid_promotion_returns_miss(tmp_path):
    outs = []
    for side in ("j", "t"):
        plan = FaultPlan(seed=7).add(tiers.OP_PROMOTE, errors_at=[0],
                                     error=InjectedCrash("died mid-promote"))
        js, ts = stores(tmp_path / side, fault_plan=plan)
        store, params = (js, tiny_params()[0]) if side == "j" else (ts, tiny_params()[1])
        store.offer("k1", "m", params)
        assert store.promote("k1") is None  # the crashed attempt is a miss
        assert store.promote("k1") is not None  # the entry is intact
        outs.append(store.snapshot())
    assert outs[1] == outs[0]


def test_crash_mid_spill_drops_the_entry(tmp_path):
    outs = []
    for side in ("j", "t"):
        plan = FaultPlan(seed=7).add(tiers.OP_SPILL, errors_at=[0],
                                     error=InjectedCrash("died mid-spill"))
        js, ts = stores(tmp_path / side, fault_plan=plan)
        store, params = (js, tiny_params()[0]) if side == "j" else (ts, tiny_params()[1])
        store.offer("k1", "m", params)
        assert store.spill_host() == 0 and store.tier_of("k1") is None
        outs.append(store.snapshot())
    assert outs[1] == outs[0]


# -- the pool ---------------------------------------------------------------------------


def tier_pair(model_dirs, tmp_path, names=("a", "b"), **kw):
    kw.setdefault("host_state_budget_bytes", 1 << 30)
    kw.setdefault("disk_state_budget_bytes", 1 << 30)
    return Pair.build(model_dirs, names=names, tmp=tmp_path, allow_admin_load=True, **kw)


def _events(pool):
    """The pool ring's events with the clock readings ``t`` and ``ms``
    masked."""
    return [{k: ("<masked>" if k in ("t", "ms") else v) for k, v in ev.items()}
            for ev in pool.flightrec.summary()["events"]]


def _baseline_tokens(model_dir, n=8):
    server = tserve.ModelServer(model_dir, dtype="float32", device="cpu", name="baseline")
    server.load()
    return server.generate(np.asarray(PROMPT, np.int32), max_new_tokens=n)


def test_unload_demotes_and_reload_promotes_token_exact(model_dirs, tmp_path):
    """Unload b (host tier), reload it (tier promotion, no safetensors
    parse), spill it (disk tier), reload again: token-exact against a
    churn-free server, and every admin body equal to the JAX pod's."""
    pair = tier_pair(model_dirs, tmp_path)
    try:
        expected = _baseline_tokens(model_dirs["b"])
        got = pair.agree("DELETE", "/admin/models/b")
        assert got[2]["b"]["state"] == "UNLOADED"
        admin = pair.agree("GET", "/admin/models")[2]
        assert admin["models"]["b"]["tier"] == "host"
        assert admin["pool"]["tiers"]["host"]["entries"] == 1
        got = pair.agree("POST", "/admin/models",
                         {"name": "b", "model_dir": model_dirs["b"], "wait": True})
        assert got[2]["b"]["load_source"] == "tier"
        assert pair.agree("GET", "/admin/models")[2]["models"]["b"]["tier"] == "hbm"
        assert pair.t.servers["b"].stats["tier"] == "host"
        np.testing.assert_array_equal(
            pair.t.servers["b"].generate(np.asarray(PROMPT, np.int32), max_new_tokens=8),
            expected)
        assert pair.agree("POST", "/v1/b/generate",
                          {"tokens": PROMPT, "max_new_tokens": 8})[2]["tokens"] == \
            expected.tolist()
        admin = pair.agree("GET", "/admin/models")[2]
        assert admin["pool"]["tiers"]["host"]["hits"] == 1
        # to disk and back
        pair.agree("DELETE", "/admin/models/b")
        assert pair.j.pool.tiers.spill_host() == pair.t.pool.tiers.spill_host() == 1
        assert pair.agree("GET", "/admin/models")[2]["models"]["b"]["tier"] == "disk"
        pair.agree("POST", "/admin/models", {"name": "b", "model_dir": model_dirs["b"],
                                             "wait": True})
        assert pair.t.servers["b"].stats["tier"] == "disk"
        assert pair.agree("POST", "/v1/b/generate",
                          {"tokens": PROMPT, "max_new_tokens": 8})[2]["tokens"] == \
            expected.tolist()
        pair.agree("GET", "/admin/models")
        _models_agree(pair)
        assert _events(pair.t.pool) == _events(pair.j.pool)
        names = [ev["event"] for ev in _events(pair.t.pool)]
        assert {"tier.demote", "tier.promote", "ladder.source"} <= set(names)
    finally:
        pair.close()


def test_eviction_demotes_instead_of_discarding(model_dirs, tmp_path):
    pair = tier_pair(model_dirs, tmp_path, evict_idle=True)
    try:
        est_c = estimate_dir_bytes(model_dirs["c"])
        for pool in (pair.j.pool, pair.t.pool):
            # one byte short of fitting c beside a and b: evicting b suffices
            pool.hbm_budget_bytes = pool.reserved_bytes() + est_c - 1
            pool.enter("a"), pool.exit("a")  # a recent, b the LRU victim
        got = pair.agree("POST", "/admin/models",
                         {"name": "c", "model_dir": model_dirs["c"], "wait": True})
        assert got[2]["c"]["state"] == "READY"
        states = pair.agree("GET", "/admin/models")[2]["models"]
        assert states["b"]["state"] == "UNLOADED" and states["b"]["tier"] == "host"
        assert states["b"]["evictions_total"] == 1
        # the evicted model comes back from the host tier (a evicted now)
        for pool in (pair.j.pool, pair.t.pool):
            pool.enter("c"), pool.exit("c")
        got = pair.agree("POST", "/admin/models",
                         {"name": "b", "model_dir": model_dirs["b"], "wait": True})
        assert got[2]["b"]["load_source"] == "tier"
        assert pair.agree("GET", "/admin/models")[2]["models"]["a"]["tier"] == "host"
        assert _events(pair.t.pool) == _events(pair.j.pool)
    finally:
        pair.close()


def test_disabled_tiers_keep_the_discard(model_dirs, tmp_path):
    pair = tier_pair(model_dirs, tmp_path, host_state_budget_bytes=0,
                     disk_state_budget_bytes=0)
    try:
        got = pair.agree("DELETE", "/admin/models/b")
        assert "tier" not in got[2]["b"]
        admin = pair.agree("GET", "/admin/models")[2]
        assert "tiers" not in admin["pool"] and "tier" not in admin["models"]["b"]
    finally:
        pair.close()


def _flaky_loads(monkeypatch, errors):
    """The first load of model c raises the package's out-of-memory error:
    XLA's RESOURCE_EXHAUSTED in JAX, ``torch.cuda.OutOfMemoryError`` in the
    port (the error a card's allocator raises)."""
    fails = {"jax": 0, "port": 0}
    for side, cls in (("jax", jserve.ModelServer), ("port", tserve.ModelServer)):
        real = cls.load

        def load(server, _real=real, _side=side):
            if server.name == "c" and fails[_side] < errors:
                fails[_side] += 1
                if _side == "jax":
                    raise type("XlaRuntimeError", (RuntimeError,), {})(
                        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
                        "1073741824 bytes")
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 1.00 GiB")
            return _real(server)

        monkeypatch.setattr(cls, "load", load)
    return fails


def test_injected_oom_recovers_by_demotion(model_dirs, tmp_path, monkeypatch):
    """The first load of c runs out of device memory: the pool demotes
    idle b and retries once; c lands READY, live traffic on a drops
    nothing."""
    pair = tier_pair(model_dirs, tmp_path)
    fails = _flaky_loads(monkeypatch, errors=1)
    stop = threading.Event()
    counts = {"served": 0, "errors": 0}

    def traffic():
        while not stop.is_set():
            try:
                pair.t.servers["a"].generate(np.asarray(PROMPT, np.int32), max_new_tokens=2)
                counts["served"] += 1
            except Exception:
                counts["errors"] += 1

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        for pool in (pair.j.pool, pair.t.pool):
            pool.enter("a"), pool.exit("a")  # a hot: b is the victim
        got = pair.agree("POST", "/admin/models",
                         {"name": "c", "model_dir": model_dirs["c"], "wait": True})
        stop.set()
        t.join(timeout=30)
        assert fails == {"jax": 1, "port": 1}
        assert got[2]["c"]["state"] == "READY"
        states = pair.agree("GET", "/admin/models")[2]["models"]
        assert states["b"]["state"] == "UNLOADED" and states["b"]["tier"] == "host"
        assert counts["errors"] == 0 and counts["served"] > 0
        assert _events(pair.t.pool) == _events(pair.j.pool)
        assert "pool.oom_retry" in [ev["event"] for ev in _events(pair.t.pool)]
    finally:
        stop.set()
        pair.close()


def test_oom_with_nothing_to_shed_ends_failed(model_dirs, tmp_path, monkeypatch):
    """A single-tenant pool: nothing idle to demote, so the out-of-memory
    error is not retried and the load lands FAILED with the error; the
    reasons are each package's allocator message."""
    pair = tier_pair(model_dirs, tmp_path, names=("a",))
    _flaky_loads(monkeypatch, errors=2)
    try:
        want, got = pair.both("POST", "/admin/models",
                              {"name": "c", "model_dir": model_dirs["c"], "wait": True})
        assert got[2]["c"]["state"] == want[2]["c"]["state"] == "FAILED"
        assert "CUDA out of memory" in got[2]["c"]["error"]
        assert "RESOURCE_EXHAUSTED" in want[2]["c"]["error"]
        for side in (want, got):
            side[2]["c"].pop("error")
        assert got == want
        want, got = pair.both("GET", "/admin/models")
        for side in (want, got):
            side[2]["models"]["c"].pop("error")
        assert got == want and got[2]["models"]["a"]["state"] == "READY"
        assert _events(pair.t.pool) == _events(pair.j.pool)
    finally:
        pair.close()


def test_507_distinguishes_retryable_from_hard_refusal(model_dirs, tmp_path):
    """Busy models whose drain could make room: Retry-After and "could
    free"; a load no demotion can fit: a hard refusal with no header."""
    pair = tier_pair(model_dirs, tmp_path)
    try:
        est_c = estimate_dir_bytes(model_dirs["c"])
        outs = []
        for pool, err in ((pair.j.pool, JaxPoolError), (pair.t.pool, PoolError)):
            pool.hbm_budget_bytes = pool.reserved_bytes() + est_c - 1
            with pytest.raises(err) as retryable:
                pool.request_load("c", model_dir=model_dirs["c"])
            pool.hbm_budget_bytes = 1
            with pytest.raises(err) as hard:
                pool.request_load("c", model_dir=model_dirs["c"])
            outs.append([(e.value.status, str(e.value), e.value.headers)
                         for e in (retryable, hard)])
        assert outs[1] == outs[0]
        assert "could free" in outs[1][0][1] and outs[1][0][2] == {"Retry-After": "2"}
        assert "hard refusal" in outs[1][1][1] and outs[1][1][2] == {}
    finally:
        pair.close()


def test_crash_mid_demotion_leaves_the_pool_consistent(model_dirs, tmp_path):
    """A fault stub's crash in the pool's demotion: the unload completes
    (the state is discarded), the entry is UNLOADED with tier "none", and
    a reload takes the cold path."""
    pair = tier_pair(model_dirs, tmp_path)
    try:
        for pool in (pair.j.pool, pair.t.pool):
            pool.tiers.fault_plan = FaultPlan(seed=11).add(
                tiers.OP_DEMOTE, errors_at=[0], error=InjectedCrash("died mid-demotion"))
        got = pair.agree("DELETE", "/admin/models/b")
        assert got[2]["b"]["state"] == "UNLOADED"
        admin = pair.agree("GET", "/admin/models")[2]
        assert admin["models"]["b"]["tier"] == "none"
        assert admin["pool"]["tiers"]["demotion_failures"] == 1
        got = pair.agree("POST", "/admin/models",
                         {"name": "b", "model_dir": model_dirs["b"], "wait": True})
        assert got[2]["b"]["load_source"] == "dir"
        assert "tier" not in pair.t.servers["b"].stats
        assert _events(pair.t.pool) == _events(pair.j.pool)
    finally:
        pair.close()


def test_int8_model_demotes_and_promotes_its_qtensors(model_dirs, tmp_path):
    """An int8 server's params (QTensor codes and scales) through the host
    and the disk tier: the promoted params equal the demoted ones, and the
    reload generates the same tokens.

    The reservations differ from the reference's here, as stated in the
    pool's docstring: the port's ``load_bytes`` is the bytes over the link
    (the checkpoint's fp32 weights, quantized on the device), the
    reference's the int8 codes and scales placed on the mesh; so the port
    over-reserves. The tier holds the device bytes in both."""
    tsset = tserve.ServerSet(
        {n: tserve.ModelServer(model_dirs[n], dtype="float32", device="cpu", name=n,
                               quantize="int8") for n in ("a", "b")},
        allow_admin_load=True, host_state_budget_bytes=1 << 30,
        disk_state_budget_bytes=1 << 30, state_spool_dir=str(tmp_path / "spool"),
        staging_root=str(tmp_path / "staging"))
    tsset.load_all()
    jserver = jserve.ModelServer(model_dirs["b"], mesh_spec="dp=1", dtype="float32",
                                 name="b", quantize="int8")
    jserver.load()
    b = tsset.servers["b"]
    link, device = b.stats["load_bytes"], b.stats["device_bytes"]
    assert link == estimate_dir_bytes(model_dirs["b"]) - _header_bytes(model_dirs["b"])
    assert jserver.stats["load_bytes"] == device < link
    before = {k: (v.q.clone(), v.scale.clone()) if isinstance(v, QTensor) else v.clone()
              for k, v in b.params.items()}
    tokens = b.generate(np.asarray(PROMPT, np.int32), max_new_tokens=6)
    tsset.pool.request_unload("b", wait=True)
    for spill in (False, True):
        if spill:
            tsset.pool.request_unload("b", wait=True)
            assert tsset.pool.tiers.spill_host() == 1
        tsset.pool.request_load("b", model_dir=model_dirs["b"], wait=True)
        b = tsset.servers["b"]
        assert b.stats["tier"] == ("disk" if spill else "host")
        assert b.stats["load_bytes"] == device
        for k, v in b.params.items():
            if isinstance(v, QTensor):
                assert torch.equal(v.q, before[k][0]) and torch.equal(v.scale, before[k][1])
            else:
                assert torch.equal(v, before[k])
        np.testing.assert_array_equal(
            b.generate(np.asarray(PROMPT, np.int32), max_new_tokens=6), tokens)


def _header_bytes(model_dir):
    from modelx_tpu_torch.dl.safetensors import read_header_from_file

    return read_header_from_file(os.path.join(model_dir, "model.safetensors"))[1]



# -- the chaos sweep (make chaos-torch: under the port's lockdep) ----------------------
# tests/test_tiers.py:414's eviction races, on a port pod alone.


def tier_sset(model_dirs, tmp_path, names=("a", "b")):
    from modelx_tpu_torch.testing import faults as tfaults

    sset = tserve.ServerSet(
        {n: tserve.ModelServer(model_dirs[n], dtype="float32", device="cpu", name=n,
                               max_seq_len=64) for n in names},
        allow_admin_load=True, staging_root=str(tmp_path / "staging"),
        host_state_budget_bytes=1 << 30, disk_state_budget_bytes=1 << 30,
        state_spool_dir=str(tmp_path / "spool"))
    sset.load_all()
    assert isinstance(sset.pool.tiers.fault_plan, (type(None), tfaults.FaultPlan))
    return sset


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_demote_while_loading(model_dirs, tmp_path):
    """Unload-b (its demotion copy off the pool lock) racing a load of c:
    c READY, b fully tiered."""
    sset = tier_sset(model_dirs, tmp_path)
    errs: list = []
    try:
        def unload_b():
            try:
                sset.pool.request_unload("b", wait=True)
            except Exception as e:  # the race must not raise; report it
                errs.append(e)

        t = threading.Thread(target=unload_b, daemon=True)
        t.start()
        sset.pool.request_load("c", model_dir=model_dirs["c"], wait=True)
        t.join(timeout=60)
        assert not errs
        states = sset.pool.states()
        assert states["c"]["state"] == "READY"
        assert states["b"]["state"] == "UNLOADED" and states["b"]["tier"] == "host"
    finally:
        sset.close()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_promote_while_draining(model_dirs, tmp_path):
    """A re-load of demoted b (tier promotion) racing the drain of a with a
    request in flight: the drain does not wedge the promotion, both land
    consistent."""
    import time

    sset = tier_sset(model_dirs, tmp_path, names=("a", "b", "c"))
    try:
        sset.pool.request_unload("b", wait=True)
        assert sset.pool.states()["b"]["tier"] == "host"
        sset.pool.enter("a")
        done = threading.Event()

        def drain_a():
            sset.pool.request_unload("a", wait=True)
            done.set()

        t = threading.Thread(target=drain_a, daemon=True)
        t.start()
        time.sleep(0.05)  # the drain now waits on a's in-flight request
        sset.pool.request_load("b", model_dir=model_dirs["b"], wait=True)
        sset.pool.exit("a")  # release the drain
        assert done.wait(timeout=60)
        t.join(timeout=10)
        states = sset.pool.states()
        assert states["b"]["state"] == "READY" and sset.servers["b"].stats.get("tier") == "host"
        assert states["a"]["state"] == "UNLOADED" and states["a"]["tier"] == "host"
    finally:
        sset.close()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_crash_mid_demotion_leaves_pool_consistent(model_dirs, tmp_path):
    """A seeded crash inside the demotion: the unload still completes (the
    old discard), b lands UNLOADED with no tier, and a re-load takes the
    cold path."""
    from modelx_tpu_torch.testing.faults import FaultPlan as TFaultPlan
    from modelx_tpu_torch.testing.faults import InjectedCrash as TInjectedCrash

    sset = tier_sset(model_dirs, tmp_path)
    try:
        sset.pool.tiers.fault_plan = TFaultPlan(seed=11).add(
            tiers.OP_DEMOTE, errors_at=[0], error=TInjectedCrash("died mid-demotion"))
        sset.pool.request_unload("b", wait=True)
        states = sset.pool.states()
        assert states["b"]["state"] == "UNLOADED" and states["b"]["tier"] == "none"
        snap = sset.pool.request_load("b", model_dir=model_dirs["b"], wait=True)
        assert snap["b"]["state"] == "READY"
        assert sset.servers["b"].stats.get("tier") is None
        expected = _baseline_tokens(model_dirs["b"], n=4)
        np.testing.assert_array_equal(
            sset.servers["b"].generate(np.asarray(PROMPT, np.int32), max_new_tokens=4), expected)
    finally:
        sset.close()
