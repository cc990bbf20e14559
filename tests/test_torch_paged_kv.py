"""The port's paged KV engine (``ContinuousBatcher(page_size=...)``) on the
CPU: the same requests submitted in the same order to a dense engine, a
paged "gather" engine and a paged "in-place" engine of the same slot count.

Gather mode builds each layer's dense view of the pages and runs the same
forward as the dense engine, so its tokens equal the dense engine's byte
for byte, greedy and sampled. In-place mode reads the pools through the
blockwise softmax (``ops/paged_attention.py``), a different reduction
order: its greedy tokens equal the dense engine's on this fp32 model. Page
accounting: pages return at retirement, a full pool makes admissions wait
in FIFO order, a request the pool can never hold is refused up front.
"""

import concurrent.futures
import threading
import time

import numpy as np
import pytest

from modelx_tpu_torch.dl.continuous import ContinuousBatcher
from modelx_tpu_torch.dl.serve import ModelServer
from tests.test_torch_continuous import SAMPLED, write_tiny_fp32


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-paged"))
    write_tiny_fp32(d)
    srv = ModelServer(d, dtype="float32", device="cpu", max_seq_len=96)
    srv.load()
    return srv


def _requests():
    rng = np.random.RandomState(7)
    greedy = [(rng.randint(1, 512, (1, n)).astype(np.int32), {}) for n in (3, 17, 40, 9)]
    sampled = [(rng.randint(1, 512, (1, n)).astype(np.int32), dict(SAMPLED, seed=s))
               for n, s in ((12, 5), (33, 6))]
    return greedy, sampled


def _run_in_order(cb, reqs, n_new=14):
    """Submit every request as one burst, in order, and drain them."""
    tickets = cb.submit_many([(t[0].tolist(), n_new, samp) for t, samp in reqs])
    return [np.concatenate(list(cb._drain_row(tk.out)), axis=1) for tk in tickets]


def test_gather_equals_dense_byte_for_byte(server):
    greedy, sampled = _requests()
    outs, kv_bytes = {}, {}
    for label, kw in (("dense", {}), ("gather", {"page_size": 16, "max_live_tokens": 512})):
        cb = ContinuousBatcher(server, max_slots=8, chunk_size=4, **kw)
        try:
            outs[label] = _run_in_order(cb, greedy + sampled)
            kv_bytes[label] = cb.kv_bytes()
            if kw:
                assert cb.stats["paged_attention"] == "gather"
        finally:
            cb.close()
    assert kv_bytes["gather"] < kv_bytes["dense"]  # 33 pages of 16 against 8 x 96
    for d, g in zip(outs["dense"], outs["gather"]):
        assert d.tobytes() == g.tobytes()
    for (t, samp), d in zip(greedy + sampled, outs["dense"]):
        np.testing.assert_array_equal(d, server.generate(t, max_new_tokens=14, **samp)[:, t.shape[1]:])


def test_in_place_greedy_equals_dense(server):
    greedy, _ = _requests()
    outs = {}
    for label, kw in (("dense", {}),
                      ("in-place", {"page_size": 8, "paged_attention": "in-place"})):
        cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, **kw)
        try:
            outs[label] = _run_in_order(cb, greedy, n_new=30)  # rows cross many pages
            if kw:
                assert cb.stats["paged_attention"] == "in-place"
                assert 0 < cb.snapshot()["pages_swept_fraction"] < 1  # the ragged bound
        finally:
            cb.close()
    for d, g in zip(outs["dense"], outs["in-place"]):
        np.testing.assert_array_equal(g, d)


def test_in_place_step_runs_the_paged_forward(server):
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, page_size=16,
                           paged_attention="in-place")
    calls = []
    real = cb._fwd_paged
    cb._fwd_paged = lambda *a, **kw: (calls.append(kw["n_blocks"]), real(*a, **kw))[1]
    try:
        t = np.asarray([[4, 8, 15, 16, 23, 42]], np.int32)
        np.testing.assert_array_equal(cb.generate(t, max_new_tokens=20),
                                      server.generate(t, max_new_tokens=20))
        # the host-known ragged bound grows with the row: 1 page, then 2
        assert calls and min(calls) == 1 and max(calls) == 2
    finally:
        cb.close()


def test_pages_return_at_retirement(server):
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, page_size=16,
                           max_live_tokens=4 * 96 // 2)
    try:
        free0 = len(cb._free_pages)
        assert cb.stats["pages_free"] == free0 == cb.num_pages - 1
        for i in range(6):  # sequential requests reuse the same pages
            t = np.array([[i + 1, i + 2, i + 3]], np.int32)
            np.testing.assert_array_equal(cb.generate(t, max_new_tokens=5),
                                          server.generate(t, max_new_tokens=5))
        deadline = time.monotonic() + 10
        while cb._rows and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(cb._free_pages) == free0 and not cb._row_pages
        assert not cb._table.any()  # every entry back on the trash page
    finally:
        cb.close()


def test_a_full_pool_makes_admissions_wait_fifo(server):
    """A pool sized for one request at a time: concurrent requests
    serialize on pages in arrival order and stay exact."""
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, page_size=16,
                           max_live_tokens=48, burst_window_ms=0)  # 3 pages + trash
    try:
        reqs = [np.array([[i + 1, i + 5]], np.int32) for i in range(4)]
        expected = [server.generate(t, max_new_tokens=20) for t in reqs]
        order = []
        lock = threading.Lock()

        def go(i):
            time.sleep(0.02 * i)  # arrival order 0, 1, 2, 3
            out = cb.generate(reqs[i], max_new_tokens=20)
            with lock:
                order.append(i)
            return out

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(go, range(4)))
        for e, g in zip(expected, got):
            np.testing.assert_array_equal(g, e)
        assert order == [0, 1, 2, 3]
        admits = [e for e in cb.flightrec.events() if e["event"] == "admit"]
        assert len(admits) == 4 and cb.stats["active_peak"] == 1
    finally:
        cb.close()


def test_oversized_and_misaligned_requests_refused(server):
    cb = ContinuousBatcher(server, max_slots=2, chunk_size=4, page_size=16,
                           max_live_tokens=32)
    try:
        with pytest.raises(ValueError, match="pages than the engine's pool holds"):
            cb.submit(list(range(1, 30)), 20, {})
    finally:
        cb.close()
    with pytest.raises(ValueError, match="multiple of page_size"):
        ContinuousBatcher(server, max_slots=2, page_size=10)
