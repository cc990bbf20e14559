"""The port's device memory telemetry (modelx_tpu_torch.utils.devmem) and
the pool's measured veto, on the CPU, against the JAX package's.

Here no CUDA context exists: the sample carries ``source="none"`` and
zeros and never vetoes a load (as the reference's live-buffer census never
does). The veto itself is driven by a ``memory_stats`` sample stubbed into
both packages' pools: the same 507 bodies (retryable when an idle model's
drain could make room, hard otherwise) and the same LRU eviction under
``evict_idle``. The card's own numbers (``mem_get_info`` and the caching
allocator) are read by the ``cuda``-marked tests of
tests/test_torch_pool_cuda.py, which skip here.
"""

import pytest
import torch

from modelx_tpu.dl import lifecycle as jlc
from modelx_tpu.utils import devmem as jdevmem
from modelx_tpu_torch.dl import lifecycle as tlc
from modelx_tpu_torch.utils import devmem
from tests.test_torch_lifecycle import (  # noqa: F401 (fresh_trackers is a fixture)
    PROMPT,
    Pair,
    fresh_trackers,
    write_tiny,
)

KEYS = {"hbm_bytes_in_use", "hbm_bytes_limit", "hbm_bytes_reservable", "device_count",
        "source"}


def test_cpu_sample_is_none_and_zero():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        pytest.skip("a CUDA context exists: the card's numbers are read instead")
    dm = devmem.raw_sample()
    assert set(dm) == KEYS and dm["source"] == "none"
    assert all(dm[k] == 0 for k in KEYS - {"source"})
    # the keys the pool reads exist in the reference's sample too
    assert {"hbm_bytes_in_use", "hbm_bytes_reservable", "source"} <= set(jdevmem.raw_sample())


def test_cached_sample_is_a_copy(monkeypatch):
    fake = {"hbm_bytes_in_use": 5, "hbm_bytes_limit": 9, "hbm_bytes_reservable": 4,
            "device_count": 1, "source": "memory_stats",
            "devices": {"0": {"hbm_bytes_in_use": 5}}}
    calls = []
    monkeypatch.setattr(devmem, "raw_sample", lambda: calls.append(1) or dict(fake))
    monkeypatch.setattr(devmem, "_cached", None)
    a = devmem.sample(max_age_s=60)
    a["hbm_bytes_in_use"] = -777
    a["devices"]["0"]["hbm_bytes_in_use"] = -777
    b = devmem.sample(max_age_s=60)
    assert b["hbm_bytes_in_use"] == 5 and b["devices"]["0"]["hbm_bytes_in_use"] == 5
    assert len(calls) == 1  # the second read came from the cache
    devmem.sample(max_age_s=0)
    assert len(calls) == 2


def test_no_cuda_context_never_vetoes(tmp_path):
    pool = tlc.ModelPool(type("S", (), {"servers": {}})())
    if devmem.raw_sample()["source"] == "none":
        assert not pool._measured_shortfall(1 << 60)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("devmem-models")
    dirs = {}
    for name, seed in (("a", 0), ("b", 1), ("c", 2)):
        write_tiny(str(root / name), seed)
        dirs[name] = str(root / name)
    return dirs


def _stub(monkeypatch, reservable):
    """A card's accountant-backed sample in both packages' pools."""
    fake = {"hbm_bytes_in_use": 1000, "hbm_bytes_limit": 1000 + reservable,
            "hbm_bytes_reservable": reservable, "device_count": 1, "source": "memory_stats"}
    monkeypatch.setattr(jlc.devmem, "sample", lambda max_age_s=1.0: dict(fake))
    monkeypatch.setattr(tlc.devmem, "sample", lambda max_age_s=1.0: dict(fake))


@pytest.mark.parametrize("boot,evict,want", [
    (("a",), False, "retryable"),      # a's drain could make room
    (("a", "b"), False, "retryable"),
    (("a", "b"), True, "evicts"),      # evict_idle: b goes, the veto still holds
    (("empty",), False, "hard"),       # the boot tenant FAILED: nothing to demote
], ids=["one", "two", "evict", "hard"])
def test_measured_veto_answers_507_as_jax(model_dirs, tmp_path, monkeypatch, boot, evict,
                                          want, fresh_trackers):
    """No budget: the card's measured reservable bytes refuse a load the
    ledger would admit, with the reference's 507 body and headers: a
    ``Retry-After`` when demoting a loaded model could make room, none when
    nothing could."""
    dirs = dict(model_dirs, empty=str(tmp_path / "empty-dir"))
    (tmp_path / "empty-dir").mkdir()
    pair = Pair.build(dirs, names=boot, tmp=tmp_path, load=False, allow_admin_load=True,
                      evict_idle=evict)
    try:
        for sset in (pair.j, pair.t):
            try:
                sset.load_all()
            except RuntimeError:
                assert boot == ("empty",)  # every boot model failed
        _stub(monkeypatch, reservable=100)  # far less than a tiny checkpoint
        got = pair.agree("POST", "/admin/models",
                         {"name": "c", "model_dir": model_dirs["c"], "wait": True})
        assert got[0] == 507 and "device measures only 100 bytes reservable" in got[2]["error"]
        assert "source=memory_stats" in got[2]["error"]
        assert ("Retry-After" in got[1]) == (want != "hard")
        assert ("hard refusal" in got[2]["error"]) == (want == "hard")
        states = pair.agree("GET", "/admin/models")[2]["models"]
        assert "c" not in states
        if want == "evicts":
            # the veto evicted the idle tenant first (it could not help: the
            # stubbed sample does not move); the node is never emptied
            assert sorted(states[n]["state"] for n in "ab") == ["READY", "UNLOADED"]
        # with room on the card the same load is admitted
        _stub(monkeypatch, reservable=1 << 40)
        got = pair.agree("POST", "/admin/models",
                         {"name": "c", "model_dir": model_dirs["c"], "wait": True})
        assert got[2]["c"]["state"] == "READY"
    finally:
        pair.close()

