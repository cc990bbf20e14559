"""The model pool's card-only paths (the ``cuda`` marker; they skip without
a card). No jax: the card's host has none, so these run there with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kernels_cuda.py tests/test_torch_pool_cuda.py``.

- ``utils/devmem``: the caching allocator's cached blocks count as
  reservable, and in use + reservable is the device's total;
- ``dl/tiers``: a card model's leaves demote into views of one pinned host
  buffer and come back bit-equal through the host and the disk tier.
"""

import pytest
import torch

from modelx_tpu_torch.dl import tiers
from modelx_tpu_torch.ops.quant import QTensor, quantize_tensor
from modelx_tpu_torch.utils import devmem


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_devmem_counts_the_allocator_cache_as_reservable(card):
    x = torch.empty(256 << 20, dtype=torch.uint8, device=card)
    held = devmem.raw_sample()
    del x
    freed = devmem.raw_sample()
    torch.cuda.empty_cache()
    assert held["source"] == freed["source"] == "memory_stats"
    assert held["hbm_bytes_in_use"] + held["hbm_bytes_reservable"] == held["hbm_bytes_limit"]
    assert held["hbm_bytes_limit"] == torch.cuda.mem_get_info(0)[1]
    assert freed["hbm_bytes_reservable"] - held["hbm_bytes_reservable"] >= (256 << 20)
    assert freed["hbm_bytes_in_use"] <= held["hbm_bytes_in_use"] - (256 << 20)


@pytest.mark.cuda
def test_card_leaves_demote_into_one_pinned_buffer(card, tmp_path):
    base = torch.randn(96, 64, device=card)
    params = {"w": base.to(torch.bfloat16), "q": quantize_tensor(base), "s": base[0, 0],
              "e": torch.zeros((0, 3), device=card)}
    store = tiers.TierStore(host_budget_bytes=1 << 30, disk_budget_bytes=1 << 30,
                            spool_root=str(tmp_path / "spool"))
    assert store.offer("k", "m", params)
    promo = store.promote("k")
    assert all(leaf.is_pinned() for leaf in promo.leaves if leaf.numel())
    assert len({leaf.untyped_storage().data_ptr() for leaf in promo.leaves}) == 1
    for spill in (False, True):
        if spill:
            assert store.spill_host() == 1
        promo = store.promote("k")
        assert promo.tier == ("disk" if spill else "host")
        got = tiers.unflatten_params(promo.treedef, [x.to(card) for x in promo.leaves])
        assert isinstance(got["q"], QTensor)
        assert torch.equal(got["q"].q, params["q"].q)
        assert torch.equal(got["q"].scale, params["q"].scale)
        for k in ("w", "s", "e"):
            assert got[k].dtype == params[k].dtype and torch.equal(got[k], params[k])
