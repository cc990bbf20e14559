"""The port's paged decode attention (modelx_tpu_torch.ops.paged_attention)
against the JAX package's (modelx_tpu/ops/paged_attention.py), on the CPU.

The same pools, tables and queries, made from a seed with numpy, go
through both: ``page_coords`` and ``write_token_kv`` exactly, and
``paged_attention`` within 1e-5 in fp32, with GQA, a scale, a tanh
softcap, a sliding window, idle rows on the trash page and ragged row
lengths. The ragged loop bound is exact: a fully masked block's update is
the identity, so running the table's whole width gives the same bytes as
stopping at the longest row's page, and the port's host-known bound
equals its own read-back one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modelx_tpu.ops import paged_attention as jpa
from modelx_tpu_torch.models import llama as tl
from modelx_tpu_torch.ops import attention as tattn
from modelx_tpu_torch.ops import paged_attention as tpa

TOL = 1e-5


def _case(seed, s=4, hq=4, hkv=2, d=16, ps=8, pages_per_slot=6, lengths=(1, 13, 30, 48)):
    """Pools with every page filled, a table giving each live slot its own
    pages in shuffled order (unreserved entries and idle slots -> trash
    page 0)."""
    rng = np.random.RandomState(seed)
    n_pages = 1 + s * pages_per_slot
    pool_k = rng.randn(n_pages, ps, hkv, d).astype(np.float32)
    pool_v = rng.randn(n_pages, ps, hkv, d).astype(np.float32)
    q = rng.randn(s, hq, d).astype(np.float32)
    table = np.zeros((s, pages_per_slot), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            table[i, j] = free.pop()
    return q, pool_k, pool_v, table, np.asarray(lengths, np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("kw", [
    {},
    {"scale": 0.3},
    {"logit_softcap": 2.5},
    {"window": 5},
    {"window": 9, "logit_softcap": 1.5, "scale": 0.2},
], ids=["plain", "scale", "softcap", "window", "all"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (6, 1)], ids=["gqa", "mha", "mqa"])
def test_paged_attention_matches_jax(kw, hq, hkv):
    q, pk, pv, table, lengths = _case(0, hq=hq, hkv=hkv)
    want = np.asarray(jpa.paged_attention(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                          jnp.asarray(table), jnp.asarray(lengths), **kw))
    got = tpa.paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(lengths), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_paged_attention_equals_dense_attention_over_the_gathered_pages():
    """The blockwise softmax is the dense softmax of each row's visible
    positions (a different reduction order, so within the tolerance)."""
    q, pk, pv, table, lengths = _case(1)
    ps = pk.shape[1]
    got = tpa.paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(lengths))
    dense_k = _t(pk)[_t(table).long()].reshape(q.shape[0], -1, *pk.shape[2:])
    dense_v = _t(pv)[_t(table).long()].reshape(q.shape[0], -1, *pv.shape[2:])
    assert dense_k.shape[1] == table.shape[1] * ps
    want = tattn.attention_reference(_t(q)[:, :, None].float(), dense_k.transpose(1, 2),
                                     dense_v.transpose(1, 2), causal=True,
                                     q_offset=_t(lengths - 1).long())
    np.testing.assert_allclose(got.numpy(), want[:, :, 0].numpy(), rtol=0, atol=TOL)


def test_ragged_bound_is_exact_and_fully_masked_blocks_are_the_identity():
    q, pk, pv, table, lengths = _case(2, lengths=(3, 9, 17, 20))
    pps = table.shape[1]
    bound = tpa.ragged_blocks(int(lengths.max()), pk.shape[1], pps)
    assert bound == 3 < pps
    args = (_t(q), _t(pk), _t(pv), _t(table), _t(lengths))
    host = tpa.paged_attention(*args, n_blocks=bound)
    readback = tpa.paged_attention(*args)
    whole_width = tpa.paged_attention(*args, n_blocks=pps)  # every trailing block masked
    assert torch.equal(host, readback)
    assert torch.equal(host, whole_width)
    # and the JAX twin's own ragged bound agrees within the tolerance
    want = np.asarray(jpa.paged_attention(*(jnp.asarray(a) for a in (q, pk, pv, table,
                                                                      lengths))))
    np.testing.assert_allclose(host.numpy(), want, rtol=0, atol=TOL)


def test_idle_rows_read_only_their_trash_page_write():
    """An idle slot (table row all zeros, length 1) attends to position 0 of
    the trash page alone: its output is that position's value row."""
    q, pk, pv, table, lengths = _case(3, lengths=(1, 1, 25, 1))
    table[[0, 1, 3]] = 0
    got = tpa.paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(lengths))
    rep = q.shape[1] // pk.shape[2]
    want_idle = np.repeat(pv[0, 0], rep, axis=0)  # [Hq, D]
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), want_idle, rtol=0, atol=TOL)


def test_page_coords_and_write_token_kv_match_jax():
    rng = np.random.RandomState(4)
    ps, s = 4, 3
    table = np.asarray([[5, 2, 7], [0, 0, 0], [1, 3, 6]], np.int32)
    offsets = np.asarray([6, 2, 11], np.int32)
    jidx, joff = jpa.page_coords(jnp.asarray(table), jnp.asarray(offsets), ps)
    tidx, toff = tpa.page_coords(_t(table), _t(offsets), ps)
    assert tidx.tolist() == np.asarray(jidx).tolist() == [2, 0, 6]
    assert toff.tolist() == np.asarray(joff).tolist() == [2, 2, 3]
    pool = rng.randn(8, ps, 2, 4).astype(np.float32)
    block = rng.randn(s, 1, 2, 4).astype(np.float32)
    want = np.asarray(jpa.write_token_kv(jnp.asarray(pool), jnp.asarray(block),
                                         jnp.asarray(table), jnp.asarray(offsets)))
    tpool = _t(pool.copy())
    out = tpa.write_token_kv(tpool, _t(block), _t(table), _t(offsets))
    assert out is tpool  # in place
    assert np.array_equal(tpool.numpy(), want)


def test_llama_paged_step_matches_the_dense_cached_step():
    """The model's paged branch: one decode step over page pools gives the
    dense cached step's logits (within the tolerance) and writes the
    step's k/v into each row's current page."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=64), dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    rng = np.random.RandomState(5)
    ps, s, max_len = 8, 3, 32
    offsets = np.asarray([5, 17, 0], np.int64)
    dense = tl.init_kv_cache(cfg, s, max_len, dtype=torch.float32)
    for c in dense.values():
        c.copy_(_t(rng.randn(*c.shape).astype(np.float32)))
    pps = max_len // ps
    table = np.arange(1, 1 + s * pps, dtype=np.int64).reshape(s, pps)
    pools = {n: torch.zeros((1 + s * pps, ps) + tuple(c.shape[2:])) for n, c in dense.items()}
    for n, c in dense.items():
        pools[n][_t(table).reshape(-1)] = c.reshape(s * pps, ps, *c.shape[2:])
    tok = _t(rng.randint(0, 64, (s, 1)))
    want, _ = tl.forward(params, tok, cfg, kv_cache=dense, cache_offset=_t(offsets))
    fwd = tl.paged_decode_fns(params, cfg)
    got, _ = fwd(params, tok, kv_cache=pools, cache_offset=_t(offsets), table=_t(table),
                 n_blocks=tpa.ragged_blocks(int(offsets.max()) + 1, ps, pps))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    for n, c in dense.items():
        for i, o in enumerate(offsets):
            page = pools[n][table[i, o // ps], o % ps]
            if n.endswith("0"):  # layer 0's k/v come before any attention
                assert torch.equal(page, c[i, o])
            np.testing.assert_allclose(page.numpy(), c[i, o].numpy(), rtol=0, atol=1e-4)
