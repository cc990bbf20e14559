"""Port MoE (modelx_tpu_torch.ops.moe) against the JAX package, on the CPU.

The JAX twin dispatches with dense one-hot einsums over a per-expert
capacity; the port gathers each expert's rows. The same numpy inputs go
through both. Tolerances: router probabilities atol 1e-7 (one fp32
softmax, another summation order); the FFN's fp32 outputs atol 1e-5, as
the models' logits (the same products, the combine summed in another
order); bf16 outputs atol 2e-2 against the twin in fp32 on the same bf16
values (outputs up to ~3, where one bf16 ulp is 0.016; observed 0.0136).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modelx_tpu.ops import moe as jmoe
from modelx_tpu_torch.ops import moe as tmoe

FP32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _inputs(seed=0, b=2, s=16, d=32, f=48, e=4, scale=1.0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    gate = (rng.normal(0, 1, (e, d)) * scale / np.sqrt(d)).astype(np.float32)
    w1 = (rng.normal(0, 1, (e, f, d)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.normal(0, 1, (e, d, f)) / np.sqrt(f)).astype(np.float32)
    w3 = (rng.normal(0, 1, (e, f, d)) / np.sqrt(d)).astype(np.float32)
    return x, gate, w1, w2, w3


@pytest.mark.parametrize("logits,k", [
    ([0.0, 0.0, 0.0, -1.0], 2),      # three tie for the top: all three kept
    ([2.0, 1.0, 1.0, 1.0], 2),       # the k-th ties two more: four kept
    ([1.0, 1.0, 1.0, 1.0], 1),       # all tie
    ([3.0, 2.0, 1.0, 0.0], 2),       # no tie: exactly k
    ([5.0, -5.0, 0.5, 0.5], 3),
])
def test_router_topk_keeps_jax_ties(logits, k):
    x = np.asarray([logits], np.float32)
    jp, jm = (np.asarray(a) for a in jmoe.router_topk(jnp.asarray(x), k))
    tp, tm = tmoe.router_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-7)
    assert tm.sum() >= k and abs(float(tp.sum()) - 1.0) < 1e-6


def test_router_topk_random_matches_jax():
    x = np.random.RandomState(1).normal(0, 2, (3, 7, 8)).astype(np.float32)
    jp, jm = (np.asarray(a) for a in jmoe.router_topk(jnp.asarray(x), 2))
    tp, tm = tmoe.router_topk(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-7)


@pytest.mark.parametrize("seq,e,k,factor", [(16, 4, 2, 0.5), (16, 4, 2, 1.0), (7, 8, 2, 1.25),
                                            (1, 8, 2, 1.0), (2048, 8, 2, 0.1), (5, 4, 1, 40.0)])
def test_expert_capacity_matches_jax(seq, e, k, factor):
    assert tmoe.expert_capacity(seq, e, k, factor) == jmoe.expert_capacity(seq, e, k, factor)


@pytest.mark.parametrize("factor", [0.0, -1.0])
def test_moe_ffn_drop_free_matches_jax(factor):
    x, gate, w1, w2, w3 = _inputs()
    want = np.asarray(jmoe.moe_ffn(*(jnp.asarray(a) for a in (x, gate, w1, w2, w3)), top_k=2,
                                   capacity_factor=factor))
    got = tmoe.moe_ffn(*(torch.from_numpy(a) for a in (x, gate, w1, w2, w3)), top_k=2,
                       capacity_factor=factor)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL)


@pytest.mark.parametrize("factor", [0.5, 0.75])
def test_moe_ffn_drops_tokens_in_sequence_order_as_jax(factor):
    """A positive factor under pressure: C = 4 (or 6) slots per expert and
    batch row for 16 tokens x 2 experts, so later tokens of a busy expert
    are dropped (their combine weight 0), the same tokens in both."""
    x, gate, w1, w2, w3 = _inputs(seed=2, scale=4.0)  # a skewed router: busy experts
    args_j = [jnp.asarray(a) for a in (x, gate, w1, w2, w3)]
    args_t = [torch.from_numpy(a) for a in (x, gate, w1, w2, w3)]
    want = np.asarray(jmoe.moe_ffn(*args_j, top_k=2, capacity_factor=factor))
    got = tmoe.moe_ffn(*args_t, top_k=2, capacity_factor=factor).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)
    free = tmoe.moe_ffn(*args_t, top_k=2, capacity_factor=0.0).numpy()
    dropped = ~np.isclose(got, free, atol=1e-6).all(-1)
    assert dropped.any() and not dropped.all()
    assert not dropped[:, 0].any()  # the first tokens always find a slot


def test_moe_ffn_bf16_matches_jax_fp32_on_the_same_values():
    """bf16 in, bf16 out. JAX's CPU backend has no bf16 x bf16 -> fp32 dot,
    so the twin runs in fp32 on the bf16-rounded inputs: the port differs
    by its roundings to bf16 at the twin's cast points."""
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(seed=3)]
    want = np.asarray(jmoe.moe_ffn(*(jnp.asarray(a.float().numpy()) for a in args), top_k=2))
    got = tmoe.moe_ffn(*args, top_k=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


def test_moe_ffn_with_an_idle_expert():
    """An expert no token picks is skipped; one token (a decode step) works."""
    x, gate, w1, w2, w3 = _inputs(seed=4, b=1, s=1, e=8)
    want = np.asarray(jmoe.moe_ffn(*(jnp.asarray(a) for a in (x, gate, w1, w2, w3)), top_k=2))
    got = tmoe.moe_ffn(*(torch.from_numpy(a) for a in (x, gate, w1, w2, w3)), top_k=2)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL)
