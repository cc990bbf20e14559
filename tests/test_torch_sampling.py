"""The port's sampler (modelx_tpu_torch.ops.sampling) on the CPU.

Inside the port the fused top-k prefix path must be BYTE-identical to the
always-sort reference (the cases of tests/test_sampling_fused.py). Against
the JAX package: the kept set of every row equals JAX's, and ``sample``
draws JAX's tokens for the same logits, seeds and steps. A token may differ
only where the reference's top two Gumbel-perturbed logits lie within
``NEAR_TIE`` of each other, or where a row's nucleus cut lies within
``NEAR_TIE`` of its cumulative probability (the two packages' exp and sum
differ in the last bits); the tests count such rows and require none
elsewhere.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.ops import sampling as JS
from modelx_tpu_torch.ops import prng
from modelx_tpu_torch.ops import sampling as S

NEAR_TIE = 1e-5
B, V, CAP = 6, 256, 8


def _logits(seed, b=B, v=V, scale=3.0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(b, v).astype(np.float32) * scale).to(dtype)


def _pair(logits, t, k, p, k_cap=CAP):
    fused = S.scale_and_filter(logits, t, k, p, k_cap=k_cap)
    ref = S.scale_and_filter_reference(logits, t, k, p, k_cap=k_cap)
    return fused, ref


def _check(logits, t, k, p, k_cap=CAP):
    fused, ref = _pair(logits, t, k, p, k_cap)
    assert fused.dtype == ref.dtype
    assert torch.equal(fused.view(torch.uint8), ref.view(torch.uint8)), "bytes differ"
    return fused


def _kept(out):
    return (out > S.mask_value(out.dtype) / 2).sum(dim=-1)


def _vec(x, dtype):
    return torch.tensor(x, dtype=dtype)


def test_top_k_zero_is_off():
    out = _check(_logits(0), torch.full((B,), 0.8), torch.zeros(B, dtype=torch.int64),
                 torch.full((B,), 0.9))
    assert _kept(out)[0] > 1  # k=0 must not act as k=1


def test_top_p_one_is_off():
    out = _check(_logits(1), torch.ones(B), torch.full((B,), 5), torch.ones(B))
    assert _kept(out)[0] == 5


def test_ties_at_kth_logit():
    lg = _logits(2).numpy().copy()
    order = np.argsort(-lg, axis=-1)
    for b in range(B):
        lg[b, order[b, 3:7]] = lg[b, order[b, 3]]  # 4-way tie across k=4
    out = _check(torch.from_numpy(lg), torch.ones(B), torch.full((B,), 4), torch.ones(B))
    assert _kept(out)[0] == 7  # 3 above + the whole tie


def test_all_rows_greedy_temperature_zero():
    lg = _logits(3)
    t = torch.zeros(B)
    _check(lg, t, torch.full((B,), 3), torch.full((B,), 0.9))
    tok = S.sample(lg, prng.PRNGKey(0), t, torch.full((B,), 3), torch.full((B,), 0.9))
    assert torch.equal(tok.long(), torch.argmax(lg, dim=-1))


def test_k_over_cap_takes_the_sort_branch():
    k = torch.full((B,), 3)
    k[2] = 100
    out = _check(_logits(4), torch.ones(B), k, torch.ones(B))
    assert _kept(out)[2] == 100


def test_nucleus_overflow_takes_the_sort_branch():
    lg = torch.from_numpy(np.random.RandomState(5).randn(B, V).astype(np.float32) * 1e-3)
    out = _check(lg, torch.ones(B), None, torch.full((B,), 0.99))
    assert _kept(out)[0] > CAP


def test_per_row_mixed_params():
    _check(_logits(6), _vec([0.0, 0.7, 1.0, 1.3, 0.9, 2.0], torch.float32),
           _vec([0, 1, 5, 8, 200, 3], torch.int64),
           _vec([0.9, 1.0, 0.5, 1.5, 0.95, 0.1], torch.float32))


def test_none_filters():
    lg, t = _logits(7), torch.ones(B)
    _check(lg, t, torch.full((B,), 4), None)
    _check(lg, t, None, torch.full((B,), 0.7))
    assert torch.equal(S.scale_and_filter(lg, t), S.scale_and_filter_reference(lg, t))
    assert torch.equal(S.scale_and_filter(lg, t), lg)


def test_vocab_inside_the_cap_sorts():
    _check(_logits(8, v=CAP), torch.ones(B), torch.full((B,), 3), torch.full((B,), 0.8))


@pytest.mark.parametrize("seed", range(10))
def test_randomised_sweep(seed):
    rng = np.random.RandomState(100 + seed)
    lg = torch.from_numpy(rng.randn(4, 128).astype(np.float32) * 2.5)
    _check(lg, torch.from_numpy(rng.uniform(0.5, 1.5, 4).astype(np.float32)),
           torch.from_numpy(rng.randint(0, CAP + 1, 4)),
           torch.from_numpy(rng.uniform(0.3, 1.2, 4).astype(np.float32)))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_no_nan_in_half_precision(dtype):
    with np.errstate(over="ignore"):
        assert np.isinf(np.float16(S.NEG_INF))  # why the mask is finfo.min
    lg = _logits(9, 4, 128, dtype=dtype)
    out = S.scale_and_filter(lg, torch.full((4,), 0.8, dtype=dtype), torch.full((4,), 5),
                             torch.full((4,), 0.9, dtype=dtype), k_cap=CAP)
    assert torch.isfinite(out.float()).all()
    assert not torch.isnan(torch.softmax(out.float(), dim=-1)).any()
    tok = S.sample(lg, prng.PRNGKey(0), torch.full((4,), 0.8), torch.full((4,), 5),
                   torch.full((4,), 0.9), seeds=torch.arange(4))
    assert ((tok >= 0) & (tok < 128)).all()


# -- against the JAX package ------------------------------------------------------


def _jax_keep(lg, t, k, p, k_cap):
    out = JS.scale_and_filter(jnp.asarray(lg.numpy()), jnp.asarray(t.numpy()),
                              None if k is None else jnp.asarray(k.numpy(), jnp.int32),
                              None if p is None else jnp.asarray(p.numpy()), k_cap=k_cap)
    return np.asarray(out) > np.finfo(np.float32).min / 2


@pytest.mark.parametrize("k_cap", [CAP, S.K_CAP])
def test_kept_set_equals_jax(k_cap):
    lg = _logits(10, v=300)
    t = _vec([0.0, 0.7, 1.0, 1.3, 0.9, 2.0], torch.float32)
    k = _vec([0, 1, 5, 8, 200, 40], torch.int64)
    p = _vec([0.9, 1.0, 0.5, 0.99, 0.95, 0.3], torch.float32)
    got = S.scale_and_filter(lg, t, k, p, k_cap=k_cap).numpy() > np.finfo(np.float32).min / 2
    np.testing.assert_array_equal(got, _jax_keep(lg, t, k, p, k_cap))


def _near_tie_rows(lg, t, k, p, seeds, steps):
    """Rows whose JAX draw is within NEAR_TIE of flipping: the top two
    perturbed logits, or the nucleus cut, that close."""
    ref = np.asarray(JS.scale_and_filter_reference(
        jnp.asarray(lg), jnp.asarray(t), jnp.asarray(k), jnp.asarray(p), k_cap=None))
    rows = set()
    for b in range(lg.shape[0]):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), int(seeds[b])),
                                 int(steps[b]))
        g = np.asarray(jax.random.gumbel(key, (lg.shape[1],), jnp.float32)) + ref[b]
        top2 = np.sort(g)[-2:]
        if top2[1] - top2[0] < NEAR_TIE:
            rows.add(b)
        sc = np.sort(lg[b] / (t[b] if t[b] > 0 else 1.0))[::-1].astype(np.float64)
        cum = np.cumsum(np.exp(sc - sc[0]) / np.exp(sc - sc[0]).sum())
        if p[b] < 1 and np.min(np.abs(cum - p[b])) < NEAR_TIE:
            rows.add(b)
    return rows


@pytest.mark.parametrize("step", [0, 3, "per-row"])
def test_sample_tokens_equal_jax(step):
    rng = np.random.RandomState(11)
    n = 32
    lg = (rng.randn(n, 300) * 2).astype(np.float32)
    t = rng.uniform(0.3, 1.5, n).astype(np.float32)
    t[::5] = 0.0  # greedy rows in the batch
    k = rng.randint(0, 80, n).astype(np.int32)
    p = rng.uniform(0.5, 1.0, n).astype(np.float32)
    seeds = rng.randint(0, 2**31 - 1, n).astype(np.int32)
    steps = np.arange(n, dtype=np.int32) if step == "per-row" else np.full(n, step, np.int32)
    want = np.asarray(JS.sample(jnp.asarray(lg), jax.random.PRNGKey(0), jnp.asarray(t),
                                jnp.asarray(k), jnp.asarray(p), seeds=jnp.asarray(seeds),
                                step=jnp.asarray(steps) if step == "per-row" else step))
    got = S.sample(torch.from_numpy(lg), prng.PRNGKey(0), torch.from_numpy(t),
                   torch.from_numpy(k), torch.from_numpy(p), seeds=torch.from_numpy(seeds),
                   step=torch.from_numpy(steps) if step == "per-row" else step).numpy()
    assert got.dtype == np.int32
    differ = set(np.nonzero(got != want)[0].tolist())
    assert differ <= _near_tie_rows(lg, t, k, p, seeds, steps), (got, want)


def test_sample_equals_categorical_over_the_reference():
    lg = _logits(8)
    t, k, p = torch.full((B,), 0.9), torch.full((B,), 12), torch.full((B,), 0.95)
    seeds = torch.arange(B)
    tok = S.sample(lg, prng.PRNGKey(42), t, k, p, seeds=seeds, step=3)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(42), seeds), 3)
    want = prng.categorical(keys, S.scale_and_filter_reference(lg, t, k, p, k_cap=None))
    assert torch.equal(tok.long(), want)
