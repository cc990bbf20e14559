"""The port's threefry (modelx_tpu_torch.ops.prng) against jax.random, on the CPU.

The reference is jax 0.9.0 with jax_default_prng_impl=threefry2x32 and
jax_threefry_partitionable=True. Tolerance: none. Key data and bits are
compared as uint32 values, uniform and Gumbel floats by their float32 bit
patterns, so a seeded sampled request draws the same tokens from either
package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu_torch.ops import prng

LENGTHS = (1, 63, 64, 65, 513, 128256)  # vocab-like: around 64 = K_CAP, Llama-3's
KEY_SEEDS = (0, 7, 2**31 - 1, 2**32 - 1)


def test_reference_runs_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_prng_key_and_fold_in_key_data(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))
    datas = (0, 1, 5, 2**31 - 1, 2**32 - 1)
    for d in datas:
        want = np.asarray(jax.random.fold_in(key, d)).astype(np.int64)
        np.testing.assert_array_equal(prng.fold_in(tkey, d).numpy(), want)
    # vectorised over data, and twice (the sampler's seed then step)
    want = np.stack([np.asarray(jax.random.fold_in(jax.random.fold_in(key, d), 3))
                     for d in datas]).astype(np.int64)
    got = prng.fold_in(prng.fold_in(tkey, torch.tensor(datas)), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", LENGTHS)
def test_bits_uniform_gumbel_bit_for_bit(n):
    for seed in KEY_SEEDS[:3]:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        tkey = prng.fold_in(prng.PRNGKey(seed), 11)
        want = np.asarray(jax.random.bits(key, (n,), jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(prng.bits(tkey, n).numpy(), want)
        for lo, hi in ((0.0, 1.0), (-3.7, 11.2)):
            want = np.asarray(jax.random.uniform(key, (n,), jnp.float32, lo, hi))
            got = prng.uniform(tkey, n, lo, hi).numpy()
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        want = np.asarray(jax.random.gumbel(key, (n,), jnp.float32, mode="low"))
        got = prng.gumbel(tkey, n).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_bits_batched_over_keys_equal_per_key_draws():
    keys = torch.stack([prng.fold_in(prng.PRNGKey(0), s) for s in range(4)])
    batched = prng.bits(keys, 65)
    for i in range(4):
        want = np.asarray(jax.random.bits(
            jax.random.fold_in(jax.random.PRNGKey(0), i), (65,), jnp.uint32))
        np.testing.assert_array_equal(batched[i].numpy(), want.astype(np.int64))


def test_log_is_xla_cpu_log_bit_for_bit():
    # torch.log differs from XLA's CPU log in the last bit for ~1 input in 7
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.uniform(0, 1, 200_000), rng.uniform(0, 1e6, 20_000), rng.rand(1000) * 1e-30,
        [0.0, 1.0, np.inf, -1.0, np.nan, 1e-45, 3e-39, np.finfo(np.float32).tiny],
    ]).astype(np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = prng.log(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def test_categorical_matches_vmapped_jax_categorical():
    rng = np.random.RandomState(1)
    logits = rng.randn(5, 300).astype(np.float32) * 2
    seeds = np.arange(5, dtype=np.int32) + 40
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(0), s))(jnp.asarray(seeds))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits)))
    tkeys = prng.fold_in(prng.PRNGKey(0), torch.from_numpy(seeds))
    got = prng.categorical(tkeys, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prng_key_refuses_out_of_range_seeds():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.PRNGKey(2**32)
