"""The port's streamed decode and prefix KV cache (modelx_tpu_torch.models.decode)
on the CPU, mirroring tests/test_prefix_cache.py.

Inside the port: ``ChunkedDecoder`` streams concatenate EXACTLY to the
sampled ``ragged_greedy_generate`` tokens for every chunk size, and a
prefix-cache hit gives exactly a cold run's tokens. Against the JAX
package, on a tiny fp32 llama (vocab 128 > K_CAP, so the fused sampler
path runs): greedy and seeded sampled streams equal JAX's ChunkedDecoder
token for token (fp32 on the CPU, and the port draws jax.random's bits; a
sampled token could differ only at a near-tie of two perturbed logits, and
these seeds have none).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.models import decode as jdecode
from modelx_tpu.models import llama as jl
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import llama as tl
from modelx_tpu_torch.models.decode import (
    ChunkedDecoder,
    PrefixKVCache,
    pad_seq_len,
    ragged_greedy_generate,
)

_CFG_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
               "num_kv_heads", "head_dim", "rope_theta", "rms_eps", "tie_embeddings",
               "qkv_bias")
SAMPLED = dict(temperature=0.9, top_k=40, top_p=0.95, seed=11)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tcfg = tl.LlamaConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS}, dtype=torch.float32)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    fwd, init = tl.decode_fns(tparams, tcfg)

    def jfwd(p, t, kv_cache, cache_offset=0, mesh=None):
        return jl.forward(p, t, jcfg, kv_cache=kv_cache, cache_offset=cache_offset)

    jdec = jdecode.ChunkedDecoder(jfwd, lambda b, n: jl.init_kv_cache(jcfg, b, n), 4)
    return dict(jparams=jparams, tparams=tparams, fwd=fwd, init=init, jdec=jdec)


def _controls(b, samp):
    if not samp:
        return {}
    return dict(temperature=np.full(b, samp["temperature"], np.float32),
                top_k=np.full(b, samp["top_k"], np.int32),
                top_p=np.full(b, samp["top_p"], np.float32),
                seeds=(samp["seed"] + np.arange(b)).astype(np.int32))


def _stream_all(dec, params, ids, n, samp=None, **kw):
    """One row, padded to the 16-bucket as the server pads it."""
    prompt = np.zeros((1, pad_seq_len(len(ids))), np.int64)
    prompt[0, : len(ids)] = ids
    pieces = list(dec.stream(params, torch.from_numpy(prompt), [len(ids)], n,
                             **_controls(1, samp), **kw))
    return np.concatenate(pieces, axis=1)[0].tolist(), pieces


# -- PrefixKVCache ------------------------------------------------------------------


def test_lookup_longest_strict_prefix():
    pc = PrefixKVCache(capacity=4)
    pc.put([1, 2], "ab")
    pc.put([1, 2, 3, 4], "abcd")
    assert pc.lookup([1, 2, 3, 4, 5]) == (4, "abcd")
    assert pc.lookup([1, 2, 9]) == (2, "ab")


def test_strict_prefix_only():
    pc = PrefixKVCache()
    pc.put([5, 6, 7], "x")
    assert pc.lookup([5, 6, 7]) is None  # the same prompt is not a STRICT prefix
    assert pc.lookup([9, 5, 6, 7]) is None
    assert pc.stats()["misses"] == 2 and pc.stats()["hits"] == 0


def test_lru_eviction():
    pc = PrefixKVCache(capacity=2)
    pc.put([1], "a")
    pc.put([2], "b")
    pc.lookup([1, 9])  # refresh [1]
    pc.put([3], "c")  # evicts [2]
    assert pc.lookup([2, 9]) is None
    assert pc.lookup([1, 9]) is not None and pc.lookup([3, 9]) is not None


def test_byte_cap_evicts_by_actual_kv_bytes():
    def entry(tokens):
        return {"k": torch.zeros((1, tokens, 2, 4))}  # 32 B a token

    pc = PrefixKVCache(capacity=8, max_bytes=3000)
    pc.put([1], entry(32))
    pc.put([2], entry(32))
    assert pc.stats()["bytes"] == 2048
    pc.lookup([1, 9])
    pc.put([3], entry(48))  # 3584 > cap: the LRU [2] goes
    assert pc.lookup([2, 9]) is None
    assert pc.lookup([1, 9]) is not None and pc.lookup([3, 9]) is not None
    assert pc.stats()["bytes"] == 1024 + 1536
    pc.put([4], entry(128))  # alone over the cap: still stored
    assert pc.lookup([4, 9]) is not None
    assert pc.stats()["entries"] == 1 and pc.stats()["bytes"] == 4096


def test_overwrite_same_key_does_not_leak_bytes():
    pc = PrefixKVCache(capacity=4, max_bytes=10**9)
    arr = {"k": torch.zeros((1, 16, 2, 4))}
    pc.put([1, 2], arr)
    pc.put([1, 2], arr)
    assert pc.stats()["bytes"] == arr["k"].nbytes and pc.stats()["entries"] == 1


def test_lookup_max_total_uses_stored_len():
    pc = PrefixKVCache(capacity=4)
    pc.put(list(range(32)), {"k": torch.zeros((1, 32, 2, 4))})
    ids = list(range(32)) + [99] * 17  # suffix bucket 32
    assert pc.lookup(ids, max_total=48) is None
    assert pc.lookup(ids, max_total=64) is not None


def test_stats_keys_match_jax_and_clear():
    from modelx_tpu.models.decode import PrefixKVCache as JaxPrefixKVCache

    pc = PrefixKVCache(capacity=2)
    pc.put([1], {"k": torch.zeros((1, 16, 2, 4))})
    pc.lookup([1, 2])
    assert sorted(pc.stats()) == sorted(JaxPrefixKVCache(2).stats())
    pc.clear()
    assert pc.stats()["entries"] == 0 and pc.stats()["bytes"] == 0


# -- streams -----------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("samp", [None, SAMPLED], ids=["greedy", "sampled"])
def test_stream_concatenates_to_ragged_generate(model, chunk, samp):
    rng = np.random.RandomState(4)
    prompt = torch.from_numpy(rng.randint(0, 128, (2, 16)))
    lens = np.array([16, 9], np.int32)
    n = 11  # not a multiple of any chunk size above but 1
    want = ragged_greedy_generate(model["fwd"], model["init"], model["tparams"], prompt,
                                  lens, n, **_controls(2, samp)).numpy()
    dec = ChunkedDecoder(model["fwd"], model["init"], chunk)
    pieces = list(dec.stream(model["tparams"], prompt, lens, n, **_controls(2, samp)))
    assert all(p.shape[1] <= chunk and p.dtype == np.int32 for p in pieces)
    np.testing.assert_array_equal(np.concatenate(pieces, axis=1), want)


@pytest.mark.parametrize("samp", [None, SAMPLED], ids=["greedy", "sampled"])
def test_stream_equals_jax_chunked_decoder(model, samp):
    ids = [3, 4, 5, 6, 7, 30, 99, 2, 64]
    got, _ = _stream_all(ChunkedDecoder(model["fwd"], model["init"], 4), model["tparams"],
                         ids, 10, samp)
    prompt = np.zeros((1, pad_seq_len(len(ids))), np.int32)
    prompt[0, : len(ids)] = ids
    kw = {k: jnp.asarray(v) for k, v in _controls(1, samp).items()}
    want = np.concatenate(list(model["jdec"].stream(
        model["jparams"], jnp.asarray(prompt), np.asarray([len(ids)], np.int32), 10, **kw)),
        axis=1)[0].tolist()
    assert got == want


def test_stop_token_cuts_a_single_row_stream_inclusively(model):
    dec = ChunkedDecoder(model["fwd"], model["init"], 3)
    full, _ = _stream_all(dec, model["tparams"], [5, 6, 7], 9, SAMPLED)
    stop = full[4]
    got, pieces = _stream_all(dec, model["tparams"], [5, 6, 7], 9, SAMPLED,
                              stop_token_ids=[stop])
    assert got == full[: full.index(stop) + 1]
    assert sum(p.shape[1] for p in pieces) == len(got)


# -- prefix-cache hits -------------------------------------------------------------------


def test_second_turn_matches_uncached_exactly(model):
    """Greedy AND sampled: the cached-prefix stream equals the cold one."""
    params, fwd, init = model["tparams"], model["fwd"], model["init"]
    turn1 = [3, 4, 5, 6, 7]
    turn2 = turn1 + [9, 9] + [8, 8, 8]
    cold = ChunkedDecoder(fwd, init, 4)
    warm = ChunkedDecoder(fwd, init, 4, prefix_cache=PrefixKVCache(4))
    for samp in (None, SAMPLED):
        expect1, _ = _stream_all(cold, params, turn1, 8, samp)
        expect2, _ = _stream_all(cold, params, turn2, 8, samp)
        assert _stream_all(warm, params, turn1, 8, samp)[0] == expect1
        assert _stream_all(warm, params, turn2, 8, samp)[0] == expect2  # a hit
    assert warm.prefix_cache.hits >= 2


def test_second_turn_prefills_only_the_suffix(model):
    widths = []

    def counting_fwd(p, t, kv_cache, cache_offset=0):
        if t.shape[1] > 1:  # prefill blocks only; decode steps are [1, 1]
            widths.append(t.shape[1])
        return model["fwd"](p, t, kv_cache=kv_cache, cache_offset=cache_offset)

    dec = ChunkedDecoder(counting_fwd, model["init"], 4, prefix_cache=PrefixKVCache(4))
    turn1 = list(range(3, 40))  # 37 tokens: bucket 48
    _stream_all(dec, model["tparams"], turn1, 4)
    _stream_all(dec, model["tparams"], turn1 + [9, 8, 7], 4)  # suffix bucket 16
    assert widths == [48, 16]


def test_suffix_write_span_never_overflows_cache(model):
    """plen 31 + suffix bucket 16 = 47 > the naive 32 + 8 + 1 = 41."""
    params, fwd, init = model["tparams"], model["fwd"], model["init"]
    turn1 = [(i % 60) + 1 for i in range(31)]
    turn2 = turn1 + [7]
    expect, _ = _stream_all(ChunkedDecoder(fwd, init, 8), params, turn2, 8)
    warm = ChunkedDecoder(fwd, init, 8, prefix_cache=PrefixKVCache(4))
    _stream_all(warm, params, turn1, 8)
    assert _stream_all(warm, params, turn2, 8)[0] == expect
    assert warm.prefix_cache.hits == 1


def test_growing_conversation_keeps_hitting(model):
    params = model["tparams"]
    dec = ChunkedDecoder(model["fwd"], model["init"], 4, prefix_cache=PrefixKVCache(4))
    cold = ChunkedDecoder(model["fwd"], model["init"], 4)
    ids = [5, 6, 7]
    for _turn in range(3):
        out, _ = _stream_all(dec, params, ids, 4, SAMPLED)
        assert out == _stream_all(cold, params, ids, 4, SAMPLED)[0]
        ids = ids + out + [11]
    assert dec.prefix_cache.hits == 2 and dec.prefix_cache.misses == 1


def test_row_lens_are_checked(model):
    prompt = torch.zeros((1, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="row_lens"):
        ragged_greedy_generate(model["fwd"], model["init"], model["tparams"], prompt, [17], 2)
    with pytest.raises(ValueError, match="row_lens"):
        list(ChunkedDecoder(model["fwd"], model["init"], 4).stream(
            model["tparams"], prompt, [0], 2))


@pytest.mark.parametrize("lens", [[16, 16], [16, 9]])
def test_decode_offsets_are_host_ints_when_rows_share_a_length(model, lens):
    """Rows of one length (every /v1/generate request and stream) write the
    cache at an int offset, a slice with no read-back from the card; only a
    ragged batch passes a [B] tensor."""
    kinds = []

    def recording_fwd(p, t, kv_cache, cache_offset=0):
        if t.shape[1] == 1:
            kinds.append(type(cache_offset))
        return model["fwd"](p, t, kv_cache=kv_cache, cache_offset=cache_offset)

    prompt = torch.as_tensor(np.random.RandomState(4).randint(1, 128, (2, 16)))
    want = int if lens[0] == lens[1] else torch.Tensor
    ragged_greedy_generate(recording_fwd, model["init"], model["tparams"], prompt, lens, 4)
    list(ChunkedDecoder(recording_fwd, model["init"], 3).stream(
        model["tparams"], prompt, lens, 4))
    assert kinds and all(k is want for k in kinds)
