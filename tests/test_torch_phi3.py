"""Port phi3 (modelx_tpu_torch.models.phi3) against the JAX package, on the CPU.

The JAX package's init of a fused phi3 checkpoint (qkv_proj, gate_up_proj)
at llama's tiny preset, handed over as numpy arrays. Tolerances: fp32
logits atol 1e-5, as tests/test_torch_llama.py (the same llama decoder
over row views); greedy and seeded sampled tokens exactly, in fp32; int8
codes, scales and their un-fused row slices byte for byte.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_family_util as fu
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.models import llama as jl
from modelx_tpu.models import phi3 as jp3
from modelx_tpu.ops import quant as jquant
from modelx_tpu_torch.dl.serve import ModelServer
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import llama as tl
from modelx_tpu_torch.models import phi3 as tp3
from modelx_tpu_torch.ops import quant as tquant

FP32_ATOL = 1e-5


def _model(vocab: int = 512, seed: int = 0):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=vocab), dtype=jnp.float32)
    jparams = jp3.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    fields = [f for f in tl.LlamaConfig.__dataclass_fields__ if f != "dtype"]
    tcfg = tl.LlamaConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=torch.float32)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def fp32_phi3():
    return _model()


def _tokens(vocab, shape, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def test_param_shapes_equal_jax():
    jcfg, _, tcfg, _ = _model()
    assert tp3.param_shapes(tcfg) == jp3.param_shapes(jcfg)


def test_forward_logits_fp32(fp32_phi3):
    jcfg, jp, tcfg, tp = fp32_phi3
    tok = _tokens(jcfg.vocab_size, (2, 16))
    jlog = np.asarray(jp3.forward(jp, jnp.asarray(tok), jcfg)[0])
    tlog, cache = tp3.forward(tp, torch.as_tensor(tok), tcfg)
    assert cache is None
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=FP32_ATOL)


def test_unfused_views_share_the_fused_storage(fp32_phi3):
    _, _, tcfg, tp = fp32_phi3
    views = tp3.as_llama_params(tp, tcfg)
    qkv = tp["model.layers.1.self_attn.qkv_proj.weight"]
    k = views["model.layers.1.self_attn.k_proj.weight"]
    assert k.untyped_storage().data_ptr() == qkv.untyped_storage().data_ptr()
    q_rows = tcfg.num_heads * tcfg.head_dim
    assert torch.equal(k, qkv[q_rows:q_rows + tcfg.num_kv_heads * tcfg.head_dim])


def test_cached_decode_equals_cache_free_forward(fp32_phi3):
    _, _, tcfg, tp = fp32_phi3
    tok = torch.as_tensor(_tokens(tcfg.vocab_size, (2, 20), seed=3))
    free = tp3.forward(tp, tok, tcfg)[0]
    fwd, init = tp3.decode_fns(tp, tcfg)
    cache = init(2, 24)
    pre, _ = fwd(tp, tok[:, :8], kv_cache=cache, cache_offset=0)
    torch.testing.assert_close(pre, free[:, :8], atol=FP32_ATOL, rtol=0)
    for t in range(8, 20):
        step, _ = fwd(tp, tok[:, t:t + 1], kv_cache=cache, cache_offset=t)
        torch.testing.assert_close(step[:, 0], free[:, t], atol=FP32_ATOL, rtol=0)


def test_greedy_and_sampled_tokens_equal_jax(fp32_phi3):
    jcfg, jp, tcfg, tp = fp32_phi3
    tok = _tokens(jcfg.vocab_size, (3, 14), seed=5)
    lens = np.array([14, 6, 11], np.int32)
    samp = dict(temperature=np.array([0.0, 0.9, 1.2], np.float32),
                top_k=np.array([0, 20, 0], np.int32), top_p=np.array([1.0, 1.0, 0.9], np.float32),
                seeds=np.array([0, 5, 9], np.int32))
    jout = np.asarray(jp3.ragged_greedy_generate(jp, jnp.asarray(tok), jnp.asarray(lens), jcfg,
                                                 max_new_tokens=8,
                                                 **{k: jnp.asarray(v) for k, v in samp.items()}))
    tout = tp3.ragged_greedy_generate(tp, torch.as_tensor(tok), lens, tcfg, max_new_tokens=8,
                                      **{k: torch.as_tensor(v) for k, v in samp.items()})
    np.testing.assert_array_equal(tout.numpy(), jout)


@pytest.mark.parametrize("lo,hi", [(0, 128), (128, 192), (192, 256), (5, 77)])
def test_int8_unfusing_byte_equal_to_jax(lo, hi):
    """A fused qkv weight quantized whole, then sliced by rows: the codes
    and the per-row scales of each slice are JAX's ``_slice_rows`` bytes."""
    w = np.random.RandomState(7).normal(0, 0.05, (256, 128)).astype(np.float32)
    jq = jp3._slice_rows(jquant.quantize(w), lo, hi)
    tq = tp3._slice_rows(tquant.quantize(w), lo, hi)
    assert isinstance(tq, tquant.QTensor)
    assert tq.q.numpy().tobytes() == np.asarray(jq.q).tobytes()
    assert tq.scale.numpy().tobytes() == np.asarray(jq.scale).tobytes()


def test_int8_phi3_serves_jax_tokens(tmp_path):
    """The loader quantizes the fused qkv_proj / gate_up_proj whole (the
    quant regex names them); the forward un-fuses the int8 rows with their
    scales: argmax and tokens equal the JAX sidecar's int8 server."""
    _, jp, _, _ = _model(vocab=96)
    d = fu.write_checkpoint(str(tmp_path), jp)
    js = JaxModelServer(d, mesh_spec="dp=1", dtype="float32", quantize="int8")
    js.load()
    ts = ModelServer(d, dtype="float32", device="cpu", quantize="int8")
    ts.load()
    assert isinstance(ts.params["model.layers.0.self_attn.qkv_proj.weight"], tquant.QTensor)
    assert isinstance(ts.params["model.layers.0.mlp.gate_up_proj.weight"], tquant.QTensor)
    tokens = np.random.RandomState(5).randint(0, 96, (2, 13)).astype(np.int32)
    np.testing.assert_array_equal(ts.forward_argmax(tokens), js.forward_argmax(tokens))
    np.testing.assert_array_equal(ts.generate(tokens, max_new_tokens=8),
                                  js.generate(tokens, max_new_tokens=8))


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    _, jp, _, _ = _model(vocab=256)
    d = fu.write_checkpoint(str(tmp_path_factory.mktemp("phi3")), jp)
    p = fu.Pods(d, "phi3")
    yield p
    p.close()


REQUESTS = fu.parity_requests(256)


@pytest.mark.parametrize("path,body", REQUESTS, ids=[f"{i}{p}" for i, (p, _) in
                                                       enumerate(REQUESTS)])
def test_http_bodies_identical_to_jax_pod(pods, path, body):
    (js, jb), (ts, tb) = pods.both(path, body)
    assert (ts, tb) == (js, jb)
    assert js == 200


@pytest.mark.parametrize("mode", sorted(fu.ENGINE_MODES))
def test_continuous_engine_equals_jax_generate(pods, mode):
    reqs = fu.engine_requests(256)
    got = fu.engine_tokens(pods.server, reqs, mode, n_new=10)
    for (prompt, samp), g in zip(reqs, got):
        want = np.asarray(pods.jserver.generate(prompt, max_new_tokens=10, **samp))
        np.testing.assert_array_equal(g, want)
