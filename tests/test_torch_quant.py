"""Weight-only int8 in the port (ops/quant.py, ops/nn.linear over a QTensor,
the loader's quantize="int8", ModelServer(quantize="int8")) against the JAX
package on the CPU.

Tolerances: codes and scales byte-equal to ``modelx_tpu.ops.quant``'s, from
numpy (the host rule) and from torch ops (the rule the loader runs on the
device); the int8 linear within 1e-5 of JAX's in fp32; an int8 tiny llama's
greedy tokens and forward argmax equal to JAX's in fp32.
"""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.loader import LocalFileSource as JaxSource
from modelx_tpu.dl.loader import load_safetensors as jax_load
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.sharding import LLAMA_RULES
from modelx_tpu.models import llama as jl
from modelx_tpu.ops import nn as jnn
from modelx_tpu.ops import quant as jq
from modelx_tpu.parallel.mesh import make_mesh
from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors
from modelx_tpu_torch.dl.serve import ModelServer
from modelx_tpu_torch.dl.weights import from_jax_params, to_tensor
from modelx_tpu_torch.ops import nn as tnn
from modelx_tpu_torch.ops import quant as tq


def _weights(kind: str) -> np.ndarray:
    """[out, in] weights with the rule's edge cases in their rows."""
    rng = np.random.RandomState(11)
    w = rng.randn(12, 40).astype(np.float32) * rng.uniform(0.01, 3.0, (12, 1)).astype(np.float32)
    w[1] = 0.0  # a zero row: scale 1, codes 0
    w[2, :] = 0.0
    w[2, 5] = -7.25  # one nonzero: the row's amax lands on -127
    # exact .5 products: scale 2**-3 (amax 127/8), codes (k + 0.5) round half to even
    w[3] = (np.arange(40) - 20 + 0.5).astype(np.float32) / 8.0
    w[3, 0] = 127.0 / 8.0
    w[4] = -w[3]
    w[5, :] = 1e-30  # tiny values: a finite reciprocal
    if kind == "bf16":
        return w.astype(ml_dtypes.bfloat16)
    return w


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_host_rule_byte_equal_to_jax(kind):
    w = _weights(kind)
    want_scale = np.asarray(jq.channel_scales(w))
    want_q = np.asarray(jq.quantize_rows(w, want_scale))
    got_scale = tq.channel_scales(w)
    got_q = tq.quantize_rows(w, got_scale)
    assert got_scale.dtype == np.float32 and got_q.dtype == np.int8
    assert got_scale.tobytes() == want_scale.tobytes()
    assert got_q.tobytes() == want_q.tobytes()
    q, scale = tq.quantize_fused(w)
    assert q.tobytes() == want_q.tobytes() and scale.tobytes() == want_scale.tobytes()
    # the edge rows did what they are there for
    assert want_scale[1] == 1.0 and int(want_q[2, 5]) == -127
    assert int(want_q[3, 1]) == -18 and int(want_q[3, 2]) == -18  # -18.5 -> -18, -17.5 -> -18


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_torch_rule_byte_equal_to_host_rule(kind):
    w = _weights(kind)
    want = jq.quantize(w)
    got = tq.quantize_tensor(to_tensor(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.q.numpy().tobytes() == np.asarray(want.q).tobytes()
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    host = tq.quantize(w)
    assert torch.equal(host.q, got.q) and torch.equal(host.scale, got.scale)
    deq = tq.dequantize(got).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jq.dequantize(want)))


@pytest.mark.parametrize("shape,bias", [((3, 40), False), ((2, 5, 40), True)])
def test_int8_linear_within_1e5_of_jax_fp32(shape, bias):
    rng = np.random.RandomState(2)
    w = _weights("fp32")
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(w.shape[0]).astype(np.float32) if bias else None
    want = np.asarray(jnn.linear(jnp.asarray(x), jq.quantize(w),
                                 None if b is None else jnp.asarray(b)))
    qt = tq.quantize(w)
    got = tnn.linear(torch.from_numpy(x), qt, None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_int8_linear_bf16_applies_the_scale_in_fp32():
    """bf16 activations on the CPU: the fp32 product of bf16 values is exact,
    so the result is the fp32 reference rounded once to bf16."""
    rng = np.random.RandomState(4)
    w = _weights("bf16")
    x = torch.from_numpy(rng.randn(3, 40).astype(np.float32)).to(torch.bfloat16)
    qt = tq.quantize(w)
    got = tnn.linear(x, qt)
    want = ((x.double() @ qt.q.double().T) * qt.scale.double()).float().to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.fixture()
def checkpoint(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {
        "model.embed_tokens.weight": rng.randn(64, 32).astype(ml_dtypes.bfloat16),
        "model.layers.0.self_attn.q_proj.weight": rng.randn(32, 32).astype(ml_dtypes.bfloat16),
        "model.layers.0.self_attn.o_proj.weight": rng.randn(32, 32).astype(ml_dtypes.bfloat16),
        "model.layers.0.mlp.down_proj.weight": rng.randn(32, 48).astype(np.float32),
        "model.layers.0.self_attn.q_proj.bias": rng.randn(32).astype(ml_dtypes.bfloat16),
        "lm_head.weight": rng.randn(64, 32).astype(ml_dtypes.bfloat16),
        "model.norm.weight": np.ones((32,), ml_dtypes.bfloat16),
    }
    tensors["model.layers.0.self_attn.q_proj.weight"][3] = 0
    path = str(tmp_path / "m.safetensors")
    jst.write_safetensors(path, tensors)
    return path, tensors


QUANTIZED = ("model.layers.0.self_attn.q_proj.weight", "model.layers.0.self_attn.o_proj.weight",
             "model.layers.0.mlp.down_proj.weight", "lm_head.weight")


def test_loader_int8_codes_and_scales_equal_jax(checkpoint):
    path, tensors = checkpoint
    src = JaxSource(path)
    try:
        want, _ = jax_load(src, make_mesh("dp=1"), LLAMA_RULES, quantize="int8")
    finally:
        src.close()
    src = LocalFileSource(path)
    try:
        got, stats = load_safetensors(src, "cpu", quantize="int8")
    finally:
        src.close()
    assert list(got) == list(tensors)
    for name in tensors:
        if name in QUANTIZED:
            assert isinstance(want[name], jq.QTensor) and isinstance(got[name], tq.QTensor)
            assert got[name].q.numpy().tobytes() == np.asarray(want[name].q).tobytes(), name
            assert got[name].scale.numpy().tobytes() == np.asarray(
                want[name].scale).tobytes(), name
        else:  # embeddings, norms and biases stay in the load dtype
            raw = got[name].reshape(-1).view(torch.uint8).numpy().tobytes()
            assert raw == tensors[name].tobytes(), name
    # the link carries the checkpoint's bytes; device memory keeps the codes
    assert stats.bytes_to_device == sum(a.nbytes for a in tensors.values())
    assert stats.bytes_resident == sum(
        (a.size + a.shape[0] * 4) if n in QUANTIZED else a.nbytes for n, a in tensors.items())
    src = LocalFileSource(path)
    try:
        with pytest.raises(ValueError, match="unsupported quantize mode"):
            load_safetensors(src, "cpu", quantize="int4")
    finally:
        src.close()


def test_loader_quantizes_before_the_dtype_cast(checkpoint):
    """A bf16 checkpoint served in fp32: codes from the stored values, the
    other floats cast."""
    path, tensors = checkpoint
    src = LocalFileSource(path)
    try:
        got, _ = load_safetensors(src, "cpu", dtype=torch.float32, quantize="int8")
    finally:
        src.close()
    want = jq.quantize(tensors["lm_head.weight"])
    assert got["lm_head.weight"].q.numpy().tobytes() == np.asarray(want.q).tobytes()
    assert got["model.embed_tokens.weight"].dtype == torch.float32


def test_from_jax_params_maps_quantized_pairs():
    w = _weights("fp32")
    qt = jq.quantize(w)
    port = from_jax_params({"x.q_proj.weight": {"q": np.asarray(qt.q),
                                                "scale": np.asarray(qt.scale)},
                            "n.weight": np.ones(3, np.float32)}, device="cpu")
    got = port["x.q_proj.weight"]
    assert isinstance(got, tq.QTensor) and got.q.dtype == torch.int8
    assert got.q.numpy().tobytes() == np.asarray(qt.q).tobytes()
    assert got.shape == w.shape and got.ndim == 2 and got.dtype == torch.float32
    assert got.nbytes == w.size + 4 * w.shape[0]


def _write_tiny(dirpath):
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=96), rope_theta=500000.0,
                              dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    os.makedirs(dirpath, exist_ok=True)
    jst.write_safetensors(os.path.join(dirpath, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})


def test_int8_tiny_llama_serves_jax_tokens(tmp_path):
    _write_tiny(str(tmp_path))
    js = JaxModelServer(str(tmp_path), mesh_spec="dp=1", dtype="float32", quantize="int8")
    js.load()
    ts = ModelServer(str(tmp_path), dtype="float32", device="cpu", quantize="int8")
    stats = ts.load()
    assert isinstance(ts.params["model.layers.0.mlp.gate_proj.weight"], tq.QTensor)
    assert stats["device_bytes"] < stats["load_bytes"]
    tokens = np.random.RandomState(5).randint(0, 96, (2, 13)).astype(np.int32)
    np.testing.assert_array_equal(ts.forward_argmax(tokens), js.forward_argmax(tokens))
    np.testing.assert_array_equal(ts.generate(tokens, max_new_tokens=9),
                                  js.generate(tokens, max_new_tokens=9))
    samp = dict(temperature=0.9, top_k=20, seed=4)
    np.testing.assert_array_equal(ts.generate(tokens, max_new_tokens=6, **samp),
                                  js.generate(tokens, max_new_tokens=6, **samp))
