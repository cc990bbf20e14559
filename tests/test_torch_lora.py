"""LoRA merge in the port (dl/lora.py, ModelServer(lora_dir=...)) against
the JAX package on the CPU.

Tolerance: the merged weights are byte-equal to ``modelx_tpu.dl.lora
.merge_adapter``'s, bf16 and fp32 bases, with and without
``adapter_config.json``; every refusal raises the reference's message; a
LoRA-served tiny llama answers JAX's forward argmax and greedy tokens in fp32.
"""

import dataclasses
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import lora as jlora
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.models import llama as jl
from modelx_tpu.ops import quant as jq
from modelx_tpu_torch.dl import lora as tlora
from modelx_tpu_torch.dl.serve import ModelServer
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.ops import quant as tq

TARGETS = {"model.layers.0.self_attn.q_proj.weight": (24, 16),
           "model.layers.1.self_attn.v_proj.weight": (8, 16)}


def _write_adapter(d, pairs: dict, config: dict | None = None, prefix="base_model.model.",
                   extra: dict | None = None):
    tensors = dict(extra or {})
    for target, (a, b) in pairs.items():
        base = target.removesuffix(".weight")
        tensors[f"{prefix}{base}.lora_A.weight"] = a
        tensors[f"{prefix}{base}.lora_B.weight"] = b
    os.makedirs(d, exist_ok=True)
    jst.write_safetensors(os.path.join(d, "adapter_model.safetensors"), tensors)
    if config is not None:
        with open(os.path.join(d, "adapter_config.json"), "w") as f:
            json.dump(config, f)
    return str(d)


def _pairs(r: int, dtype, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {t: (rng.randn(r, shape[1]).astype(dtype) * 0.3, rng.randn(shape[0], r).astype(dtype))
            for t, shape in TARGETS.items()}


def _base(dtype) -> dict:
    rng = np.random.RandomState(9)
    base = {t: rng.randn(*shape).astype(dtype) for t, shape in TARGETS.items()}
    base["model.norm.weight"] = np.ones((16,), dtype)
    return base


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("config", [
    None,
    {"r": 4, "lora_alpha": 32},
    {"r": 4, "lora_alpha": 7, "use_rslora": True},
    {"lora_alpha": 6},
], ids=["no-config", "alpha32", "rslora", "r-from-pairs"])
def test_merge_byte_equal_to_jax(tmp_path, dtype, config):
    d = _write_adapter(tmp_path / "ad", _pairs(4, dtype), config)
    np_base = _base(dtype)
    want = jlora.merge_adapter({k: jnp.asarray(v) for k, v in np_base.items()}, d)
    got = tlora.merge_adapter(from_jax_params(np_base, device="cpu"), d)
    assert sorted(got) == sorted(want)
    for name in want:
        assert _bytes(got[name]) == _bytes(want[name]), name
    assert tlora.parse_adapter_dir(d)[0] == jlora.parse_adapter_dir(d)[0]
    # the merge moved the targets
    assert _bytes(got[next(iter(TARGETS))]) != np_base[next(iter(TARGETS))].tobytes()


def _broken(tmp_path, case: str):
    """An adapter dir (and base params) whose merge must be refused."""
    d = tmp_path / case
    pairs = _pairs(4, np.float32)
    t0 = next(iter(TARGETS))
    if case == "empty-dir":
        os.makedirs(d)
        return str(d), _base(np.float32)
    if case == "modules-to-save":
        return _write_adapter(d, pairs, extra={
            f"base_model.model.lm_head.modules_to_save.weight{i}": np.ones(3, np.float32)
            for i in range(5)}), _base(np.float32)
    if case == "missing-b":
        a, _ = pairs[t0]
        os.makedirs(d)
        jst.write_safetensors(str(d / "a.safetensors"),
                              {f"base_model.model.{t0[:-7]}.lora_A.weight": a})
        return str(d), _base(np.float32)
    if case == "no-tensors":
        os.makedirs(d)
        jst.write_safetensors(str(d / "a.safetensors"), {})
        return str(d), _base(np.float32)
    if case == "rank-pattern":
        return _write_adapter(d, pairs, {"r": 4, "rank_pattern": {"q_proj": 8}}), \
            _base(np.float32)
    if case == "rank-mismatch":
        return _write_adapter(d, pairs, {"r": 8, "lora_alpha": 16}), _base(np.float32)
    if case == "missing-target":
        base = _base(np.float32)
        del base[t0]
        return _write_adapter(d, pairs), base
    if case == "shape-mismatch":
        base = _base(np.float32)
        base[t0] = base[t0][:, :8]
        return _write_adapter(d, pairs), base
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["empty-dir", "modules-to-save", "missing-b", "no-tensors",
                                  "rank-pattern", "rank-mismatch", "missing-target",
                                  "shape-mismatch"])
def test_refusals_raise_the_jax_message(tmp_path, case):
    d, np_base = _broken(tmp_path, case)
    with pytest.raises(ValueError) as want:
        jlora.merge_adapter({k: jnp.asarray(v) for k, v in np_base.items()}, d)
    with pytest.raises(ValueError) as got:
        tlora.merge_adapter(from_jax_params(np_base, device="cpu"), d)
    assert str(got.value) == str(want.value)


def test_quantized_target_is_refused_as_jax(tmp_path):
    d = _write_adapter(tmp_path / "ad", _pairs(4, np.float32))
    np_base = _base(np.float32)
    t0 = next(iter(TARGETS))
    jparams = {k: jnp.asarray(v) for k, v in np_base.items()}
    jparams[t0] = jq.quantize(np_base[t0])
    tparams = from_jax_params(np_base, device="cpu")
    tparams[t0] = tq.quantize(np_base[t0])
    with pytest.raises(ValueError) as want:
        jlora.merge_adapter(jparams, d)
    with pytest.raises(ValueError) as got:
        tlora.merge_adapter(tparams, d)
    assert str(got.value) == str(want.value)
    assert "merge adapters before --quantize" in str(got.value)


def test_lora_server_serves_the_jax_merge(tmp_path):
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=80), rope_theta=500000.0,
                              dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    model = tmp_path / "model"
    model.mkdir()
    jst.write_safetensors(str(model / "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})
    rng = np.random.RandomState(2)
    pairs = {}
    for i in range(cfg.num_layers):
        for proj, out in (("q_proj", 128), ("v_proj", 64)):
            pairs[f"model.layers.{i}.self_attn.{proj}.weight"] = (
                rng.randn(8, 128).astype(np.float32) * 0.1,
                rng.randn(out, 8).astype(np.float32) * 0.1)
    ad = _write_adapter(tmp_path / "ad", pairs, {"r": 8, "lora_alpha": 16})
    js = JaxModelServer(str(model), mesh_spec="dp=1", dtype="float32", lora_dir=ad)
    js.load()
    ts = ModelServer(str(model), dtype="float32", device="cpu", lora_dir=ad)
    stats = ts.load()
    assert stats["lora_dir"] == ad and stats["lora_merge_seconds"] >= 0
    for name in pairs:
        assert _bytes(ts.params[name]) == _bytes(js.params[name]), name
    tokens = rng.randint(0, 80, (2, 11)).astype(np.int32)
    np.testing.assert_array_equal(ts.forward_argmax(tokens), js.forward_argmax(tokens))
    np.testing.assert_array_equal(ts.generate(tokens, max_new_tokens=7),
                                  js.generate(tokens, max_new_tokens=7))
