"""The port's family registry and the loader's expert fusion against the JAX package.

Config inference runs on meta tensors (shapes only) of the full presets,
the JAX package's on ShapeDtypeStructs of the same shapes: every field
equal, Phi-3-mini's head_dim 96 and Gemma-2-27b's 128 / 144 included.
The loader folds HF's per-expert tensors (``...experts.<i>.w1.weight``)
into the stacked tensor JAX's ``fuse_expert_tensors`` describes, and its
bytes equal the JAX loader's.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import families as jfam
from modelx_tpu.dl import loader as jloader
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.sharding import MIXTRAL_RULES
from modelx_tpu.models import bert as jbert
from modelx_tpu.models import gemma2 as jgemma2
from modelx_tpu.models import gpt2 as jgpt2
from modelx_tpu.models import llama as jllama
from modelx_tpu.models import mixtral as jmixtral
from modelx_tpu.models import phi3 as jphi3
from modelx_tpu.parallel.mesh import make_mesh
from modelx_tpu_torch.dl import families as tfam
from modelx_tpu_torch.dl import loader as tloader
from modelx_tpu_torch.dl import safetensors as tst


def _phi3_mini():
    return jllama.LlamaConfig(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                              num_layers=32, num_heads=32, num_kv_heads=32, head_dim=96,
                              rope_theta=10000.0)


def _phi3_medium():
    return jllama.LlamaConfig(vocab_size=32064, hidden_size=5120, intermediate_size=17920,
                              num_layers=40, num_heads=40, num_kv_heads=10, head_dim=128,
                              rope_theta=10000.0)


def _gemma2_27b():
    return dataclasses.replace(jgemma2.Gemma2Config.gemma2_9b(), hidden_size=4608,
                               intermediate_size=36864, num_layers=46, num_heads=32,
                               num_kv_heads=16, head_dim=128, query_pre_attn_scalar=144.0)


# (family, JAX module, JAX config) at full width; depth cut to 2 layers
# (inference counts layers, so the cut shows as itself)
PRESETS = [
    ("gemma2", jgemma2, jgemma2.Gemma2Config.gemma2_9b()),
    ("gemma2", jgemma2, jgemma2.Gemma2Config.gemma2_2b()),
    ("gemma2", jgemma2, _gemma2_27b()),
    ("phi3", jphi3, _phi3_mini()),
    ("phi3", jphi3, _phi3_medium()),
    ("mixtral", jmixtral, jmixtral.MixtralConfig.mixtral_8x7b()),
    ("gpt2", jgpt2, jgpt2.GPT2Config.gpt2_125m()),
    ("gemma2", jgemma2, jgemma2.Gemma2Config.tiny()),
    ("phi3", jphi3, jllama.LlamaConfig.tiny()),
    ("mixtral", jmixtral, jmixtral.MixtralConfig.tiny()),
    ("gpt2", jgpt2, jgpt2.GPT2Config.tiny()),
    ("bert", jbert, jbert.BertConfig.bert_base()),
    ("bert", jbert, jbert.BertConfig.tiny()),
]


@pytest.mark.parametrize("family,module,jcfg", PRESETS,
                         ids=["gemma2-9b", "gemma2-2b", "gemma2-27b", "phi3-mini", "phi3-medium",
                              "mixtral-8x7b", "gpt2-125m", "gemma2-tiny", "phi3-tiny",
                              "mixtral-tiny", "gpt2-tiny", "bert-base", "bert-tiny"])
def test_infer_config_matches_jax(family, module, jcfg):
    shapes = module.param_shapes(dataclasses.replace(jcfg, num_layers=2))
    jax_abs = {n: jax.ShapeDtypeStruct(s, jnp.bfloat16) for n, s in shapes.items()}
    port_abs = {n: torch.empty(s, dtype=torch.bfloat16, device="meta") for n, s in shapes.items()}
    assert tfam.detect(list(shapes)).name == family
    jc = jfam.FAMILIES[family].infer_config(jax_abs)
    tc = tfam.FAMILIES[family].infer_config(port_abs)
    fields = [f.name for f in dataclasses.fields(tc) if f.name != "dtype"]
    assert {f: getattr(tc, f) for f in fields} == {f: getattr(jc, f) for f in fields}
    assert tc.dtype == torch.bfloat16
    if jcfg.hidden_size > 512:  # the full presets read back as themselves
        assert {f: getattr(tc, f) for f in fields if f != "num_layers"} == {
            f: getattr(jcfg, f) for f in fields if f != "num_layers"}


def test_phi3_mini_rides_head_dim_96():
    shapes = jphi3.param_shapes(_phi3_mini())
    cfg = tfam.infer_phi3_config({n: torch.empty(s, device="meta") for n, s in shapes.items()})
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads) == (96, 32, 32)
    from modelx_tpu_torch.ops.attention import KERNEL_HEAD_DIMS

    assert 96 in KERNEL_HEAD_DIMS


def test_only_bert_is_not_yet_ported():
    """bert, the last family left, is ported: the registry holds every
    family of the JAX package's and the not-yet-ported list is gone."""
    assert not hasattr(tfam, "NOT_YET_PORTED")
    assert set(tfam.FAMILIES) == set(jfam.FAMILIES)
    fam = tfam.detect(["bert.embeddings.word_embeddings.weight"])
    assert fam.name == "bert" and fam.generate_ragged is None and fam.decode_fns is None


@pytest.mark.parametrize("sidecar", [
    {"rope_scaling": {"type": "longrope", "long_factor": [1.0]}},
    {"rope_scaling": {"type": "su"}},
    {"rope_scaling": {"rope_type": "yarn"}},
    {"rope_theta": 250000.0},
], ids=["longrope", "su", "yarn", "theta"])
def test_phi3_sidecar_refuses_long_context_as_jax(sidecar):
    shapes = jphi3.param_shapes(dataclasses.replace(_phi3_mini(), num_layers=1))
    jc = jfam.infer_phi3_config({n: jax.ShapeDtypeStruct(s, jnp.bfloat16)
                                 for n, s in shapes.items()})
    tc = tfam.infer_phi3_config({n: torch.empty(s, device="meta") for n, s in shapes.items()})
    try:
        jout = jfam.apply_sidecar_config(jc, sidecar, "phi3")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfam.apply_sidecar_config(tc, sidecar, "phi3")
        assert str(got.value) == str(e)
        return
    assert tfam.apply_sidecar_config(tc, sidecar, "phi3").rope_theta == jout.rope_theta


def _per_expert_checkpoint(path):
    """A checkpoint in HF's per-expert layout, members out of order and
    interleaved with other tensors; bf16 experts; plus two groups that must
    not fuse (an index missing, a shape that differs)."""
    rng = np.random.RandomState(0)
    arrays = {"model.embed_tokens.weight": rng.rand(8, 4).astype(np.float32)}
    for layer in (1, 0):
        p = f"model.layers.{layer}.block_sparse_moe"
        for e in (2, 0, 3, 1):
            for w, shape in (("w1", (6, 4)), ("w2", (4, 6)), ("w3", (6, 4))):
                arrays[f"{p}.experts.{e}.{w}.weight"] = (
                    rng.rand(*shape).astype(ml_dtypes.bfloat16))
            arrays[f"model.layers.{layer}.input_layernorm.weight.{e}"] = rng.rand(4).astype(
                np.float32)
    arrays["x.experts.0.gap.weight"] = rng.rand(3).astype(np.float32)
    arrays["x.experts.2.gap.weight"] = rng.rand(3).astype(np.float32)
    arrays["x.experts.0.odd.weight"] = rng.rand(3).astype(np.float32)
    arrays["x.experts.1.odd.weight"] = rng.rand(5).astype(np.float32)
    jst.write_safetensors(path, arrays)
    return arrays


def test_fuse_expert_tensors_matches_jax(tmp_path):
    path = str(tmp_path / "moe.safetensors")
    _per_expert_checkpoint(path)
    jinfos, _ = jst.read_header_from_file(path)
    tinfos, _ = tst.read_header_from_file(path)
    want = jloader.fuse_expert_tensors(jinfos)
    got = tloader.fuse_expert_tensors(tinfos)
    assert list(got) == list(want)

    def desc(info):
        members = [m.name for m in info.members] if info.members else None
        return info.dtype, tuple(info.shape), info.start, info.end, members

    assert {n: desc(i) for n, i in got.items()} == {n: desc(i) for n, i in want.items()}
    fused = "model.layers.0.block_sparse_moe.experts.w2.weight"
    assert got[fused].shape == (4, 4, 6)
    assert "x.experts.2.gap.weight" in got and "x.experts.1.odd.weight" in got  # unfused


def test_loaded_fused_tensor_byte_equal_to_jax(tmp_path):
    """The port's loader reads each stacked tensor from its members' byte
    ranges: the same bytes as the JAX loader's on a one-device mesh, and
    as the members stacked by hand."""
    path = str(tmp_path / "moe.safetensors")
    arrays = _per_expert_checkpoint(path)
    src = jloader.LocalFileSource(path)
    try:
        jparams, _ = jloader.load_safetensors(src, make_mesh("dp=1"), MIXTRAL_RULES)
    finally:
        src.close()
    src = tloader.LocalFileSource(path)
    try:
        tparams, stats = tloader.load_safetensors(src, "cpu")
    finally:
        src.close()
    assert sorted(tparams) == sorted(jparams)
    for name, arr in jparams.items():
        want = np.asarray(arr)
        got = tparams[name]
        assert tuple(got.shape) == want.shape, name
        assert got.contiguous().view(torch.uint8).numpy().tobytes() == want.tobytes(), name
    stacked = np.stack([arrays[f"model.layers.1.block_sparse_moe.experts.{e}.w3.weight"]
                        for e in range(4)])
    assert (tparams["model.layers.1.block_sparse_moe.experts.w3.weight"].view(torch.uint16)
            .numpy().tobytes() == stacked.tobytes())
    assert stats.bytes_to_device == sum(a.nbytes for a in arrays.values())
