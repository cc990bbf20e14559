"""Port attention (modelx_tpu_torch.ops.attention) against the JAX package.

The same numpy inputs (np.random.RandomState) go through the port's plain
reference, the JAX reference and the JAX Pallas flash kernel in interpret
mode. fp32 tolerance is atol 2e-6, as tests/test_model.py holds the JAX
flash kernel to its own reference (same math, another summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modelx_tpu.ops import attention as jattn
from modelx_tpu_torch.ops import attention as tattn

FP32_ATOL = 2e-6
# bf16 in, bf16 out: the PV product rounds to bf16 (2^-8 relative ulp) in
# both frameworks, after fp32 logits/softmax whose order differs
BF16_ATOL = 2e-2


def _inputs(seed, b=2, h=4, hkv=4, s=128, d=32):
    rng = np.random.RandomState(seed)
    q = rng.rand(b, h, s, d).astype(np.float32)
    k = rng.rand(b, hkv, s, d).astype(np.float32)
    v = rng.rand(b, hkv, s, d).astype(np.float32)
    return q, k, v


# (id, kv heads, reference kwargs, JAX flash block kwargs)
CASES = [
    ("causal", 4, {}, {"block_q": 64, "block_k": 64}),
    ("noncausal", 4, {"causal": False}, {"block_q": 64, "block_k": 64}),
    ("gqa", 2, {}, {"block_q": 64, "block_k": 64}),
    ("block_k_gt_block_q", 4, {}, {"block_q": 32, "block_k": 128}),
    ("softcap_window", 2, {"scale": 0.25, "logit_softcap": 5.0, "window": 24},
     {"block_q": 32, "block_k": 32}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_jax_flash_and_reference(case):
    _, hkv, kw, blocks = case
    q, k, v = _inputs(0, hkv=hkv)
    port = tattn.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jref = np.asarray(jattn.attention_reference(jq, jk, jv, **kw))
    jflash = np.asarray(jattn.flash_attention(jq, jk, jv, interpret=True, **kw, **blocks))
    np.testing.assert_allclose(port, jref, atol=FP32_ATOL)
    np.testing.assert_allclose(port, jflash, atol=FP32_ATOL)
    assert np.abs(port).sum() > 0


@pytest.mark.parametrize("kw", [{}, {"causal": False}, {"logit_softcap": 30.0, "window": 40}],
                         ids=["causal", "noncausal", "softcap_window"])
def test_head_dim_96_matches_jax_flash(kw):
    """Phi-3-mini's head_dim, which the CUDA kernel runs as its 128 tile
    with zero columns: the plain version the kernel is held to equals the
    Pallas kernel (interpret mode) and JAX's reference at D = 96."""
    q, k, v = _inputs(5, h=4, hkv=4, s=96, d=96)
    port = tattn.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jref = np.asarray(jattn.attention_reference(jq, jk, jv, **kw))
    jflash = np.asarray(jattn.flash_attention(jq, jk, jv, interpret=True, block_q=32,
                                              block_k=32, **kw))
    np.testing.assert_allclose(port, jref, atol=FP32_ATOL)
    np.testing.assert_allclose(port, jflash, atol=FP32_ATOL)
    assert 96 in tattn.KERNEL_HEAD_DIMS


def test_reference_per_row_q_offset_matches_jax():
    """[B] q_offset (ragged cached decode): each row's queries sit at their
    own positions against a longer cache."""
    rng = np.random.RandomState(4)
    q = rng.rand(3, 4, 2, 32).astype(np.float32)
    k = rng.rand(3, 2, 40, 32).astype(np.float32)
    v = rng.rand(3, 2, 40, 32).astype(np.float32)
    off = np.array([5, 17, 38], np.int32)
    port = tattn.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=torch.from_numpy(off)).numpy()
    jref = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(off)))
    np.testing.assert_allclose(port, jref, atol=FP32_ATOL)


def test_reference_bf16_matches_jax():
    q, k, v = _inputs(1, hkv=2)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    port = tattn.attention_reference(tq, tk, tv)
    assert port.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jref = np.asarray(jattn.attention_reference(jq, jk, jv)).astype(np.float32)
    np.testing.assert_allclose(port.float().numpy(), jref, atol=BF16_ATOL)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    """CPU tensors take the plain version, bit for bit, and launch nothing."""
    q, k, v = _inputs(2, hkv=2, s=100)  # ragged for any GPU tile
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = tattn.flash_attention.launches
    kw = {"scale": 0.3, "logit_softcap": 4.0, "window": 16}
    out = tattn.flash_attention(tq, tk, tv, **kw)
    assert torch.equal(out, tattn.attention_reference(tq, tk, tv, **kw))
    assert tattn.flash_attention.launches == before


def test_flash_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    neither device gets no plain-version fallback."""
    q = torch.empty(1, 4, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, q, q)
