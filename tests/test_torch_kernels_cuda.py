"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card. This file
imports torch and the port only (no jax), so on the card's host it runs
without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: the kernel in its working dtype against the plain version in
fp32, |err| <= atol + rtol*|ref| with (2e-5, 2e-5) for fp32 (summation
order) and (2e-3, 8e-3) for bf16 (the output's rounding to bf16, two
half-ulps), as chip_smoke.py states them.
"""

import pytest
import torch

from modelx_tpu_torch.ops import attention as tattn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(device, dtype, b, h, hkv, sq, sk, d, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, h, sq, d, generator=gen, device=device).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
    return q, k, v


def _tol(dtype):
    return (2e-5, 2e-5) if dtype == torch.float32 else (2e-3, 8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, d, dtype):
    q, k, v = _qkv(cuda_device, dtype, 2, 8, 2, 200, 200, d, seed=d)
    atol, rtol = _tol(dtype)
    for kw in ({}, {"causal": False}, {"scale": d ** -0.5, "logit_softcap": 50.0, "window": 48}):
        before = tattn.flash_attention.launches
        out = tattn.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert tattn.flash_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        ref = tattn.attention_reference(q.float(), k.float(), v.float(), **kw)
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1, 1), (7, 130), (130, 7), (65, 65)])
def test_kernel_ragged_and_unequal_lengths(cuda_device, sq, sk):
    """Any Sq/Sk, including Sq != Sk (causal is top-left aligned, as in the
    TPU kernel and attention_reference with q_offset=0)."""
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 4, sq, sk, 128, seed=sq * 1000 + sk)
    for causal in (True, False):
        out = tattn.flash_attention(q, k, v, causal=causal)
        ref = tattn.attention_reference(q, k, v, causal=causal)
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 4, 16, 16, 32, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, torch.float16, 1, 4, 4, 16, 16, 64, seed=0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tattn.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 3, 16, 16, 64, seed=0)
    with pytest.raises(ValueError, match="H % Hkv"):
        tattn.flash_attention(q, k, v)
