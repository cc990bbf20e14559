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
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2), (8, 1)])  # GQA ratios 1, 4, 8
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, d, dtype, h, hkv):
    seed = d if hkv == 2 else d + hkv  # (8, 2) keeps the inputs it had before GQA 1 and 8
    q, k, v = _qkv(cuda_device, dtype, 2, h, hkv, 200, 200, d, seed=seed)
    atol, rtol = _tol(dtype)
    # window 48 is smaller than any kv tile (64 or 128 keys); window 150
    # straddles two or three of them
    for kw in ({}, {"causal": False}, {"scale": d ** -0.5, "logit_softcap": 50.0, "window": 48},
               {"window": 150}, {"logit_softcap": 30.0, "window": 150}):
        before = tattn.flash_attention.launches
        out = tattn.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert tattn.flash_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        ref = tattn.attention_reference(q.float(), k.float(), v.float(), **kw)
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)


# (dtype, B, H, Hkv, Sq, Sk): any Sq/Sk, including Sq != Sk both ways, and
# lengths one short of, one past and one short of twice the 128-row tile
RAGGED_CASES = [
    (torch.float32, 1, 4, 4, 1, 1), (torch.float32, 1, 4, 4, 7, 130),
    (torch.float32, 1, 4, 4, 130, 7), (torch.float32, 1, 4, 4, 65, 65),
    (torch.bfloat16, 1, 4, 4, 1, 1), (torch.bfloat16, 1, 4, 4, 7, 130),
    (torch.bfloat16, 1, 4, 4, 130, 7), (torch.bfloat16, 1, 4, 4, 65, 65),
    (torch.bfloat16, 1, 4, 2, 127, 127), (torch.bfloat16, 1, 4, 2, 129, 129),
    (torch.bfloat16, 1, 4, 2, 255, 255), (torch.bfloat16, 1, 4, 2, 127, 255),
    (torch.bfloat16, 1, 4, 2, 255, 127), (torch.bfloat16, 1, 4, 2, 129, 255),
    (torch.bfloat16, 1, 4, 2, 255, 129),
    (torch.bfloat16, 1, 1, 1, 129, 255),    # B*H = 1
    (torch.bfloat16, 4, 64, 8, 255, 129),   # B*H = 256
    (torch.float32, 1, 1, 1, 129, 255), (torch.float32, 4, 64, 8, 255, 129),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,hkv,sq,sk", RAGGED_CASES)
@pytest.mark.parametrize("d", [96, 128, 256])
def test_kernel_ragged_and_unequal_lengths(cuda_device, dtype, b, h, hkv, sq, sk, d):
    """Any Sq/Sk, including Sq != Sk (causal is top-left aligned, as in the
    TPU kernel and attention_reference with q_offset=0)."""
    q, k, v = _qkv(cuda_device, dtype, b, h, hkv, sq, sk, d, seed=sq * 1000 + sk)
    atol, rtol = _tol(dtype)
    for causal in (True, False):
        out = tattn.flash_attention(q, k, v, causal=causal)
        ref = tattn.attention_reference(q.float(), k.float(), v.float(), causal=causal)
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)


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


@pytest.mark.cuda
def test_a_bundled_library_installs_and_launches(cuda_device, tmp_path, monkeypatch):
    """The program store's bundle of the built library (dl/program_store.py)
    installs into an empty build directory, binds with origin "bundle"
    without running nvcc, and its kernel matches the plain version (bf16
    tolerance above) on the Llama-3-8B head layout."""
    from modelx_tpu_torch.dl import program_store
    from modelx_tpu_torch.kernels import build

    build.build()  # this tree's library: nvcc, or the build directory's copy
    data = program_store.build_bundle(build.build_dir(), keys=[build.library_name()])
    meta = program_store._bundle_meta(data)
    assert meta["sourceDigest"] == build.source_digest() and "release" in meta["nvcc"]
    monkeypatch.setenv("MODELX_COMPILE_CACHE", str(tmp_path / "cc"))
    assert program_store.install_bundle(data, build.build_dir())["installed"] == 1

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc ran")

    monkeypatch.setattr(build, "compile_library", no_nvcc)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_info", None)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 32, 8, 256, 256, 128, seed=5)
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    info = build.library_info()
    assert info["origin"] == "bundle" and info["path"].startswith(str(tmp_path / "cc"))
    atol, rtol = _tol(torch.bfloat16)
    ref = tattn.attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
