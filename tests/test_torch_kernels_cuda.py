"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card. This file
imports torch and the port only (no jax), so on the card's host it runs
without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: the kernel in its working dtype against the plain version in
fp32, |err| <= atol + rtol*|ref| with (2e-5, 2e-5) for fp32 (summation
order) and (2e-3, 8e-3) for bf16 (the output's rounding to bf16, two
half-ulps), as chip_smoke.py states them. The backward kernel's gradients:
|err| <= atol*max|ref| + rtol*|ref| with (1e-5, 2e-5) for fp32 and
(2e-3, 8e-3) for bf16, each tensor against its own maximum (chip_smoke.py's
``BWD_TOL``); the forward's row log-sum-exp within 1e-4 (``LSE_TOL``). The
bf16 backward at head_dim 64-128 sums dQ (and under GQA dK, dV) with
atomics in arrival order, so two of its runs agree within ``BWD_TOL`` of
each other, not bit for bit; its fp32 and head_dim 32 kernels sum in a
fixed order and agree bit for bit.
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
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
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
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 4, 16, 16, 48, seed=0)
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


BWD_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (2e-3, 8e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_version(cuda_device, d, dtype, h, hkv):
    """The backward kernel, reached through autograd (FlashAttentionFunction),
    against attention_backward_reference on the same q, k, v, do and the
    forward kernel's o and lse; that o (the training instantiation's) against
    attention_reference, its lse against attention_lse_reference."""
    q, k, v = _qkv(cuda_device, dtype, 2, h, hkv, 200, 200, d, seed=d + 7 * hkv)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(d),
                     device=cuda_device).to(dtype)
    atol, rtol = BWD_TOL[dtype]
    for kw in ({}, {"causal": False}, {"scale": d ** -0.5, "logit_softcap": 50.0, "window": 48},
               {"window": 150}):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = (tattn.flash_attention.launches, tattn.flash_attention_backward.launches)
        out = tattn.flash_attention(*leaves, **kw)
        out.backward(do)
        torch.cuda.synchronize()
        assert (tattn.flash_attention.launches, tattn.flash_attention_backward.launches) == (
            before[0] + 1, before[1] + 1)
        causal = kw.get("causal", True)
        o_atol, o_rtol = _tol(dtype)
        ref_o = tattn.attention_reference(q.float(), k.float(), v.float(), **kw)
        torch.testing.assert_close(out.detach().float(), ref_o, atol=o_atol, rtol=o_rtol)
        _, lse = tattn._flash_cuda(q, k, v, causal, kw.get("scale"),
                                   kw.get("logit_softcap", 0.0), kw.get("window", 0),
                                   with_lse=True)
        ref_lse = tattn.attention_lse_reference(q.float(), k.float(), v.float(), **kw)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        want = tattn.attention_backward_reference(q.float(), k.float(), v.float(),
                                                  out.detach().float(), do.float(), lse, **kw)
        for leaf, ref in zip(leaves, want):
            assert leaf.grad.dtype == dtype and leaf.grad.shape == leaf.shape
            err = (leaf.grad.float() - ref).abs()
            assert bool((err <= atol * ref.abs().max() + rtol * ref.abs()).all()), \
                float(err.max())


@pytest.mark.cuda
def test_backward_refuses_head_dim_256(cuda_device):
    """Under autograd a head_dim the backward kernel does not take raises
    before the forward runs."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 4, 4, 16, 16, 256, seed=0)
    q.requires_grad_(True)
    before = tattn.flash_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(q, k, v)
    assert tattn.flash_attention.launches == before


@pytest.mark.cuda
def test_backward_is_once_differentiable(cuda_device):
    """The backward kernel's grads carry no graph of their own: a second
    order gradient raises instead of coming out wrong."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 4, 4, 16, 16, 64, seed=0)
    q.requires_grad_(True)
    out = tattn.flash_attention(q, k, v)
    do = torch.ones_like(out, requires_grad=True)
    (dq,) = torch.autograd.grad(out, q, do, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def _backward_case(dtype, b, h, hkv, sq, sk, d, seed):
    q, k, v = _qkv(torch.device("cuda"), dtype, b, h, hkv, sq, sk, d, seed=seed)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                     device="cuda").to(dtype)
    return q, k, v, do


def _check_backward(q, k, v, do, kw):
    """The backward kernel from the training forward's o and lse against
    attention_backward_reference under BWD_TOL; returns its (dq, dk, dv)."""
    out, lse = tattn._flash_cuda(q, k, v, kw.get("causal", True), kw.get("scale"),
                                 kw.get("logit_softcap", 0.0), kw.get("window", 0),
                                 with_lse=True)
    got = tattn.flash_attention_backward(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    want = tattn.attention_backward_reference(q.float(), k.float(), v.float(), out.float(),
                                              do.float(), lse, **kw)
    atol, rtol = BWD_TOL[q.dtype]
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == q.dtype and x.shape == ref.shape
        err = (x.float() - ref).abs()
        assert bool(torch.isfinite(x).all()), name
        assert bool((err <= atol * ref.abs().max() + rtol * ref.abs()).all()), \
            (name, kw, float(err.max()))
    return got


# (dtype, B, H, Hkv, Sq, Sk): the backward at Sq != Sk both ways and at
# lengths one short of and one past its 64-row q tiles and 128-key tiles.
# Every case has a query that sees two keys or more: where each query sees
# one key the true dq and dk are zero, and the reference holds fp32 noise.
BWD_RAGGED_CASES = [
    (torch.bfloat16, 1, 4, 2, 63, 127), (torch.bfloat16, 1, 4, 2, 65, 129),
    (torch.bfloat16, 1, 4, 2, 129, 65), (torch.bfloat16, 1, 4, 4, 127, 255),
    (torch.bfloat16, 1, 4, 1, 255, 129), (torch.bfloat16, 2, 4, 2, 3, 2),
    (torch.bfloat16, 1, 4, 4, 200, 7), (torch.bfloat16, 1, 4, 2, 7, 200),
    (torch.float32, 1, 4, 2, 63, 129), (torch.float32, 1, 4, 2, 129, 63),
    (torch.float32, 1, 4, 4, 65, 127),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,hkv,sq,sk", BWD_RAGGED_CASES)
@pytest.mark.parametrize("d", [64, 96, 128])
def test_backward_ragged_and_unequal_lengths(cuda_device, dtype, b, h, hkv, sq, sk, d):
    """Any Sq/Sk through the backward: TMA zero-fills past the lengths and
    the atomics must skip the rows and keys past them; causal is top-left
    aligned, and with a window some rows of Sq > Sk see no key at all."""
    q, k, v, do = _backward_case(dtype, b, h, hkv, sq, sk, d, seed=sq * 1000 + sk + d)
    for kw in ({}, {"causal": False}, {"window": 50},
               {"scale": d ** -0.5, "logit_softcap": 30.0, "window": 100}):
        _check_backward(q, k, v, do, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,hkv", [(torch.bfloat16, 128, 2), (torch.bfloat16, 96, 8),
                                         (torch.bfloat16, 64, 4), (torch.bfloat16, 32, 2),
                                         (torch.float32, 128, 2)])
def test_backward_runs_agree(cuda_device, dtype, d, hkv):
    """Two backward runs on the same inputs: within BWD_TOL of each other
    where atomics sum (bf16 at head_dim 64-128), bit for bit where the sums
    have a fixed order (fp32, bf16 at head_dim 32)."""
    q, k, v, do = _backward_case(dtype, 2, 8, hkv, 512, 512, d, seed=d + hkv)
    first = _check_backward(q, k, v, do, {})
    second = _check_backward(q, k, v, do, {})
    atol, rtol = BWD_TOL[dtype]
    for x, y in zip(first, second):
        if dtype == torch.float32 or d == 32:
            assert torch.equal(x, y)
        else:
            err = (x.float() - y.float()).abs()
            assert bool((err <= atol * y.float().abs().max() + rtol * y.float().abs()).all())


@pytest.mark.cuda
def test_backward_training_shape_through_autograd(cuda_device):
    """chip_smoke.py's BWD_CASES training shape (Llama-3-8B's attention: q
    [1, 32, 2048, 128] bf16, 8 kv heads, causal) through
    FlashAttentionFunction: one forward and one backward launch, and the
    gradients within BWD_TOL of attention_backward_reference."""
    q, k, v, do = _backward_case(torch.bfloat16, 1, 32, 8, 2048, 2048, 128, seed=2000)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (tattn.flash_attention.launches, tattn.flash_attention_backward.launches)
    out = tattn.flash_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    assert (tattn.flash_attention.launches, tattn.flash_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    _, lse = tattn._flash_cuda(q, k, v, True, None, 0.0, 0, with_lse=True)
    want = tattn.attention_backward_reference(q.float(), k.float(), v.float(),
                                              out.detach().float(), do.float(), lse)
    atol, rtol = BWD_TOL[torch.bfloat16]
    for leaf, ref in zip(leaves, want):
        err = (leaf.grad.float() - ref).abs()
        assert bool((err <= atol * ref.abs().max() + rtol * ref.abs()).all()), float(err.max())
