"""The attention gradient of the port against the JAX package, on the CPU.

The JAX package has no custom_vjp and ``jax.grad`` through its Pallas call
does not run on the CPU, so the yardstick is ``jax.vjp`` through
``modelx_tpu.ops.attention.attention_reference``. The same numpy inputs
(np.random.RandomState) go through:
- ``attention_backward_reference`` (the plain form the backward kernel
  computes: P from the row log-sum-exp, dS, the softcap's chain factor, the
  GQA sums), fed ``attention_lse_reference``'s LSE;
- ``attention_lse_reference``, held by P = exp(s_c - lse) rebuilding JAX's
  forward output (P V) — the LSE is right iff its rows of P sum to one;
- ``flash_attention`` on CPU tensors with ``requires_grad`` (the plain
  reference under autograd).

Tolerance: fp32 throughout, atol 2e-5 on gradients of magnitude ~1-10
(another summation order; the kernel's own twin is in
test_torch_kernels_cuda.py, marked ``cuda``) and 2e-6 on the rebuilt
output, as test_torch_attention.py holds the forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.ops import attention as jattn
from modelx_tpu_torch.ops import attention as tattn

GRAD_ATOL = 2e-5
OUT_ATOL = 2e-6

# (id, B, H, Hkv, S, D, kwargs)
CASES = [
    ("causal_gqa4:2_d32", 2, 4, 2, 40, 32, {}),
    ("noncausal_gqa4:2_d32", 2, 4, 2, 40, 32, {"causal": False}),
    ("causal_gqa8:1_d64", 1, 8, 1, 33, 64, {}),
    ("softcap50_window_d64", 1, 4, 2, 48, 64,
     {"scale": 0.125, "logit_softcap": 50.0, "window": 9}),
    ("ragged_s37_d128", 1, 4, 4, 37, 128, {}),
    ("noncausal_ragged_s37_d128", 1, 4, 2, 37, 128, {"causal": False}),
]


def _inputs(seed, b, h, hkv, s, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, hkv, s, d).astype(np.float32)
    v = rng.randn(b, hkv, s, d).astype(np.float32)
    do = rng.randn(b, h, s, d).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, kw):
    out, vjp = jax.vjp(lambda a, b, c: jattn.attention_reference(a, b, c, **kw),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_lse_and_backward_match_jax_vjp(case):
    _, b, h, hkv, s, d, kw = case
    q, k, v, do = _inputs(len(case[0]), b, h, hkv, s, d)
    jout, jgrads = _jax_vjp(q, k, v, do, kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))

    lse = tattn.attention_lse_reference(tq, tk, tv, **kw)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    # P = exp(s_c - lse) over the visible keys rebuilds JAX's output
    scale = kw.get("scale", d ** -0.5)
    kr = tk.repeat_interleave(h // hkv, dim=1)
    vr = tv.repeat_interleave(h // hkv, dim=1)
    logits = tq @ kr.transpose(-1, -2) * scale
    if kw.get("logit_softcap", 0.0) > 0:
        cap = kw["logit_softcap"]
        logits = cap * torch.tanh(logits / cap)
    p = torch.exp(logits - lse[..., None])
    if kw.get("causal", True):
        qpos = torch.arange(s)[:, None]
        kpos = torch.arange(s)[None, :]
        seen = kpos <= qpos
        if kw.get("window", 0) > 0:
            seen &= kpos > qpos - kw["window"]
        p = p.masked_fill(~seen, 0.0)
    np.testing.assert_allclose((p @ vr).numpy(), jout, atol=OUT_ATOL)

    out = tattn.attention_reference(tq, tk, tv, **kw)
    grads = tattn.attention_backward_reference(tq, tk, tv, out, tdo, lse, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL, err_msg=name)

    # the wrapper on CPU tensors under autograd: the plain reference's grads
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    tattn.flash_attention(*leaves, **kw).backward(tdo)
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=GRAD_ATOL, err_msg=name)


def test_backward_wrapper_takes_the_plain_version_for_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 1, 4, 2, 20, 32))
    lse = tattn.attention_lse_reference(q, k, v)
    out = tattn.attention_reference(q, k, v)
    before = tattn.flash_attention_backward.launches
    got = tattn.flash_attention_backward(q, k, v, out, do, lse)
    want = tattn.attention_backward_reference(q, k, v, out, do, lse)
    assert tattn.flash_attention_backward.launches == before  # no kernel on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_head_dims_of_the_two_kernels():
    assert 32 in tattn.KERNEL_HEAD_DIMS and 256 in tattn.KERNEL_HEAD_DIMS
    assert tattn.BACKWARD_HEAD_DIMS == (32, 64, 96, 128)


def _plain_forward_kernel(calls):
    """A stand-in for the forward kernel's launch on CPU tensors: the plain
    output (and log-sum-exp), recording each call."""
    def launch(q, k, v, causal, scale, logit_softcap, window, with_lse=False):
        calls.append(tuple(q.shape))
        kw = dict(causal=causal, scale=scale, logit_softcap=logit_softcap, window=window)
        out = tattn.attention_reference(q, k, v, **kw)
        return (out, tattn.attention_lse_reference(q, k, v, **kw)) if with_lse else out
    return launch


def test_flash_function_differentiates_once(monkeypatch):
    """FlashAttentionFunction around the forward's plain stand-in (its
    backward wrapper takes the plain version for CPU tensors): the grads
    equal autograd's through attention_reference, and a second-order
    gradient raises instead of coming out wrong."""
    calls = []
    monkeypatch.setattr(tattn, "_flash_cuda", _plain_forward_kernel(calls))
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 1, 4, 2, 24, 32))
    kw = dict(causal=True, scale=None, logit_softcap=50.0, window=8)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tattn.FlashAttentionFunction.apply(*leaves, *kw.values())
    # an output gradient on the graph (a gradient penalty's) would carry
    # the kernels' grads into a second order, where they have no graph
    grads = torch.autograd.grad(out, leaves, do.clone().requires_grad_(True),
                                create_graph=True)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tattn.attention_reference(*plain, **kw), plain, do)
    assert calls == [(1, 4, 24, 32)]
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=GRAD_ATOL,
                                   err_msg=name)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        grads[0].sum().backward()


def test_flash_function_refuses_head_dim_256_before_its_forward(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "_flash_cuda", _plain_forward_kernel(calls))
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(6, 1, 2, 2, 8, 256))
    with pytest.raises(ValueError, match="head_dim 256"):
        tattn.FlashAttentionFunction.apply(q.requires_grad_(True), k, v, True, None, 0.0, 0)
    assert calls == []


def test_backward_workspace_fits_each_kernel():
    """The scratch the backward's C entry takes (fp32 elements): D_i alone
    for fp32 and bf16 at head_dim 32; for the bf16 wgmma kernel D_i and
    lse * log2(e) at a row stride padded to 64, the dQ accumulator, and
    the dK and dV accumulators only under GQA."""
    f = tattn.backward_workspace_floats
    assert f(torch.float32, 1, 8, 2, 333, 333, 128) == 8 * 333
    assert f(torch.bfloat16, 2, 4, 2, 256, 256, 32) == 2 * 4 * 256
    # the training shape: 2 x 32 x 2048 rows, dQ 33.5 MB, dK + dV 16.8 MB
    assert f(torch.bfloat16, 1, 32, 8, 2048, 2048, 128) == (
        2 * 32 * 2048 + 32 * 2048 * 128 + 2 * 8 * 2048 * 128)
    assert f(torch.bfloat16, 1, 4, 4, 65, 129, 96) == 2 * 4 * 128 + 4 * 65 * 96
    assert f(torch.bfloat16, 2, 4, 1, 1, 7, 64) == 2 * 2 * 4 * 64 + 2 * 4 * 64 + 2 * 2 * 7 * 64

