"""Shared dense-layer primitives (counterpart of ``modelx_tpu/ops/nn.py``).

Matmuls accumulate in fp32 (on the card, cuBLAS's compute type for bf16
operands; fp32 operands stay full fp32 with TF32 off) and the result is
cast to the activation dtype before the bias is added, as the JAX twin
does.

An int8 ``QTensor`` weight multiplies against its codes cast to the
activation dtype (exact: every int8 is a bf16) and its per-output-channel
scale multiplies the fp32 product before the one cast to the activation
dtype, as the JAX twin's ``preferred_element_type=float32`` epilogue does.
On the card a bf16 product lands in fp32 through ``torch.mm(...,
out_dtype=torch.float32)``; on the CPU the operands are widened to fp32,
whose products of bf16 values are exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from modelx_tpu_torch.ops.quant import QTensor


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Statistics in fp32 (the biased variance), cast back, THEN the affine
    in the activation dtype, as the JAX twin does."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w.T (+ b) with w stored [out, in] (torch Linear layout);
    ``w`` may be an int8 ``QTensor`` (weight-only quantization)."""
    if isinstance(w, QTensor):
        y = (_int8_product(x, w.q) * w.scale).to(x.dtype)
    else:
        y = F.linear(x, w).to(x.dtype)
    return y if b is None else y + b


def _int8_product(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x @ q.T as fp32 [..., out]."""
    if x.dtype == torch.float32 or not x.is_cuda:
        return F.linear(x.float(), q.float())
    codes = q.to(x.dtype)  # a transient copy of the weight in the activation dtype
    y = torch.mm(x.reshape(-1, x.shape[-1]), codes.T, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], q.shape[0])


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w (+ b) with w stored [in, out] (HF GPT-2's Conv1D layout)."""
    y = torch.matmul(x, w).to(x.dtype)
    return y if b is None else y + b
