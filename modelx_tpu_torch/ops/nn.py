"""Shared dense-layer primitives (counterpart of ``modelx_tpu/ops/nn.py``).

Matmuls accumulate in fp32 (on the card, cuBLAS's compute type for bf16
operands; fp32 operands stay full fp32 with TF32 off) and the result is
cast to the activation dtype before the bias is added, as the JAX twin
does. The int8 ``QTensor`` branch comes with the quantization slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w.T (+ b) with w stored [out, in] (torch Linear layout)."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"linear over {type(w).__name__} weights (int8 QTensor) comes with "
            "the int8 weight-only quantization slice"
        )
    y = F.linear(x, w).to(x.dtype)
    return y if b is None else y + b
