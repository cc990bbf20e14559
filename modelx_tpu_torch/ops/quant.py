"""Weight-only int8 quantization for serving (counterpart of
``modelx_tpu/ops/quant.py``).

Symmetric per-output-channel int8: ``w ≈ q * scale[:, None]`` with
``q ∈ [-127, 127]``. The matmul runs in the activation dtype against the
int8 codes and the per-channel scale multiplies the fp32 accumulator
(``ops/nn.linear``), so the change is half the weight bytes in device
memory.

The rule gives the JAX package's bytes: the scale is ``amax / 127 +
(amax == 0)`` in fp32, the codes are ``rint(w * (1 / scale))`` (the fp32
reciprocal, not a divide; ``rint`` rounds half to even) clipped to ±127.
The numpy functions below are the host rule, copied from the JAX package,
and run through the native engine's fused GIL-free pass
(``native.quantize_rows``) when it is built, as the JAX package's do;
``quantize_tensor`` is the same rule in torch ops. The port's int8 load
quantizes on the device (``dl/loader.py`` calls ``quantize_tensor`` right
after a weight's bytes land there), so the host rule serves tests and
serve-time callers, not the load.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

# weights worth quantizing: the big attention + mlp matmuls ([out, in]
# torch layout), including phi3's fused qkv_proj/gate_up_proj. Anchored on
# the preceding dot so the fused names match by intent, not by suffix
# accident. Embeddings/norms/expert stacks stay full precision.
DEFAULT_ELIGIBLE = re.compile(
    r"(\.(q|k|v|o|qkv)_proj|\.(gate|up|gate_up|down)_proj|(^|\.)lm_head)"
    r"\.weight$"
)


@dataclasses.dataclass
class QTensor:
    """int8 weight + per-output-channel scale; drop-in for a 2-D weight in
    ``ops.nn.linear``."""

    q: torch.Tensor  # int8 [out, in]
    scale: torch.Tensor  # fp32 [out]

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def to(self, device) -> "QTensor":
        return QTensor(q=self.q.to(device), scale=self.scale.to(device))


def _native_quant(w, scales=None, want_q: bool = True):
    """The native fused pass (``modelx_io.cc mx_quantize_rows``) when the
    engine and the dtype allow, else None. One GIL-free pass replaces
    several numpy passes; bfloat16 comes as a CPU ``torch.bfloat16``
    tensor."""
    from modelx_tpu_torch import native

    return native.quantize_rows(w, scales=scales, want_q=want_q)


def _f32(w) -> np.ndarray:
    """``w`` as an fp32 numpy array (a torch tensor by way of the CPU)."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def channel_scales(w) -> np.ndarray:
    """Per-output-channel symmetric scale (f32 [out]) for an [out, in] weight."""
    got = _native_quant(w, want_q=False)
    if got is not None:
        return got[1]
    w32 = _f32(w)
    amax = np.max(np.abs(w32), axis=1)
    return (amax / 127.0 + (amax == 0)).astype(np.float32)  # no /0 for zero rows


def quantize_rows(w, scale: np.ndarray) -> np.ndarray:
    """int8 rows of an [out_rows, in] slice given those rows' scales;
    multiplies by the f32 reciprocal (not a divide), bit-identical to the
    native pass."""
    got = _native_quant(w, scales=scale)
    if got is not None:
        return got[0]
    w32 = _f32(w)
    inv = (np.float32(1.0) / np.asarray(scale, np.float32))[:, None]
    return np.clip(np.rint(w32 * inv), -127, 127).astype(np.int8)


def quantize_fused(w) -> tuple[np.ndarray, np.ndarray]:
    """(q int8, scales f32) of a whole [out, in] weight: the native path
    reads the source once; the same bytes as channel_scales +
    quantize_rows."""
    got = _native_quant(w)
    if got is not None:
        return got
    scale = channel_scales(w)
    return quantize_rows(w, scale), scale


def quantize(w: np.ndarray) -> QTensor:
    """Host-side quantize of a full [out, in] weight (tests / serve-time)."""
    q, scale = quantize_fused(np.ascontiguousarray(w))
    return QTensor(q=torch.from_numpy(q), scale=torch.from_numpy(scale))


def quantize_tensor(w: torch.Tensor, amax_reduce=None) -> QTensor:
    """The host rule in torch ops, on ``w``'s device: the same bytes as
    ``quantize`` of the same values. One fp32 copy of ``w`` is the
    transient: the codes are computed in place in it. The divisor is a
    tensor: torch divides a CUDA tensor by a Python scalar as a multiply by
    the scalar's rounded reciprocal, which is not numpy's division.
    ``amax_reduce(amax)`` turns a column slice's per-row absolute maxima
    into the whole rows' (on a mesh: the maximum over the ranks holding
    the other columns), so the slice's scales and codes are those of the
    whole weight."""
    w32 = w.to(torch.float32, copy=True)
    amax = torch.amax(torch.abs(w32), dim=1)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = amax / torch.full_like(amax, 127.0) + (amax == 0).to(torch.float32)
    inv = (torch.ones_like(scale) / scale)[:, None]
    q = w32.mul_(inv).round_().clamp_(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (t.q.to(torch.float32) * t.scale[:, None]).to(dtype)
