"""Attention: the plain PyTorch reference and the Hopper flash kernel's wrapper.

Counterpart of ``modelx_tpu/ops/attention.py``. ``attention_reference`` is
the plain version every path is held against; ``flash_attention`` launches
the hand-written CUDA kernel (``csrc/flash_attention.cu``) for CUDA tensors
and runs the plain version for CPU tensors — nothing else. Ring and
Ulysses attention come with the multi-device slice.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

# head dims the CUDA kernel is instantiated for (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = (64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q, k, v, causal: bool = True, q_offset=0,
                        scale: float | None = None, logit_softcap: float = 0.0,
                        window: int = 0):
    """Plain softmax(QK^T * scale)V. Shapes: [B, H, S, D]; kv may have fewer
    heads than q (GQA) as long as H % Hkv == 0. ``q_offset`` positions the
    queries for cached decode: an int, or a [B] tensor for ragged batches.

    ``scale`` defaults to 1/sqrt(head_dim). ``logit_softcap`` > 0 applies
    cap * tanh(logits / cap) BEFORE masking. ``window`` > 0 limits each
    query to its last ``window`` keys (needs ``causal``). Logits are fp32;
    probs are cast to v's dtype before the PV product, as the JAX twin does.
    """
    q, k, v = _repeat_kv_heads(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if causal:
        qlen, klen = q.shape[2], k.shape[2]
        qpos = torch.arange(qlen, device=q.device)[:, None]  # [Q,1]
        if isinstance(q_offset, torch.Tensor) and q_offset.ndim:
            qpos = qpos + q_offset.to(q.device)[:, None, None, None]  # [B,1,Q,1]
        else:
            qpos = qpos + int(q_offset)
        kpos = torch.arange(klen, device=q.device)[None, :]
        visible = kpos <= qpos
        if window > 0:  # keys qpos-window < kpos <= qpos stay visible
            visible = visible & (kpos > qpos - window)
        logits = logits.masked_fill(~visible, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _repeat_kv_heads(q, k, v):
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return q, k, v


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    logit_softcap: float = 0.0, window: int = 0):
    """Flash attention. q: [B, H, Sq, D], k/v: [B, Hkv, Sk, D] (GQA allowed).

    CUDA tensors launch the hand-written kernel, which indexes kv head
    ``h // (H / Hkv)`` instead of repeating kv and masks the ragged edge
    itself (any Sq, Sk). CPU tensors run ``attention_reference``. Anything
    the kernel does not take raises; there is no fallback. Each kernel
    launch adds one to ``flash_attention.launches``.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   logit_softcap=logit_softcap, window=window)
    return _flash_cuda(q, k, v, causal, scale, logit_softcap, window)


flash_attention.launches = 0


def _flash_cuda(q, k, v, causal, scale, logit_softcap, window):
    if not (q.is_cuda and k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q/k/v must share one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash_attention: q/k/v must all be bfloat16 or float32, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: want q [B,H,Sq,D], k/v [B,Hkv,Sk,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or h % hkv:
        raise ValueError(
            f"flash_attention: kv shape {tuple(k.shape)} does not fit q "
            f"{tuple(q.shape)} (need H % Hkv == 0)"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if sq == 0 or sk == 0 or b * h == 0:
        raise ValueError("flash_attention: empty q or kv")
    if b * h > 2**31 - 1 or -(-sq // 64) > 65535:
        raise ValueError(f"flash_attention: grid too large for {tuple(q.shape)}")
    from modelx_tpu_torch.kernels.build import load_library

    lib = load_library()
    q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
    out = torch.empty_like(q)
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.mx_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, hkv, sq, sk, d,
            float(sm_scale), float(logit_softcap), int(bool(causal)), int(window),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def _aligned(x):
    """The kernel reads 16-byte vectors: a view at an odd storage offset
    gets its own allocation."""
    return x if x.data_ptr() % 16 == 0 else x.clone()

