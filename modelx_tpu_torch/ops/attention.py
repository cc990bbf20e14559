"""Attention: the plain PyTorch reference and the Hopper flash kernel's wrapper.

Counterpart of ``modelx_tpu/ops/attention.py``. ``attention_reference`` is
the plain version every path is held against; ``flash_attention`` launches
the hand-written CUDA kernel (``csrc/flash_attention.cu``) for CUDA tensors
and runs the plain version for CPU tensors — nothing else. Under autograd
(training) it runs ``FlashAttentionFunction``: the forward kernel also
writes each row's log-sum-exp, and the backward is the hand-written kernel
of ``csrc/flash_attention_bwd.cu`` (``flash_attention_backward``), held to
``attention_backward_reference``.

Sequence parallelism (``ring_attention``, ``ulysses_attention``) takes
each rank's [B, H, S/n, D] shards of q, k and v over a mesh axis and
returns its shard of the output. The ring rotates k/v to the next rank
with ``batch_isend_irecv`` and merges each block in plain torch, as the
reference's ring merges in ``jnp``; Ulysses turns sequence shards into
head shards with ``all_to_all_single`` and runs the flash kernel on each
rank's [B, H/n, S, D].
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
# keys per chunk of the ring's per-hop merge (the reference's RING_BLOCK_K)
RING_BLOCK_K = 512

# head dims the CUDA kernel is instantiated for (csrc/flash_attention.cu;
# in bf16, 32 on the CUDA cores, the rest on the tensor cores)
KERNEL_HEAD_DIMS = (32, 64, 96, 128, 256)
# head dims of the backward kernel (csrc/flash_attention_bwd.cu): 256
# (gemma2) is on no training path
BACKWARD_HEAD_DIMS = (32, 64, 96, 128)
# the bf16 head dims the backward runs on its wgmma kernel (32 keeps the
# mma.sync pair, fp32 the CUDA cores)
BACKWARD_WGMMA_HEAD_DIMS = (64, 96, 128)
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


def _visible(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor | None:
    """[Sq, Sk] bool mask of the (query, key) pairs a query sees, queries
    from position 0 (None: every pair)."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    visible = kpos <= qpos
    if window > 0:
        visible = visible & (kpos > qpos - window)
    return visible


def _capped_logits(q, k, scale, logit_softcap):
    """fp32 scaled logits s and, with a softcap, (cap * tanh(s / cap), the
    tanh) — the tanh is the softcap's chain factor's input."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if logit_softcap > 0.0:
        t = torch.tanh(s / logit_softcap)
        return logit_softcap * t, t
    return s, None


def attention_lse_reference(q, k, v, causal: bool = True, scale: float | None = None,
                            logit_softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Plain fp32 row log-sum-exp [B, H, Sq] of the scaled, softcapped,
    masked logits (masked entries at ``NEG_INF``, as ``attention_reference``
    masks them): what the forward kernel writes for the backward. ``v`` is
    unused; the signature is the attention's."""
    del v
    q, k, _ = _repeat_kv_heads(q, k, k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits, _ = _capped_logits(q, k, scale, logit_softcap)
    visible = _visible(q.shape[2], k.shape[2], causal, window, q.device)
    if visible is not None:
        logits = logits.masked_fill(~visible, NEG_INF)
    return torch.logsumexp(logits, dim=-1)


def attention_backward_reference(q, k, v, o, do, lse, causal: bool = True,
                                 scale: float | None = None, logit_softcap: float = 0.0,
                                 window: int = 0):
    """(dq, dk, dv) of attention in the form the backward kernel computes,
    in fp32, cast to the inputs' dtypes. ``o`` is the forward's output,
    ``lse`` its row log-sum-exp [B, H, Sq] (``attention_lse_reference``),
    ``do`` the output's gradient. Per head, over the visible pairs:
    P = exp(s_c - lse); dV = P^T dO; dP = dO V^T; D = rowsum(dO * O);
    dS = P * (dP - D), times the softcap's chain factor (1 - (s_c/cap)^2);
    dQ = scale dS K; dK = scale dS^T Q; dK and dV summed over the H/Hkv
    query heads that share a kv head."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, of, dof = q.float(), o.float(), do.float()
    _, kf, vf = _repeat_kv_heads(qf, k.float(), v.float())
    s_c, t = _capped_logits(qf, kf, scale, logit_softcap)
    p = torch.exp(s_c - lse.float()[..., None])
    visible = _visible(sq, sk, causal, window, q.device)
    if visible is not None:
        p = p.masked_fill(~visible, 0.0)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    if hkv != h:
        dk = dk.reshape(b, hkv, h // hkv, sk, d).sum(2)
        dv = dv.reshape(b, hkv, h // hkv, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    itself (any Sq, Sk). When autograd records (grad enabled and q, k or v
    requiring grad) the launch goes through ``FlashAttentionFunction``,
    whose backward is the backward kernel; otherwise (serving, under
    ``torch.inference_mode``) the plain launch, with no log-sum-exp. CPU
    tensors run ``attention_reference``, which autograd differentiates.
    Anything the kernel does not take raises; there is no fallback. Each
    forward kernel launch adds one to ``flash_attention.launches``.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   logit_softcap=logit_softcap, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, logit_softcap, window)
    return _flash_cuda(q, k, v, causal, scale, logit_softcap, window)


flash_attention.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel pair as one differentiable op: the forward launches the
    forward kernel with a log-sum-exp output and saves q, k, v, o and lse;
    the backward launches the backward kernel (``flash_attention_backward``).
    A head_dim the backward kernel does not take raises before the forward
    runs; the backward is not itself differentiable (no second order)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, logit_softcap, window):
        if q.shape[-1] not in BACKWARD_HEAD_DIMS:
            raise ValueError(f"flash_attention under autograd: head_dim {q.shape[-1]} not in "
                             f"the backward kernel's {BACKWARD_HEAD_DIMS}")
        q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
        out, lse = _flash_cuda(q, k, v, causal, scale, logit_softcap, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = (causal, scale, logit_softcap, window)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, do, lse, *ctx.options)
        return dq, dk, dv, None, None, None, None


def flash_attention_backward(q, k, v, o, do, lse, causal: bool = True,
                             scale: float | None = None, logit_softcap: float = 0.0,
                             window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, its output ``o``,
    the forward kernel's row log-sum-exp ``lse`` (fp32 [B, H, Sq]) and the
    output's gradient ``do``. CUDA tensors launch the backward kernel
    (``csrc/flash_attention_bwd.cu``), adding one to
    ``flash_attention_backward.launches``; CPU tensors run
    ``attention_backward_reference``. No fallback."""
    if all(x.device.type == "cpu" for x in (q, k, v, o, do, lse)):
        return attention_backward_reference(q, k, v, o, do, lse, causal=causal, scale=scale,
                                            logit_softcap=logit_softcap, window=window)
    return _flash_bwd_cuda(q, k, v, o, do, lse, causal, scale, logit_softcap, window)


flash_attention_backward.launches = 0


def _check_operands(q, k, v, head_dims, what):
    """The checks both kernels share; returns (B, H, Hkv, Sq, Sk, D)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError(
            f"{what}: q/k/v must share one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"{what}: q/k/v must all be bfloat16 or float32, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"{what}: want q [B,H,Sq,D], k/v [B,Hkv,Sk,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or h % hkv:
        raise ValueError(
            f"{what}: kv shape {tuple(k.shape)} does not fit q "
            f"{tuple(q.shape)} (need H % Hkv == 0)"
        )
    if d not in head_dims:
        raise ValueError(f"{what}: head_dim {d} not in {head_dims}")
    if sq == 0 or sk == 0 or b * h == 0:
        raise ValueError(f"{what}: empty q or kv")
    if b * h * -(-sq // 64) > 2**31 - 1 or -(-sq // 64) > 65535 or -(-sk // 64) > 65535:
        raise ValueError(f"{what}: too many q or kv tiles for {tuple(q.shape)}, {tuple(k.shape)}")
    return b, h, hkv, sq, sk, d


def _flash_cuda(q, k, v, causal, scale, logit_softcap, window, lib=None, with_lse=False):
    """Check the operands and launch the kernel of ``lib`` (by default the
    port's own library, built on first use). Returns out, or (out, lse)
    ``with_lse``."""
    b, h, hkv, sq, sk, d = _check_operands(q, k, v, KERNEL_HEAD_DIMS, "flash_attention")
    if lib is None:
        from modelx_tpu_torch.kernels.build import load_library

        lib = load_library()
    q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
    out = torch.empty_like(q)
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_KERNEL_DTYPES[q.dtype], b, h, hkv, sq, sk, d, float(sm_scale),
            float(logit_softcap), int(bool(causal)), int(window), stream)
    lse = None
    with torch.cuda.device(q.device):
        if with_lse:
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
            err = lib.mx_flash_attention_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), lse.data_ptr(), *args)
        else:
            err = lib.mx_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), *args)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def backward_workspace_floats(dtype, b: int, h: int, hkv: int, sq: int, sk: int, d: int) -> int:
    """fp32 elements of the scratch the backward kernel takes (its C entry's
    ``ws``): D_i, ``b * h * sq``, for fp32 and bf16 at head_dim 32; for the
    bf16 wgmma kernel, D_i and lse * log2(e) at a row stride padded to 64,
    the fp32 dQ accumulator [b, h, sq, d] and, when ``hkv != h``, the dK and
    dV accumulators [b, hkv, sk, d] each."""
    if dtype != torch.bfloat16 or d not in BACKWARD_WGMMA_HEAD_DIMS:
        return b * h * sq
    sqp = -(-sq // 64) * 64
    n = 2 * b * h * sqp + b * h * sq * d
    return n + (2 * b * hkv * sk * d if hkv != h else 0)


def _flash_bwd_cuda(q, k, v, o, do, lse, causal, scale, logit_softcap, window, lib=None):
    """Check the operands and launch the backward kernel of ``lib`` (by
    default the port's own library): three launches on the current stream
    (bf16 at head_dim 64-128: the pre-pass, the wgmma kernel, the post-pass;
    else D_i, dK/dV, dQ)."""
    b, h, hkv, sq, sk, d = _check_operands(q, k, v, BACKWARD_HEAD_DIMS,
                                           "flash_attention_backward")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_backward: o {tuple(o.shape)} {o.dtype} and do "
            f"{tuple(do.shape)} must be q's shape {tuple(q.shape)} and dtype {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse must be fp32 {(b, h, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(x.device != q.device for x in (o, do, lse)):
        raise ValueError("flash_attention_backward: every operand on q's device")
    if lib is None:
        from modelx_tpu_torch.kernels.build import load_library

        lib = load_library()
    q, k, v, o, do, lse = (_aligned(x.contiguous()) for x in (q, k, v, o, do.to(q.dtype), lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(backward_workspace_floats(q.dtype, b, h, hkv, sq, sk, d),
                     dtype=torch.float32, device=q.device)
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        err = lib.mx_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), ws.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, hkv, sq, sk, d, float(sm_scale),
            float(logit_softcap), int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def _aligned(x):
    """The kernel reads 16-byte vectors: a view at an odd storage offset
    gets its own allocation."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


# -- sequence parallelism -----------------------------------------------------


def _axis_group(mesh, axis: str):
    """(group, size, index) of this rank's line along ``axis``."""
    return mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True, block_k: int = 0):
    """Ring attention over a sequence-sharded mesh axis (counterpart of
    ``modelx_tpu/ops/attention.py:195``).

    q/k/v: this rank's [B, H(kv), S/n, D] shards; rank i of the axis holds
    tokens [i S/n, (i+1) S/n). The rank merges flash statistics against its
    resident k/v, then receives the previous rank's block while it sends
    its own to the next, n-1 hops: numerically full attention with O(S/n)
    memory and neighbour-only traffic. Causal hops whose whole block lies
    after this rank's last query are skipped. Returns this rank's output
    shard [B, H, S/n, D] in q's dtype."""
    group, n, idx = _axis_group(mesh, axis)
    bk = block_k or RING_BLOCK_K
    b, h, s_local, d = q.shape
    q_start = idx * s_local
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for i in range(n):
        reqs = []
        if i < n - 1:
            import torch.distributed as dist

            k_nxt, v_nxt = torch.empty_like(k_cur), torch.empty_like(v_cur)
            nxt = dist.get_global_rank(group, (idx + 1) % n)
            prv = dist.get_global_rank(group, (idx - 1) % n)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_cur, nxt, group), dist.P2POp(dist.isend, v_cur, nxt, group),
                dist.P2POp(dist.irecv, k_nxt, prv, group), dist.P2POp(dist.irecv, v_nxt, prv, group),
            ])
        k_start = ((idx - i) % n) * s_local  # whose block this rank holds now
        if not causal or k_start <= q_start + s_local - 1:
            acc, m, l_sum = _merge_block(q, k_cur, v_cur, acc, m, l_sum, q_offset=q_start,
                                         k_offset=k_start, causal=causal, block_k=bk)
        for r in reqs:
            r.wait()
        if reqs:
            k_cur, v_cur = k_nxt, v_nxt
    return (acc / torch.clamp(l_sum, min=1e-30)[..., None]).to(q.dtype)


def _merge_block(q, k, v, acc, m_prev, l_prev, q_offset, k_offset, causal,
                 block_k: int = RING_BLOCK_K):
    """Merge one k/v block into running flash statistics (reference
    ``:300``). All [B, H, S, D]; kv heads repeat to q's. The block is
    consumed in ``block_k``-key chunks with the online softmax carried
    across chunks: peak memory O(s_q x block_k), not O(s_q x s_k)."""
    q32, k32, v32 = (x.float() for x in _repeat_kv_heads(q, k, v))
    q32 = q32 * (1.0 / math.sqrt(q.shape[-1]))
    s_k = k32.shape[2]
    bk = min(block_k, s_k)
    if s_k % bk:
        bk = s_k  # odd block sizes: one chunk (correctness over tiling)
    qpos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
    for i in range(s_k // bk):
        k_blk = k32[:, :, i * bk:(i + 1) * bk]
        v_blk = v32[:, :, i * bk:(i + 1) * bk]
        s = torch.matmul(q32, k_blk.transpose(-1, -2))
        if causal:
            kpos = k_offset + i * bk + torch.arange(bk, device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new[..., None])
        l_prev = l_prev * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v_blk)
        m_prev = m_new
    return acc, m_prev, l_prev


def _all_to_all(x, group, n: int, split_dim: int, cat_dim: int):
    """Tiled all-to-all over ``group``: ``x`` splits into n pieces along
    ``split_dim``, piece j goes to rank j, and the pieces received
    concatenate (in source order) along ``cat_dim``."""
    import torch.distributed as dist

    pieces = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()  # [n, ...]
    out = torch.empty_like(pieces)
    dist.all_to_all_single(out, pieces, group=group)
    return torch.cat(out.unbind(0), dim=cat_dim)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True):
    """Ulysses/DeepSpeed-style sequence parallelism via all-to-all
    (counterpart of ``modelx_tpu/ops/attention.py:257``).

    q/k/v: this rank's [B, H(kv), S/n, D] shards. Two all-to-alls re-shard
    from sequence to heads: each rank then holds H/n heads over the FULL
    sequence and runs ``flash_attention`` (the hand-written kernel on the
    card) on them, and a final all-to-all restores its sequence shard.
    Needs H % n == 0; kv heads that do not divide n repeat only up to
    lcm(Hkv, n)."""
    group, n, _ = _axis_group(mesh, axis)
    if q.shape[1] % n:
        raise ValueError(f"ulysses needs heads % {axis}={n} == 0, got {q.shape[1]}")
    hkv = k.shape[1]
    if hkv % n:
        rep = ((n * hkv) // math.gcd(n, hkv)) // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if n == 1:
        return flash_attention(q, k, v, causal=causal)
    # [B, H, S/n, D] -> [B, H/n, S, D]: split heads, gather sequence
    qh, kh, vh = (_all_to_all(x, group, n, split_dim=1, cat_dim=2) for x in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=causal)
    # [B, H/n, S, D] -> [B, H, S/n, D]
    return _all_to_all(out, group, n, split_dim=2, cat_dim=1)
