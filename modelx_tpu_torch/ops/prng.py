"""The part of ``jax.random`` the sampler draws from, in torch integer ops.

Counterpart of what ``modelx_tpu/ops/sampling.py`` calls in ``jax.random``
(jax 0.9.0, ``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True``), bit for bit, so a seeded sampled
request draws the same tokens from either package. The port may not import
JAX, so it keeps its own copy:

- ``threefry2x32``: the Threefry-2x32 block cipher, 20 rounds;
- ``PRNGKey(0)``: key data ``[0, 0]``;
- ``fold_in``: the key hashed with ``[0, data]``;
- ``bits``: 32-bit draws in the partitionable counter layout (element i
  hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and xors the halves);
- ``uniform``: float32 in ``[minval, maxval)`` from the top 23 bits;
- ``gumbel`` in mode "low": ``-log(-log(uniform(tiny, 1)))``;
- ``categorical``: argmax of logits plus Gumbel noise.

Keys are int64 tensors whose last dimension holds the two uint32 words;
every word is kept in ``[0, 2**32)`` by masking after each add and shift,
because torch's ``uint32`` has thin op coverage on CUDA.

``log`` is XLA's CPU float32 logarithm (a Cephes polynomial whose
multiply-adds the compiler fuses), not ``torch.log``: the two differ in the
last bit for about one input in seven, and the Gumbel noise must match the
reference's bits. Each fused multiply-add runs in float64 and rounds once to
float32; both steps are correctly rounded on the CPU and the card, so the
card draws the same bits as the CPU.
"""

from __future__ import annotations

import struct

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000  # float32 1.0
FLOAT32_TINY = torch.finfo(torch.float32).tiny  # 2**-126, the smallest normal


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Key data of ``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32)
    (JAX's 32-bit default): ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter pair (x1, x2) under key (k1, k2); all
    int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2] and data (an int or a tensor
    that broadcasts against ``key[..., 0]``, taken modulo 2**32) -> the new
    keys [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: [..., n] int64 of uint32
    values for keys [..., 2]."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0:1], key[..., 1:2], counts >> 32, counts & MASK32)
    return y1 ^ y2


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add does: the
    product of two float32 is exact in float64."""
    return (torch.as_tensor(a, dtype=torch.float64) * b + c).to(torch.float32)


def _f32(bits32: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits32))[0]


# XLA's float32 log (Cephes): log(1 + x) on [sqrt(1/2) - 1, sqrt(2) - 1] as
# x - x^2/2 + x^3 * P(x), and the exponent e added back as e*Q2 + e*Q1
_LOG_P = tuple(_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
    0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOG_Q1 = _f32(0xB95E8083)
_LOG_Q2 = 0.693359375
_SQRT_HALF = _f32(0x3F3504F3)


def log(a: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 natural log, bit for bit: subnormal inputs read as
    0 (-inf), negatives and NaN give NaN, +inf gives +inf."""
    a = a.to(torch.float32)
    b = torch.clamp(a, min=FLOAT32_TINY).view(torch.int32)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    m = ((b & -0x7F800001) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    out = _fma(e, _LOG_Q2, _fma(-0.5, x2, x) + y)
    out = torch.where(a < FLOAT32_TINY, float("-inf"), out)
    out = torch.where(a == float("inf"), float("inf"), out)
    return torch.where((a < 0) | torch.isnan(a), float("nan"), out)


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for keys
    [..., 2] -> [..., n] float32."""
    mantissa = (bits(key, n) >> 9) | _ONE_BITS  # < 2**31: exact in int32
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.clamp(_fma(floats, float(span), float(lo)), min=float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32, mode="low")``."""
    return -log(-log(uniform(key, n, FLOAT32_TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Row i of ``logits`` [B, V] sampled with ``keys[i]`` (keys [B, 2]), as
    ``jax.vmap(jax.random.categorical)(keys, logits)`` does: the argmax of
    the float32 logits plus Gumbel noise. Returns [B] int64."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
