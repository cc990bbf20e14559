"""Stream safetensors byte ranges into device memory (single device).

Counterpart of ``modelx_tpu/dl/loader.py`` (``LocalFileSource :340``,
``LoadStats :530``, ``load_safetensors :647``). Each tensor's byte range is
read into a pinned host staging buffer and copied to the card with a
``non_blocking`` copy on a side stream; a ring of staging buffers lets the
read of one chunk overlap the copy of the one before it. The bytes are
viewed as the tensor's dtype on the device, so BF16 never passes through
numpy. No mesh, int8 quantization or HTTP source yet: those come with the
multi-device, quantization and registry-deploy slices.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time

import numpy as np
import torch

from modelx_tpu_torch.dl import safetensors as st

STAGING_CHUNK = 64 << 20  # bytes per pinned staging buffer
STAGING_BUFFERS = 4


class LocalFileSource:
    """Positional reads from one local file."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)

    def read_range(self, offset: int, length: int, out=None):
        """Read ``length`` bytes at ``offset`` into ``out`` (a writable
        buffer of at least ``length`` bytes), or into a new uint8 array."""
        buf = np.empty(length, np.uint8) if out is None else out
        view = memoryview(buf).cast("B")[:length]
        n = 0
        while n < length:
            got = os.preadv(self._fd, [view[n:]], offset + n)
            if got <= 0:
                break
            n += got
        if n != length:
            raise OSError(f"short read of {self.path}: want {length}, got {n}")
        return buf

    def close(self) -> None:
        os.close(self._fd)


@dataclasses.dataclass
class LoadStats:
    bytes_to_device: int = 0
    tensors: int = 0
    fetch_seconds: float = 0.0  # host time spent in reads
    total_seconds: float = 0.0

    @property
    def gbps(self) -> float:
        return self.bytes_to_device / max(self.total_seconds, 1e-9) / 1e9


class _Staging:
    """A ring of pinned host buffers, each guarded by the event of the last
    copy out of it, feeding non_blocking host-to-device copies on one side
    stream."""

    def __init__(self, device: torch.device) -> None:
        self.stream = torch.cuda.Stream(device=device)
        self.bufs = [torch.empty(STAGING_CHUNK, dtype=torch.uint8, pin_memory=True)
                     for _ in range(STAGING_BUFFERS)]
        self.events: list[torch.cuda.Event | None] = [None] * STAGING_BUFFERS
        self.next = 0

    def acquire(self) -> tuple[int, torch.Tensor]:
        i = self.next
        self.next = (i + 1) % STAGING_BUFFERS
        if self.events[i] is not None:
            self.events[i].synchronize()  # its previous copy has landed
        return i, self.bufs[i]

    def copy(self, i: int, dst: torch.Tensor, n: int) -> None:
        with torch.cuda.stream(self.stream):
            dst.copy_(self.bufs[i][:n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[i] = ev

    def finish(self) -> None:
        self.stream.synchronize()


def load_safetensors(
    source,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
) -> tuple[dict[str, torch.Tensor], LoadStats]:
    """Load every tensor of one safetensors blob onto ``device``. The header
    is read with two small ranged reads. ``dtype`` casts floating tensors on
    the device after the copy (serving an fp32 checkpoint in bf16, or the
    reverse); integer tensors keep theirs."""
    t0 = time.monotonic()
    device = torch.device(device)
    stats = LoadStats()
    (hlen,) = struct.unpack("<Q", bytes(source.read_range(0, 8)))
    tensors = st.parse_header(bytes(source.read_range(8, hlen)))
    data_offset = 8 + hlen
    staging = _Staging(device) if device.type == "cuda" else None
    raw: dict[str, torch.Tensor] = {}
    for name, info in tensors.items():
        n = info.nbytes
        if staging is None:
            dst = torch.empty(n, dtype=torch.uint8)
            tf = time.monotonic()
            source.read_range(data_offset + info.start, n, dst.numpy())
            stats.fetch_seconds += time.monotonic() - tf
        else:
            dst = torch.empty(n, dtype=torch.uint8, device=device)
            for off in range(0, n, STAGING_CHUNK):
                m = min(STAGING_CHUNK, n - off)
                i, buf = staging.acquire()
                tf = time.monotonic()
                source.read_range(data_offset + info.start + off, m, buf.numpy())
                stats.fetch_seconds += time.monotonic() - tf
                staging.copy(i, dst[off:off + m], m)
        raw[name] = dst
        stats.bytes_to_device += n
        stats.tensors += 1
    if staging is not None:
        staging.finish()
    out = {}
    for name, info in tensors.items():
        t = raw.pop(name).view(info.torch_dtype()).reshape(info.shape)
        if dtype is not None and t.is_floating_point() and t.dtype != dtype:
            t = t.to(dtype)
        out[name] = t
    stats.total_seconds = time.monotonic() - t0
    return out, stats
