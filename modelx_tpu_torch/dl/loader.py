"""Stream safetensors byte ranges into device memory (single device).

Counterpart of ``modelx_tpu/dl/loader.py`` (``LocalFileSource :340``,
``LoadStats :530``, ``load_safetensors :647``). Each tensor's byte range is
read into a pinned host staging buffer and copied to the card with a
``non_blocking`` copy on a side stream; a ring of staging buffers lets the
read of one chunk overlap the copy of the one before it. The bytes are
viewed as the tensor's dtype on the device, so BF16 never passes through
numpy. ``quantize="int8"`` turns the big matmul weights into ``QTensor``s
on the device, each right after its bytes land there: the link carries the
checkpoint's bytes and device memory keeps the int8 codes. No mesh or HTTP
source yet: those come with the multi-device and registry-deploy slices.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time

import numpy as np
import torch

from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.ops import quant

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
    bytes_to_device: int = 0  # over the link: the checkpoint's bytes
    bytes_resident: int = 0  # kept in device memory (int8 codes + scales when quantized)
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
    quantize: str | None = None,
) -> tuple[dict, LoadStats]:
    """Load every tensor of one safetensors blob onto ``device``. The header
    is read with two small ranged reads. ``dtype`` casts floating tensors on
    the device after the copy (serving an fp32 checkpoint in bf16, or the
    reverse); integer tensors keep theirs. ``quantize="int8"`` quantizes each
    eligible weight (2-D, a name ``quant.DEFAULT_ELIGIBLE`` matches) from its
    stored values, before any cast, and returns it as a ``QTensor``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    t0 = time.monotonic()
    device = torch.device(device)
    stats = LoadStats()
    (hlen,) = struct.unpack("<Q", bytes(source.read_range(0, 8)))
    tensors = st.parse_header(bytes(source.read_range(8, hlen)))
    data_offset = 8 + hlen
    staging = _Staging(device) if device.type == "cuda" else None
    raw: dict[str, torch.Tensor] = {}
    out: dict = {}
    for name, info in tensors.items():
        n = info.nbytes
        if staging is None:
            dst = torch.empty(n, dtype=torch.uint8)
            tf = time.monotonic()
            source.read_range(data_offset + info.start, n, dst.numpy())
            stats.fetch_seconds += time.monotonic() - tf
        else:
            dst = torch.empty(n, dtype=torch.uint8, device=device)
            if quantize:
                # dst may reuse the block of a tensor quantized before it:
                # copy into it only after that quantize has read it
                staging.stream.wait_stream(torch.cuda.current_stream(device))
            for off in range(0, n, STAGING_CHUNK):
                m = min(STAGING_CHUNK, n - off)
                i, buf = staging.acquire()
                tf = time.monotonic()
                source.read_range(data_offset + info.start + off, m, buf.numpy())
                stats.fetch_seconds += time.monotonic() - tf
                staging.copy(i, dst[off:off + m], m)
        stats.bytes_to_device += n
        stats.tensors += 1
        if quantize and len(info.shape) == 2 and quant.DEFAULT_ELIGIBLE.search(name):
            if staging is not None:
                # quantize on the compute stream once this tensor's copies
                # landed; its bytes are then freed, one tensor at a time
                torch.cuda.current_stream(device).wait_stream(staging.stream)
            out[name] = quant.quantize_tensor(dst.view(info.torch_dtype()).reshape(info.shape))
        else:
            raw[name] = dst
    if staging is not None:
        staging.finish()
    for name, info in tensors.items():
        if name in out:
            continue
        t = raw.pop(name).view(info.torch_dtype()).reshape(info.shape)
        if dtype is not None and t.is_floating_point() and t.dtype != dtype:
            t = t.to(dtype)
        out[name] = t
    out = {name: out[name] for name in tensors}  # the header's order
    stats.bytes_resident = sum(t.nbytes for t in out.values())
    stats.total_seconds = time.monotonic() - t0
    return out, stats
