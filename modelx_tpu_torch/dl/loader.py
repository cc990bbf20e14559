"""Stream safetensors byte ranges into device memory (single device).

Counterpart of ``modelx_tpu/dl/loader.py`` (``LocalFileSource :340``,
``HTTPSource :379``, ``_FetchGovernor :261``, ``auto_fetch_concurrency
:246``, ``_read_with_retry :225``, ``LoadStats :530``, ``load_safetensors
:647``). The tensor index comes from the manifest's ``modelx.tensor.index``
annotation when the caller has it, else from the header (two small ranged
reads). Every tensor's bytes are cut into chunks of at most
``STAGING_CHUNK``; a pool of fetch threads reads the chunks in parallel
(ranged preads of a local file, or ranged GETs on one kept-alive
connection per thread, both through the native IO engine with the GIL
released when it is built; ``LoadStats.native_reads`` counts them), each
straight into a pinned host staging buffer
(``readinto``, no intermediate ``bytes``), and copies it to the card with a
``non_blocking`` copy on a side stream; a buffer is reused once the event
of its last copy has fired, so fetches overlap the copies. A governor gates
the reads: it halves the width when local reads collapse and grows it
while remote reads show headroom. The bytes are viewed as the tensor's
dtype on the device, so BF16 never passes through numpy. ``quantize=
"int8"`` turns the big matmul weights into ``QTensor``s on the device,
tensor by tensor as they complete: the link carries the checkpoint's bytes
and device memory keeps the int8 codes. HF's per-expert MoE tensors
(``...experts.<i>.w1.weight``) load as one stacked [E, ...] tensor read
from the members' byte ranges (``fuse_expert_tensors``).

On a mesh each rank reads only the bytes of its own slices (``index``),
as the reference plans its reads from ``addressable_devices_indices_map``:
a dim-0 slice of a row-major tensor is one range, a dim-1 slice one range
per row (``_byte_runs``), and ``LoadStats`` counts this rank's bytes.
"""

from __future__ import annotations

import dataclasses
import http.client
import math
import os
import queue
import re
import struct
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.ops import quant

STAGING_CHUNK = 32 << 20  # bytes per pinned staging buffer (and per ranged read)
FETCH_RETRIES = 3  # per-read retry budget
# bytes of not-yet-complete tensors in flight before the loader waits for
# the oldest (bounds device memory held as raw bytes when quantizing)
WINDOW_BYTES = 2 << 30


def _read_with_retry(source, offset: int, length: int, out=None,
                     retries: int = FETCH_RETRIES, timer=None):
    """Ranged read with exponential backoff: a transient fetch error must
    not kill a multi-hundred-tensor load. ``timer(nbytes, seconds)`` fires
    for the successful attempt only: the fetch governor must see transfer
    time, not backoff sleeps or failed I/O."""
    for attempt in range(retries):
        t0 = time.monotonic()
        try:
            result = source.read_range(offset, length, out)
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(0.2 * (2 ** attempt))
        else:
            if timer is not None:
                timer(length, time.monotonic() - t0)
            return result


def auto_fetch_concurrency(source) -> int:
    """Fetch width from the host: local preads are memcpy-bound, so 2 a
    core (at most 8); HTTP reads wait on sockets, so 4 a core in [8, 16]."""
    cpu = os.cpu_count() or 1
    if isinstance(getattr(source, "source", source), LocalFileSource):
        return max(2, min(8, 2 * cpu))
    return max(8, min(16, 4 * cpu))


class _FetchGovernor:
    """Admission gate for fetch reads. It halves its width when measured
    per-thread throughput collapses under ``floor_bps`` and doubles it,
    up to ``max_width``, while per-thread throughput stays above
    ``growth_bps``; after 3 backoffs it stops growing. The gate is taken
    per read, so width changes apply mid-load."""

    MAX_GROWTH_BACKOFFS = 3

    def __init__(self, width: int, floor_bps: float, min_width: int = 2,
                 max_width: int = 0, growth_bps: float = 0.0) -> None:
        self.width = max(1, int(width))
        self.floor_bps = float(floor_bps)
        self.min_width = min(min_width, self.width)
        self.max_width = max(self.width, int(max_width))
        self.growth_bps = float(growth_bps)
        self._cv = threading.Condition()
        self._active = 0
        self._bytes = 0
        self._busy_s = 0.0
        self.backoffs = 0
        self.growths = 0

    def acquire(self) -> None:
        with self._cv:
            while self._active >= self.width:
                self._cv.wait()
            self._active += 1

    def release(self, nbytes: int, seconds: float) -> None:
        with self._cv:
            self._active -= 1
            self._bytes += nbytes
            self._busy_s += seconds
            if (self.floor_bps or self.growth_bps) and self._busy_s >= 0.25:
                rate = self._bytes / self._busy_s  # per busy thread
                if self.floor_bps and rate < self.floor_bps and self.width > self.min_width:
                    self.width = max(self.min_width, self.width // 2)
                    self.backoffs += 1
                elif (self.growth_bps and rate >= self.growth_bps
                      and self.width < self.max_width
                      and self.backoffs < self.MAX_GROWTH_BACKOFFS):
                    self.width = min(self.max_width, self.width * 2)
                    self.growths += 1
                # decay: recent reads dominate the next verdict
                self._bytes //= 2
                self._busy_s /= 2
            self._cv.notify_all()


class _OverlapClock:
    """Wall time with fetches in flight, with copies being issued, and with
    both (the overlap the staging ring exists to create)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = {"fetch": 0, "put": 0}
        self._last = time.monotonic()
        self.busy = {"fetch": 0.0, "put": 0.0}
        self.overlap_s = 0.0

    def _tick(self) -> None:
        now = time.monotonic()
        dt, self._last = now - self._last, now
        for kind, n in self._n.items():
            if n > 0:
                self.busy[kind] += dt
        if self._n["fetch"] > 0 and self._n["put"] > 0:
            self.overlap_s += dt

    def enter(self, kind: str) -> None:
        with self._lock:
            self._tick()
            self._n[kind] += 1

    def exit(self, kind: str) -> None:
        with self._lock:
            self._tick()
            self._n[kind] -= 1


def _view(buf, length: int) -> memoryview:
    return memoryview(buf).cast("B")[:length]


class _NativeCounter:
    """Reads that went through the native engine (``native_reads``), the
    proof the GIL-free path ran and not its Python fallback."""

    def __init__(self) -> None:
        self.native_reads = 0
        self._count_lock = threading.Lock()

    def _count_native(self) -> None:
        with self._count_lock:
            self.native_reads += 1


def _native_engine():
    """The native IO engine module when it is built and loadable, else None."""
    from modelx_tpu_torch import native

    return native if native.available() else None


class LocalFileSource(_NativeCounter):
    """Positional reads from one local file: the native engine's GIL-free
    ``pread_fd`` when it is available, ``os.preadv`` otherwise."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self._native = _native_engine()

    def read_range(self, offset: int, length: int, out=None):
        """Read ``length`` bytes at ``offset`` into ``out`` (a writable
        buffer of at least ``length`` bytes), or into a new uint8 array."""
        buf = np.empty(length, np.uint8) if out is None else out
        view = _view(buf, length)
        if self._native is not None and length > 0:
            self._native.pread_fd(self._fd, offset, length, view)
            self._count_native()
            return buf
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


class HTTPSource(_NativeCounter):
    """Ranged GETs against a URL (the registry's blob endpoint or a
    presigned URL) with one kept-alive connection per thread, each body
    landing in the caller's buffer: on ``http`` URLs through the native
    engine's raw-socket GET with the GIL released, else (``https``, no
    engine, or a transport fault on the native path) on ``http.client``
    with ``readinto``. A colocated client does better with the registry's
    ``file`` location (``LocalFileSource``)."""

    def __init__(self, url: str, headers: dict[str, str] | None = None) -> None:
        super().__init__()
        self.url = url
        self.headers = headers or {}
        u = urllib.parse.urlsplit(url)
        self._https = u.scheme == "https"
        self._host = u.hostname or ""
        self._port = u.port or (443 if self._https else 80)
        self._path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        self._local = threading.local()
        self._conns: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        # native engine: raw-socket ranged GETs, the GIL released for the
        # whole transfer (http only; TLS stays on the python path)
        self._use_native = u.scheme == "http"
        self._native_headers = "".join(f"{k}: {v}\r\n" for k, v in self.headers.items())
        self._natives: list = []

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self._https:
                from modelx_tpu_torch.client.remote import insecure_default, ssl_context

                conn = http.client.HTTPSConnection(self._host, self._port, timeout=300,
                                                   context=ssl_context(insecure_default()))
            else:
                conn = http.client.HTTPConnection(self._host, self._port, timeout=300)
            self._local.conn = conn
            with self._lock:
                self._conns.append(conn)
        return conn

    def _request(self, method: str, headers: dict[str, str]) -> http.client.HTTPResponse:
        conn = self._conn()
        try:
            conn.request(method, self._path, headers=headers)
            return conn.getresponse()
        except (OSError, http.client.HTTPException):
            # a stale kept-alive connection: rebuild it once
            conn.close()
            self._local.conn = None
            conn = self._conn()
            conn.request(method, self._path, headers=headers)
            return conn.getresponse()

    def _native_conn(self):
        """Thread-local native keep-alive connection (None once disabled)."""
        conn = getattr(self._local, "native", None)
        if conn is None:
            engine = _native_engine()
            if engine is None:
                self._use_native = False
                return None
            conn = engine.NativeHTTPConnection(self._host, self._port)
            self._local.native = conn
            with self._lock:
                self._natives.append(conn)
        return conn

    def _native_read(self, offset: int, length: int, out):
        """The native ranged GET, or None when this source drops to the
        Python path (no engine, a transport fault, a server ignoring
        Range); an error status raises. The engine redials a connection
        the server closed and drains error bodies of any size itself."""
        try:
            conn = self._native_conn()
        except OSError:
            conn = None
            self._use_native = False
        if conn is None:
            return None
        buf = np.empty(length, np.uint8) if out is None else out
        try:
            status = conn.get_range(self._path, offset, length, _view(buf, length),
                                    self._native_headers)
        except OSError:
            # transport or protocol trouble: the python path for this source
            self._local.native = None
            conn.close()
            self._use_native = False
            return None
        if status not in (200, 206):
            raise OSError(f"ranged read failed: HTTP {status}")
        self._count_native()
        return buf

    def read_range(self, offset: int, length: int, out=None):
        if self._use_native and length > 0:
            buf = self._native_read(offset, length, out)
            if buf is not None:
                return buf
        h = dict(self.headers)
        h["Range"] = f"bytes={offset}-{offset + length - 1}"
        resp = self._request("GET", h)
        try:
            if resp.status not in (200, 206):
                body = resp.read(4096)
                raise OSError(f"ranged read failed: HTTP {resp.status}: {body[:200]!r}")
            buf = np.empty(length, np.uint8) if out is None else out
            view = _view(buf, length)
            if resp.status == 200:  # the server ignored Range
                view[:] = resp.read()[offset:offset + length]
                return buf
            n = 0
            while n < length:
                got = resp.readinto(view[n:])
                if not got:
                    break
                n += got
            if n != length:
                raise OSError(f"ranged read short: want {length}, got {n}")
            return buf
        finally:
            resp.read()  # drain, so the kept-alive connection stays usable

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
            natives, self._natives = self._natives, []
        for conn in conns + natives:
            conn.close()


@dataclasses.dataclass
class LoadStats:
    bytes_fetched: int = 0  # read from the source
    bytes_to_device: int = 0  # over the link: the checkpoint's bytes
    bytes_resident: int = 0  # kept in device memory (int8 codes + scales when quantized)
    tensors: int = 0
    fetch_seconds: float = 0.0  # thread-seconds spent in reads
    total_seconds: float = 0.0
    fetch_width: int = 0  # the governor's final width
    fetch_backoffs: int = 0  # times the governor halved the width
    fetch_growths: int = 0  # times it doubled it
    # wall time with host-to-device copies being issued, and with fetches
    # and copies both in flight
    device_put_seconds: float = 0.0
    overlap_seconds: float = 0.0
    # pinned staging buffers allocated, and acquires served by a reused one
    staging_allocs: int = 0
    staging_reuses: int = 0
    # reads served by the native engine (GIL-free pread / ranged GET)
    native_reads: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_to_device / max(self.total_seconds, 1e-9) / 1e9


class _Staging:
    """A pool of pinned host buffers, each guarded by the event of the last
    copy out of it, feeding non_blocking host-to-device copies on one side
    stream."""

    def __init__(self, device: torch.device, count: int) -> None:
        self.stream = torch.cuda.Stream(device=device)
        self.bufs = [torch.empty(STAGING_CHUNK, dtype=torch.uint8, pin_memory=True)
                     for _ in range(count)]
        self.events: list[torch.cuda.Event | None] = [None] * count
        self.free: queue.SimpleQueue[int] = queue.SimpleQueue()
        for i in range(count):
            self.free.put(i)
        self.reuses = 0
        self._lock = threading.Lock()

    def acquire(self) -> tuple[int, torch.Tensor]:
        i = self.free.get()
        ev = self.events[i]
        if ev is not None:
            ev.synchronize()  # its previous copy has landed
            with self._lock:
                self.reuses += 1
        return i, self.bufs[i]

    def copy(self, i: int, dst: torch.Tensor, n: int) -> None:
        with torch.cuda.stream(self.stream):
            dst.copy_(self.bufs[i][:n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[i] = ev
        self.free.put(i)

    def release(self, i: int) -> None:
        self.free.put(i)

    def finish(self) -> None:
        self.stream.synchronize()


_EXPERT_NAME = re.compile(r"^(.+\.experts)\.(\d+)\.(.+)$")


def fuse_expert_tensors(tensors: dict[str, st.TensorInfo]) -> dict[str, st.TensorInfo]:
    """Fold HF per-expert entries (``...experts.<i>.w1.weight``) into
    virtual stacked tensors (``...experts.w1.weight``, shape [E, ...]),
    the layout ``models/mixtral.py`` consumes: the stacked tensor's bytes
    are its members' byte ranges, in expert order. A group whose indices
    are not 0..E-1 or whose members differ in shape or dtype passes
    through unfused. (The JAX twin also takes partition rules that may
    keep a group unfused for its mesh; on one card every uniform group
    fuses.)"""
    groups: dict[str, dict[int, st.TensorInfo]] = {}
    out: dict[str, st.TensorInfo] = {}
    for name, info in tensors.items():
        m = _EXPERT_NAME.match(name)
        if m:
            groups.setdefault(f"{m.group(1)}.{m.group(3)}", {})[int(m.group(2))] = info
        else:
            out[name] = info
    for key, members in groups.items():
        idxs = sorted(members)
        first = members[idxs[0]]
        uniform = idxs == list(range(len(idxs))) and all(
            m.shape == first.shape and m.dtype == first.dtype for m in members.values())
        if not uniform:
            for info in members.values():
                out[info.name] = info
            continue
        ms = [members[i] for i in idxs]
        out[key] = st.TensorInfo(
            name=key, dtype=first.dtype, shape=(len(ms), *first.shape),
            start=first.start, end=first.start + sum(m.nbytes for m in ms), members=ms)
    return out


def _box_ranges(shape, index, itemsize: int) -> list[tuple[int, int]]:
    """(offset, length) in a row-major tensor's bytes of each contiguous
    run of the box ``index`` (one slice per dim, step 1), in the box's
    row-major order, adjacent runs merged."""
    strides, acc = [], itemsize
    for n in reversed(shape):
        strides.insert(0, acc)
        acc *= n
    cut = [d for d, (sl, n) in enumerate(zip(index, shape)) if (sl.start, sl.stop) != (0, n)]
    if not cut:
        return [(0, acc)]
    last = cut[-1]
    inner = (index[last].stop - index[last].start) * strides[last]
    offs = [index[last].start * strides[last]]
    for d in range(last - 1, -1, -1):
        offs = [i * strides[d] + o for i in range(index[d].start, index[d].stop) for o in offs]
    runs: list[tuple[int, int]] = []
    for off in offs:
        if runs and runs[-1][0] + runs[-1][1] == off:
            runs[-1] = (runs[-1][0], runs[-1][1] + inner)
        else:
            runs.append((off, inner))
    return runs


def _byte_runs(info: st.TensorInfo, index=None) -> list[tuple[int, int, int]]:
    """(offset in the tensor, offset in the data section, length) of each
    contiguous run of ``info``'s bytes (of the box ``index`` of them when
    given), cut at ``STAGING_CHUNK``."""
    if index is not None:
        if info.members:
            raise ValueError(f"{info.name}: a fused expert tensor cannot load a slice")
        itemsize = info.nbytes // max(1, math.prod(info.shape))
        spans = [(info.start + off, n) for off, n in _box_ranges(info.shape, index, itemsize)]
    else:
        spans = [(part.start, part.nbytes) for part in info.members or [info]]
    runs, at = [], 0
    for start, nbytes in spans:
        for off in range(0, nbytes, STAGING_CHUNK):
            n = min(STAGING_CHUNK, nbytes - off)
            runs.append((at + off, start + off, n))
        at += nbytes
    return runs


def _fetch_units(runs: list[tuple[int, int, int]]) -> list[tuple[int, int, list]]:
    """``runs`` grouped into fetch units of at most ``STAGING_CHUNK`` bytes
    that land contiguously in the tensor: (offset in the tensor, length,
    [(offset in the data section, length), ...]). A dim-1 slice's row runs
    share a unit (and one copy to the card) instead of one each."""
    units: list[tuple[int, int, list]] = []
    for at, src, n in runs:
        if units and units[-1][0] + units[-1][1] == at and units[-1][1] + n <= STAGING_CHUNK:
            u_at, u_n, pieces = units[-1]
            pieces.append((src, n))
            units[-1] = (u_at, u_n + n, pieces)
        else:
            units.append((at, n, [(src, n)]))
    return units


def read_index(source) -> tuple[dict[str, st.TensorInfo], int]:
    """The safetensors header by two small ranged reads: (tensors, data offset)."""
    (hlen,) = struct.unpack("<Q", bytes(_read_with_retry(source, 0, 8)))
    return st.parse_header(bytes(_read_with_retry(source, 8, hlen))), 8 + hlen


def load_safetensors(
    source,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
    quantize: str | None = None,
    tensors: dict[str, st.TensorInfo] | None = None,
    data_offset: int | None = None,
    concurrency: int = 0,
    index=None,
) -> tuple[dict, LoadStats]:
    """Load every tensor of one safetensors blob onto ``device``.

    ``tensors``/``data_offset`` come from the manifest's tensor-index
    annotation when the caller has it; otherwise the header is read with
    two small ranged reads. ``concurrency`` <= 0 takes the width from the
    host and the source type (``auto_fetch_concurrency``). ``dtype`` casts
    floating tensors on the device after the copy; integer tensors keep
    theirs. ``quantize="int8"`` quantizes each eligible weight (2-D, a name
    ``quant.DEFAULT_ELIGIBLE`` matches) from its stored values, before any
    cast, and returns it as a ``QTensor``. ``index(name, shape)``, when
    given, names the slices (one per dim) of each tensor to load: only
    their bytes are read, and the tensor arrives at the slice's shape."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    if quantize and index is not None:
        raise ValueError("int8 quantization of a sliced load is not supported")
    t0 = time.monotonic()
    device = torch.device(device)
    stats = LoadStats()
    counter = getattr(source, "source", source)
    native0 = getattr(counter, "native_reads", 0)
    # env-gated chaos drills (default off): MODELX_FAULT_PLAN with a
    # "loader.read" schedule wraps the source, so the retry and the
    # governor can be rehearsed against a real deployment on demand
    from modelx_tpu_torch.testing import faults as _faults

    env_plan = _faults.from_env()
    if env_plan is not None and env_plan.has("loader.read"):
        source = _faults.FaultyByteSource(source, env_plan)
    if tensors is None or data_offset is None:
        tensors, data_offset = read_index(source)
    tensors = fuse_expert_tensors(tensors)
    if concurrency <= 0:
        concurrency = auto_fetch_concurrency(counter)
    # local page-cache reads under ~32 MB/s a thread mean the threads are
    # fighting the scheduler: halve. Remote reads may double the width
    # while each thread holds 24 MB/s; local ones regrow only to the start.
    # the policy reads the source under a fault wrapper: injected faults
    # must not flip the governor to the remote profile
    is_local = isinstance(counter, LocalFileSource)
    governor = _FetchGovernor(
        concurrency, floor_bps=32e6 if is_local else 0.0,
        max_width=concurrency if is_local else 2 * concurrency,
        growth_bps=128e6 if is_local else 24e6)
    clock = _OverlapClock()
    staging = _Staging(device, governor.max_width + 2) if device.type == "cuda" else None
    lock = threading.Lock()

    def fetch(dst: torch.Tensor, pieces: list[tuple[int, int]]) -> None:
        """One unit: its pieces ((offset, length) in the data section) read
        back to back into a staging buffer and copied onto the card at
        once, or (CPU) straight into ``dst``."""
        i, buf = staging.acquire() if staging is not None else (None, None)
        try:
            target = dst.numpy() if buf is None else buf.numpy()
            at = 0
            busy = 0.0
            for offset, n in pieces:
                sample = [0, 0.0]

                def timer(nbytes: int, secs: float, sample=sample) -> None:
                    sample[0], sample[1] = nbytes, secs

                governor.acquire()
                try:
                    clock.enter("fetch")
                    try:
                        _read_with_retry(source, data_offset + offset, n, target[at:at + n],
                                         timer=timer)
                    finally:
                        clock.exit("fetch")
                finally:
                    governor.release(sample[0], sample[1])
                at += n
                busy += sample[1]
            with lock:
                stats.bytes_fetched += at
                stats.fetch_seconds += busy
            if staging is not None:
                clock.enter("put")
                try:
                    staging.copy(i, dst, at)
                finally:
                    clock.exit("put")
                i = None
        finally:
            if i is not None:
                staging.release(i)

    raw: dict[str, torch.Tensor] = {}
    out: dict = {}
    pending: list[tuple[str, st.TensorInfo, torch.Tensor, list]] = []
    in_flight = 0
    if index is not None:
        boxes = {name: tuple(index(name, info.shape)) for name, info in tensors.items()}
        runs = {name: _byte_runs(info, boxes[name]) for name, info in tensors.items()}
        shapes = {name: tuple(sl.stop - sl.start for sl in boxes[name]) for name in tensors}
    else:
        runs = {name: _byte_runs(info) for name, info in tensors.items()}
        shapes = {name: tuple(info.shape) for name, info in tensors.items()}

    def complete(name: str, info: st.TensorInfo, dst: torch.Tensor, futures: list) -> None:
        for f in futures:
            f.result()
        if quantize and len(info.shape) == 2 and quant.DEFAULT_ELIGIBLE.search(name):
            if staging is not None:
                # quantize on the compute stream once this tensor's copies
                # landed; its raw bytes are then freed, one tensor at a time
                torch.cuda.current_stream(device).wait_stream(staging.stream)
            out[name] = quant.quantize_tensor(dst.view(info.torch_dtype()).reshape(info.shape))
        else:
            raw[name] = dst

    with ThreadPoolExecutor(max_workers=governor.max_width,
                            thread_name_prefix="modelx-fetch") as pool:
        try:
            for name, info in tensors.items():
                n = sum(size for _, _, size in runs[name])
                dst = torch.empty(n, dtype=torch.uint8, device=device)
                if quantize and staging is not None:
                    # dst may reuse the block of a tensor quantized before
                    # it: copy into it only after that quantize has read it
                    staging.stream.wait_stream(torch.cuda.current_stream(device))
                futures = [pool.submit(fetch, dst[at:at + size], pieces)
                           for at, size, pieces in _fetch_units(runs[name])]
                pending.append((name, info, dst, futures))
                in_flight += n
                stats.bytes_to_device += n
                stats.tensors += 1
                while pending and in_flight > WINDOW_BYTES:
                    head = pending.pop(0)
                    in_flight -= head[2].numel()
                    complete(*head)
            for head in pending:
                complete(*head)
        except BaseException:
            for *_, futures in pending:
                for f in futures:
                    f.cancel()
            raise
    if staging is not None:
        staging.finish()
    for name, info in tensors.items():
        if name in out:
            continue
        t = raw.pop(name).view(info.torch_dtype()).reshape(shapes[name])
        if dtype is not None and t.is_floating_point() and t.dtype != dtype:
            t = t.to(dtype)
        out[name] = t
    out = {name: out[name] for name in tensors}  # the header's order
    stats.bytes_resident = sum(t.nbytes for t in out.values())
    stats.total_seconds = time.monotonic() - t0
    stats.fetch_width = governor.width
    stats.native_reads = getattr(counter, "native_reads", 0) - native0
    stats.fetch_backoffs = governor.backoffs
    stats.fetch_growths = governor.growths
    stats.device_put_seconds = clock.busy["put"]
    stats.overlap_seconds = clock.overlap_s
    if staging is not None:
        stats.staging_allocs = len(staging.bufs)
        stats.staging_reuses = staging.reuses
    from modelx_tpu_torch.utils import trace

    # the load as one closed span (its timing and counters known only now)
    trace.tracer().record({
        "path": "dl.load", "start_s": t0, "duration_s": stats.total_seconds,
        "tensors": stats.tensors, "bytes_fetched": stats.bytes_fetched,
        "bytes_to_device": stats.bytes_to_device,
        "fetch_thread_s": round(stats.fetch_seconds, 3),
        "overlap_s": round(stats.overlap_seconds, 3), "staging_allocs": stats.staging_allocs,
        "gbps": round(stats.gbps, 3),
    })
    return out, stats
