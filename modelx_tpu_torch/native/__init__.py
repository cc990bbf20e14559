"""ctypes bindings for the native IO engine (``modelx_io.cc``), the port's
counterpart of ``modelx_tpu/native/__init__.py``.

The byte-moving hot loops of the registry -> card path (positional file
reads, ranged HTTP GETs, sha256 content addressing, host int8 rows) are
C++ compiled on first use with the host's g++ and loaded with ctypes.
Every call releases the GIL for its whole duration, so the loader's fetch
threads and a push's hashing do not contend with the thread that issues
the host-to-device copies, nor with another tenant's forward.

This is host code: g++, not nvcc; it runs the same on the CPU and on the
card's host. It degrades exactly as the JAX package's engine does: when no
toolchain (and no earlier build) is in reach, ``lib()`` returns None and
every caller keeps its pure-Python path.

The build lands in ``modelx_tpu_torch/_build/libmodelx_io.so``, written
under a per-process temporary name and published with ``os.replace``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger("modelx.native")

_SRC = os.path.join(os.path.dirname(__file__), "modelx_io.cc")
_SO = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "libmodelx_io.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

# mx_quantize_rows dtype codes
DTYPE_F32, DTYPE_BF16, DTYPE_F16 = 0, 1, 2


class MxRange(ctypes.Structure):
    _fields_ = [
        ("offset", ctypes.c_int64),
        ("length", ctypes.c_int64),
        ("buf", ctypes.c_void_p),
    ]


def build(force: bool = False) -> str | None:
    """Compile modelx_io.cc -> _build/libmodelx_io.so. Returns the path, or
    None when no toolchain is available. Cached: skips when the .so is newer
    than the source."""
    if (
        not force
        and os.path.exists(_SO)
        and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    ):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # per-process temp output so concurrent builds can't corrupt each other;
    # os.replace publishes atomically and last-writer-wins is fine (same src)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC, "-ldl"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError) as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if os.path.exists(_SO):
            # an image that bakes the .so but ships no toolchain, with an
            # install mtime that makes the source look newer: an existing
            # library beats the pure-Python fallback
            logger.debug("native rebuild unavailable (%s); using existing .so", e)
            return _SO
        logger.debug("native build unavailable: %s", e)
        return None
    return _SO


def lib() -> ctypes.CDLL | None:
    """The loaded native library, building it on first use; None if the
    native engine is unavailable (callers fall back to pure Python)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()  # no-op when the .so is newer than the source
        if path is None:
            return None
        try:
            l = ctypes.CDLL(path)
        except OSError as e:
            logger.debug("native load failed: %s", e)
            return None
        l.mx_pread_scatter.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(MxRange), ctypes.c_int, ctypes.c_int,
        ]
        l.mx_pread_scatter.restype = ctypes.c_int
        l.mx_pread_fd.argtypes = [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        l.mx_pread_fd.restype = ctypes.c_int
        l.mx_sha256_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        l.mx_sha256_file.restype = ctypes.c_int
        l.mx_sha256_buf.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
        l.mx_sha256_buf.restype = ctypes.c_int
        l.mx_http_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        l.mx_http_connect.restype = ctypes.c_void_p
        l.mx_http_close.argtypes = [ctypes.c_void_p]
        l.mx_http_close.restype = None
        l.mx_http_get_range.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        l.mx_http_get_range.restype = ctypes.c_int
        try:
            # a baked .so from an older build may predate this entry point;
            # the quantize wrapper then falls back to numpy and the rest of
            # the engine keeps working (degrade, don't raise)
            l.mx_quantize_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            l.mx_quantize_rows.restype = ctypes.c_int
        except AttributeError:
            logger.debug("native quantize unavailable (stale .so)")
        _lib = l
        return _lib


def available() -> bool:
    return lib() is not None


# -- high-level wrappers ------------------------------------------------------


def sha256_file(path: str) -> str | None:
    """Hex sha256 of a file, GIL-free; None if the engine is unavailable."""
    l = lib()
    if l is None:
        return None
    out = ctypes.create_string_buffer(65)
    rc = l.mx_sha256_file(path.encode(), out)
    if rc != 0:
        raise OSError(-rc, f"mx_sha256_file({path}): {os.strerror(-rc)}")
    return out.value.decode()


def sha256_buffer(view) -> str | None:
    """Hex sha256 of a bytes-like object; None if unavailable."""
    l = lib()
    if l is None:
        return None
    mv = memoryview(view)
    if not mv.c_contiguous:
        mv = memoryview(bytes(mv))
    mv = mv.cast("B")
    out = ctypes.create_string_buffer(65)
    if mv.readonly:
        buf = (ctypes.c_char * len(mv)).from_buffer_copy(mv)
        addr = ctypes.addressof(buf)
    else:
        addr = ctypes.addressof(ctypes.c_char.from_buffer(mv)) if len(mv) else None
    l.mx_sha256_buf(addr, len(mv), out)
    return out.value.decode()


def pread_fd(fd: int, offset: int, length: int, out) -> None:
    """Single GIL-free positional read on an already-open fd. ``out`` must
    hold at least ``length`` bytes — the native side writes ``length`` bytes
    unconditionally, so an undersized buffer would be heap corruption."""
    l = lib()
    if l is None:
        raise RuntimeError("native engine unavailable")
    mv = memoryview(out)
    if length < 0 or mv.nbytes < length:
        raise ValueError(f"buffer holds {mv.nbytes} bytes, need {length}")
    c = ctypes.c_char.from_buffer(mv.cast("B"))
    rc = l.mx_pread_fd(fd, offset, length, ctypes.addressof(c))
    if rc != 0:
        raise OSError(-rc, f"mx_pread_fd: {os.strerror(-rc)}")


def pread_scatter(path: str, ranges: list[tuple[int, int, memoryview]], threads: int = 8) -> None:
    """Parallel positional reads: each (offset, length, writable buffer)."""
    l = lib()
    if l is None:
        raise RuntimeError("native engine unavailable")
    arr = (MxRange * len(ranges))()
    _keep = []
    for i, (off, ln, mv) in enumerate(ranges):
        if ln < 0 or memoryview(mv).nbytes < ln:
            raise ValueError(
                f"range {i}: buffer holds {memoryview(mv).nbytes} bytes, need {ln}"
            )
        c = ctypes.c_char.from_buffer(memoryview(mv).cast("B"))
        _keep.append(c)
        arr[i] = MxRange(off, ln, ctypes.addressof(c))
    rc = l.mx_pread_scatter(path.encode(), arr, len(ranges), threads)
    if rc != 0:
        raise OSError(-rc, f"mx_pread_scatter({path}): {os.strerror(-rc)}")


def _rows_of(arr):
    """(address, dtype code, rows, cols, keep-alive) of a 2-D C-contiguous
    weight, or None when the layout or dtype is not the kernel's. Takes a
    numpy float32 / float16 array, raw bfloat16 bits as a numpy uint16
    array, or a CPU torch tensor of float32, bfloat16 or float16."""
    import numpy as np

    if type(arr).__module__.startswith("torch"):
        import torch

        codes = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16,
                 torch.float16: DTYPE_F16}
        code = codes.get(arr.dtype)
        if (code is None or arr.device.type != "cpu" or arr.dim() != 2
                or not arr.is_contiguous()):
            return None
        return arr.data_ptr(), code, arr.shape[0], arr.shape[1], arr
    arr = np.asarray(arr)
    codes = {np.dtype(np.float32): DTYPE_F32, np.dtype(np.uint16): DTYPE_BF16,
             np.dtype(np.float16): DTYPE_F16}
    code = codes.get(arr.dtype)
    if code is None or arr.ndim != 2 or not arr.flags.c_contiguous:
        return None
    return arr.ctypes.data, code, arr.shape[0], arr.shape[1], arr


def quantize_rows(arr, scales=None, want_q: bool = True, threads: int = 0):
    """Fused rowwise int8 quantization of a 2-D float weight, GIL-free.

    Returns (q int8 [rows, cols] or None, scales f32 [rows]) as numpy
    arrays — numerically identical to ``ops/quant.py``'s numpy rule — or
    None when the native engine is unavailable or the dtype/layout is
    unsupported (callers fall back). bfloat16 comes as a CPU
    ``torch.bfloat16`` tensor or as its raw bits in a numpy uint16 array.
    ``scales`` given = quantize with the caller's scales; absent = compute
    them (absmax/127). ``want_q=False`` = scales only.
    """
    import numpy as np

    l = lib()
    if l is None or not hasattr(l, "mx_quantize_rows"):
        return None
    got = _rows_of(arr)
    if got is None:
        return None
    addr, code, rows, cols, _keep = got
    if rows == 0 or cols == 0:  # degenerate shapes keep the numpy semantics
        return None
    if threads <= 0:
        threads = min(4, os.cpu_count() or 1)
    q = np.empty((rows, cols), np.int8) if want_q else None
    if scales is not None:
        scales_arr = np.ascontiguousarray(scales, np.float32)
        if scales_arr.shape != (rows,):
            raise ValueError(f"scales shape {scales_arr.shape} != ({rows},)")
        scales_in, scales_out = scales_arr.ctypes.data, None
    else:
        scales_arr = np.empty((rows,), np.float32)
        scales_in, scales_out = None, scales_arr.ctypes.data
    rc = l.mx_quantize_rows(
        addr, code, rows, cols, scales_in, scales_out,
        q.ctypes.data if q is not None else None, threads,
    )
    if rc != 0:
        raise OSError(-rc, f"mx_quantize_rows: {os.strerror(-rc)}")
    return q, scales_arr


class NativeHTTPConnection:
    """One keep-alive connection to an http:// origin; ranged GETs land
    straight in caller buffers with the GIL released."""

    def __init__(self, host: str, port: int, timeout_ms: int = 300_000) -> None:
        l = lib()
        if l is None:
            raise RuntimeError("native engine unavailable")
        self._lib = l
        self._conn = l.mx_http_connect(host.encode(), port, timeout_ms)
        if not self._conn:
            raise OSError(f"connect {host}:{port} failed")
        self._host = host
        self._port = port

    def get_range(self, path: str, offset: int, length: int, out: memoryview,
                  headers: str = "") -> int:
        """Returns the HTTP status; raises on transport errors. ``out`` must
        be exactly ``length`` bytes."""
        mv = memoryview(out).cast("B")
        if len(mv) != length:
            raise ValueError(f"buffer {len(mv)} != length {length}")
        c = ctypes.c_char.from_buffer(mv)
        # bracket IPv6 literals (urlsplit strips the brackets)
        host = f"[{self._host}]" if ":" in self._host else self._host
        host_hdr = f"{host}:{self._port}"
        rc = self._lib.mx_http_get_range(
            self._conn, host_hdr.encode(), path.encode(), headers.encode(),
            offset, length, ctypes.addressof(c),
        )
        if rc < 0:
            raise OSError(f"native ranged GET failed (code {rc}) for {path}")
        return rc

    def close(self) -> None:
        if getattr(self, "_conn", None):
            self._lib.mx_http_close(self._conn)
            self._conn = None

    def __del__(self) -> None:
        # a finalizer must not raise; a failed close still leaves a trace
        try:
            self.close()
        except Exception:
            logger.debug("native connection close failed in __del__", exc_info=True)
