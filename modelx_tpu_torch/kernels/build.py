"""Build the flash-attention CUDA source with nvcc and bind it with ctypes.

``csrc/flash_attention.cu`` is compiled on first use, for ``sm_90a``, into a
shared library with a plain C interface under ``modelx_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags: a
changed source rebuilds, an unchanged one loads the cached library.

Nothing here runs at import time: the CPU tests import this module on a
box without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "flash_attention.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, dtype, B, H, Hkv, Sq, Sk, D, scale, softcap, causal, window,
# stream. Every pointer and the stream are c_void_p, so ctypes never cuts
# them to 32 bits; the function returns its cudaGetLastError() (0 = ok).
ARGTYPES = [_P] * 4 + [_I] * 7 + [_F, _F, _I, _I, _P]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
# nvcc's register/shared-memory report (-Xptxas -v) when this process built
build_log = ""


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"flash_attention-{digest[:16]}.so")


def build() -> bool:
    """Compile the library unless it is cached. Returns whether nvcc ran;
    raises with nvcc's output when it fails."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return True


def load_library() -> ctypes.CDLL:
    """The bound flash-attention library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(library_path())
            lib.mx_flash_attention.argtypes = ARGTYPES
            lib.mx_flash_attention.restype = ctypes.c_int
            _lib = lib
    return _lib
