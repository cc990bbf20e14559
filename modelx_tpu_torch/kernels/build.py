"""Build the flash-attention CUDA sources with nvcc and bind them with ctypes.

Every ``.cu`` under ``csrc/`` (the forward ``flash_attention.cu`` and the
backward ``flash_attention_bwd.cu``, with the headers beside them) is
compiled on first use, for ``sm_90a``, one nvcc per source, all started
together, and linked into one shared library with a plain C interface,
named by a hash of every file under ``csrc/`` and the flags: a changed
source or header rebuilds, an unchanged tree loads the cached library.

The library lives in the build directory: ``$MODELX_COMPILE_CACHE`` when
it is set (the JAX sidecar keeps its persistent XLA cache there), else
``modelx_tpu_torch/_build/`` (listed in ``.gitignore``). The program store
(``dl/program_store.py``) ships this library with a model version and
installs a pulled one into the same directory, so a pod that pulls it
serves its first cache-free forward without running nvcc, or without
nvcc at all. ``library_info()`` says where the loaded library came from:
``"nvcc"`` (built by this process, with nvcc's seconds), ``"bundle"``
(installed from the registry by this process) or ``"cached"`` (found on
disk).

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
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
# the default build directory; $MODELX_COMPILE_CACHE overrides it
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "sm_90a"
# The source reaches cuTensorMapEncodeTiled through cudaGetDriverEntryPoint,
# so nothing links against libcuda; its headers are found beside it.
_GENCODE = f"-gencode=arch=compute_{ARCH[3:]},code={ARCH}"
# one object per source (-c), then one link (-shared)
NVCC_FLAGS = (_GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (_GENCODE, "-shared")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, dtype, B, H, Hkv, Sq, Sk, D, scale, softcap, causal, window,
# stream. Every pointer and the stream are c_void_p, so ctypes never cuts
# them to 32 bits; each function returns its cudaGetLastError() (0 = ok).
ARGTYPES = [_P] * 4 + [_I] * 7 + [_F, _F, _I, _I, _P]
# the training forward: ARGTYPES with the fp32 lse pointer after o
LSE_ARGTYPES = [_P] * 5 + [_I] * 7 + [_F, _F, _I, _I, _P]
# the backward: q, k, v, o, do, lse, delta, dq, dk, dv, then as ARGTYPES
BWD_ARGTYPES = [_P] * 10 + [_I] * 7 + [_F, _F, _I, _I, _P]
SYMBOLS = {"mx_flash_attention": ARGTYPES, "mx_flash_attention_lse": LSE_ARGTYPES,
           "mx_flash_attention_bwd": BWD_ARGTYPES}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
# nvcc's register/shared-memory report (-Xptxas -v) when this process built
build_log = ""
# where each library path this process built or installed came from:
# path -> ("nvcc", seconds) or ("bundle", None)
_origins: dict[str, tuple[str, float | None]] = {}
_info: dict | None = None  # library_info() once load_library has bound one


def build_dir() -> str:
    """Where the library is built, cached and installed."""
    return os.environ.get("MODELX_COMPILE_CACHE") or BUILD_DIR


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest() -> str:
    """sha256 over every file under csrc/ (relative name and bytes) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for root, _dirs, files in sorted(os.walk(CSRC)):
        for name in sorted(files):
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, CSRC).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def library_name() -> str:
    return f"flash_attention-{source_digest()[:16]}.so"


def library_path() -> str:
    return os.path.join(build_dir(), library_name())


def nvcc_version() -> str:
    """nvcc's ``release`` line (e.g. "Cuda compilation tools, release
    12.9, V12.9.86"), or "" where there is no nvcc."""
    try:
        proc = subprocess.run([nvcc_path(), "--version"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return ""
    lines = [ln.strip() for ln in proc.stdout.splitlines() if "release" in ln]
    return lines[0] if lines else ""


def note_installed(path: str) -> None:
    """Record that the program store installed ``path`` in this process."""
    _origins[os.path.realpath(path)] = ("bundle", None)


def compile_library(source_dir: str, out: str) -> str:
    """nvcc every ``.cu`` of ``source_dir`` (one nvcc each, all at once,
    with the headers beside them) and link them into the shared library
    ``out``. Returns nvcc's output and raises with it when nvcc fails."""
    sources = [os.path.join(source_dir, n) for n in sorted(os.listdir(source_dir))
               if n.endswith(".cu")]
    if not sources:
        raise RuntimeError(f"kernel build failed: no .cu source under {source_dir}")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    nvcc = nvcc_path()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    try:
        logs = [(src, proc.communicate()[0], proc.returncode) for src, proc in zip(sources, procs)]
        text = "".join(f"== {os.path.basename(src)}\n{log}" for src, log, _ in logs)
        failed = [f"{os.path.basename(src)} ({rc})" for src, _, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"kernel build failed: nvcc exited nonzero for {failed}\n{text}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed: nvcc exited {link.returncode}\n{link.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in objs:
            if os.path.exists(path):
                os.unlink(path)
    return text + link.stdout


def build() -> bool:
    """Compile the library unless it is cached. Returns whether nvcc ran;
    raises with nvcc's output when it fails."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return False
    t0 = time.monotonic()
    build_log = compile_library(CSRC, out)
    _origins[os.path.realpath(out)] = ("nvcc", time.monotonic() - t0)
    return True


def bind(path: str) -> ctypes.CDLL:
    """Load a built library and declare the C interface of each of
    ``SYMBOLS`` it exports (a baseline built from an older source may have
    the forward only; calling a missing one raises AttributeError)."""
    lib = ctypes.CDLL(path)
    if not hasattr(lib, "mx_flash_attention"):
        raise RuntimeError(f"{path} exports no mx_flash_attention")
    for name, argtypes in SYMBOLS.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The bound flash-attention library, built on first use."""
    global _lib, _info
    if _lib is not None:
        return _lib
    from modelx_tpu_torch.utils import trace

    with _lock:
        if _lib is None:
            # the port's compile: the JAX sidecar's serve.compile span times
            # its jit, this one the library's build (nvcc) or bind
            with trace.span("serve.compile", library=library_name()) as rec:
                build()
                path = library_path()
                lib = bind(path)
                origin, secs = _origins.get(os.path.realpath(path), ("cached", None))
                rec["origin"] = origin
            _info = {"origin": origin, "path": path, "nvcc_seconds": secs}
            _lib = lib
    return _lib


def library_info() -> dict | None:
    """``{"origin", "path", "nvcc_seconds"}`` of the bound library (origin
    "nvcc", "bundle" or "cached"; seconds only for "nvcc"), or None before
    ``load_library`` has bound one."""
    return dict(_info) if _info is not None else None

