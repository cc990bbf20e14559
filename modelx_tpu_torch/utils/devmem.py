"""Measured device memory telemetry (counterpart of
``modelx_tpu/utils/devmem.py``).

The model pool admits loads against file-size estimates (safetensors bytes
at reservation, tightened to the loaded bytes at READY). This module
samples what the card itself reports, so the pool can veto a load the
ledger admitted but the device cannot hold (``lifecycle.ModelPool.
_measured_shortfall``), and ``pool_snapshot()`` shows the estimate beside
the measurement.

On CUDA the sample reads ``torch.cuda.mem_get_info`` (free and total bytes
of the device, whoever holds them) and the caching allocator's
``memory_allocated`` / ``memory_reserved``. Blocks the allocator keeps
cached after a model is freed count as used in ``mem_get_info`` but are
free for the next load (the allocator releases them and retries before it
raises an out-of-memory error), so they are counted as reservable:

    hbm_bytes_limit      = total
    hbm_bytes_in_use     = total - free - (reserved - allocated)
    hbm_bytes_reservable = free + (reserved - allocated)

The sample carries ``source="memory_stats"``, the name the reference gives
its accountant-backed source, so the pool's veto reads as it does there.
Without an initialized CUDA context (the CPU, or a process that has not
touched the card) it carries ``source="none"`` and zeros, and never vetoes
a load.

Samples are cached for ``max_age_s`` (default 1 s): ``pool_snapshot`` is
read per request of ``/admin/models``.
"""

from __future__ import annotations

import logging
import threading
import time

__all__ = ["sample", "raw_sample"]

logger = logging.getLogger("modelx.devmem")

_cache_lock = threading.Lock()
_cached: dict | None = None
_cached_t = 0.0


def _device_stats(index: int) -> dict | None:
    """One CUDA device's numbers, or None when the probe fails."""
    import torch

    try:
        free, total = torch.cuda.mem_get_info(index)
        allocated = torch.cuda.memory_allocated(index)
        reserved = torch.cuda.memory_reserved(index)
    except Exception:  # a device that cannot be queried
        logger.debug("mem_get_info(%d) failed", index, exc_info=True)
        return None
    cached = max(0, int(reserved) - int(allocated))
    return {
        "hbm_bytes_in_use": max(0, int(total) - int(free) - cached),
        "hbm_bytes_limit": int(total),
        "hbm_bytes_reservable": int(free) + cached,
        "allocated_bytes": int(allocated),
        "reserved_bytes": int(reserved),
    }


def raw_sample() -> dict:
    """One uncached sample across the CUDA devices this process has
    initialized. Keys are numeric except ``source``."""
    out = {
        "hbm_bytes_in_use": 0,
        "hbm_bytes_limit": 0,
        "hbm_bytes_reservable": 0,
        "device_count": 0,
        "source": "none",
    }
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return out
        count = torch.cuda.device_count()
    except Exception:
        logger.debug("CUDA device query failed", exc_info=True)
        return out
    out["device_count"] = count
    per = [_device_stats(i) for i in range(count)]
    if not any(p is not None for p in per):
        return out
    out["source"] = "memory_stats"
    # per-device breakdown keyed by device index: on several cards the
    # aggregate hides one card filling while its peers idle
    out["devices"] = {}
    for i, p in enumerate(per):
        if p is None:
            continue
        for key in ("hbm_bytes_in_use", "hbm_bytes_limit", "hbm_bytes_reservable"):
            out[key] += p[key]
        out["devices"][str(i)] = p
    return out


def sample(max_age_s: float = 1.0) -> dict:
    """The cached sample every surface shares. A copy is returned:
    callers merge it into snapshot trees they then mutate."""
    global _cached, _cached_t
    now = time.monotonic()
    with _cache_lock:
        if _cached is not None and now - _cached_t < max_age_s:
            return _copy(_cached)
    fresh = raw_sample()
    with _cache_lock:
        _cached, _cached_t = fresh, time.monotonic()
        return _copy(fresh)


def _copy(sample_dict: dict) -> dict:
    """Copy deep enough that a caller mutating the nested per-device dicts
    cannot corrupt the shared cache entry."""
    out = dict(sample_dict)
    if isinstance(out.get("devices"), dict):
        out["devices"] = {k: dict(v) for k, v in out["devices"].items()}
    return out
