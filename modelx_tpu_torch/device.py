"""Explicit device and dtype handling.

The port runs on the card unless the caller asks for the CPU: there is no
silent fallback, so a box without CUDA fails loudly instead of serving an
8B model on its cores.
"""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def parse_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (or the torch dtype itself)."""
    if isinstance(name, torch.dtype):
        if name not in _DTYPES.values():
            raise ValueError(f"unsupported dtype {name} (bfloat16 or float32)")
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} (bfloat16 or float32)") from None


def start_host_copy(t: torch.Tensor):
    """Start ``t``'s device->host copy now; returns a zero-arg callable that
    waits for that copy alone (its CUDA event) and gives a numpy array.

    Callers that serialize device work under a lock queue the copy under it
    and call the result after the release: the stream keeps the copy after
    the work that produced ``t``, and the host's wait holds no lock. A CPU
    tensor is copied at once."""
    if not t.is_cuda:
        arr = t.numpy().copy()
        return lambda: arr
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()

    def get():
        ev.synchronize()
        return host.numpy()

    return get
