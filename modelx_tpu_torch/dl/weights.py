"""Hand the JAX package's params to the port.

Both packages key params by HF names in HF's [out, in] layout, so no
transposes happen here: each numpy array becomes a torch tensor on
``device``. BF16 (and F8) arrays arrive as ``ml_dtypes`` arrays, recognised
by their dtype's name (this package never imports ml_dtypes) and
reinterpreted through their raw bits (``uint16`` for bf16).
"""

from __future__ import annotations

import numpy as np
import torch

from modelx_tpu_torch.device import resolve_device


# ml_dtypes' extended floats by dtype name -> (same-width numpy int, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values (extended floats bit-exact)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name in _BIT_VIEWS:
        bits, dtype = _BIT_VIEWS[arr.dtype.name]
        return torch.from_numpy(arr.view(bits).copy()).view(dtype)
    return torch.from_numpy(arr.copy())


def from_jax_params(np_params: dict[str, np.ndarray], device=None,
                    dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The port's params dict from the JAX package's params as numpy arrays.
    ``dtype`` casts floating tensors; ``device`` defaults to the card."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        t = to_tensor(arr).to(dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    return out
