"""Hand the JAX package's params to the port.

Both packages key params by HF names in HF's [out, in] layout, so no
transposes happen here: each numpy array becomes a torch tensor on
``device``. BF16 (and F8) arrays arrive as ``ml_dtypes`` arrays, recognised
by their dtype's name (this package never imports ml_dtypes) and
reinterpreted through their raw bits (``uint16`` for bf16). A quantized
weight arrives as a ``{"q": int8, "scale": fp32}`` pair of arrays and
becomes the port's ``QTensor``. ``shard_jax_params`` hands over one
rank's slices instead, as a mesh rank holds them.
"""

from __future__ import annotations

import numpy as np
import torch

from modelx_tpu_torch.device import resolve_device
from modelx_tpu_torch.ops.quant import QTensor


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
                    dtype: torch.dtype | None = None, index=None) -> dict[str, torch.Tensor]:
    """The port's params dict from the JAX package's params as numpy arrays
    (a quantized weight as its ``{"q", "scale"}`` pair). ``dtype`` casts
    floating tensors; ``device`` defaults to the card. ``index(name,
    shape)``, when given, names the slices of each array to keep."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        if isinstance(arr, dict):
            out[name] = QTensor(q=to_tensor(arr["q"]), scale=to_tensor(arr["scale"])).to(dev)
            continue
        if index is not None:
            arr = np.asarray(arr)[index(name, arr.shape)]
        t = to_tensor(arr).to(dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    return out


def shard_jax_params(np_params: dict[str, np.ndarray], cfg, mesh, device=None,
                     dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """This mesh rank's slices of a llama/qwen2 model's JAX params: what
    the mesh loader reads for it (``models/llama.ShardingCtx``)."""
    from modelx_tpu_torch.models import llama

    ctx = llama.sharding_ctx(cfg, mesh)
    return from_jax_params(np_params, device=device, dtype=dtype, index=ctx.param_index)
