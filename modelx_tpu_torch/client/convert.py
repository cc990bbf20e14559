"""Checkpoint converters: foreign formats -> safetensors dirs ready to push
(counterpart of ``modelx_tpu/client/convert.py``).

- **torch** (PyTorch): a ``.bin``/``.pt`` ``state_dict`` converts tensor by
  tensor through the port's ``dl/safetensors.py``; bf16 stays
  ``torch.bfloat16`` and is written as its own bytes. The file is
  byte-identical to the JAX package's converter's for the same state dict.
- **orbax** (JAX): restoring one needs ``orbax.checkpoint``, which the port
  does not import. ``convert_orbax`` refuses with ``OrbaxNotPortedError``,
  which names the JAX package's ``modelx convert orbax``.

Both write ``model.safetensors`` into the destination directory, which then
pushes like any other model (``modelx-torch push``). Tensors keep their
source names; ``--rename old=new`` handles prefix fixes (e.g. torch's
``module.``).
"""

from __future__ import annotations

import os
from typing import Callable


class OrbaxNotPortedError(ValueError):
    """``convert orbax`` in the port: the converter needs orbax, which only
    the JAX package may import."""

    def __init__(self, src: str) -> None:
        super().__init__(
            f"cannot convert {src}: restoring an orbax checkpoint needs orbax.checkpoint, "
            f"which modelx_tpu_torch does not import; convert it with the JAX package's "
            f"`modelx convert orbax SRC DST_DIR`, then push DST_DIR with `modelx-torch push`"
        )


def _apply_renames(tensors: dict, renames: list[str]) -> dict:
    """``old=new`` prefix rewrites, applied in order; ``old=`` strips."""
    for spec in renames:
        old, sep, new = spec.partition("=")
        if not sep or not old:
            raise ValueError(f"--rename wants OLD=NEW (prefixes), got {spec!r}")
        renamed: dict = {}
        for name, value in tensors.items():
            target = new + name[len(old):] if name.startswith(old) else name
            if target in renamed:
                # a collision would silently drop a weight from the artifact
                raise ValueError(
                    f"--rename {spec!r} maps two tensors onto {target!r}"
                )
            renamed[target] = value
        tensors = renamed
    return tensors


def convert_orbax(src: str, dst_dir: str, renames: list[str] | None = None,
                  log: Callable[[str], None] = lambda s: None) -> dict:
    """Refused in the port: see ``OrbaxNotPortedError``."""
    raise OrbaxNotPortedError(src)


def convert_torch(src: str, dst_dir: str, renames: list[str] | None = None,
                  log: Callable[[str], None] = lambda s: None) -> dict:
    """Convert a torch state_dict (.bin/.pt) to dst_dir/model.safetensors."""
    import torch

    state = torch.load(src, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]  # lightning-style wrapper
    tensors = {name: value.detach().cpu() for name, value in state.items()
               if isinstance(value, torch.Tensor)}  # skip non-tensor metadata entries
    if not tensors:
        raise ValueError(f"no tensors found in {src}")
    return _write_artifact(tensors, dst_dir, renames, log)


def _write_artifact(tensors: dict, dst_dir: str, renames: list[str] | None,
                    log: Callable[[str], None]) -> dict:
    """Shared converter tail: renames -> dst_dir/model.safetensors."""
    from modelx_tpu_torch.dl import safetensors as st

    tensors = _apply_renames(tensors, renames or [])
    os.makedirs(dst_dir, exist_ok=True)
    path = os.path.join(dst_dir, "model.safetensors")
    st.write_safetensors(path, tensors)
    log(f"{len(tensors)} tensors -> {path}")
    return {"tensors": len(tensors), "bytes": os.path.getsize(path), "path": path}
