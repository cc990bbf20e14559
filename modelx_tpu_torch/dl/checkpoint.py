"""Checkpoint and resume through the registry (counterpart of
``modelx_tpu/dl/checkpoint.py``).

A training state (params, the AdamW state of ``models/train.py`` and the
step) is flattened to named tensors and written as layer-grouped
safetensors shards, ``state-base.safetensors`` and
``state-layer-NNNNN.safetensors``, with ``checkpoint.json`` renamed into
place last as the commit point. Grouping by layer makes incremental push
real: after more steps only the shards whose bytes changed upload (the
push's content-address dedup).

A checkpoint crosses between the packages both ways: for the same tensors
the port writes the JAX package's bytes. The optimizer leaves take optax's
tree-path names (``__opt__0|count``, ``__opt__0|mu|<param>``,
``__opt__0|nu|<param>``), and the 0-d ``count`` is written with shape
``[1]``, as the reference's writer stores every 0-d array (its
``np.ascontiguousarray`` makes it 1-d); restore reads either shape.

    ckpt = Checkpointer(dir)
    ckpt.save(params, opt_state, step=100)
    ckpt.push("http://registry/library/run@v1")
    params, opt_state, step = ckpt.restore(template_params, template_opt, device="cuda")

Restore streams the params onto the device through the loader
(``dl/loader.py load_safetensors``); each moment follows its param there.
"""

from __future__ import annotations

import glob
import json
import os
import re

import torch

from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.models.train import AdamWState

STEP_FILE = "checkpoint.json"
_OPT_PREFIX = "__opt__"
_SEP = "|"
# optax.adamw is a chain; its member 0 (scale_by_adam) holds the state
_ADAM = "0"


# -- optimizer state <-> flat named tensors -------------------------------------


def flatten_state(opt_state: AdamWState) -> dict[str, torch.Tensor]:
    """The optimizer state as named tensors under optax's tree-path names
    (the 0-d count as shape [1], the reference's bytes)."""
    flat = {f"{_OPT_PREFIX}{_ADAM}{_SEP}count": opt_state.count.reshape(1)}
    for field in ("mu", "nu"):
        for name, t in getattr(opt_state, field).items():
            flat[f"{_OPT_PREFIX}{_ADAM}{_SEP}{field}{_SEP}{name}"] = t
    return flat


def restore_state(template: AdamWState, flat: dict[str, torch.Tensor]) -> AdamWState:
    """An ``AdamWState`` shaped like ``template`` from flattened tensors
    (each leaf as stored; a [1] count becomes 0-d)."""

    def leaf(key: str, want: torch.Size) -> torch.Tensor:
        key = _OPT_PREFIX + key
        if key not in flat:
            raise KeyError(f"checkpoint missing optimizer leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(want):
            if arr.numel() != want.numel():
                raise ValueError(f"optimizer leaf {key}: shape {tuple(arr.shape)} != "
                                 f"{tuple(want)}")
            arr = arr.reshape(want)  # 0-d leaves round-trip as shape-(1,)
        return arr

    return AdamWState(
        count=leaf(f"{_ADAM}{_SEP}count", template.count.shape),
        mu={n: leaf(f"{_ADAM}{_SEP}mu{_SEP}{n}", t.shape) for n, t in template.mu.items()},
        nu={n: leaf(f"{_ADAM}{_SEP}nu{_SEP}{n}", t.shape) for n, t in template.nu.items()},
    )


# -- layer-grouped shards ---------------------------------------------------------

_LAYER = re.compile(r"(?:^|\.)layers?\.(\d+)\.")


def group_key(name: str) -> str:
    """Shard group of a tensor: its layer index, or 'base' for the rest.
    Optimizer leaves group with the params they track."""
    m = _LAYER.search(name.replace(_SEP, "."))
    return f"layer-{int(m.group(1)):05d}" if m else "base"


def save_sharded(directory: str, tensors: dict) -> list[str]:
    """Write tensors (torch, any device, or numpy) as layer-grouped
    safetensors files, each group's tensors in name order. Deterministic
    grouping and serialization: an unchanged layer writes the same bytes
    (the dedup unit). Each shard goes to a temp name and is renamed, so a
    crash mid-save never corrupts an existing shard."""
    groups: dict[str, dict] = {}
    for name, arr in sorted(tensors.items()):
        groups.setdefault(group_key(name), {})[name] = arr
    os.makedirs(directory, exist_ok=True)
    written = []
    for key, members in sorted(groups.items()):
        fname = f"state-{key}.safetensors"
        path = os.path.join(directory, fname)
        tmp = path + f".tmp-{os.getpid()}"
        st.write_safetensors(tmp, members)
        os.replace(tmp, path)
        written.append(fname)
    return written


class Checkpointer:
    """Save and restore a (params, opt_state, step) training state in a
    local directory shaped for registry push (content-addressed,
    incremental)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory

    def save(self, params: dict, opt_state: AdamWState | None = None, step: int = 0) -> list[str]:
        tensors = dict(params)
        if opt_state is not None:
            tensors.update(flatten_state(opt_state))
        written = save_sharded(self.directory, tensors)
        meta = {"step": int(step), "files": written, "params": sorted(params)}
        tmp = os.path.join(self.directory, STEP_FILE + f".tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
        os.replace(tmp, os.path.join(self.directory, STEP_FILE))  # commit point
        # prune shards of an older layout only AFTER the commit point, and
        # only this class's own state-*.safetensors: the directory may also
        # hold pulled model weights, which a save never touches
        for path in glob.glob(os.path.join(self.directory, "state-*.safetensors")):
            if os.path.basename(path) not in written:
                os.unlink(path)
        return written

    def _meta(self) -> dict:
        meta_path = os.path.join(self.directory, STEP_FILE)
        if not os.path.exists(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)

    def _shard_paths(self) -> list[str]:
        files = self._meta().get("files")
        if files:
            return [os.path.join(self.directory, fn) for fn in files]
        return sorted(glob.glob(os.path.join(self.directory, "*.safetensors")))

    def restore(self, template_params: dict, template_opt: AdamWState | None = None,
                device=None) -> tuple[dict, AdamWState | None, int]:
        """Returns (params, opt_state, step). The params stream onto
        ``device`` (default: the CPU) through the loader; the optimizer
        leaves are read on the host and each moment moves to its param's
        device, the count to the first param's."""
        from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors

        device = torch.device(device) if device is not None else torch.device("cpu")
        step = int(self._meta().get("step", 0))
        params: dict[str, torch.Tensor] = {}
        opt_flat: dict[str, torch.Tensor] = {}
        for path in self._shard_paths():
            infos, off = st.read_header_from_file(path)
            opt_names = {n for n in infos if n.startswith(_OPT_PREFIX)}
            if opt_names:
                opt_flat.update(st.read_tensors(path, lambda n: n in opt_names))
            wanted = {n: i for n, i in infos.items() if n not in opt_names}
            if not wanted:
                continue
            src = LocalFileSource(path)
            try:
                loaded, _stats = load_safetensors(src, device, tensors=wanted, data_offset=off)
            finally:
                src.close()
            params.update(loaded)

        missing = set(template_params) - set(params)
        if missing:
            raise KeyError(f"checkpoint missing params: {sorted(missing)[:4]}...")

        opt_state = None
        if template_opt is not None:
            opt_state = restore_state(template_opt, opt_flat)
            opt_state.count = opt_state.count.to(device)
            for field in (opt_state.mu, opt_state.nu):
                for name in field:
                    where = params[name].device if name in params else device
                    field[name] = field[name].to(where)
        return params, opt_state, step

    def push(self, uri: str, quiet: bool = True) -> None:
        """Push the checkpoint directory as a model version; unchanged layer
        shards are skipped by content-address dedup."""
        from modelx_tpu_torch.client.reference import parse_reference

        ref = parse_reference(uri)
        ref.client(quiet=quiet).push(ref.repository, ref.version or "latest", self.directory)
