"""Joining the process group, and host-local helpers (counterpart of
``modelx_tpu/parallel/distributed.py``).

The port runs one process per card. ``initialize`` joins them into one
``torch.distributed`` group: the reference's ``MODELX_COORDINATOR``
(``host:port`` of rank 0), ``MODELX_NUM_PROCESSES`` and
``MODELX_PROCESS_ID``, or torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. Rank r computes on
``cuda:LOCAL_RANK`` (the process id when no local rank is given). The
backend follows the device the caller names (``nccl`` for cuda, ``gloo``
for cpu) unless the caller names one; it is never switched quietly. The
group's rendezvous store stays open after the join: ``control_store()``
is where rank 0 posts the op log its followers replay (``dl/mesh_serve.py``).
"""

from __future__ import annotations

import datetime
import logging
import os

import torch

logger = logging.getLogger("modelx.distributed")

# how long a collective (or the rendezvous) may wait on a peer before it
# fails: a dead or stalled rank must not hang the others for ever
DEFAULT_TIMEOUT_S = 300.0

_initialized = False
_store = None
_device: torch.device | None = None


def _env_int(*names: str) -> int | None:
    for name in names:
        val = os.environ.get(name)
        if val not in (None, ""):
            return int(val)
    return None


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str | torch.device = "cuda",
               backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent join of the process group; True when this process is in
    one (now or before), False for a single-process run (nothing
    configured), which is a no-op.

    Resolution per argument: explicit > the MODELX_* variables > torchrun's.
    ``device`` "cuda" takes ``cuda:LOCAL_RANK`` (``cuda:N`` is taken as
    named); a rank whose card is missing raises, it never moves to another
    card or to the CPU."""
    global _initialized, _store, _device
    import torch.distributed as dist

    if _initialized or dist.is_initialized():
        return True
    env = os.environ
    torchrun = bool(env.get("MASTER_ADDR")) and env.get("RANK") not in (None, "")
    if coordinator_address is None:
        coordinator_address = env.get("MODELX_COORDINATOR") or None
    if coordinator_address is None and torchrun:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("MODELX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("MODELX_PROCESS_ID", "RANK")
    if coordinator_address is None and num_processes is None:
        logger.debug("single-process run; no process group")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs a coordinator (host:port), a process count and this "
            f"process's id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else _env_int("LOCAL_RANK")
        local = process_id if local is None else local
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= have:
            raise RuntimeError(f"rank {process_id} wants cuda:{local}, but this host has "
                               f"{have} CUDA device(s)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    host, _, port = coordinator_address.rpartition(":")
    if torchrun and env.get("TORCHELASTIC_USE_AGENT_STORE") == "True":
        # torchrun's agent already hosts the store at MASTER_PORT
        dist.init_process_group(backend, init_method="env://", rank=process_id,
                                world_size=num_processes, timeout=timeout)
        store = dist.distributed_c10d._get_default_store()
    else:
        store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                              is_master=(process_id == 0), timeout=timeout)
        dist.init_process_group(backend, store=store, rank=process_id,
                                world_size=num_processes, timeout=timeout)
    _initialized, _store, _device = True, store, dev
    logger.info("distributed: process %d/%d on %s over %s", process_id, num_processes,
                dev, backend)
    return True


def control_store():
    """The group's rendezvous store (None without a group)."""
    return _store


def local_device() -> torch.device:
    """The device this rank computes on: the one ``initialize`` chose, or
    the CPU without a group."""
    return _device if _device is not None else torch.device("cpu")


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    global _initialized, _store, _device
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _store, _device = False, None, None


def process_span() -> tuple[int, int]:
    """(process_index, process_count); (0, 1) without a group. Calls
    :func:`initialize` first (idempotent, a no-op when single-process)."""
    import torch.distributed as dist

    initialize()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_slice(total: int) -> tuple[int, int]:
    """Even [start, stop) split of ``total`` items for this process: the
    pattern for sharding host-side work (e.g. which files of a multi-file
    checkpoint this host reads) before device placement takes over."""
    idx, count = process_span()
    per = (total + count - 1) // count
    start = min(idx * per, total)
    return start, min(start + per, total)
