"""A gloo group of worker processes for the port's multi-device tests.

``GlooGroup(n)`` spawns n processes (``multiprocessing`` spawn, one torch
thread each) that join one gloo process group with a timeout, then run
module-level functions on request: ``run(fn, *args)`` sends ``fn`` to every
rank and returns the ranks' results in rank order. A test module keeps one
group for all its cases (spawning costs seconds). A rank that raises fails
the call with its traceback; a rank that does not answer within the
timeout fails it too, so a hung collective fails its test instead of
running into the suite's clock. The workers import torch and the port
only, never jax.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import socket
import traceback

GROUP_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, conn, timeout_s: float) -> None:
    import torch

    torch.set_num_threads(1)
    from modelx_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=timeout_s)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        modname, fname, args, kwargs = msg
        try:
            fn = getattr(importlib.import_module(modname), fname)
            conn.send(("ok", fn(*args, **kwargs)))
        except BaseException:  # noqa: BLE001 - the test reads the traceback
            conn.send(("err", traceback.format_exc()))
    distributed.shutdown()


class GlooGroup:
    def __init__(self, world: int, timeout_s: float = GROUP_TIMEOUT_S) -> None:
        ctx = mp.get_context("spawn")
        self.world = world
        self.timeout_s = timeout_s
        port = free_port()
        self.conns, self.procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(rank, world, port, child, timeout_s),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)

    def run(self, fn, *args, **kwargs) -> list:
        for conn in self.conns:
            conn.send((fn.__module__, fn.__name__, args, kwargs))
        out, errors = [], []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(self.timeout_s + 30):
                raise TimeoutError(f"rank {rank} did not answer {fn.__name__} in time")
            status, val = conn.recv()
            if status == "err":
                errors.append(f"rank {rank}:\n{val}")
            out.append(val)
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()


# -- functions the workers run ------------------------------------------------


def _llama_cfg(cfg_kw: dict):
    import torch

    from modelx_tpu_torch.models import llama

    kw = dict(cfg_kw)
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    return llama.LlamaConfig(**kw)


def _rank_params(np_params: dict, cfg, mesh) -> dict:
    from modelx_tpu_torch.dl.weights import shard_jax_params

    return shard_jax_params(np_params, cfg, mesh, device="cpu")


def llama_logits(np_params: dict, tokens, cfg_kw: dict, spec: str, impl: str = "auto"):
    """The mesh forward's logits (numpy) on rank 0, None elsewhere."""
    import torch

    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.parallel.mesh import make_mesh

    cfg = _llama_cfg(cfg_kw)
    mesh = make_mesh(spec)
    if mesh.coord is None:  # past the mesh's prefix of the world
        return None
    params = _rank_params(np_params, cfg, mesh)
    with torch.inference_mode():
        logits, _ = llama.forward(params, torch.as_tensor(tokens), cfg, mesh=mesh,
                                  attention_impl=impl)
    return logits.float().numpy() if mesh.is_leader else None


def llama_generate(np_params: dict, prompt, cfg_kw: dict, spec: str, n: int,
                   impl: str = "auto", **sampling):
    """The mesh's ragged decode of ``prompt`` (numpy tokens) on every rank
    of the mesh (None past its prefix of the world)."""
    import numpy as np
    import torch

    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.parallel.mesh import make_mesh

    cfg = _llama_cfg(cfg_kw)
    mesh = make_mesh(spec)
    if mesh.coord is None:
        return None
    params = _rank_params(np_params, cfg, mesh)
    prompt = torch.as_tensor(prompt)
    with torch.inference_mode():
        out = llama.ragged_greedy_generate(
            params, prompt, np.full((prompt.shape[0],), prompt.shape[1]), cfg,
            max_new_tokens=n, mesh=mesh, attention_impl=impl, **sampling)
    return out.numpy()


def sp_attention(q, k, v, spec: str, impl: str, causal: bool = True, block_k: int = 0):
    """Ring or Ulysses over the mesh's sp axis from global numpy q/k/v:
    each rank takes its sequence shard, and rank 0 returns the output
    gathered over sp (numpy). A ``ValueError`` comes back as its message."""
    import torch

    from modelx_tpu_torch.ops import attention
    from modelx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(spec)
    if mesh.coord is None:  # past the mesh's prefix of the world
        return None
    n, i = mesh.axis_size("sp"), mesh.axis_index("sp")
    s = q.shape[2] // n
    q, k, v = (torch.as_tensor(x[:, :, i * s:(i + 1) * s]) for x in (q, k, v))
    try:
        if impl == "ring":
            out = attention.ring_attention(q, k, v, mesh, axis="sp", causal=causal,
                                           block_k=block_k)
        else:
            out = attention.ulysses_attention(q, k, v, mesh, axis="sp", causal=causal)
    except ValueError as e:
        return str(e)
    out = mesh.all_gather(out, "sp", dim=2)
    return out.numpy() if mesh.is_leader else None


def mesh_layout(spec: str):
    """This rank's (rank, coordinate, each axis group's ranks)."""
    import torch.distributed as dist

    from modelx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(spec)
    groups = {a: (dist.get_process_group_ranks(mesh.group(a)) if mesh.group(a) else None)
              for a in mesh.axis_names}
    return mesh.rank, mesh.coord, groups


def collectives(spec: str):
    """All-reduce, all-gather and the leader broadcast over a live mesh."""
    import torch

    from modelx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(spec)
    r = mesh.rank
    summed = mesh.all_reduce(torch.full((2,), float(r)), "tp").tolist()
    gathered = mesh.all_gather(torch.tensor([[r]]), "tp", dim=1).tolist()
    leader = mesh.broadcast_from_leader(torch.tensor([r + 10])).tolist()
    return summed, gathered, leader


def host_slices(total: int):
    from modelx_tpu_torch.parallel import distributed

    return distributed.process_span(), distributed.host_local_slice(total)
