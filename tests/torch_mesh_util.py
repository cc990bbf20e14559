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


# -- a serving pod on the group: rank 0 drives, the others follow ----------------

_POD_SEQ = [0]


def mesh_pod(model_dir: str, spec: str, server_kw: dict, set_kw: dict, drive: str,
             args: tuple = (), follower_kw: dict | None = None, namespace: str = ""):
    """Serve ``model_dir`` as model "m" on the mesh ``spec`` of the group:
    every rank builds the server (``server_kw``; a follower's options
    updated by ``follower_kw``) and loads it; rank 0 puts it behind a
    ``ServerSet`` (``set_kw``) with the op log attached and runs
    ``drive(sset, *args)`` (a function of this module) while the others
    replay the log, until rank 0 posts ``shutdown``. The result of rank 0's drive
    comes back; None from the others."""
    from modelx_tpu_torch.dl.mesh_serve import Follower, OpLog, follow
    from modelx_tpu_torch.dl.serve import ModelServer, ServerSet
    from modelx_tpu_torch.parallel import distributed
    from modelx_tpu_torch.parallel.mesh import make_mesh

    # every rank of the group counts every pod, those of a smaller mesh
    # too, so the ranks of a later pod name the same log
    _POD_SEQ[0] += 1
    mesh = make_mesh(spec)
    if mesh.coord is None:
        return None
    log = OpLog(distributed.control_store(), rank=mesh.rank, world=mesh.size,
                timeout_s=GROUP_TIMEOUT_S, namespace=f"{namespace}{_POD_SEQ[0]}/")
    kw = dict(server_kw)
    if not mesh.is_leader:
        kw.update(follower_kw or {})

    def make(name: str, path: str) -> ModelServer:
        return ModelServer(path, dtype="float32", device="cpu", max_seq_len=96, name=name,
                           mesh=mesh, **kw)

    servers = {"m": make("m", model_dir)}
    if not mesh.is_leader:
        for server in servers.values():
            server.load()
        follow(Follower(servers, make_server=make), log)
        return None
    sset = ServerSet(servers, mesh=mesh, **set_kw)
    sset.load_all()
    sset.oplog = log
    for server in servers.values():
        server.attach_oplog(log, sset.device_lock)
    try:
        return globals()[drive](sset, *args)
    finally:
        sset.close()
        log.post("shutdown")


def _http(port: int, method: str, path: str, body=None):
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def drive_http(sset, requests: list, burst: bool = False):
    """Rank 0: the pod's HTTP answers (status, body bytes) to ``requests``
    ([(method, path, body)]), one after another or, ``burst``, all at
    once; with the model's stats and the batcher's device calls."""
    import threading

    from modelx_tpu_torch.dl.serve import serve

    httpd = serve(sset, listen=f"127.0.0.1:{free_port()}")
    port = httpd.server_address[1]
    try:
        if burst:
            out = [None] * len(requests)

            def one(i, req):
                out[i] = _http(port, *req)

            threads = [threading.Thread(target=one, args=(i, r)) for i, r in enumerate(requests)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            out = [_http(port, *req) for req in requests]
        batcher = sset.batchers.get("m")
        return out, {"batches": batcher.batches if batcher is not None else 0,
                     "stats": dict(sset.servers["m"].stats) if "m" in sset.servers else {}}
    finally:
        httpd.shutdown()
        httpd.server_close()


def drive_engine(sset, cases: list, page_size: int = 0):
    """Rank 0: each case's (tokens, max_new_tokens, sampling) through the
    model's continuous engine and through the plain path on the same
    mesh, with the engine's snapshot and its cache leaves' shapes."""
    import numpy as np

    server = sset.servers["m"]
    cb = sset.continuous_for(server)
    out = []
    for tokens, n, samp in cases:
        tokens = np.asarray(tokens, np.int32)
        out.append((cb.generate(tokens, max_new_tokens=n, **samp),
                    server.generate(tokens, max_new_tokens=n, **samp)))
    shapes = {name: tuple(leaf.shape) for name, leaf in cb._cache.items()}
    return out, cb.snapshot(), shapes


def drive_engine_burst(sset, rows: list):
    """Rank 0: ``rows`` [(ids, max_new_tokens, sampling)] submitted to the
    model's continuous engine as one burst (FIFO after the first), each
    row's new tokens, with the prefix cache's stats."""
    import numpy as np

    server = sset.servers["m"]
    cb = sset.continuous_for(server)
    tickets = cb.submit_many(rows)
    out = [np.concatenate(list(cb._drain_row(t.out)), axis=1)[0].tolist() for t in tickets]
    return out, server._prefix_cache.stats()


def drive_scores(sset, rows: list, top_k: int):
    """Rank 0: ``score_logprobs_rows`` of ``rows``."""
    return sset.servers["m"].score_logprobs_rows(rows, top_k=top_k)


def drive_streams(sset, prompts: list, n: int, samp: dict):
    """Rank 0: one stream per prompt, in turn (the prefix cache's path),
    with the cache's stats after."""
    import numpy as np

    server = sset.servers["m"]
    out = []
    for ids in prompts:
        pieces = list(server.generate_stream(np.asarray([ids], np.int32), max_new_tokens=n,
                                             chunk_size=4, **samp))
        out.append(np.concatenate(pieces, axis=1)[0].tolist())
    return out, server._prefix_cache.stats() if server._prefix_cache is not None else None


def drive_kv_bundle(sset, prompts: list, n: int):
    """Rank 0: stream ``prompts`` (the last extends the first, so its
    entry is hit), then build the hot entry's bundle (its leaves gathered
    over tp) and return its bytes."""
    from modelx_tpu_torch.dl import kv_store

    server = sset.servers["m"]
    streamed, _stats = drive_streams(sset, prompts, n, {})
    (key, entry), = server._prefix_cache.take_publishable(1)
    return streamed, list(key), kv_store._build_for_server(server, key, entry, "")


def drive_kv_evicted(sset, hot: list, others: list, n: int):
    """Rank 0: stream ``hot`` and an extension (its entry is hit and taken
    for publishing), then ``others`` (their puts evict it), then build the
    taken entry's bundle and stream ``hot`` again: (the first streams, the
    bundle, the last stream)."""
    from modelx_tpu_torch.dl import kv_store

    server = sset.servers["m"]
    streamed, _stats = drive_streams(sset, [hot, hot + [4, 2]], n, {})
    (key, entry), = server._prefix_cache.take_publishable(1)
    drive_streams(sset, others, n, {})
    data = kv_store._build_for_server(server, key, entry, "")
    again, _stats = drive_streams(sset, [hot], n, {})
    return streamed, data, again[0]


def loaded_slices(model_dir: str, spec: str, server_kw: dict):
    """This rank's loaded params of a server on ``spec`` (the load runs on
    every rank): name -> (its slice's (start, stop) per dim, the tensor as
    numpy, or an int8 weight's (codes, scales))."""
    from modelx_tpu_torch.dl.serve import ModelServer
    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.ops.quant import QTensor
    from modelx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(spec)
    if mesh.coord is None:
        return None
    server = ModelServer(model_dir, dtype="float32", device="cpu", max_seq_len=96, mesh=mesh,
                         **server_kw)
    server.load()
    ctx = llama.sharding_ctx(server.cfg, mesh)
    shapes = llama.param_shapes(server.cfg)
    out = {}
    for name, t in server.params.items():
        box = [(sl.start, sl.stop) for sl in ctx.param_index(name, shapes[name])]
        val = (t.q.numpy(), t.scale.numpy()) if isinstance(t, QTensor) else t.numpy()
        out[name] = (box, val)
    return out


def drive_engine_crash(sset, tokens, n: int):
    """Rank 0: the engine's answer, then a chunk step that crashes before
    its post (every rank rebuilds its state from the op log's
    ``rebuild``), then the same request again."""
    import time

    import numpy as np

    from modelx_tpu_torch.dl.serving_errors import ServingError

    server = sset.servers["m"]
    cb = sset.continuous_for(server)
    tokens = np.asarray(tokens, np.int32)
    first = cb.generate(tokens, max_new_tokens=n)
    real, left = cb._chunk, [1]

    def crash(*a):
        if left[0]:
            left[0] -= 1
            raise RuntimeError("injected")
        return real(*a)

    cb._chunk = crash
    try:
        cb.generate(tokens, max_new_tokens=n)
        crashed = ""
    except ServingError as e:
        crashed = type(e).__name__
    deadline = time.monotonic() + 30
    while cb.engine_state != "running" and time.monotonic() < deadline:
        time.sleep(0.05)
    return first, crashed, cb.generate(tokens, max_new_tokens=n), cb.snapshot()["engine_restarts"]
