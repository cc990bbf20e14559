"""Serving one model set across a mesh of processes, one per card.

The reference serves a mesh from one process: it drives every local device
and GSPMD inserts the collectives. The port runs one process per card, so
every device call must run on every rank, in the same order, with the same
arguments. Rank 0 binds HTTP and owns the answers; the other ranks (the
followers) load the same models and replay rank 0's device calls:

- Each device call rank 0 makes under a model's ``_device_lock`` is first
  appended to an op log: a small JSON header (the op, the model and its
  scalars) and the request's token ids, under a sequence number in the
  process group's rendezvous store (``distributed.control_store``). The
  device lock orders the calls, so the log's order is the execution order.
- A follower (``follow``) reads the log in sequence and runs the same
  device work, whose collectives then meet rank 0's.

The ops, and the host decisions each carries so that no follower makes
one of its own: ``forward``, ``generate`` (a window batcher's group is one,
its members and padding in its rows and row lengths), ``score``
(``logprobs``), ``stream_open``/``_next``/``_close`` (the prefix-cache hit
by its entry's digest), ``spec_open``/``_verify``/``_close`` (rank 0's
proposals and the offset its accepted count rolled back to),
``prefix_evict`` (rank 0's evictions), ``kv_gather`` (a KV bundle's
leaves gathered over tp), ``engine_open`` and ``engine`` (each continuous
engine step with its slots, pages, offsets, tokens and sampling vectors;
``dl/continuous.py``), and ``admin_load``/``admin_unload`` (the pool's
runtime loads and unloads, with the state-tier key every rank demotes or
promotes its slices under).

The log lives in the store rather than in a collective so that an idle
follower waits for the next request without a collective timing out, and
rank 0 never waits on a follower to post. Rank 0 waits on followers only
inside the forward's collectives, which carry the group's timeout: a
follower that dies or stalls fails the request with a 503
(``MeshFailedError``), marks the log failed (every later request answers
503 at once), and ``serve_main`` exits non-zero. A follower whose leader
is gone (the store's connection breaks) or that reads ``shutdown`` exits.

A request can also fail the same way on every rank: out of memory for
its [B, S], or a bad argument (``request_error``). Each follower reports
every op's outcome to the store; when rank 0's op raises such an error it
waits for the followers' outcomes, and if every follower finished the op
(its own error of that kind, or none) no rank is left inside a collective:
the request answers its error and the mesh serves on. A follower that
reports any other error, or none within the group's timeout, fails the
mesh as above.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
import threading
import time

import numpy as np

from modelx_tpu_torch.dl.serving_errors import ServingError

logger = logging.getLogger("modelx.mesh")

# ops kept in the store behind the newest; a follower never lags further
# (every op with device work meets rank 0 in a collective)
KEEP_OPS = 4096
# a follower's wait for the next op, re-armed while the leader lives
POLL_S = 30.0


class MeshFailedError(ServingError):
    """A rank of the serving mesh died, stalled past the group's timeout or
    failed a collective: the mesh cannot answer (503), and the pod exits."""

    http_status = 503


def request_error(e: BaseException) -> bool:
    """Whether ``e`` is an error one request causes the same way on every
    rank: out of memory (the card's, or the host allocator's on the CPU)
    or a bad argument. A collective's error or timeout and a rank gone are
    not: they break the mesh."""
    import torch

    if isinstance(e, (torch.OutOfMemoryError, ValueError)):
        return True
    return isinstance(e, RuntimeError) and "can't allocate memory" in str(e)


def _outcome(e: BaseException | None) -> str:
    if e is None:
        return "ok"
    return f"request {type(e).__name__}" if request_error(e) else f"fatal {type(e).__name__}"


class OpLog:
    """The ordered device calls of rank 0, in the group's store, and the
    followers' outcome of each."""

    def __init__(self, store, children=(), rank: int = 0, world: int = 1,
                 timeout_s: float = 300.0, namespace: str = "") -> None:
        import torch.distributed as dist

        # ``namespace`` parts logs that share one store (one per pod)
        self._store = dist.PrefixStore(f"modelx/{namespace}ops/", store)
        self._done = dist.PrefixStore(f"modelx/{namespace}done/", store)
        self._seq = 0
        self._lock = threading.Lock()
        self.rank, self.world, self.timeout_s = rank, world, float(timeout_s)
        # the follower processes rank 0 started (subprocess.Popen), watched
        # before each post so a dead one fails fast
        self.children = list(children)
        self.failed: str | None = None
        self.failed_event = threading.Event()

    def fail(self, reason: str) -> None:
        if self.failed is None:
            self.failed = reason
            logger.error("serving mesh failed: %s", reason)
        self.failed_event.set()

    def check(self) -> None:
        """Raise ``MeshFailedError`` once the mesh is known to be broken."""
        for i, p in enumerate(self.children, start=1):
            rc = p.poll()
            if rc is not None:
                self.fail(f"mesh rank {i} exited with code {rc}")
        if self.failed is not None:
            raise MeshFailedError(f"serving mesh unavailable: {self.failed}")

    def post(self, op: str, model: str = "", tokens=None, **fields) -> int:
        """Append one op (rank 0; the caller holds the device lock); its
        sequence number. ``tokens`` (as int64) and every numpy array among
        ``fields`` ride as raw bytes after the JSON header, which names
        each one's dtype and shape."""
        self.check()
        named = {} if tokens is None else {"tokens": np.asarray(tokens, np.int64)}
        named.update((k, v) for k, v in fields.items() if isinstance(v, np.ndarray))
        head = {"op": op, "model": model,
                **{k: v for k, v in fields.items() if k not in named}}
        parts = []
        if named:
            head["arrays"] = []
            for name, arr in named.items():
                arr = np.ascontiguousarray(arr)
                head["arrays"].append([name, arr.dtype.str, list(arr.shape)])
                parts.append(arr.tobytes())
        payload = json.dumps(head).encode() + b"\n" + b"".join(parts)
        with self._lock:
            self._store.set(str(self._seq), payload)
            if self._seq >= KEEP_OPS:
                self._store.delete_key(str(self._seq - KEEP_OPS))
            self._seq += 1
            return self._seq - 1

    def report(self, seq: int, outcome: str) -> None:
        """A follower's outcome of op ``seq`` ("ok", "request <error>" or
        "fatal <error>")."""
        self._done.set(f"{seq}/{self.rank}", outcome)
        if seq >= KEEP_OPS:
            self._done.delete_key(f"{seq - KEEP_OPS}/{self.rank}")

    def in_step(self, seq: int) -> bool:
        """Rank 0, after op ``seq`` raised a ``request_error``: whether every
        follower finished that op, each with no error or one of that kind,
        so that no rank is left inside a collective. Waits up to the group's
        timeout (and a margin) for the outcomes; a follower that exits or
        reports another error makes it False at once."""
        deadline = time.monotonic() + self.timeout_s + 10.0
        for rank in range(1, self.world):
            key = f"{seq}/{rank}"
            while True:
                try:
                    self._done.wait([key], datetime.timedelta(seconds=1.0))
                    break
                except Exception as e:  # the store's timeout, or the leader's store gone
                    if "timeout" not in str(e).lower():
                        raise
                if any(p.poll() is not None for p in self.children):
                    return False
                if time.monotonic() > deadline:
                    return False
            if self._done.get(key).decode().startswith("fatal"):
                return False
        return True

    def read(self) -> tuple[int, dict, dict]:
        """The next op (followers): its sequence number, its header and its
        arrays by name (``"tokens"`` among them when posted), waiting as
        long as the leader lives."""
        seq = self._seq
        key = str(seq)
        while True:
            try:
                self._store.wait([key], datetime.timedelta(seconds=POLL_S))
                break
            except Exception as e:  # the store's timeout, or the leader gone
                if "timeout" not in str(e).lower():
                    raise
        payload = self._store.get(key)
        self._seq += 1
        head_raw, _, body = payload.partition(b"\n")
        head = json.loads(head_raw)
        arrays, at = {}, 0
        for name, dtype, shape in head.pop("arrays", ()):
            dt = np.dtype(dtype)
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            arrays[name] = np.frombuffer(body[at:at + n], dt).reshape(shape).copy()
            at += n
        return seq, head, arrays


@contextlib.contextmanager
def guarded(oplog: OpLog, seq: int):
    """Rank 0, around the device work of op ``seq`` (posted): an error
    fails the mesh (``MeshFailedError``, 503) unless it is a
    ``request_error`` every follower met alike (``OpLog.in_step``)."""
    try:
        yield
    except MeshFailedError:
        raise
    except Exception as e:
        if request_error(e) and oplog.in_step(seq):
            raise
        oplog.fail(f"{type(e).__name__}: {e}")
        raise MeshFailedError(f"serving mesh failed: {e}") from e


def _arr(x, dtype):
    return None if x is None else np.asarray(x, dtype)


class Follower:
    """A follower rank's serving state: its loaded models (name ->
    ``ModelServer``), the streams rank 0 opened (by model and id), and for
    the admin ops
    ``make_server(name, model_dir)`` (a server built with this pod's
    options) and the rank's own state tiers (``dl/tiers.TierStore``,
    None when off), into which an unloaded model's slices demote and from
    which a reload promotes them."""

    def __init__(self, servers: dict, make_server=None, tiers=None) -> None:
        self.servers = servers
        self.make_server = make_server
        self.tiers = tiers
        self.streams: dict[int, object] = {}

    def close(self) -> None:
        for gen in self.streams.values():
            gen.close()
        self.streams.clear()


def follow(state: Follower, log: OpLog) -> int:
    """A follower's loop: replay rank 0's ops on ``state``'s models until
    ``shutdown``; returns 0 then. Each op's outcome goes to the log. An op that raises a
    ``request_error`` failed the same way on rank 0 (or rank 0 waits the
    outcome out): the loop goes on. Any other error ends the loop with the
    exception (the leader fails its request on the broken collective)."""
    for server in state.servers.values():
        server.follow_mesh()
    while True:
        seq, op, arrays = log.read()
        if op["op"] == "shutdown":
            state.close()
            return 0
        try:
            _replay(state, op, arrays)
        except Exception as e:
            log.report(seq, _outcome(e))
            if not request_error(e):
                raise
            logger.warning("mesh op %d (%s) failed as a request: %s", seq, op["op"], e)
        else:
            log.report(seq, "ok")


def _replay(state: Follower, op: dict, arrays: dict) -> None:
    import torch

    kind = op["op"]
    if kind in ("admin_load", "admin_unload"):
        return _replay_admin(state, kind, op)
    server = state.servers[op["model"]]
    tokens = arrays.pop("tokens", None)
    with server._device_lock, torch.inference_mode():
        _replay_on(server, state.streams, kind, op, tokens, arrays)


def _replay_on(server, streams: dict, kind: str, op: dict, tokens, arrays: dict) -> None:
    if kind in ("forward", "score"):  # rank 0 reads the argmax or the logprobs
        server.family.forward(server.params, server._tokens(tokens), server.cfg,
                              **server._mesh_kw())
    elif kind == "generate":
        server.family.generate_ragged(
            server.params, server._tokens(tokens), np.asarray(op["row_lens"], np.int64),
            server.cfg, max_new_tokens=op["n"],
            temperature=_arr(op.get("temperature"), np.float32),
            top_k=_arr(op.get("top_k"), np.int32), top_p=_arr(op.get("top_p"), np.float32),
            seeds=_arr(op.get("seeds"), np.int64), **server._mesh_kw())
    elif kind == "stream_open":
        hit = None
        if op.get("hit") is not None:
            hit = server._prefix_cache.by_digest(op["hit"])
        gen = server._stream_pieces(
            tokens.astype(np.int32), op["n"], temperature=op["temperature"],
            top_k=op["top_k"], top_p=op["top_p"], seed=op["seed"],
            chunk_size=op["chunk_size"], stop_token_ids=op["stop_token_ids"], hit=hit)
        streams[(op["model"], op["sid"])] = gen
        next(gen, None)
    elif kind == "stream_next":
        next(streams[(op["model"], op["sid"])], None)
    elif kind == "stream_close":
        gen = streams.pop((op["model"], op["sid"]), None)
        if gen is not None:
            gen.close()
    elif kind == "spec_open":
        from modelx_tpu_torch.models.speculative import SpecSession

        fields = {k: op[k] for k in ("real_len", "cache_len", "temperature", "top_k",
                                     "top_p", "seed")}
        server._spec_sessions[op["sid"]] = SpecSession(
            server._speculative_decoder(), server.params, prompt=arrays["prompt"], **fields)
    elif kind == "spec_verify":
        server._spec_sessions[op["sid"]].verify(arrays["block"], op["offset"], op["draws"])
    elif kind == "spec_close":
        server._spec_sessions.pop(op["sid"], None)
    elif kind == "kv_gather":
        _plen, entry = server._prefix_cache.by_digest(op["digest"])
        ctx = server._kv_ctx()
        for name in sorted(entry):  # rank 0's order (ModelServer.whole_kv)
            server._gather_heads(entry[name], ctx)
    elif kind == "prefix_evict":
        server._prefix_cache.evict(op["digests"])
    elif kind == "engine_open":
        from modelx_tpu_torch.dl.continuous import ContinuousBatcher

        server._engine_replica = None  # a rebuilt engine's memory first
        fields = {k: v for k, v in op.items() if k not in ("op", "model")}
        server._engine_replica = ContinuousBatcher(
            server, **fields, prefix_cache=server._prefix_cache, flight_recorder=False,
            device_telemetry=False, replica=True)
    elif kind == "engine":
        step = op["step"]
        inputs = {k: v for k, v in op.items() if k not in ("op", "model", "step")}
        inputs.update(arrays)
        server._engine_replica.replay(step, inputs)
        if step == "release":
            server._engine_replica = None
    else:
        raise RuntimeError(f"unknown mesh op {kind!r}")


def _replay_admin(state: Follower, kind: str, op: dict) -> None:
    """A runtime load (this rank reads its own byte ranges, or promotes
    its own slices from its tiers) or an unload (its slices demote to its
    tiers, then free), as rank 0's pool decided."""
    name = op["model"]
    old = state.servers.pop(name, None)
    if old is not None:
        _free(state, name, old, op.get("tier_key", "") if kind == "admin_unload" else "")
    if kind == "admin_unload":
        return
    promo = None
    if op.get("tier_key") and state.tiers is not None:
        promo = state.tiers.promote(op["tier_key"])
    if promo is None and not op.get("source_dir"):
        raise RuntimeError(f"mesh admin load of {name}: no checkpoint and no tier entry "
                           "on this rank")
    server = state.make_server(name, op.get("source_dir") or "")
    server.follow_mesh()
    if promo is not None:
        server.load_from_tier(promo)
    else:
        server.load()
    state.servers[name] = server


def _free(state: Follower, name: str, server, tier_key: str) -> None:
    """Drop a follower's model: its engine replica and sessions, its
    slices demoted to its tiers under rank 0's key first."""
    for key in [k for k in state.streams if k[0] == name]:
        state.streams.pop(key).close()
    from modelx_tpu_torch.dl.lifecycle import ModelPool

    server._engine_replica = None
    server._spec_sessions.clear()
    if tier_key and state.tiers is not None and state.tiers.enabled \
            and server.params is not None:
        try:
            state.tiers.offer(tier_key, name, server.params, family=server.family,
                              cfg=server.cfg)
        except Exception:
            logger.exception("demotion of %s on this rank failed; state discarded", name)
    ModelPool._free_server(name, server)
