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
  ``ModelServer`` method, whose collectives then meet rank 0's.

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
                 timeout_s: float = 300.0) -> None:
        import torch.distributed as dist

        self._store = dist.PrefixStore("modelx/ops/", store)
        self._done = dist.PrefixStore("modelx/done/", store)
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
        sequence number."""
        self.check()
        head = {"op": op, "model": model, **fields}
        body = b""
        if tokens is not None:
            arr = np.ascontiguousarray(np.asarray(tokens, np.int64))
            head["shape"] = list(arr.shape)
            body = arr.tobytes()
        payload = json.dumps(head).encode() + b"\n" + body
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

    def read(self) -> tuple[int, dict, np.ndarray | None]:
        """The next op (followers) and its sequence number, waiting as long
        as the leader lives."""
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
        tokens = None
        if "shape" in head:
            tokens = np.frombuffer(body, np.int64).reshape(head.pop("shape")).copy()
        return seq, head, tokens


def _arr(x, dtype):
    return None if x is None else np.asarray(x, dtype)


def follow(servers: dict, log: OpLog) -> int:
    """A follower's loop: replay rank 0's ops on ``servers`` (name ->
    loaded ``ModelServer``) until ``shutdown``; returns 0 then. Each op's
    outcome goes to the log. An op that raises a ``request_error`` failed
    the same way on rank 0 (or rank 0 waits the outcome out): the loop
    goes on. Any other error ends the loop with the exception (the leader
    fails its request on the broken collective)."""
    streams: dict[int, object] = {}
    while True:
        seq, op, tokens = log.read()
        if op["op"] == "shutdown":
            for gen in streams.values():
                gen.close()
            return 0
        try:
            _replay(servers, streams, op, tokens)
        except Exception as e:
            log.report(seq, _outcome(e))
            if not request_error(e):
                raise
            logger.warning("mesh op %d (%s) failed as a request: %s", seq, op["op"], e)
        else:
            log.report(seq, "ok")


def _replay(servers: dict, streams: dict, op: dict, tokens) -> None:
    kind = op["op"]
    server = servers[op["model"]]
    if kind == "forward":
        server._argmax(tokens)
    elif kind == "generate":
        server._generate_ragged(
            tokens, np.asarray(op["row_lens"], np.int64), op["n"],
            temperature=_arr(op.get("temperature"), np.float32),
            top_k=_arr(op.get("top_k"), np.int32), top_p=_arr(op.get("top_p"), np.float32),
            seeds=_arr(op.get("seeds"), np.int64))
    elif kind == "stream_open":
        gen = server._stream_pieces(
            tokens.astype(np.int32), op["n"], temperature=op["temperature"],
            top_k=op["top_k"], top_p=op["top_p"], seed=op["seed"],
            chunk_size=op["chunk_size"], stop_token_ids=op["stop_token_ids"])
        streams[op["sid"]] = gen
        server._follow_piece(gen)
    elif kind == "stream_next":
        server._follow_piece(streams[op["sid"]])
    elif kind == "stream_close":
        gen = streams.pop(op["sid"], None)
        if gen is not None:
            gen.close()
    else:
        raise RuntimeError(f"unknown mesh op {kind!r}")
