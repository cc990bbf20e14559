"""Continuous (in-flight) batching: requests join a RUNNING decode
(counterpart of ``modelx_tpu/dl/continuous.py``).

The window batcher (``dl/serve.Batcher``) coalesces only requests that
arrive within a few ms of each other; anything landing mid-decode waits for
the whole previous ragged decode. This engine removes that wait: a fixed
slot array decodes forever in ``chunk_size``-step chunks, and new requests
are admitted into free slots at chunk boundaries (iteration-level
scheduling). The JAX twin compiles one program per shape; here every
"program" is an eager step at a fixed shape:

- **One KV state, allocated once.** A dense cache of ``[max_slots,
  max_len]`` per layer (or, paged, a pool of pages) lives on the device
  for the engine's lifetime and every step writes into it in place. Every
  chunk step runs at ``[max_slots, 1]`` and attends over the whole
  ``max_len`` span, as the JAX twin's does: a row's bits then depend on
  nothing but its own tokens, whatever the other slots hold (a span cut to
  the longest live row would change the reductions' length, and with it
  the bf16 rounding, with the schedule). Per-slot prompt lengths, decode
  depths and sampling controls are host numpy vectors uploaded per
  dispatch, never shapes.
- **Paged KV (``page_size`` > 0)**: the per-layer state is a POOL of
  fixed-size pages plus a host block table, so device memory scales with
  LIVE tokens instead of ``max_slots x max_len``. Admissions reserve their
  span's pages up front (waiting FIFO when the pool is full), retirements
  recycle them; page 0 is a trash page no slot owns. ``paged_attention=
  "gather"`` builds one layer's dense view of every slot's pages at a time
  inside the family forward (the transient is one layer's k and v view,
  written back row by row), the dense engine's bits; ``"in-place"`` reads
  the pools directly through the family's paged forward
  (``ops/paged_attention.py``), whose loop stops at the longest live row's
  page: a fully masked block's update is the identity, so that bound is
  exact and schedule-invariant too.
- **Admission = prefill into a fresh [1, S] cache + one row copy of that
  cache into the slot** (grouped: same-bucket arrivals share one [m, S]
  prefill, m a power of two). The running batch never re-prefills.
- **Chunked prefill (``prefill_chunk`` > 0):** a long prompt lands piece
  by piece between decode chunks under a per-boundary token budget
  (``prefill_budget``), so one long admission cannot freeze the running
  batch; a page-blocked fill waits, and if every fill is blocked with no
  decode row left to retire, the youngest is preempted (it emitted
  nothing, so its restart is exact).
- **Pipelined dispatch:** up to ``pipeline_depth`` chunks stay in flight;
  each chunk's token block starts its device-to-host copy at dispatch
  (a ``non_blocking`` copy into pinned memory plus a recorded CUDA event)
  and the oldest is delivered one boundary late, while a younger chunk
  runs. In steady decode one dispatch runs ``dispatch_depth`` chunks.
  Per-slot vectors go up from private pinned snapshots per dispatch (the
  loop mutates its host arrays while an upload may still be in flight).
  The dispatch path makes no other host sync: the ragged page bound and
  the visible span come from the host offsets.
- **Speculation (``speculative_k`` > 0):** whenever exactly one greedy row
  is active, the loop swaps the chunk for a ``[max_slots, k+1]`` verify
  step over the row's own n-gram proposals (token-exact by argmax
  determinism).
- **Supervision:** a crashed loop fails its waiters with typed errors,
  rebuilds its device state and restarts with backoff; more than
  ``max_crashes`` crashes within ``crash_window_s`` open the circuit, a
  request charged with ``POISON_CRASHES`` crashes is refused up front
  (400), and a boundary watchdog turns a stalled dispatch into a crash.
  A flight-recorder ring keeps the boundary events and dumps them on a
  crash.

The device lock of ``ModelServer`` is taken per dispatch, not per
request, so a ``/v1/forward`` gets in at a boundary.

Token-exactness: a request decoded here yields the tokens the same request
gets from the plain paths: greedy rows by argmax, sampled rows because the
per-row (seed, step) stream (``ops/sampling.py``) depends only on the
row's seed and decode depth, both carried per slot. The token sequences
are therefore also dispatch-schedule invariant (pipeline and dispatch
depths). On the CPU in fp32 that is byte equality; in bf16 on the card a
step's row count changes the matmul's rounding, so an answer equals the
plain one or first differs at a near-tie.

Left for later slices: mesh placement of the state, registry-installed
prefix KV, the ``/metrics`` block and trace spans, and fault injection.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
import zlib
from collections.abc import Mapping
from typing import Iterator

import numpy as np
import torch

from modelx_tpu_torch.dl.serving_errors import (
    DeadlineExceededError,
    EngineBrokenError,
    PoisonedRequestError,
    QueueFullError,
    ServingError,
)
from modelx_tpu_torch.models.decode import SEQ_BUCKET, pad_seq_len, stop_cut
from modelx_tpu_torch.ops import prng
from modelx_tpu_torch.ops import sampling as sampling_ops
from modelx_tpu_torch.ops.paged_attention import page_coords, ragged_blocks
from modelx_tpu_torch.testing import faults as _faults
from modelx_tpu_torch.utils import devmem, flightrec, promexp, trace, tswheel

logger = logging.getLogger("modelx.serve")

_DONE = object()  # end-of-stream sentinel on per-request output queues
_NO_HIT = object()  # "no memoized prefix-cache lookup" sentinel (None = a miss)


def _fingerprint(ids, n: int) -> tuple:
    """Identity of one request for poison quarantine: cheap, deterministic
    and content-addressed."""
    return (int(zlib.crc32(np.asarray(ids, np.int32).tobytes())), len(ids), int(n))


class _Ticket:
    """One submitted request: its output queue and a cancellation flag.
    ``cancel()`` (idempotent, any thread) tells the engine the consumer is
    gone: the slot frees at the next chunk boundary. ``deadline``
    (monotonic seconds, None = none) is the engine's --request-timeout
    clamped by any propagated per-request budget; ``timeout_s`` records the
    budget that applied, for the 504's message."""

    __slots__ = ("out", "cancelled", "deadline", "timeout_s", "restart",
                 "request_id", "t_submit", "t_admit", "t_first",
                 "prefill_pieces", "preempts", "resume_step")

    def __init__(self) -> None:
        self.out: "queue.Queue" = queue.Queue()
        self.cancelled = False
        self.deadline: float | None = None
        self.timeout_s: float = 0.0
        # a preempted fill's exact restart goes ahead of newer arrivals:
        # priority-aware inserts never cut in front of it
        self.restart = False
        # phase stamps, each written by the one thread that owns the
        # transition; t_admit and t_first stick at their first write
        self.request_id = ""
        self.t_submit = 0.0
        self.t_admit = 0.0
        self.t_first = 0.0
        self.prefill_pieces = 0
        self.preempts = 0
        self.resume_step = 0

    def cancel(self) -> None:
        self.cancelled = True

    def timing(self) -> dict:
        """The phases this ticket went through, in ms; phases that never
        happened are absent."""
        t: dict = {}
        if self.t_submit and self.t_admit:
            t["queue_ms"] = round((self.t_admit - self.t_submit) * 1e3, 3)
        if self.t_admit and self.t_first:
            t["prefill_ms"] = round((self.t_first - self.t_admit) * 1e3, 3)
        if self.t_submit and self.t_first:
            t["ttft_ms"] = round((self.t_first - self.t_submit) * 1e3, 3)
        if self.prefill_pieces:
            t["prefill_pieces"] = self.prefill_pieces
        if self.preempts:
            t["preempts"] = self.preempts
        if self.resume_step:
            t["resume_step"] = self.resume_step
        return t


class _Row:
    """One admitted request row bound to a slot."""

    __slots__ = ("slot", "budget", "emitted", "ticket", "skip", "stops",
                 "closed", "seq", "greedy", "ngram", "ng_len", "tok_pending")

    def __init__(self, slot: int, budget: int, ticket: _Ticket,
                 stops: frozenset = frozenset(), seq: list | None = None,
                 greedy: bool = True) -> None:
        self.slot = slot
        self.budget = budget
        self.emitted = 0
        self.ticket = ticket
        # a chunk emits each step's ENTRY token, so a freshly admitted
        # row's first chunk re-emits the prefill token already delivered
        self.skip = 1
        self.stops = stops
        # set by delivery on a stop hit (lags the plan by <= 1 chunk)
        self.closed = False
        # speculation bookkeeping: the row's token history + n-gram index
        self.seq = seq
        self.greedy = greedy
        self.ngram = None
        self.ng_len = 0
        # the engine's tok vector holds this row's next token, computed by
        # a chunk but not yet delivered
        self.tok_pending = False

    @property
    def out(self) -> "queue.Queue":
        return self.ticket.out


class _Fill:
    """A slot mid-chunked-prefill: the prompt lands piece by piece; the row
    emits nothing until the last piece flips it to a decoding _Row.
    ``filled`` counts the prompt tokens whose KV is resident."""

    __slots__ = ("slot", "ids", "n", "samp", "ticket", "filled", "fp")

    def __init__(self, slot: int, ids: list, n: int, samp: dict,
                 ticket: _Ticket, filled: int = 0, fp: tuple | None = None) -> None:
        self.slot = slot
        self.ids = ids
        self.n = n
        self.samp = samp
        self.ticket = ticket
        self.filled = filled
        self.fp = fp


class _GatheredPages(Mapping):
    """A page pool seen as dense ``[slots, max_len]`` caches, one layer at a
    time: reading leaf ``<k|v><layer>`` gathers that leaf's pages through
    the block table (the dense engine's view, value for value), and the
    rows the forward wrote into the view (``width`` positions from each
    slot's offset) go back into the pool before the next layer's leaves
    are gathered (and at ``flush``). A family forward reads each layer's
    pair before it writes it and walks the layers in order, so the
    transient is one layer's k and v views."""

    def __init__(self, pool: dict, table: torch.Tensor, page_size: int,
                 offsets: torch.Tensor, width: int) -> None:
        self._pool = pool
        self._table = table  # [S, pages_per_slot] int64
        self._ps = page_size
        self._offsets = offsets
        self._width = width
        self._rows = torch.arange(table.shape[0], device=table.device)
        self._pending: dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        for other in [n for n in self._pending if n[1:] != name[1:]]:
            self._write_back(other)
        p = self._pool[name]
        dense = p[self._table].reshape(self._table.shape[0], -1, *p.shape[2:])
        self._pending[name] = dense
        return dense

    def __iter__(self):
        return iter(self._pool)

    def __len__(self) -> int:
        return len(self._pool)

    def flush(self) -> None:
        for name in list(self._pending):
            self._write_back(name)

    def _write_back(self, name: str) -> None:
        dense = self._pending.pop(name)
        pool = self._pool[name]
        for j in range(self._width):
            off = self._offsets + j
            page_idx, off_in = page_coords(self._table, off, self._ps)
            pool[page_idx, off_in] = dense[self._rows, off]


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed slot array.

    ``submit`` enqueues one prompt row; the engine thread admits it into a
    free slot at the next chunk boundary and its output queue receives
    int32 numpy arrays of new tokens (totalling ``max_new_tokens``, fewer
    at a stop token), then the ``_DONE`` sentinel. ``generate`` /
    ``stream`` are the blocking conveniences the serving layer uses.
    """

    # a request is quarantined once this many loop crashes are attributed
    # to dispatching its admission/fill work
    POISON_CRASHES = 2

    # dispatch_depth=0 resolves to this in steady decode
    AUTO_DISPATCH_DEPTH = 4

    def __init__(self, server, max_slots: int = 8, chunk_size: int = 8,
                 max_len: int = 0, prefix_cache=None, page_size: int = 0,
                 max_live_tokens: int = 0, speculative_k: int = 0,
                 max_ngram: int = 3, paged_attention: str = "gather",
                 pipeline_depth: int = 2,
                 dispatch_depth: int = 0,
                 burst_window_ms: float = 1.0,
                 prefill_chunk: int = 0,
                 prefill_budget: int = 0,
                 max_queue_depth: int = 0,
                 request_timeout_s: float = 0.0,
                 supervise: bool = True,
                 restart_backoff_s: float = 0.25,
                 max_crashes: int = 5,
                 crash_window_s: float = 60.0,
                 boundary_watchdog_s: float = 0.0,
                 flight_recorder: bool = True,
                 flightrec_capacity: int = 0,
                 flight_dump_dir: str = "",
                 device_telemetry: bool = True) -> None:
        if server.family.decode_fns is None:
            raise ValueError(f"family {server.family.name} has no cached decode")
        self.server = server
        self.device = server.device
        self._on_card = self.device.type == "cuda"
        # the engine thread works on this card (a bare "cuda" means the
        # constructing thread's current one)
        self._device_index = (
            (self.device.index if self.device.index is not None else torch.cuda.current_device())
            if self._on_card else None)
        self.max_slots = int(max_slots)
        self.chunk_size = int(chunk_size)
        self.max_len = int(max_len) or int(server.max_seq_len)
        # chunked prefill: pieces are 16-bucketed like every prompt shape
        self.prefill_chunk = pad_seq_len(int(prefill_chunk)) if prefill_chunk else 0
        # per-boundary token budget: decode rows spend chunk_size each
        # first, prefill pieces pack into the remainder (0 = one piece per
        # filling row per boundary); the head piece always lands
        self.prefill_budget = int(prefill_budget)
        self.speculative_k = int(speculative_k)
        self.max_ngram = int(max_ngram)
        # a verify block writes up to k+1 positions past a row's offset;
        # the per-row span must cover whichever engine writes deepest
        self._overrun = max(self.chunk_size, self.speculative_k + 1)
        self.prefix_cache = prefix_cache
        self._fwd, self._init_cache = server.family.decode_fns(server.params, server.cfg)
        if paged_attention not in ("gather", "in-place"):
            raise ValueError(f"unknown paged_attention mode {paged_attention!r}")
        self._fwd_paged = (
            server.family.paged_decode_fns(server.params, server.cfg)
            if (page_size > 0 and paged_attention == "in-place"
                and server.family.paged_decode_fns is not None)
            else None
        )
        if page_size > 0 and paged_attention == "in-place" and self._fwd_paged is None:
            # an operator asking for in-place did so for the memory budget;
            # a silent fallback would surface only as an OOM later
            logger.warning(
                "--kv-attention in-place: family %s has no paged decode; "
                "falling back to the dense-gather chunk (higher per-step "
                "transient memory)", server.family.name)
        self.page_size = int(page_size)
        self._key = prng.PRNGKey(0, device=self.device)
        self._max_live_tokens = int(max_live_tokens)
        self._cache = None
        self._tok = None
        try:
            self._alloc_device_state(max_live_tokens)
        except BaseException:
            # an out-of-memory error here may leave SOME per-layer tensors
            # allocated: drop them before re-raising so the caller's
            # demote-and-retry (ServerSet.continuous_for) sees the bytes back
            self._cache = None
            self._tok = None
            raise
        # host-side per-slot state (uploaded per dispatch)
        self._offsets = np.zeros(self.max_slots, np.int64)
        self._steps = np.zeros(self.max_slots, np.int64)
        self._temp = np.zeros(self.max_slots, np.float32)
        self._top_k = np.zeros(self.max_slots, np.int64)
        self._top_p = np.ones(self.max_slots, np.float32)
        self._seeds = np.zeros(self.max_slots, np.int64)
        self._use_filters = np.zeros(self.max_slots, bool)
        self._rows: dict[int, _Row] = {}  # slot -> active row
        self._free = list(range(self.max_slots))
        self._first_pending: list = []  # (row, first-token fetch, done)
        self._filling: dict[int, _Fill] = {}  # slot -> chunk-prefilling row
        self._fill_order: list[int] = []  # fill slots, arrival order
        # fills preempted for pages: parked until a fill flips or dies
        # (re-queueing at once would re-grab the pages the older fill needs)
        self._preempted: list = []
        self._last_chunk_t: float | None = None
        # boundary-prep overlap memo: ticket -> (fingerprint, prefix hit)
        self._prep_memo: dict = {}
        # host copy of the device tok vector's lookahead tokens (the chunk
        # block's extra column); None = stale
        self._tok_host: np.ndarray | None = None
        # per-boundary host time: the dispatch-to-dispatch gap minus the
        # time blocked on device results
        self._boundary_host_ms: "collections.deque[float]" = collections.deque(maxlen=512)
        self._sync_wait_s = 0.0
        self._boundary_syncs = 0  # blocking device->host syncs since the last dispatch
        self._steady = False
        self._tokens_in_flight = 0
        self._inflight_chunks = 0
        self._depth_last = 1
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.dispatch_depth = int(dispatch_depth)
        if self.dispatch_depth < 0:
            raise ValueError("dispatch_depth must be >= 0 (0 = auto)")
        self._depth_cap = self.dispatch_depth or self.AUTO_DISPATCH_DEPTH
        self.burst_window_ms = float(burst_window_ms)

        self._q: "queue.Queue" = queue.Queue()
        # FIFO admission backlog: items popped while no slot was free
        self._waiting: list = []
        self._closed = False
        self._broken: BaseException | None = None
        self._close_lock = threading.Lock()
        # bounded admission: submits past this many not-yet-admitted rows
        # shed with QueueFullError (429 + Retry-After)
        self.max_queue_depth = int(max_queue_depth)
        self.request_timeout_s = float(request_timeout_s)
        self._backlog = 0
        # supervision
        self.supervise = bool(supervise)
        self.restart_backoff_s = float(restart_backoff_s)
        self.max_crashes = int(max_crashes)
        self.crash_window_s = float(crash_window_s)
        self._crash_times: list[float] = []
        self._restarts = 0
        self._state = "running"  # running | restarting | broken | stopped
        self._closed_ev = threading.Event()
        self._poison: dict[tuple, int] = {}
        self._suspect_fp: tuple | None = None
        # hang watchdog: a boundary with no progress for this long (rows
        # active) is a crash; off by default
        self.boundary_watchdog_s = float(boundary_watchdog_s)
        self._watch_stall: BaseException | None = None
        self._progress_t: float | None = None
        # flight recorder: boundary-granularity events, dumped on a crash
        self.flight_dump_dir = str(flight_dump_dir or "")
        self.flightrec = (
            flightrec.FlightRecorder(int(flightrec_capacity) or flightrec.DEFAULT_CAPACITY)
            if flight_recorder else None
        )
        self._suspect_rid = ""
        self.device_telemetry = bool(device_telemetry)
        self.rate_tokens = tswheel.Wheel()
        self.stats = {"chunks": 0, "admitted": 0, "active_peak": 0,
                      "prefill_pieces": 0, "stall_ms_max": 0.0,
                      "engine_restarts": 0, "shed": 0, "expired": 0,
                      "prefix_hits_installed": 0,
                      "dispatches": 0, "dispatch_depth_max": 1,
                      "host_syncs_per_boundary": 0,
                      "tokens_in_flight_peak": 0, "sync_lag_chunks_max": 0,
                      "decode_rows": 0, "decode_pad_rows": 0}
        self.hist_queue_ms = promexp.Histogram()
        self.hist_ttft_ms = promexp.Histogram()
        # env-gated chaos drills (default off): MODELX_FAULT_PLAN schedules
        # deterministic dispatch faults against the running engine
        env_plan = _faults.from_env()
        if env_plan is not None and env_plan.has("engine.dispatch"):
            self._chunk = _faults.wrap_dispatch(self._chunk, env_plan)
        if self.prefill_chunk > 0:
            self.stats["prefill_chunk"] = self.prefill_chunk
            self.stats["fill_waits"] = 0
            self.stats["fill_preempts"] = 0
        if self.page_size > 0:
            self.stats["page_size"] = self.page_size
            self.stats["pages_total"] = self.num_pages - 1  # excl. trash
            self.stats["pages_free"] = len(self._free_pages)
            self.stats["paged_attention"] = (
                "in-place" if self._fwd_paged is not None else "gather")
        if self.boundary_watchdog_s > 0:
            self.stats["watchdog_stalls"] = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"continuous-{getattr(server, 'name', '')}")
        self._thread.start()
        if self.boundary_watchdog_s > 0:
            self._watch_thread = threading.Thread(target=self._watchdog, daemon=True)
            self._watch_thread.start()

    # -- device state ---------------------------------------------------------

    def _alloc_device_state(self, max_live_tokens: int) -> None:
        """The engine's big device allocations: the KV page pool (or dense
        cache) and the token vector. Tensors are stored on ``self`` as they
        are made, so the constructor's cleanup drops partial ones."""
        if self.page_size > 0:
            if self.max_len % self.page_size:
                raise ValueError(
                    f"max_len {self.max_len} must be a multiple of "
                    f"page_size {self.page_size}")
            budget = int(max_live_tokens) or max(
                self.max_len + self.chunk_size + self.page_size,
                self.max_slots * self.max_len // 4,
            )
            self.num_pages = 1 + -(-budget // self.page_size)  # +1: trash
            self._pages_per_slot = self.max_len // self.page_size
            self._free_pages = list(range(1, self.num_pages))
            self._table = np.zeros((self.max_slots, self._pages_per_slot), np.int64)
            self._row_pages: dict[int, list[int]] = {}
            template = self._init_cache(1, self.page_size)
            self._cache = {}
            for name, leaf in template.items():
                self._cache[name] = torch.zeros(
                    (self.num_pages, self.page_size) + tuple(leaf.shape[2:]),
                    dtype=leaf.dtype, device=leaf.device)
        else:
            self.num_pages = 0
            self._cache = self._init_cache(self.max_slots, self.max_len)
        self._tok = torch.zeros((self.max_slots, 1), dtype=torch.int64, device=self.device)

    def kv_bytes(self) -> int:
        """Bytes of the engine's KV state (dense cache or page pool)."""
        return sum(int(c.numel()) * c.element_size() for c in (self._cache or {}).values())

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A private device copy of a host array: on the card through a
        fresh pinned block (the caching host allocator keeps it until the
        non_blocking copy is done), so the loop may mutate ``arr`` at once."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._on_card:
            return src.clone()
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        return pinned.to(self.device, non_blocking=True)

    def _fetch(self, t: torch.Tensor):
        """Start ``t``'s device->host copy now; returns a zero-arg callable
        that waits for it (on that copy's event only) and yields numpy."""
        if not self._on_card:
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

    # -- flight recorder ------------------------------------------------------

    def _rec(self, event: str, slot: int = -1, request_id: str = "", **fields) -> None:
        fr = self.flightrec
        if fr is not None:
            fr.record(event, slot=slot, request_id=request_id, **fields)

    def _slot_states(self) -> list[dict]:
        out = []
        for slot, row in list(self._rows.items()):
            out.append({"slot": slot, "state": "decoding",
                        "request_id": row.ticket.request_id,
                        "emitted": row.emitted, "budget": row.budget})
        for slot, fill in list(self._filling.items()):
            out.append({"slot": slot, "state": "filling",
                        "request_id": fill.ticket.request_id,
                        "filled": fill.filled, "prompt_len": len(fill.ids)})
        return out

    def _flight_dump(self, reason: str, err: BaseException | None) -> str:
        """Write the black-box file (crash / watchdog / circuit-break);
        best-effort, never a failure of its own."""
        if self.flightrec is None or not self.flight_dump_dir:
            return ""
        meta = {"model": str(getattr(self.server, "name", "") or ""),
                "engine_state": self._state, "restarts": self._restarts}
        if err is not None:
            meta["error"] = repr(err)[:300]
        path = self.flightrec.dump(self.flight_dump_dir, reason, meta=meta,
                                   slots=self._slot_states())
        if path:
            logger.warning("flight recorder dumped %s black box to %s", reason, path)
        return path

    # -- device steps ---------------------------------------------------------

    def _pick(self, logits: torch.Tensor, temp, top_k, top_p, seeds, step) -> torch.Tensor:
        """Each row's next token [B] int64 from float logits [B, V]: the
        argmax when ``temp`` is None (no row samples), else ``sample``'s
        per-row (seed, step) draw."""
        if temp is None:
            return torch.argmax(logits, dim=-1)
        return sampling_ops.sample(logits.float(), self._key, temp, top_k=top_k,
                                   top_p=top_p, seeds=seeds, step=step).long()

    def _samp_vectors(self, samps: list, m: int) -> tuple:
        """(temp, top_k, top_p, seeds, first_steps) device vectors for
        ``m`` rows (pad rows greedy): temp None when no row samples, a
        filter None when no row uses it, so the one-shot pick does no
        filter work for nothing."""
        temp = np.zeros(m, np.float32)
        top_k = np.zeros(m, np.int64)
        top_p = np.ones(m, np.float32)
        seeds = np.zeros(m, np.int64)
        steps = np.zeros(m, np.int64)
        for i, samp in enumerate(samps):
            temp[i] = float(samp.get("temperature", 0.0))
            top_k[i] = int(samp.get("top_k", 0))
            top_p[i] = float(samp.get("top_p", 1.0))
            seeds[i] = int(samp.get("seed", 0))
            steps[i] = int(samp.get("resume_step", 0))
        if not (temp > 0).any():
            return None, None, None, None, None
        sampled = temp > 0
        return (self._upload(temp),
                self._upload(top_k) if (sampled & (top_k > 0)).any() else None,
                self._upload(top_p) if (sampled & (top_p < 1.0)).any() else None,
                self._upload(seeds), self._upload(steps))

    def _write_pages(self, leaf: torch.Tensor, src: torch.Tensor, ids: torch.Tensor,
                     span: int) -> None:
        """Write ``src[:, :span]`` ([k, >= span, H, D]) into the pages
        ``ids`` ([k, n_pages], device) of one pool leaf; the last page may
        be partial (its tail stays junk past every query position)."""
        ps = self.page_size
        k = src.shape[0]
        full = span // ps
        if full:
            leaf[ids[:, :full].reshape(-1)] = src[:, : full * ps].reshape(
                k * full, ps, *src.shape[2:])
        rem = span - full * ps
        if rem:
            leaf[ids[:, full], :rem] = src[:, full * ps: span]

    def _prefill(self, prompts: np.ndarray, row_lens: np.ndarray, samps: list) -> tuple:
        """Prefill ``prompts`` [m, Sb] into a fresh scratch cache and pick
        each row's first token at its last real position (step
        ``resume_step`` of its stream). Returns (scratch cache, firsts [m])."""
        m, sb = prompts.shape
        small = self._init_cache(m, sb)
        logits, _ = self._fwd(self.server.params, self._upload(prompts), kv_cache=small,
                              cache_offset=0)
        last = logits[torch.arange(m, device=logits.device), self._upload(row_lens - 1)]
        temp, top_k, top_p, seeds, steps = self._samp_vectors(samps, m)
        return small, self._pick(last, temp, top_k, top_p, seeds, steps)

    def _insert(self, small: dict, slots: list, span: int, page_ids: np.ndarray | None) -> None:
        """Copy the scratch rows' first ``span`` positions into their
        slots (dense) or their reserved pages (paged)."""
        k = len(slots)
        if self.page_size > 0:
            ids = self._upload(page_ids.reshape(k, -1))
            for name, leaf in self._cache.items():
                self._write_pages(leaf, small[name][:k], ids, span)
        elif k == 1:
            for name, c in self._cache.items():
                c[slots[0], :span] = small[name][0, :span]
        else:
            idx = self._upload(np.asarray(slots, np.int64))
            for name, c in self._cache.items():
                c[idx, :span] = small[name][:k, :span]

    def _set_tok(self, slots: list, firsts: torch.Tensor) -> None:
        if len(slots) == 1:
            self._tok[slots[0], 0] = firsts[0]
        else:
            self._tok[self._upload(np.asarray(slots, np.int64)), 0] = firsts[: len(slots)]

    def _chunk(self, n_steps: int) -> torch.Tensor:
        """``n_steps`` decode steps over ALL slots at [max_slots, 1], from
        the host vectors as they stand (snapshotted and uploaded once).
        Returns the token block [max_slots, n_steps + 1]: each step's entry
        token plus the final carry (each row's next, undelivered token),
        so the lagged readback also learns the lookahead value."""
        active = list(self._rows)
        sampled = bool((self._temp[active] > 0).any()) if active else False
        filtered = sampled and bool(self._use_filters[active].any())
        ar = np.arange(n_steps, dtype=np.int64)[:, None]
        ints = np.concatenate([self._offsets[None, :] + ar, self._steps[None, :] + ar,
                               self._seeds[None, :], self._top_k[None, :]])
        ints_dev = self._upload(ints)
        if sampled:
            floats = self._upload(np.stack([self._temp, self._top_p]))
            temp, seeds = floats[0], ints_dev[2 * n_steps]
            top_k = ints_dev[2 * n_steps + 1] if filtered else None
            top_p = floats[1] if filtered else None
        else:
            temp = top_k = top_p = seeds = None
        params = self.server.params
        ps = self.page_size
        table = self._upload(self._table) if ps > 0 else None
        tok = self._tok
        toks = []
        longest = int(self._offsets.max()) + 1  # the in-place loop's ragged bound
        for t in range(n_steps):
            offs = ints_dev[t]
            if self._fwd_paged is not None:
                logits, _ = self._fwd_paged(
                    params, tok, kv_cache=self._cache, cache_offset=offs, table=table,
                    n_blocks=ragged_blocks(longest + t, ps, self._pages_per_slot))
            elif ps > 0:
                view = _GatheredPages(self._cache, table, ps, offs, 1)
                logits, _ = self._fwd(params, tok, kv_cache=view, cache_offset=offs)
                view.flush()
            else:
                logits, _ = self._fwd(params, tok, kv_cache=self._cache, cache_offset=offs)
            nxt = self._pick(logits[:, -1, :], temp, top_k, top_p, seeds,
                             ints_dev[n_steps + t] if sampled else None)
            toks.append(tok[:, 0])
            tok = nxt[:, None]
        self._tok = tok
        return torch.stack(toks + [tok[:, 0]], dim=1)

    def _verify(self, block: np.ndarray) -> torch.Tensor:
        """One speculative verify step over the FULL slot array: ``block``
        [max_slots, k+1] (the active slot carries last token + proposals,
        idle slots zeros, whose writes land on their garbage rows).
        Returns the argmax at every position [max_slots, k+1]. Rejected
        positions leave garbage KV past the rewound offset, hidden by the
        causal mask until overwritten."""
        offs = self._upload(self._offsets)
        params = self.server.params
        tokens = self._upload(block)
        if self.page_size > 0:
            view = _GatheredPages(self._cache, self._upload(self._table), self.page_size,
                                  offs, block.shape[1])
            logits, _ = self._fwd(params, tokens, kv_cache=view, cache_offset=offs)
            view.flush()
        else:
            logits, _ = self._fwd(params, tokens, kv_cache=self._cache, cache_offset=offs)
        return torch.argmax(logits, dim=-1)

    def _slot_row(self, slot: int, span: int) -> tuple[dict, dict | None, np.ndarray | None]:
        """The slot's own cache over positions [0, span): views of the dense
        rows (writes land in place), or views of a gathered copy of its
        pages (the caller writes the touched pages back). Returns (views,
        the gathered copies or None, their page ids or None)."""
        if self.page_size <= 0:
            return {n: c[slot: slot + 1, :span] for n, c in self._cache.items()}, None, None
        n_pg = -(-span // self.page_size)
        ids = self._table[slot, :n_pg].copy()
        idx = self._upload(ids)
        full = {n: p[idx].reshape(1, n_pg * self.page_size, *p.shape[2:])
                for n, p in self._cache.items()}
        return {n: d[:, :span] for n, d in full.items()}, full, ids

    def _piece(self, fill: _Fill, piece_len: int, take: int, last: bool):
        """Run one prefill piece [1, piece_len] at the fill's offset against
        the slot's own earlier KV; the landed KV equals the same span of a
        monolithic prefill. The last piece also picks the row's first
        token (step ``resume_step`` of its stream). Returns the first
        token [1] or None."""
        slot, filled = fill.slot, fill.filled
        block = np.zeros((1, piece_len), np.int64)
        block[0, :take] = fill.ids[filled: filled + take]
        row, full, ids = self._slot_row(slot, filled + piece_len)
        logits, _ = self._fwd(self.server.params, self._upload(block), kv_cache=row,
                              cache_offset=filled)
        if full is not None:
            # write back only the pages the piece touched
            ps = self.page_size
            start_pg, end_pg = filled // ps, (filled + piece_len - 1) // ps
            touched = self._upload(ids[start_pg: end_pg + 1])
            for name, leaf in self._cache.items():
                src = full[name][0, start_pg * ps: (end_pg + 1) * ps]
                leaf[touched] = src.reshape(end_pg + 1 - start_pg, ps, *src.shape[1:])
        if not last:
            return None
        first = self._pick(logits[:, take - 1], *self._samp_vectors([fill.samp], 1))
        self._tok[slot, 0] = first[0]
        return first

    # -- speculation ----------------------------------------------------------

    def _spec_ok(self) -> bool:
        """Speculate iff exactly one greedy row is active and nothing waits
        for a slot or fills (admissions beat speculation)."""
        if (self.speculative_k <= 0 or len(self._rows) != 1
                or self._waiting or self._filling):
            return False
        row = next(iter(self._rows.values()))
        return (row.greedy and not row.closed and not row.ticket.cancelled
                and row.seq is not None)

    def _spec_step(self) -> None:
        """Propose -> verify -> accept -> deliver, synchronously. The cache
        holds [0, offset) and ``tok`` carries the next token to consume:
        after admission it was delivered already; after a chunk it is the
        chunk's undelivered lookahead (``row.tok_pending``), emitted as part
        of this round. The block is [that token, proposals...] at the
        row's offset, ``models/speculative.py``'s layout."""
        from modelx_tpu_torch.models.speculative import _NgramIndex

        slot, row = next(iter(self._rows.items()))
        prefix_emit: list[int] = []
        if row.tok_pending:
            if self._tok_host is not None:
                tok_val = int(self._tok_host[slot])
            else:
                t0 = time.monotonic()
                tok_val = int(self._tok[slot, 0].item())
                self._sync_wait_s += time.monotonic() - t0
                self._boundary_syncs += 1
            row.seq.append(tok_val)
            prefix_emit = [tok_val]
        else:
            tok_val = row.seq[-1]
        if row.ngram is None:
            row.ngram = _NgramIndex(self.max_ngram)
        row.ngram.extend(row.seq, row.ng_len)
        row.ng_len = len(row.seq)
        k = self.speculative_k
        prop = row.ngram.propose(row.seq, k)
        block = np.zeros((self.max_slots, k + 1), np.int64)
        block[slot, 0] = tok_val
        if prop:
            block[slot, 1:1 + len(prop)] = prop
        with trace.span("continuous.spec_verify", proposed=len(prop)), \
                self.server._device_lock:
            argm_dev = self._verify(block)[slot]
            fetch = self._fetch(argm_dev)
        # the spec boundary's one blocking readback: acceptance decides the
        # next proposal
        t0 = time.monotonic()
        argm = fetch()
        self._sync_wait_s += time.monotonic() - t0
        self._boundary_syncs += 1
        self.stats["spec_steps"] = self.stats.get("spec_steps", 0) + 1
        self.stats["spec_proposed"] = self.stats.get("spec_proposed", 0) + len(prop)
        a = 0
        while a < len(prop) and int(argm[a]) == prop[a]:
            a += 1
        room = row.budget - row.emitted
        new = (prefix_emit + prop[:a] + [int(argm[a])])[:room]
        verified = new[len(prefix_emit):]
        self.stats["spec_accepted"] = self.stats.get("spec_accepted", 0) + min(a, len(verified))
        # rewind past rejected/padded positions; only verified history stays
        self._offsets[slot] += a + 1
        self._steps[slot] += a + 1
        row.seq.extend(verified)
        row.emitted += len(new)
        # for a fall-back to chunk mode: tok carries the row's last
        # DELIVERED token, whose chunk-entry re-emission the skip swallows
        tok_np = np.zeros((self.max_slots, 1), np.int64)
        tok_np[slot, 0] = row.seq[-1]
        self._tok = self._upload(tok_np)
        self._tok_host = tok_np[:, 0].copy()
        self._steady = False
        row.skip = 1
        row.tok_pending = False
        piece = np.asarray([new], np.int32)
        done = row.emitted >= row.budget
        if row.stops:
            cut = stop_cut(new, row.stops)
            if cut is not None:
                piece = piece[:, :cut]
                done = True
        row.out.put(piece)
        if done:
            row.out.put(_DONE)
            row.closed = True  # the sweep frees the slot before the next step

    # -- engine loop: admission -----------------------------------------------

    def _need_pages(self, ids, n: int) -> int:
        """Pages covering the row's whole write span (prompt bucket +
        budget + the overrun margin, the span ``submit`` validates)."""
        need = pad_seq_len(len(ids)) + n + self._overrun
        return -(-need // self.page_size)

    def _admits_now(self, item) -> bool:
        """A free slot and, paged, enough free pages: a single-program
        admission needs its whole span up front, a chunk fill only its
        first piece's pages."""
        if not self._free:
            return False
        if self.page_size > 0 and not item[3].cancelled:
            ids, n = item[0], item[1]
            if self.prefill_chunk > 0 and pad_seq_len(len(ids)) > self.prefill_chunk:
                need = -(-self.prefill_chunk // self.page_size)
            else:
                need = self._need_pages(ids, n)
            if need > len(self._free_pages):
                return False
        return True

    def _release_slot(self, slot: int) -> None:
        """Return a retired row's slot (and, paged, its pages) to the free
        sets. Table zeroing points the slot's entries back at the trash
        page; a chunk still in flight dispatched with its own snapshot of
        the table, and the device runs in order, so reuse stays ordered."""
        self._free.append(slot)
        self._offsets[slot] = 0
        if self.page_size > 0:
            self._free_pages.extend(self._row_pages.pop(slot, ()))
            self._table[slot, :] = 0
            self.stats["pages_free"] = len(self._free_pages)

    def _gather_prep(self, item, to_admit: list) -> None:
        """Prepare one admissible item into ``to_admit``; if preparation
        itself dies, every waiter gathered so far is failed first."""
        self._backlog_sub(1)
        memo = self._prep_memo.pop(item[3], None)
        fp = memo[0] if memo is not None else _fingerprint(item[0], item[1])
        self._suspect_fp = fp
        self._suspect_rid = item[3].request_id
        try:
            prep = self._prepare_admit(item, memo_hit=memo[1] if memo is not None else _NO_HIT)
        except BaseException as e:
            item[3].out.put(e)
            for p in to_admit:
                p["ticket"].out.put(e)
            raise
        self._suspect_fp = None
        self._suspect_rid = ""
        if prep is not None:
            prep["fp"] = fp
            to_admit.append(prep)

    def _prepare_admit(self, item, memo_hit=_NO_HIT) -> dict | None:
        """Claim a slot (and, paged, reserve the row's pages) and resolve
        the prefix-cache hit: host bookkeeping only. With chunked prefill,
        a prompt whose to-prefill span exceeds one piece becomes a FILL."""
        ids, n, samp, ticket = item
        if ticket.cancelled:
            ticket.out.put(_DONE)
            return None
        if ticket.deadline is not None and time.monotonic() > ticket.deadline:
            self.stats["expired"] += 1
            self._rec("deadline", request_id=ticket.request_id, state="queued")
            ticket.out.put(self._deadline_error(ticket, "waiting for a slot"))
            return None
        slot = self._free.pop()
        if not ticket.t_admit:
            ticket.t_admit = time.monotonic()
        s = len(ids)
        hit = None
        if self.prefix_cache is not None:
            if memo_hit is not _NO_HIT:
                hit = memo_hit
            else:
                hit = self.prefix_cache.lookup(ids, max_total=self.max_len)
        if self.prefill_chunk > 0:
            to_fill = s - (hit[0] if hit is not None else 0)
            use_fill = pad_seq_len(to_fill) > self.prefill_chunk
            if (not use_fill and self.page_size > 0
                    and self._need_pages(ids, n) > len(self._free_pages)):
                use_fill = True
            if use_fill:
                if self.page_size > 0:
                    self._row_pages[slot] = []
                    self._table[slot, :] = 0
                return {"ids": ids, "n": n, "samp": samp, "ticket": ticket,
                        "slot": slot, "s": s, "hit": hit, "fill": True,
                        "finished": False}
        prompt_pages = None
        if self.page_size > 0:
            need_pages = self._need_pages(ids, n)
            pages = [self._free_pages.pop() for _ in range(need_pages)]
            self._row_pages[slot] = pages
            self._table[slot, :] = 0
            self._table[slot, :need_pages] = pages
            self.stats["pages_free"] = len(self._free_pages)
            n_prompt = -(-pad_seq_len(s) // self.page_size)
            prompt_pages = np.asarray(pages[:n_prompt], np.int64)
        return {"ids": ids, "n": n, "samp": samp, "ticket": ticket,
                "slot": slot, "s": s, "prompt_pages": prompt_pages,
                "hit": hit, "bucket": pad_seq_len(s), "fill": False,
                "finished": False}

    def _finish_admit_host(self, prep: dict, first_ref) -> None:
        """Post-dispatch bookkeeping: per-slot vectors, the row, and its
        async first-token delivery (``first_ref()`` -> np [1, 1])."""
        slot, s, samp = prep["slot"], prep["s"], prep["samp"]
        k_val = int(samp.get("top_k", 0))
        p_val = float(samp.get("top_p", 1.0))
        self._offsets[slot] = s
        # a resumed request's first token was step k: the row continues
        # the original (seed, step) stream
        self._steps[slot] = int(samp.get("resume_step", 0)) + 1
        self._temp[slot] = float(samp.get("temperature", 0.0))
        self._top_k[slot] = k_val
        self._top_p[slot] = p_val
        self._seeds[slot] = int(samp.get("seed", 0))
        self._use_filters[slot] = k_val > 0 or p_val < 1.0
        row = _Row(slot, prep["n"], prep["ticket"],
                   stops=frozenset(samp.get("stop_token_ids") or ()),
                   seq=list(prep["ids"]) if self.speculative_k > 0 else None,
                   greedy=float(samp.get("temperature", 0.0)) <= 0.0)
        row.emitted = 1
        done = row.emitted >= row.budget
        self._first_pending.append((row, first_ref, done))
        if done:
            self._release_slot(slot)
        else:
            self._rows[slot] = row
        prep["finished"] = True
        self._steady = False
        self.stats["admitted"] += 1
        self.stats["active_peak"] = max(self.stats["active_peak"], len(self._rows))
        self._rec("admit", slot=slot, request_id=prep["ticket"].request_id,
                  prompt_len=s, budget=prep["n"])

    def _admit_all(self, preps: list) -> None:
        """Dispatch a boundary's prepared admissions: same-bucket preps
        without a prefix cache share ONE [m, Sb] prefill, the rest go one
        by one; a dispatch that dies fails every unfinished prep's waiter."""
        self._tok_host = None
        try:
            singles: list = []
            groups: dict[int, list] = {}
            for p in preps:
                if p["fill"]:
                    self._start_fill(p)
                elif self.prefix_cache is not None:
                    singles.append(p)
                else:
                    groups.setdefault(p["bucket"], []).append(p)
            for group in groups.values():
                if len(group) == 1:
                    singles.append(group[0])
                    continue
                with trace.span("continuous.admit_many", rows=len(group)):
                    self._admit_group(group)
                self.stats["admit_batches"] = self.stats.get("admit_batches", 0) + 1
            for p in singles:
                with trace.span("continuous.admit"):
                    self._admit_one(p)
        except BaseException as e:
            for p in preps:
                if not p["finished"]:
                    p["ticket"].out.put(e)
            raise

    def _admit_group(self, preps: list) -> None:
        """One prefill admits the whole same-bucket group as [m, Sb], m the
        burst size rounded UP to a power of two (clamped to max_slots);
        pad rows (row_len 1) are computed and dropped."""
        sb = preps[0]["bucket"]
        m = min(self.max_slots, 1 << max(len(preps) - 1, 0).bit_length())
        self.stats["admit_pad_rows"] = self.stats.get("admit_pad_rows", 0) + m - len(preps)
        prompts = np.zeros((m, sb), np.int64)
        row_lens = np.ones(m, np.int64)
        for i, p in enumerate(preps):
            prompts[i, : p["s"]] = p["ids"]
            row_lens[i] = p["s"]
        slots = [p["slot"] for p in preps]
        with self.server._device_lock:
            small, firsts = self._prefill(prompts, row_lens, [p["samp"] for p in preps])
            page_ids = (np.stack([p["prompt_pages"] for p in preps])
                        if self.page_size > 0 else None)
            self._insert(small, slots, sb, page_ids)
            self._set_tok(slots, firsts)
            fetch = self._fetch(firsts[: len(preps)])
        for i, p in enumerate(preps):
            self._finish_admit_host(p, lambda i=i: fetch()[i].reshape(1, 1))

    def _admit_one(self, prep: dict) -> None:
        ids, samp, slot, s = prep["ids"], prep["samp"], prep["slot"], prep["s"]
        # this dispatch is attributable to ONE request (poison quarantine)
        self._suspect_fp = prep["fp"]
        self._suspect_rid = prep["ticket"].request_id
        # registry-installed prefix KV (dl/kv_store.py): this admission
        # decodes from fleet-shared state, the proof that a fresh pod
        # skipped a shared prefix's prefill
        installed = (prep["hit"] is not None and self.prefix_cache is not None
                     and self.prefix_cache.entry_origin(ids[: prep["hit"][0]]) == "installed")
        if installed:
            self.stats["prefix_hits_installed"] += 1
        self._rec("dispatch_admit", slot=slot, request_id=prep["ticket"].request_id,
                  prompt_len=s, cached=prep["hit"] is not None, installed_kv=installed)
        hit = prep["hit"]
        with self.server._device_lock:
            if hit is not None:
                plen, stored = hit
                suffix = ids[plen:]
                sb = pad_seq_len(len(suffix))
                block = np.zeros((1, sb), np.int64)
                block[0, : len(suffix)] = suffix
                # the scratch cache starts as the STORED prefix KV extended
                # by the suffix bucket; only the suffix prefills, at plen
                small = {n: torch.cat([st, st.new_zeros((1, sb) + tuple(st.shape[2:]))], dim=1)
                         for n, st in stored.items()}
                logits, _ = self._fwd(self.server.params, self._upload(block),
                                      kv_cache=small, cache_offset=plen)
                first = self._pick(logits[:, len(suffix) - 1], *self._samp_vectors([samp], 1))
                trim = pad_seq_len(s)
                small = {n: c[:, :trim].clone() for n, c in small.items()}
            else:
                trim = pad_seq_len(s)
                prompt = np.zeros((1, trim), np.int64)
                prompt[0, :s] = ids
                small, first = self._prefill(prompt, np.asarray([s], np.int64), [samp])
            self._insert(small, [slot], trim, prep["prompt_pages"])
            self._set_tok([slot], first)
            fetch = self._fetch(first)
        if self.prefix_cache is not None:
            # the scratch cache IS this prompt's prefill KV (bucketed to the
            # prompt's 16-quantum): the conversation's next turn prefills
            # only its new suffix
            self.prefix_cache.put(ids, small)
        self._finish_admit_host(prep, lambda: fetch().reshape(1, 1))
        self._suspect_fp = None
        self._suspect_rid = ""

    # -- chunked prefill scheduling -------------------------------------------

    def _reserve_upto(self, slot: int, tokens: int) -> bool:
        """Grow a filling slot's page reservation to cover ``tokens``
        positions; False = the pool is short (wait, or preempt)."""
        need = -(-tokens // self.page_size)
        pages = self._row_pages.setdefault(slot, [])
        if need <= len(pages):
            return True
        if need - len(pages) > len(self._free_pages):
            return False
        for j in range(len(pages), need):
            pg = self._free_pages.pop()
            pages.append(pg)
            self._table[slot, j] = pg
        self.stats["pages_free"] = len(self._free_pages)
        return True

    def _start_fill(self, prep: dict) -> None:
        """Begin a chunked prefill on a claimed slot. A prefix hit seeds
        the slot with the stored KV so only the suffix lands piece by
        piece; the pieces dispatch from the boundary scheduler."""
        slot, ids = prep["slot"], prep["ids"]
        plen = 0
        if prep["hit"] is not None:
            plen_real, stored = prep["hit"]
            # the fill frontier starts at the stored prefix ROUNDED DOWN to
            # the bucket quantum, so every piece lands 16-aligned; the <= 15
            # tokens between re-prefill with the first suffix piece
            plen = plen_real // SEQ_BUCKET * SEQ_BUCKET
            bucket = pad_seq_len(plen_real)
            if plen == 0:
                pass  # sub-bucket prefix: seeding buys nothing
            elif self.page_size > 0 and not self._reserve_upto(slot, bucket):
                plen = 0  # the seed's pages are not free: fill it all
            else:
                with trace.span("continuous.fill_seed", prefix=plen), self.server._device_lock:
                    if self.page_size > 0:
                        n_pg = -(-bucket // self.page_size)
                        self._insert(stored, [slot], bucket,
                                     np.asarray(self._row_pages[slot][:n_pg], np.int64))
                    else:
                        self._insert(stored, [slot], bucket, None)
        fill = _Fill(slot, list(ids), prep["n"], dict(prep["samp"]), prep["ticket"],
                     filled=plen, fp=prep.get("fp"))
        # the fill's offset is its KV frontier: decode chunks run over every
        # slot, so its garbage writes land beyond the real prefix
        self._offsets[slot] = plen
        self._steps[slot] = 0
        self._filling[slot] = fill
        self._fill_order.append(slot)
        prep["finished"] = True
        self._steady = False

    def _fill_piece(self, rem: int) -> tuple[int, int, bool]:
        """(bucketed piece length, real tokens taken, is-last) for a fill
        with ``rem`` prompt tokens outstanding."""
        if rem <= self.prefill_chunk:
            return pad_seq_len(rem), rem, True
        return self.prefill_chunk, self.prefill_chunk, False

    def _dispatch_pieces(self, decode_spend: int) -> bool:
        """Land this boundary's prefill pieces: FIFO over filling rows, one
        piece each, packed into the budget after the decode rows' spend;
        the head piece is exempt. True when at least one piece landed."""
        spent = decode_spend
        landed = 0
        for slot in list(self._fill_order):
            fill = self._filling.get(slot)
            if fill is None:
                continue
            if fill.ticket.cancelled:
                # retire now: a cancelled lone fill skipped here would read
                # as "every fill is page-blocked" and trip the preempt check
                self._drop_fill(slot)
                continue
            rem = len(fill.ids) - fill.filled
            piece_len, take, last = self._fill_piece(rem)
            if landed and self.prefill_budget > 0 and spent + piece_len > self.prefill_budget:
                break
            if self.page_size > 0:
                # the last piece also reserves the decode span: the flip
                # must never strand a row that cannot decode
                upto = (pad_seq_len(len(fill.ids)) + fill.n + self._overrun
                        if last else fill.filled + piece_len)
                if not self._reserve_upto(slot, upto):
                    self.stats["fill_waits"] += 1
                    continue
            self._land_piece(fill, piece_len, take, last)
            spent += piece_len
            landed += 1
        return landed > 0

    def _land_piece(self, fill: _Fill, piece_len: int, take: int, last: bool) -> None:
        """Dispatch one prefill piece (async). The last piece picks the
        row's first token and flips the slot from filling to decoding."""
        slot = fill.slot
        self._suspect_fp = fill.fp
        self._suspect_rid = fill.ticket.request_id
        self._steady = False
        if last:
            self._tok_host = None
        self.stats["prefill_pieces"] += 1
        fill.ticket.prefill_pieces += 1
        self._rec("fill_piece", slot=slot, request_id=fill.ticket.request_id,
                  tokens=take, last=last)
        # the engine thread has no request context: re-bind the ticket's id
        # so the piece joins its request's timeline
        with trace.request_context(fill.ticket.request_id), \
                trace.span("continuous.prefill_flip" if last else "continuous.prefill_piece",
                           tokens=take), self.server._device_lock:
            first = self._piece(fill, piece_len, take, last)
            fetch = self._fetch(first) if last else None
        if not last:
            fill.filled += take
            self._offsets[slot] = fill.filled
            self._suspect_fp = None
            self._suspect_rid = ""
            return
        del self._filling[slot]
        self._fill_order.remove(slot)
        if self.prefix_cache is not None:
            # store the freshly landed prompt KV: the next turn prefills
            # only its new suffix, as after a single-program admission
            bucket = pad_seq_len(len(fill.ids))
            with self.server._device_lock:
                row, _full, _ids = self._slot_row(slot, bucket)
                snap = {n: c.clone() for n, c in row.items()}
            self.prefix_cache.put(fill.ids, snap)
        prep = {"slot": slot, "s": len(fill.ids), "samp": fill.samp, "n": fill.n,
                "ticket": fill.ticket, "ids": fill.ids, "finished": False}
        self._finish_admit_host(prep, lambda: fetch().reshape(1, 1))
        self._suspect_fp = None
        self._suspect_rid = ""
        self._requeue_preempted()

    def _requeue_preempted(self) -> None:
        """A fill flipped or died: parked preempted fills restart (FIFO,
        ahead of newer arrivals)."""
        if self._preempted:
            self._waiting[:0] = self._preempted
            self._preempted.clear()

    def _drop_fill(self, slot: int, err: BaseException | None = None) -> None:
        """Retire a filling row early: end its stream (_DONE for a gone
        consumer, ``err`` for a deadline) and free the slot and pages."""
        fill = self._filling.pop(slot, None)
        if fill is not None:
            fill.ticket.out.put(_DONE if err is None else err)
        if slot in self._fill_order:
            self._fill_order.remove(slot)
        self._release_slot(slot)
        self._requeue_preempted()

    def _preempt_fill(self) -> None:
        """Every fill is page-blocked and no decode row is left to retire:
        restart the YOUNGEST fill (it emitted nothing, so the restart is
        exact); parked, not re-queued, so it cannot re-grab the pages."""
        dropped = False
        for slot, fill in list(self._filling.items()):
            if fill.ticket.cancelled:
                self._drop_fill(slot)
                dropped = True
        if dropped or not self._filling:
            return
        if len(self._filling) < 2:
            raise RuntimeError(
                "page pool wedged: a lone filling row cannot reserve its "
                "next piece (pool smaller than a validated request?)")
        slot = self._fill_order[-1]
        fill = self._filling.pop(slot)
        self._fill_order.remove(slot)
        self._release_slot(slot)
        self.stats["fill_preempts"] += 1
        self._rec("preempt", slot=slot, request_id=fill.ticket.request_id,
                  filled=fill.filled)
        fill.ticket.restart = True
        fill.ticket.preempts += 1
        self._preempted.append((fill.ids, fill.n, fill.samp, fill.ticket))
        self._backlog_add(1)

    # -- engine loop: dispatch and delivery -----------------------------------

    def _overlap_prep(self) -> None:
        """While dispatched chunks execute: drain the submit queue into the
        FIFO backlog and pre-compute the backlog head's admission prep
        (poison fingerprint, prefix-cache lookup), so an admission boundary
        swaps prepared inputs instead of doing that work serially."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                # the close sentinel is strictly last: hand it back
                self._q.put(None)
                break
            if isinstance(item, list):
                for row_item in item:
                    self._backlog_insert(row_item)
            else:
                self._backlog_insert(item)
        limit = len(self._free) + 2
        for item in self._waiting[:limit]:
            ticket = item[3]
            if ticket.cancelled or ticket in self._prep_memo:
                continue
            fp = _fingerprint(item[0], item[1])
            hit = None
            if self.prefix_cache is not None:
                hit = self.prefix_cache.lookup(item[0], max_total=self.max_len)
            self._prep_memo[ticket] = (fp, hit)

    def _pick_depth(self) -> int:
        """Chunks per dispatch: > 1 only in steady decode (no fill, backlog,
        queued item or owed first token), capped at every row's remaining
        budget so writes stay inside the validated span, on a power-of-two
        ladder."""
        if self._depth_cap <= 1 or not self._rows:
            return 1
        if (self._filling or self._waiting or self._preempted
                or self._first_pending or not self._q.empty()):
            return 1
        rem_min = min(r.budget - r.emitted for r in self._rows.values())
        fit = min(self._depth_cap, rem_min // self.chunk_size)
        if fit <= 1:
            return 1
        depth = 1
        while depth * 2 <= fit:
            depth *= 2
        return depth

    def _dispatch_chunk(self) -> tuple:
        """Dispatch one decode chunk (async on the card) and PLAN its
        emissions now: take counts and retirements depend on budgets only,
        so scheduling runs a chunk ahead of token delivery. The token
        block's device->host copy starts here."""
        depth = self._pick_depth()
        n_steps = depth * self.chunk_size
        self._rec("dispatch", depth=depth, n_steps=n_steps, active=len(self._rows), devices=1)
        with trace.span("continuous.chunk", active=len(self._rows), depth=depth), \
                self.server._device_lock:
            block = self._chunk(n_steps)
            fetch = self._fetch(block)
        self._tok_host = None
        self.stats["chunks"] += depth
        self.stats["dispatches"] += 1
        n_live = len(self._rows) + len(self._filling)
        self.stats["decode_rows"] += self.max_slots * depth
        self.stats["decode_pad_rows"] += max(self.max_slots - n_live, 0) * depth
        if self.page_size > 0:
            pps = int(self._table.shape[1])
            blocks = int(min(pps, (int(self._offsets.max()) + n_steps) // self.page_size + 1))
            self.stats["pages_swept"] = self.stats.get("pages_swept", 0) + blocks
            self.stats["pages_swept_possible"] = self.stats.get("pages_swept_possible", 0) + pps
        self._depth_last = depth
        if depth > self.stats["dispatch_depth_max"]:
            self.stats["dispatch_depth_max"] = depth
        self._inflight_chunks += depth
        if self._inflight_chunks > self.stats["sync_lag_chunks_max"]:
            self.stats["sync_lag_chunks_max"] = self._inflight_chunks
        now = time.monotonic()
        if self._last_chunk_t is not None:
            # the max gap between consecutive dispatches while rows were
            # active is the stall a decoding client can observe
            gap_ms = (now - self._last_chunk_t) * 1e3
            if gap_ms > self.stats["stall_ms_max"]:
                self.stats["stall_ms_max"] = round(gap_ms, 3)
            host_ms = max(0.0, gap_ms - self._sync_wait_s * 1e3)
            self._boundary_host_ms.append(host_ms)
            if self._steady and self._boundary_syncs > self.stats["host_syncs_per_boundary"]:
                # steady decode must cost at most ONE blocking sync per
                # boundary (the lagged token readback)
                self.stats["host_syncs_per_boundary"] = self._boundary_syncs
        self._sync_wait_s = 0.0
        self._boundary_syncs = 0
        self._steady = True
        self._last_chunk_t = now
        self._offsets += n_steps
        self._steps += n_steps
        for slot in self._free:
            # idle slots write garbage at the start of their own rows (the
            # next admission overwrites them); their offsets must stay in
            # range, where the JAX twin's dynamic_update_slice clamps
            self._offsets[slot] = 0
        for slot, fill in self._filling.items():
            # filling slots don't decode: pinned at the fill frontier
            self._offsets[slot] = fill.filled
            self._steps[slot] = 0
        plan = []
        taken = 0
        for slot, row in list(self._rows.items()):
            row.tok_pending = True
            take = min(n_steps - row.skip, row.budget - row.emitted)
            row.emitted += max(take, 0)
            taken += max(take, 0)
            done = row.emitted >= row.budget
            plan.append((slot, row, row.skip, take, done))
            row.skip = 0
            if done:  # reuse is ordered: the device runs dispatches in order
                del self._rows[slot]
                self._release_slot(slot)
        self._tokens_in_flight += taken
        if self._tokens_in_flight > self.stats["tokens_in_flight_peak"]:
            self.stats["tokens_in_flight_peak"] = self._tokens_in_flight
        return fetch, plan, depth

    def _deliver_firsts(self) -> None:
        """Hand this boundary's admitted rows their prefill tokens."""
        firsts, self._first_pending = self._first_pending, []
        for row, first_ref, done in firsts:
            if row.ticket.cancelled:
                row.out.put(_DONE)
                row.closed = True
                continue
            t0 = time.monotonic()
            first_np = first_ref().astype(np.int32)
            self._sync_wait_s += time.monotonic() - t0
            # a blocking fetch, at an admission boundary (not steady decode)
            self._boundary_syncs += 1
            self._steady = False
            ticket = row.ticket
            if not ticket.t_first:
                ticket.t_first = time.monotonic()
                if ticket.t_submit:
                    if ticket.t_admit:
                        self.hist_queue_ms.observe((ticket.t_admit - ticket.t_submit) * 1e3)
                    self.hist_ttft_ms.observe((ticket.t_first - ticket.t_submit) * 1e3)
            if row.seq is not None:
                row.seq.append(int(first_np[0, 0]))
            row.out.put(first_np)
            self.rate_tokens.add(1)
            if row.stops and int(first_np[0, 0]) in row.stops and not done:
                row.out.put(_DONE)
                row.closed = True
                self._rec("eos", slot=row.slot, request_id=ticket.request_id,
                          reason="stop", emitted=row.emitted)
            elif done:
                row.out.put(_DONE)
                self._rec("eos", slot=row.slot, request_id=ticket.request_id,
                          reason="budget", emitted=row.emitted)

    def _put_pieces(self, row: _Row, arr: np.ndarray) -> None:
        """Hand a row its tokens in chunk_size pieces (a deep dispatch's
        take keeps the per-chunk flush cadence of a stream)."""
        cs = self.chunk_size
        for j in range(0, arr.shape[1], cs):
            row.out.put(arr[:, j:j + cs])

    def _deliver(self, pending: tuple | None) -> None:
        """Wait for an in-flight chunk's tokens (the boundary's ONE lagged
        sync: the copy started at dispatch) and hand them to waiters."""
        if pending is None:
            return
        fetch, plan, depth = pending
        t0 = time.monotonic()
        toks = fetch().astype(np.int32)
        wait_s = time.monotonic() - t0
        self._sync_wait_s += wait_s
        self._boundary_syncs += 1
        self._inflight_chunks = max(0, self._inflight_chunks - depth)
        self._rec("readback", depth=depth, rows=len(plan), wait_ms=round(wait_s * 1e3, 3))
        self.rate_tokens.add(sum(max(take, 0) for _, _, _, take, _ in plan))
        self._tok_host = toks[:, -1].copy()
        for slot, row, skip, take, done in plan:
            self._tokens_in_flight = max(0, self._tokens_in_flight - max(take, 0))
            if row.closed:
                continue
            if row.ticket.cancelled:
                row.out.put(_DONE)
                row.closed = True
                continue
            piece = toks[slot: slot + 1, skip: skip + take] if take > 0 else None
            if piece is not None and row.seq is not None:
                row.seq.extend(piece[0].tolist())
            if piece is not None and row.stops:
                cut = stop_cut(piece[0].tolist(), row.stops)
                if cut is not None:
                    self._put_pieces(row, piece[:, :cut])
                    row.out.put(_DONE)
                    row.closed = True
                    self._rec("eos", slot=slot, request_id=row.ticket.request_id,
                              reason="stop", emitted=row.emitted)
                    continue
            if piece is not None:
                self._put_pieces(row, piece)
            if done:
                row.out.put(_DONE)
                self._rec("eos", slot=slot, request_id=row.ticket.request_id,
                          reason="budget", emitted=row.emitted)

    # -- engine loop: admission control ---------------------------------------

    @staticmethod
    def _deadline_passed(ticket: _Ticket, now: float) -> bool:
        return not ticket.cancelled and ticket.deadline is not None and now > ticket.deadline

    def _sweep_backlog(self) -> None:
        """Purge dead backlog entries at every boundary: cancelled rows end
        with _DONE, past-deadline rows with the 504, without a slot."""
        now = time.monotonic()
        for lst, state in ((self._waiting, "waiting for a slot"),
                           (self._preempted, "waiting for pages")):
            keep = []
            for item in lst:
                ticket = item[3]
                if ticket.cancelled:
                    self._backlog_sub(1)
                    self._prep_memo.pop(ticket, None)
                    ticket.out.put(_DONE)
                elif self._deadline_passed(ticket, now):
                    self.stats["expired"] += 1
                    self._rec("deadline", request_id=ticket.request_id, state=state)
                    self._backlog_sub(1)
                    self._prep_memo.pop(ticket, None)
                    ticket.out.put(self._deadline_error(ticket, state))
                else:
                    keep.append(item)
            lst[:] = keep

    def _expire_deadlines(self) -> None:
        """Expire past-deadline ADMITTED requests at the boundary: filling
        rows release slot and pages, decoding rows fail mid-stream."""
        now = time.monotonic()
        for slot, fill in list(self._filling.items()):
            if self._deadline_passed(fill.ticket, now):
                self.stats["expired"] += 1
                self._rec("deadline", slot=slot, request_id=fill.ticket.request_id,
                          state="prefilling")
                self._drop_fill(slot, self._deadline_error(fill.ticket, "prefilling"))
        for row in self._rows.values():
            if not row.closed and self._deadline_passed(row.ticket, now):
                self.stats["expired"] += 1
                self._rec("deadline", slot=row.slot, request_id=row.ticket.request_id,
                          state="decoding")
                row.out.put(self._deadline_error(row.ticket, "decoding"))
                row.closed = True

    def _sweep_closed(self) -> None:
        """Free the slots of rows a stop token ended or a client abandoned,
        BEFORE admission and the next dispatch."""
        self._sweep_backlog()
        self._expire_deadlines()
        for slot, row in list(self._rows.items()):
            if row.ticket.cancelled and not row.closed:
                row.out.put(_DONE)
                row.closed = True
            if row.closed:
                del self._rows[slot]
                self._release_slot(slot)
        for slot, fill in list(self._filling.items()):
            if fill.ticket.cancelled:
                self._drop_fill(slot)

    # -- engine loop: supervision ---------------------------------------------

    def _run(self) -> None:
        """The engine thread: run the loop and restart it after a crash,
        with exponential backoff and a circuit breaker."""
        if self._on_card:
            torch.cuda.set_device(self._device_index)
        with torch.inference_mode():
            while True:
                verdict = self._loop()
                if verdict != "crashed":
                    return
                delay = self.restart_backoff_s * (2 ** max(0, len(self._crash_times) - 1))
                self._closed_ev.wait(delay)
                with self._close_lock:
                    bail = self._closed
                    if bail and self._broken is None:
                        self._broken = EngineBrokenError("closed during restart")
                if bail:
                    self._drain_queue(EngineBrokenError("continuous batcher closed"))
                    self._state = "stopped"
                    return
                self._rebuild()
                with self._close_lock:
                    self._restarts += 1
                    self.stats["engine_restarts"] = self._restarts
                    self._state = "running"
                logger.warning("continuous engine restarted (restart #%d)", self._restarts)

    def _watchdog(self) -> None:
        """Hang monitor: a boundary stalled past the window with rows
        active fails every waiter now, flips the state so /healthz drains,
        and leaves an error the loop raises when the dispatch returns."""
        while not self._closed_ev.wait(max(0.01, min(0.25, self.boundary_watchdog_s / 4))):
            if self._watch_stall is not None or self._state != "running":
                continue
            last = self._progress_t
            busy = bool(self._rows or self._filling or self._first_pending)
            if not busy or last is None:
                continue
            stalled_s = time.monotonic() - last
            if stalled_s <= self.boundary_watchdog_s:
                continue
            err = EngineBrokenError(
                f"boundary watchdog: no dispatch progress in {stalled_s:.2f}s "
                f"(window {self.boundary_watchdog_s}s)")
            self._watch_stall = err
            self.stats["watchdog_stalls"] += 1
            self._rec("watchdog_stall", stalled_s=round(stalled_s, 3),
                      window_s=self.boundary_watchdog_s)
            self._state = "restarting"
            self._flight_dump("watchdog", err)
            logger.error("continuous engine stalled: no boundary progress in %.2fs "
                         "(watchdog %.2fs); failing %d active row(s)", stalled_s,
                         self.boundary_watchdog_s, len(self._rows) + len(self._filling))
            for row in list(self._rows.values()):
                row.out.put(err)
            for fill in list(self._filling.values()):
                fill.ticket.out.put(err)

    def _rebuild(self) -> None:
        """Fresh engine state after a crash: a new KV state, zeroed host
        vectors, every slot free. The prefix cache survives (its entries
        are keyed by token prefix, independent of slot state)."""
        self._cache = None
        self._tok = None
        self._alloc_device_state(self._max_live_tokens)
        if self.page_size > 0:
            self.stats["pages_free"] = len(self._free_pages)
        self._offsets[:] = 0
        self._steps[:] = 0
        self._temp[:] = 0.0
        self._top_k[:] = 0
        self._top_p[:] = 1.0
        self._seeds[:] = 0
        self._use_filters[:] = False
        self._rows = {}
        self._free = list(range(self.max_slots))
        self._first_pending = []
        self._filling = {}
        self._fill_order = []
        self._preempted = []
        self._suspect_fp = None
        self._suspect_rid = ""
        self._last_chunk_t = None
        self._prep_memo = {}
        self._tok_host = None
        self._watch_stall = None
        self._progress_t = None
        if self.flightrec is not None:
            self.flightrec.reset()
            self._rec("rebuild", restarts=self._restarts + 1)
        self._sync_wait_s = 0.0
        self._boundary_syncs = 0
        self._steady = False
        self._tokens_in_flight = 0
        self._inflight_chunks = 0
        self._depth_last = 1

    def _loop(self) -> str:
        pending: "collections.deque[tuple]" = collections.deque()  # oldest first
        try:
            while True:
                if self._watch_stall is not None:
                    raise self._watch_stall
                self._progress_t = time.monotonic()
                self._sweep_closed()
                if not self._rows:
                    # idle gaps are not decode stalls
                    self._last_chunk_t = None
                    self._sync_wait_s = 0.0
                    self._boundary_syncs = 0
                # gather everything admissible (up to free slots), FIFO;
                # block on the queue only when fully idle
                to_admit: list = []
                while True:
                    if self._waiting:
                        if not self._admits_now(self._waiting[0]):
                            break
                        self._gather_prep(self._waiting.pop(0), to_admit)
                        continue
                    block = (not self._rows and not self._filling and not pending
                             and not self._first_pending and not to_admit)
                    try:
                        item = self._q.get(block=block)
                    except queue.Empty:
                        break
                    if (block and self.burst_window_ms > 0
                            and item is not None and self.max_slots > 1):
                        # an idle engine: wait a beat for co-arrivals so a
                        # burst admits as one prefill and decodes in step
                        time.sleep(self.burst_window_ms / 1e3)
                    if isinstance(item, list):
                        for row_item in item:
                            self._backlog_insert(row_item)
                        continue
                    if item is None:
                        err = RuntimeError("continuous batcher closed")
                        for prep in to_admit:
                            prep["ticket"].out.put(err)
                        self._deliver_firsts()
                        while pending:
                            # deliver-then-pop: a chunk that raises stays in
                            # the deque for the failsafe
                            self._deliver(pending[0])
                            pending.popleft()
                        self._fail_active(err)
                        self._state = "stopped"
                        return "closed"
                    if not self._admits_now(item):
                        self._backlog_insert(item)
                        break
                    self._gather_prep(item, to_admit)
                if to_admit:
                    self._admit_all(to_admit)
                if self._spec_ok():
                    # single greedy row: drain everything in flight so the
                    # row's history is complete, then one verify round
                    self._deliver_firsts()
                    while pending:
                        self._deliver(pending[0])
                        pending.popleft()
                    self._sweep_closed()
                    if self._spec_ok():
                        self._spec_step()
                    continue
                n_decode = len(self._rows)
                if self._rows:
                    # go deep only in steady decode; an owed first token
                    # waits for one chunk's enqueue, not pipeline_depth's
                    # (an eager chunk's enqueue is host time, not async)
                    pending.append(self._dispatch_chunk())
                    while (len(pending) < self.pipeline_depth and self._rows
                           and not self._filling and not self._waiting and self._q.empty()
                           and not self._first_pending):
                        pending.append(self._dispatch_chunk())
                if self._filling:
                    landed = self._dispatch_pieces(n_decode * self.chunk_size)
                    if (not landed and self._filling and not self._rows
                            and not pending and not self._first_pending):
                        self._preempt_fill()
                self._deliver_firsts()
                if pending:
                    self._overlap_prep()
                    self._deliver(pending[0])
                    pending.popleft()
        except BaseException as e:  # engine death must not hang waiters
            logger.exception("continuous engine loop died")
            now = time.monotonic()
            err = e if isinstance(e, ServingError) else EngineBrokenError(
                f"engine loop died: {e!r}")
            if err is not e:
                err.__cause__ = e
            with self._close_lock:
                # circuit breaker, decided under the lock submit checks
                self._crash_times = [t for t in self._crash_times
                                     if now - t < self.crash_window_s]
                self._crash_times.append(now)
                broken = (not self.supervise or self._closed
                          or len(self._crash_times) > self.max_crashes)
                if broken:
                    self._broken = err
                    self._state = "broken"
                else:
                    self._state = "restarting"
            if self._suspect_fp is not None:
                self._poison[self._suspect_fp] = self._poison.get(self._suspect_fp, 0) + 1
                self._suspect_fp = None
            self._rec("crash", request_id=self._suspect_rid, error=repr(e)[:200],
                      verdict="broken" if broken else "crashed")
            if e is not self._watch_stall:
                self._flight_dump("circuit-break" if broken else "crash", err)
            self._suspect_rid = ""
            self._deliver_failsafe(pending, err)
            self._fail_active(err, drain_queue=broken)
            return "broken" if broken else "crashed"

    def _deliver_failsafe(self, pending, err: BaseException) -> None:
        """On engine death, rows in an undelivered plan (or owed a first
        token) may be out of _rows already: fail them directly."""
        for row, _first, _done in self._first_pending:
            row.out.put(err)
        self._first_pending = []
        for _fetch, plan, _depth in pending:
            for _slot, row, _skip, _take, _done in plan:
                row.out.put(err)
        self._tokens_in_flight = 0
        self._inflight_chunks = 0

    @staticmethod
    def _is_batch(item) -> bool:
        samp = item[2]
        return isinstance(samp, dict) and samp.get("priority") == "batch"

    def _backlog_insert(self, item) -> None:
        """Priority-aware FIFO: an interactive item queues ahead of the
        TRAILING run of batch items (FIFO within each class), never past a
        restart-pinned ticket; with no batch work queued this is an
        append."""
        if not self._is_batch(item):
            i = len(self._waiting)
            while i > 0:
                queued = self._waiting[i - 1]
                if not self._is_batch(queued) or queued[3].restart:
                    break
                i -= 1
            if i < len(self._waiting):
                self._waiting.insert(i, item)
                return
        self._waiting.append(item)

    def _backlog_add(self, n: int) -> None:
        with self._close_lock:
            self._backlog += n

    def _backlog_sub(self, n: int) -> None:
        with self._close_lock:
            self._backlog = max(0, self._backlog - n)

    def _drain_queue(self, err: BaseException) -> None:
        """Fail every row still in the submit queue."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            rows = item if isinstance(item, list) else [item]
            self._backlog_sub(len(rows))
            for row_item in rows:
                row_item[3].out.put(err)

    def _fail_active(self, err: BaseException, drain_queue: bool = True) -> None:
        for row in self._rows.values():
            row.out.put(err)
        self._rows.clear()
        for fill in self._filling.values():
            fill.ticket.out.put(err)
        self._filling.clear()
        self._fill_order.clear()
        for item in self._preempted:
            item[3].out.put(err)
        self._backlog_sub(len(self._preempted))
        self._preempted.clear()
        for item in self._waiting:
            item[3].out.put(err)
        self._backlog_sub(len(self._waiting))
        self._waiting.clear()
        self._prep_memo.clear()
        if drain_queue:
            # broken/close: nothing will serve the queue. A supervised
            # restart skips this: queued rows admit once the loop is back
            self._drain_queue(err)

    # -- public API -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Counters and live gauges: cumulative stats plus the active /
        filling / waiting counts, the pipeline gauges, the boundary
        host-time percentiles, the latency histograms, the supervision
        state and the device memory sample."""
        snap = dict(self.stats)
        snap["active"] = len(self._rows)
        snap["filling"] = len(self._filling)
        snap["waiting"] = len(self._waiting) + len(self._preempted)
        snap["dispatch_depth"] = self._depth_last
        snap["tokens_in_flight"] = self._tokens_in_flight
        snap["sync_lag_chunks"] = self._inflight_chunks
        try:
            hist_list = list(self._boundary_host_ms)
        except RuntimeError:  # a concurrent append
            hist_list = list(self._boundary_host_ms)
        if hist_list:
            hist = np.asarray(hist_list, np.float64)
            snap["boundary_host_ms_p50"] = round(float(np.percentile(hist, 50)), 3)
            snap["boundary_host_ms_p99"] = round(float(np.percentile(hist, 99)), 3)
            snap["boundary_host_ms_count"] = int(hist.size)
        if self.stats.get("decode_rows"):
            snap["pad_fraction"] = round(
                self.stats["decode_pad_rows"] / self.stats["decode_rows"], 4)
        if self.stats.get("pages_swept_possible"):
            snap["pages_swept_fraction"] = round(
                self.stats["pages_swept"] / self.stats["pages_swept_possible"], 4)
        qh = self.hist_queue_ms.snapshot()
        if qh["count"]:
            snap["queue_ms_hist"] = qh
        th = self.hist_ttft_ms.snapshot()
        if th["count"]:
            snap["ttft_ms_hist"] = th
        snap["engine_state"] = self._state
        snap["mesh"] = "dp=1"
        snap["mesh_devices"] = 1
        snap["quarantined"] = sum(1 for c in self._poison.values() if c >= self.POISON_CRASHES)
        snap["queue_depth"] = self._backlog
        if self.max_queue_depth > 0:
            snap["max_queue_depth"] = self.max_queue_depth
        if self.request_timeout_s > 0:
            snap["request_timeout_s"] = self.request_timeout_s
        snap["tokens_per_s_1m"] = round(self.rate_tokens.rate(60), 4)
        snap["tokens_per_s_5m"] = round(self.rate_tokens.rate(300), 4)
        if self.flightrec is not None:
            snap["flightrec_events"] = self.flightrec.total
        if self.device_telemetry:
            dm = devmem.sample()
            snap["hbm_bytes_in_use"] = dm["hbm_bytes_in_use"]
            snap["hbm_bytes_reservable"] = dm["hbm_bytes_reservable"]
            snap["hbm_source"] = dm["source"]
        return snap

    @property
    def engine_state(self) -> str:
        """running | restarting | broken | stopped: what /healthz reads."""
        return self._state

    def _validate(self, ids: list[int], max_new_tokens: int) -> None:
        s = len(ids)
        if s < 1:
            raise ValueError("empty prompt row")
        # + the overrun margin: a slot keeps writing to the end of its last
        # chunk (or verify block) past the budget
        need = pad_seq_len(s) + max_new_tokens + self._overrun
        if need > self.max_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds the "
                f"engine's max_len {self.max_len} (margin {self._overrun})")
        if self.page_size > 0 and self._need_pages(ids, max_new_tokens) > self.num_pages - 1:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) needs more "
                f"pages than the engine's pool holds "
                f"({self.num_pages - 1} x {self.page_size} tokens)")

    def _check_quarantine(self, ids, n: int) -> None:
        if not self._poison:
            return
        crashes = self._poison.get(_fingerprint(ids, n), 0)
        if crashes >= self.POISON_CRASHES:
            raise PoisonedRequestError(crashes)

    def _enqueue(self, payload, rows: int) -> None:
        with self._close_lock:
            if self._closed:
                raise RuntimeError("continuous batcher closed")
            if self._broken is not None:
                raise EngineBrokenError(
                    f"continuous batcher is broken: {self._broken}") from self._broken
            if self.max_queue_depth > 0 and self._backlog + rows > self.max_queue_depth:
                self.stats["shed"] += rows
                raise QueueFullError(
                    self._backlog, self.max_queue_depth,
                    retry_after=1 + self._backlog // max(1, self.max_slots))
            self._backlog += rows
            self._q.put(payload)

    def _stamp_deadline(self, ticket: _Ticket, timeout_s: float | None = None) -> None:
        """Effective budget = min(engine --request-timeout, the caller's
        propagated remainder)."""
        eff = self.request_timeout_s if self.request_timeout_s > 0 else 0.0
        if timeout_s is not None and timeout_s > 0:
            eff = min(eff, float(timeout_s)) if eff > 0 else float(timeout_s)
        if eff > 0:
            ticket.deadline = time.monotonic() + eff
            ticket.timeout_s = eff

    def _deadline_error(self, ticket: _Ticket, state: str) -> DeadlineExceededError:
        return DeadlineExceededError(state, ticket.timeout_s or self.request_timeout_s)

    def submit(self, ids: list[int], max_new_tokens: int, samp: dict,
               timeout_s: float | None = None, request_id: str = "") -> _Ticket:
        """Enqueue one prompt row; the ticket carries the output queue and a
        ``cancel()`` for a consumer that goes away. ``timeout_s`` clamps
        the deadline to a propagated remainder; ``request_id`` joins the
        engine's timeline with the transport's."""
        self._validate(ids, max_new_tokens)
        self._check_quarantine(ids, max_new_tokens)
        ticket = _Ticket()
        ticket.request_id = str(request_id or "")
        ticket.resume_step = int(samp.get("resume_step", 0) or 0)
        ticket.t_submit = time.monotonic()
        self._stamp_deadline(ticket, timeout_s)
        self._enqueue((list(ids), int(max_new_tokens), dict(samp), ticket), 1)
        return ticket

    def submit_many(self, rows: list[tuple[list[int], int, dict]],
                    timeout_s: float | None = None) -> list[_Ticket]:
        """Enqueue several rows as ONE burst: they admit at the same
        boundary, so same-bucket rows share a prefill deterministically."""
        for ids, n, _samp in rows:
            self._validate(ids, n)
            self._check_quarantine(ids, n)
        tickets = [_Ticket() for _ in rows]
        now = time.monotonic()
        for t, (_ids, _n, samp) in zip(tickets, rows):
            t.t_submit = now
            t.resume_step = int(samp.get("resume_step", 0) or 0)
            self._stamp_deadline(t, timeout_s)
        self._enqueue([(list(ids), int(n), dict(samp), t)
                       for (ids, n, samp), t in zip(rows, tickets)], len(rows))
        return tickets

    def submit_row(self, ids: list[int], max_new_tokens: int, samp: dict) -> "queue.Queue":
        return self.submit(ids, max_new_tokens, samp).out

    def _drain_row(self, out: "queue.Queue") -> Iterator[np.ndarray]:
        while True:
            item = out.get()
            if item is _DONE:
                return
            if isinstance(item, ServingError):
                raise item
            if isinstance(item, BaseException):
                raise EngineBrokenError(f"continuous decode failed: {item}") from item
            yield item

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, stop_token_ids=None, timeout_s: float | None = None,
                 priority: str = "interactive", timing: dict | None = None) -> np.ndarray:
        """[B, S + m], as ModelServer.generate: rows of a multi-row request
        become independent slots with seeds seed+i. With ``stop_token_ids``
        every row's slot frees at its stop; m is the longest row's emitted
        length, shorter rows padded by repeating their stop token (the
        serving layer's inclusive trim cuts at the FIRST stop)."""
        tokens = np.asarray(tokens, np.int32)
        b, _s = tokens.shape
        stops = list(stop_token_ids or ())
        tickets = self.submit_many([
            (tokens[i].tolist(), max_new_tokens,
             {"temperature": temperature, "top_k": top_k, "top_p": top_p,
              "seed": (seed + i) % (2**31), "stop_token_ids": stops, "priority": priority})
            for i in range(b)
        ], timeout_s=timeout_s)
        rows = []
        emitted = 0
        try:
            for t in tickets:
                row = np.concatenate(list(self._drain_row(t.out)), axis=1)
                emitted += int(row.size)
                rows.append(row)
        finally:
            if timing is not None and tickets:
                # a multi-row request reports the WORST row per phase
                for t in tickets:
                    for k, v in t.timing().items():
                        timing[k] = max(timing.get(k, 0), v) if isinstance(v, (int, float)) else v
        width = max(r.shape[1] for r in rows)
        rows = [r if r.shape[1] == width else np.pad(
            r, ((0, 0), (0, width - r.shape[1])), constant_values=int(r[0, -1]))
            for r in rows]
        self.server.stats["tokens_generated"] += emitted
        return np.concatenate([tokens, np.concatenate(rows, axis=0)], axis=1)

    def stream(self, tokens: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: int = 0, chunk_size: int = 0, stop_token_ids=None,
               timeout_s: float | None = None, priority: str = "interactive",
               resume_step: int = 0, request_id: str = "",
               timing: dict | None = None) -> Iterator[np.ndarray]:
        """Single-row streaming: yields [1, k] arrays of new tokens as the
        engine decodes them (the prefill token alone, then up to the
        ENGINE's chunk size; ``chunk_size`` is accepted and ignored).

        ``resume_step`` = k > 0 CONTINUES an interrupted stream: ``tokens``
        = the original prompt + the k tokens already emitted,
        ``max_new_tokens`` = the original budget minus k, the original
        ``seed``; the row re-prefills and its first token is step k of the
        original (seed, step) stream, so the continuation equals the tokens
        the interrupted stream would have emitted next."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.shape[0] != 1:
            raise ValueError("continuous stream is single-row")
        resume_step = int(resume_step)
        if resume_step < 0:
            raise ValueError("resume_step must be >= 0")
        if resume_step >= tokens.shape[1]:
            raise ValueError(f"resume_step {resume_step} >= row length {tokens.shape[1]} "
                             "(pass prompt + emitted tokens)")
        samp = {"temperature": temperature, "top_k": top_k, "top_p": top_p,
                "seed": seed, "stop_token_ids": list(stop_token_ids or ()),
                "priority": priority}
        if resume_step:
            samp["resume_step"] = resume_step
        ticket = self.submit(tokens[0].tolist(), max_new_tokens, samp, timeout_s=timeout_s,
                             request_id=request_id)
        try:
            for piece in self._drain_row(ticket.out):
                self.server.stats["tokens_generated"] += int(piece.size)
                yield piece
        finally:
            # a consumer that stops early frees the slot at the next boundary
            ticket.cancel()
            if timing is not None:
                timing.update(ticket.timing())

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._closed_ev.set()
        self._thread.join(timeout=30)

    def release_device_state(self) -> None:
        """Drop the engine's device allocations (the KV cache or page pool
        and the token vector). Call AFTER ``close()``: an unload returns
        the memory now, not when the collector notices the dead engine."""
        if not self._closed:
            raise RuntimeError("release_device_state requires close() first")
        self._cache = None
        self._tok = None
