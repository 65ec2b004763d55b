"""Dispatch coalescer — pipelined device dispatch for concurrent selects.

Workers enqueue compiled placement requests and block on a future; a
dispatch thread drains the queue, stages up to ``max_lanes`` requests into
preallocated ``(max_lanes, …)`` buffers, and issues ONE fused dispatch
(``ops.kernels.fused_place_batch``: the ``fused_place`` and
``allocs_fit_verify`` kernels) whose packed ``(B, P, 8)`` result costs one
device→host copy.

The loop is a producer/consumer pipeline, as in the JAX package:

* the **dispatch thread** only launches.  On the card each dispatch
  launches on the current stream and records a ``torch.cuda.Event``; up to
  ``pipeline_depth`` launches (env ``NOMAD_TPU_PIPELINE_DEPTH``, default 8)
  overlap.  On the CPU the dispatch runs the plain version synchronously.
* a **resolver thread** waits on each ticket's event, does the one
  ``.cpu()`` of its packed result, and completes the futures in launch
  order.

Because overlapped dispatches read a matrix that plans committed during
their flight may mutate, each ticket records ``matrix.version`` at launch;
a mismatch at resolve time counts into ``stale_dispatches``.  Correctness
does not depend on it: the serialized plan applier re-verifies every plan
against authoritative state.

Every dispatch has the same shapes — ``max_lanes`` lanes (short batches
padded with dead lanes) and a ``PLACEMENT_CHUNK``-long scan (callers take
the first rows they asked for).  The reference's analog: many schedulers
walk nodes concurrently and the plan applier serializes commits
(worker.go:49-53, plan_apply.go:49-69).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..ops import kernels
from ..ops.encode import RequestSlab, SchedRequest
from ..retry import env_int
from ..state.matrix import DEVICE_LOCK

log = logging.getLogger(__name__)

# Sparse plan-delta capacity per request; selects with more touched rows
# fall back to the solo dispatch path.
MAX_DELTA_ROWS = 32

_DEPTH_ENV = "NOMAD_TPU_PIPELINE_DEPTH"


def default_pipeline_depth() -> int:
    """Overlapping dispatches kept in flight (env-tunable, default 8)."""
    return max(1, env_int(_DEPTH_ENV, 8))


@dataclass
class PlaceOutcome:
    """Unpacked per-request result (numpy, host-side)."""

    rows: np.ndarray  # (P,) i32
    scores: np.ndarray  # (P,) f32
    binpack: np.ndarray  # (P,) f32
    preempted: np.ndarray  # (P,) bool
    nodes_evaluated: np.ndarray  # (P,) i32
    nodes_filtered: np.ndarray  # (P,) i32
    nodes_exhausted: np.ndarray  # (P,) i32
    # The device-resident AllocsFit re-verify verdicts ((P,) bool — True =
    # placement survives the sequential cross-lane re-check at
    # `matrix_version`) and the matrix version the dispatch was scored
    # against.  At an unchanged version a False verdict is a guaranteed
    # plan-applier rejection; the applier stays authoritative either way.
    fit_verified: Optional[np.ndarray] = None
    matrix_version: int = -1


@dataclass
class _DeviceOp:
    fn: "callable"
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None


@dataclass
class _Pending:
    request: SchedRequest
    delta_rows: np.ndarray  # (MAX_DELTA_ROWS,) i32, -1 padded
    delta_vals: np.ndarray  # (MAX_DELTA_ROWS, 3) f32
    tg_count: np.ndarray  # (N,) i32
    spread_counts: np.ndarray  # (S, V) f32
    penalty: np.ndarray  # (N,) bool
    class_elig: np.ndarray  # (pad,) bool
    host_mask: np.ndarray  # (N,) bool
    # Placements the caller will actually consume (0 = all scan_length).
    n_live: int = 0
    enqueued_at: float = 0.0
    done: threading.Event = field(default_factory=threading.Event)
    outcome: Optional[PlaceOutcome] = None
    error: Optional[BaseException] = None


@dataclass
class _Ticket:
    """One in-flight dispatch: the packed result (a tensor on the card with
    the event that marks it complete, or a CPU tensor), its lanes, and the
    matrix version its inputs were synced at."""

    packed: torch.Tensor
    done_event: Optional["torch.cuda.Event"]
    entries: List[_Pending]
    matrix_version: int
    launched_at: float = 0.0


class DeviceCoalescer:
    """The single dispatch port for the shared device matrix."""

    def __init__(
        self,
        matrix,
        max_lanes: int = 64,
        scan_length: Optional[int] = None,
        linger_s: float = 0.002,
        pipeline_depth: Optional[int] = None,
        metrics=None,
        device="cuda",
    ):
        from .stack import PLACEMENT_CHUNK

        self.matrix = matrix
        self.device = resolve_device(device)
        self.max_lanes = max_lanes
        self.scan_length = scan_length or PLACEMENT_CHUNK
        self.linger_s = linger_s
        self.pipeline_depth = (
            pipeline_depth if pipeline_depth else default_pipeline_depth()
        )
        self.metrics = metrics  # optional MetricsRegistry (the server's)
        self._queue: List[_Pending] = []
        # Arbitrary device closures (oversized-delta solo selects) executed
        # on the dispatch thread so the server has exactly ONE
        # device-launching thread.
        self._ops: List[_DeviceOp] = []
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._resolver: Optional[threading.Thread] = None
        self._tickets: Optional["queue.Queue"] = None
        self._depth_sem: Optional[threading.Semaphore] = None
        # Preallocated (max_lanes, N) host staging buffers the lanes write
        # into; lane padding by memset (see _staging).
        self._stage: Optional[Dict[str, np.ndarray]] = None
        self._req_slab = RequestSlab(max_lanes)
        # Gauges/counters (ints under the GIL; exact enough for telemetry).
        self.dispatches = 0
        self.coalesced_requests = 0
        self.stale_dispatches = 0
        self.inflight = 0
        self.solo_ops = 0
        # Fused accounting: launches and live lanes, and the
        # occupancy-features ratchet (a monotone widening union of what
        # the batches used).
        self.fused_dispatches = 0
        self.fused_lanes = 0
        self._features: Optional[kernels.Features] = None

    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        # The pipeline bound: a launch consumes a permit, the resolver
        # returns it after the fetch, so exactly pipeline_depth dispatches
        # overlap.  The ticket queue itself never blocks.
        self._depth_sem = threading.BoundedSemaphore(self.pipeline_depth)
        self._tickets = queue.Queue()
        self._resolver = threading.Thread(
            target=self._resolve_loop, name="resolver-coalescer", daemon=True
        )
        self._resolver.start()
        self._thread = threading.Thread(
            target=self._run, name="device-coalescer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread:
            self._thread.join(timeout=10)

    # ------------------------------------------------------------------

    def place(
        self,
        request: SchedRequest,
        delta_rows: np.ndarray,
        delta_vals: np.ndarray,
        tg_count: np.ndarray,
        spread_counts: np.ndarray,
        penalty: np.ndarray,
        class_elig: np.ndarray,
        host_mask: np.ndarray,
        timeout: float = 600.0,
        n_live: int = 0,
    ) -> PlaceOutcome:
        """Submit one placement request; blocks until its batch lands.
        The scan always runs ``scan_length`` steps — take ``rows[:k]``."""
        p = _Pending(
            request=request,
            delta_rows=delta_rows,
            delta_vals=delta_vals,
            tg_count=tg_count,
            spread_counts=spread_counts,
            penalty=penalty,
            class_elig=class_elig,
            host_mask=host_mask,
            n_live=n_live,
            enqueued_at=time.time(),
        )
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("coalescer stopped")
            self._queue.append(p)
            self._cond.notify()
        if not p.done.wait(timeout=timeout):
            raise TimeoutError("coalescer dispatch timed out")
        if p.error is not None:
            raise p.error
        assert p.outcome is not None
        return p.outcome

    def run_device_op(self, fn, timeout: float = 600.0):
        """Execute ``fn()`` on the dispatch thread and return its result —
        for device work that doesn't fit the batched placement shape
        (oversized-delta solo selects)."""
        op = _DeviceOp(fn=fn)
        self.solo_ops += 1
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("coalescer stopped")
            self._ops.append(op)
            self._cond.notify()
        if not op.done.wait(timeout=timeout):
            raise TimeoutError("device op timed out")
        if op.error is not None:
            raise op.error
        return op.result

    # ------------------------------------------------------------------

    def _run(self) -> None:
        """Dispatch (producer) loop: build batches, launch, hand tickets to
        the resolver.  Never blocks on a device→host copy."""
        while True:
            self._drain_ops()
            batch = self._next_batch()
            if batch is None and self._stop.is_set():
                self._shutdown_pipeline()
                return
            if not batch:
                continue
            # Wait for a pipeline slot BEFORE launching: the permit bounds
            # overlapping dispatches (and how stale an in-flight read can
            # get).  Requests arriving meanwhile coalesce into the next
            # batch.
            self._depth_sem.acquire()
            waited = time.time()
            if self.metrics is not None:
                qw = self.metrics.timer("nomad.coalescer.queue_wait")
                for p in batch:
                    qw.observe(max(0.0, waited - p.enqueued_at))
            try:
                with trace.span("coalescer.launch", lanes=len(batch),
                                metrics=self.metrics):
                    packed, event, version = self._dispatch(batch)
            except BaseException as exc:  # noqa: BLE001
                self._depth_sem.release()
                for p in batch:
                    p.error = exc
                    p.done.set()
                continue
            self.dispatches += 1
            self.coalesced_requests += len(batch)
            self.inflight += 1
            self._tickets.put(
                _Ticket(packed, event, batch, version, launched_at=waited)
            )

    def _shutdown_pipeline(self) -> None:
        """Stop path: fail queued work, let the resolver drain in-flight
        tickets (their callers are still blocked on real futures), then
        join it."""
        with self._cond:
            leftover_ops, self._ops = self._ops, []
            leftover_q, self._queue = self._queue, []
        err = RuntimeError("coalescer stopped")
        for op in leftover_ops:
            op.error = err
            op.done.set()
        for p in leftover_q:
            p.error = err
            p.done.set()
        self._tickets.put(None)  # sentinel after every real ticket
        self._resolver.join(timeout=10)
        if self._resolver.is_alive():
            self._fail_queued_tickets(err)

    def _fail_queued_tickets(self, err: BaseException) -> None:
        """Drain the ticket queue and fail every undone future, with the
        same pipeline accounting as _resolve_loop's finally block."""
        while True:
            try:
                ticket = self._tickets.get_nowait()
            except queue.Empty:
                return
            if ticket is None:
                continue
            for p in ticket.entries:
                if not p.done.is_set():
                    p.error = err
                    p.done.set()
            self.inflight -= 1
            try:
                self._depth_sem.release()
            except ValueError:
                pass  # bounded; resolver may have already released it
            with self._cond:
                self._cond.notify_all()

    def _resolve_loop(self) -> None:
        """Resolver (consumer) loop: the ONLY place the live path blocks on
        a device→host copy.  Tickets complete in launch order."""
        try:
            while True:
                ticket = self._tickets.get()
                if ticket is None:
                    return
                try:
                    self._resolve(ticket)
                except BaseException as exc:  # noqa: BLE001
                    # Fail the lanes and keep the resolver alive: the
                    # accounting below must run, or the dispatch loop
                    # deadlocks on a permit that never comes back.
                    for p in ticket.entries:
                        if not p.done.is_set():
                            p.error = exc
                            p.done.set()
                finally:
                    self.inflight -= 1
                    self._depth_sem.release()
                    with self._cond:
                        self._cond.notify_all()
        finally:
            self._fail_queued_tickets(RuntimeError("coalescer stopped"))

    def _drain_ops(self) -> None:
        while True:
            with self._cond:
                if not self._ops:
                    return
                op = self._ops.pop(0)
            try:
                op.result = op.fn()
            except BaseException as exc:  # noqa: BLE001
                op.error = exc
            op.done.set()

    def _next_batch(self) -> Optional[List[_Pending]]:
        with self._cond:
            if not self._queue:
                # Untimed wait: place()/run_device_op() notify on enqueue,
                # stop() on shutdown, the resolver after every ticket.
                self._cond.wait_for(
                    lambda: bool(self._queue)
                    or bool(self._ops)
                    or self._stop.is_set(),
                )
            if not self._queue:
                return None
        # Linger briefly so concurrent workers land in one dispatch.
        if self.linger_s:
            self._stop.wait(self.linger_s)
        with self._cond:
            batch = self._queue[: self.max_lanes]
            del self._queue[: len(batch)]
        return batch or None

    # ------------------------------------------------------------------

    def _ratchet_features(self, k: int) -> kernels.Features:
        """The occupancy-features ratchet: a monotone widening union, so a
        narrow batch after a wide one keeps the wide loop bounds."""
        feats = kernels.features_of(self._req_slab.live_view(k))
        if self._features is not None:
            feats = self._features.widen(feats)
        self._features = feats
        return feats

    def _staging(self, n: int, cw: int, sc_shape) -> Dict[str, np.ndarray]:
        """Preallocated (max_lanes, …) host staging buffers.  Lanes write
        rows in place; unused lanes are padded by memset.  Rebuilt only
        when the matrix grows or the class-pad bucket shifts."""
        st = self._stage
        if (
            st is None
            or st["host_mask"].shape[1] != n
            or st["class_elig"].shape[1] != cw
            or st["spread_counts"].shape[1:] != sc_shape
        ):
            lanes = self.max_lanes
            st = self._stage = {
                "host_mask": np.zeros((lanes, n), bool),
                "tg_count": np.zeros((lanes, n), np.int32),
                "penalty": np.zeros((lanes, n), bool),
                "class_elig": np.ones((lanes, cw), bool),
                "spread_counts": np.zeros((lanes,) + sc_shape, np.float32),
                "delta_rows": np.full((lanes, MAX_DELTA_ROWS), -1, np.int32),
                "delta_vals": np.zeros(
                    (lanes, MAX_DELTA_ROWS, 3), np.float32
                ),
                "lane_mask": np.zeros((lanes,), bool),
            }
        return st

    def _dispatch(self, batch: List[_Pending]):
        """Launch one fused dispatch; returns (packed result, completion
        event or None on the CPU, matrix version at launch)."""
        with DEVICE_LOCK:
            arrays = self.matrix.sync(self.device)
            version = self.matrix.version
        n = int(arrays.used.shape[0])

        k = len(batch)
        cw = max(p.class_elig.shape[0] for p in batch)
        sc_shape = batch[0].spread_counts.shape
        st = self._staging(n, cw, sc_shape)
        hm, tg = st["host_mask"], st["tg_count"]
        pen, ce = st["penalty"], st["class_elig"]
        sc, dr, dv = st["spread_counts"], st["delta_rows"], st["delta_vals"]
        lm = st["lane_mask"]
        lm[:k] = True
        lm[k:] = False
        for i, p in enumerate(batch):
            # Requests built just before a matrix growth or a class-count
            # pow2 crossing carry narrower arrays; the staging row's tail
            # keeps the inert value (new rows masked off — they were not
            # host-checked; unknown classes eligible, matching
            # _class_eligibility's default).
            w = p.host_mask.shape[0]
            hm[i, :w] = p.host_mask
            hm[i, w:] = False
            w = p.tg_count.shape[0]
            tg[i, :w] = p.tg_count
            tg[i, w:] = 0
            w = p.penalty.shape[0]
            pen[i, :w] = p.penalty
            pen[i, w:] = False
            w = p.class_elig.shape[0]
            ce[i, :w] = p.class_elig
            ce[i, w:] = True
            sc[i] = p.spread_counts
            dr[i] = p.delta_rows
            dv[i] = p.delta_vals
        if k < self.max_lanes:
            # Dead lanes are masked by lane_mask; their deltas are reset so
            # a stale row id can never reach the verify scan.
            hm[k:] = False
            dr[k:] = -1

        # Request operands: the preallocated slab, packed into the two
        # tensors the kernels read (dead-lane rows keep earlier contents,
        # masked off by lane_mask).
        for i, p in enumerate(batch):
            self._req_slab.fill(i, p.request)
        ri, rf = kernels.pack_requests(self._req_slab.batch())
        feats = self._ratchet_features(k)

        dev = arrays.used.device

        def up(a: np.ndarray) -> torch.Tensor:
            # Pageable-memory copies are staged before the call returns, so
            # the staging buffers can be rewritten by the next dispatch.
            return torch.from_numpy(a).to(dev, non_blocking=True)

        packed = kernels.fused_place_batch(
            arrays, arrays.used, up(dr), up(dv), up(tg), up(sc), up(pen),
            up(ri), up(rf), up(ce), up(hm), up(lm),
            n_placements=self.scan_length, features=feats,
        )
        self.fused_dispatches += 1
        self.fused_lanes += k
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return packed, event, version

    def _resolve(self, ticket: _Ticket) -> None:
        if ticket.done_event is not None:
            ticket.done_event.synchronize()
        arr = ticket.packed.cpu().numpy()  # ONE device→host copy
        entries = ticket.entries
        if self.matrix.version != ticket.matrix_version:
            # The matrix moved while this dispatch was in flight: its
            # placements were scored against a stale snapshot.  Still safe
            # to propose — the serialized applier re-verifies every plan.
            self.stale_dispatches += 1
            trace.event("coalescer.stale_dispatch")
        for i, p in enumerate(entries):
            row = arr[i]
            rows_i = row[:, kernels.PACKED_ROW].astype(np.int32)
            # The device-resident AllocsFit column: a 0.0 on a real
            # placement means an earlier lane in THIS launch already
            # claimed the capacity.  Advisory: the applier decides.
            vcol = row[:, kernels.FUSED_PACKED_VERIFIED]
            fit_verified = ~((rows_i >= 0) & (vcol == 0.0))
            p.outcome = PlaceOutcome(
                rows=rows_i,
                scores=row[:, kernels.PACKED_SCORE],
                binpack=row[:, kernels.PACKED_BINPACK],
                preempted=row[:, kernels.PACKED_PREEMPT] != 0.0,
                nodes_evaluated=row[:, kernels.PACKED_EVALUATED].astype(
                    np.int32
                ),
                nodes_filtered=row[:, kernels.PACKED_FILTERED].astype(
                    np.int32
                ),
                nodes_exhausted=row[:, kernels.PACKED_EXHAUSTED].astype(
                    np.int32
                ),
                fit_verified=fit_verified,
                matrix_version=ticket.matrix_version,
            )
            p.done.set()
