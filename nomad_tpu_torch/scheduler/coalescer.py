"""Dispatch coalescer — pipelined device dispatch for concurrent selects.

Workers enqueue compiled placement requests and block on a future; a
dispatch thread drains the queue, stages up to ``max_lanes`` requests into
preallocated ``(max_lanes, …)`` buffers, and issues ONE fused dispatch
(``ops.kernels.fused_place_batch``: the ``fused_place`` and
``allocs_fit_verify`` kernels) whose packed ``(B, P, 8)`` result costs one
device→host copy.  With ``NOMAD_TPU_MEGABATCH=0`` (read at construction)
the dispatch is the staged one instead: ``ops.kernels.place_batch``, one
launch with no verify column, whose ``(B, P, 7)`` result leaves every
pick's fit to the plan applier.

The loop is a producer/consumer pipeline, as in the JAX package:

* the **dispatch thread** only launches.  On the card each dispatch
  launches its kernels on the current stream, enqueues the packed
  result's copy into a page-locked host tensor right behind them, and
  records a ``torch.cuda.Event`` after the copy; up to ``pipeline_depth``
  launches (env ``NOMAD_TPU_PIPELINE_DEPTH``, default 8) overlap.  On the
  CPU the dispatch runs the plain version synchronously.
* a **resolver thread** polls each ticket's event alone — so the wait
  covers that ticket's kernels and copy and nothing launched after it —
  under the device breaker's watchdog (``obs/breaker.py``), and completes
  the futures in launch order.

The device fault domain: the resolver classifies every wait ok / slow /
wedged; a wedged ticket is abandoned and its lanes fail with
``DeviceWedgedError``.  The breaker gates every dispatch: while it is
open, or half-open with its one canary launch in flight, a dispatch
launches nothing and its lanes fail with ``DeviceBreakerOpenError``.
Both errors reach the worker, which nacks the eval.  The reference
degrades to a host twin instead; on the card that would be a silent
fallback from the kernel to its plain version, which this package never
takes.

The node-sharded dispatch (``parallel/``): given more than one device
(``device=[...]``, or ``n_device_shards`` > 1, or by default every
visible card when a host has several), the coalescer builds a
``('batch', 'node')`` mesh once, homes the matrix's rows to its node
shards (``NodeMatrix.set_shard_count``) and launches
``parallel.sharded_fused_place_batch`` over the mesh-resident copy
(``NodeMatrix.sync_sharded``); ``NOMAD_TPU_SHARDED_MEGABATCH=0`` keeps the
staged ``sharded_place_batch`` instead.  The result is gathered on the
lead device, whose page-locked copy and event come after every shard's
last launch, so the resolver's watchdog times the whole dispatch.  A lost
shard is evacuated (:meth:`DeviceCoalescer.evacuate_shard`): the matrix
re-lays every row over the surviving shards and the mesh drops the lost
node shard's devices; a result scored against an older layout maps its
rows through ``NodeMatrix.translate_rows``.

Because overlapped dispatches read a matrix that plans committed during
their flight may mutate, each ticket records ``matrix.version`` at launch;
a mismatch at resolve time counts into ``stale_dispatches``.  Correctness
does not depend on it: the serialized plan applier re-verifies every plan
against authoritative state.

A fused dispatch has the same shapes every time — ``max_lanes`` lanes
(short batches padded with dead lanes) and a ``PLACEMENT_CHUNK``-long scan
(callers take the first rows they asked for).  A staged dispatch launches
only its live lanes (the reference pads to ``max_lanes`` with all-False
host masks; the resolver reads only live lanes either way).  The
reference's analog: many schedulers walk nodes concurrently and the plan
applier serializes commits (worker.go:49-53, plan_apply.go:49-69).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import trace
from ..device import resolve_device, upload
from ..obs.breaker import (
    STALL_OK,
    STALL_SLOW,
    STALL_WEDGED,
    DeviceBreaker,
    DeviceBreakerOpenError,
    DeviceWedgedError,
    classify_stall,
)
from ..ops import kernels
from ..ops.encode import RequestSlab, SchedRequest
from ..parallel import sharding
from ..retry import env_int
from ..state.matrix import DEVICE_LOCK

log = logging.getLogger(__name__)

# Sparse plan-delta capacity per request; selects with more touched rows
# fall back to the solo dispatch path.
MAX_DELTA_ROWS = 32

_DEPTH_ENV = "NOMAD_TPU_PIPELINE_DEPTH"
_MEGABATCH_ENV = "NOMAD_TPU_MEGABATCH"
_SHARDED_MEGABATCH_ENV = "NOMAD_TPU_SHARDED_MEGABATCH"
# How long the stop path waits for the resolver before it fails the
# queued tickets and the one the resolver is stuck on.
_JOIN_WINDOW_S = 10.0


def default_pipeline_depth() -> int:
    """Overlapping dispatches kept in flight (env-tunable, default 8)."""
    return max(1, env_int(_DEPTH_ENV, 8))


def poll_until(done, deadline_s: float, wedge_factor: float):
    """Poll ``done()`` with growing naps (20 µs to 1 ms) until it is true
    or the watchdog's wedge bound (``deadline_s * wedge_factor``; none when
    ``deadline_s <= 0``) has passed; returns ``(verdict, elapsed_s)``, the
    verdict ``classify_stall``'s, ``wedged`` if the bound passed first.

    The resolver's wait on a ticket's CUDA event.  The reference waits on
    a sacrificial thread (``obs.breaker.watchdog_fetch``); polling the
    event never blocks in a call that cannot be interrupted and starts no
    thread, and gave the better median burst throughput on an H100
    (PERF.md §6 has both measured)."""
    bound = deadline_s * wedge_factor if deadline_s > 0 else float("inf")
    t0 = time.monotonic()
    nap = 20e-6
    while not done():
        elapsed = time.monotonic() - t0
        if elapsed > bound:
            return STALL_WEDGED, elapsed
        time.sleep(nap)
        nap = min(2 * nap, 1e-3)
    elapsed = time.monotonic() - t0
    return classify_stall(elapsed, deadline_s, wedge_factor), elapsed


def megabatch_enabled() -> bool:
    """The fused dispatch (``ops.kernels.fused_place_batch``: explicit lane
    masks and the cross-lane AllocsFit verify column).  Default on;
    ``NOMAD_TPU_MEGABATCH=0`` selects the staged ``place_batch`` dispatch."""
    return os.environ.get(_MEGABATCH_ENV, "1").lower() not in (
        "0", "off", "false",
    )


def sharded_megabatch_enabled() -> bool:
    """The node-sharded fused dispatch (``parallel.
    sharded_fused_place_batch``: the ranking scan and the cross-lane
    AllocsFit verify with the node axis split over the mesh).  Default on
    when a mesh is configured; ``NOMAD_TPU_SHARDED_MEGABATCH=0`` keeps
    multi-device dispatches on the staged ``sharded_place_batch`` (no
    verify column)."""
    return os.environ.get(_SHARDED_MEGABATCH_ENV, "1").lower() not in (
        "0", "off", "false",
    )


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
    # Trace context captured on the submitting worker's thread (place());
    # the dispatch thread stitches coalescer.queue_wait onto it and the
    # resolver thread stitches coalescer.device — the launch→resolver hop.
    trace_ctx: Optional[trace.SpanContext] = None


@dataclass
class _Ticket:
    """One in-flight dispatch: the host tensor its packed result lands in
    (page-locked, filled by a copy the event marks complete; or the CPU
    result itself, with no event), its lanes, and the matrix version its
    inputs were synced at."""

    host: torch.Tensor
    done_event: Optional["torch.cuda.Event"]
    entries: List[_Pending]
    matrix_version: int
    launched_at: float = 0.0
    # True when this launch is the half-open breaker's single probe; its
    # wait's verdict decides whether the card path is re-admitted.
    canary: bool = False


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
        n_device_shards: Optional[int] = None,
    ):
        from .stack import PLACEMENT_CHUNK

        self.matrix = matrix
        # One device, or an ordered list of them (the node-sharded
        # dispatch); the list's first device is the lead.
        self._mesh_devices = sharding.device_list(device)
        self.device = (self._mesh_devices[0] if self._mesh_devices
                       else resolve_device(device))
        if self._mesh_devices and n_device_shards is None:
            n_device_shards = len(self._mesh_devices)
        # Devices dispatches span: None = decided at the first dispatch
        # (every visible card when the host has more than one, else 1).
        self.n_device_shards = n_device_shards
        self._mesh: Optional[sharding.Mesh] = None
        self._sharded_fn = None
        self._sharded_fused_fn = None
        self.sharded_megabatch = sharded_megabatch_enabled()
        self.shard_evacuations = 0
        self._pre_evac_shards: Optional[int] = None
        self._pre_evac_device_shards: Optional[int] = None
        self._pre_evac_devices: Optional[list] = None
        self._evac_batch: Optional[int] = None
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
        self.megabatch = megabatch_enabled()
        self.fused_dispatches = 0
        self.fused_lanes = 0
        self._features: Optional[kernels.Features] = None
        # Device fault domain (obs/breaker.py): the resolver classifies
        # every wait ok/slow/wedged under the watchdog deadline; the
        # breaker gates each dispatch.  Wedged tickets count here (their
        # futures raise DeviceWedgedError).
        self.breaker = DeviceBreaker(metrics=metrics)
        self.wedged_dispatches = 0
        # The ticket the resolver is waiting on (the stop path fails its
        # lanes if the resolver misses its join window).
        self._resolving: Optional[_Ticket] = None

    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        # A fresh leadership term probes the card fresh — a breaker left
        # open by the previous term would refuse every dispatch of the new
        # one until its probation ran out.
        self.breaker.reset()
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

    def inflight_depth(self) -> int:
        """Dispatches launched but not yet resolved (pipeline occupancy)."""
        return self.inflight

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
            trace_ctx=trace.current(),
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
            # batch.  The wait gives way to stop(): a resolver stuck on a
            # wedged card may hold every permit.
            while not self._depth_sem.acquire(timeout=0.1):
                if self._stop.is_set():
                    self._fail(batch, RuntimeError("coalescer stopped"))
                    self._shutdown_pipeline()
                    return
            self._launch(batch)

    def _launch(self, batch: List[_Pending]) -> None:
        """With a pipeline permit held: record the lanes' queue waits, ask
        the breaker, launch and hand the ticket to the resolver; or fail
        the lanes and return the permit."""
        waited = time.time()
        if self.metrics is not None:
            qw = self.metrics.timer("nomad.coalescer.queue_wait")
            for p in batch:
                qw.observe(max(0.0, waited - p.enqueued_at))
        # Stitch each lane's enqueue→launch wait onto its eval trace
        # (carried here from the worker thread on _Pending.trace_ctx).
        for p in batch:
            if p.trace_ctx is not None:
                trace.record_span(
                    "coalescer.queue_wait",
                    p.enqueued_at,
                    waited,
                    ctx=p.trace_ctx,
                    metrics=self.metrics,
                )
        # Device fault domain: while the breaker is open the dispatch
        # launches nothing and its lanes fail with a typed error (the
        # worker nacks the evals); half-open admits exactly one canary
        # launch whose wait's verdict decides re-admission.
        allowed, canary = self.breaker.allow_device_dispatch()
        if not allowed:
            self.breaker.note_degraded()
            self._depth_sem.release()
            self._fail(batch, DeviceBreakerOpenError(self.breaker.state))
            return
        try:
            with trace.span("coalescer.launch", lanes=len(batch),
                            metrics=self.metrics):
                host, event, version = self._dispatch(batch)
        except BaseException as exc:  # noqa: BLE001
            if canary:
                # The probe died before producing a verdict — release the
                # slot so half-open can retry.
                self.breaker.cancel_canary()
            self._depth_sem.release()
            self._fail(batch, exc)
            return
        self.dispatches += 1
        self.coalesced_requests += len(batch)
        self.inflight += 1
        self._tickets.put(
            _Ticket(host, event, batch, version, launched_at=waited,
                    canary=canary)
        )

    @staticmethod
    def _fail(lanes: List[_Pending], err: BaseException) -> None:
        """Complete every lane not yet done with ``err``."""
        for p in lanes:
            if not p.done.is_set():
                p.error = err
                p.done.set()

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
        self._fail(leftover_q, err)
        self._tickets.put(None)  # sentinel after every real ticket
        self._resolver.join(timeout=_JOIN_WINDOW_S)
        if self._resolver.is_alive():
            # The resolver missed its join window (a wait past every
            # watchdog bound, or the watchdog disabled): fail whatever is
            # still queued, and the lanes of the ticket it is stuck on, so
            # no caller blocks past shutdown.
            self._fail_queued_tickets(err)
            stuck = self._resolving
            if stuck is not None:
                if stuck.canary:
                    self.breaker.cancel_canary()
                self._fail(stuck.entries, err)

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
            if ticket.canary:
                self.breaker.cancel_canary()
            self._fail(ticket.entries, err)
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
                self._resolving = ticket
                try:
                    self._resolve(ticket)
                except BaseException as exc:  # noqa: BLE001
                    # Fail the lanes and keep the resolver alive: the
                    # accounting below must run, or the dispatch loop
                    # deadlocks on a permit that never comes back.
                    self._fail(ticket.entries, exc)
                finally:
                    self._resolving = None
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

    def _resolve_sharding(self) -> int:
        """Decide (once, and again after an evacuation or heal) how many
        devices dispatches span, and build the mesh and its programs."""
        if self.n_device_shards is None:
            count = (torch.cuda.device_count()
                     if self.device.type == "cuda" else 1)
            self.n_device_shards = count if count > 1 else 1
        if self.n_device_shards > 1 and self._sharded_fn is None:
            devs = self._mesh_devices
            if devs is None:
                devs = (sharding.visible_devices()
                        if self.device.type == "cuda"
                        else [self.device] * self.n_device_shards)
            # A survivor mesh keeps the first mesh's batch width.
            self._mesh = sharding.make_mesh(
                self.n_device_shards, batch=self._evac_batch, devices=devs)
            self._sharded_fn = sharding.sharded_place_batch(
                self._mesh, self.scan_length)
            node_shards = sharding.node_shard_count(self._mesh)
            if self.megabatch and self.sharded_megabatch:
                self._sharded_fused_fn = sharding.sharded_fused_place_batch(
                    self._mesh, self.scan_length)
            # Home rows to their node shard so claims balance across the
            # node axis and growth never migrates a row between shards;
            # not while an evacuation is active (the survivor layout is
            # the homing).
            if (node_shards > 1 and self._pre_evac_shards is None
                    and self.matrix.capacity % node_shards == 0):
                self.matrix.set_shard_count(node_shards)
                if self.metrics is not None:
                    for s in range(node_shards):
                        self.metrics.gauge_fn(
                            "nomad.matrix.shard_rows",
                            lambda s=s: (
                                self.matrix.shard_row_counts()[s]
                                if s < self.matrix.shard_count else 0),
                            shard=s,
                        )
            log.info("coalescer: node-sharded dispatch over %r (%s)",
                     self._mesh,
                     "fused" if self._sharded_fused_fn else "staged")
        return self.n_device_shards

    def evacuate_shard(self, shard: int) -> int:
        """Evacuate a lost node shard: the matrix re-lays every row over
        the survivors (``NodeMatrix.relayout_shards`` replays the claim
        policy over the nodes in row order, so the layout equals a
        from-scratch one on the surviving shards), and the next dispatch
        builds its mesh without the lost shard's devices.  In-flight
        tickets scored against the old layout map their rows through the
        matrix's remap window.  Returns the surviving shard count."""
        with DEVICE_LOCK:
            before = int(self.matrix.shard_count)
            if before <= 1:
                raise ValueError("evacuation requires shard_count > 1")
            if self._mesh is None:
                self._resolve_sharding()
            mesh = self._mesh
            if self._pre_evac_shards is None:
                self._pre_evac_shards = before
                self._pre_evac_device_shards = self.n_device_shards
                self._pre_evac_devices = self._mesh_devices
                self._evac_batch = mesh.shape[0] if mesh is not None else None
            self.matrix.evacuate_shard(shard)
            survivors = int(self.matrix.shard_count)
            if mesh is not None and shard < mesh.shape[1]:
                self._mesh_devices = [
                    d for row in mesh.devices
                    for j, d in enumerate(row) if j != shard]
                self.n_device_shards = len(self._mesh_devices)
            self._mesh = None
            self._sharded_fn = None
            self._sharded_fused_fn = None
        self.shard_evacuations += 1
        self.breaker.note_evacuation()
        trace.event("coalescer.shard_evacuated", shard=shard,
                    survivors=survivors)
        if self.metrics is not None:
            self.metrics.incr("nomad.coalescer.shard_evacuations")
        return survivors

    def heal_shard_evacuations(self) -> Optional[int]:
        """Re-admit evacuated shards: a full re-layout back to the shard
        count before the first evacuation, through the same remap window,
        and the first mesh's devices.  Returns the restored shard count,
        or None when no evacuation is active."""
        restored = self._pre_evac_shards
        if restored is None:
            return None
        with DEVICE_LOCK:
            self.matrix.relayout_shards(restored)
            self._pre_evac_shards = None
            self.n_device_shards = self._pre_evac_device_shards
            self._mesh_devices = self._pre_evac_devices
            self._evac_batch = None
            self._mesh = None
            self._sharded_fn = None
            self._sharded_fused_fn = None
        trace.event("coalescer.shard_healed", restored=restored)
        return restored

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
        """Launch one fused or staged dispatch; returns (host tensor of the
        packed result, completion event or None on the CPU, matrix version
        at launch).  The staged dispatch launches the ``k`` live lanes
        only, at full features, as the reference's staged path (no
        ``features=``); its sharded twin launches every lane, the dead
        ones with all-False host masks, as the reference's does."""
        sharded = None
        with DEVICE_LOCK:
            if self._resolve_sharding() > 1:
                # The matrix stays resident across the mesh: only dirty
                # rows go to the shards that own them.
                sharded = self.matrix.sync_sharded(self._mesh)
                fused_fn, staged_fn = self._sharded_fused_fn, self._sharded_fn
                n = sharded.n
                dev = sharded.mesh.lead
            else:
                arrays = self.matrix.sync(self.device)
                n = int(arrays.used.shape[0])
                dev = arrays.used.device
            version = self.matrix.version

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

        if sharded is not None:
            if fused_fn is not None:
                packed = fused_fn(
                    sharded, dr, dv, tg, sc, pen, ri, rf, ce, hm, lm,
                    features=self._ratchet_features(k),
                )
                self.fused_dispatches += 1
                self.fused_lanes += k
            else:
                packed = staged_fn(sharded, dr, dv, tg, sc, pen, ri, rf, ce,
                                   hm)
        elif self.megabatch:
            packed = kernels.fused_place_batch(
                arrays, arrays.used,
                *(upload(a, dev)
                  for a in (dr, dv, tg, sc, pen, ri, rf, ce, hm, lm)),
                n_placements=self.scan_length,
                features=self._ratchet_features(k),
            )
            self.fused_dispatches += 1
            self.fused_lanes += k
        else:
            packed = kernels.place_batch(
                arrays, arrays.used,
                *(upload(a[:k], dev)
                  for a in (dr, dv, tg, sc, pen, ri, rf, ce, hm)),
                n_placements=self.scan_length,
            )
        if dev.type != "cuda":
            return packed, None, version
        # One ticket, one copy, behind its own kernels only: the copy is
        # enqueued on the stream right after them and the event after the
        # copy, so the resolver's wait covers this dispatch and nothing
        # launched later.  A sharded result lies on the lead device, whose
        # stream already waits on every shard's last launch.  The
        # page-locked tensor is allocated per ticket: the outcomes are
        # numpy views of it, and torch's caching host allocator hands a
        # block out again only after its copy has completed and its last
        # view is gone.
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        with torch.cuda.device(dev):
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return host, event, version

    def _wait_fetch(self, ticket: _Ticket, deadline: float, factor: float):
        """Wait for the ticket's result under the watchdog; returns
        ``(verdict, packed result as numpy or None when wedged, elapsed
        seconds)``.  With no event (the CPU path: the result is already on
        the host) it is ``ok`` at once; otherwise the ticket's event alone
        is polled (``poll_until``)."""
        event = ticket.done_event
        if event is None:
            return STALL_OK, ticket.host.numpy(), 0.0
        verdict, elapsed = poll_until(event.query, deadline, factor)
        if verdict == STALL_WEDGED:
            return verdict, None, elapsed
        return verdict, ticket.host.numpy(), elapsed

    def _resolve(self, ticket: _Ticket) -> None:
        entries = ticket.entries
        brk = self.breaker
        deadline = brk.deadline_s()
        try:
            verdict, arr, elapsed = self._wait_fetch(
                ticket, deadline, brk.cfg.wedge_factor
            )
        except BaseException as exc:  # noqa: BLE001
            if ticket.canary:
                brk.cancel_canary()
            self._fail(entries, exc)
            return
        if verdict == STALL_WEDGED:
            # The wait blew through the wedge bound: abandon it, trip the
            # breaker, and complete every lane with the typed error — the
            # worker's exception path nacks the eval.  Later tickets still
            # resolve in launch order; the pipeline permit is returned by
            # _resolve_loop's finally.
            brk.record_wedge(elapsed, canary=ticket.canary)
            self.wedged_dispatches += 1
            trace.event(
                "coalescer.wedged_dispatch",
                lanes=len(entries),
                elapsed_ms=round(elapsed * 1e3, 1),
            )
            self._fail(entries, DeviceWedgedError(
                f"device fetch wedged after {elapsed * 1e3:.0f}ms "
                f"(deadline {deadline * 1e3:.0f}ms)",
                elapsed_s=elapsed,
                deadline_s=deadline,
            ))
            return
        if verdict == STALL_SLOW:
            brk.record_slow(elapsed, canary=ticket.canary)
        else:
            brk.record_ok(elapsed, canary=ticket.canary)
        resolved_at = time.time()
        # The launch→resolver hop: each lane's device window (launch to
        # result on the host) recorded here, on the resolver thread,
        # against the trace context the worker thread captured in place().
        for p in entries:
            if p.trace_ctx is not None:
                trace.record_span(
                    "coalescer.device",
                    ticket.launched_at or resolved_at,
                    resolved_at,
                    ctx=p.trace_ctx,
                    metrics=self.metrics,
                    lanes=len(entries),
                )
        if self.matrix.version != ticket.matrix_version:
            # The matrix moved while this dispatch was in flight: its
            # placements were scored against a stale snapshot.  Still safe
            # to propose — the serialized applier re-verifies every plan.
            self.stale_dispatches += 1
            trace.event("coalescer.stale_dispatch")
        fused = arr.shape[-1] == kernels.FUSED_PACKED_WIDTH
        # A relocation (growth of a sharded matrix, an evacuation) while
        # this dispatch was in flight moved rows: map them through the
        # matrix's remap window (rows too old come back -1, a failed
        # placement that the stack retries).  Once a ticket.
        rows = self.matrix.translate_rows(
            arr[:len(entries), :, kernels.PACKED_ROW].astype(np.int32),
            ticket.matrix_version,
        )
        for i, p in enumerate(entries):
            row = arr[i]
            rows_i = rows[i]
            fit_verified = None
            if fused:
                # The device-resident AllocsFit column: a 0.0 on a real
                # placement means an earlier lane in THIS launch already
                # claimed the capacity.  Advisory: the applier decides.  A
                # staged result has no such column: the applier alone
                # judges its picks.
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
