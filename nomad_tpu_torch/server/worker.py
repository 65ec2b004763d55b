"""Scheduling worker — dequeue → snapshot-sync → schedule → submit → ack.

Reference: ``nomad/worker.go`` (``Worker.run`` :105-138). Each worker is a
thread that pulls evaluations from the broker, waits for its local state to
catch up to the eval's index (``snapshotMinIndex``, :228 — the ★sync point),
invokes the right scheduler, and acks/nacks the eval. The worker itself is
the scheduler's ``Planner``: ``submit_plan`` enqueues on the leader's plan
queue and blocks on the apply future, then waits out any refresh index
before handing the scheduler a fresh snapshot (:277-330).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from .. import trace
from ..scheduler import new_scheduler
from ..state.store import StateSnapshot
from ..structs.types import Evaluation, Plan, PlanResult

log = logging.getLogger(__name__)

# Scheduler types a worker serves (reference: config.EnabledSchedulers);
# the system and core schedulers are not part of this package yet.
DEFAULT_SCHEDULERS = ["service", "batch"]

# Backstop so a wedged applier can't deadlock a worker forever.
PLAN_APPLY_TIMEOUT = 60.0


class Worker:
    def __init__(self, server, schedulers: Optional[List[str]] = None):
        self.server = server
        self.schedulers = schedulers or list(DEFAULT_SCHEDULERS)
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._renewer: Optional[threading.Thread] = None
        # (eval_id, token) of the delivery currently inside the scheduler
        # invocation; the renewer thread extends its unack lease so a
        # legitimately slow eval (cold jit compile, degraded dispatch)
        # cannot race a nack-timeout redelivery.
        self._active_lease: Optional[Tuple[str, str]] = None
        self.leases_renewed = 0
        self.evals_processed = 0
        self._snapshot: Optional[StateSnapshot] = None

    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return  # leadership can cycle; one thread per worker
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, name="worker", daemon=True)
        self._thread.start()
        if self._renewer is None or not self._renewer.is_alive():
            self._renewer = threading.Thread(
                target=self._renew_loop, name="worker-renew", daemon=True
            )
            self._renewer.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _renew_loop(self) -> None:
        """Lease-renewal heartbeat: while a scheduler invocation is in
        flight, extend its broker unack lease every third of the nack
        timeout.  A ValueError means the delivery was already settled or
        redelivered — nothing to protect; the eval-token check at plan
        apply is the backstop either way."""
        while not self._stop.is_set():
            lease = self._active_lease
            if lease is not None:
                try:
                    self.server.eval_broker.renew(*lease)
                    self.leases_renewed += 1
                except ValueError:
                    pass
            interval = max(
                self.server.eval_broker.nack_timeout / 3.0, 0.05
            )
            self._stop.wait(interval)

    def set_paused(self, paused: bool) -> None:
        if paused:
            self._paused.set()
        else:
            self._paused.clear()

    # ------------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            if self._paused.is_set():
                self._stop.wait(0.05)
                continue
            ev, token = self.server.eval_broker.dequeue(
                self.schedulers, timeout=0.2
            )
            if ev is None:
                continue
            # Root span of the eval's trace (trace id == eval id; the
            # broker's queue_wait span recorded at dequeue shares it).
            with trace.span(
                "eval.process",
                trace_id=ev.id,
                metrics=self.server.metrics,
                type=ev.type,
            ):
                try:
                    self.process_eval(ev, token)
                except Exception:  # noqa: BLE001
                    log.exception("scheduler failed for eval %s", ev.id)
                    try:
                        self.server.eval_broker.nack(ev.id, token)
                    except ValueError:
                        pass
                    trace.event("eval.nack")
                    continue
                try:
                    self.server.eval_broker.ack(ev.id, token)
                except ValueError:
                    pass
                trace.event("eval.ack")
                self.evals_processed += 1

    def process_eval(self, ev: Evaluation, token: str = "") -> None:
        # The delivery token rides on the eval; schedulers stamp it into
        # their plans so the applier can reject a worker whose delivery was
        # nack-timeout-redelivered mid-schedule (eval_token, worker.go:74).
        ev.leader_ack = token
        metrics = self.server.metrics
        # ★ sync point: local replica must reach the eval's creation index
        # before scheduling (worker.go:121, snapshotMinIndex).
        with trace.span("worker.wait_for_index", metrics=metrics), \
                metrics.timer("nomad.worker.wait_for_index").time():
            self.server.store.wait_for_index(ev.modify_index, timeout=5.0)
        self._snapshot = self.server.store.snapshot()
        sched = new_scheduler(
            ev.type, self._snapshot, self, self.server.store.matrix
        )
        # invoke_scheduler timer (worker.go:245) — the per-eval hot path.
        # The renewer thread extends this delivery's unack lease for as
        # long as the scheduler runs (eval_broker.renew).
        self._active_lease = (ev.id, token) if token else None
        try:
            with trace.span("worker.invoke_scheduler", metrics=metrics), \
                    metrics.timer("nomad.worker.invoke_scheduler").time():
                sched.process(ev)
        finally:
            self._active_lease = None
        if ev.create_time:
            # Enqueue→scheduled end-to-end latency (eval_broker telemetry).
            metrics.timer("nomad.eval.latency").observe(
                max(0.0, time.time() - ev.create_time)
            )

    # ------------------------------------------------------------------
    # Planner interface (scheduler/scheduler.go:112; worker.go:277-330)
    # ------------------------------------------------------------------

    def submit_plan(
        self, plan: Plan
    ) -> Tuple[Optional[PlanResult], Optional[StateSnapshot]]:
        with trace.span("plan.submit", metrics=self.server.metrics):
            pending = self.server.plan_queue.enqueue(plan)
            try:
                result = pending.wait(timeout=PLAN_APPLY_TIMEOUT)
            except Exception:  # noqa: BLE001 — queue disabled / apply error
                return None, self.server.store.snapshot()
        snapshot = None
        if result.refresh_index:
            # Partial commit: catch up to the refresh index before retrying
            # (worker.go SubmitPlan → snapshotMinIndex(RefreshIndex)).
            self.server.store.wait_for_index(result.refresh_index, timeout=5.0)
            snapshot = self.server.store.snapshot()
        return result, snapshot

    def update_eval(self, ev: Evaluation) -> None:
        self.server.apply_eval_updates([ev])

    def create_evals(self, evals: List[Evaluation]) -> None:
        self.server.apply_eval_updates(list(evals))

    def refresh_snapshot(self) -> StateSnapshot:
        return self.server.store.snapshot()
