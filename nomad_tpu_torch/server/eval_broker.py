"""Evaluation broker — leader-only priority queue of evaluations.

Reference: ``nomad/eval_broker.go`` (EvalBroker, :47-105). Semantics kept:

- per-scheduler-type ready queues ordered by (priority desc, FIFO);
- at-least-once delivery: ``dequeue`` hands out a token, ``ack``/``nack``
  settle it; un-acked evals past the nack timeout are requeued;
- a delivery limit, after which the eval lands in the special ``_failed``
  queue (reaped by the leader's failed-eval reaper);
- per-job serialization: at most one eval per (namespace, job) is ready or
  outstanding at a time; later ones wait in a per-job pending heap and are
  promoted on ack (``b.pending`` in the reference);
- delayed evals (``wait_until`` in the future) sit in a delay heap serviced
  by a timer thread (reference: ``lib/delayheap`` + ``runDelayedEvalsWatcher``);
- the broker is disabled until leadership is established
  (``nomad/leader.go:222``); enqueues while disabled accumulate and flush on
  enable (``b.enabled`` handling in ``Enqueue``).
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .. import trace
from ..chaos.injector import inject
from ..structs.types import EvalStatus, Evaluation

# Reference: nomad/config.go — EvalNackTimeout / EvalDeliveryLimit defaults.
# Nack timeout is generous: it must cover a worst-case cold jit compile of the
# placement kernels, or the redelivered eval races the still-working worker
# (the eval-token check at plan apply is the backstop either way).
DEFAULT_NACK_TIMEOUT = 120.0
DEFAULT_DELIVERY_LIMIT = 3

FAILED_QUEUE = "_failed"


class _ReadyQueue:
    """Priority heap: max priority first, FIFO within a priority."""

    def __init__(self):
        self._heap: List[Tuple[int, int, Evaluation]] = []
        self._seq = itertools.count()

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(self._heap, (-ev.priority, next(self._seq), ev))

    def pop(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def peek_priority(self) -> Optional[int]:
        if not self._heap:
            return None
        return -self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)


class _Unack:
    __slots__ = ("eval", "token", "nack_timer", "deadline")

    def __init__(self, ev: Evaluation, token: str, deadline: float):
        self.eval = ev
        self.token = token
        self.deadline = deadline


class EvalBroker:
    def __init__(
        self,
        nack_timeout: float = DEFAULT_NACK_TIMEOUT,
        delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
        metrics=None,
    ):
        self.metrics = metrics
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit

        self._enabled = False
        self._ready: Dict[str, _ReadyQueue] = {}
        self._unack: Dict[str, _Unack] = {}  # eval_id -> outstanding
        self._attempts: Dict[str, int] = {}  # eval_id -> deliveries
        # Every eval id currently anywhere in the broker (ready, delayed,
        # pending, or unacked) — enqueue is idempotent against it, which is
        # what makes deferred-flush + restoreEvals on leadership gain safe.
        self._tracked: Set[str] = set()
        # Per-job serialization (namespace, job_id) -> eval ids ready/outstanding.
        self._job_tokens: Dict[Tuple[str, str], str] = {}
        self._pending: Dict[Tuple[str, str], List[Tuple[int, int, Evaluation]]] = {}
        self._seq = itertools.count()
        # Delay heap for wait_until evals.
        self._delayed: List[Tuple[float, int, Evaluation]] = []
        # Ready-queue entry timestamps for the broker.queue_wait trace
        # span — broker-owned (Evaluation.copy() rebuilds from __dict__,
        # so the eval struct itself cannot carry dynamic attributes).
        self._enqueue_ts: Dict[str, float] = {}
        # Evals enqueued while disabled (flushed on enable).
        self._deferred: List[Evaluation] = []
        self._shutdown = False
        self._timer_thread: Optional[threading.Thread] = None

        # Priority-aware shedding (OverloadController actuator): while
        # engaged, evals below the priority floor are deferred into the
        # delay heap with a jittered re-enqueue delay instead of landing
        # ready — backpressure the dispatch side can see, not backlog.
        self._shed_enabled = False
        self._shed_floor = 0
        self._shed_delay = 2.0
        self._shed_jitter = 0.5
        self._shed_max_defers = 8  # aging: progress even under sustained shed
        self._shed_counts: Dict[str, int] = {}
        self._shed_rng = random.Random()

        self.stats = {
            "total_ready": 0,
            "total_unacked": 0,
            "total_pending": 0,
            "total_waiting": 0,
            "total_failed_deliveries": 0,
            "total_shed": 0,
        }

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        """Enable on leadership gain; disable (and flush state) on loss
        (reference: SetEnabled, eval_broker.go:148)."""
        with self._lock:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                self._shutdown = False  # restartable after shutdown()
                deferred, self._deferred = self._deferred, []
                for ev in deferred:
                    self._enqueue_locked(ev)
                if self._timer_thread is None or not self._timer_thread.is_alive():
                    self._timer_thread = threading.Thread(
                        target=self._run_delayed_watcher, daemon=True
                    )
                    self._timer_thread.start()
            else:
                self._flush_locked()
            self._cond.notify_all()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._cond.notify_all()

    def _flush_locked(self) -> None:
        self._ready.clear()
        self._unack.clear()
        self._attempts.clear()
        self._job_tokens.clear()
        self._pending.clear()
        self._delayed = []
        self._tracked.clear()
        self._enqueue_ts.clear()
        self._shed_counts.clear()

    @property
    def enabled(self) -> bool:
        return self._enabled

    # ------------------------------------------------------------------
    # Enqueue
    # ------------------------------------------------------------------

    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            self._enqueue_locked(ev)
            self._cond.notify_all()

    def enqueue_all(self, evals: List[Evaluation]) -> None:
        with self._lock:
            for ev in evals:
                self._enqueue_locked(ev)
            self._cond.notify_all()

    def _enqueue_locked(self, ev: Evaluation) -> None:
        if not self._enabled:
            self._deferred.append(ev)
            return
        if ev.id in self._tracked:
            return
        self._tracked.add(ev.id)
        now = time.time()
        if ev.wait_until and ev.wait_until > now:
            heapq.heappush(self._delayed, (ev.wait_until, next(self._seq), ev))
            return
        self._enqueue_ready_locked(ev)

    def _enqueue_ready_locked(self, ev: Evaluation) -> None:
        if self._maybe_shed_locked(ev):
            return
        # Queue-wait starts at first readiness (per-job pending keeps its
        # original stamp; a nack redelivery re-stamps from requeue).
        self._enqueue_ts.setdefault(ev.id, time.time())
        key = (ev.namespace, ev.job_id)
        holder = self._job_tokens.get(key)
        if holder is not None and holder != ev.id and ev.job_id:
            # Another eval for this job is in flight — park in pending
            # (per-job serialization, eval_broker.go processEnqueue).
            heapq.heappush(
                self._pending.setdefault(key, []),
                (-ev.priority, next(self._seq), ev),
            )
            return
        if ev.job_id:
            self._job_tokens[key] = ev.id
        queue = ev.type or "service"
        self._ready.setdefault(queue, _ReadyQueue()).push(ev)

    # ------------------------------------------------------------------
    # Priority-aware shedding (OverloadController actuator)
    # ------------------------------------------------------------------

    def set_shedding(
        self,
        enabled: bool,
        priority_floor: int = 50,
        delay: float = 2.0,
        jitter: float = 0.5,
    ) -> None:
        """Engage/release shed mode.  Called by OverloadController
        actuator methods (lint O003 holds those to trace + counter
        emission); the chaos seam here lets scenarios lose or slow the
        actuation itself."""
        spec = inject("broker.shed", enabled=str(enabled))
        if spec is not None and spec.kind == "error":
            trace.event("seam.broker.shed", applied=False)
            return  # actuation lost — controller re-drives next tick
        trace.event(
            "seam.broker.shed", applied=True, enabled=enabled,
            floor=priority_floor,
        )
        with self._lock:
            self._shed_enabled = enabled
            self._shed_floor = priority_floor
            self._shed_delay = max(delay, 0.05)
            self._shed_jitter = max(jitter, 0.0)
            if not enabled:
                self._shed_counts.clear()
                # Promote anything the delay heap is only holding for
                # shed reasons at its scheduled time — no early flush
                # needed; the watcher drains naturally.
            self._cond.notify_all()

    def _maybe_shed_locked(self, ev: Evaluation) -> bool:
        """Defer ``ev`` with a jittered delay when shed mode is on and
        its priority sits below the floor.  Ages out after
        ``_shed_max_defers`` deferrals so sustained overload still
        makes (slow) progress on low-priority work."""
        if not self._shed_enabled or ev.priority >= self._shed_floor:
            return False
        defers = self._shed_counts.get(ev.id, 0)
        if defers >= self._shed_max_defers:
            return False
        self._shed_counts[ev.id] = defers + 1
        self.stats["total_shed"] += 1
        if self.metrics is not None:
            self.metrics.incr("nomad.broker.evals_shed")
        spread = 1.0 + self._shed_jitter * (2.0 * self._shed_rng.random() - 1.0)
        deadline = time.time() + max(self._shed_delay * spread, 0.05)
        heapq.heappush(self._delayed, (deadline, next(self._seq), ev))
        return True

    def shed_stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "enabled": self._shed_enabled,
                "priority_floor": self._shed_floor,
                "delay_s": self._shed_delay,
                "total_shed": self.stats["total_shed"],
                "deferred_now": len(self._shed_counts),
            }

    # ------------------------------------------------------------------
    # Dequeue / Ack / Nack
    # ------------------------------------------------------------------

    def dequeue(
        self, schedulers: List[str], timeout: Optional[float] = None
    ) -> Tuple[Optional[Evaluation], str]:
        """Block until an eval for one of ``schedulers`` is ready; returns
        (eval, token) or (None, "") on timeout/shutdown/disable."""
        deadline = time.time() + timeout if timeout is not None else None
        with self._lock:
            while True:
                if self._shutdown:
                    return None, ""
                if self._enabled:
                    ev = self._pop_ready_locked(schedulers)
                    if ev is not None:
                        token = "tok-%x" % next(self._seq)
                        count = self._attempts.get(ev.id, 0) + 1
                        self._attempts[ev.id] = count
                        self._unack[ev.id] = _Unack(
                            ev, token, time.time() + self.nack_timeout
                        )
                        enq_ts = self._enqueue_ts.pop(ev.id, None)
                        break
                # Expired-nack requeues are the watcher thread's job (it
                # notifies when it moves anything), so waiters here sleep
                # for their full remaining timeout instead of 1s-capped
                # poll wakeups that each swept the unack table.
                wait = None
                if deadline is not None:
                    wait = deadline - time.time()
                    if wait <= 0:
                        return None, ""
                self._cond.wait(timeout=wait)
        # Outside the broker lock: stitch the enqueue→dequeue wait into the
        # eval's trace (trace id == eval id, so the worker's root span joins
        # the same trace without any handoff through the eval struct).
        if enq_ts is not None:
            trace.record_span(
                "broker.queue_wait",
                enq_ts,
                time.time(),
                ctx=trace.start_trace(ev.id),
                parent=0,
                metrics=self.metrics,
                attempt=count,
            )
        return ev, token

    def _pop_ready_locked(self, schedulers: List[str]) -> Optional[Evaluation]:
        # Highest priority across the requested queues (DequeueEval scan).
        best_q = None
        best_p = None
        for s in schedulers:
            q = self._ready.get(s)
            if q is None:
                continue
            p = q.peek_priority()
            if p is not None and (best_p is None or p > best_p):
                best_p, best_q = p, q
        return best_q.pop() if best_q else None

    def ack(self, eval_id: str, token: str) -> None:
        """Settle a delivery; promotes the next pending eval for the job
        (reference: Ack, eval_broker.go:696)."""
        with self._lock:
            un = self._unack.get(eval_id)
            if un is None or un.token != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            del self._unack[eval_id]
            self._attempts.pop(eval_id, None)
            self._tracked.discard(eval_id)
            self._enqueue_ts.pop(eval_id, None)
            self._shed_counts.pop(eval_id, None)
            ev = un.eval
            key = (ev.namespace, ev.job_id)
            if self._job_tokens.get(key) == ev.id:
                del self._job_tokens[key]
                pending = self._pending.get(key)
                if pending:
                    _, _, nxt = heapq.heappop(pending)
                    if not pending:
                        del self._pending[key]
                    self._enqueue_ready_locked(nxt)
            self._cond.notify_all()

    def renew(self, eval_id: str, token: str) -> None:
        """Extend the unack lease of an outstanding delivery by a full
        nack timeout.  Workers call this around long scheduler
        invocations (a cold jit compile of the placement kernels can
        legitimately outlast the nack timeout), so slow-but-alive work no
        longer races a timeout redelivery — the hazard the generous
        DEFAULT_NACK_TIMEOUT only papered over.  Raises ValueError on an
        unknown eval or stale token (the delivery was already settled or
        redelivered; the worker's plan can no longer commit anyway)."""
        with self._lock:
            un = self._unack.get(eval_id)
            if un is None or un.token != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            un.deadline = time.time() + self.nack_timeout
            # The watcher naps until the earliest unack deadline; wake it
            # so the pushed-out deadline recomputes.
            self._cond.notify_all()

    def nack(self, eval_id: str, token: str) -> None:
        """Return an eval for redelivery; past the delivery limit it moves to
        the ``_failed`` queue (eval_broker.go:737)."""
        with self._lock:
            un = self._unack.get(eval_id)
            if un is None or un.token != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            del self._unack[eval_id]
            ev = un.eval
            if self._attempts.get(ev.id, 0) >= self.delivery_limit:
                self.stats["total_failed_deliveries"] += 1
                self._ready.setdefault(FAILED_QUEUE, _ReadyQueue()).push(ev)
            else:
                # Redeliver (keeps the job token — same eval retries).
                queue = ev.type or "service"
                self._ready.setdefault(queue, _ReadyQueue()).push(ev)
            self._cond.notify_all()

    def _sweep_nacks_locked(self) -> bool:
        now = time.time()
        expired = [u for u in self._unack.values() if u.deadline <= now]
        for un in expired:
            del self._unack[un.eval.id]
            ev = un.eval
            if self._attempts.get(ev.id, 0) >= self.delivery_limit:
                self.stats["total_failed_deliveries"] += 1
                self._ready.setdefault(FAILED_QUEUE, _ReadyQueue()).push(ev)
            else:
                self._ready.setdefault(ev.type or "service", _ReadyQueue()).push(ev)
        return bool(expired)

    # ------------------------------------------------------------------
    # Delay heap watcher
    # ------------------------------------------------------------------

    def _run_delayed_watcher(self) -> None:
        """Service the delay heap AND requeue expired nacks — the single
        housekeeping thread, so dequeue waiters never have to poll.  Waits
        on the broker condvar (instead of sleeping unlocked) so a freshly
        enqueued delayed eval shortens the nap immediately."""
        with self._lock:
            while True:
                if self._shutdown or not self._enabled:
                    return
                now = time.time()
                moved = self._sweep_nacks_locked()
                while self._delayed and self._delayed[0][0] <= now:
                    _, _, ev = heapq.heappop(self._delayed)
                    self._enqueue_ready_locked(ev)
                    moved = True
                if moved:
                    self._cond.notify_all()
                wait_for = 0.5
                if self._delayed:
                    wait_for = min(wait_for, max(0.0, self._delayed[0][0] - now))
                if self._unack:
                    nxt = min(u.deadline for u in self._unack.values())
                    wait_for = min(wait_for, max(0.0, nxt - now))
                self._cond.wait(timeout=max(wait_for, 0.01))

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def outstanding_token(self, eval_id: str) -> Optional[str]:
        """The token of the currently outstanding delivery of ``eval_id``
        (None if not outstanding). The plan applier rejects plans whose token
        is stale — a worker that lost its delivery to a nack-timeout
        redelivery cannot commit (reference: plan_apply.go token check)."""
        with self._lock:
            un = self._unack.get(eval_id)
            return un.token if un is not None else None

    def ready_count(self, scheduler: Optional[str] = None) -> int:
        with self._lock:
            if scheduler is not None:
                q = self._ready.get(scheduler)
                return len(q) if q else 0
            return sum(len(q) for q in self._ready.values())

    def unacked_count(self) -> int:
        with self._lock:
            return len(self._unack)

    def unacked_ids(self) -> List[str]:
        with self._lock:
            return list(self._unack)

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def delayed_count(self) -> int:
        with self._lock:
            return len(self._delayed)

    def failed_evals(self) -> List[Evaluation]:
        """Drain the failed queue (leader reaper, nomad/leader.go:556)."""
        with self._lock:
            q = self._ready.get(FAILED_QUEUE)
            out = []
            if q:
                while True:
                    ev = q.pop()
                    if ev is None:
                        break
                    out.append(ev)
                    self._tracked.discard(ev.id)
                    self._enqueue_ts.pop(ev.id, None)
                    self._shed_counts.pop(ev.id, None)
                    key = (ev.namespace, ev.job_id)
                    if self._job_tokens.get(key) == ev.id:
                        del self._job_tokens[key]
            return out
