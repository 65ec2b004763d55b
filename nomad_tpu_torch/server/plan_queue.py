"""Plan queue — priority-ordered pending plans awaiting the applier.

Reference: ``nomad/plan_queue.go`` — workers submit plans concurrently; the
leader's single applier goroutine dequeues them in priority order and settles
each submission through a future.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import List, Optional, Tuple

from .. import trace
from ..structs.types import Plan, PlanResult


class PendingPlan:
    """A submitted plan plus its completion future (planQueue.pendingPlan)."""

    def __init__(self, plan: Plan):
        self.plan = plan
        self._event = threading.Event()
        self._result: Optional[PlanResult] = None
        self._error: Optional[Exception] = None
        # Trace context captured on the submitting worker's thread; the
        # applier thread stitches plan.queue_wait / plan.apply spans onto
        # it (the plan's hop across the worker→applier boundary).
        self.trace_ctx = trace.current()
        self.enqueued_at = time.time()

    def respond(self, result: Optional[PlanResult], error: Optional[Exception]) -> None:
        self._result = result
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        if not self._event.wait(timeout=timeout):
            raise TimeoutError("plan apply timed out")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class PlanQueue:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: List[Tuple[int, int, PendingPlan]] = []
        self._seq = itertools.count()
        self._enabled = False
        self._shutdown = False

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if enabled:
                self._shutdown = False  # restartable after shutdown()
            if not enabled:
                for _, _, pending in self._heap:
                    pending.respond(None, RuntimeError("plan queue disabled"))
                self._heap = []
            self._cond.notify_all()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            for _, _, pending in self._heap:
                pending.respond(None, RuntimeError("plan queue shutdown"))
            self._heap = []
            self._cond.notify_all()

    def enqueue(self, plan: Plan) -> PendingPlan:
        pending = PendingPlan(plan)
        with self._lock:
            if self._shutdown:
                pending.respond(None, RuntimeError("plan queue shutdown"))
                return pending
            if not self._enabled:
                pending.respond(None, RuntimeError("plan queue disabled"))
                return pending
            heapq.heappush(self._heap, (-plan.priority, next(self._seq), pending))
            self._cond.notify_all()
        return pending

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        with self._lock:
            if not self._cond.wait_for(
                lambda: self._heap or self._shutdown, timeout=timeout
            ):
                return None
            if self._shutdown or not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def dequeue_all(self, timeout: Optional[float] = None) -> List[PendingPlan]:
        """Block for the first pending plan, then drain everything queued —
        the applier commits the whole batch under one store-lock acquisition
        instead of paying the lock round-trip per plan."""
        with self._lock:
            if not self._cond.wait_for(
                lambda: self._heap or self._shutdown, timeout=timeout
            ):
                return []
            if self._shutdown or not self._heap:
                return []
            batch = []
            while self._heap:
                batch.append(heapq.heappop(self._heap)[2])
            return batch

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)
