"""Blocked-evaluations tracker.

Reference: ``nomad/blocked_evals.go`` — evals whose placements failed wait
here until cluster capacity changes. Unblocking is keyed by the node's
*computed class* (``Block`` :152, ``Unblock`` :404, ``UnblockNode`` :487,
``watchCapacity`` :508): an eval records which classes it already found
ineligible; a capacity change on a class it has not seen (or any change, if
the eval *escaped* class hashing) re-enqueues it. Duplicate blocked evals per
job are tracked and cancelled by the leader.

Re-enqueue ordering is **per-namespace deficit round-robin**, not the
reference's global FIFO: an unblock event that frees hundreds of one
tenant's evals (a thundering herd after a big node joins) must not
front-run every other tenant at equal priority — the broker's ready
queue is FIFO within a priority band, so the order evals *re-enter* it
IS the fairness policy.  :class:`_DeficitRoundRobin` keeps a persistent
per-namespace deficit across unblock rounds, so a namespace that got a
long run of service in one round starts the next one at the back.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import trace
from ..chaos.injector import inject
from ..structs.types import EvalStatus, EvalTrigger, Evaluation


class _DeficitRoundRobin:
    """Interleave items across namespaces with classic DRR (quantum 1,
    unit cost): each pass every active namespace's deficit grows by the
    quantum; a namespace emits items while its deficit covers them.
    Deficits persist across calls (bounded at ±``_CLAMP``), so heavy
    service in one unblock round is paid back in the next.
    """

    _CLAMP = 64.0

    def __init__(self, quantum: float = 1.0):
        self.quantum = quantum
        self._deficit: Dict[str, float] = {}
        self.rounds = 0
        self.served: Dict[str, int] = {}

    def interleave(self, evals: List[Evaluation]) -> List[Evaluation]:
        if len(evals) <= 1:
            for ev in evals:
                self.served[ev.namespace] = self.served.get(ev.namespace, 0) + 1
            return list(evals)
        queues: "OrderedDict[str, List[Evaluation]]" = OrderedDict()
        for ev in evals:
            queues.setdefault(ev.namespace, []).append(ev)
        # Rotate the starting namespace by accumulated service so the
        # same tenant does not lead every round.
        order = sorted(queues, key=lambda ns: self.served.get(ns, 0))
        out: List[Evaluation] = []
        idx = {ns: 0 for ns in queues}
        while len(out) < len(evals):
            self.rounds += 1
            progressed = False
            for ns in order:
                q = queues[ns]
                if idx[ns] >= len(q):
                    continue
                credit = self._deficit.get(ns, 0.0) + self.quantum
                while idx[ns] < len(q) and credit >= 1.0:
                    out.append(q[idx[ns]])
                    idx[ns] += 1
                    credit -= 1.0
                    progressed = True
                    self.served[ns] = self.served.get(ns, 0) + 1
                self._deficit[ns] = max(
                    -self._CLAMP, min(self._CLAMP, credit)
                ) if idx[ns] < len(q) else 0.0
            if not progressed:
                # Every namespace is deficit-starved this pass; the next
                # pass adds another quantum each — guaranteed progress.
                continue
        # Namespaces fully drained reset their deficit (classic DRR:
        # an empty queue forfeits its credit, preventing burst hoarding).
        return out


class BlockedEvals:
    def __init__(self, enqueue_fn: Callable[[Evaluation], None]):
        self._lock = threading.Lock()
        self._enqueue = enqueue_fn
        self._enabled = False
        # eval_id -> eval, split by whether class hashing escaped.
        self._captured: Dict[str, Evaluation] = {}
        self._escaped: Dict[str, Evaluation] = {}
        # (namespace, job_id) -> blocked eval id (one per job; rest are dups).
        self._jobs: Dict[Tuple[str, str], str] = {}
        self._duplicates: List[Evaluation] = []
        # Classes whose capacity changed while nothing was blocked — lets a
        # Block() racing an Unblock() see the change (b.unblockIndexes).
        self._unblock_indexes: Dict[str, int] = {}
        # Per-namespace fair re-enqueue (module docstring): persistent
        # across unblock rounds, reset with set_enabled(False).
        self._drr = _DeficitRoundRobin()
        self.stats = {
            "total_blocked": 0,
            "total_escaped": 0,
            "total_quota_limit": 0,
            "total_unblocked": 0,
        }

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._captured.clear()
                self._escaped.clear()
                self._jobs.clear()
                self._duplicates.clear()
                self._unblock_indexes.clear()
                self._drr = _DeficitRoundRobin()

    # ------------------------------------------------------------------

    def block(self, ev: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            key = (ev.namespace, ev.job_id)
            existing = self._jobs.get(key)
            if existing is not None and existing != ev.id:
                # Duplicate blocked eval for the job: keep latest, cancel rest
                # (blocked_evals.go:199-219).
                old = self._captured.pop(existing, None) or self._escaped.pop(
                    existing, None
                )
                if old is not None:
                    self._duplicates.append(old)
            self._jobs[key] = ev.id

            # Missed-unblock check: capacity changed on a class this eval
            # hasn't marked ineligible since it was snapshotted.
            if self._missed_unblock_locked(ev):
                del self._jobs[key]
                self._enqueue_unblocked_locked([ev])
                return

            if ev.escaped_computed_class:
                self._escaped[ev.id] = ev
                self.stats["total_escaped"] += 1
            else:
                self._captured[ev.id] = ev
            self.stats["total_blocked"] += 1

    def _missed_unblock_locked(self, ev: Evaluation) -> bool:
        for cls, idx in self._unblock_indexes.items():
            if idx <= ev.snapshot_index:
                continue
            elig = ev.class_eligibility.get(cls)
            if elig is None or elig:
                # Unseen or eligible class changed after our snapshot.
                return True
            if ev.escaped_computed_class:
                return True
        return False

    # ------------------------------------------------------------------

    def unblock(self, computed_class: str, index: int) -> None:
        """Capacity changed on ``computed_class`` (node registered, alloc
        stopped, drain lifted...). Re-enqueue everything that could now fit."""
        spec = inject("blocked.unblock", cls=computed_class)
        if spec is not None and spec.kind == "error":
            # Capacity wakeup lost: evals stay blocked until the next
            # capacity event or the leader's periodic unblock sweep.
            trace.event("seam.blocked.unblock", cls=computed_class,
                        applied=False)
            return
        trace.event("seam.blocked.unblock", cls=computed_class, applied=True)
        with self._lock:
            if not self._enabled:
                return
            self._unblock_indexes[computed_class] = index
            unblock: List[Evaluation] = list(self._escaped.values())
            self._escaped.clear()
            still: Dict[str, Evaluation] = {}
            for ev in self._captured.values():
                elig = ev.class_eligibility.get(computed_class)
                if elig is None or elig:
                    # Eval never saw this class, or saw it eligible (failure
                    # was capacity, not feasibility) → retry.
                    unblock.append(ev)
                else:
                    still[ev.id] = ev
            self._captured = still
            self._enqueue_unblocked_locked(unblock)

    def unblock_all(self, index: int) -> None:
        with self._lock:
            if not self._enabled:
                return
            unblock = list(self._escaped.values()) + list(self._captured.values())
            self._escaped.clear()
            self._captured.clear()
            self._enqueue_unblocked_locked(unblock)

    def unblock_node(self, node_id: str, index: int) -> None:
        """Node-specific unblock used for system jobs when a node joins
        (blocked_evals.go:487). Without per-node tracking we treat it as an
        all-class capacity event scoped to system evals."""
        with self._lock:
            if not self._enabled:
                return
            unblock = [
                ev
                for ev in list(self._captured.values()) + list(self._escaped.values())
                if ev.type == "system"
            ]
            for ev in unblock:
                self._captured.pop(ev.id, None)
                self._escaped.pop(ev.id, None)
            self._enqueue_unblocked_locked(unblock)

    def unblock_failed(self) -> None:
        """Re-enqueue every eval blocked after placement conflicts
        (blocked_evals.go UnblockFailed): its job had room, it lost the
        race for it."""
        with self._lock:
            if not self._enabled:
                return
            unblock = []
            for pool in (self._captured, self._escaped):
                for eid, ev in list(pool.items()):
                    if ev.triggered_by == EvalTrigger.MAX_PLAN_ATTEMPTS.value:
                        unblock.append(pool.pop(eid))
            self._enqueue_unblocked_locked(unblock)

    def _enqueue_unblocked_locked(self, evals: List[Evaluation]) -> None:
        # Deficit round-robin across namespaces: the broker's ready queue
        # is FIFO within a priority band, so this re-enqueue order is the
        # inter-tenant fairness policy (module docstring).
        for ev in self._drr.interleave(evals):
            key = (ev.namespace, ev.job_id)
            if self._jobs.get(key) == ev.id:
                del self._jobs[key]
            requeued = ev.copy()
            requeued.status = EvalStatus.PENDING.value
            self.stats["total_unblocked"] += 1
            self._enqueue(requeued)

    # ------------------------------------------------------------------

    def untrack(self, namespace: str, job_id: str) -> None:
        """Job deregistered: drop its blocked eval (blocked_evals.go:Untrack)."""
        with self._lock:
            eid = self._jobs.pop((namespace, job_id), None)
            if eid:
                self._captured.pop(eid, None)
                self._escaped.pop(eid, None)

    def duplicates(self) -> List[Evaluation]:
        """Drain duplicate blocked evals for the leader to cancel
        (reapDupBlockedEvaluations, nomad/leader.go:593)."""
        with self._lock:
            dups, self._duplicates = self._duplicates, []
            return dups

    def blocked_count(self) -> int:
        with self._lock:
            return len(self._captured) + len(self._escaped)

    def fairness_stats(self) -> Dict[str, object]:
        """DRR service accounting for /v1/overload's dequeue actuator row."""
        with self._lock:
            return {
                "policy": "deficit-round-robin",
                "quantum": self._drr.quantum,
                "rounds": self._drr.rounds,
                "served": dict(self._drr.served),
                "total_unblocked": self.stats["total_unblocked"],
            }
