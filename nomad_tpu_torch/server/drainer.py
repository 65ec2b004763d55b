"""Node drainer — paced migration off draining nodes.

Reference: ``nomad/drainer/drainer.go:189-393`` with its three parts:
``watch_nodes.go`` (track draining nodes, detect completion),
``watch_jobs.go`` (per-job migrate pacing by the ``migrate`` stanza's
``max_parallel``), and ``drain_heap.go`` (coalesced deadlines).

Mechanism in this build: the drainer stamps batches of allocations with a
``migrate`` DesiredTransition (one batched raft apply,
``drainer.go:357``) and cuts an eval per affected job; the reconciler
migrates ONLY stamped allocs (reconcile_util.go filterByTainted), so the
stamp rate IS the pacing.  In-flight migrations are measured as stamped
allocs whose replacement has not yet reported healthy (or running, when
the group has no update stanza).  At the node's drain deadline every
remaining alloc is stamped at once (force).  When a draining node holds no
more migratable allocs, its drain flag is cleared (the node stays
ineligible) — ``NodesDrainComplete``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..structs.types import (
    AllocClientStatus,
    DesiredTransition,
    EvalStatus,
    EvalTrigger,
    Evaluation,
    JobType,
)

log = logging.getLogger(__name__)


class NodeDrainer:
    def __init__(self, server, poll_interval: float = 0.25):
        self.server = server
        self.poll_interval = poll_interval
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()

    def start(self) -> None:
        self._shutdown.clear()
        self._thread = threading.Thread(
            target=self._run, name="node-drainer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)

    def notify(self) -> None:
        """Kick the loop (a node began/ended draining, or allocs changed)."""
        self._wake.set()

    # ------------------------------------------------------------------

    def _run(self) -> None:
        store = self.server.store
        index = 0
        while not self._shutdown.is_set():
            # A snapshot of the table: registrations add nodes while this
            # thread reads it.
            draining = [
                n for n in list(store.nodes.values())
                if n.drain and n.drain_strategy is not None
            ]
            # Deadline heap equivalent: the nearest forced deadline bounds
            # the wait (drain_heap.go coalescing collapses to "earliest").
            timeout = self.poll_interval if draining else 1.0
            for n in draining:
                fd = n.drain_strategy.force_deadline
                if fd:
                    timeout = min(timeout, max(0.0, fd - time.time()))
            self._wake.clear()
            if draining:
                store.wait_for_table(
                    "allocs", index, timeout=max(timeout, 0.01)
                )
            else:
                # Idle (no draining node): drain starts are discovered by
                # the 1s poll either way, so don't ride the allocs watch —
                # it wakes this thread on every plan apply for nothing.
                self._wake.wait(timeout=timeout)
            index = store.table_index("allocs")
            if self._shutdown.is_set():
                return
            try:
                self._drain_pass(draining)
            except Exception:  # noqa: BLE001
                log.exception("drainer pass failed")

    # ------------------------------------------------------------------

    def _drain_pass(self, draining) -> None:
        store = self.server.store
        now = time.time()
        # Per-job in-flight counts span ALL draining nodes (watch_jobs.go
        # paces per job, not per node).
        transitions: Dict[str, DesiredTransition] = {}
        evals_for: Dict[Tuple[str, str], int] = {}
        inflight = self._inflight_by_job()

        for node in draining:
            strat = node.drain_strategy
            deadline_hit = bool(strat.force_deadline) and now >= strat.force_deadline
            migratable = []
            system_allocs = []
            for a in store.allocs_by_node(node.id):
                if a.terminal_status():
                    continue
                job = a.job
                if job is not None and job.type == JobType.SYSTEM.value:
                    if not strat.ignore_system_jobs:
                        system_allocs.append(a)
                    continue
                migratable.append(a)

            if not migratable:
                # All migratable work is gone.  Stop remaining system allocs
                # *before* marking the drain complete (watch_nodes.go:91-101
                # drains RemainingAllocs when IsDone); only then
                # NodesDrainComplete.
                unstamped = [
                    a for a in system_allocs
                    if not a.desired_transition.should_migrate()
                ]
                if unstamped:
                    for a in unstamped:
                        transitions[a.id] = DesiredTransition(migrate=True)
                        key = (a.namespace, a.job_id)
                        evals_for[key] = max(
                            evals_for.get(key, 0),
                            a.job.priority if a.job is not None else 50,
                        )
                    continue
                if system_allocs:
                    continue  # stamped, waiting for them to stop
                self.server.complete_node_drain(node.id)
                continue

            # At the forced deadline every remaining alloc (system included)
            # is stamped at once, unpaced (drainer.go deadline handling).
            remaining = migratable + (system_allocs if deadline_hit else [])
            for a in remaining:
                if a.desired_transition.should_migrate():
                    continue  # already stamped; scheduler owns it now
                key = (a.namespace, a.job_id)
                if not deadline_hit:
                    tg = (
                        a.job.lookup_task_group(a.task_group)
                        if a.job is not None
                        else None
                    )
                    migrate = (
                        tg.migrate_strategy if tg is not None else None
                    )
                    max_parallel = migrate.max_parallel if migrate else 1
                    if inflight.get(key, 0) >= max_parallel:
                        continue
                    inflight[key] = inflight.get(key, 0) + 1
                transitions[a.id] = DesiredTransition(migrate=True)
                evals_for[key] = max(
                    evals_for.get(key, 0),
                    a.job.priority if a.job is not None else 50,
                )

        if transitions:
            evals = [
                Evaluation(
                    namespace=ns,
                    priority=prio,
                    type=(
                        store.job_by_id(ns, jid).type
                        if store.job_by_id(ns, jid)
                        else JobType.SERVICE.value
                    ),
                    triggered_by=EvalTrigger.NODE_DRAIN.value,
                    job_id=jid,
                    status=EvalStatus.PENDING.value,
                )
                for (ns, jid), prio in evals_for.items()
            ]
            self.server.apply_alloc_desired_transitions(transitions, evals)

    def _inflight_by_job(self) -> Dict[Tuple[str, str], int]:
        """Stamped-but-unfinished migrations per job: the stamped alloc is
        still non-terminal, or its replacement hasn't reported healthy yet
        (watch_jobs.go handleTaskGroup's health gate)."""
        store = self.server.store
        counts: Dict[Tuple[str, str], int] = {}
        for a in list(store.allocs.values()):
            if not a.desired_transition.should_migrate():
                continue
            key = (a.namespace, a.job_id)
            if not a.terminal_status():
                counts[key] = counts.get(key, 0) + 1
                continue
            # Terminal original: does a live replacement exist and is it
            # healthy/running?
            replacement = None
            if a.next_allocation:
                replacement = store.allocs.get(a.next_allocation)
            if replacement is None or replacement.terminal_status():
                continue
            tg = (
                replacement.job.lookup_task_group(replacement.task_group)
                if replacement.job is not None
                else None
            )
            if tg is not None and tg.update is not None and tg.update.max_parallel:
                healthy = (
                    replacement.deployment_status is not None
                    and replacement.deployment_status.healthy is True
                )
            else:
                healthy = replacement.client_status == (
                    AllocClientStatus.RUNNING.value
                )
            if not healthy:
                counts[key] = counts.get(key, 0) + 1
        return counts
