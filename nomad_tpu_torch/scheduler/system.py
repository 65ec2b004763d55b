"""System scheduler — one alloc per feasible node.

Reference: scheduler/system_sched.go:22-54 (+ diffSystemAllocs in util.go).
Feasibility for the whole cluster is one kernel call
(SystemStack.feasible_nodes); the per-node diff stays host-side.
"""

from __future__ import annotations

import time
from typing import Dict, List

from ..structs.types import (
    AllocClientStatus,
    AllocDesiredStatus,
    Allocation,
    AllocMetric,
    EvalStatus,
    Evaluation,
    Plan,
)
from .context import EvalContext
from .reconcile import ALLOC_NOT_NEEDED, ALLOC_UPDATING, tasks_updated
from .stack import SystemStack
from .util import tainted_nodes

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5


class SystemScheduler:
    def __init__(self, snapshot, planner, matrix=None):
        self.snapshot = snapshot
        self.planner = planner
        self.matrix = matrix if matrix is not None else snapshot.store.matrix
        self.queued_allocs: Dict[str, int] = {}
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}

    def process(self, eval: Evaluation) -> None:
        for _ in range(MAX_SYSTEM_SCHEDULE_ATTEMPTS):
            ok, retry = self._attempt(eval)
            if ok or not retry:
                break
            self.snapshot = self.planner.refresh_snapshot()
        self._finish_eval(eval)

    def _attempt(self, eval: Evaluation):
        snap = self.snapshot
        job = snap.job_by_id(eval.namespace, eval.job_id)
        self.queued_allocs = {}
        self.failed_tg_allocs = {}

        plan = Plan(
            eval_id=eval.id,
            priority=eval.priority,
            job=job,
            snapshot_index=snap.snapshot_index,
            eval_token=eval.leader_ack,
        )
        ctx = EvalContext(snap, plan)
        allocs = snap.allocs_by_job(eval.namespace, eval.job_id)
        tainted = tainted_nodes(snap, allocs)

        if job is None or job.stopped():
            for a in allocs:
                if not a.terminal_status():
                    plan.append_stopped_alloc(a, ALLOC_NOT_NEEDED)
            if not plan.is_no_op():
                self.planner.submit_plan(plan)
            return True, False

        stack = SystemStack(ctx, self.matrix)
        stack.set_job(job)
        # Allocs on tainted nodes are stopped below; only THEIR volume
        # claims may be looked through when re-placing (see set_replaced).
        stack.set_replaced({
            a.id for a in allocs
            if not a.terminal_status() and a.node_id in tainted
        })
        self._stack = stack  # eligibility telemetry for blocked-eval keying

        live_by_node_tg: Dict[tuple, List[Allocation]] = {}
        for a in allocs:
            if not a.terminal_status():
                live_by_node_tg.setdefault((a.node_id, a.task_group), []).append(a)

        for tg in job.task_groups:
            feasible, metric = stack.feasible_nodes(tg)
            feasible_set = set(feasible)

            # Feasible-but-exhausted nodes are reported as failures so the
            # shortfall is visible (placed + failed = eligible nodes) and a
            # blocked eval can retry when capacity frees (system_sched.go
            # failedTGAllocs + queuedAllocs accounting).
            if metric.nodes_exhausted > 0:
                m = metric.copy()
                m.coalesced_failures = metric.nodes_exhausted
                self.failed_tg_allocs[tg.name] = m
                self.queued_allocs[tg.name] = (
                    self.queued_allocs.get(tg.name, 0) + metric.nodes_exhausted
                )

            # Stop allocs on nodes no longer feasible / tainted.  Judge the
            # nodes by the live table the kernel's mask was just read from:
            # a node that went down after this eval's snapshot is
            # infeasible in the mask, and its alloc is lost, not "not
            # needed" (the JAX package classifies against the snapshot;
            # ROADMAP queue 3, R5).
            tainted = tainted_nodes(snap.store, allocs)
            for (node_id, tg_name), node_allocs in list(live_by_node_tg.items()):
                if tg_name != tg.name:
                    continue
                node = tainted.get(node_id)
                lost = node_id in tainted and (node is None or not node.drain)
                if node_id not in feasible_set or node_id in tainted:
                    for a in node_allocs:
                        plan.append_stopped_alloc(
                            a,
                            ALLOC_NOT_NEEDED,
                            client_status=(
                                AllocClientStatus.LOST.value if lost else ""
                            ),
                        )
                    del live_by_node_tg[(node_id, tg_name)]

            # Place/refresh one alloc per feasible node.
            for node_id in feasible:
                existing = live_by_node_tg.get((node_id, tg.name), [])
                if existing:
                    a = existing[0]
                    if a.job is not None and a.job.version == job.version:
                        continue
                    old_tg = a.job.lookup_task_group(tg.name) if a.job else None
                    if old_tg is not None and not tasks_updated(old_tg, tg):
                        new = a.copy()
                        new.job = job
                        plan.append_alloc(new)
                        continue
                    plan.append_stopped_alloc(a, ALLOC_UPDATING)
                node = snap.node_by_id(node_id)
                if node is None:
                    continue
                ports = stack._assign_ports(node, tg)
                if ports is None:
                    # Port shortfall is a failed placement too: it must
                    # reach failed_tg_allocs so a blocked eval parks and
                    # retries when the conflicting alloc frees the port.
                    self.queued_allocs[tg.name] = (
                        self.queued_allocs.get(tg.name, 0) + 1
                    )
                    m = self.failed_tg_allocs.get(tg.name)
                    if m is None:
                        m = metric.copy()
                        self.failed_tg_allocs[tg.name] = m
                    m.coalesced_failures += 1
                    continue
                alloc = Allocation(
                    namespace=job.namespace,
                    eval_id=eval.id,
                    name=f"{job.id}.{tg.name}[0]",
                    node_id=node_id,
                    node_name=node.name,
                    job_id=job.id,
                    job=job,
                    task_group=tg.name,
                    resources=tg.combined_resources(),
                    desired_status=AllocDesiredStatus.RUN.value,
                    client_status=AllocClientStatus.PENDING.value,
                    metrics=metric.copy(),
                    assigned_ports=ports,
                    create_time=time.time(),
                )
                plan.append_alloc(alloc)

        # Allocs of task groups removed from the job: stop (the generic
        # path's by_tg.pop leftover loop; reconcile.py).
        tg_names = {tg.name for tg in job.task_groups}
        for (node_id, tg_name), node_allocs in live_by_node_tg.items():
            if tg_name not in tg_names:
                for a in node_allocs:
                    plan.append_stopped_alloc(a, ALLOC_NOT_NEEDED)

        if plan.is_no_op():
            return True, False
        result, new_snapshot = self.planner.submit_plan(plan)
        if result is None:
            return False, True
        full, _, _ = result.full_commit(plan)
        if not full:
            if new_snapshot is not None:
                self.snapshot = new_snapshot
            return False, True
        return True, False

    def _finish_eval(self, eval: Evaluation) -> None:
        updated = eval.copy()
        updated.status = EvalStatus.COMPLETE.value
        updated.queued_allocations = dict(self.queued_allocs)
        updated.failed_tg_allocs = dict(self.failed_tg_allocs)

        # Exhausted/failed nodes park a blocked eval so the system job
        # retries when capacity frees (system_sched.go:142-152; unblocked
        # via BlockedEvals.unblock_node / class capacity events).
        if self.failed_tg_allocs:
            stack = getattr(self, "_stack", None)
            blocked = Evaluation(
                namespace=eval.namespace,
                priority=eval.priority,
                type=eval.type,
                triggered_by="queued-allocs",
                job_id=eval.job_id,
                status=EvalStatus.BLOCKED.value,
                status_description="created to place remaining system allocs",
                previous_eval=eval.id,
                snapshot_index=self.snapshot.snapshot_index,
                class_eligibility=(
                    dict(stack.class_eligibility) if stack else {}
                ),
                escaped_computed_class=(
                    stack.escaped_computed_class if stack else True
                ),
            )
            updated.blocked_eval = blocked.id
            self.planner.create_evals([blocked])
        self.planner.update_eval(updated)
