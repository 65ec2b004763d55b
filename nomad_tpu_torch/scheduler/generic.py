"""Generic (service/batch) scheduler.

Reference: scheduler/generic_sched.go:125-328 — the retry loop around
(snapshot → reconcile → compute placements → submit plan), with blocked-eval
creation on placement failure (:193-212), partial-commit retry on a stale
snapshot, and follow-up evals for delayed reschedules.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..structs.types import (
    AllocClientStatus,
    AllocDeploymentStatus,
    AllocDesiredStatus,
    Allocation,
    AllocMetric,
    EvalStatus,
    EvalTrigger,
    Evaluation,
    Job,
    JobType,
    Plan,
    RescheduleEvent,
    RescheduleTracker,
    Resources,
)
from .context import EvalContext
from .preemption import select_victims
from .reconcile import (
    ALLOC_RESCHEDULED,
    ALLOC_UPDATING,
    AllocReconciler,
    PlaceRequest,
)
from .stack import GenericStack
from .util import tainted_nodes

# Retry bounds (reference: generic_sched.go:15-22).
MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

BLOCKED_EVAL_MAX_PLAN_DESC = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENTS = "created to place remaining allocations"


class SchedulerError(Exception):
    pass


class GenericScheduler:
    """One eval → one (or a few, on retry) plan submissions."""

    def __init__(self, sched_type: str, snapshot, planner, matrix=None):
        self.sched_type = sched_type
        self.batch = sched_type == JobType.BATCH.value
        self.snapshot = snapshot
        self.planner = planner
        self.matrix = matrix if matrix is not None else snapshot.store.matrix
        self.limit = (
            MAX_BATCH_SCHEDULE_ATTEMPTS
            if self.batch
            else MAX_SERVICE_SCHEDULE_ATTEMPTS
        )
        self.queued_allocs: Dict[str, int] = {}
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        self.blocked: Optional[Evaluation] = None

    # ------------------------------------------------------------------

    def process(self, eval: Evaluation) -> None:
        ok = False
        for attempt in range(self.limit):
            ok, retry = self._attempt(eval)
            if ok or not retry:
                break
            # stale snapshot: refresh and try again (worker re-snapshot,
            # generic_sched.go:161-173)
            self.snapshot = self.planner.refresh_snapshot()
        if not ok and not self._no_work:
            self._fail_eval(eval, "maximum attempts reached")
            return
        self._finish_eval(eval)

    # ------------------------------------------------------------------

    _no_work = False

    def _attempt(self, eval: Evaluation):
        """Returns (success, retry)."""
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
        deployment = snap.latest_deployment_by_job(eval.namespace, eval.job_id)

        reconciler = AllocReconciler(
            job_id=eval.job_id,
            job=job,
            existing=allocs,
            tainted=tainted,
            eval_id=eval.id,
            deployment=deployment,
            batch=self.batch,
        )
        results = reconciler.compute()
        # Annotations for `job plan` dry runs (scheduler/annotate.go:1-201
        # via structs.DesiredUpdates).
        self.last_desired_updates = dict(results.desired_tg_updates)
        # Placements made while an active same-version deployment is being
        # driven (next batches, canaries) attach to it (generic_sched.go
        # computePlacements deploymentID stamping).
        self._active_deployment = (
            deployment
            if deployment is not None
            and job is not None
            and deployment.job_version == job.version
            and deployment.active()
            else None
        )

        # Follow-up evals must exist before allocs reference them
        # (generic_sched.go createRescheduleLaterEvals ordering).
        if results.followup_evals:
            self.planner.create_evals(results.followup_evals)

        # Stops, delayed-reschedule stamps, and in-place updates.
        for stop in results.stop:
            plan.append_stopped_alloc(
                stop.alloc, stop.description, client_status=stop.client_status
            )
        plan.alloc_updates.extend(results.followup_updates)
        for upd in results.inplace:
            new = upd.alloc.copy()
            new.job = upd.new_job
            plan.append_alloc(new)
        for upd in results.destructive:
            plan.append_stopped_alloc(upd.alloc, ALLOC_UPDATING)
            results.place.append(
                PlaceRequest(
                    name=upd.alloc.name,
                    task_group=upd.new_job.lookup_task_group(
                        upd.alloc.task_group
                    ),
                    previous_alloc=upd.alloc,
                )
            )

        plan.deployment = results.deployment
        plan.deployment_updates = results.deployment_updates

        # Placements through the TPU stack.
        if job is not None and results.place:
            self._compute_placements(ctx, job, eval, results.place)

        if plan.is_no_op() and not self.failed_tg_allocs:
            self._no_work = True
            return True, False
        self._no_work = False

        result, new_snapshot = self.planner.submit_plan(plan)
        if result is None:
            return False, True

        # Update queued counts by what actually committed.
        full, expected, actual = result.full_commit(plan)
        if not full:
            # partial commit: retry against the refresh index snapshot
            if new_snapshot is not None:
                self.snapshot = new_snapshot
            return False, True
        return True, False

    # ------------------------------------------------------------------

    def _compute_placements(
        self,
        ctx: EvalContext,
        job: Job,
        eval: Evaluation,
        places: List[PlaceRequest],
    ) -> None:
        cfg = ctx.snapshot.scheduler_config()
        preemption_on = (
            cfg.preemption_config.batch_scheduler_enabled
            if self.batch
            else cfg.preemption_config.service_scheduler_enabled
        )
        stack = GenericStack(
            ctx,
            self.matrix,
            algorithm=cfg.scheduler_algorithm,
            preemption_enabled=preemption_on,
            batch=self.batch,
        )
        stack.set_job(job)
        replaced = {
            p.previous_alloc.id for p in places
            if p.previous_alloc is not None
        }
        for stops in ctx.plan.node_update.values():
            replaced.update(s.id for s in stops)
        stack.set_replaced(replaced)
        self._stack = stack

        # Group placement asks: requests with penalty nodes (reschedules)
        # place one-by-one; the rest batch through one kernel scan.
        by_tg: Dict[str, List[PlaceRequest]] = {}
        for p in places:
            if p.task_group is None:
                continue
            by_tg.setdefault(p.task_group.name, []).append(p)

        for tg_name, reqs in by_tg.items():
            tg = reqs[0].task_group
            sticky = (
                tg.ephemeral_disk.sticky if tg.ephemeral_disk else False
            )
            plain, penalized, preferred = [], [], []
            for p in reqs:
                if _penalty_nodes(p):
                    penalized.append(p)
                elif sticky and p.previous_alloc is not None:
                    preferred.append(p)
                else:
                    plain.append(p)

            if plain:
                options = stack.select(tg, n_placements=len(plain))
                for p, opt in zip(plain, options):
                    self._handle_option(ctx, job, eval, p, opt, tg)
            for p in preferred:
                # Sticky ephemeral disk: try the previous alloc's node
                # FIRST so local data survives the replacement; fall back
                # to a normal placement (findPreferredNode,
                # generic_sched.go:756-770).
                opts = stack.select(
                    tg, n_placements=1,
                    restrict_nodes=[p.previous_alloc.node_id],
                )
                if opts[0] is None:
                    opts = stack.select(tg, n_placements=1)
                self._handle_option(ctx, job, eval, p, opts[0], tg)
            for p in penalized:
                opts = stack.select(
                    tg, n_placements=1, penalty_nodes=_penalty_nodes(p)
                )
                self._handle_option(ctx, job, eval, p, opts[0], tg)

    def _handle_option(self, ctx, job, eval, place: PlaceRequest, opt, tg):
        if opt is None:
            # failed placement → blocked-eval accounting
            # (generic_sched.go:193-212)
            self.queued_allocs[tg.name] = self.queued_allocs.get(tg.name, 0) + 1
            metric = self.failed_tg_allocs.setdefault(tg.name, AllocMetric())
            metric.coalesced_failures += 1
            return

        resources = tg.combined_resources()
        alloc = Allocation(
            namespace=job.namespace,
            eval_id=eval.id,
            name=place.name,
            node_id=opt.node_id,
            node_name=opt.node.name,
            job_id=job.id,
            job=job,
            task_group=tg.name,
            resources=resources,
            desired_status=AllocDesiredStatus.RUN.value,
            client_status=AllocClientStatus.PENDING.value,
            metrics=opt.metric,
            assigned_ports=opt.assigned_ports,
            create_time=time.time(),
        )
        prev = place.previous_alloc
        if prev is not None:
            alloc.previous_allocation = prev.id
            if place.reschedule:
                tracker = (
                    prev.reschedule_tracker.events[:]
                    if prev.reschedule_tracker
                    else []
                )
                tracker.append(
                    RescheduleEvent(
                        reschedule_time=time.time(),
                        prev_alloc_id=prev.id,
                        prev_node_id=prev.node_id,
                    )
                )
                alloc.reschedule_tracker = RescheduleTracker(events=tracker)
                alloc.desired_description = ALLOC_RESCHEDULED
        deploy = ctx.plan.deployment or getattr(
            self, "_active_deployment", None
        )
        if deploy is not None:
            alloc.deployment_id = deploy.id
        if place.canary:
            alloc.deployment_status = AllocDeploymentStatus(canary=True)

        if opt.needs_preempt:
            node = opt.node
            proposed = ctx.proposed_allocs(node.id)
            avail = node.comparable_resources()
            used = Resources(cpu=0, memory_mb=0, disk_mb=0)
            for a in proposed:
                used.add(a.resources)
            remaining = Resources(
                cpu=avail.cpu - used.cpu,
                memory_mb=avail.memory_mb - used.memory_mb,
                disk_mb=avail.disk_mb - used.disk_mb,
            )
            victims = select_victims(job, node, proposed, resources, remaining)
            if victims is None:
                self.queued_allocs[tg.name] = (
                    self.queued_allocs.get(tg.name, 0) + 1
                )
                self.failed_tg_allocs.setdefault(tg.name, AllocMetric())
                return
            for v in victims:
                ctx.plan.append_preempted_alloc(v, alloc.id)

        ctx.plan.append_alloc(alloc)

    # ------------------------------------------------------------------

    def _finish_eval(self, eval: Evaluation) -> None:
        updated = eval.copy()
        updated.status = EvalStatus.COMPLETE.value
        updated.queued_allocations = dict(self.queued_allocs)
        updated.failed_tg_allocs = dict(self.failed_tg_allocs)

        # Blocked eval for failed placements (generic_sched.go:193-212).
        if self.failed_tg_allocs and eval.triggered_by != (
            EvalTrigger.MAX_PLAN_ATTEMPTS.value
        ):
            stack = getattr(self, "_stack", None)
            blocked = Evaluation(
                namespace=eval.namespace,
                priority=eval.priority,
                type=eval.type,
                triggered_by=EvalTrigger.QUEUED_ALLOCS.value,
                job_id=eval.job_id,
                status=EvalStatus.BLOCKED.value,
                status_description=BLOCKED_EVAL_FAILED_PLACEMENTS,
                previous_eval=eval.id,
                # Unblock keying (blocked_evals.go): which classes we saw
                # (in)eligible at this snapshot, and whether class caching
                # escaped to per-node checks.
                snapshot_index=self.snapshot.snapshot_index,
                class_eligibility=dict(stack.class_eligibility) if stack else {},
                escaped_computed_class=(
                    stack.escaped_computed_class if stack else True
                ),
            )
            updated.blocked_eval = blocked.id
            self.planner.create_evals([blocked])
        self.planner.update_eval(updated)

    def _fail_eval(self, eval: Evaluation, reason: str) -> None:
        updated = eval.copy()
        updated.status = EvalStatus.FAILED.value
        updated.status_description = reason
        self.planner.update_eval(updated)


def _penalty_nodes(place: PlaceRequest) -> List[str]:
    """Previous node ids penalized for a rescheduled placement
    (SelectOptions.PenaltyNodeIDs, generic_sched.go:694-716)."""
    if not place.reschedule or place.previous_alloc is None:
        return []
    prev = place.previous_alloc
    nodes = [prev.node_id]
    if prev.reschedule_tracker:
        nodes.extend(e.prev_node_id for e in prev.reschedule_tracker.events)
    return [n for n in dict.fromkeys(nodes) if n]
