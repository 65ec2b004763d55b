"""Allocation reconciler — diff (job spec, existing allocs, node taints) into
placement/stop/update sets.

Reference: scheduler/reconcile.go:39-983 + reconcile_util.go. This is
deliberately host Python: it is branchy, small-n (allocs of ONE job), and
runs once per eval — the per-node math it feeds lives in the kernels.

Covered here: terminal filtering by name (funcs.go:69-90), tainted-node
migration/lost handling, excess stop, in-place vs destructive updates with
rolling max_parallel pacing, failed-alloc rescheduling with
constant/exponential/fibonacci backoff and follow-up evals
(generic_sched.go:719-753), deployment creation/progress for jobs with an
update stanza, and canary placement/promotion bookkeeping.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..structs.types import (
    AllocClientStatus,
    AllocDesiredStatus,
    Allocation,
    Deployment,
    DeploymentState,
    DeploymentStatus,
    DeploymentStatusUpdate,
    DesiredTransition,
    EvalStatus,
    EvalTrigger,
    Evaluation,
    Job,
    JobType,
    Node,
    RescheduleEvent,
    RescheduleTracker,
    TaskGroup,
)

# Alloc stop descriptions (reference: scheduler/reconcile.go:26-37).
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"
ALLOC_LOST = "alloc is lost since its node is down"
ALLOC_IN_PLACE = "alloc updating in-place"
ALLOC_NODE_TAINTED = "alloc not needed as node is tainted"
ALLOC_RESCHEDULED = "alloc was rescheduled because it failed"


@dataclass
class PlaceRequest:
    name: str
    task_group: TaskGroup
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    canary: bool = False


@dataclass
class StopRequest:
    alloc: Allocation
    description: str
    client_status: str = ""


@dataclass
class UpdateRequest:
    alloc: Allocation
    new_job: Job


@dataclass
class TGReconcileResult:
    place: List[PlaceRequest] = field(default_factory=list)
    stop: List[StopRequest] = field(default_factory=list)
    inplace: List[UpdateRequest] = field(default_factory=list)
    destructive: List[UpdateRequest] = field(default_factory=list)
    ignore: int = 0
    placing_canaries: bool = False
    # desired annotation counts (reference: structs.DesiredUpdates)
    desired: Dict[str, int] = field(default_factory=dict)


@dataclass
class ReconcileResults:
    place: List[PlaceRequest] = field(default_factory=list)
    stop: List[StopRequest] = field(default_factory=list)
    inplace: List[UpdateRequest] = field(default_factory=list)
    destructive: List[UpdateRequest] = field(default_factory=list)
    # delayed-reschedule follow-up evals (eval_broker DelayHeap consumers)
    followup_evals: List[Evaluation] = field(default_factory=list)
    # metadata-only alloc updates stamping follow_up_eval_id onto failed
    # allocs awaiting a delayed reschedule (plan.alloc_updates)
    followup_updates: List[Allocation] = field(default_factory=list)
    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)
    desired_tg_updates: Dict[str, Dict[str, int]] = field(default_factory=dict)


def tasks_updated(a: TaskGroup, b: TaskGroup) -> bool:
    """Whether a TG change is destructive (reference: tasksUpdated,
    scheduler/util.go). Count changes alone are NOT destructive."""
    ax = dataclasses.asdict(a)
    bx = dataclasses.asdict(b)
    for k in ("count",):
        ax.pop(k, None)
        bx.pop(k, None)
    return ax != bx


# tasks_updated runs two deep dataclasses.asdict walks per version-mismatched
# alloc; under a rolling update every alloc of the job hits the same
# (old version, new version) pair.  A registered (job id, version) names an
# immutable definition in the store, so the verdict is cacheable by version
# pair.  Bounded FIFO so long-lived servers don't grow without limit.
_tasks_updated_cache: Dict[Tuple[str, int, int, str], bool] = {}
_TASKS_UPDATED_CACHE_MAX = 4096


def tasks_updated_memo(old_job: Job, new_job: Job, tg_name: str) -> bool:
    key = (old_job.id, old_job.version, new_job.version, tg_name)
    hit = _tasks_updated_cache.get(key)
    if hit is None:
        old_tg = old_job.lookup_task_group(tg_name)
        new_tg = new_job.lookup_task_group(tg_name)
        hit = (
            True
            if old_tg is None or new_tg is None
            else tasks_updated(old_tg, new_tg)
        )
        if len(_tasks_updated_cache) >= _TASKS_UPDATED_CACHE_MAX:
            _tasks_updated_cache.pop(next(iter(_tasks_updated_cache)))
        _tasks_updated_cache[key] = hit
    return hit


def reschedule_delay(policy, attempt: int) -> float:
    """Backoff for the next reschedule (generic_sched.go:719-753)."""
    base = policy.delay
    if policy.delay_function == "constant":
        d = base
    elif policy.delay_function == "exponential":
        d = base * (2 ** max(0, attempt))
    else:  # fibonacci
        x, y = base, base
        for _ in range(max(0, attempt)):
            x, y = y, x + y
        d = x
    if policy.max_delay > 0:
        d = min(d, policy.max_delay)
    return d


def should_reschedule(
    alloc: Allocation, policy, now: float
) -> Tuple[bool, float]:
    """(eligible, wait_seconds). wait == 0 → reschedule immediately; wait > 0
    → schedule a follow-up eval at now+wait. The backoff is anchored at the
    alloc's failure time (NextRescheduleTime semantics: eligible when
    fail_time + delay(attempt) has passed)."""
    if policy is None or (policy.attempts == 0 and not policy.unlimited):
        return False, 0.0
    events = (
        alloc.reschedule_tracker.events if alloc.reschedule_tracker else []
    )
    attempt = len(events)
    if not policy.unlimited:
        window_start = now - policy.interval
        recent = [e for e in events if e.reschedule_time >= window_start]
        if len(recent) >= policy.attempts:
            return False, 0.0
        attempt = len(recent)
    next_time = alloc.fail_time() + reschedule_delay(policy, attempt)
    return True, max(0.0, next_time - now)


class AllocReconciler:
    """Reference: NewAllocReconciler (reconcile.go:90)."""

    def __init__(
        self,
        job_id: str,
        job: Optional[Job],
        existing: List[Allocation],
        tainted: Dict[str, Optional[Node]],
        eval_id: str,
        deployment: Optional[Deployment] = None,
        now: Optional[float] = None,
        batch: bool = False,
        supports_disconnected_clients: bool = False,
    ):
        self.job_id = job_id
        self.job = job
        self.existing = existing
        self.tainted = tainted
        self.eval_id = eval_id
        self.deployment = deployment
        self.now = now if now is not None else time.time()
        self.batch = batch
        self.job_stopped = job is None or job.stopped()

    # ------------------------------------------------------------------

    def compute(self) -> ReconcileResults:
        res = ReconcileResults()

        if self.job_stopped:
            for alloc in self.existing:
                if not alloc.terminal_status():
                    res.stop.append(
                        StopRequest(alloc, ALLOC_NOT_NEEDED)
                    )
            if self.deployment is not None and self.deployment.active():
                res.deployment_updates.append(
                    DeploymentStatusUpdate(
                        deployment_id=self.deployment.id,
                        status=DeploymentStatus.CANCELLED.value,
                        status_description="Cancelled because job is stopped",
                    )
                )
            return res

        job = self.job
        assert job is not None

        by_tg: Dict[str, List[Allocation]] = {}
        for alloc in self.existing:
            by_tg.setdefault(alloc.task_group, []).append(alloc)

        # Cancel deployments for older job versions (reconcile.go
        # cancelDeployments).
        deployment = self.deployment
        if deployment is not None and deployment.active():
            if deployment.job_version != job.version:
                res.deployment_updates.append(
                    DeploymentStatusUpdate(
                        deployment_id=deployment.id,
                        status=DeploymentStatus.CANCELLED.value,
                        status_description=(
                            "Cancelled due to newer version of job"
                        ),
                    )
                )
                deployment = None

        creating_deployment = False
        dstates: Dict[str, DeploymentState] = {}

        # A failed deployment for the CURRENT version blocks further updates
        # until a new version arrives (reconcile.go deploymentFailed); only
        # an active same-version deployment continues to be driven.
        self._deployment = (
            deployment
            if deployment is not None and deployment.job_version == job.version
            else None
        )
        self._deployment_failed = (
            self._deployment is not None
            and self._deployment.status == DeploymentStatus.FAILED.value
        )
        self._deployment_paused = (
            self._deployment is not None
            and self._deployment.status == DeploymentStatus.PAUSED.value
        )

        for tg in job.task_groups:
            allocs = by_tg.pop(tg.name, [])
            tg_res = self._compute_group(tg, allocs, res)
            res.place.extend(tg_res.place)
            res.stop.extend(tg_res.stop)
            res.inplace.extend(tg_res.inplace)
            res.destructive.extend(tg_res.destructive)
            res.desired_tg_updates[tg.name] = tg_res.desired

            # Deployment bookkeeping: a service job with an update stanza
            # gets a deployment tracking each changed TG when no deployment
            # exists yet for this job version
            # (reconcile.go computeDeploymentUpdates).
            if (
                job.type == JobType.SERVICE.value
                and tg.update is not None
                and tg.update.max_parallel > 0
                and (tg_res.place or tg_res.destructive
                     or tg_res.placing_canaries)
                and self._deployment is None
                and not self._deployment_failed
            ):
                creating_deployment = True
                dstates[tg.name] = DeploymentState(
                    auto_revert=tg.update.auto_revert,
                    auto_promote=tg.update.auto_promote,
                    desired_total=tg.count,
                    desired_canaries=tg.update.canary,
                    progress_deadline=tg.update.progress_deadline,
                    require_progress_by=self.now + tg.update.progress_deadline,
                )

        # Allocs of task groups no longer in the job: stop.
        for allocs in by_tg.values():
            for alloc in allocs:
                if not alloc.terminal_status():
                    res.stop.append(StopRequest(alloc, ALLOC_NOT_NEEDED))

        if creating_deployment:
            res.deployment = Deployment(
                namespace=job.namespace,
                job_id=job.id,
                job_version=job.version,
                job_modify_index=job.modify_index,
                job_create_index=job.create_index,
                task_groups=dstates,
                status=DeploymentStatus.RUNNING.value,
                status_description="Deployment is running",
            )
        return res

    # ------------------------------------------------------------------

    def _compute_group(
        self, tg: TaskGroup, allocs: List[Allocation], res: ReconcileResults
    ) -> TGReconcileResult:
        out = TGReconcileResult()
        job = self.job
        assert job is not None
        desired: Dict[str, int] = {
            "place": 0,
            "stop": 0,
            "migrate": 0,
            "in_place_update": 0,
            "destructive_update": 0,
            "ignore": 0,
        }
        out.desired = desired

        # -- partition: live / failed-retryable / terminal-by-name
        # (funcs.go:69-90). Failed allocs still desired to run are NOT plain
        # terminal: they hold their name and go through reschedule policy
        # (reconcile_util.go filterByRescheduleable).
        live: List[Allocation] = []
        failed: List[Allocation] = []
        waiting: List[Allocation] = []  # pending delayed reschedule elsewhere
        terminal_by_name: Dict[str, Allocation] = {}
        n_allocs = len(allocs)
        if n_allocs:
            # Mask combination instead of per-alloc branch chains: one
            # attribute sweep per predicate, then boolean algebra.  On jobs
            # with hundreds of allocs this replaces the interpreted if/elif
            # ladder with four numpy ops.
            run_v = AllocDesiredStatus.RUN.value
            fail_v = AllocClientStatus.FAILED.value
            is_failed = np.fromiter(
                (
                    a.desired_status == run_v
                    and a.client_status == fail_v
                    and not a.next_allocation
                    for a in allocs
                ),
                bool,
                n_allocs,
            )
            is_terminal = np.fromiter(
                (a.terminal_status() for a in allocs), bool, n_allocs
            )
            for i in np.flatnonzero(is_failed):
                a = allocs[i]
                # A follow-up eval owns this alloc until it fires; only the
                # owning eval may reschedule it (updateByReschedulable).
                if a.follow_up_eval_id and a.follow_up_eval_id != self.eval_id:
                    waiting.append(a)
                else:
                    failed.append(a)
            for i in np.flatnonzero(~is_failed & is_terminal):
                a = allocs[i]
                prev = terminal_by_name.get(a.name)
                if prev is None or prev.create_index < a.create_index:
                    terminal_by_name[a.name] = a
            live = [allocs[i] for i in np.flatnonzero(~is_failed & ~is_terminal)]

        # -- tainted-node handling: migrate (drain, drainer-paced) or lost
        # (down/gone).  Draining nodes migrate ONLY the allocs the drainer
        # has stamped with a migrate DesiredTransition — that is how drain
        # pacing works (reconcile_util.go filterByTainted +
        # nomad/drainer/watch_jobs.go batches).
        untainted: List[Allocation] = []
        migrate: List[Allocation] = []
        lost: List[Allocation] = []
        if not self.tainted:
            # Steady-state fast path: no tainted nodes — only the migrate
            # transition can reroute an alloc, and the drainer stamps it
            # rarely.  One mask sweep, no per-alloc dict probes.
            if live:
                wants_migrate = np.fromiter(
                    (a.desired_transition.should_migrate() for a in live),
                    bool,
                    len(live),
                )
                if wants_migrate.any():
                    migrate = [live[i] for i in np.flatnonzero(wants_migrate)]
                    untainted = [
                        live[i] for i in np.flatnonzero(~wants_migrate)
                    ]
                else:
                    untainted = live
        else:
            for a in live:
                if a.node_id not in self.tainted:
                    # Drainer-forced migration arrives as a DesiredTransition
                    # (nomad/drainer/drainer.go:357).
                    if a.desired_transition.should_migrate():
                        migrate.append(a)
                    else:
                        untainted.append(a)
                    continue
                node = self.tainted[a.node_id]
                if node is not None and node.drain:
                    if a.desired_transition.should_migrate():
                        migrate.append(a)
                    else:
                        untainted.append(a)
                else:
                    lost.append(a)

        # -- canaries of the current deployment are handled out-of-band of
        # the name bookkeeping below (reconcile.go cancelUnneededCanaries /
        # computeCanaries): they shadow existing names until promotion.
        deployment = self._deployment
        dstate = (
            deployment.task_groups.get(tg.name)
            if deployment is not None
            else None
        )
        promoted = dstate.promoted if dstate is not None else False
        canaries: List[Allocation] = []
        if deployment is not None:
            canaries = [
                a for a in untainted
                if a.deployment_id == deployment.id
                and a.deployment_status is not None
                and a.deployment_status.canary
            ]
            canary_ids = {a.id for a in canaries}
            untainted = [a for a in untainted if a.id not in canary_ids]
        if self._deployment_failed and canaries:
            # Failed deployment: its canaries are torn down (the old
            # version keeps running; auto-revert is the watcher's job).
            for a in canaries:
                out.stop.append(StopRequest(a, ALLOC_NOT_NEEDED))
                desired_canary_stops = desired.get("stop", 0) + 1
                desired["stop"] = desired_canary_stops
            canaries = []
        if promoted and canaries:
            # Promoted canaries are ordinary new-version allocs; they win
            # the name slots, pushing same-name old allocs into excess.
            untainted = canaries + untainted
            canaries = []

        # -- failed allocs through reschedule policy: now / later / never
        reschedule_now: List[Allocation] = []
        reschedule_later: List[Tuple[Allocation, float]] = []
        failed_holding_name: List[Allocation] = list(waiting)
        policy = tg.reschedule_policy
        for a in failed:
            force = a.desired_transition.should_force_reschedule()
            ok, delay = should_reschedule(a, policy, self.now)
            if force or (ok and delay <= 0):
                reschedule_now.append(a)
            elif ok:
                reschedule_later.append((a, delay))
            else:
                # Not reschedulable: the failed alloc keeps its name slot and
                # is left in place (job shows as degraded).
                failed_holding_name.append(a)

        # -- batch jobs keep successfully-completed allocs completed: the
        # terminal map prevents re-placement of the same name.
        count = 0 if job.stopped() else tg.count

        # -- name bookkeeping
        def name_of(i: int) -> str:
            return f"{job.id}.{tg.name}[{i}]"

        # -- excess: stop highest-index names beyond count
        keep: List[Allocation] = []
        excess: List[Allocation] = []
        by_index = sorted(untainted, key=lambda a: a.index)
        seen_names: set = set()
        for a in by_index:
            if a.index < count and a.name not in seen_names:
                keep.append(a)
                seen_names.add(a.name)
            else:
                excess.append(a)
        for a in excess:
            out.stop.append(StopRequest(a, ALLOC_NOT_NEEDED))
            desired["stop"] += 1

        # -- updates: in-place vs destructive, paced by update.max_parallel
        inplace: List[Allocation] = []
        destructive: List[Allocation] = []
        for a in keep:
            if a.job is not None and a.job.version == job.version:
                out.ignore += 1
                desired["ignore"] += 1
                continue
            if a.job is not None and not tasks_updated_memo(a.job, job, tg.name):
                inplace.append(a)
            else:
                destructive.append(a)

        for a in inplace:
            out.inplace.append(UpdateRequest(a, job))
            desired["in_place_update"] += 1

        # -- canary gate: destructive changes behind a canary stanza place
        # canaries first and defer the rolling update until the deployment
        # watcher promotes (reconcile.go computeCanaries).
        requires_canaries = (
            tg.update is not None
            and tg.update.canary > 0
            and destructive
            and not promoted
        )
        if requires_canaries:
            if not (self._deployment_failed or self._deployment_paused):
                missing = tg.update.canary - len(canaries)
                for i in range(max(0, missing)):
                    out.place.append(
                        PlaceRequest(
                            name=name_of(i),
                            task_group=tg,
                            canary=True,
                        )
                    )
                    desired["canary"] = desired.get("canary", 0) + 1
                    out.placing_canaries = True
            for a in destructive:
                out.ignore += 1
                desired["ignore"] += 1
            destructive = []

        # -- rolling-update pacing: max_parallel minus in-flight placements
        # of the new version that have not yet reported healthy — the
        # health gate that makes batches wait (reconcile.go
        # computeDestructiveUpdates + deploymentwatcher next-batch evals).
        if tg.update is not None and tg.update.max_parallel > 0:
            in_flight_unhealthy = 0
            if deployment is not None:
                in_flight_unhealthy = sum(
                    1
                    for a in keep
                    if a.deployment_id == deployment.id
                    and (
                        a.deployment_status is None
                        or a.deployment_status.healthy is not True
                    )
                )
            limit = max(0, tg.update.max_parallel - in_flight_unhealthy)
        else:
            limit = len(destructive)
        if self._deployment_failed or self._deployment_paused:
            limit = 0
        for a in destructive[:limit]:
            out.destructive.append(UpdateRequest(a, job))
            desired["destructive_update"] += 1
        for a in destructive[limit:]:
            out.ignore += 1
            desired["ignore"] += 1

        # -- migrations: stop + place elsewhere
        for a in migrate:
            out.stop.append(StopRequest(a, ALLOC_MIGRATING))
            desired["migrate"] += 1
            if a.index < count:
                out.place.append(
                    PlaceRequest(
                        name=a.name,
                        task_group=tg,
                        previous_alloc=a,
                    )
                )

        # -- lost: mark lost + replace
        for a in lost:
            out.stop.append(
                StopRequest(
                    a, ALLOC_LOST, client_status=AllocClientStatus.LOST.value
                )
            )
            desired["stop"] += 1
            if a.index < count:
                out.place.append(
                    PlaceRequest(name=a.name, task_group=tg, previous_alloc=a)
                )

        # -- reschedule now: stop-and-replace with penalty on prior node
        for a in reschedule_now:
            out.place.append(
                PlaceRequest(
                    name=a.name,
                    task_group=tg,
                    previous_alloc=a,
                    reschedule=True,
                )
            )
            desired["place"] += 1

        # -- reschedule later: follow-up eval at now+delay
        #    (generic_sched.go createRescheduleLaterEvals)
        delays = sorted(set(d for _, d in reschedule_later))
        eval_by_delay: Dict[float, Evaluation] = {}
        for d in delays:
            ev = Evaluation(
                namespace=job.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by=EvalTrigger.RETRY_FAILED_ALLOC.value,
                job_id=job.id,
                status=EvalStatus.PENDING.value,
                wait_until=self.now + d,
            )
            eval_by_delay[d] = ev
            res.followup_evals.append(ev)
        for a, d in reschedule_later:
            upd = a.copy()
            upd.follow_up_eval_id = eval_by_delay[d].id
            res.followup_updates.append(upd)

        # -- place missing: every name index below count not already covered
        # by a kept alloc, an in-flight placement, a name-holding failed
        # alloc, a pending delayed reschedule, or (batch) a successful run.
        used_names = (
            {a.name for a in keep}
            | {p.name for p in out.place}
            | {a.name for a in failed_holding_name}
            | {a.name for a, _ in reschedule_later}
        )
        if self.batch:
            used_names |= {
                n for n, a in terminal_by_name.items() if a.ran_successfully()
            }
        for i in range(count):
            nm = name_of(i)
            if nm in used_names:
                continue
            prev = terminal_by_name.get(nm)
            out.place.append(
                PlaceRequest(name=nm, task_group=tg, previous_alloc=prev)
            )
            used_names.add(nm)
            desired["place"] += 1

        return out
