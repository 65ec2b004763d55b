"""CoreScheduler — internal ``_core`` evals implementing garbage collection.

Reference: ``nomad/core_sched.go`` (``CoreScheduler.Process`` :44-67):
``_core`` evaluations are ordinary broker work items whose ``job_id``
selects the GC routine (eval-gc, job-gc, deployment-gc, node-gc, or the
force variants that ignore thresholds).  The reference converts GC
thresholds from raft indexes to wall-time with its ``timetable``; here
every object carries wall-clock timestamps/indexes directly, so the
thresholds are plain ages.

Deletions flow through the server's GC apply methods
(``Server.apply_gc``), like every other mutation.  A node GC frees the
node's matrix row; a later registration reuses it and marks it dirty, so
the card-resident copy uploads it before the next dispatch
(``NodeMatrix.sync``).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from ..structs.types import EvalStatus, Evaluation, JobType

log = logging.getLogger(__name__)

# Job ids for core evals (core_sched.go job names).
CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_FORCE_GC = "force-gc"

# Default thresholds (reference config defaults: EvalGCThreshold 1h,
# JobGCThreshold 4h, DeploymentGCThreshold 1h, NodeGCThreshold 24h).
EVAL_GC_THRESHOLD = 3600.0
JOB_GC_THRESHOLD = 4 * 3600.0
DEPLOYMENT_GC_THRESHOLD = 3600.0
NODE_GC_THRESHOLD = 24 * 3600.0


class CoreScheduler:
    """Processes ``_core`` evals (scheduler type ``_core``)."""

    def __init__(self, snapshot, planner, matrix=None):
        self.snapshot = snapshot
        self.planner = planner
        self.server = planner.server  # GC mutates through server applies

    # ------------------------------------------------------------------

    def process(self, ev: Evaluation) -> None:
        force = ev.job_id == CORE_JOB_FORCE_GC
        kind = ev.job_id
        # Job GC must precede eval GC in a forced sweep: eval GC deletes a
        # dead batch job's terminal evals+allocs, after which the job no
        # longer looks dead (batch-dead = "has allocs, all terminal") and
        # would survive every force-gc (the reference's forceGC runs jobGC
        # first for the same reason, core_sched.go).
        if force or kind == CORE_JOB_JOB_GC:
            self._job_gc(force)
        if force or kind == CORE_JOB_EVAL_GC:
            self._eval_gc(force)
        if force or kind == CORE_JOB_DEPLOYMENT_GC:
            self._deployment_gc(force)
        if force or kind == CORE_JOB_NODE_GC:
            self._node_gc(force)
        done = ev.copy()
        done.status = EvalStatus.COMPLETE.value
        self.planner.update_eval(done)

    # ------------------------------------------------------------------

    def _cutoff(self, threshold: float, force: bool) -> float:
        return time.time() if force else time.time() - threshold

    def _eval_gc(self, force: bool) -> None:
        """Terminal evals (and their terminal allocs) past the threshold
        (core_sched.go evalGC + gcEval)."""
        store = self.server.store
        cutoff = self._cutoff(EVAL_GC_THRESHOLD, force)
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for ev in list(store.evals.values()):
            if not ev.terminal_status():
                continue
            if ev.create_time and ev.create_time > cutoff:
                continue
            allocs = store.allocs_by_eval(ev.id)
            # A batch job's evals/allocs are retained until the job is
            # GC'd (core_sched.go:139 batch carve-out).
            job = store.job_by_id(ev.namespace, ev.job_id)
            if (
                job is not None
                and job.type == JobType.BATCH.value
                and not job.stopped()
                and not force
            ):
                continue
            if any(not a.terminal_status() for a in allocs):
                continue
            gc_evals.append(ev.id)
            gc_allocs.extend(a.id for a in allocs)
        if gc_evals or gc_allocs:
            self.server.apply_gc(evals=gc_evals, allocs=gc_allocs)
            log.info("eval GC reaped %d evals / %d allocs",
                     len(gc_evals), len(gc_allocs))

    def _job_gc(self, force: bool) -> None:
        """Dead/stopped jobs with only terminal evals+allocs
        (core_sched.go jobGC)."""
        store = self.server.store
        cutoff = self._cutoff(JOB_GC_THRESHOLD, force)
        gc_jobs = []
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for (ns, jid), job in list(store.jobs.items()):
            if job.is_periodic() and not job.stopped():
                continue
            if not (job.stopped() or self._job_dead(ns, jid, job)):
                continue
            if job.submit_time and job.submit_time > cutoff:
                continue
            evals = store.evals_by_job(ns, jid)
            allocs = store.allocs_by_job(ns, jid)
            if any(not e.terminal_status() for e in evals):
                continue
            if any(not a.terminal_status() for a in allocs):
                continue
            gc_jobs.append((ns, jid))
            gc_evals.extend(e.id for e in evals)
            gc_allocs.extend(a.id for a in allocs)
        if gc_jobs:
            self.server.apply_gc(
                jobs=gc_jobs, evals=gc_evals, allocs=gc_allocs
            )
            log.info("job GC reaped %d jobs", len(gc_jobs))

    def _job_dead(self, ns: str, jid: str, job) -> bool:
        if job.type == JobType.BATCH.value:
            allocs = self.server.store.allocs_by_job(ns, jid)
            return bool(allocs) and all(a.terminal_status() for a in allocs)
        return False

    def _deployment_gc(self, force: bool) -> None:
        store = self.server.store
        cutoff = self._cutoff(DEPLOYMENT_GC_THRESHOLD, force)
        gc = []
        for dep in list(store.deployments.values()):
            if dep.active():
                continue
            job = store.job_by_id(dep.namespace, dep.job_id)
            if (
                job is not None
                and not force
                and job.submit_time
                and job.submit_time > cutoff
            ):
                continue
            gc.append(dep.id)
        if gc:
            self.server.apply_gc(deployments=gc)
            log.info("deployment GC reaped %d deployments", len(gc))

    def _node_gc(self, force: bool) -> None:
        """Down nodes with no allocations (core_sched.go nodeGC)."""
        store = self.server.store
        cutoff = self._cutoff(NODE_GC_THRESHOLD, force)
        gc = []
        for node in list(store.nodes.values()):
            if not node.terminal():
                continue
            if not force and node.status_updated_at > cutoff:
                continue
            if store.allocs_by_node(node.id):
                continue
            gc.append(node.id)
        if gc:
            self.server.apply_gc(nodes=gc)
            log.info("node GC reaped %d nodes", len(gc))
