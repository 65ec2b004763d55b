"""Deployment watcher — the leader service driving rolling updates.

Reference: ``nomad/deploymentwatcher/deployments_watcher.go:120-348`` (the
Watcher tracking every active deployment) + per-deployment
``deployment_watcher.go``: consume alloc health transitions and

- create the **next-batch eval** when health progress frees rolling-update
  capacity (the reconciler's pacing gate is max_parallel minus in-flight
  unhealthy allocs, so each health report may unlock placements);
- **auto-promote** once every desired canary reports healthy;
- **fail** the deployment on an unhealthy alloc or a missed progress
  deadline, and **auto-revert** the job to its previous version when the
  update stanza asks for it;
- mark the deployment **successful** when every group reaches its desired
  count healthy (canary groups must be promoted first).

The watch loop is a blocking query on the alloc/deployment tables — the
same change feed the reference consumes through memdb watch sets.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ..structs.types import (
    DeploymentStatus,
    EvalStatus,
    EvalTrigger,
    Evaluation,
    Job,
)

log = logging.getLogger(__name__)

DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DESC_UNHEALTHY_ALLOCS = "Failed due to unhealthy allocations"
DESC_PROMOTED = "Deployment is running (promoted)"
DESC_SUCCESSFUL = "Deployment completed successfully"


class DeploymentWatcher:
    def __init__(self, server, poll_interval: float = 0.25):
        self.server = server
        self.poll_interval = poll_interval
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # deployment id -> healthy-alloc count at the last eval we created
        # (dedups next-batch evals per health transition).
        self._last_eval_health: Dict[str, int] = {}

    def start(self) -> None:
        self._shutdown.clear()
        self._thread = threading.Thread(
            target=self._run, name="deployment-watcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _run(self) -> None:
        store = self.server.store
        index = 0
        while not self._shutdown.is_set():
            # Wake on any alloc or deployment change (blocking query).
            idx_a = store.table_index("allocs")
            idx_d = store.table_index("deployment")
            cur = max(idx_a, idx_d)
            if cur <= index:
                store.wait_for_table("allocs", index, timeout=self.poll_interval)
            index = max(
                store.table_index("allocs"), store.table_index("deployment")
            )
            try:
                for dep in store.active_deployments():
                    self._check_deployment(dep)
            except Exception:  # noqa: BLE001
                log.exception("deployment watcher pass failed")
            self._shutdown.wait(self.poll_interval)

    # ------------------------------------------------------------------

    def _check_deployment(self, dep) -> None:
        store = self.server.store
        now = time.time()
        if dep.status == DeploymentStatus.PAUSED.value:
            # Operator paused (Deployment.Pause): no pacing evals, no
            # deadline enforcement until resumed.
            return
        allocs = [
            a for a in list(store.allocs.values())
            if a.deployment_id == dep.id
        ]
        job = store.job_by_id(dep.namespace, dep.job_id)
        if job is None or job.stopped():
            self.server.update_deployment_status(
                dep.id,
                DeploymentStatus.CANCELLED.value,
                "Cancelled because job is stopped",
            )
            return
        if job.version != dep.job_version:
            self.server.update_deployment_status(
                dep.id,
                DeploymentStatus.CANCELLED.value,
                "Cancelled due to newer version of job",
            )
            return

        # Unhealthy alloc → fail (+ auto-revert).
        unhealthy = [
            a for a in allocs
            if a.deployment_status is not None
            and a.deployment_status.healthy is False
        ]
        if unhealthy:
            self._fail(dep, job, DESC_UNHEALTHY_ALLOCS)
            return

        # Progress deadline.
        for state in dep.task_groups.values():
            if (
                state.require_progress_by
                and now > state.require_progress_by
                and state.healthy_allocs < state.desired_total
            ):
                self._fail(dep, job, DESC_PROGRESS_DEADLINE)
                return

        # Auto-promote: every desired canary healthy in every canary group.
        if dep.requires_promotion() and dep.has_auto_promote():
            if self._canaries_healthy(dep, allocs):
                self.server.promote_deployment(dep.id)
                return

        # Successful?  Every group: desired_total healthy (and promoted
        # where canaries are involved).
        done = all(
            s.healthy_allocs >= s.desired_total
            and (s.desired_canaries == 0 or s.promoted)
            for s in dep.task_groups.values()
        )
        if done and dep.task_groups:
            self.server.update_deployment_status(
                dep.id, DeploymentStatus.SUCCESSFUL.value, DESC_SUCCESSFUL
            )
            self._last_eval_health.pop(dep.id, None)
            return

        # Health progressed since the last eval we cut → next-batch eval
        # (deployment_watcher.go createBatchedUpdate).
        healthy_total = sum(
            s.healthy_allocs for s in dep.task_groups.values()
        )
        if healthy_total > self._last_eval_health.get(dep.id, -1):
            self._last_eval_health[dep.id] = healthy_total
            if healthy_total > 0:
                self._create_eval(dep, job)

    def _canaries_healthy(self, dep, allocs) -> bool:
        for state in dep.task_groups.values():
            if state.desired_canaries == 0 or state.promoted:
                continue
            healthy = 0
            placed = set(state.placed_canaries)
            for a in allocs:
                if (
                    a.id in placed
                    and a.deployment_status is not None
                    and a.deployment_status.healthy is True
                ):
                    healthy += 1
            if healthy < state.desired_canaries:
                return False
        return True

    def _create_eval(self, dep, job: Job) -> None:
        self.server.apply_eval_updates([
            Evaluation(
                namespace=dep.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by=EvalTrigger.DEPLOYMENT_WATCHER.value,
                job_id=dep.job_id,
                deployment_id=dep.id,
                status=EvalStatus.PENDING.value,
            )
        ])

    def _fail(self, dep, job: Job, desc: str) -> None:
        auto_revert = any(s.auto_revert for s in dep.task_groups.values())
        self.server.update_deployment_status(
            dep.id, DeploymentStatus.FAILED.value, desc
        )
        self._last_eval_health.pop(dep.id, None)
        if auto_revert:
            reverted = self.server.revert_job(
                dep.namespace, dep.job_id, to_version=None
            )
            if reverted is None:
                # No older version to revert to; cut an eval so the
                # reconciler tears down failed-deployment canaries.
                self._create_eval(dep, job)
        else:
            self._create_eval(dep, job)
