"""The server — single-process control plane wiring, trimmed to the
scheduling path.

Reference: ``nomad/server.go`` (Server struct :95-257).  Wired here: the
state store and the card-resident node matrix, the dispatch coalescer,
the eval broker, blocked evals with the periodic retry of those blocked
after placement conflicts, the plan queue with its serialized applier, N
scheduling workers, the heartbeat TTL wheel and the node drainer, and the
node RPCs that feed them.  Every mutation funnels
through the ``apply_*`` methods with a monotonically assigned index.

The deployment watcher, the periodic dispatcher, the load gate, overload
control, SLOs, replication, ACLs, the failed-eval reaper and volume
watcher, the core (GC) scheduler and the HTTP API are not part of this
package yet.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..device import resolve_device
from ..state.matrix import NodeMatrix, computed_class_key, node_attributes
from ..state.store import StateStore
from ..structs.types import (
    AllocClientStatus,
    Allocation,
    DesiredTransition,
    EvalStatus,
    EvalTrigger,
    Evaluation,
    Job,
    JobStatus,
    JobType,
    Node,
    NodeStatus,
    SchedulerConfiguration,
)
from .admission import admit
from .blocked_evals import BlockedEvals
from .drainer import NodeDrainer
from .eval_broker import EvalBroker
from .heartbeat import HeartbeatManager
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .worker import Worker

log = logging.getLogger(__name__)


@dataclass
class ServerConfig:
    num_workers: int = 2
    eval_nack_timeout: float = 120.0
    eval_delivery_limit: int = 3
    heartbeat_min_ttl: float = 10.0
    heartbeat_max_ttl: float = 20.0
    # Seed of the heartbeat TTL jitter (server/heartbeat.py).
    heartbeat_seed: int = 0
    node_capacity: int = 1024
    # Max selects batched into one device dispatch (scheduler/coalescer.py).
    coalescer_lanes: int = 64
    # Overlapping dispatches the coalescer keeps in flight.  None = env
    # NOMAD_TPU_PIPELINE_DEPTH, default 8.
    pipeline_depth: Optional[int] = None
    # Seconds between retries of the evals blocked after placement
    # conflicts (leader.go failedEvalUnblockInterval).
    failed_eval_unblock_interval: float = 60.0
    scheduler_config: SchedulerConfiguration = field(
        default_factory=SchedulerConfiguration
    )


class Server:
    """The scheduling path's control plane.  ``device`` is where the node
    matrix lives and the kernels run: ``"cuda"`` (the default) needs a
    card and raises without one; ``"cpu"`` runs the plain PyTorch
    versions."""

    def __init__(self, config: Optional[ServerConfig] = None, device="cuda"):
        self.config = config or ServerConfig()
        self.device = resolve_device(device)
        from ..metrics import MetricsRegistry

        self.metrics = MetricsRegistry()
        self.matrix = NodeMatrix(
            capacity=self.config.node_capacity, device=self.device
        )
        self.store = StateStore(matrix=self.matrix)
        self.store.scheduler_config = self.config.scheduler_config
        self.eval_broker = EvalBroker(
            nack_timeout=self.config.eval_nack_timeout,
            delivery_limit=self.config.eval_delivery_limit,
            metrics=self.metrics,
        )
        self.blocked_evals = BlockedEvals(self.eval_broker.enqueue)
        self.plan_queue = PlanQueue()
        self.plan_applier = PlanApplier(self)
        self.workers: List[Worker] = [
            Worker(self) for _ in range(self.config.num_workers)
        ]
        self.heartbeater = HeartbeatManager(
            self._on_heartbeat_expired,
            random.Random(self.config.heartbeat_seed),
            min_ttl=self.config.heartbeat_min_ttl,
            max_ttl=self.config.heartbeat_max_ttl,
        )
        self.drainer = NodeDrainer(self)
        # The matrix's single dispatch port: concurrent selects coalesce
        # into batched kernel launches (scheduler/coalescer.py).
        from ..scheduler.coalescer import DeviceCoalescer

        self.coalescer = DeviceCoalescer(
            self.matrix, max_lanes=self.config.coalescer_lanes,
            pipeline_depth=self.config.pipeline_depth,
            metrics=self.metrics, device=self.device,
        )
        self.matrix.coalescer = self.coalescer

        self._index_lock = threading.Lock()
        self._index = 0
        self._leader = False
        self._unblock_stop = threading.Event()
        self._unblocker: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    def next_index(self) -> int:
        with self._index_lock:
            self._index = max(self._index, self.store.latest_index) + 1
            return self._index

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Enable the scheduling services (establishLeadership,
        leader.go:222, the subset this package has; a single server is
        always the leader)."""
        if self._leader:
            return
        self._leader = True
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.plan_queue.set_enabled(True)
        self.heartbeater.set_enabled(True)
        self.coalescer.start()
        self.plan_applier.start()
        for w in self.workers:
            w.start()
        for ev in list(self.store.evals.values()):
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)
        # Arm TTL timers for nodes already in state — a node that died while
        # no leader was watching must still expire (initializeHeartbeatTimers,
        # nomad/heartbeat.go:21).
        for node in list(self.store.nodes.values()):
            if node.status != NodeStatus.DOWN.value:
                self.heartbeater.reset_heartbeat(node.id)
        self.drainer.start()
        self._unblock_stop.clear()
        self._unblocker = threading.Thread(
            target=self._periodic_unblock_failed, name="unblock-failed",
            daemon=True,
        )
        self._unblocker.start()

    def _periodic_unblock_failed(self) -> None:
        """Retry the evals blocked after placement conflicts
        (leader.go periodicUnblockFailedEvals)."""
        while not self._unblock_stop.wait(
            self.config.failed_eval_unblock_interval
        ):
            self.blocked_evals.unblock_failed()

    def shutdown(self) -> None:
        self._leader = False
        self._unblock_stop.set()
        if self._unblocker is not None:
            self._unblocker.join()
        self.drainer.stop()
        for w in self.workers:
            w.stop()
        self.plan_applier.stop()
        self.coalescer.stop()
        self.eval_broker.shutdown()
        self.plan_queue.shutdown()
        self.heartbeater.set_enabled(False)

    # ------------------------------------------------------------------
    # Job RPCs (nomad/job_endpoint.go:80 Register, :797 Deregister)
    # ------------------------------------------------------------------

    def submit_job(self, job: Job) -> Optional[Evaluation]:
        # Admission pipeline (job_endpoint_hooks.go): mutate
        # (canonicalize), then validate — rejects before anything lands.
        admit(job)
        index = self.next_index()
        job.submit_time = time.time()
        job.status = JobStatus.PENDING.value
        self.store.upsert_job(index, job)
        if job.is_periodic() or job.is_parameterized():
            # Children are dispatched later (job_endpoint.go:245-260); the
            # periodic dispatcher is not part of this package yet.
            return None
        ev = Evaluation(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EvalTrigger.JOB_REGISTER.value,
            job_id=job.id,
            job_modify_index=index,
            status=EvalStatus.PENDING.value,
        )
        self.apply_eval_updates([ev])
        return ev

    def deregister_job(
        self, namespace: str, job_id: str, purge: bool = False
    ) -> Optional[Evaluation]:
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            return None
        index = self.next_index()
        if purge:
            self.store.delete_job(index, namespace, job_id)
        else:
            stopped = job.copy()
            stopped.stop = True
            self.store.upsert_job(index, stopped)
        self.blocked_evals.untrack(namespace, job_id)
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EvalTrigger.JOB_DEREGISTER.value,
            job_id=job_id,
            status=EvalStatus.PENDING.value,
        )
        self.apply_eval_updates([ev])
        return ev

    # ------------------------------------------------------------------
    # Eval apply (fsm.go applyUpdateEval → broker/blocked routing)
    # ------------------------------------------------------------------

    def apply_eval_updates(self, evals: List[Evaluation]) -> int:
        index = self.next_index()
        for ev in evals:
            if not ev.create_time:
                ev.create_time = time.time()
        self.store.upsert_evals(index, evals)
        for ev in evals:
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)
        self._cancel_duplicate_blocked()
        return index

    def _cancel_duplicate_blocked(self) -> None:
        """Cancel the blocked evals that a newer blocked eval of the same
        job replaced (reapDupBlockedEvaluations, leader.go:593).  The JAX
        package does this from a reaper thread every 0.5 s; here it runs
        as soon as the newer eval blocks, with the same end state."""
        dups = self.blocked_evals.duplicates()
        if not dups:
            return
        cancelled = []
        for dup in dups:
            ev = dup.copy()
            ev.status = EvalStatus.CANCELLED.value
            cancelled.append(ev)
        self.store.upsert_evals(self.next_index(), cancelled)

    # ------------------------------------------------------------------
    # Node RPCs (nomad/node_endpoint.go:80 Register, :375 UpdateStatus,
    # :511 UpdateDrain, :1054 UpdateAlloc)
    # ------------------------------------------------------------------

    def register_node(self, node: Node) -> float:
        prev = self.store.node_by_id(node.id)
        index = self.next_index()
        self.store.upsert_node(index, node)
        ttl = self.heartbeater.reset_heartbeat(node.id)
        new_capacity = prev is None or prev.terminal() or not prev.ready()
        if new_capacity and node.ready():
            self._capacity_added(node, index)
            self._create_node_evals(node, index, system_only=True)
        return ttl

    def heartbeat_node(self, node_id: str) -> float:
        node = self.store.node_by_id(node_id)
        if node is None:
            return 0.0
        if node.status == NodeStatus.DOWN.value:
            # A heartbeat from a down node re-registers it as initializing
            # until the client pushes a full update (node_endpoint.go:476).
            self.update_node_status(node_id, NodeStatus.INIT.value)
        return self.heartbeater.reset_heartbeat(node_id)

    def update_node_status(self, node_id: str, status: str) -> None:
        node = self.store.node_by_id(node_id)
        if node is None:
            return
        transitioned_down = (
            status == NodeStatus.DOWN.value and node.status != NodeStatus.DOWN.value
        )
        became_ready = (
            status == NodeStatus.READY.value and node.status != NodeStatus.READY.value
        )
        index = self.next_index()
        self.store.update_node_status(index, node_id, status)
        node = self.store.node_by_id(node_id)
        if transitioned_down:
            self.heartbeater.clear_heartbeat(node_id)
            self._create_node_evals(node, index)
        elif became_ready and node.ready():
            self._capacity_added(node, index)
            # init→ready also needs node evals so system jobs land on the
            # node (UpdateStatus → createNodeEvals, node_endpoint.go:375).
            self._create_node_evals(node, index, system_only=True)

    def update_node_drain(
        self, node_id: str, drain_strategy, mark_eligible: bool = False
    ) -> None:
        index = self.next_index()
        self.store.update_node_drain(index, node_id, drain_strategy, mark_eligible)
        node = self.store.node_by_id(node_id)
        if node is not None:
            if node.drain:
                self._create_node_evals(node, index)
            elif node.ready():
                self._capacity_added(node, index)

    def update_node_eligibility(self, node_id: str, eligibility: str) -> None:
        index = self.next_index()
        self.store.update_node_eligibility(index, node_id, eligibility)
        node = self.store.node_by_id(node_id)
        if node is not None and node.ready():
            self._capacity_added(node, index)

    def _on_heartbeat_expired(self, node_id: str) -> None:
        log.info("node %s missed heartbeat, marking down", node_id)
        self.metrics.incr("nomad.heartbeat.missed")
        self.update_node_status(node_id, NodeStatus.DOWN.value)

    def _capacity_added(self, node: Node, index: int) -> None:
        cls = computed_class_key(node_attributes(node), node)
        self.blocked_evals.unblock(cls, index)
        self.blocked_evals.unblock_node(node.id, index)

    def _create_node_evals(
        self, node: Node, index: int, system_only: bool = False
    ) -> None:
        """One eval per job touching the node (+ system jobs in its DC) —
        createNodeEvals (node_endpoint.go:1145)."""
        if node is None:
            return
        evals: List[Evaluation] = []
        jobs_seen = set()
        if not system_only:
            for alloc in self.store.allocs_by_node(node.id):
                if alloc.terminal_status():
                    continue
                key = (alloc.namespace, alloc.job_id)
                if key in jobs_seen:
                    continue
                jobs_seen.add(key)
                job = self.store.job_by_id(*key)
                if job is None:
                    continue
                evals.append(
                    Evaluation(
                        namespace=alloc.namespace,
                        priority=job.priority,
                        type=job.type,
                        triggered_by=EvalTrigger.NODE_UPDATE.value,
                        job_id=alloc.job_id,
                        node_id=node.id,
                        node_modify_index=index,
                        status=EvalStatus.PENDING.value,
                    )
                )
        for job in self.store.all_jobs():
            if job.type != JobType.SYSTEM.value or job.stopped():
                continue
            if node.datacenter not in job.datacenters:
                continue
            if (job.namespace, job.id) in jobs_seen:
                continue
            evals.append(
                Evaluation(
                    namespace=job.namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=EvalTrigger.NODE_UPDATE.value,
                    job_id=job.id,
                    node_id=node.id,
                    node_modify_index=index,
                    status=EvalStatus.PENDING.value,
                )
            )
        if evals:
            self.apply_eval_updates(evals)

    # ------------------------------------------------------------------
    # Alloc client updates (Node.UpdateAlloc, node_endpoint.go:1054)
    # ------------------------------------------------------------------

    def update_allocs_from_client(self, updates: List[Allocation]) -> None:
        index = self.next_index()
        evals: List[Evaluation] = []
        freed_nodes: Dict[str, Node] = {}
        jobs_seen = set()
        for upd in updates:
            prev = self.store.alloc_by_id(upd.id)
            if prev is None:
                continue
            became_terminal = not prev.client_terminal() and upd.client_status in (
                AllocClientStatus.COMPLETE.value,
                AllocClientStatus.FAILED.value,
                AllocClientStatus.LOST.value,
            )
            if became_terminal:
                node = self.store.node_by_id(prev.node_id)
                if node is not None:
                    freed_nodes[node.id] = node
            # Failed alloc → reschedule eval (node_endpoint.go:1079-1107).
            if (
                upd.client_status == AllocClientStatus.FAILED.value
                and prev.client_status != AllocClientStatus.FAILED.value
            ):
                key = (prev.namespace, prev.job_id)
                job = self.store.job_by_id(*key)
                if job is not None and not job.stopped() and key not in jobs_seen:
                    jobs_seen.add(key)
                    evals.append(
                        Evaluation(
                            namespace=prev.namespace,
                            priority=job.priority,
                            type=job.type,
                            triggered_by=EvalTrigger.RETRY_FAILED_ALLOC.value,
                            job_id=prev.job_id,
                            status=EvalStatus.PENDING.value,
                        )
                    )
        self.store.update_allocs_from_client(index, updates)
        for node in freed_nodes.values():
            self._capacity_added(node, index)
        if evals:
            self.apply_eval_updates(evals)

    def stop_alloc(self, alloc_id: str) -> Optional[Evaluation]:
        """User-initiated ``alloc stop`` (alloc_endpoint.go Stop): set the
        desired transition and create a reschedule eval."""
        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None:
            return None
        index = self.next_index()
        stopped = alloc.copy()
        stopped.desired_transition.reschedule = True
        ev = Evaluation(
            namespace=alloc.namespace,
            priority=alloc.job_priority(),
            type=alloc.job.type if alloc.job else JobType.SERVICE.value,
            triggered_by=EvalTrigger.ALLOC_STOP.value,
            job_id=alloc.job_id,
            status=EvalStatus.PENDING.value,
        )
        self.store.upsert_allocs(index, [stopped])
        self.apply_eval_updates([ev])
        return ev

    # ------------------------------------------------------------------
    # Drainer applies
    # ------------------------------------------------------------------

    def apply_alloc_desired_transitions(
        self, transitions: Dict[str, DesiredTransition], evals: List[Evaluation]
    ) -> None:
        """Batched drainer stamp + evals (AllocUpdateDesiredTransition,
        drainer.go:357)."""
        self.store.update_allocs_desired_transition(
            self.next_index(), transitions
        )
        if evals:
            self.apply_eval_updates(evals)

    def complete_node_drain(self, node_id: str) -> None:
        """Drain finished: clear the strategy, node stays ineligible
        (drainer.go NodesDrainComplete)."""
        node = self.store.node_by_id(node_id)
        if node is None or not node.drain:
            return
        self.store.update_node_drain(
            self.next_index(), node_id, None, mark_eligible=False
        )
        log.info("node %s drain complete", node_id)

    # ------------------------------------------------------------------
    # Plan-apply hook
    # ------------------------------------------------------------------

    def on_plan_applied(self, plan, result, index: int) -> None:
        """Post-commit: stopped/preempted allocs free capacity → unblock
        their nodes' classes (the watchCapacity feed, blocked_evals.go:508)."""
        freed = set(result.node_update.keys()) | set(result.node_preemptions.keys())
        for nid in freed:
            node = self.store.node_by_id(nid)
            if node is not None:
                cls = computed_class_key(node_attributes(node), node)
                self.blocked_evals.unblock(cls, index)

    # ------------------------------------------------------------------

    def wait_for_eval(
        self, eval_id: str, timeout: float = 10.0
    ) -> Optional[Evaluation]:
        """Poll until the eval reaches a terminal status."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            ev = self.store.eval_by_id(eval_id)
            if ev is not None and ev.terminal_status():
                return ev
            time.sleep(0.01)
        return self.store.eval_by_id(eval_id)
