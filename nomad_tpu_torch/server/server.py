"""The server — single-process control plane wiring, trimmed to the
scheduling path.

Reference: ``nomad/server.go`` (Server struct :95-257).  Wired here: the
state store and the card-resident node matrix, the dispatch coalescer,
the eval broker, blocked evals, the plan queue with its serialized
applier, and N scheduling workers.  Every mutation funnels through the
``apply_*`` methods with a monotonically assigned index.

Heartbeats, the deployment watcher, the drainer, the periodic dispatcher,
the load gate, overload control, SLOs, replication, ACLs, the leader
reapers and the HTTP API are not part of this package yet.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..device import resolve_device
from ..state.matrix import NodeMatrix, computed_class_key, node_attributes
from ..state.store import StateStore
from ..structs.types import (
    EvalStatus,
    EvalTrigger,
    Evaluation,
    Job,
    JobStatus,
    Node,
    SchedulerConfiguration,
)
from .admission import admit
from .blocked_evals import BlockedEvals
from .eval_broker import EvalBroker
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .worker import Worker

log = logging.getLogger(__name__)


@dataclass
class ServerConfig:
    num_workers: int = 2
    eval_nack_timeout: float = 120.0
    eval_delivery_limit: int = 3
    node_capacity: int = 1024
    # Max selects batched into one device dispatch (scheduler/coalescer.py).
    coalescer_lanes: int = 64
    # Overlapping dispatches the coalescer keeps in flight.  None = env
    # NOMAD_TPU_PIPELINE_DEPTH, default 8.
    pipeline_depth: Optional[int] = None
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

    # ------------------------------------------------------------------

    def next_index(self) -> int:
        with self._index_lock:
            self._index = max(self._index, self.store.latest_index) + 1
            return self._index

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Enable the scheduling services (leader.go:222, the subset this
        package has)."""
        if self._leader:
            return
        self._leader = True
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.plan_queue.set_enabled(True)
        self.coalescer.start()
        self.plan_applier.start()
        for w in self.workers:
            w.start()
        for ev in list(self.store.evals.values()):
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def shutdown(self) -> None:
        self._leader = False
        for w in self.workers:
            w.stop()
        self.plan_applier.stop()
        self.coalescer.stop()
        self.eval_broker.shutdown()
        self.plan_queue.shutdown()

    # ------------------------------------------------------------------
    # Job RPCs (nomad/job_endpoint.go:80 Register)
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
        return index

    # ------------------------------------------------------------------
    # Node RPCs (nomad/node_endpoint.go:80 Register)
    # ------------------------------------------------------------------

    def register_node(self, node: Node) -> None:
        prev = self.store.node_by_id(node.id)
        index = self.next_index()
        self.store.upsert_node(index, node)
        new_capacity = prev is None or prev.terminal() or not prev.ready()
        if new_capacity and node.ready():
            self._capacity_added(node, index)

    def _capacity_added(self, node: Node, index: int) -> None:
        cls = computed_class_key(node_attributes(node), node)
        self.blocked_evals.unblock(cls, index)
        self.blocked_evals.unblock_node(node.id, index)

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
