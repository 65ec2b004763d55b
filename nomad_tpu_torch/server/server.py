"""The server — single-process control plane wiring, trimmed to the
scheduling path.

Reference: ``nomad/server.go`` (Server struct :95-257).  Wired here: the
state store and the card-resident node matrix, the dispatch coalescer,
the eval broker, blocked evals with the periodic retry of those blocked
after placement conflicts, the plan queue with its serialized applier, N
scheduling workers, the heartbeat TTL wheel, the node drainer, the
deployment watcher, the periodic dispatcher and the leader reapers (failed
evals, volume claims, periodic core GC), with the job, deployment, node
and GC RPCs that feed them.  Every mutation funnels through the
``apply_*`` methods with a monotonically assigned index.

With ``ServerConfig.data_dir`` set, every store mutation is write-ahead
journaled there (``state/wal.py``) and a new server restores the snapshot
and the log tail before it starts; the matrix is rebuilt through the
store's mutators, and its first sync uploads it in full.  The leader's
control loop — the SLO observatory, the admission gate and the overload
controller (``obs/``) — starts and stops with leadership.  Every span
of an eval feeds this server's ``nomad.phase.*`` timers (``trace/``).
ACL tokens resolve to compiled policies (``acl/``) through
``resolve_token`` and ``check_acl_capability``.

The node agents (``client/``) reach the server through the client-facing
RPCs: ``register_node``, ``heartbeat_node``, ``update_node_status``, the
blocking ``get_client_allocs``, ``update_allocs_from_client``,
``get_alloc_fs_origin`` and ``get_volume_source``.  With
:meth:`Server.setup_replication` (the agent calls it when ``peers`` or
``raft_enabled`` is set) the server joins a replicated cluster
(``server/replication.py``): it follows until it wins an election, every
store write goes to a quorum first, and ``join_peer``/``remove_peer``
change the membership.  Each server of such a cluster holds its own
device; only the leader launches kernels.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..device import resolve_device
from ..state.matrix import NodeMatrix, computed_class_key, node_attributes
from ..state.store import StateStore
from ..structs.types import (
    AllocClientStatus,
    Allocation,
    DeploymentStatus,
    DesiredTransition,
    EvalStatus,
    EvalTrigger,
    Evaluation,
    Job,
    JobStatus,
    JobType,
    Node,
    NodeStatus,
    Plan,
    PlanResult,
    ScalingEvent,
    SchedulerConfiguration,
    generate_uuid,
)
from .admission import AdmissionGate, admit
from .blocked_evals import BlockedEvals
from .deploymentwatcher import DeploymentWatcher
from .drainer import NodeDrainer
from .eval_broker import EvalBroker
from .heartbeat import HeartbeatManager
from .periodic import PeriodicDispatcher
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
    # Durability (fsm.go Persist/Restore + raft-boltdb log): when set, every
    # state mutation is write-ahead journaled under data_dir and the server
    # restores snapshot+log on boot. None = in-memory only.
    data_dir: Optional[str] = None
    wal_fsync: bool = False
    snapshot_every: int = 4096
    # Max selects batched into one device dispatch (scheduler/coalescer.py).
    coalescer_lanes: int = 64
    # Overlapping dispatches the coalescer keeps in flight.  None = env
    # NOMAD_TPU_PIPELINE_DEPTH, default 8.
    pipeline_depth: Optional[int] = None
    # Devices the coalescer's dispatches span (the node-sharded dispatch,
    # parallel/).  None = the length of a device list given to Server,
    # else every visible card when the host has more than one, else 1.
    n_device_shards: Optional[int] = None
    # Seconds between retries of the evals blocked after placement
    # conflicts (leader.go failedEvalUnblockInterval).
    failed_eval_unblock_interval: float = 60.0
    # Delay of the follow-up eval the failed-eval reaper cuts for an eval
    # past its delivery limit (leader.go failedEvalFollowUpWaitRange).
    failed_eval_unblock_delay: float = 60.0
    # Core GC cadence (leader.go schedulePeriodic; one shared interval for
    # the eval, job, deployment and node GC evals).
    core_gc_interval: float = 300.0
    # ACL enforcement (acl/; nomad/server.go:88-91 token resolution).
    acl_enabled: bool = False
    scheduler_config: SchedulerConfiguration = field(
        default_factory=SchedulerConfiguration
    )
    # SLO observatory (obs/): the leader's burn-rate loop.  slo_specs None
    # = the north-star defaults (obs.default_slos); [] disables SLO
    # evaluation while keeping the health report live.
    slo_enabled: bool = True
    slo_interval: float = 1.0
    slo_specs: Optional[List] = None
    # Overload control loop (obs/controller.py): the observatory tick
    # drives admission gating + broker shedding off the composite
    # pressure score.  overload_config None = NOMAD_TPU_OVERLOAD_* env
    # defaults; admission_rate/burst None = NOMAD_TPU_OVERLOAD_RATE /
    # _BURST (500/s, 1000) per-namespace token buckets (rate <= 0
    # disables volumetric limiting).
    overload_enabled: bool = True
    overload_config: Optional[object] = None
    admission_rate: Optional[float] = None
    admission_burst: Optional[float] = None
    # Multi-server consensus (server/replication.py): peer HTTP addresses.
    # Empty = single-server (immediate leadership, no replication).
    server_id: str = ""
    peers: List[str] = field(default_factory=list)
    # Run replication even with no configured peers (a single-server
    # cluster that expects `server join` to grow it later).
    raft_enabled: bool = False
    election_timeout: tuple = (0.25, 0.5)
    raft_heartbeat_interval: float = 0.08
    # Shared secret authenticating server↔server raft RPCs; required on
    # /v1/internal/raft/* when set (otherwise those routes accept any
    # caller when ACLs are off — see api/http_server.route).
    cluster_secret: str = ""


class Server:
    """The scheduling path's control plane.  ``device`` is where the node
    matrix lives and the kernels run: ``"cuda"`` (the default) needs a
    card and raises without one; ``"cpu"`` runs the plain PyTorch
    versions.  A list of devices (``["cuda:0", "cuda:1"]``, or one device
    named several times for virtual shards) makes the coalescer's
    dispatches node-sharded over them; the first is the lead, where the
    one-device work (solo selects, system jobs, the plan verify) runs."""

    def __init__(self, config: Optional[ServerConfig] = None, device="cuda"):
        from ..parallel.sharding import device_list

        self.config = config or ServerConfig()
        self.devices = device_list(device)
        self.device = (self.devices[0] if self.devices
                       else resolve_device(device))
        from ..metrics import MetricsRegistry

        self.metrics = MetricsRegistry()
        self.matrix = NodeMatrix(
            capacity=self.config.node_capacity, device=self.device
        )
        self.store = StateStore(matrix=self.matrix)
        self.store.scheduler_config = self.config.scheduler_config
        # Set by setup_replication; None = a single server that leads.
        self.replicator = None
        if self.config.data_dir:
            from ..state.wal import WriteAheadLog

            wal = WriteAheadLog(self.config.data_dir, fsync=self.config.wal_fsync)
            snap, entries = wal.load()
            if snap or entries:
                log.info(
                    "restoring state: snapshot=%s wal_entries=%d",
                    bool(snap), len(entries),
                )
            self.store.restore(snap, entries)
            self.store.attach_wal(wal, snapshot_every=self.config.snapshot_every)
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
        # Leader services (leader.go:222 establishLeadership set).
        self.deployment_watcher = DeploymentWatcher(self)
        self.drainer = NodeDrainer(self)
        self.periodic = PeriodicDispatcher(self)
        # The matrix's single dispatch port: concurrent selects coalesce
        # into batched kernel launches (scheduler/coalescer.py).
        from ..scheduler.coalescer import DeviceCoalescer

        self.coalescer = DeviceCoalescer(
            self.matrix, max_lanes=self.config.coalescer_lanes,
            pipeline_depth=self.config.pipeline_depth,
            metrics=self.metrics,
            device=self.devices or self.device,
            n_device_shards=self.config.n_device_shards,
        )
        self.matrix.coalescer = self.coalescer

        # Ambient trace spans (the scheduler stack has no server handle)
        # feed this server's phase timers; the last server constructed
        # wins, which only blurs attribution with several in one process.
        from .. import trace

        trace.set_default_metrics(self.metrics)
        self._register_telemetry_gauges()

        # SLO observatory: constructed always (its reports answer on a
        # server that is not the leader too), ticking only on leaders.
        from ..obs import OverloadController, SLOObservatory

        self.observatory = SLOObservatory(
            self,
            specs=self.config.slo_specs,
            interval=self.config.slo_interval,
        )
        # Overload control loop: gate + controller are constructed always
        # (the report answers even when the loop is off); the observatory
        # tick only steps the controller on leaders with overload_enabled.
        self.admission_gate = AdmissionGate(
            rate=self.config.admission_rate,
            burst=self.config.admission_burst,
            metrics=self.metrics,
        )
        self.overload_controller = OverloadController(
            self, config=self.config.overload_config
        )

        self._index_lock = threading.Lock()
        self._index = 0
        self._last_gc = time.time()
        self._leader = False
        self._unblock_stop = threading.Event()
        self._unblocker: Optional[threading.Thread] = None
        self._reaper: Optional[threading.Thread] = None
        self._acl_cache: Dict = {}
        # Dry runs (plan_job) in flight, and whether an install holds new
        # ones off: an install waits for the dry runs in flight and none
        # starts until the image is in.
        self._dry_cond = threading.Condition()
        self._dry_runs = 0
        self._installing = False
        # Serializes establish_leadership and revoke_leadership: the
        # replicator calls them from its election thread and from the
        # thread of a step-down.
        self._transition_lock = threading.RLock()

    def _register_telemetry_gauges(self) -> None:
        """The matrix, coalescer and encoder counters as pull gauges of the
        registry, so one snapshot carries the device cost picture.  The
        reference's gauges on counters this package's coalescer does not
        keep (top-k host bytes, verify conflicts, feature recompiles,
        operand bytes) wait for those subjects."""
        m = self.metrics
        c = self.coalescer
        mx = self.matrix
        enc = mx.shared_encoder()
        m.gauge_fn("nomad.coalescer.pipeline_depth", lambda: c.pipeline_depth)
        m.gauge_fn("nomad.coalescer.inflight_depth", c.inflight_depth)
        m.gauge_fn("nomad.coalescer.dispatches", lambda: c.dispatches)
        m.gauge_fn(
            "nomad.coalescer.coalesced_requests", lambda: c.coalesced_requests
        )
        m.gauge_fn(
            "nomad.coalescer.lane_fill_ratio",
            lambda: round(
                c.coalesced_requests / (c.dispatches * c.max_lanes or 1), 4
            ),
        )
        m.gauge_fn("nomad.coalescer.stale_dispatches", lambda: c.stale_dispatches)
        m.gauge_fn(
            "nomad.coalescer.wedged_dispatches", lambda: c.wedged_dispatches
        )
        m.gauge_fn(
            "nomad.coalescer.shard_evacuations", lambda: c.shard_evacuations
        )
        m.gauge_fn("nomad.matrix.full_uploads", lambda: mx.full_uploads)
        m.gauge_fn("nomad.matrix.scatter_syncs", lambda: mx.scatter_syncs)
        m.gauge_fn(
            "nomad.matrix.rows_scattered_total", lambda: mx.rows_scattered_total
        )
        m.gauge_fn(
            "nomad.matrix.rows_per_scatter",
            lambda: round(mx.rows_scattered_total / (mx.scatter_syncs or 1), 2),
        )
        m.gauge_fn(
            "nomad.matrix.upload_bytes_total", lambda: mx.upload_bytes_total
        )
        # Per-kernel attribution: launch counts by path and the request
        # compile cache's hits and misses.  One fused launch serves every
        # coalesced lane (launches/eval = fused_dispatches / fused_lanes).
        m.gauge_fn("nomad.kernel.launches", lambda: c.dispatches, path="batched")
        m.gauge_fn("nomad.kernel.launches", lambda: c.solo_ops, path="solo")
        m.gauge_fn(
            "nomad.kernel.launches", lambda: c.fused_dispatches, path="fused"
        )
        m.gauge_fn("nomad.kernel.fused_lanes", lambda: c.fused_lanes)
        m.gauge_fn(
            "nomad.kernel.launches_per_eval",
            lambda: round(c.fused_dispatches / (c.fused_lanes or 1), 4),
            path="fused",
        )
        m.gauge_fn(
            "nomad.kernel.compile_cache", lambda: enc.cache_hits, result="hit"
        )
        m.gauge_fn(
            "nomad.kernel.compile_cache", lambda: enc.cache_misses, result="miss"
        )
        # Node-axis sharding: claimed rows per home shard (more series
        # appear when the coalescer homes the matrix to a wider mesh at
        # its first dispatch).
        for s in range(mx.shard_count):
            m.gauge_fn(
                "nomad.matrix.shard_rows",
                lambda s=s: (
                    mx.shard_row_counts()[s] if s < mx.shard_count else 0
                ),
                shard=s,
            )

    # ------------------------------------------------------------------

    def next_index(self) -> int:
        with self._index_lock:
            self._index = max(self._index, self.store.latest_index) + 1
            return self._index

    # ------------------------------------------------------------------
    # Consensus (server/replication.py)
    # ------------------------------------------------------------------

    def setup_replication(self, self_addr: str) -> None:
        """Join the configured peer set: this server starts as a follower
        and only runs leader services after winning an election.  Call
        before :meth:`start` (the agent does, with its HTTP address)."""
        from .replication import Replicator

        self.replicator = Replicator(
            self,
            server_id=self.config.server_id or self_addr,
            self_addr=self_addr,
            peer_addrs=self.config.peers,
            election_timeout=self.config.election_timeout,
            heartbeat_interval=self.config.raft_heartbeat_interval,
            cluster_secret=self.config.cluster_secret,
            state_dir=self.config.data_dir,
        )
        self.store.replicator = self.replicator
        # Membership replicated through state (server join/leave) wins
        # over the static config list — a WAL-restored server rejoins the
        # set it last knew, not the one it booted with.
        if self.store.raft_peers:
            self.replicator.update_peers(self.store.raft_peers)

    # ------------------------------------------------------------------
    # Membership (nomad/serf.go join + operator_endpoint.go
    # RaftRemovePeer — here an explicit replicated configuration change)
    # ------------------------------------------------------------------

    def _current_members(self) -> List[str]:
        rep = self.replicator
        if self.store.raft_peers:
            return list(self.store.raft_peers)
        members = set(self.config.peers)
        if rep is not None:
            members.add(rep.self_addr)
            members.update(rep.peers)
        return sorted(members)

    def join_peer(self, addr: str) -> List[str]:
        """Leader-side `server join`: add a member and replicate the new
        configuration; the heartbeat loop then snapshots/repairs the
        newcomer up to date."""
        if self.replicator is None:
            raise ValueError("server is not running replication")
        self.replicator.ensure_leader()
        members = set(self._current_members())
        members.add(addr)
        self.store.set_raft_peers(self.next_index(), sorted(members))
        return sorted(members)

    def remove_peer(self, addr: str) -> List[str]:
        """Dead-peer eviction by operator command (RaftRemovePeer)."""
        if self.replicator is None:
            raise ValueError("server is not running replication")
        self.replicator.ensure_leader()
        members = set(self._current_members())
        members.discard(addr)
        self.store.set_raft_peers(self.next_index(), sorted(members))
        return sorted(members)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """A single server leads at once; a replicated one follows until
        it wins an election (monitorLeadership, leader.go:54)."""
        if self.replicator is not None:
            self.coalescer.start()
            self.replicator.start()
            return
        self.establish_leadership()

    def establish_leadership(self) -> None:
        """Enable leader-only services (establishLeadership,
        leader.go:222).  With a replicator, only while it holds the
        leader role: a revoke queued by an earlier step-down and this
        call may run in either order, and the role decides."""
        with self._transition_lock:
            if self._leader or (
                self.replicator is not None and not self.replicator.is_leader
            ):
                return
            self._establish_leadership_locked()

    def _establish_leadership_locked(self) -> None:
        self._leader = True
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.plan_queue.set_enabled(True)
        self.heartbeater.set_enabled(True)
        self.coalescer.start()
        self.plan_applier.start()  # idempotent: leadership can cycle
        for w in self.workers:
            w.start()
        self._restore_evals()
        # Arm TTL timers for nodes already in state — a node that died while
        # no leader was watching must still expire (initializeHeartbeatTimers,
        # nomad/heartbeat.go:21).
        for node in list(self.store.nodes.values()):
            if node.status != NodeStatus.DOWN.value:
                self.heartbeater.reset_heartbeat(node.id)
        self.deployment_watcher.start()
        self.drainer.start()
        self.periodic.start()  # restores periodic jobs from state
        if self.config.slo_enabled:
            self.observatory.start()
        self._unblock_stop.clear()
        self._unblocker = threading.Thread(
            target=self._periodic_unblock_failed, name="unblock-failed",
            daemon=True,
        )
        self._unblocker.start()
        self._reaper = threading.Thread(
            target=self._run_reapers, name="leader-reapers", daemon=True
        )
        self._reaper.start()

    def _periodic_unblock_failed(self) -> None:
        """Retry the evals blocked after placement conflicts
        (leader.go periodicUnblockFailedEvals)."""
        while not self._unblock_stop.wait(
            self.config.failed_eval_unblock_interval
        ):
            self.blocked_evals.unblock_failed()

    def _stop_leader_threads(self) -> None:
        self._unblock_stop.set()
        for thread in (self._unblocker, self._reaper):
            if thread is not None and thread is not threading.current_thread():
                thread.join()

    def revoke_leadership(self) -> None:
        """Disable leader-only services (revokeLeadership, leader.go).
        With a replicator, not while it holds the leader role again (see
        :meth:`establish_leadership`)."""
        with self._transition_lock:
            if not self._leader or (
                self.replicator is not None and self.replicator.is_leader
            ):
                return
            self._revoke_leadership_locked()

    def _revoke_leadership_locked(self) -> None:
        self._leader = False
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_queue.set_enabled(False)
        self.heartbeater.set_enabled(False)
        self._stop_leader_threads()
        self.deployment_watcher.stop()
        self.drainer.stop()
        self.periodic.stop()
        self.observatory.stop()
        # Release the actuators: a demoted leader must not leave the
        # cluster gated/shedding on stale pressure it can no longer see.
        self.overload_controller.reset()
        # Same for the device breaker: open/half-open is leader-local
        # health state; the next leader judges the card fresh.
        self.coalescer.breaker.reset()

    def install_snapshot(self, snapshot_wire: dict, seq: int) -> None:
        """Replace all state with another server's image
        (``StateStore.install_snapshot``).  The replicator installs the
        leader's image on a follower through here; a follower demoted a
        moment earlier may still have workers selecting and dispatches on
        the device.  So leadership is revoked first and the workers finish
        their evals, and no select holds rows of the matrix that the
        install clears.  A server that leads without a replicator takes
        leadership back after, which re-enqueues the image's evals; a
        replicated follower does not (its next election starts the
        workers again).  Dry runs (:meth:`plan_job`) select through the
        same matrix: the install waits for those in flight and holds new
        ones off until the image is in, so none reads rows that the
        install reassigns."""
        with self._dry_cond:
            while self._installing:
                self._dry_cond.wait()
            self._installing = True
            while self._dry_runs:
                self._dry_cond.wait()
        try:
            with self._transition_lock:
                leader = self._leader and self.replicator is None
                if self._leader:
                    self._revoke_leadership_locked()
            for w in self.workers:  # signal all first: each polls for 0.2 s
                w.stop(timeout=0)
            for w in self.workers:
                w.stop(timeout=None)
            self.store.install_snapshot(snapshot_wire, seq)
            if leader:
                self.establish_leadership()
        finally:
            with self._dry_cond:
                self._installing = False
                self._dry_cond.notify_all()

    def shutdown(self) -> None:
        if self.replicator is not None:
            # First: no election may start leader services from here on.
            self.replicator.stop()
        self._leader = False
        self._stop_leader_threads()
        self.deployment_watcher.stop()
        self.drainer.stop()
        self.periodic.stop()
        self.observatory.stop()
        self.overload_controller.reset()
        self.coalescer.breaker.reset()
        for w in self.workers:
            w.stop()
        self.plan_applier.stop()
        self.coalescer.stop()
        self.eval_broker.shutdown()
        self.plan_queue.shutdown()
        self.heartbeater.set_enabled(False)
        self.store.close_watches()
        if self.store.wal is not None:
            # Clean-shutdown snapshot: compacts the log and speeds the next
            # boot (crash-stop restores identically from WAL replay).
            try:
                self.store.write_snapshot()
                self.store.wal.close()
            except Exception:  # noqa: BLE001
                log.exception("shutdown snapshot failed")

    def _restore_evals(self) -> None:
        """Re-enqueue non-terminal evals from state on leadership gain
        (restoreEvals, leader.go:493)."""
        for ev in list(self.store.evals.values()):
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    # ------------------------------------------------------------------
    # Job RPCs (nomad/job_endpoint.go:80 Register, :797 Deregister)
    # ------------------------------------------------------------------

    def submit_job(
        self, job: Job, internal: bool = False
    ) -> Optional[Evaluation]:
        # Admission pipeline (job_endpoint_hooks.go): mutate
        # (canonicalize), then validate — rejects before anything journals.
        admit(job)
        # Load gate (after canonicalize so namespace is filled): external
        # registers/dispatches pay the token bucket; internal resubmits
        # (periodic children, reverts, scales) bypass it — shedding them
        # would silently drop work the server itself originated.
        if not internal:
            self.admission_gate.check(job.namespace, job.priority)
        index = self.next_index()
        job.submit_time = time.time()
        job.status = JobStatus.PENDING.value
        self.store.upsert_job(index, job)
        if job.is_periodic() or job.is_parameterized():
            # Periodic/parameterized jobs get no eval at register time —
            # children are dispatched later (job_endpoint.go:245-260).
            if job.is_periodic() and self._leader:
                self.periodic.add(job)
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
    # ACL (acl/ package; nomad/acl.go ResolveToken + 2Q cache — here a
    # table-index-validated dict, same effect at this scale)
    # ------------------------------------------------------------------

    def bootstrap_acl(self):
        """One-time creation of the initial management token
        (ACL.Bootstrap, nomad/acl_endpoint.go)."""
        from ..structs.types import ACLToken

        # Same lock order as the journaled wrapper (_write_lock → _lock);
        # _lock alone around a journaled write inverts and can deadlock.
        with self.store._write_lock, self.store._lock:
            if self.store.has_management_token():
                raise PermissionError("ACL already bootstrapped")
            token = ACLToken(
                name="Bootstrap Token", type="management",
                create_time=time.time(),
            )
            self.store.upsert_acl_tokens(self.next_index(), [token])
        return token

    def resolve_token(self, secret_id: str):
        """secret → compiled ACL. Empty secret resolves to the
        ``anonymous`` policy (deny-all when undefined); an unknown secret
        to None."""
        from ..acl import ACL, DENY_ALL_ACL, MANAGEMENT_ACL, parse_policy

        if not self.config.acl_enabled:
            return MANAGEMENT_ACL
        cache_key = (
            secret_id,
            self.store.table_index("acl_token"),
            self.store.table_index("acl_policy"),
        )
        cached = self._acl_cache.get(cache_key)
        if cached is not None:
            return cached
        if not secret_id:
            anon = self.store.acl_policies.get("anonymous")
            acl = ACL([parse_policy(anon.rules)]) if anon else DENY_ALL_ACL
        else:
            token = self.store.acl_token_by_secret(secret_id)
            if token is None:
                acl = None  # invalid secret: reject outright
            elif token.is_management():
                acl = MANAGEMENT_ACL
            else:
                policies = [
                    self.store.acl_policies.get(name)
                    for name in token.policies
                ]
                acl = ACL([
                    parse_policy(p.rules) for p in policies if p is not None
                ])
        if acl is not None:  # never cache invalid-secret misses: a bad
            # token retried in a loop would flush valid entries
            if len(self._acl_cache) > 1024:
                self._acl_cache.clear()
            self._acl_cache[cache_key] = acl
        return acl

    def check_acl_capability(
        self, token: str, kind: str, capability: str,
        namespace: str = "default",
    ) -> bool:
        """Capability check for a caller holding ``token``: ``kind`` is
        ``namespace`` (a namespace capability such as ``submit-job``),
        ``node``, ``operator`` or, otherwise, ``agent`` (``read`` or
        ``write``)."""
        if not self.config.acl_enabled:
            return True
        acl = self.resolve_token(token)
        if acl is None:
            return False
        if kind == "namespace":
            return acl.allow_namespace(namespace, capability)
        if kind == "node":
            return acl.allow_node(capability)
        if kind == "operator":
            return acl.allow_operator(capability)
        return acl.allow_agent(capability)

    def plan_job(self, job: Job, diff: bool = False) -> Dict:
        """`job plan` dry run (nomad/job_endpoint.go:1642 Plan +
        scheduler/annotate.go): run the real scheduler — and through it
        the coalescer and the card's kernels — against a pinned snapshot
        with a recording planner; nothing commits.  Returns per-TG
        create/update/destroy annotations, placement failures, and
        (optionally) a coarse spec diff.  A snapshot install in progress
        holds the dry run off until the image is in."""
        with self._dry_cond:
            while self._installing:
                self._dry_cond.wait()
            self._dry_runs += 1
        try:
            return self._plan_job(job, diff)
        finally:
            with self._dry_cond:
                self._dry_runs -= 1
                self._dry_cond.notify_all()

    def _plan_job(self, job: Job, diff: bool) -> Dict:
        from ..scheduler import new_scheduler
        from ..structs import serde

        snap = self.store.snapshot()
        prev = snap.job_by_id(job.namespace, job.id)
        if prev is not None:
            job.version = prev.version + (
                1 if StateStore._job_spec_changed(prev, job) else 0
            )
        else:
            job.version = 0

        ev = Evaluation(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by="job-plan",
            job_id=job.id,
            status=EvalStatus.PENDING.value,
            annotate_plan=True,
            snapshot_index=snap.snapshot_index,
        )
        planner = _DryRunPlanner(snap)
        sched = new_scheduler(
            job.type or JobType.SERVICE.value,
            _ProposedJobSnapshot(snap, job),
            planner,
            self.matrix,
        )
        sched.process(ev)

        updated = planner.updated_eval
        annotations = getattr(sched, "last_desired_updates", None)
        if annotations is None:
            # System scheduler: derive counts from the recorded plan.
            annotations = {}
            for plan in planner.plans:
                for allocs in plan.node_allocation.values():
                    for a in allocs:
                        d = annotations.setdefault(a.task_group, {})
                        d["place"] = d.get("place", 0) + 1
                for allocs in plan.node_update.values():
                    for a in allocs:
                        d = annotations.setdefault(a.task_group, {})
                        d["stop"] = d.get("stop", 0) + 1
        out: Dict = {
            "Annotations": {"DesiredTGUpdates": annotations},
            "FailedTGAllocs": {
                tg: serde.to_wire(m)
                for tg, m in (
                    updated.failed_tg_allocs if updated else {}
                ).items()
            },
            "JobModifyIndex": prev.modify_index if prev else 0,
            "CreatedEvals": len(planner.evals),
            "Index": snap.snapshot_index,
        }
        if diff:
            out["Diff"] = _job_diff(prev, job)
        return out

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
        if job.is_periodic():
            self.periodic.remove(namespace, job_id)
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
        # Health signal: the heartbeat_liveness SLO and the overload
        # score both rate this counter (obs/evaluator.py).
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
    # Deployment RPCs (nomad/deployment_endpoint.go Promote/Fail/Pause +
    # Job revert, nomad/job_endpoint.go:1240 Revert)
    # ------------------------------------------------------------------

    def update_deployment_status(
        self, deployment_id: str, status: str, description: str = ""
    ) -> None:
        self.store.update_deployment_status(
            self.next_index(), deployment_id, status, description
        )

    def promote_deployment(
        self, deployment_id: str, groups: Optional[List[str]] = None
    ) -> None:
        """Flip canary groups to promoted and cut an eval so the reconciler
        begins replacing old-version allocs."""
        dep = self.store.deployment_by_id(deployment_id)
        if dep is None:
            return
        self.store.update_deployment_promotion(
            self.next_index(), deployment_id, groups
        )
        job = self.store.job_by_id(dep.namespace, dep.job_id)
        if job is not None:
            self.apply_eval_updates([
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

    def fail_deployment(self, deployment_id: str, description: str = "") -> None:
        self.update_deployment_status(
            deployment_id,
            DeploymentStatus.FAILED.value,
            description or "Deployment marked as failed",
        )

    def revert_job(
        self, namespace: str, job_id: str, to_version: Optional[int] = None
    ) -> Optional[Evaluation]:
        """Re-submit a prior job version as a new version (auto-revert and
        the `job revert` CLI; nomad/job_endpoint.go:1240)."""
        current = self.store.job_by_id(namespace, job_id)
        if current is None:
            return None
        versions = self.store.job_versions.get((namespace, job_id), [])
        target: Optional[Job] = None
        for v in reversed(versions):
            if to_version is not None:
                if v.version == to_version:
                    target = v
                    break
            elif v.version < current.version:
                target = v
                break
        if target is None:
            return None
        reverted = target.copy()
        reverted.stop = False
        return self.submit_job(reverted, internal=True)

    def pause_deployment(self, deployment_id: str, pause: bool) -> None:
        """Pause/resume a rolling update (Deployment.Pause,
        nomad/deployment_endpoint.go): paused deployments are skipped by
        the watcher's pacing loop until resumed."""
        self.update_deployment_status(
            deployment_id,
            DeploymentStatus.PAUSED.value if pause
            else DeploymentStatus.RUNNING.value,
            "Deployment is paused" if pause
            else "Deployment is running",
        )

    # ------------------------------------------------------------------
    # Parameterized dispatch + scaling (nomad/job_endpoint.go:1849
    # Dispatch, :980 Scale).  Both register through submit_job: a
    # dispatch pays the load gate like any external register, a scale is
    # internal.
    # ------------------------------------------------------------------

    # structs.DispatchPayloadSizeLimit (16 KiB), pre-base64.
    DISPATCH_PAYLOAD_LIMIT = 16 * 1024

    def dispatch_job(
        self,
        namespace: str,
        job_id: str,
        payload: bytes = b"",
        meta: Optional[Dict[str, str]] = None,
    ) -> Tuple[Optional[Job], Optional[Evaluation]]:
        """Instantiate a parameterized job as a dispatched child
        (Job.Dispatch): validate meta against meta_required/meta_optional,
        stamp the payload, and register ``<id>/dispatch-<ts>-<uuid>``."""
        import base64

        parent = self.store.job_by_id(namespace, job_id)
        if parent is None:
            raise ValueError("job not found")
        if not parent.is_parameterized():
            raise ValueError("job is not parameterized")
        if parent.stop:
            raise ValueError("job is stopped")
        spec = parent.parameterized or {}
        meta = dict(meta or {})
        required = set(spec.get("meta_required", []))
        optional = set(spec.get("meta_optional", []))
        missing = required - set(meta)
        if missing:
            raise ValueError(f"missing required meta: {sorted(missing)}")
        unexpected = set(meta) - required - optional
        if unexpected:
            raise ValueError(f"unpermitted meta: {sorted(unexpected)}")
        payload_mode = spec.get("payload", "optional")
        if payload and payload_mode == "forbidden":
            raise ValueError("payload forbidden by parameterized block")
        if not payload and payload_mode == "required":
            raise ValueError("payload required by parameterized block")
        if len(payload) > self.DISPATCH_PAYLOAD_LIMIT:
            raise ValueError("payload exceeds 16 KiB limit")

        child = parent.copy()
        child.id = (
            f"{parent.id}/dispatch-{int(time.time())}-"
            f"{generate_uuid()[:8]}"
        )
        child.name = child.id
        child.parent_id = parent.id
        child.parameterized = None
        child.periodic = None
        child.meta = {**parent.meta, **meta}
        child.payload = base64.b64encode(payload).decode() if payload else ""
        child.version = 0
        ev = self.submit_job(child)
        return child, ev

    def scale_job(
        self,
        namespace: str,
        job_id: str,
        group: str,
        count: Optional[int],
        message: str = "",
        error: bool = False,
        meta: Optional[Dict] = None,
    ) -> Optional[Evaluation]:
        """Set a group's count (Job.Scale): bounds-checked against the
        group's scaling policy, records a ScalingEvent, and registers the
        updated job (a new version, like the reference's raft apply)."""
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError("job not found")
        if not group and len(job.task_groups) == 1:
            group = job.task_groups[0].name
        tg = job.lookup_task_group(group)
        if tg is None:
            raise ValueError(f"no task group {group!r}")
        if error and count is not None:
            raise ValueError("scale cannot carry both count and error")

        ev: Optional[Evaluation] = None
        prev_count = tg.count
        if count is not None:
            if count < 0:
                raise ValueError("count cannot be negative")
            pol = tg.scaling
            if pol is not None:
                # Bounds apply even with the policy DISABLED: disabled
                # stops the autoscaler from acting (scaling.go:74), it
                # does not lift the operator-declared min/max guardrails.
                if count < pol.min or (pol.max and count > pol.max):
                    raise ValueError(
                        f"count {count} outside policy bounds "
                        f"[{pol.min}, {pol.max}]"
                    )
            updated = job.copy()
            updated.lookup_task_group(group).count = count
            ev = self.submit_job(updated, internal=True)
        self.store.record_scaling_event(
            self.next_index(), namespace, job_id, group,
            ScalingEvent(
                time=time.time(),
                count=count,
                previous_count=prev_count,
                message=message,
                error=error,
                eval_id=ev.id if ev else "",
                meta=dict(meta or {}),
            ),
        )
        return ev

    def system_gc(self) -> None:
        """Force a full GC sweep now (System.GarbageCollect,
        nomad/system_endpoint.go): one force-gc core eval through the
        normal broker/worker path."""
        from ..scheduler.core import CORE_JOB_FORCE_GC

        self.apply_eval_updates([_core_eval(CORE_JOB_FORCE_GC)])

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

    def record_periodic_launch(
        self, namespace: str, job_id: str, launch_time: float
    ) -> None:
        self.store.record_periodic_launch(
            self.next_index(), namespace, job_id, launch_time
        )

    # ------------------------------------------------------------------
    # GC applies (core_sched.go deletion raft applies)
    # ------------------------------------------------------------------

    def apply_gc(
        self,
        jobs: Optional[List[Tuple[str, str]]] = None,
        evals: Optional[List[str]] = None,
        allocs: Optional[List[str]] = None,
        deployments: Optional[List[str]] = None,
        nodes: Optional[List[str]] = None,
    ) -> None:
        index = self.next_index()
        for aid in allocs or []:
            self.store.delete_alloc(index, aid)
        for eid in evals or []:
            self.store.delete_eval(index, eid)
        for ns, jid in jobs or []:
            self.store.delete_job(index, ns, jid)
            self.store.periodic_launch.pop((ns, jid), None)
        for did in deployments or []:
            self.store.delete_deployment(index, did)
        for nid in nodes or []:
            # The node's matrix row is freed; a later registration reuses
            # it and marks it dirty, so the next sync uploads it.
            self.heartbeater.clear_heartbeat(nid)
            self.store.delete_node(index, nid)

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
    # Leader reapers
    # ------------------------------------------------------------------

    def _run_reapers(self) -> None:
        """The failed-eval reaper, the volume-claim release and the
        periodic core GC evals, every 0.5 s (leader.go:556
        reapFailedEvaluations, volumewatcher, :686 schedulePeriodic).  The
        duplicate-blocked-eval reaper runs inline instead
        (:meth:`_cancel_duplicate_blocked`)."""
        while not self._unblock_stop.is_set():
            try:
                self._reap_once()
            except Exception:  # noqa: BLE001
                log.exception("leader reaper pass failed")
            self._unblock_stop.wait(0.5)

    def _reap_once(self) -> None:
        for ev in self.eval_broker.failed_evals():
            failed = ev.copy()
            failed.status = EvalStatus.FAILED.value
            failed.status_description = (
                "maximum attempts reached (%d)" % self.eval_broker.delivery_limit
            )
            # Follow-up eval retries the job later with a delay
            # (leader.go:573-585).
            followup = Evaluation(
                namespace=ev.namespace,
                priority=ev.priority,
                type=ev.type,
                triggered_by=EvalTrigger.FAILED_FOLLOW_UP.value,
                job_id=ev.job_id,
                status=EvalStatus.PENDING.value,
                wait_until=time.time() + self.config.failed_eval_unblock_delay,
            )
            self.store.upsert_evals(self.next_index(), [failed, followup])
            self.eval_broker.enqueue(followup)
        # Volume watcher (nomad/volumewatcher/volumes_watcher.go): release
        # claims held by terminal or vanished allocs, then unblock evals
        # that failed placement awaiting the volume.
        released = False
        for (ns, vid), vol in list(self.store.volumes.items()):
            stale = [
                aid
                for aid in list(vol.read_claims) + list(vol.write_claims)
                if (a := self.store.alloc_by_id(aid)) is None
                or a.terminal_status()
            ]
            if stale:
                self.store.release_volume_claims(
                    self.next_index(), ns, vid, stale
                )
                released = True
        if released:
            self.blocked_evals.unblock_all(self.store.latest_index)
        # Periodic core GC evals, processed by the CoreScheduler.
        now = time.time()
        if now - self._last_gc >= self.config.core_gc_interval:
            self._last_gc = now
            from ..scheduler.core import (
                CORE_JOB_DEPLOYMENT_GC,
                CORE_JOB_EVAL_GC,
                CORE_JOB_JOB_GC,
                CORE_JOB_NODE_GC,
            )

            self.apply_eval_updates([
                _core_eval(kind)
                for kind in (
                    CORE_JOB_EVAL_GC,
                    CORE_JOB_JOB_GC,
                    CORE_JOB_DEPLOYMENT_GC,
                    CORE_JOB_NODE_GC,
                )
            ])

    # ------------------------------------------------------------------
    # Client-facing RPCs (the node agents in ``client/`` call these)
    # ------------------------------------------------------------------

    def get_alloc_fs_origin(self, alloc_id: str) -> Dict:
        """Where a (previous) allocation's files live and whether it stopped
        writing — the cross-node ephemeral-disk migration handshake
        (client/allocwatcher remote prevAllocMigrator; the reference
        streams via the FS API the same way)."""
        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None:
            return {"Addr": "", "Terminal": True}
        node = self.store.node_by_id(alloc.node_id)
        addr = ""
        if node is not None:
            addr = node_attributes(node).get("nomad.advertise.address", "")
        return {"Addr": addr, "Terminal": alloc.terminal_status()}

    def get_volume_source(
        self, namespace: str, volume_id: str
    ) -> Optional[str]:
        """Client-side volume hook resolution: registered volume id → the
        backing host-volume name nodes expose (the CSI node-stage analog;
        the reference ships mount info inside the CSI plugin RPCs)."""
        vol = self.store.volume_by_id(namespace, volume_id)
        return vol.source if vol is not None else None

    def get_client_allocs(
        self, node_id: str, min_index: int = 0, timeout: float = 30.0
    ) -> Tuple[List[Allocation], int]:
        """Blocking query for a node's allocations (Node.GetClientAllocs,
        node_endpoint.go:915): blocks until the allocs table passes
        ``min_index`` (or timeout), then returns (allocs, table_index); the
        index never goes below ``min_index``, so a watcher never goes
        backwards.  Once the server has shut down it raises, so that a
        client still watching takes its backoff instead of asking again at
        once (a query parked at shutdown returns what the store holds)."""
        if self.store.watches_closed:
            raise RuntimeError("server is shut down")
        index = self.store.wait_for_table("allocs", min_index, timeout=timeout)
        return self.store.allocs_by_node(node_id), max(index, min_index)

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


def _core_eval(kind: str) -> Evaluation:
    """A ``_core`` eval whose job id names the GC routine
    (core_sched.go job names)."""
    return Evaluation(
        namespace="-",
        priority=100,
        type="_core",
        triggered_by=EvalTrigger.SCHEDULED.value,
        job_id=kind,
        status=EvalStatus.PENDING.value,
    )


class _DryRunPlanner:
    """Planner seam for `job plan`: records plans/evals instead of
    committing (the scheduler.Harness pattern, scheduler/testing.go:83,
    used by the reference's Plan endpoint against a snapshot)."""

    def __init__(self, snapshot):
        self.snapshot = snapshot
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.updated_eval: Optional[Evaluation] = None

    def submit_plan(self, plan):
        self.plans.append(plan)
        result = PlanResult(
            node_allocation=dict(plan.node_allocation),
            node_update=dict(plan.node_update),
            node_preemptions=dict(plan.node_preemptions),
            deployment=plan.deployment,
            deployment_updates=list(plan.deployment_updates),
            alloc_index=self.snapshot.snapshot_index,
        )
        return result, None

    def update_eval(self, ev: Evaluation) -> None:
        self.updated_eval = ev

    def create_evals(self, evals: List[Evaluation]) -> None:
        self.evals.extend(evals)

    def refresh_snapshot(self):
        return self.snapshot


class _ProposedJobSnapshot:
    """Snapshot overlay that serves the PROPOSED job spec for its own id
    and delegates every other read to the pinned snapshot."""

    def __init__(self, snapshot, job: Job):
        self._snapshot = snapshot
        self._job = job

    def job_by_id(self, namespace: str, job_id: str):
        if (namespace, job_id) == (self._job.namespace, self._job.id):
            return self._job
        return self._snapshot.job_by_id(namespace, job_id)

    def __getattr__(self, name):
        return getattr(self._snapshot, name)


def _job_diff(prev: Optional[Job], new: Job) -> Dict:
    """Coarse spec diff for `job plan -diff` (structs.JobDiff trimmed to
    type + changed top-level fields)."""
    import dataclasses as _dc

    if prev is None:
        return {"Type": "Added", "Fields": []}
    a = _dc.asdict(prev)
    b = _dc.asdict(new)
    skip = {"version", "create_index", "modify_index", "job_modify_index",
            "submit_time", "status"}
    changed = sorted(
        k for k in set(a) | set(b)
        if k not in skip and a.get(k) != b.get(k)
    )
    return {"Type": "Edited" if changed else "None", "Fields": changed}
