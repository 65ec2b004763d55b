"""Core shared types for the TPU-native orchestrator.

These are the framework-wide data structures — the equivalent of the
reference's ``nomad/structs/structs.go`` (Job :3947, TaskGroup :5905,
Task :6634, Resources :1812, Node, Allocation :9092, Evaluation :10192,
Plan :10486). They are plain Python dataclasses on the host; the scheduler
never iterates them per-node — instead the state layer encodes nodes into a
dense device matrix (see ``nomad_tpu.state.matrix``) and jobs into compiled
constraint/ask tensors (see ``nomad_tpu.ops.encode``).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Identifiers / constants
# ---------------------------------------------------------------------------


_uuid_local = threading.local()


def generate_uuid() -> str:
    # Formatting os.urandom directly skips uuid.UUID's int round-trip, and
    # the entropy is pulled in per-thread 4 KiB slabs — one getrandom()
    # syscall per 256 ids instead of one per id.  Alloc/eval construction
    # sits on the hot eval path and showed the per-call syscall at ~25% of
    # busy worker samples.
    pos = getattr(_uuid_local, "pos", 4096)
    if pos >= 4096:
        _uuid_local.buf = os.urandom(4096)
        pos = 0
    _uuid_local.pos = pos + 16
    h = _uuid_local.buf[pos:pos + 16].hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


class JobType(str, enum.Enum):
    SERVICE = "service"
    BATCH = "batch"
    SYSTEM = "system"
    CORE = "_core"  # internal GC jobs (reference: nomad/core_sched.go)


class JobStatus(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DEAD = "dead"


class NodeStatus(str, enum.Enum):
    INIT = "initializing"
    READY = "ready"
    DOWN = "down"


class NodeSchedulingEligibility(str, enum.Enum):
    ELIGIBLE = "eligible"
    INELIGIBLE = "ineligible"


class AllocDesiredStatus(str, enum.Enum):
    RUN = "run"
    STOP = "stop"
    EVICT = "evict"


class AllocClientStatus(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETE = "complete"
    FAILED = "failed"
    LOST = "lost"


class EvalStatus(str, enum.Enum):
    BLOCKED = "blocked"
    PENDING = "pending"
    COMPLETE = "complete"
    FAILED = "failed"
    CANCELLED = "cancelled"


class EvalTrigger(str, enum.Enum):
    JOB_REGISTER = "job-register"
    JOB_DEREGISTER = "job-deregister"
    PERIODIC_JOB = "periodic-job"
    NODE_DRAIN = "node-drain"
    NODE_UPDATE = "node-update"
    ALLOC_STOP = "alloc-stop"
    SCHEDULED = "scheduled"
    ROLLING_UPDATE = "rolling-update"
    DEPLOYMENT_WATCHER = "deployment-watcher"
    FAILED_FOLLOW_UP = "failed-follow-up"
    MAX_PLAN_ATTEMPTS = "max-plan-attempts"
    RETRY_FAILED_ALLOC = "retry-failed-alloc"
    QUEUED_ALLOCS = "queued-allocs"
    PREEMPTION = "preemption"
    JOB_SCALING = "job-scaling"


class DeploymentStatus(str, enum.Enum):
    RUNNING = "running"
    PAUSED = "paused"
    FAILED = "failed"
    SUCCESSFUL = "successful"
    CANCELLED = "cancelled"


# Priority bounds (reference: structs.go JobMinPriority/JobMaxPriority).
JOB_MIN_PRIORITY = 1
JOB_MAX_PRIORITY = 100
JOB_DEFAULT_PRIORITY = 50
CORE_JOB_PRIORITY = JOB_MAX_PRIORITY * 2

# Reference: PreemptionConfig — an alloc is preemptible only by jobs whose
# priority exceeds its own by more than this delta (preemption.go:663).
PREEMPTION_PRIORITY_DELTA = 10


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------


@dataclass
class NetworkResource:
    """A requested/allocated network (trimmed: label + ports).

    Reference: nomad/structs/network.go — per-IP port bitmaps. Port
    *assignment* is host-side for the single chosen node; the kernel only
    checks aggregate fit (see SURVEY.md §7 hard-part b).
    """

    mode: str = "host"
    mbits: int = 0
    reserved_ports: List[int] = field(default_factory=list)
    dynamic_ports: List[str] = field(default_factory=list)  # labels
    # assigned dynamic ports (filled at placement time): label -> port
    assigned_ports: Dict[str, int] = field(default_factory=dict)

    def copy(self) -> "NetworkResource":
        return dataclasses.replace(
            self,
            reserved_ports=list(self.reserved_ports),
            dynamic_ports=list(self.dynamic_ports),
            assigned_ports=dict(self.assigned_ports),
        )


@dataclass
class RequestedDevice:
    """A device ask, e.g. ``gpu`` / ``nvidia/gpu`` count=2.

    Reference: structs.RequestedDevice; matched by DeviceChecker
    (scheduler/feasible.go:1173) and accounted by DeviceAccounter.
    """

    name: str = "gpu"
    count: int = 1
    constraints: List["Constraint"] = field(default_factory=list)
    affinities: List["Affinity"] = field(default_factory=list)


@dataclass
class Resources:
    """Task resource ask. Reference: structs.Resources (structs.go:1812)."""

    cpu: int = 100  # MHz shares
    memory_mb: int = 300
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[RequestedDevice] = field(default_factory=list)
    cores: int = 0  # reserved cores ask

    def copy(self) -> "Resources":
        return dataclasses.replace(
            self,
            networks=[n.copy() for n in self.networks],
            devices=[dataclasses.replace(d) for d in self.devices],
        )

    def add(self, other: "Resources") -> None:
        self.cpu += other.cpu
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb


@dataclass
class NodeResources:
    """Total schedulable resources of a node."""

    cpu: int = 4000
    memory_mb: int = 8192
    disk_mb: int = 100 * 1024
    networks: List[NetworkResource] = field(default_factory=list)
    # device-type name -> instance ids present on the node
    devices: Dict[str, List[str]] = field(default_factory=dict)


@dataclass
class NodeReservedResources:
    """Resources reserved for the OS/agent, subtracted from totals.

    Reference: node.ComparableReservedResources (funcs.go:131,164-173).
    """

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_ports: List[int] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Constraints / affinities / spreads
# ---------------------------------------------------------------------------


class Op(str, enum.Enum):
    """Constraint operands (reference: scheduler/feasible.go:795-860)."""

    EQ = "="
    NEQ = "!="
    LT = "<"
    LTE = "<="
    GT = ">"
    GTE = ">="
    REGEXP = "regexp"
    VERSION = "version"
    SEMVER = "semver"
    SET_CONTAINS = "set_contains"
    SET_CONTAINS_ANY = "set_contains_any"
    DISTINCT_HOSTS = "distinct_hosts"
    DISTINCT_PROPERTY = "distinct_property"
    IS_SET = "is_set"
    IS_NOT_SET = "is_not_set"


@dataclass
class Constraint:
    """``constraint { attribute = l_target; operator; value = r_target }``"""

    l_target: str = ""
    r_target: str = ""
    operand: str = Op.EQ.value

    def key(self) -> tuple:
        return (self.l_target, self.operand, self.r_target)


@dataclass
class Affinity:
    """Weighted soft constraint (reference: structs.Affinity; scored by
    NodeAffinityIterator, scheduler/rank.go:648-735)."""

    l_target: str = ""
    r_target: str = ""
    operand: str = Op.EQ.value
    weight: int = 50  # in [-100, 100], non-zero


@dataclass
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass
class Spread:
    """``spread`` stanza (reference: structs.Spread; scored by
    SpreadIterator, scheduler/spread.go)."""

    attribute: str = ""
    weight: int = 50  # in (0, 100]
    targets: List[SpreadTarget] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Job spec
# ---------------------------------------------------------------------------


@dataclass
class RestartPolicy:
    """Client-side restart policy (reference: structs.RestartPolicy)."""

    attempts: int = 2
    interval: float = 30 * 60.0
    delay: float = 15.0
    mode: str = "fail"  # "fail" | "delay"


@dataclass
class ReschedulePolicy:
    """Server-side reschedule policy (reference: structs.ReschedulePolicy;
    consumed at generic_sched.go:719-753)."""

    attempts: int = 0
    interval: float = 0.0
    delay: float = 30.0
    delay_function: str = "exponential"  # constant|exponential|fibonacci
    max_delay: float = 3600.0
    unlimited: bool = True


@dataclass
class MigrateStrategy:
    """Drain pacing (reference: structs.MigrateStrategy; consumed by
    nomad/drainer/watch_jobs.go)."""

    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time: float = 10.0
    healthy_deadline: float = 5 * 60.0


@dataclass
class UpdateStrategy:
    """Rolling-update config (reference: structs.UpdateStrategy; driven by
    nomad/deploymentwatcher/)."""

    max_parallel: int = 0  # 0 disables deployments
    health_check: str = "checks"
    min_healthy_time: float = 10.0
    healthy_deadline: float = 5 * 60.0
    progress_deadline: float = 10 * 60.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0
    stagger: float = 30.0


@dataclass
class EphemeralDisk:
    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False


@dataclass
class VolumeRequest:
    """A task group's volume ask (jobspec ``volume`` block; reference:
    structs.VolumeRequest).  type "host" binds a node host_volumes entry by
    name; type "csi" binds a registered Volume (structs.CSIVolume) whose
    claims the control plane tracks."""

    name: str = ""
    type: str = "host"  # "host" | "csi"
    source: str = ""
    read_only: bool = False
    per_alloc: bool = False


@dataclass
class VolumeMount:
    """Task-level mount of a group volume (structs.VolumeMount)."""

    volume: str = ""
    destination: str = ""
    read_only: bool = False


@dataclass
class Volume:
    """A registered cluster volume — the CSI-volume analog without an
    external plugin daemon (reference: structs.CSIVolume + csi_volumes
    table, nomad/state/schema.go; claims nomad/csi_endpoint.go).

    ``source`` names the host-volume entry nodes must expose; the
    schedulability contract lives in ``access_mode`` + the claim tables."""

    id: str = ""
    name: str = ""
    namespace: str = "default"
    plugin_id: str = "host"
    source: str = ""
    access_mode: str = "single-node-writer"  # | multi-node-reader | multi-node-multi-writer
    attachment_mode: str = "file-system"
    capacity_mb: int = 0
    # alloc_id -> node_id claim tables (CSIVolume.ReadAllocs/WriteAllocs).
    read_claims: Dict[str, str] = field(default_factory=dict)
    write_claims: Dict[str, str] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def __post_init__(self) -> None:
        if not self.id:
            self.id = generate_uuid()
        if not self.name:
            self.name = self.id
        if not self.source:
            self.source = self.name

    def exclusive_writer(self) -> bool:
        return self.access_mode == "single-node-writer"

    def claimable(self, read_only: bool) -> bool:
        """Can another alloc claim this volume now?  (WriteFreeClaims,
        structs.CSIVolume).  Reader-only access modes never admit
        writers."""
        if read_only:
            return True
        if self.access_mode == "multi-node-multi-writer":
            return True
        if self.access_mode == "single-node-writer":
            return not self.write_claims
        return False


@dataclass
class ScalingPolicy:
    """Horizontal group-count scaling bounds + autoscaler policy document
    (reference: structs.ScalingPolicy, nomad/structs/structs.go; stored in
    the scaling_policy table, nomad/state/schema.go:85-901).  Declared on
    a task group (jobspec ``scaling`` block); enforced by Job.Scale."""

    min: int = 0
    max: int = 0
    enabled: bool = True
    # Opaque autoscaler configuration (cooldown, checks...) — carried, not
    # interpreted, exactly like the reference.
    policy: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ScalingEvent:
    """One entry in a group's scaling history (structs.ScalingEvent;
    scaling_event table)."""

    time: float = 0.0
    count: Optional[int] = None
    previous_count: int = 0
    message: str = ""
    error: bool = False
    eval_id: str = ""
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PeriodicConfig:
    """Cron-style launch config (reference: structs.PeriodicConfig;
    nomad/periodic.go)."""

    enabled: bool = True
    spec: str = ""  # cron expression
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    time_zone: str = "UTC"


@dataclass
class Service:
    name: str = ""
    port_label: str = ""
    tags: List[str] = field(default_factory=list)
    checks: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class Task:
    name: str = "task"
    driver: str = "mock"
    config: Dict[str, Any] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    services: List[Service] = field(default_factory=list)
    kill_timeout: float = 5.0
    leader: bool = False
    lifecycle_hook: str = ""  # "" (main) | "prestart" | "poststart" | "poststop"
    lifecycle_sidecar: bool = False
    artifacts: List[Dict[str, Any]] = field(default_factory=list)
    templates: List[Dict[str, Any]] = field(default_factory=list)
    # Where a dispatched parameterized job's payload lands in the task dir
    # (structs.DispatchPayloadConfig): {"file": "input.json"} → local/.
    dispatch_payload: Optional[Dict[str, str]] = None
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    # Log rotation caps (structs.LogConfig; client/logmon/):
    # {"max_files": N, "max_file_size_mb": M}.  None = defaults (10 x 10MB).
    logs: Optional[Dict[str, int]] = None


@dataclass
class TaskGroup:
    name: str = "group"
    count: int = 1
    tasks: List[Task] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    migrate_strategy: MigrateStrategy = field(default_factory=MigrateStrategy)
    update: Optional[UpdateStrategy] = None
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    networks: List[NetworkResource] = field(default_factory=list)
    stop_after_client_disconnect: Optional[float] = None
    scaling: Optional[ScalingPolicy] = None
    volumes: Dict[str, VolumeRequest] = field(default_factory=dict)

    def combined_resources(self) -> Resources:
        """Aggregate ask across tasks (+ ephemeral disk), the unit the fit
        kernel sees. Reference: BinPackIterator sums task asks per TG
        (scheduler/rank.go:210-480)."""
        total = Resources(cpu=0, memory_mb=0, disk_mb=0)
        for t in self.tasks:
            total.add(t.resources)
        total.disk_mb += self.ephemeral_disk.size_mb
        return total

    def combined_devices(self) -> Dict[str, int]:
        asks: Dict[str, int] = {}
        for t in self.tasks:
            for d in t.resources.devices:
                asks[d.name] = asks.get(d.name, 0) + d.count
        return asks


@dataclass
class Job:
    id: str = ""
    name: str = ""
    namespace: str = "default"
    type: str = JobType.SERVICE.value
    priority: int = JOB_DEFAULT_PRIORITY
    datacenters: List[str] = field(default_factory=lambda: ["dc1"])
    region: str = "global"
    task_groups: List[TaskGroup] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    periodic: Optional[PeriodicConfig] = None
    parameterized: Optional[Dict[str, Any]] = None
    all_at_once: bool = False
    stop: bool = False
    status: str = JobStatus.PENDING.value
    version: int = 0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0
    submit_time: float = 0.0
    parent_id: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    # Dispatch payload (base64; structs.Job.Payload) — set on the CHILD of
    # a parameterized job by Job.Dispatch, written into the task dir by
    # the dispatch-payload task hook.
    payload: str = ""

    def __post_init__(self) -> None:
        if not self.id:
            self.id = generate_uuid()
        if not self.name:
            self.name = self.id

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def is_periodic(self) -> bool:
        return self.periodic is not None and self.periodic.enabled

    def is_parameterized(self) -> bool:
        return self.parameterized is not None

    def stopped(self) -> bool:
        return self.stop

    def copy(self) -> "Job":
        # Deep-ish copy sufficient for versioning semantics.
        import copy as _copy

        return _copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class DriverInfo:
    detected: bool = True
    healthy: bool = True


@dataclass
class Node:
    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    resources: NodeResources = field(default_factory=NodeResources)
    reserved: NodeReservedResources = field(default_factory=NodeReservedResources)
    status: str = NodeStatus.READY.value
    scheduling_eligibility: str = NodeSchedulingEligibility.ELIGIBLE.value
    drain: bool = False
    drain_strategy: Optional["DrainStrategy"] = None
    drivers: Dict[str, DriverInfo] = field(default_factory=dict)
    host_volumes: Dict[str, str] = field(default_factory=dict)  # name -> path
    create_index: int = 0
    modify_index: int = 0
    status_updated_at: float = 0.0

    def __post_init__(self) -> None:
        if not self.id:
            self.id = generate_uuid()
        if not self.name:
            self.name = f"node-{self.id[:8]}"

    def ready(self) -> bool:
        return (
            self.status == NodeStatus.READY.value
            and not self.drain
            and self.scheduling_eligibility == NodeSchedulingEligibility.ELIGIBLE.value
        )

    def comparable_resources(self) -> Resources:
        """Total minus reserved (reference: funcs.go:130-131)."""
        return Resources(
            cpu=self.resources.cpu - self.reserved.cpu,
            memory_mb=self.resources.memory_mb - self.reserved.memory_mb,
            disk_mb=self.resources.disk_mb - self.reserved.disk_mb,
        )

    def terminal(self) -> bool:
        return self.status == NodeStatus.DOWN.value


@dataclass
class DrainStrategy:
    deadline: float = 60 * 60.0  # seconds; <0 means force-drain immediately
    ignore_system_jobs: bool = False
    force_deadline: float = 0.0  # absolute time when deadline hits


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


@dataclass
class RescheduleEvent:
    reschedule_time: float = 0.0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay: float = 0.0


@dataclass
class RescheduleTracker:
    events: List[RescheduleEvent] = field(default_factory=list)


@dataclass
class DesiredTransition:
    """Server-requested transition (reference: structs.DesiredTransition;
    set in batches by the drainer, nomad/drainer/drainer.go:357)."""

    migrate: Optional[bool] = None
    reschedule: Optional[bool] = None
    force_reschedule: Optional[bool] = None

    def should_migrate(self) -> bool:
        return bool(self.migrate)

    def should_force_reschedule(self) -> bool:
        return bool(self.force_reschedule)


@dataclass
class AllocDeploymentStatus:
    healthy: Optional[bool] = None
    timestamp: float = 0.0
    canary: bool = False


@dataclass
class TaskState:
    state: str = "pending"  # pending | running | dead
    failed: bool = False
    restarts: int = 0
    started_at: float = 0.0
    finished_at: float = 0.0
    events: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class AllocMetric:
    """Per-placement scoring telemetry — first-class introspection data.

    Reference: structs.AllocMetric (structs.go:9807): nodes evaluated /
    filtered / exhausted counts plus per-node score breakdown, surfaced by
    ``alloc status -verbose``.
    """

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: Dict[str, int] = field(default_factory=dict)  # dc -> count
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    quota_exhausted: List[str] = field(default_factory=list)
    # node_id -> {score_name: value}
    scores: Dict[str, Dict[str, float]] = field(default_factory=dict)
    allocation_time: float = 0.0
    coalesced_failures: int = 0

    def exhausted_node(self, node_id: str, dimension: str) -> None:
        self.nodes_exhausted += 1
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + 1
            )

    def filter_node(self, node_id: str, constraint: str) -> None:
        self.nodes_filtered += 1
        if constraint:
            self.constraint_filtered[constraint] = (
                self.constraint_filtered.get(constraint, 0) + 1
            )

    def score_node(self, node_id: str, name: str, score: float) -> None:
        self.scores.setdefault(node_id, {})[name] = score

    def copy(self) -> "AllocMetric":
        import copy as _copy

        return _copy.deepcopy(self)


@dataclass
class Allocation:
    id: str = ""
    namespace: str = "default"
    eval_id: str = ""
    name: str = ""  # job.name[tg][index]
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    resources: Resources = field(default_factory=Resources)
    desired_status: str = AllocDesiredStatus.RUN.value
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)
    client_status: str = AllocClientStatus.PENDING.value
    client_description: str = ""
    task_states: Dict[str, TaskState] = field(default_factory=dict)
    deployment_id: str = ""
    deployment_status: Optional[AllocDeploymentStatus] = None
    previous_allocation: str = ""
    next_allocation: str = ""
    reschedule_tracker: Optional[RescheduleTracker] = None
    follow_up_eval_id: str = ""
    metrics: AllocMetric = field(default_factory=AllocMetric)
    # ports actually assigned on the chosen node: {task: {label: port}}
    assigned_ports: Dict[str, Dict[str, int]] = field(default_factory=dict)
    assigned_devices: Dict[str, List[str]] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0
    create_time: float = 0.0
    modify_time: float = 0.0

    def __post_init__(self) -> None:
        if not self.id:
            self.id = generate_uuid()

    @property
    def index(self) -> int:
        """The per-TG index parsed from the alloc name ``job[tg][i]``."""
        try:
            return int(self.name.rsplit("[", 1)[1].rstrip("]"))
        except (IndexError, ValueError):
            return 0

    def terminal_status(self) -> bool:
        """Reference: Allocation.TerminalStatus — desired stop/evict OR
        client terminal."""
        if self.desired_status in (
            AllocDesiredStatus.STOP.value,
            AllocDesiredStatus.EVICT.value,
        ):
            return True
        return self.client_terminal()

    def client_terminal(self) -> bool:
        return self.client_status in (
            AllocClientStatus.COMPLETE.value,
            AllocClientStatus.FAILED.value,
            AllocClientStatus.LOST.value,
        )

    def ran_successfully(self) -> bool:
        return self.client_status == AllocClientStatus.COMPLETE.value

    def fail_time(self) -> float:
        """When this alloc last failed — latest task finish, falling back to
        modify/create time. Anchors reschedule backoff (reference:
        Allocation.LastEventTime / NextRescheduleTime, structs.go)."""
        latest = 0.0
        for ts in self.task_states.values():
            latest = max(latest, ts.finished_at)
        return latest or self.modify_time or self.create_time

    def migrate_disk(self) -> bool:
        if self.job is None:
            return False
        tg = self.job.lookup_task_group(self.task_group)
        return tg is not None and tg.ephemeral_disk.migrate

    def copy(self) -> "Allocation":
        import copy as _copy

        return _copy.deepcopy(self)

    def job_priority(self) -> int:
        return self.job.priority if self.job else JOB_DEFAULT_PRIORITY


# ---------------------------------------------------------------------------
# Evaluation / Plan
# ---------------------------------------------------------------------------


@dataclass
class Evaluation:
    id: str = ""
    namespace: str = "default"
    priority: int = JOB_DEFAULT_PRIORITY
    type: str = JobType.SERVICE.value  # scheduler type
    triggered_by: str = EvalTrigger.JOB_REGISTER.value
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EvalStatus.PENDING.value
    status_description: str = ""
    wait_until: float = 0.0  # absolute time for delayed evals
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    # For blocked evals: which computed classes were (in)eligible at block time
    # (reference: Evaluation.ClassEligibility / EscapedComputedClass,
    #  nomad/blocked_evals.go keying).
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    quota_limit_reached: str = ""
    # tg name -> count of allocs that could not be placed
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    # tg name -> metric for failed placement
    failed_tg_allocs: Dict[str, AllocMetric] = field(default_factory=dict)
    annotate_plan: bool = False
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time: float = 0.0
    leader_ack: str = ""  # broker token

    def __post_init__(self) -> None:
        if not self.id:
            self.id = generate_uuid()
        if not self.create_time:
            self.create_time = time.time()

    def copy(self) -> "Evaluation":
        """Copy with fresh mutable containers (no dict aliasing between the
        copy and the original)."""
        new = Evaluation(**self.__dict__)
        new.class_eligibility = dict(self.class_eligibility)
        new.queued_allocations = dict(self.queued_allocations)
        new.failed_tg_allocs = dict(self.failed_tg_allocs)
        return new

    def terminal_status(self) -> bool:
        return self.status in (
            EvalStatus.COMPLETE.value,
            EvalStatus.FAILED.value,
            EvalStatus.CANCELLED.value,
        )

    def should_enqueue(self) -> bool:
        return self.status == EvalStatus.PENDING.value

    def should_block(self) -> bool:
        return self.status == EvalStatus.BLOCKED.value


@dataclass
class Plan:
    """A proposed state mutation from one scheduler invocation.

    Reference: structs.Plan (structs.go:10486): per-node alloc additions
    (NodeAllocation), stops/evictions (NodeUpdate), preemptions, plus job and
    eval metadata. Verified by the plan applier against the freshest snapshot
    (nomad/plan_apply.go:400) before commit.
    """

    eval_id: str = ""
    priority: int = JOB_DEFAULT_PRIORITY
    job: Optional[Job] = None
    # node_id -> new/updated allocs to place on that node
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node_id -> allocs to stop/evict on that node
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node_id -> allocs preempted to make room
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    # metadata-only alloc updates (e.g. follow_up_eval_id on failed allocs
    # awaiting a delayed reschedule) — applied by the applier but excluded
    # from usage accounting and commit-completeness checks
    alloc_updates: List[Allocation] = field(default_factory=list)
    deployment: Optional["Deployment"] = None
    deployment_updates: List["DeploymentStatusUpdate"] = field(default_factory=list)
    annotations: Optional[Dict[str, Any]] = None
    all_at_once: bool = False
    eval_token: str = ""
    snapshot_index: int = 0

    def is_no_op(self) -> bool:
        return (
            not self.node_allocation
            and not self.node_update
            and not self.alloc_updates
            and not self.deployment_updates
            and self.deployment is None
        )

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_stopped_alloc(self, alloc: Allocation, desc: str, client_status: str = "") -> None:
        stopped = alloc.copy()
        stopped.desired_status = AllocDesiredStatus.STOP.value
        stopped.desired_description = desc
        if client_status:
            stopped.client_status = client_status
        stopped.job = None  # normalized: job known from plan
        self.node_update.setdefault(alloc.node_id, []).append(stopped)

    def append_preempted_alloc(self, alloc: Allocation, preempting_alloc_id: str) -> None:
        evicted = alloc.copy()
        evicted.desired_status = AllocDesiredStatus.EVICT.value
        evicted.desired_description = (
            f"Preempted by alloc ID {preempting_alloc_id}"
        )
        evicted.job = None
        self.node_preemptions.setdefault(alloc.node_id, []).append(evicted)


@dataclass
class PlanResult:
    """What the applier actually committed (may be a partial commit).

    Reference: structs.PlanResult; RefreshIndex drives scheduler retry on
    partial commit (nomad/plan_apply.go:166-178).
    """

    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional["Deployment"] = None
    deployment_updates: List["DeploymentStatusUpdate"] = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0

    def full_commit(self, plan: Plan) -> tuple:
        expected = sum(len(a) for a in plan.node_allocation.values())
        actual = sum(len(a) for a in self.node_allocation.values())
        return expected == actual, expected, actual


# ---------------------------------------------------------------------------
# Deployment
# ---------------------------------------------------------------------------


@dataclass
class DeploymentState:
    """Per-TG deployment progress (reference: structs.DeploymentState)."""

    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: List[str] = field(default_factory=list)
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline: float = 0.0
    require_progress_by: float = 0.0


@dataclass
class Deployment:
    id: str = ""
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_create_index: int = 0
    task_groups: Dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DeploymentStatus.RUNNING.value
    status_description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def __post_init__(self) -> None:
        if not self.id:
            self.id = generate_uuid()

    def active(self) -> bool:
        return self.status in (
            DeploymentStatus.RUNNING.value,
            DeploymentStatus.PAUSED.value,
        )

    def requires_promotion(self) -> bool:
        return any(
            s.desired_canaries > 0 and not s.promoted
            for s in self.task_groups.values()
        )

    def has_auto_promote(self) -> bool:
        return all(
            s.auto_promote for s in self.task_groups.values() if s.desired_canaries > 0
        ) and any(s.desired_canaries > 0 for s in self.task_groups.values())


@dataclass
class DeploymentStatusUpdate:
    deployment_id: str = ""
    status: str = ""
    status_description: str = ""


# ---------------------------------------------------------------------------
# Scheduler configuration (runtime knobs held in replicated state;
# reference: structs.SchedulerConfiguration, nomad/structs/operator.go)
# ---------------------------------------------------------------------------


@dataclass
class PreemptionConfig:
    system_scheduler_enabled: bool = True
    batch_scheduler_enabled: bool = False
    service_scheduler_enabled: bool = False


@dataclass
class SchedulerConfiguration:
    scheduler_algorithm: str = "binpack"  # "binpack" | "spread"
    preemption_config: PreemptionConfig = field(default_factory=PreemptionConfig)
    memory_oversubscription_enabled: bool = False


# ---------------------------------------------------------------------------
# ACL (reference: acl/policy.go policy documents; structs.ACLPolicy /
# ACLToken, nomad/structs/structs.go; token resolution nomad/acl.go)
# ---------------------------------------------------------------------------


@dataclass
class ACLPolicy:
    name: str = ""
    description: str = ""
    rules: str = ""  # HCL policy document (acl/policy.go grammar subset)
    create_index: int = 0
    modify_index: int = 0


@dataclass
class ACLToken:
    accessor_id: str = field(default_factory=generate_uuid)
    secret_id: str = field(default_factory=generate_uuid)
    name: str = ""
    type: str = "client"  # "client" | "management"
    policies: List[str] = field(default_factory=list)
    global_: bool = True
    create_time: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    def is_management(self) -> bool:
        return self.type == "management"
