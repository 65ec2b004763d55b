"""Compile a (job, task-group) into dense tensors for the scheduling kernels.

The reference resolves constraints per node per eval via reflection and string
parsing (scheduler/feasible.go:709-1020 ConstraintChecker, resolveTarget
:748). Here, a task group is compiled *once* into fixed-shape arrays — slots
into the node matrix's attribute columns plus op codes — and the kernel
evaluates every node in one pass. Operators that cannot vectorize (regexp,
set_contains, lexical string order) escape to a host-side per-computed-class
check (mirroring the reference's class cache, feasible.go:1029).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

# Compile-time attribute recorder: maps an attribute name to its slot
# (None = unregistered).  The encoder threads one through constraint and
# affinity encoding so computed-class keys record what they depend on.
AttrRecorder = Callable[[str], Optional[int]]

import numpy as np

from ..state.matrix import (
    DEVICE_SLOTS,
    PORT_BITS,
    NodeMatrix,
    numeric_value,
    priority_bucket,
    stable_hash,
    version_value,
)
from ..structs.types import (
    Affinity,
    Constraint,
    Job,
    Op,
    Spread,
    TaskGroup,
    PREEMPTION_PRIORITY_DELTA,
)

# Fixed request widths (shape-stable for jit caching; see SURVEY.md §7
# hard-part e — p99 < 5ms requires avoiding recompilation).
MAX_CONSTRAINTS = 16
MAX_AFFINITIES = 8
MAX_DATACENTERS = 8
MAX_SPREADS = 2
MAX_SPREAD_VALUES = 16
MAX_STATIC_PORTS = 8

# Kernel op codes.
OP_EQ = 0
OP_NEQ = 1
OP_LT = 2
OP_LTE = 3
OP_GT = 4
OP_GTE = 5
OP_IS_SET = 6
OP_IS_NOT_SET = 7
# Version ops compare the attr_ver column (packed major*1e6+minor*1e3+patch),
# never the plain-numeric column — "2.0" is 2.0 as a number but 2000000 as a
# version, and both sides of a comparison must use the same encoding.
OP_VER_EQ = 8
OP_VER_LT = 9
OP_VER_LTE = 10
OP_VER_GT = 11
OP_VER_GTE = 12

_NUMERIC_OPS = {
    Op.LT.value: OP_LT,
    Op.LTE.value: OP_LTE,
    Op.GT.value: OP_GT,
    Op.GTE.value: OP_GTE,
}

_VERSION_RE = re.compile(r"^\s*(>=|<=|>|<|=)?\s*v?(\d+(?:\.\d+){0,2})\s*$")


def pow2_bucket(n: int) -> int:
    """Round a count up to a power of two. Used for every padded shape that
    feeds a jit'd kernel (placement-scan lengths, class-eligibility vectors)
    so the jit cache stays bounded (SURVEY.md §7 hard-part e). The single
    source of truth — stack and parallel batch-building must agree."""
    return 1 << max(0, (n - 1)).bit_length()


class SchedRequest(NamedTuple):
    """Device-side encoding of one task-group placement ask."""

    ask: np.ndarray  # (3,) f32 cpu/mem/disk
    c_slot: np.ndarray  # (C,) i32, -1 = inactive
    c_op: np.ndarray  # (C,) i32
    c_hash: np.ndarray  # (C,) i32
    c_num: np.ndarray  # (C,) f32
    dc_hash: np.ndarray  # (DC,) i32, 0 padded
    dev_ask: np.ndarray  # (D,) i32
    algorithm: np.ndarray  # () i32: 0 binpack, 1 spread
    desired_count: np.ndarray  # () f32 — TG count (anti-affinity denominator)
    a_slot: np.ndarray  # (A,) i32, -1 = inactive
    a_op: np.ndarray  # (A,) i32
    a_hash: np.ndarray  # (A,) i32
    a_num: np.ndarray  # (A,) f32
    a_weight: np.ndarray  # (A,) f32
    s_slot: np.ndarray  # (S,) i32, -1 = inactive
    s_weight: np.ndarray  # (S,) f32
    s_even: np.ndarray  # (S,) bool — even-spread mode
    s_value_hash: np.ndarray  # (S, V) i32 — known values (targets), 0 padded
    s_desired: np.ndarray  # (S, V) f32 — desired count per target value
    s_implicit: np.ndarray  # (S,) f32 — implicit-target desired count (NaN none)
    s_sum_weights: np.ndarray  # () f32
    preempt_bucket: np.ndarray  # () i32 — victims strictly below; -1 disabled
    # () bool — job carries a distinct_hosts constraint: nodes with any
    # proposed alloc of this job+TG (tg_count > 0) are hard-infeasible, so the
    # placement scan cannot stack allocs on one node between host-mask
    # refreshes (DistinctHostsIterator, feasible.go:505).
    distinct_hosts: np.ndarray
    # Port feasibility (NetworkIndex, structs/network.go:35): requested
    # static ports (-1 pad; only ports < PORT_BITS encoded — the rest are
    # host-verified) and the dynamic-port ask count.
    p_static: np.ndarray  # (P,) i32
    p_dyn: np.ndarray  # () i32


class RequestSlab:
    """Preallocated ``(B, …)`` operand slab for batched request encoding.

    The coalescer's old per-dispatch ``tree_map(np.stack)`` allocated ~25
    fresh arrays per launch.  The slab instead writes each lane's
    :class:`SchedRequest` into row ``i`` of persistent ``(B, …)`` buffers
    and hands the SAME request-of-buffers pytree to the kernel every
    dispatch — no per-launch allocation, stable shapes for the jit cache.

    Rows past the live count keep their previous (valid) contents — dead
    lanes are masked by ``lane_mask``/``host_mask``, never decoded into
    results — and the whole slab is broadcast-initialized from the first
    request filled so even a cold slab holds well-formed rows.  Buffers are
    rebuilt only if a field's trailing shape shifts (encoder version
    change)."""

    def __init__(self, lanes: int):
        self.lanes = int(lanes)
        self._bufs: Optional[SchedRequest] = None

    def _build(self, proto: SchedRequest) -> SchedRequest:
        fields = [np.asarray(f) for f in proto]
        bufs = SchedRequest(*[
            np.empty((self.lanes,) + f.shape, f.dtype) for f in fields
        ])
        for buf, f in zip(bufs, fields):
            buf[:] = f  # broadcast: every row starts as a valid request
        return bufs

    def fill(self, i: int, req: SchedRequest) -> None:
        """Write ``req`` into lane row ``i`` (rebuilds on shape drift)."""
        bufs = self._bufs
        if bufs is None or any(
            buf.shape[1:] != np.asarray(f).shape
            for buf, f in zip(bufs, req)
        ):
            bufs = self._bufs = self._build(req)
        for buf, f in zip(bufs, req):
            buf[i] = f

    def batch(self) -> SchedRequest:
        """The full (B, …) stacked request pytree (call after fill)."""
        assert self._bufs is not None, "fill at least one lane first"
        return self._bufs

    def live_view(self, k: int) -> SchedRequest:
        """Zero-copy views of the first ``k`` (live) rows — what occupancy
        measurement (kernels.features_of) should see, not stale tails."""
        assert self._bufs is not None, "fill at least one lane first"
        return SchedRequest(*[buf[:k] for buf in self._bufs])

    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._bufs) if self._bufs else 0


@dataclass
class EscapedConstraint:
    """A constraint the kernel can't evaluate; checked host-side per class
    (or per node for unique attrs)."""

    constraint: Constraint
    unique: bool = False  # targets a node-unique attribute


@dataclass
class CompiledTaskGroup:
    request: SchedRequest
    escaped: List[EscapedConstraint] = field(default_factory=list)
    # Device asks that overflowed the DeviceRegistry — must be checked
    # host-side against node.resources.devices (no silent drop).
    escaped_devices: List[Tuple[str, int]] = field(default_factory=list)
    # True when job.datacenters overflowed MAX_DATACENTERS; the kernel then
    # skips the dc check (sentinel) and the host filters by datacenter.
    dc_escaped: bool = False
    # host-only soft metadata
    spreads: List[Spread] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    drivers: List[str] = field(default_factory=list)
    host_volumes: List[str] = field(default_factory=list)
    # Registered-volume asks (type "csi"): checked host-side against the
    # volume table's claims (stack._host_mask; HostVolumeChecker /
    # CSIVolumeChecker, feasible.go:132,209).
    csi_volumes: List["VolumeRequest"] = field(default_factory=list)
    # Every attr/device slot resolution this compilation made, including
    # failed ones (None = registry exhausted at compile time).  A cache hit
    # is valid iff each resolution still holds — so entries survive registry
    # GROWTH (new nodes registering unrelated attrs), which the old
    # len(slot_of) cache-key term treated as a full invalidation.
    attr_guard: List[Tuple[str, Optional[int]]] = field(default_factory=list)
    dev_guard: List[Tuple[str, Optional[int]]] = field(default_factory=list)


def _resolve_attr_name(target: str) -> Optional[str]:
    """``${attr.foo}`` / ``${node.class}`` / ``${meta.x}`` → attribute name
    (reference: feasible.go resolveTarget:748-790)."""
    if not target:
        return None
    name = target
    if name.startswith("${") and name.endswith("}"):
        name = name[2:-1]
    if name.startswith("attr."):
        name = name[len("attr.") :]
    return name


def _encode_version_operand(r_target: str) -> Optional[Tuple[int, float]]:
    """``>= 1.2.3`` → (op, packed numeric). Multi-clause falls to host."""
    if "," in r_target:
        return None
    m = _VERSION_RE.match(r_target)
    if not m:
        return None
    comparator = m.group(1) or "="
    packed = version_value(m.group(2))
    if math.isnan(packed):
        return None
    op = {
        ">=": OP_VER_GTE,
        "<=": OP_VER_LTE,
        ">": OP_VER_GT,
        "<": OP_VER_LT,
        "=": OP_VER_EQ,
    }[comparator]
    return op, packed


class RequestEncoder:
    """Compiles task groups against a NodeMatrix's registries.

    Compilation results are cached per (job id, version, tg name) — the
    reference re-runs constraint parsing per eval; we pay it once.  Cached
    entries carry slot guards (attr_guard/dev_guard) instead of keying on
    registry size: steady-state evals hit the cache even while node
    registrations keep growing the attr registry.
    """

    def __init__(self, matrix: NodeMatrix):
        self.matrix = matrix
        self._cache: Dict[tuple, CompiledTaskGroup] = {}
        # Cost attribution (ints under the GIL): a miss is a full
        # constraint re-parse, the per-eval host tax the cache exists to
        # avoid.  Surfaced as nomad.kernel.compile_cache{result=...}.
        self.cache_hits = 0
        self.cache_misses = 0

    def compile(
        self,
        job: Job,
        tg: TaskGroup,
        algorithm: str = "binpack",
        preemption_enabled: bool = False,
    ) -> CompiledTaskGroup:
        key = (job.id, job.version, tg.name, algorithm, preemption_enabled)
        hit = self._cache.get(key)
        if hit is not None and self._guard_valid(hit):
            self.cache_hits += 1
            return hit
        self.cache_misses += 1
        compiled = self._compile(job, tg, algorithm, preemption_enabled)
        self._cache[key] = compiled
        return compiled

    def _guard_valid(self, compiled: CompiledTaskGroup) -> bool:
        """True while every slot resolution the compile made still holds
        (registries are append-only, so in practice this only fails across
        a matrix rebuild)."""
        slot_of = self.matrix.attrs.slot_of
        for name, slot in compiled.attr_guard:
            if slot_of.get(name) != slot:
                return False
        for name, slot in compiled.dev_guard:
            if self.matrix.devices.lookup(name) != slot:
                return False
        return True

    def _compile(
        self,
        job: Job,
        tg: TaskGroup,
        algorithm: str,
        preemption_enabled: bool,
    ) -> CompiledTaskGroup:
        attrs = self.matrix.attrs
        attr_guard: List[Tuple[str, Optional[int]]] = []
        dev_guard: List[Tuple[str, Optional[int]]] = []

        def reg_attr(name: str) -> Optional[int]:
            slot = attrs.register(name)
            attr_guard.append((name, slot))
            return slot

        # Constraint set = job + tg + all tasks (reference: stack.go SetJob /
        # feasibility wrapper collects all levels).
        constraints: List[Constraint] = list(job.constraints) + list(tg.constraints)
        drivers: List[str] = []
        for task in tg.tasks:
            constraints.extend(task.constraints)
            if task.driver and task.driver not in drivers:
                drivers.append(task.driver)

        c_slot = np.full((MAX_CONSTRAINTS,), -1, np.int32)
        c_op = np.zeros((MAX_CONSTRAINTS,), np.int32)
        c_hash = np.zeros((MAX_CONSTRAINTS,), np.int32)
        c_num = np.full((MAX_CONSTRAINTS,), np.nan, np.float32)
        escaped: List[EscapedConstraint] = []
        ci = 0

        def emit(slot: int, op: int, h: int = 0, num: float = math.nan) -> bool:
            nonlocal ci
            if ci >= MAX_CONSTRAINTS:
                return False
            c_slot[ci] = slot
            c_op[ci] = op
            c_hash[ci] = h
            c_num[ci] = num
            ci += 1
            return True

        # Driver feasibility = constraint driver.<name> is set & truthy
        # (reference: DriverChecker feasible.go:433; matrix stores "1" only
        # for detected+healthy drivers).
        for drv in drivers:
            slot = reg_attr(f"driver.{drv}")
            if slot is not None:
                emit(slot, OP_EQ, stable_hash("1"))

        for con in constraints:
            if not self._encode_constraint(con, emit, escaped, reg_attr):
                escaped.append(self._escape(con))

        # Datacenter membership (reference: readyNodesInDCs, scheduler/util.go).
        # Jobs with more datacenters than the encoding holds escape to a
        # host-side dc filter; dc_hash[0] == -1 tells the kernel to skip.
        dc_hash = np.zeros((MAX_DATACENTERS,), np.int32)
        dc_escaped = len(job.datacenters) > MAX_DATACENTERS
        if dc_escaped:
            dc_hash[0] = -1
        else:
            for i, dc in enumerate(job.datacenters):
                dc_hash[i] = stable_hash(dc)

        # Devices. Registry overflow escapes to a host-side per-node check.
        dev_ask = np.zeros((DEVICE_SLOTS,), np.int32)
        escaped_devices: List[Tuple[str, int]] = []
        for name, count in tg.combined_devices().items():
            slot = self.matrix.devices.register(name)
            dev_guard.append((name, slot))
            if slot is not None:
                dev_ask[slot] += count
            else:
                escaped_devices.append((name, count))

        # Affinities: job + tg + tasks (reference: rank.go:678-696).
        affinities: List[Affinity] = (
            list(job.affinities)
            + list(tg.affinities)
            + [a for t in tg.tasks for a in t.affinities]
        )
        a_slot = np.full((MAX_AFFINITIES,), -1, np.int32)
        a_op = np.zeros((MAX_AFFINITIES,), np.int32)
        a_hash = np.zeros((MAX_AFFINITIES,), np.int32)
        a_num = np.full((MAX_AFFINITIES,), np.nan, np.float32)
        a_weight = np.zeros((MAX_AFFINITIES,), np.float32)
        ai = 0
        for aff in affinities[:MAX_AFFINITIES]:
            enc = self._encode_predicate(
                aff.l_target, aff.operand, aff.r_target, reg_attr
            )
            if enc is None:
                continue  # non-vectorizable affinity: skipped (soft signal)
            slot, op, h, num = enc
            a_slot[ai], a_op[ai], a_hash[ai], a_num[ai] = slot, op, h, num
            a_weight[ai] = float(aff.weight)
            ai += 1

        # Spreads: job + tg (reference: spread.go computeSpreadInfo).
        spreads: List[Spread] = list(tg.spreads) + list(job.spreads)
        s_slot = np.full((MAX_SPREADS,), -1, np.int32)
        s_weight = np.zeros((MAX_SPREADS,), np.float32)
        s_even = np.zeros((MAX_SPREADS,), bool)
        s_value_hash = np.zeros((MAX_SPREADS, MAX_SPREAD_VALUES), np.int32)
        s_desired = np.full((MAX_SPREADS, MAX_SPREAD_VALUES), np.nan, np.float32)
        s_implicit = np.full((MAX_SPREADS,), np.nan, np.float32)
        sum_weights = 0.0
        total_count = float(tg.count)
        for si, sp in enumerate(spreads[:MAX_SPREADS]):
            name = _resolve_attr_name(sp.attribute)
            slot = reg_attr(name) if name else None
            if slot is None:
                continue
            s_slot[si] = slot
            s_weight[si] = float(sp.weight)
            sum_weights += float(sp.weight)
            if not sp.targets:
                s_even[si] = True
                continue
            sum_desired = 0.0
            for vi, target in enumerate(sp.targets[:MAX_SPREAD_VALUES]):
                desired = (target.percent / 100.0) * total_count
                s_value_hash[si, vi] = stable_hash(target.value)
                s_desired[si, vi] = desired
                sum_desired += desired
            if 0.0 < sum_desired < total_count:
                s_implicit[si] = total_count - sum_desired

        preempt_bucket = -1
        if preemption_enabled:
            # Victims must have priority < job.priority − delta
            # (reference: preemption.go:663).
            threshold = job.priority - PREEMPTION_PRIORITY_DELTA
            if threshold > 0:
                preempt_bucket = priority_bucket(threshold)

        # Port asks across group + task networks (stack._assign_ports is the
        # host-side assignment twin; this is the kernel-side feasibility).
        p_static = np.full((MAX_STATIC_PORTS,), -1, np.int32)
        p_dyn = 0
        pi = 0
        all_nets = list(tg.networks) + [
            n for t in tg.tasks for n in t.resources.networks
        ]
        for net in all_nets:
            p_dyn += len(net.dynamic_ports)
            for port in net.reserved_ports:
                if 0 <= port < PORT_BITS and pi < MAX_STATIC_PORTS:
                    p_static[pi] = port
                    pi += 1
                # overflow / out-of-bitmap ports are verified host-side at
                # assignment and again at plan-apply

        ask = tg.combined_resources()
        req = SchedRequest(
            ask=np.array([ask.cpu, ask.memory_mb, ask.disk_mb], np.float32),
            c_slot=c_slot,
            c_op=c_op,
            c_hash=c_hash,
            c_num=c_num,
            dc_hash=dc_hash,
            dev_ask=dev_ask,
            algorithm=np.int32(1 if algorithm == "spread" else 0),
            desired_count=np.float32(max(1.0, float(tg.count))),
            a_slot=a_slot,
            a_op=a_op,
            a_hash=a_hash,
            a_num=a_num,
            a_weight=a_weight,
            s_slot=s_slot,
            s_weight=s_weight,
            s_even=s_even,
            s_value_hash=s_value_hash,
            s_desired=s_desired,
            s_implicit=s_implicit,
            s_sum_weights=np.float32(sum_weights if sum_weights else 1.0),
            preempt_bucket=np.int32(preempt_bucket),
            distinct_hosts=np.bool_(
                any(c.operand == Op.DISTINCT_HOSTS.value for c in constraints)
            ),
            p_static=p_static,
            p_dyn=np.int32(p_dyn),
        )
        return CompiledTaskGroup(
            request=req,
            escaped=escaped,
            escaped_devices=escaped_devices,
            dc_escaped=dc_escaped,
            spreads=spreads,
            affinities=affinities,
            drivers=drivers,
            host_volumes=[
                v.source or v.name
                for v in (tg.volumes or {}).values() if v.type == "host"
            ],
            csi_volumes=[
                v for v in (tg.volumes or {}).values() if v.type == "csi"
            ],
            attr_guard=attr_guard,
            dev_guard=dev_guard,
        )

    # -- predicate encoding --------------------------------------------------

    def _escape(self, con: Constraint) -> EscapedConstraint:
        name = _resolve_attr_name(con.l_target) or ""
        unique = "unique." in name
        return EscapedConstraint(constraint=con, unique=unique)

    def _encode_constraint(self, con: Constraint, emit, escaped,
                           reg_attr: Optional[AttrRecorder] = None) -> bool:
        if con.operand in (Op.DISTINCT_HOSTS.value, Op.DISTINCT_PROPERTY.value):
            # Handled by dedicated host-side iterators (feasible.go:505,604).
            escaped.append(self._escape(con))
            return True
        enc = self._encode_predicate(
            con.l_target, con.operand, con.r_target, reg_attr
        )
        if enc is None:
            return False
        slot, op, h, num = enc
        return emit(slot, op, h, num)

    def _encode_predicate(
        self, l_target: str, operand: str, r_target: str,
        reg_attr: Optional[AttrRecorder] = None,
    ) -> Optional[Tuple[int, int, int, float]]:
        """Encode one predicate as (slot, op, hash, num); None = escape.
        ``reg_attr`` (compile-time recorder) defaults to the raw registry."""
        name = _resolve_attr_name(l_target)
        if name is None:
            return None
        register = reg_attr or self.matrix.attrs.register
        slot = register(name)
        if slot is None:
            return None  # registry exhausted — host fallback

        if operand in (Op.EQ.value, "==", "is"):
            return slot, OP_EQ, stable_hash(r_target), math.nan
        if operand in (Op.NEQ.value, "not"):
            return slot, OP_NEQ, stable_hash(r_target), math.nan
        if operand == Op.IS_SET.value:
            return slot, OP_IS_SET, 0, math.nan
        if operand == Op.IS_NOT_SET.value:
            return slot, OP_IS_NOT_SET, 0, math.nan
        if operand in _NUMERIC_OPS:
            num = numeric_value(r_target)
            if math.isnan(num):
                return None  # lexical comparison — host fallback
            return slot, _NUMERIC_OPS[operand], 0, num
        if operand in (Op.VERSION.value, Op.SEMVER.value):
            enc = _encode_version_operand(r_target)
            if enc is None:
                return None
            op, packed = enc
            return slot, op, 0, packed
        # regexp / set_contains / others: host fallback
        return None
