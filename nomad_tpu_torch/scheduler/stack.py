"""Selection stacks — host orchestration of the vectorized ranking pipeline.

The reference's GenericStack is a 14-iterator pull chain walking sampled
nodes one at a time (scheduler/stack.go:324-417, sampling at :78-91). Here a
``select`` call compiles the task group once (ops/encode.py), builds the
plan-adjusted proposed usage, and invokes one fused kernel
(ops/kernels.py) that scores **all** nodes and places N allocs
in one kernel launch — the sampling trade-off disappears because scoring
the full cluster is one pass over the card-resident matrix.

Host-side residue (SURVEY.md §7 hard-part b): combinatorial port/device
*assignment* happens only for the chosen node; non-vectorizable constraints
are evaluated per computed class (feasible_host.py); a rare post-check
failure masks the node and re-runs the kernel.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import trace
from ..ops.encode import (
    CompiledTaskGroup,
    MAX_SPREAD_VALUES,
    RequestEncoder,
    pow2_bucket as _pow2_bucket,
)
from ..ops import kernels
from ..state.matrix import DEVICE_LOCK, NodeMatrix, node_attributes, stable_hash
from ..structs.types import (
    Allocation,
    AllocMetric,
    Job,
    Node,
    Op,
    TaskGroup,
)
from .context import EvalContext
from .feasible_host import check_constraint_host, check_host_volumes

# Dynamic port range (reference: structs/network.go MinDynamicPort/MaxDynamicPort).
from ..state.matrix import MAX_DYNAMIC_PORT, MIN_DYNAMIC_PORT  # noqa: E402
# (canonical port-range constants live beside the port bitmap encoding)

# Placement chunk ceiling: the scan length of one dispatch (the JAX package
# bounds its jit cache to lengths {1, 2, 4, 8, 16} with it).
PLACEMENT_CHUNK = 16
# Bound on kernel re-entries after host-side rejections (gone node, port
# conflict) or preemption-assisted picks.
MAX_SELECT_RETRIES = 8

# Solo-path occupancy ratchet (mirrors DeviceCoalescer._features): the
# Features bucket widens monotonically across the process, as the JAX
# package's does.  Mutated only on the device thread (dev_op closures run
# serialized).
_solo_features: Optional[kernels.Features] = None


def _ratchet_features(request) -> kernels.Features:
    global _solo_features
    feats = kernels.features_of(request)
    _solo_features = (
        feats if _solo_features is None else _solo_features.widen(feats)
    )
    return _solo_features


def _dense_used0(arrays, deltas: Dict[int, np.ndarray]) -> torch.Tensor:
    """Proposed base usage: matrix usage + sparse per-row plan deltas (a
    new tensor; the rows are distinct, so ``index_add_`` needs no order).
    Device code — call on the device thread (dev_op closures)."""
    used0 = arrays.used.clone()
    if deltas:
        dev = used0.device
        rows = np.fromiter(deltas.keys(), np.int64)
        dvals = np.stack([deltas[r] for r in rows]).astype(np.float32)
        used0.index_add_(0, torch.from_numpy(rows).to(dev),
                         torch.from_numpy(dvals).to(dev))
    return used0


def _full_mask(n: int, host_mask: Optional[np.ndarray]) -> np.ndarray:
    """host_mask with the all-pass default materialized."""
    return host_mask if host_mask is not None else np.ones((n,), bool)


def _pad_width(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad a node-axis array to width ``n`` — the matrix can grow between
    building host inputs and the dev_op running on the device thread; new
    rows get the conservative fill (False/0: not host-checked this round)."""
    if arr.shape[0] >= n:
        return arr
    out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
    out[: arr.shape[0]] = arr
    return out


@dataclass
class SelectionOption:
    """One placement decision (reference: rank.RankedNode)."""

    node_id: str
    node: Node
    row: int
    final_score: float
    binpack_score: float
    needs_preempt: bool
    metric: AllocMetric = field(default_factory=AllocMetric)
    # task -> {label: port} assigned host-side for the chosen node
    assigned_ports: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # Fused-path advisory: the device's sequential cross-lane AllocsFit
    # verdict for this placement (False = an earlier lane in the same
    # launch claimed the capacity — the applier will reject this plan at an
    # unchanged matrix version).  None on the staged/solo paths.
    fit_verified: Optional[bool] = None




class GenericStack:
    """Service/batch ranking stack (reference: stack.go:324-417)."""

    def __init__(
        self,
        ctx: EvalContext,
        matrix: NodeMatrix,
        algorithm: str = "binpack",
        preemption_enabled: bool = False,
        batch: bool = False,
    ):
        self.ctx = ctx
        self.matrix = matrix
        self.algorithm = algorithm
        self.preemption_enabled = preemption_enabled
        self.batch = batch
        # Shared, matrix-lifetime encoder: stacks are rebuilt per eval, so a
        # per-stack encoder would discard the compile cache every eval.
        self.encoder: RequestEncoder = matrix.shared_encoder()
        self.job: Optional[Job] = None
        # Eligibility telemetry consumed by blocked-eval creation
        # (reference: EvalEligibility, context.go:190; fills the eval's
        # ClassEligibility / EscapedComputedClass fields).
        self.class_eligibility: Dict[str, bool] = {}
        self.escaped_computed_class = False
        # Alloc ids this pass is replacing or stopping — the ONLY live
        # volume claims a new placement may look through (set_replaced).
        self.replaced_allocs: set = set()

    def set_job(self, job: Job) -> None:
        self.job = job

    def set_replaced(self, alloc_ids) -> None:
        """Declare the allocs this scheduling pass replaces/stops; their
        volume claims don't block placement (the reconciler releases them
        in the same plan)."""
        self.replaced_allocs = set(alloc_ids)

    def _record_eligibility(self, class_elig: np.ndarray, host_mask) -> None:
        for key, cid in self.matrix.class_ids.items():
            if cid < len(class_elig):
                self.class_eligibility[key] = bool(class_elig[cid])
        if host_mask is not None:
            # Per-node (class-unhashable) checks were in play — the eval
            # escapes class caching and must retry on any capacity change.
            self.escaped_computed_class = True

    # -- proposed-state assembly -------------------------------------------

    def _plan_usage_deltas(self) -> Dict[int, np.ndarray]:
        """Net (cpu, mem, disk) the in-flight plan adds per node row."""
        deltas: Dict[int, np.ndarray] = {}
        plan = self.ctx.plan

        def add(node_id: str, res, sign: float) -> None:
            row = self.matrix.row_of.get(node_id)
            if row is None:
                return
            d = deltas.setdefault(row, np.zeros(3, np.float32))
            d += sign * np.array([res.cpu, res.memory_mb, res.disk_mb], np.float32)

        for node_id, allocs in plan.node_allocation.items():
            for a in allocs:
                add(node_id, a.resources, 1.0)
        for node_id, allocs in plan.node_update.items():
            for a in allocs:
                add(node_id, a.resources, -1.0)
        for node_id, allocs in plan.node_preemptions.items():
            for a in allocs:
                add(node_id, a.resources, -1.0)
        return deltas

    def _tg_counts(self, job: Job, tg: TaskGroup) -> Dict[int, int]:
        """Proposed allocs of this job+TG per node row (JobAntiAffinity and
        distinct_hosts inputs)."""
        counts: Dict[int, int] = {}
        plan = self.ctx.plan
        removed = self.ctx.plan_removed_ids()
        for a in self.ctx.snapshot.allocs_by_job(job.namespace, job.id):
            if a.terminal_status() or a.id in removed or a.task_group != tg.name:
                continue
            row = self.matrix.row_of.get(a.node_id)
            if row is not None:
                counts[row] = counts.get(row, 0) + 1
        for node_id, allocs in plan.node_allocation.items():
            n = sum(1 for a in allocs if a.task_group == tg.name)
            if n:
                row = self.matrix.row_of.get(node_id)
                if row is not None:
                    counts[row] = counts.get(row, 0) + n
        return counts

    def _spread_counts(
        self, job: Job, tg: TaskGroup, compiled: CompiledTaskGroup
    ) -> np.ndarray:
        """(S, V) usage counts per attribute value, aligned/extended against
        the compiled s_value_hash table (propertyset.go usage tracking)."""
        req = compiled.request
        s_hash = req.s_value_hash.copy()
        counts = np.zeros_like(s_hash, np.float32)
        if not compiled.spreads:
            return counts
        removed = self.ctx.plan_removed_ids()
        live = [
            a
            for a in self.ctx.snapshot.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status() and a.id not in removed
            and a.task_group == tg.name
        ]
        for allocs in self.ctx.plan.node_allocation.values():
            live.extend(a for a in allocs if a.task_group == tg.name)
        for si, sp in enumerate(compiled.spreads[: s_hash.shape[0]]):
            if req.s_slot[si] < 0:
                continue
            name = sp.attribute
            if name.startswith("${") and name.endswith("}"):
                name = name[2:-1]
            if name.startswith("attr."):
                name = name[len("attr.") :]
            for a in live:
                node = self.ctx.snapshot.node_by_id(a.node_id)
                if node is None:
                    continue
                value = node_attributes(node).get(name)
                if not value:
                    continue
                h = stable_hash(value)
                idx = np.where(s_hash[si] == h)[0]
                if idx.size:
                    counts[si, idx[0]] += 1.0
                else:
                    free = np.where(s_hash[si] == 0)[0]
                    if free.size:
                        s_hash[si, free[0]] = h
                        counts[si, free[0]] = 1.0
        # persist discovered values into the request copy used by the kernel
        compiled.request = req._replace(s_value_hash=s_hash)
        return counts

    def _class_eligibility(self, compiled: CompiledTaskGroup) -> np.ndarray:
        """Evaluate escaped non-unique constraints once per computed class
        (the ComputedClass cache, feasible.go:1029). Returns a padded bool
        vector indexed by class id."""
        n_classes = max(1, len(self.matrix.class_ids))
        pad = _pow2_bucket(n_classes)
        elig = np.ones((pad,), bool)
        escaped = [
            e.constraint
            for e in compiled.escaped
            if not e.unique
            and e.constraint.operand
            not in (Op.DISTINCT_HOSTS.value, Op.DISTINCT_PROPERTY.value)
        ]
        if not escaped:
            return elig
        for cid, rep_node_id in self.matrix.class_repr.items():
            node = self.ctx.snapshot.node_by_id(rep_node_id)
            if node is None:
                continue
            ok = all(check_constraint_host(c, node) for c in escaped)
            if cid < pad:
                elig[cid] = ok
        return elig

    def _volume_claimable(self, vol, vreq, job: Job) -> bool:
        """Do the volume's live claims admit this request?  Claims from
        terminal (or vanished) allocs don't count — the volume watcher
        releases them lazily; claims from allocs this pass replaces/stops
        (set_replaced) don't block their own replacement.  A blanket
        same-job exemption would let two LIVE allocs of one job
        double-claim a single-node-writer volume."""
        if vreq.read_only or vol.access_mode == "multi-node-multi-writer":
            return True
        if vol.access_mode != "single-node-writer":
            return False  # reader-only volume cannot take a writer
        snap = self.ctx.snapshot
        for alloc_id in vol.write_claims:
            a = snap.alloc_by_id(alloc_id) if hasattr(
                snap, "alloc_by_id"
            ) else None
            if a is None or a.terminal_status():
                continue
            if alloc_id in self.replaced_allocs:
                continue
            return False
        return True

    def _host_mask(
        self, job: Job, tg: TaskGroup, compiled: CompiledTaskGroup
    ) -> Optional[np.ndarray]:
        """Per-node mask for unique-attr escapes, distinct_hosts,
        distinct_property, host volumes, and escaped device asks. None when
        nothing applies (the common case — no O(N) host walk)."""
        n = self.matrix.capacity
        mask: Optional[np.ndarray] = None

        def ensure() -> np.ndarray:
            nonlocal mask
            if mask is None:
                mask = np.ones((n,), bool)
            return mask

        unique = [e.constraint for e in compiled.escaped if e.unique]
        distinct_hosts = any(
            e.constraint.operand == Op.DISTINCT_HOSTS.value for e in compiled.escaped
        )
        distinct_props = [
            e.constraint
            for e in compiled.escaped
            if e.constraint.operand == Op.DISTINCT_PROPERTY.value
        ]

        # Registered-volume feasibility (CSIVolumeChecker, feasible.go:209):
        # the volume must exist, its claims must admit this request, and
        # only nodes exposing its backing host volume qualify.
        csi_sources: List[str] = []
        for vreq in compiled.csi_volumes:
            vol = self.ctx.snapshot.volume_by_id(job.namespace, vreq.source)
            if vol is None or not self._volume_claimable(vol, vreq, job):
                return np.zeros((n,), bool)  # nothing feasible → blocked
            csi_sources.append(vol.source)

        if (
            unique or compiled.host_volumes or csi_sources
            or compiled.escaped_devices or compiled.dc_escaped
        ):
            m = ensure()
            dcs = set(job.datacenters)
            for node_id, row in self.matrix.row_of.items():
                node = self.ctx.snapshot.node_by_id(node_id)
                if node is None:
                    m[row] = False
                    continue
                if compiled.dc_escaped and node.datacenter not in dcs:
                    m[row] = False
                    continue
                if unique and not all(
                    check_constraint_host(c, node) for c in unique
                ):
                    m[row] = False
                    continue
                if compiled.host_volumes and not check_host_volumes(
                    node, compiled.host_volumes
                ):
                    m[row] = False
                    continue
                if csi_sources and not check_host_volumes(
                    node, csi_sources
                ):
                    m[row] = False
                    continue
                for name, count in compiled.escaped_devices:
                    if len(node.resources.devices.get(name, [])) < count:
                        m[row] = False
                        break

        if distinct_hosts:
            # Mask nodes already holding a proposed alloc of this job
            # (DistinctHostsIterator, feasible.go:505).
            m = ensure()
            removed = self.ctx.plan_removed_ids()
            for a in self.ctx.snapshot.allocs_by_job(job.namespace, job.id):
                if a.terminal_status() or a.id in removed:
                    continue
                row = self.matrix.row_of.get(a.node_id)
                if row is not None:
                    m[row] = False
            for node_id, allocs in self.ctx.plan.node_allocation.items():
                if allocs:
                    row = self.matrix.row_of.get(node_id)
                    if row is not None:
                        m[row] = False

        for con in distinct_props:
            # DistinctPropertyIterator (feasible.go:604): limit allocs of the
            # job per distinct value of the property.
            m = ensure()
            limit = int(con.r_target) if str(con.r_target).isdigit() else 1
            name = con.l_target
            if name.startswith("${") and name.endswith("}"):
                name = name[2:-1]
            if name.startswith("attr."):
                name = name[len("attr.") :]
            counts: Dict[str, int] = {}
            removed = self.ctx.plan_removed_ids()
            live = [
                a
                for a in self.ctx.snapshot.allocs_by_job(job.namespace, job.id)
                if not a.terminal_status() and a.id not in removed
            ]
            for allocs in self.ctx.plan.node_allocation.values():
                live.extend(allocs)
            for a in live:
                anode = self.ctx.snapshot.node_by_id(a.node_id)
                if anode is None:
                    continue
                v = node_attributes(anode).get(name)
                if v:
                    counts[v] = counts.get(v, 0) + 1
            for node_id, row in self.matrix.row_of.items():
                node = self.ctx.snapshot.node_by_id(node_id)
                if node is None:
                    continue
                v = node_attributes(node).get(name)
                if v is not None and counts.get(v, 0) >= limit:
                    m[row] = False
        return mask

    # -- port assignment (host-side, chosen node only) ----------------------

    def _assign_ports(
        self, node: Node, tg: TaskGroup, extra_used: Optional[set] = None
    ) -> Optional[Dict[str, Dict[str, int]]]:
        """Assign reserved + dynamic ports on the chosen node; None on
        conflict (NetworkIndex equivalent, nomad/structs/network.go:35).
        ``extra_used``: ports handed out earlier in the same select batch,
        before the plan reflects them."""
        if not tg.networks and not any(
            t.resources.networks for t in tg.tasks
        ):
            # No port asks — skip the proposed-allocs walk entirely.  That
            # walk (every live alloc on the node, through the MVCC snapshot
            # wrapper) was the single hottest worker frame for port-less
            # jobs, which place on every node the kernel picks.
            return {}
        used = set(node.reserved.reserved_ports)
        if extra_used:
            used |= extra_used
        for a in self.ctx.proposed_allocs(node.id):
            for nets in a.assigned_ports.values():
                used.update(nets.values())
            for net in a.resources.networks:
                used.update(net.reserved_ports)

        result: Dict[str, Dict[str, int]] = {}
        nets = list(tg.networks) + [
            n for t in tg.tasks for n in t.resources.networks
        ]
        owners = ["group"] * len(tg.networks) + [
            t.name for t in tg.tasks for _ in t.resources.networks
        ]
        cursor = MIN_DYNAMIC_PORT
        for net, owner in zip(nets, owners):
            ports: Dict[str, int] = {}
            for port in net.reserved_ports:
                if port in used:
                    return None
                used.add(port)
                ports[str(port)] = port
            for label in net.dynamic_ports:
                while cursor in used and cursor <= MAX_DYNAMIC_PORT:
                    cursor += 1
                if cursor > MAX_DYNAMIC_PORT:
                    return None
                used.add(cursor)
                ports[label] = cursor
            if ports:
                result.setdefault(owner, {}).update(ports)
        return result

    # -- the main entry ------------------------------------------------------

    def select(
        self,
        tg: TaskGroup,
        n_placements: int = 1,
        penalty_nodes: Optional[Sequence[str]] = None,
        restrict_nodes: Optional[Sequence[str]] = None,
    ) -> List[Optional[SelectionOption]]:
        """Place ``n_placements`` allocs of ``tg``; one option (or None) per
        requested placement (reference: stack.go:117-179 Select, called per
        missing alloc from generic_sched.go:472).  ``restrict_nodes`` limits
        candidates to the given set (sticky ephemeral-disk preference,
        generic_sched.go:756-770 findPreferredNode).

        With a coalescer attached to the matrix (the live server), the
        kernel call is batched with other workers' selects and this method
        never touches the device directly; otherwise the whole selection
        holds DEVICE_LOCK (tests, solo tools)."""
        if getattr(self.matrix, "coalescer", None) is not None:
            return self._select_locked(
                tg, n_placements, penalty_nodes, restrict_nodes
            )
        with DEVICE_LOCK:
            return self._select_locked(
                tg, n_placements, penalty_nodes, restrict_nodes
            )

    # -- kernel dispatch (coalesced or solo) --------------------------------

    def _dispatch_place(
        self,
        compiled: CompiledTaskGroup,
        deltas: Dict[int, np.ndarray],
        tg_count: np.ndarray,
        spread_counts: np.ndarray,
        penalty: np.ndarray,
        class_elig: np.ndarray,
        host_mask: Optional[np.ndarray],
        remaining: int,
    ):
        """Run one placement scan; returns host-side arrays (rows, scores,
        binpack, preempted, n_eval, n_filt, n_exh, fit_verified) of scan
        length ≥ the bucket for ``remaining``.  fit_verified is None unless
        the fused path supplied its cross-lane verify column."""
        from .coalescer import MAX_DELTA_ROWS

        # One consistent width for every per-node array in this request:
        # re-reading matrix.capacity here could disagree with the shapes the
        # caller built if a node registration grew the matrix mid-select.
        n = tg_count.shape[0]
        coal = getattr(self.matrix, "coalescer", None)
        if coal is not None and len(deltas) <= MAX_DELTA_ROWS:
            drows = np.full((MAX_DELTA_ROWS,), -1, np.int32)
            dvals = np.zeros((MAX_DELTA_ROWS, 3), np.float32)
            for i, (row, d) in enumerate(deltas.items()):
                drows[i] = row
                dvals[i] = d
            out = coal.place(
                compiled.request,
                drows,
                dvals,
                tg_count,
                spread_counts,
                penalty,
                class_elig,
                host_mask if host_mask is not None
                else self.matrix.shared_masks()[1],
                n_live=remaining,
            )
            return (
                out.rows, out.scores, out.binpack, out.preempted,
                out.nodes_evaluated, out.nodes_filtered, out.nodes_exhausted,
                out.fit_verified,
            )

        # Solo path (more than MAX_DELTA_ROWS plan deltas, or no
        # coalescer): the same fused_place kernel at B=1 with the dense
        # proposed usage as its base.  With a coalescer present (live
        # server) the closure still executes on ITS thread.
        def dev_op():
            arrays = self.matrix.sync()
            n_dev = int(arrays.used.shape[0])
            dev = arrays.used.device
            bucket = min(_pow2_bucket(remaining), PLACEMENT_CHUNK)
            feats = _ratchet_features(compiled.request)

            def on_dev(arr):
                return torch.from_numpy(np.array(arr, copy=True)).to(dev)

            result = kernels.place_task_group(
                arrays,
                compiled.request,
                _dense_used0(arrays, deltas),
                on_dev(_pad_width(tg_count, n_dev, 0).astype(np.int32)),
                on_dev(spread_counts.astype(np.float32)),
                on_dev(_pad_width(penalty, n_dev, False)),
                on_dev(class_elig),
                on_dev(_pad_width(_full_mask(n, host_mask), n_dev, False)),
                n_placements=bucket,
                features=feats,
            )
            return (
                result.rows, result.scores, result.binpack,
                result.preempted, result.nodes_evaluated,
                result.nodes_filtered, result.nodes_exhausted,
                None,
            )

        return self.matrix.run_on_device(dev_op)

    def _select_locked(
        self,
        tg: TaskGroup,
        n_placements: int = 1,
        penalty_nodes: Optional[Sequence[str]] = None,
        restrict_nodes: Optional[Sequence[str]] = None,
    ) -> List[Optional[SelectionOption]]:
        assert self.job is not None, "set_job first"
        job = self.job
        start = time.monotonic()

        sched_cfg = self.ctx.snapshot.scheduler_config()
        with trace.span("sched.encode"):
            compiled = self.encoder.compile(
                job,
                tg,
                algorithm=self.algorithm,
                preemption_enabled=self.preemption_enabled,
            )

        n = self.matrix.capacity

        if penalty_nodes:
            penalty = np.zeros((n,), bool)
            for node_id in penalty_nodes:
                row = self.matrix.row_of.get(node_id)
                if row is not None:
                    penalty[row] = True
        else:
            # Steady state: no penalized nodes — reuse the matrix-wide
            # read-only all-False mask instead of allocating per eval.
            penalty = self.matrix.shared_masks()[0]

        with trace.span("sched.feasibility"):
            class_elig = self._class_eligibility(compiled)
            base_host_mask = self._host_mask(job, tg, compiled)
        self._record_eligibility(class_elig, base_host_mask)
        if restrict_nodes is not None:
            allowed = np.zeros((n,), bool)
            for node_id in restrict_nodes:
                row = self.matrix.row_of.get(node_id)
                if row is not None:
                    allowed[row] = True
            base_host_mask = (
                allowed if base_host_mask is None
                else (base_host_mask & allowed)
            )

        options: List[Optional[SelectionOption]] = []
        banned_rows: List[int] = []
        # Accounting for selections made in *earlier kernel calls of this
        # select()*: the plan only learns about them after select returns, so
        # later chunks/retries must fold them in here to avoid over-commit.
        chosen_rows: List[int] = []
        chosen_ports: Dict[str, set] = {}
        remaining = n_placements
        retries = 0
        while remaining > 0 and retries <= MAX_SELECT_RETRIES:
            host_mask = base_host_mask
            if banned_rows:
                host_mask = (
                    np.ones((n,), bool) if host_mask is None else host_mask.copy()
                )
                host_mask[banned_rows] = False

            deltas = self._plan_usage_deltas()
            for row in chosen_rows:
                d = deltas.setdefault(row, np.zeros(3, np.float32))
                d += np.asarray(compiled.request.ask, np.float32)

            tg_counts = self._tg_counts(job, tg)
            for row in chosen_rows:
                tg_counts[row] = tg_counts.get(row, 0) + 1
            if tg_counts:
                tg_count = np.zeros((n,), np.int32)
                for row, c in tg_counts.items():
                    tg_count[row] = c
            else:
                # First placement pass of a fresh job: no proposed allocs
                # anywhere — reuse the matrix-wide read-only zero vector.
                tg_count = self.matrix.shared_zero_i32()

            spread_counts = self._spread_counts(job, tg, compiled)

            # Binpack + score are fused into the placement kernel, so one
            # span covers the whole device dispatch (launch + result wait).
            with trace.span("sched.dispatch", lanes=remaining):
                (rows_all, scores_all, binpack_all, preempted_all, n_eval_all,
                 n_filt_all, n_exh_all, verified_all) = self._dispatch_place(
                    compiled, deltas, tg_count, spread_counts, penalty,
                    class_elig, host_mask, remaining,
                )
            take = min(len(rows_all), remaining)
            rows_out = rows_all[:take]
            scores = scores_all[:take]
            binpack = binpack_all[:take]
            preempted = preempted_all[:take]
            n_eval = n_eval_all[:take]
            n_filt = n_filt_all[:take]
            n_exh = n_exh_all[:take]

            retry = False
            for i, row in enumerate(rows_out):
                metric = AllocMetric(
                    nodes_evaluated=int(n_eval[i]),
                    nodes_filtered=int(n_filt[i]),
                    nodes_exhausted=int(n_exh[i]),
                )
                metric.allocation_time = time.monotonic() - start
                if row < 0:
                    options.append(None)
                    remaining -= 1
                    continue
                node_id = self.matrix.node_of.get(int(row))
                node = (
                    self.ctx.snapshot.node_by_id(node_id) if node_id else None
                )
                if node is None:
                    banned_rows.append(int(row))
                    retries += 1
                    retry = True
                    break
                # Host-side combinatorial residue: port assignment, aware of
                # ports handed out earlier in this same batch.
                ports = self._assign_ports(
                    node, tg, extra_used=chosen_ports.get(node_id)
                )
                if ports is None:
                    banned_rows.append(int(row))
                    retries += 1
                    retry = True
                    break
                metric.score_node(node_id, "binpack", float(binpack[i]))
                metric.score_node(node_id, "final", float(scores[i]))
                opt = SelectionOption(
                    node_id=node_id,
                    node=node,
                    row=int(row),
                    final_score=float(scores[i]),
                    binpack_score=float(binpack[i]),
                    needs_preempt=bool(preempted[i]),
                    metric=metric,
                    assigned_ports=ports,
                    fit_verified=(
                        bool(verified_all[i])
                        if verified_all is not None else None
                    ),
                )
                options.append(opt)
                chosen_rows.append(int(row))
                if ports:
                    bag = chosen_ports.setdefault(node_id, set())
                    for per_task in ports.values():
                        bag.update(per_task.values())
                remaining -= 1
                if bool(preempted[i]):
                    # A preemption-assisted pick changes proposed state in a
                    # way the in-scan accounting can't see (victims are chosen
                    # host-side afterwards); re-enter conservatively — the
                    # chosen_rows delta keeps this node's ask accounted.
                    retries += 1
                    retry = True
                    break
            if not retry:
                # Results beyond `take` from this chunk are discarded;
                # remaining placements loop around with updated accounting.
                continue

        while len(options) < n_placements:
            options.append(None)
        return options


