"""Host-side state store — the authoritative object store.

The reference keeps all cluster state in an in-memory MVCC database
(go-memdb immutable radix trees, ``nomad/state/state_store.go``, 19 tables
``nomad/state/schema.go:85-901``) replicated through Raft, with point-in-time
snapshots and blocking queries via WatchSets.

This build keeps the *discipline* and adapts the mechanism:

- **Immutability discipline.** Objects handed to the store are owned by it
  and MUST NOT be mutated afterwards; updates insert replacement copies in a
  single reference assignment (atomic under the GIL). Readers therefore never
  observe torn objects.
- **Snapshot indices, not copied tables.** ``snapshot()`` captures the
  current raft-style ``latest_index`` and reads through to the live tables.
  This is weaker than memdb's true point-in-time snapshots, but the
  reference's own architecture makes it sound: schedulers are *optimistic*
  and every plan is re-verified serially against authoritative state at
  commit time (``nomad/plan_apply.go:49-69`` design note). The applier is
  the single writer, so its view is always consistent.
- **Blocking queries.** ``wait_for_index`` blocks until the store reaches a
  raft index (the worker's snapshot-min-index sync point,
  ``nomad/worker.go:228``); table watches wake subscribers on any bump of a
  table index (memdb WatchSet equivalent, ``state_store.go:198``).

The store also forwards node/alloc deltas to the device-resident
``NodeMatrix`` so HBM state tracks the authoritative log incrementally
(SURVEY.md §7 hard-part a).
"""

from __future__ import annotations

import functools
import inspect
import threading
import time as _time
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..structs.types import (
    ACLPolicy,
    ACLToken,
    AllocClientStatus,
    AllocDesiredStatus,
    Allocation,
    Deployment,
    DesiredTransition,
    EvalStatus,
    Evaluation,
    Job,
    JobStatus,
    JobType,
    Node,
    NodeSchedulingEligibility,
    NodeStatus,
    SchedulerConfiguration,
)
from ..lint import tsan
from .matrix import NodeMatrix


def journaled(fn):
    """Journal a top-level store mutation to the attached WAL (if any).

    The append happens *before* the mutation applies (write-ahead), inside
    the store lock so the log order is the apply order.  Nested mutator
    calls (``upsert_plan_results`` → ``upsert_allocs``…), replayed
    mutations and entries applied from a leader's stream
    (:meth:`StateStore.apply_remote`) are not re-journaled.

    Mutators that stamp wall-clock times declare a keyword-only ``now``
    parameter; the wrapper resolves it *before* appending so the timestamp
    is part of the journaled args and WAL replay is deterministic (the
    reference journals timestamps inside raft request bodies for the same
    reason, e.g. structs.AllocUpdateRequest timestamps).

    With a replicator (``server/replication.py``) the entry goes to a
    quorum of peers first, with no store lock held: a write that cannot
    reach a quorum raises before anything lands in the log or the tables.
    """
    op = fn.__name__
    has_now = "now" in inspect.signature(fn).parameters

    @functools.wraps(fn)
    def wrapper(self, index, *args, **kwargs):
        # Writers serialize on _write_lock (reentrant — mutators nest);
        # _lock (the READ lock) is held only for the in-memory apply, NOT
        # across the replication quorum wait.  Without this split, every
        # read — scheduler snapshots, blocking queries, HTTP GETs — stalls
        # behind each write's network round-trip.
        with self._write_lock:
            with self._lock:
                if (
                    (self.wal is None and self.replicator is None)
                    or self._replaying
                    or self._applying_remote
                    or self._journal_depth > 0
                ):
                    return fn(self, index, *args, **kwargs)
                if has_now and kwargs.get("now") is None:
                    kwargs["now"] = _time.time()
                from ..structs import serde

                args_wire = {
                    "args": [serde.to_wire(a) for a in args],
                    "kwargs": {
                        k: serde.to_wire(v) for k, v in kwargs.items()
                    },
                }
                replicator = self.replicator
                entry = None
                if replicator is not None:
                    seq_base = (
                        self.wal.seq if self.wal is not None
                        else replicator.last_seq
                    )
                    entry = {
                        "i": index, "s": seq_base + 1, "op": op,
                        "a": args_wire,
                    }
            if replicator is not None:
                # Replicate FIRST, with no store lock held: a write that
                # cannot reach a quorum raises before anything lands
                # locally (log or tables), so an uncommitted entry can
                # never replay after a restart (commit-then-apply order;
                # replication.py).  _write_lock keeps seq assignment and
                # stream order race-free.
                replicator.replicate(entry)
            with self._lock:
                if entry is not None:
                    if self.wal is not None:
                        self.wal.append_entry(entry)
                else:
                    self.wal.append(index, op, args_wire)
                self._journal_depth += 1
                try:
                    out = fn(self, index, *args, **kwargs)
                finally:
                    self._journal_depth -= 1
                if (
                    self.wal is not None
                    and self.wal.appends_since_snapshot >= self.snapshot_every
                ):
                    self.write_snapshot()
                return out

    return wrapper


class JobSummary:
    """Per-job TG status counts (reference: structs.JobSummary, maintained by
    state-store triggers nomad/state/state_store.go setJobSummary)."""

    def __init__(self, job_id: str, namespace: str = "default"):
        self.job_id = job_id
        self.namespace = namespace
        # tg -> {queued, complete, failed, running, starting, lost}
        self.summary: Dict[str, Dict[str, int]] = {}
        self.children_pending = 0
        self.children_running = 0
        self.children_dead = 0
        self.create_index = 0
        self.modify_index = 0


class StateStore:
    """Authoritative in-memory store + device-matrix feed.

    All mutating methods take an explicit raft-style ``index`` (monotonic);
    the FSM/applier is responsible for ordering. Reads may be performed from
    any thread.
    """

    def __init__(self, matrix: Optional[NodeMatrix] = None):
        self._lock = threading.RLock()
        # Serializes top-level writers; reentrant because mutators nest
        # (@journaled).
        self._write_lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # Index watchers (worker snapshot-sync, blocking queries) wait on a
        # dedicated leaf condvar so they never contend on — nor get woken
        # into — the global store lock.  The predicate reads the
        # authoritative counters unlocked (GIL-atomic int/dict reads);
        # _bump notifies under the watch lock, which orders the notify
        # after any waiter's failed predicate check (no lost wakeups).
        self._watch_cond = threading.Condition(threading.Lock())
        # Set by close_watches() when the server shuts down: blocking
        # queries parked in wait_for_table return at once.
        self._watches_closed = False
        self.matrix = matrix if matrix is not None else NodeMatrix()
        # Replication seam (server/replication.py): when attached,
        # mutations replicate to peers before applying; _applying_remote
        # marks follower-side applies of the leader's stream.
        self.replicator = None

        # Durability seam (attach_wal): top-level mutations journal through
        # the @journaled decorator; replay suppresses re-journaling.
        self.wal = None
        self._replaying = False
        self._journal_depth = 0
        self.snapshot_every = 4096
        # Consensus seam (apply_remote): marks follower-side applies of
        # entries a leader already committed.
        self._applying_remote = False

        # Change-event stream (nomad/stream/EventBroker): mutators publish
        # as they commit; restore replay does not re-publish history.
        from ..stream import EventBroker

        self.events = EventBroker()

        self.latest_index = 0
        self._table_index: Dict[str, int] = {}

        # Primary tables (id -> object).
        self.nodes: Dict[str, Node] = {}
        self.jobs: Dict[Tuple[str, str], Job] = {}  # (namespace, id)
        self.job_versions: Dict[Tuple[str, str], List[Job]] = {}
        self.evals: Dict[str, Evaluation] = {}
        self.allocs: Dict[str, Allocation] = {}
        self.deployments: Dict[str, Deployment] = {}
        self.job_summaries: Dict[Tuple[str, str], JobSummary] = {}
        self.periodic_launch: Dict[Tuple[str, str], float] = {}
        # Scaling (nomad/state/schema.go scaling_policy + scaling_event
        # tables).  Policies are a VIEW derived from job specs (updated on
        # job upsert/delete — deterministic from job writes, so replay- and
        # replication-safe without their own journal entries); events are
        # journaled history rings keyed by (ns, job, group).
        self.scaling_policies: Dict[Tuple[str, str, str], "ScalingPolicy"] = {}
        self.scaling_events: Dict[Tuple[str, str, str], List["ScalingEvent"]] = {}
        # Registered volumes (csi_volumes table analog) by (ns, id).
        self.volumes: Dict[Tuple[str, str], "Volume"] = {}
        # Server membership (the raft configuration-change analog,
        # nomad/serf.go + RaftRemovePeer): the full member address list,
        # replicated like any write so every server converges on the same
        # peer set, and snapshot-carried so joiners learn it on catch-up.
        self.raft_peers: List[str] = []
        self.scheduler_config = SchedulerConfiguration()
        # ACL tables (acl_policy/acl_token, nomad/state/schema.go).
        self.acl_policies: Dict[str, "ACLPolicy"] = {}
        self.acl_tokens: Dict[str, "ACLToken"] = {}  # by accessor id
        self._token_by_secret: Dict[str, str] = {}
        # Namespaces (nomad/state/schema.go namespaces table); "default"
        # always exists.
        self.namespaces: Dict[str, Dict] = {
            "default": {"Name": "default", "Description": "Default namespace"}
        }

        # Secondary indexes (sets of ids).
        self._allocs_by_node: Dict[str, Set[str]] = {}
        self._allocs_by_job: Dict[Tuple[str, str], Set[str]] = {}
        self._allocs_by_eval: Dict[str, Set[str]] = {}
        self._evals_by_job: Dict[Tuple[str, str], Set[str]] = {}
        self._deployments_by_job: Dict[Tuple[str, str], Set[str]] = {}

        # MVCC version history: (table, key) -> recent replaced versions
        # (newest last).  Snapshot reads resolve objects modified after
        # their index back to the version visible at snapshot time — the
        # memdb point-in-time discipline (state_store.go:171 Snapshot)
        # with a bounded ring instead of immutable radix trees.
        self._history: Dict[Tuple[str, object], List] = {}
        self.history_depth = 4

        # TSan-lite (lint/tsan.py): wraps locks + primary tables with
        # lockset checking when a test enabled the sanitizer; one flag
        # test otherwise.
        if tsan.enabled():
            tsan.instrument("store", self)

    # ------------------------------------------------------------------
    # Index bookkeeping / blocking queries
    # ------------------------------------------------------------------

    def _bump(self, table: str, index: int) -> None:
        self.latest_index = max(self.latest_index, index)
        self._table_index[table] = max(self._table_index.get(table, 0), index)
        with self._watch_cond:
            self._watch_cond.notify_all()

    def table_index(self, table: str) -> int:
        with self._lock:
            return self._table_index.get(table, 0)

    def wait_for_index(self, index: int, timeout: Optional[float] = None) -> bool:
        """Block until ``latest_index >= index`` (worker.go:228 sync point).
        Waits on the watch condvar, NOT the store lock — a snapshot-syncing
        worker costs writers nothing while it waits."""
        if self.latest_index >= index:  # fast path: already caught up
            return True
        with self._watch_cond:
            return self._watch_cond.wait_for(
                lambda: self.latest_index >= index, timeout=timeout
            )

    def wait_for_table(
        self, table: str, min_index: int, timeout: Optional[float] = None
    ) -> int:
        """Blocking query: wait until a table index exceeds ``min_index``;
        returns the current table index (memdb WatchSet equivalent)."""
        with self._watch_cond:
            self._watch_cond.wait_for(
                lambda: self._table_index.get(table, 0) > min_index
                or self._watches_closed,
                timeout=timeout,
            )
            return self._table_index.get(table, 0)

    def close_watches(self) -> None:
        """Wake every blocking query and let later ones return at once
        (server shutdown: an HTTP handler parked in a client's blocking
        query must not hold its thread for the query's wait).  Callers
        that loop on a wait check ``watches_closed`` and stop."""
        with self._watch_cond:
            self._watches_closed = True
            self._watch_cond.notify_all()

    @property
    def watches_closed(self) -> bool:
        return self._watches_closed

    def snapshot(self) -> "StateSnapshot":
        with self._lock:
            return StateSnapshot(self, self.latest_index)

    def _push_history(self, table: str, key, prev) -> None:
        """Record a replaced/deleted version for MVCC snapshot reads.
        Ring-bounded: a snapshot older than ``history_depth`` replacements
        of one object degrades to the live read (documented staleness
        bound; evals span ~100ms while objects churn far slower)."""
        if prev is None:
            return
        ring = self._history.setdefault((table, key), [])
        ring.append(prev)
        if len(ring) > self.history_depth:
            del ring[: len(ring) - self.history_depth]
        # Amortized horizon GC: rings for long-dead keys (deleted objects
        # never touched again) are dropped once far behind the log head.
        if len(self._history) > 100_000:
            horizon = self.latest_index - 10_000
            self._history = {
                k: r
                for k, r in self._history.items()
                if r and r[-1].modify_index >= horizon
            }

    def _resolve_at(self, table: str, key, live, snap_index: int):
        """The version of (table, key) visible at ``snap_index``."""
        if live is not None and live.modify_index <= snap_index:
            return live
        for old in reversed(self._history.get((table, key), ())):
            if old.modify_index <= snap_index:
                return old
        if live is not None and live.create_index > snap_index:
            return None  # created after the snapshot
        return live  # history exhausted — bounded-staleness fallback

    def _publish(
        self, topic: str, type_: str, key: str, payload, index: int,
        namespace: str = "default",
    ) -> None:
        if self._replaying:
            return
        from ..stream import Event

        self.events.publish([
            Event(topic=topic, type=type_, key=key, namespace=namespace,
                  index=index, payload=payload)
        ])

    # ------------------------------------------------------------------
    # Nodes
    # ------------------------------------------------------------------

    @journaled
    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            prev = self.nodes.get(node.id)
            node.modify_index = index
            if prev is None:
                node.create_index = index
            else:
                node.create_index = prev.create_index
                # Registration carries the CLIENT's facts; operator state
                # is server-owned and survives re-registration (the
                # reference's Node.Register preserves drain/eligibility/
                # status, node_endpoint.go) — otherwise a periodic
                # re-fingerprint would silently cancel a drain or
                # resurrect a down-marked node.
                node.drain = prev.drain
                node.drain_strategy = prev.drain_strategy
                node.scheduling_eligibility = prev.scheduling_eligibility
                node.status = prev.status
            self._push_history("nodes", node.id, prev)
            self.nodes[node.id] = node
            self.matrix.upsert_node(node)
            self._bump("nodes", index)
            self._publish("Node", "NodeRegistration", node.id, node, index)

    @journaled
    def delete_node(self, index: int, node_id: str) -> None:
        with self._lock:
            prev = self.nodes.pop(node_id, None)
            if prev is not None:
                self._push_history("nodes", node_id, prev)
                self.matrix.remove_node(node_id)
                self._bump("nodes", index)
                self._publish(
                    "Node", "NodeDeregistered", node_id, None, index
                )

    @journaled
    def update_node_status(
        self, index: int, node_id: str, status: str, *, now: Optional[float] = None
    ) -> None:
        with self._lock:
            prev = self.nodes.get(node_id)
            if prev is None:
                return
            import copy as _copy

            node = _copy.copy(prev)
            node.status = status
            node.modify_index = index
            node.status_updated_at = now if now is not None else _time.time()
            self._push_history("nodes", node_id, prev)
            self.nodes[node_id] = node
            self.matrix.upsert_node(node)
            self._bump("nodes", index)
            self._publish("Node", "NodeStatusUpdate", node_id, node, index)

    @journaled
    def update_node_eligibility(
        self, index: int, node_id: str, eligibility: str
    ) -> None:
        with self._lock:
            prev = self.nodes.get(node_id)
            if prev is None:
                return
            import copy as _copy

            node = _copy.copy(prev)
            node.scheduling_eligibility = eligibility
            node.modify_index = index
            self._push_history("nodes", node_id, prev)
            self.nodes[node_id] = node
            self.matrix.upsert_node(node)
            self._bump("nodes", index)
            self._publish("Node", "NodeEligibility", node_id, node, index)

    @journaled
    def update_node_drain(
        self, index: int, node_id: str, drain_strategy, mark_eligible: bool = False
    ) -> None:
        with self._lock:
            prev = self.nodes.get(node_id)
            if prev is None:
                return
            import copy as _copy

            node = _copy.copy(prev)
            node.drain_strategy = drain_strategy
            node.drain = drain_strategy is not None
            if node.drain:
                node.scheduling_eligibility = (
                    NodeSchedulingEligibility.INELIGIBLE.value
                )
            elif mark_eligible:
                node.scheduling_eligibility = NodeSchedulingEligibility.ELIGIBLE.value
            node.modify_index = index
            self._push_history("nodes", node_id, prev)
            self.nodes[node_id] = node
            self.matrix.upsert_node(node)
            self._bump("nodes", index)
            self._publish("Node", "NodeDrain", node_id, node, index)

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self.nodes.get(node_id)

    def ready_nodes_in_dcs(self, datacenters: Iterable[str]) -> List[Node]:
        dcs = set(datacenters)
        return [
            n
            for n in self.nodes.values()
            if n.ready() and (not dcs or n.datacenter in dcs)
        ]

    # ------------------------------------------------------------------
    # Jobs
    # ------------------------------------------------------------------

    @journaled
    def upsert_job(self, index: int, job: Job) -> None:
        with self._lock:
            key = (job.namespace, job.id)
            prev = self.jobs.get(key)
            job.modify_index = index
            job.job_modify_index = index
            if prev is None:
                job.create_index = index
                job.version = 0
            else:
                job.create_index = prev.create_index
                if self._job_spec_changed(prev, job):
                    job.version = prev.version + 1
                else:
                    job.version = prev.version
            self._push_history("jobs", key, prev)
            self.jobs[key] = job
            versions = self.job_versions.setdefault(key, [])
            versions.append(job)
            del versions[:-6]  # JobTrackedVersions default
            if key not in self.job_summaries:
                summary = JobSummary(job.id, job.namespace)
                summary.create_index = index
                for tg in job.task_groups:
                    summary.summary[tg.name] = {}
                self.job_summaries[key] = summary
            # Refresh the scaling-policy view for this job's groups.
            for k in [p for p in self.scaling_policies if p[:2] == key]:
                del self.scaling_policies[k]
            for tg in job.task_groups:
                if tg.scaling is not None:
                    self.scaling_policies[key + (tg.name,)] = tg.scaling
            self._bump("jobs", index)
            self._publish(
                "Job", "JobRegistered", job.id, job, index, job.namespace
            )

    @staticmethod
    def _job_spec_changed(a: Job, b: Job) -> bool:
        """Conservative spec-change check driving version bumps."""
        import dataclasses

        ax = dataclasses.asdict(a)
        bx = dataclasses.asdict(b)
        for k in (
            "version",
            "create_index",
            "modify_index",
            "job_modify_index",
            "submit_time",
            "status",
        ):
            ax.pop(k, None)
            bx.pop(k, None)
        return ax != bx

    @journaled
    def delete_job(self, index: int, namespace: str, job_id: str) -> None:
        with self._lock:
            key = (namespace, job_id)
            prev = self.jobs.pop(key, None)
            if prev is not None:
                self._push_history("jobs", key, prev)
                self.job_versions.pop(key, None)
                self.job_summaries.pop(key, None)
                self.periodic_launch.pop(key, None)
                for k in [p for p in self.scaling_policies if p[:2] == key]:
                    del self.scaling_policies[k]
                for k in [p for p in self.scaling_events if p[:2] == key]:
                    del self.scaling_events[k]
                self._bump("jobs", index)
                self._publish(
                    "Job", "JobDeregistered", job_id, None, index, namespace
                )

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self.jobs.get((namespace, job_id))

    def job_version(self, namespace: str, job_id: str, version: int) -> Optional[Job]:
        for j in self.job_versions.get((namespace, job_id), []):
            if j.version == version:
                return j
        return None

    def jobs_by_namespace(self, namespace: str) -> List[Job]:
        return [j for (ns, _), j in self.jobs.items() if ns == namespace]

    def all_jobs(self) -> List[Job]:
        return list(self.jobs.values())

    # ------------------------------------------------------------------
    # Evaluations
    # ------------------------------------------------------------------

    @journaled
    def upsert_evals(self, index: int, evals: Iterable[Evaluation]) -> None:
        with self._lock:
            upserted: List[Evaluation] = []
            for ev in evals:
                upserted.append(ev)
                prev = self.evals.get(ev.id)
                ev.modify_index = index
                if prev is None:
                    ev.create_index = index
                else:
                    ev.create_index = prev.create_index
                self._push_history("evals", ev.id, prev)
                self.evals[ev.id] = ev
                self._evals_by_job.setdefault((ev.namespace, ev.job_id), set()).add(
                    ev.id
                )
            self._bump("evals", index)
            for ev in upserted:
                self._publish(
                    "Evaluation", "EvaluationUpdated", ev.id, ev, index,
                    ev.namespace,
                )

    @journaled
    def delete_eval(self, index: int, eval_id: str) -> None:
        with self._lock:
            ev = self.evals.pop(eval_id, None)
            if ev is not None:
                self._push_history("evals", eval_id, ev)
                ids = self._evals_by_job.get((ev.namespace, ev.job_id))
                if ids:
                    ids.discard(eval_id)
                self._bump("evals", index)

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self.evals.get(eval_id)

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        ids = self._evals_by_job.get((namespace, job_id), set())
        return [self.evals[i] for i in ids if i in self.evals]

    # ------------------------------------------------------------------
    # Allocations
    # ------------------------------------------------------------------

    def _index_alloc(self, alloc: Allocation) -> None:
        self._allocs_by_node.setdefault(alloc.node_id, set()).add(alloc.id)
        self._allocs_by_job.setdefault(
            (alloc.namespace, alloc.job_id), set()
        ).add(alloc.id)
        if alloc.eval_id:
            self._allocs_by_eval.setdefault(alloc.eval_id, set()).add(alloc.id)

    def _unindex_alloc(self, alloc: Allocation) -> None:
        s = self._allocs_by_node.get(alloc.node_id)
        if s:
            s.discard(alloc.id)
        s = self._allocs_by_job.get((alloc.namespace, alloc.job_id))
        if s:
            s.discard(alloc.id)
        s = self._allocs_by_eval.get(alloc.eval_id)
        if s:
            s.discard(alloc.id)

    @journaled
    def upsert_allocs(
        self, index: int, allocs: Iterable[Allocation], *, now: Optional[float] = None
    ) -> None:
        """Insert/replace allocations, keeping the device matrix in sync."""
        with self._lock:
            if now is None:
                now = _time.time()
            upserted: List[Allocation] = []
            for alloc in allocs:
                upserted.append(alloc)
                prev = self.allocs.get(alloc.id)
                alloc.modify_index = index
                if prev is None:
                    alloc.create_index = index
                    alloc.alloc_modify_index = index
                else:
                    alloc.create_index = prev.create_index
                    alloc.alloc_modify_index = index

                # Matrix delta: usage counts only while non-terminal.
                was_live = prev is not None and not prev.terminal_status()
                is_live = not alloc.terminal_status()
                if was_live and not is_live:
                    self.matrix.remove_alloc(prev)
                elif not was_live and is_live:
                    self.matrix.add_alloc(alloc)
                elif was_live and is_live and prev.node_id != alloc.node_id:
                    self.matrix.remove_alloc(prev)
                    self.matrix.add_alloc(alloc)

                if prev is not None:
                    self._unindex_alloc(prev)
                    self._push_history("allocs", alloc.id, prev)
                self.allocs[alloc.id] = alloc
                self._index_alloc(alloc)
                self._update_summary(alloc, prev, index)
                self._deployment_alloc_delta(index, alloc, prev, now)

                # Stamp the replaced alloc so it is never rescheduled twice
                # (reference: UpsertAllocs sets NextAllocation on the
                # previous alloc, nomad/state/state_store.go).
                if alloc.previous_allocation:
                    old = self.allocs.get(alloc.previous_allocation)
                    if old is not None and old.next_allocation != alloc.id:
                        import copy as _copy

                        old2 = _copy.copy(old)
                        old2.next_allocation = alloc.id
                        old2.modify_index = index
                        self._push_history("allocs", old2.id, old)
                        self.allocs[old2.id] = old2
            self._bump("allocs", index)
            for alloc in upserted:
                self._publish(
                    "Allocation", "AllocationUpdated", alloc.id, alloc,
                    index, alloc.namespace,
                )

    @journaled
    def update_allocs_from_client(
        self, index: int, updates: Iterable[Allocation], *, now: Optional[float] = None
    ) -> None:
        """Client status updates (Node.UpdateAlloc path,
        nomad/node_endpoint.go:1054): merge client fields into stored alloc."""
        with self._lock:
            merged = []
            for upd in updates:
                prev = self.allocs.get(upd.id)
                if prev is None:
                    continue
                import copy as _copy

                alloc = _copy.copy(prev)
                alloc.client_status = upd.client_status
                alloc.client_description = upd.client_description
                alloc.task_states = upd.task_states
                alloc.deployment_status = upd.deployment_status
                merged.append(alloc)
            if merged:
                self.upsert_allocs(index, merged, now=now)

    @journaled
    def delete_alloc(self, index: int, alloc_id: str) -> None:
        with self._lock:
            alloc = self.allocs.pop(alloc_id, None)
            if alloc is not None:
                self._push_history("allocs", alloc_id, alloc)
                if not alloc.terminal_status():
                    self.matrix.remove_alloc(alloc)
                self._unindex_alloc(alloc)
                self._bump("allocs", index)

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self.allocs.get(alloc_id)

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        ids = self._allocs_by_node.get(node_id, set())
        return [self.allocs[i] for i in ids if i in self.allocs]

    def allocs_by_job(
        self, namespace: str, job_id: str, anystate: bool = True
    ) -> List[Allocation]:
        ids = self._allocs_by_job.get((namespace, job_id), set())
        return [self.allocs[i] for i in ids if i in self.allocs]

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        ids = self._allocs_by_eval.get(eval_id, set())
        return [self.allocs[i] for i in ids if i in self.allocs]

    def _update_summary(
        self, alloc: Allocation, prev: Optional[Allocation], index: int
    ) -> None:
        summary = self.job_summaries.get((alloc.namespace, alloc.job_id))
        if summary is None:
            return
        tg = summary.summary.setdefault(alloc.task_group, {})

        def bucket(a: Allocation) -> Optional[str]:
            if a.desired_status == AllocDesiredStatus.RUN.value:
                return {
                    AllocClientStatus.PENDING.value: "starting",
                    AllocClientStatus.RUNNING.value: "running",
                    AllocClientStatus.COMPLETE.value: "complete",
                    AllocClientStatus.FAILED.value: "failed",
                    AllocClientStatus.LOST.value: "lost",
                }.get(a.client_status)
            return {
                AllocClientStatus.COMPLETE.value: "complete",
                AllocClientStatus.FAILED.value: "failed",
                AllocClientStatus.LOST.value: "lost",
            }.get(a.client_status)

        if prev is not None:
            b = bucket(prev)
            if b and tg.get(b, 0) > 0:
                tg[b] -= 1
        b = bucket(alloc)
        if b:
            tg[b] = tg.get(b, 0) + 1
        summary.modify_index = index

    # ------------------------------------------------------------------
    # Deployments
    # ------------------------------------------------------------------

    @journaled
    def upsert_deployment(self, index: int, deployment: Deployment) -> None:
        with self._lock:
            prev = self.deployments.get(deployment.id)
            deployment.modify_index = index
            if prev is None:
                deployment.create_index = index
            else:
                deployment.create_index = prev.create_index
            self._push_history("deployment", deployment.id, prev)
            self.deployments[deployment.id] = deployment
            self._deployments_by_job.setdefault(
                (deployment.namespace, deployment.job_id), set()
            ).add(deployment.id)
            self._bump("deployment", index)
            self._publish(
                "Deployment", "DeploymentUpserted", deployment.id,
                deployment, index, deployment.namespace,
            )

    @journaled
    def delete_deployment(self, index: int, deployment_id: str) -> None:
        with self._lock:
            d = self.deployments.pop(deployment_id, None)
            if d is not None:
                self._push_history("deployment", deployment_id, d)
                ids = self._deployments_by_job.get((d.namespace, d.job_id))
                if ids:
                    ids.discard(deployment_id)
                self._bump("deployment", index)

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self.deployments.get(deployment_id)

    def latest_deployment_by_job(
        self, namespace: str, job_id: str
    ) -> Optional[Deployment]:
        ids = self._deployments_by_job.get((namespace, job_id), set())
        best: Optional[Deployment] = None
        for i in ids:
            d = self.deployments.get(i)
            if d and (best is None or d.create_index > best.create_index):
                best = d
        return best

    def active_deployments(self) -> List[Deployment]:
        return [d for d in self.deployments.values() if d.active()]

    @journaled
    def update_deployment_status(
        self, index: int, deployment_id: str, status: str, description: str = ""
    ) -> None:
        """UpdateDeploymentStatus (state_store.go): terminal statuses detach
        the deployment from scheduling."""
        with self._lock:
            d = self.deployments.get(deployment_id)
            if d is None:
                return
            import copy as _copy

            d2 = _copy.copy(d)
            d2.status = status
            d2.status_description = description
            d2.modify_index = index
            self._push_history("deployment", deployment_id, d)
            self.deployments[deployment_id] = d2
            self._bump("deployment", index)
            self._publish(
                "Deployment", "DeploymentStatusUpdate", deployment_id, d2,
                index, d2.namespace,
            )

    @journaled
    def update_deployment_promotion(
        self, index: int, deployment_id: str, groups: Optional[List[str]] = None
    ) -> None:
        """UpdateDeploymentPromotion (state_store.go): flip promoted on the
        given TGs (all canary TGs when groups is None)."""
        with self._lock:
            d = self.deployments.get(deployment_id)
            if d is None:
                return
            import copy as _copy

            d2 = _copy.copy(d)
            d2.task_groups = {
                name: _copy.copy(st) for name, st in d.task_groups.items()
            }
            for name, st in d2.task_groups.items():
                if groups is not None and name not in groups:
                    continue
                if st.desired_canaries > 0:
                    st.promoted = True
            d2.status_description = "Deployment is running"
            d2.modify_index = index
            self._push_history("deployment", deployment_id, d)
            self.deployments[deployment_id] = d2
            self._bump("deployment", index)
            self._publish(
                "Deployment", "DeploymentPromotion", deployment_id, d2,
                index, d2.namespace,
            )

    def _deployment_alloc_delta(
        self, index: int, alloc: Allocation, prev: Optional[Allocation],
        now: float,
    ) -> None:
        """Maintain per-TG deployment counters as allocs are placed and
        report health (updateDeploymentWithAlloc, state_store.go).  Called
        under the lock from upsert_allocs."""
        if not alloc.deployment_id:
            return
        d = self.deployments.get(alloc.deployment_id)
        if d is None or not d.active():
            return
        st = d.task_groups.get(alloc.task_group)
        if st is None:
            return
        import copy as _copy

        placed_delta = 1 if prev is None else 0
        healthy_delta = unhealthy_delta = 0
        prev_h = prev.deployment_status.healthy if (
            prev is not None and prev.deployment_status is not None
        ) else None
        new_h = (
            alloc.deployment_status.healthy
            if alloc.deployment_status is not None
            else None
        )
        if prev_h is None and new_h is True:
            healthy_delta = 1
        elif prev_h is None and new_h is False:
            unhealthy_delta = 1
        if not (placed_delta or healthy_delta or unhealthy_delta):
            return
        d2 = _copy.copy(d)
        d2.task_groups = {
            name: _copy.copy(s) for name, s in d.task_groups.items()
        }
        st2 = d2.task_groups[alloc.task_group]
        st2.placed_allocs += placed_delta
        st2.healthy_allocs += healthy_delta
        st2.unhealthy_allocs += unhealthy_delta
        if placed_delta and alloc.deployment_status is not None and (
            alloc.deployment_status.canary
        ):
            st2.placed_canaries = list(st2.placed_canaries) + [alloc.id]
        if healthy_delta:
            # Health progress extends the progress deadline
            # (deployment_watcher.go progress tracking).
            st2.require_progress_by = (
                now + st2.progress_deadline
                if st2.progress_deadline
                else st2.require_progress_by
            )
        d2.modify_index = index
        self._push_history("deployment", d2.id, d)
        self.deployments[d2.id] = d2
        self._bump("deployment", index)

    @journaled
    def update_allocs_desired_transition(
        self, index: int, transitions: Dict[str, "DesiredTransition"]
    ) -> None:
        """Batched drainer stamp (AllocUpdateDesiredTransition raft apply,
        nomad/drainer/drainer.go:357)."""
        with self._lock:
            import copy as _copy

            for alloc_id, transition in transitions.items():
                prev = self.allocs.get(alloc_id)
                if prev is None or prev.terminal_status():
                    continue
                a2 = _copy.copy(prev)
                a2.desired_transition = transition
                a2.modify_index = index
                self._push_history("allocs", alloc_id, prev)
                self.allocs[alloc_id] = a2
            self._bump("allocs", index)

    # ------------------------------------------------------------------
    # Periodic launches (periodic_launch table, state_store.go)
    # ------------------------------------------------------------------

    @journaled
    def record_periodic_launch(
        self, index: int, namespace: str, job_id: str, launch_time: float
    ) -> None:
        with self._lock:
            self.periodic_launch[(namespace, job_id)] = launch_time
            self._bump("periodic_launch", index)

    # ------------------------------------------------------------------
    # Volumes (csi_volumes table + claim tracking;
    # nomad/csi_endpoint.go, nomad/state/state_store.go CSIVolumeRegister/
    # CSIVolumeClaim — trimmed to the plugin-less host-volume analog)
    # ------------------------------------------------------------------

    # Validation MUST precede the @journaled inner mutators: the wrapper
    # WAL-appends BEFORE calling fn, so a mutator that raises poisons the
    # log (replay crash-loops).
    # Public entry points therefore validate under the canonical locks and
    # only then enter the unconditional journaled twin.

    def upsert_volume(self, index: int, volume: "Volume") -> None:
        with self._write_lock, self._lock:
            prev = self.volumes.get((volume.namespace, volume.id))
            if prev is not None and (
                prev.read_claims or prev.write_claims
            ) and (
                prev.access_mode != volume.access_mode
                or prev.source != volume.source
            ):
                # The reference rejects re-registering an in-use volume
                # with changed parameters — live claims were granted
                # under the old contract.
                raise ValueError(
                    "volume is in use; access_mode/source cannot change"
                )
            self._upsert_volume(index, volume)

    @journaled
    def _upsert_volume(self, index: int, volume: "Volume") -> None:
        with self._lock:
            key = (volume.namespace, volume.id)
            prev = self.volumes.get(key)
            volume.modify_index = index
            if prev is None:
                volume.create_index = index
            else:
                volume.create_index = prev.create_index
                # Claims survive a re-register (spec updates must not
                # wipe attachment state).
                volume.read_claims = dict(prev.read_claims)
                volume.write_claims = dict(prev.write_claims)
            self._push_history("volumes", key, prev)
            self.volumes[key] = volume
            self._bump("volumes", index)
            self._publish(
                "Volume", "VolumeRegistered", volume.id, volume, index,
                volume.namespace,
            )

    def delete_volume(self, index: int, namespace: str, volume_id: str) -> None:
        with self._write_lock, self._lock:
            vol = self.volumes.get((namespace, volume_id))
            if vol is None:
                return
            if vol.read_claims or vol.write_claims:
                raise ValueError("volume is in use")
            self._delete_volume(index, namespace, volume_id)

    @journaled
    def _delete_volume(self, index: int, namespace: str, volume_id: str) -> None:
        with self._lock:
            key = (namespace, volume_id)
            vol = self.volumes.pop(key, None)
            if vol is None:
                return
            self._push_history("volumes", key, vol)
            self._bump("volumes", index)
            self._publish(
                "Volume", "VolumeDeregistered", volume_id, None, index,
                namespace,
            )

    def claim_volume(
        self, index: int, namespace: str, volume_id: str, alloc_id: str,
        node_id: str, read_only: bool,
    ) -> None:
        with self._write_lock, self._lock:
            if (namespace, volume_id) not in self.volumes:
                raise ValueError(f"unknown volume {volume_id!r}")
            self._claim_volume(
                index, namespace, volume_id, alloc_id, node_id, read_only
            )

    @journaled
    def _claim_volume(
        self, index: int, namespace: str, volume_id: str, alloc_id: str,
        node_id: str, read_only: bool,
    ) -> None:
        with self._lock:
            vol = self.volumes.get((namespace, volume_id))
            if vol is None:
                return  # volume GC'd between journal and a late replay
            table = vol.read_claims if read_only else vol.write_claims
            table[alloc_id] = node_id
            vol.modify_index = index
            self._bump("volumes", index)

    @journaled
    def release_volume_claims(
        self, index: int, namespace: str, volume_id: str,
        alloc_ids: List[str],
    ) -> None:
        with self._lock:
            vol = self.volumes.get((namespace, volume_id))
            if vol is None:
                return
            for aid in alloc_ids:
                vol.read_claims.pop(aid, None)
                vol.write_claims.pop(aid, None)
            vol.modify_index = index
            self._bump("volumes", index)

    def volume_by_id(self, namespace: str, volume_id: str) -> Optional["Volume"]:
        return self.volumes.get((namespace, volume_id))

    @journaled
    def set_raft_peers(self, index: int, addrs: List[str]) -> None:
        """Replace the replicated membership list (raft configuration
        change).  Replicated with the OLD peer set (replicate-first order
        in @journaled), then applied — so the entry commits under the
        quorum that authorized it; the snapshot image carries it as
        ``raft_peers``."""
        with self._lock:
            self.raft_peers = list(addrs)
            self._bump("raft_peers", index)
        rep = self.replicator
        if rep is not None:
            # Outside this method's own _lock block: update_peers takes
            # the replicator lock, under which the replicator never takes
            # a store lock.
            rep.update_peers(addrs)

    @journaled
    def record_scaling_event(
        self, index: int, namespace: str, job_id: str, group: str,
        event: "ScalingEvent",
    ) -> None:
        """Append to a group's scaling history (UpsertScalingEvent,
        nomad/state/state_store.go; ring capped like JobTrackedScalingEvents)."""
        with self._lock:
            ring = self.scaling_events.setdefault(
                (namespace, job_id, group), []
            )
            ring.append(event)
            del ring[:-20]
            self._bump("scaling_event", index)

    # ------------------------------------------------------------------
    # Scheduler config (raft-held runtime knobs; structs/operator.go)
    # ------------------------------------------------------------------

    @journaled
    def set_scheduler_config(self, index: int, config: SchedulerConfiguration) -> None:
        with self._lock:
            self.scheduler_config = config
            self._bump("scheduler_config", index)

    # ------------------------------------------------------------------
    # ACL (acl_policy/acl_token tables; nomad/state/state_store.go
    # UpsertACLPolicies/UpsertACLTokens/BootstrapACLTokens)
    # ------------------------------------------------------------------

    @journaled
    def upsert_acl_policy(self, index: int, policy: ACLPolicy) -> None:
        with self._lock:
            prev = self.acl_policies.get(policy.name)
            policy.modify_index = index
            policy.create_index = (
                prev.create_index if prev is not None else index
            )
            self.acl_policies[policy.name] = policy
            self._bump("acl_policy", index)

    @journaled
    def delete_acl_policy(self, index: int, name: str) -> None:
        with self._lock:
            if self.acl_policies.pop(name, None) is not None:
                self._bump("acl_policy", index)

    @journaled
    def upsert_acl_tokens(
        self, index: int, tokens: Iterable[ACLToken]
    ) -> None:
        with self._lock:
            for token in tokens:
                prev = self.acl_tokens.get(token.accessor_id)
                token.modify_index = index
                token.create_index = (
                    prev.create_index if prev is not None else index
                )
                if prev is not None:
                    self._token_by_secret.pop(prev.secret_id, None)
                self.acl_tokens[token.accessor_id] = token
                self._token_by_secret[token.secret_id] = token.accessor_id
            self._bump("acl_token", index)

    @journaled
    def delete_acl_token(self, index: int, accessor_id: str) -> None:
        with self._lock:
            token = self.acl_tokens.pop(accessor_id, None)
            if token is not None:
                self._token_by_secret.pop(token.secret_id, None)
                self._bump("acl_token", index)

    @journaled
    def upsert_namespace(self, index: int, name: str, description: str = "") -> None:
        with self._lock:
            self.namespaces[name] = {
                "Name": name, "Description": description,
                "CreateIndex": self.namespaces.get(name, {}).get(
                    "CreateIndex", index
                ),
                "ModifyIndex": index,
            }
            self._bump("namespaces", index)

    @journaled
    def delete_namespace(self, index: int, name: str) -> None:
        with self._lock:
            if name == "default":
                raise ValueError("cannot delete the default namespace")
            if any(ns == name for ns, _ in self.jobs):
                raise ValueError(f"namespace {name!r} has jobs")
            if self.namespaces.pop(name, None) is not None:
                self._bump("namespaces", index)

    def acl_token_by_secret(self, secret_id: str) -> Optional[ACLToken]:
        accessor = self._token_by_secret.get(secret_id)
        return self.acl_tokens.get(accessor) if accessor else None

    def has_management_token(self) -> bool:
        return any(t.is_management() for t in self.acl_tokens.values())

    # ------------------------------------------------------------------
    # Plan results (UpsertPlanResults, state_store.go:318)
    # ------------------------------------------------------------------

    @journaled
    def upsert_plan_results(
        self,
        index: int,
        allocs: List[Allocation],
        stops: List[Allocation],
        preemptions: List[Allocation],
        deployment: Optional[Deployment] = None,
        deployment_updates: Optional[List] = None,
        evals: Optional[List[Evaluation]] = None,
        *,
        now: Optional[float] = None,
    ) -> None:
        with self._lock:
            if deployment is not None:
                self.upsert_deployment(index, deployment)
            for upd in deployment_updates or []:
                d = self.deployments.get(upd.deployment_id)
                if d is not None:
                    import copy as _copy

                    d2 = _copy.copy(d)
                    d2.status = upd.status
                    d2.status_description = upd.status_description
                    self.upsert_deployment(index, d2)
            # A plan's allocs are copies from the scheduler's snapshot,
            # which may predate client updates that landed while the eval
            # was in flight; committing them verbatim rolls client-reported
            # state back (e.g. a scale-up in-place update clobbering
            # "running" with the snapshot's "pending").  Keep the store's
            # client-owned fields (reference: upsertAllocsImpl "keep the
            # clients task states", nomad/state/state_store.go:3180) unless
            # the plan asserts "lost" — a server-side verdict that sticks.
            for alloc in stops + preemptions + allocs:
                prev = self.allocs.get(alloc.id)
                if prev is None:
                    continue
                alloc.task_states = prev.task_states
                if alloc.client_status != AllocClientStatus.LOST.value:
                    alloc.client_status = prev.client_status
                    alloc.client_description = prev.client_description
                if alloc.deployment_status is None:
                    alloc.deployment_status = prev.deployment_status
            self.upsert_allocs(index, stops + preemptions + allocs, now=now)
            # Volume claims for newly placed allocs whose groups request
            # registered volumes (CSIVolumeClaim at plan apply).  Derived
            # from the same entry, so replication/replay reproduce claims
            # without their own journal records.
            for a in allocs:
                job = a.job
                tg = job.lookup_task_group(a.task_group) if job else None
                if tg is None or not tg.volumes:
                    continue
                for vreq in tg.volumes.values():
                    if vreq.type != "csi":
                        continue
                    vol = self.volumes.get((a.namespace, vreq.source))
                    if vol is None:
                        continue
                    table = (
                        vol.read_claims if vreq.read_only
                        else vol.write_claims
                    )
                    table[a.id] = a.node_id
                    vol.modify_index = index
                    self._bump("volumes", index)
            if evals:
                self.upsert_evals(index, evals)


    # ------------------------------------------------------------------
    # Durability: WAL attach, snapshot image, restore
    # (reference: nomad/fsm.go:1367 Persist / :1381 Restore)
    # ------------------------------------------------------------------

    def attach_wal(self, wal, snapshot_every: int = 4096) -> None:
        """Start journaling top-level mutations to ``wal``.  Call after
        :meth:`restore` so replayed mutations are not re-appended."""
        with self._lock:
            self.wal = wal
            self.snapshot_every = snapshot_every

    # ------------------------------------------------------------------
    # Replication seam (server/replication.py feeds these on followers)
    # ------------------------------------------------------------------

    def apply_remote(self, entry: dict) -> None:
        """Apply one committed entry from the leader's stream (follower
        side): journal it locally (same seq), then run the mutator without
        journaling it again.  Takes the canonical lock order
        (_write_lock → _lock): the mutator's @journaled wrapper acquires
        _write_lock, so _lock alone here would invert it."""
        from ..structs import serde

        with self._write_lock, self._lock:
            if self.wal is not None:
                self.wal.append_entry(entry)
            args = [serde.from_wire(a) for a in entry["a"]["args"]]
            kwargs = {
                k: serde.from_wire(v)
                for k, v in entry["a"]["kwargs"].items()
            }
            self._applying_remote = True
            try:
                getattr(self, entry["op"])(entry["i"], *args, **kwargs)
            finally:
                self._applying_remote = False
            if (
                self.wal is not None
                and self.wal.appends_since_snapshot >= self.snapshot_every
            ):
                self.write_snapshot()

    def install_snapshot(self, snapshot_wire: dict, seq: int) -> None:
        """Replace ALL local state with the leader's FSM image (raft
        InstallSnapshot): reset tables + matrix, restore, persist.
        Takes the canonical lock order (_write_lock → _lock): the restore
        replays through mutators whose @journaled wrapper acquires
        _write_lock — _lock alone here would invert and deadlock.

        The matrix is cleared first, so the next ``NodeMatrix.sync``
        uploads it in full into new device tensors, and a dispatch in
        flight sees the version bump and is treated as stale."""
        with self._write_lock, self._lock:
            self._reset_tables_locked()
            self.restore(snapshot_wire, [])
            if self.wal is not None:
                self.wal.seq = seq
                self.wal.write_snapshot(self.to_snapshot_wire())
        # A joiner learns the membership list from the image it was
        # caught up with (outside _lock — see set_raft_peers).
        rep = self.replicator
        if rep is not None and self.raft_peers:
            rep.update_peers(self.raft_peers)

    def _reset_tables_locked(self) -> None:
        self.matrix.clear()
        self.latest_index = 0
        self._table_index.clear()
        self.nodes.clear()
        self.jobs.clear()
        self.job_versions.clear()
        self.evals.clear()
        self.allocs.clear()
        self.deployments.clear()
        self.job_summaries.clear()
        self.periodic_launch.clear()
        self.scaling_policies.clear()
        self.scaling_events.clear()
        self.raft_peers = []
        self.volumes.clear()
        self._allocs_by_node.clear()
        self._allocs_by_job.clear()
        self._allocs_by_eval.clear()
        self._evals_by_job.clear()
        self._deployments_by_job.clear()
        self._history.clear()
        self.acl_policies.clear()
        self.acl_tokens.clear()
        self._token_by_secret.clear()
        self.namespaces = {
            "default": {"Name": "default", "Description": "Default namespace"}
        }

    def to_snapshot_wire(self) -> dict:
        """Serialize the full FSM image (matrix excluded — it is rebuilt by
        replaying restores through the mutators)."""
        from ..structs import serde

        with self._lock:
            return {
                "latest_index": self.latest_index,
                "table_index": dict(self._table_index),
                "nodes": [serde.to_wire(n) for n in self.nodes.values()],
                "job_versions": [
                    [serde.to_wire(v) for v in versions]
                    for versions in self.job_versions.values()
                ],
                "evals": [serde.to_wire(e) for e in self.evals.values()],
                "allocs": [serde.to_wire(a) for a in self.allocs.values()],
                "deployments": [
                    serde.to_wire(d) for d in self.deployments.values()
                ],
                "periodic_launch": [
                    [ns, jid, t]
                    for (ns, jid), t in self.periodic_launch.items()
                ],
                "scaling_events": [
                    [ns, jid, g, [serde.to_wire(e) for e in ring]]
                    for (ns, jid, g), ring in self.scaling_events.items()
                ],
                "raft_peers": list(self.raft_peers),
                "volumes": [
                    serde.to_wire(v) for v in self.volumes.values()
                ],
                "scheduler_config": serde.to_wire(self.scheduler_config),
                "acl_policies": [
                    serde.to_wire(p) for p in self.acl_policies.values()
                ],
                "acl_tokens": [
                    serde.to_wire(t) for t in self.acl_tokens.values()
                ],
                "namespaces": dict(self.namespaces),
            }

    def write_snapshot(self) -> None:
        if self.wal is not None:
            self.wal.write_snapshot(self.to_snapshot_wire())

    def restore(self, snapshot_wire: Optional[dict], entries: List[dict]) -> None:
        """Rebuild state (and, via the mutators, the device matrix) from a
        snapshot image + WAL tail.  Must run before :meth:`attach_wal`."""
        from ..structs import serde

        # Canonical order (_write_lock → _lock): replayed mutators
        # re-enter the journaled wrapper, which acquires _write_lock.
        with self._write_lock, self._lock:
            self._replaying = True
            try:
                if snapshot_wire:
                    self._restore_snapshot(snapshot_wire, serde)
                for e in entries:
                    args = [serde.from_wire(a) for a in e["a"]["args"]]
                    kwargs = {
                        k: serde.from_wire(v)
                        for k, v in e["a"]["kwargs"].items()
                    }
                    getattr(self, e["op"])(e["i"], *args, **kwargs)
            finally:
                self._replaying = False
            # Restore re-publishes nothing: everything up to the restored
            # index is unservable backlog for event subscribers.
            self.events.mark_history_truncated(self.latest_index)

    def _restore_snapshot(self, snap: dict, serde) -> None:
        # Replay through the mutators so derived state (matrix rows, alloc
        # usage aggregates, secondary indexes, summaries) rebuilds itself;
        # then patch the index/version fields the mutators recompute.
        for w in snap["nodes"]:
            node = serde.from_wire(w)
            create = node.create_index
            self.upsert_node(node.modify_index, node)
            node.create_index = create
        for versions_w in snap["job_versions"]:
            versions = [serde.from_wire(w) for w in versions_w]
            for v in versions:
                wanted_version = v.version
                create = v.create_index
                self.upsert_job(v.modify_index, v)
                v.version = wanted_version
                v.create_index = create
        for w in snap["evals"]:
            ev = serde.from_wire(w)
            create = ev.create_index
            self.upsert_evals(ev.modify_index, [ev])
            ev.create_index = create
        for w in snap["allocs"]:
            alloc = serde.from_wire(w)
            create = alloc.create_index
            self.upsert_allocs(alloc.modify_index, [alloc])
            alloc.create_index = create
        for w in snap["deployments"]:
            dep = serde.from_wire(w)
            create = dep.create_index
            self.upsert_deployment(dep.modify_index, dep)
            dep.create_index = create
        for ns, jid, t in snap["periodic_launch"]:
            self.periodic_launch[(ns, jid)] = t
        for ns, jid, g, ring in snap.get("scaling_events", []):
            self.scaling_events[(ns, jid, g)] = [
                serde.from_wire(w) for w in ring
            ]
        self.raft_peers = list(snap.get("raft_peers", []))
        for w in snap.get("volumes", []):
            v = serde.from_wire(w)
            self.volumes[(v.namespace, v.id)] = v
        self.scheduler_config = serde.from_wire(snap["scheduler_config"])
        for w in snap.get("acl_policies", []):
            p = serde.from_wire(w)
            self.acl_policies[p.name] = p
        for w in snap.get("acl_tokens", []):
            t = serde.from_wire(w)
            self.acl_tokens[t.accessor_id] = t
            self._token_by_secret[t.secret_id] = t.accessor_id
        self.namespaces.update(snap.get("namespaces", {}))
        # Exact index fidelity last — replays bumped these monotonically.
        self.latest_index = snap["latest_index"]
        self._table_index = dict(snap["table_index"])


class StateSnapshot:
    """A scheduler-facing point-in-time read view at ``snapshot_index``.

    Implements the scheduler ``State`` interface (scheduler/scheduler.go:65).
    Objects modified after the snapshot resolve back through the store's
    MVCC history ring to the version visible at snapshot time; objects
    created after it are invisible — the memdb point-in-time discipline
    (state_store.go:171 Snapshot / :198 SnapshotMinIndex).  Bound: a
    snapshot older than ``history_depth`` replacements of one object
    degrades to the live version (the applier's serialized re-verify still
    protects commits — plan_apply.go:49-69).  GC deletions (terminal
    objects reaped after the snapshot) simply vanish from index scans;
    they were terminal in both views.
    """

    def __init__(self, store: StateStore, index: int):
        self.store = store
        self.snapshot_index = index
        # Runtime config is an immutable-replace singleton: pin it now.
        self._scheduler_config = store.scheduler_config

    def _at(self, table: str, key, live):
        return self.store._resolve_at(table, key, live, self.snapshot_index)

    def ready_nodes_in_dcs(self, datacenters) -> List[Node]:
        dcs = set(datacenters)
        return [
            n for n in self.nodes()
            if n.ready() and (not dcs or n.datacenter in dcs)
        ]

    def nodes(self) -> List[Node]:
        store = self.store
        with store._lock:
            out = [
                self._at("nodes", nid, n) for nid, n in store.nodes.items()
            ]
        return [n for n in out if n is not None]

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._at("nodes", node_id, self.store.nodes.get(node_id))

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        key = (namespace, job_id)
        return self._at("jobs", key, self.store.jobs.get(key))

    def allocs_by_job(self, namespace: str, job_id: str) -> List[Allocation]:
        store = self.store
        with store._lock:
            ids = list(store._allocs_by_job.get((namespace, job_id), ()))
            out = [self._at("allocs", i, store.allocs.get(i)) for i in ids]
        return [a for a in out if a is not None]

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        store = self.store
        with store._lock:
            ids = list(store._allocs_by_node.get(node_id, ()))
            out = [self._at("allocs", i, store.allocs.get(i)) for i in ids]
        return [a for a in out if a is not None]

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._at("evals", eval_id, self.store.evals.get(eval_id))

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._at("allocs", alloc_id, self.store.allocs.get(alloc_id))

    def volume_by_id(self, namespace: str, volume_id: str):
        key = (namespace, volume_id)
        return self._at("volumes", key, self.store.volumes.get(key))

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self._at(
            "deployment", deployment_id,
            self.store.deployments.get(deployment_id),
        )

    def latest_deployment_by_job(self, namespace: str, job_id: str):
        store = self.store
        with store._lock:
            ids = list(store._deployments_by_job.get((namespace, job_id), ()))
            best: Optional[Deployment] = None
            for i in ids:
                d = self._at("deployment", i, store.deployments.get(i))
                if d and (best is None or d.create_index > best.create_index):
                    best = d
        return best

    def scheduler_config(self) -> SchedulerConfiguration:
        return self._scheduler_config
