"""Cluster invariant checker — the post-scenario safety oracle.

After any chaos scenario (or at any quiescent point), these checks scan
authoritative state for the properties the control plane promises to
hold *whatever failed*:

1. **Replacement coverage** — no live ``run`` alloc sits on a down or
   draining node without the control plane having reacted (a node-
   triggered eval at/after the transition, or a replacement alloc).
   Reference: ``createNodeEvals``, node_endpoint.go:1145.
2. **Capacity** — ``AllocsFit`` holds on every node: the non-terminal
   allocs placed there never exceed comparable resources (funcs.go:97).
3. **Volume safety** — a ``single-node-writer`` volume has at most one
   live writer claim (csi_endpoint.go claim discipline).
4. **Broker hygiene** — no leaked outstanding evals: once workers are
   idle, nothing stays checked out of the eval broker forever
   (eval_broker.go unack/nack lease discipline).
5. **Convergence** — after a heal, every live server's FSM image is
   byte-identical (the raft state-machine safety property, §5.4.3).

Each check returns human-readable violation strings; an empty list means
the invariant holds.  ``check_store`` composes 1-4 for one server;
``check_convergence`` compares a set of servers.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional

from ..structs.funcs import allocs_fit
from ..structs.types import AllocDesiredStatus, NodeStatus


def check_replacement_coverage(store) -> List[str]:
    """Invariant 1: every live alloc on a down/drained node has a
    replacement eval (node-update/node-drain at or after the node's
    transition index) or a successor alloc pointing at it."""
    violations: List[str] = []
    with store._lock:
        allocs = list(store.allocs.values())
        successors = {
            a.previous_allocation for a in allocs if a.previous_allocation
        }
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            if alloc.desired_status != AllocDesiredStatus.RUN.value:
                continue  # already told to stop — the reaction happened
            node = store.nodes.get(alloc.node_id)
            gone = node is None
            down = not gone and node.status == NodeStatus.DOWN.value
            draining = not gone and bool(node.drain)
            if not (gone or down or draining):
                continue
            if alloc.id in successors:
                continue
            node_index = node.modify_index if node is not None else 0
            reacted = any(
                ev.triggered_by in ("node-update", "node-drain")
                and ev.modify_index >= node_index
                for ev in store.evals_by_job(alloc.namespace, alloc.job_id)
            )
            if not reacted:
                violations.append(
                    f"alloc {alloc.id[:8]} (job {alloc.job_id}) lives on "
                    f"{'missing' if gone else node.status} node "
                    f"{alloc.node_id[:8]} with no replacement eval"
                )
    return violations


def check_allocs_fit(store) -> List[str]:
    """Invariant 2: no node is over-committed."""
    violations: List[str] = []
    with store._lock:
        node_ids = list(store.nodes)
    for nid in node_ids:
        node = store.node_by_id(nid)
        if node is None:
            continue
        fit, dim, used = allocs_fit(node, store.allocs_by_node(nid))
        if not fit:
            violations.append(
                f"node {nid[:8]} over-committed on {dim} "
                f"(used cpu={used.cpu} mem={used.memory_mb} "
                f"disk={used.disk_mb})"
            )
    return violations


def check_volume_writers(store) -> List[str]:
    """Invariant 3: ≤1 live writer on every single-node-writer volume."""
    violations: List[str] = []
    with store._lock:
        volumes = list(store.volumes.values())
        for vol in volumes:
            if vol.access_mode != "single-node-writer":
                continue
            live = [
                aid for aid in vol.write_claims
                if (a := store.allocs.get(aid)) is not None
                and not a.terminal_status()
            ]
            if len(live) > 1:
                violations.append(
                    f"volume {vol.namespace}/{vol.id} "
                    f"(single-node-writer) has {len(live)} live writers: "
                    f"{[i[:8] for i in live]}"
                )
    return violations


def check_broker(server, settle: float = 5.0) -> List[str]:
    """Invariant 4: no eval STAYS checked out of the broker.  One sample
    cannot distinguish busy from wedged — background work (e.g. a node
    TTL expiring mid-sweep) hands workers legitimate leases at any
    moment.  A lease violates only if the SAME eval remains unacked for
    the whole settle window; the nack sweeper reclaims a dead worker's
    lease well inside it, so a survivor is a leak."""
    import time as _time

    broker = getattr(server, "eval_broker", None)
    if broker is None or not broker.enabled:
        return []
    stuck = set(broker.unacked_ids())
    deadline = _time.time() + settle
    while stuck and _time.time() < deadline:
        _time.sleep(0.1)
        stuck &= set(broker.unacked_ids())
    if stuck:
        ids = ", ".join(sorted(stuck)[:4])
        return [
            f"eval broker holds {len(stuck)} stuck unacked eval(s): {ids}"
        ]
    return []


def check_store(server) -> List[str]:
    """Invariants 1-4 against one server's authoritative state."""
    store = server.store
    return (
        check_replacement_coverage(store)
        + check_allocs_fit(store)
        + check_volume_writers(store)
        + check_broker(server)
    )


def _fsm_image(store) -> str:
    """Canonical JSON of the full FSM image (what a snapshot would
    persist), for cross-server comparison.  Table lists are sorted by
    their serialized form: insertion order can legitimately differ
    between a follower that replayed the log and one that installed a
    snapshot, and order is not part of the FSM contract."""
    wire = store.to_snapshot_wire()
    wire.pop("wal_seq", None)
    canon = {}
    for key, val in wire.items():
        if isinstance(val, list):
            canon[key] = sorted(
                json.dumps(item, sort_keys=True) for item in val
            )
        else:
            canon[key] = val
    return json.dumps(canon, sort_keys=True)


def check_convergence(servers: Iterable) -> List[str]:
    """Invariant 5: all live servers hold identical FSM images (compare
    after heal + quiescence — a mid-replication snapshot legitimately
    lags)."""
    servers = list(servers)
    if len(servers) < 2:
        return []
    violations: List[str] = []
    indexes = [s.store.latest_index for s in servers]
    if len(set(indexes)) > 1:
        violations.append(f"store indexes diverge: {indexes}")
    images = [_fsm_image(s.store) for s in servers]
    if len(set(images)) > 1:
        for i, img in enumerate(images[1:], start=1):
            if img != images[0]:
                violations.append(
                    f"server[{i}] FSM image differs from server[0] "
                    f"(indexes {indexes[i]} vs {indexes[0]})"
                )
    return violations


def wait_converged(
    servers: Iterable, timeout: float = 15.0, poll: float = 0.1
) -> List[str]:
    """Poll until convergence holds or the deadline passes; returns the
    final violation list (empty = converged)."""
    import time

    servers = list(servers)
    deadline = time.monotonic() + timeout
    violations = check_convergence(servers)
    while violations and time.monotonic() < deadline:
        time.sleep(poll)
        violations = check_convergence(servers)
    return violations


def check_cluster(
    servers: Iterable, leader: Optional[object] = None
) -> List[str]:
    """Full post-scenario sweep: convergence across ``servers`` plus
    invariants 1-4 on the leader (or the first server when in-process)."""
    servers = list(servers)
    violations = check_convergence(servers)
    subject = leader if leader is not None else (servers[0] if servers else None)
    if subject is not None:
        violations += check_store(subject)
    if violations:
        # Post-mortem: persist the flight recorder next to the chaos seed
        # so the violated run's span timeline survives the process.
        from .. import trace

        path = trace.auto_dump(
            "invariant", extra={"violations": violations[:20]}
        )
        if path:
            violations = violations + [f"flight record dumped: {path}"]
    return violations
