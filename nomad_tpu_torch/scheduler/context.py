"""Evaluation context — the plan under construction plus scoring telemetry.

Reference: scheduler/context.go:12-211 (EvalContext holds the state snapshot,
the Plan being built, per-placement AllocMetrics, and the ProposedAllocs
cache that lets later placements in the same plan see earlier ones).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..structs.types import Allocation, AllocMetric, Job, Plan


class EvalContext:
    def __init__(self, snapshot, plan: Plan):
        self.snapshot = snapshot
        self.plan = plan
        self.metrics: Dict[str, AllocMetric] = {}  # per-TG last metric

    def plan_removed_ids(self) -> set:
        """Ids of allocs the in-flight plan stops, evicts, or preempts —
        excluded from every proposed-usage computation."""
        removed = set()
        for allocs in self.plan.node_update.values():
            removed.update(a.id for a in allocs)
        for allocs in self.plan.node_preemptions.values():
            removed.update(a.id for a in allocs)
        return removed

    def proposed_allocs(self, node_id: str) -> List[Allocation]:
        """Allocs a node would have if the plan applied: existing non-terminal
        − plan stops/evictions/preemptions + in-plan placements
        (reference: context.go ProposedAllocs)."""
        existing = [
            a
            for a in self.snapshot.allocs_by_node(node_id)
            if not a.terminal_status()
        ]
        removed = {
            a.id
            for a in self.plan.node_update.get(node_id, [])
        } | {a.id for a in self.plan.node_preemptions.get(node_id, [])}
        proposed = [a for a in existing if a.id not in removed]
        proposed.extend(self.plan.node_allocation.get(node_id, []))
        return proposed
