"""Scheduler test harness — a real StateStore plus a fake Planner that
applies plans directly and records them.

Reference: scheduler/testing.go:40-279 (Harness, with RejectPlan at :17-38 to
force the stale-snapshot refresh path). This is tier 1 of the test strategy
(SURVEY.md §4): the kernels get golden-tested against real state here.

A harness built without a store makes one whose matrix lives on
``device`` (default ``"cuda"``, which needs a card; tests pass ``"cpu"``,
where the schedulers' selects run the kernels' plain versions).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from ..state.matrix import NodeMatrix
from ..state.store import StateSnapshot, StateStore
from ..structs.types import Evaluation, Plan, PlanResult


class Harness:
    def __init__(self, store: Optional[StateStore] = None, device="cuda"):
        self.store = (store if store is not None
                      else StateStore(matrix=NodeMatrix(device=device)))
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.created_evals: List[Evaluation] = []
        self._index = itertools.count(1000)
        self.reject_plan = False  # RejectPlan (testing.go:17-38)
        self.partial_commit_nodes: set = set()  # nodes whose allocs drop

    def next_index(self) -> int:
        return next(self._index)

    # -- Planner interface ---------------------------------------------------

    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], Optional[StateSnapshot]]:
        self.plans.append(plan)
        if self.reject_plan:
            # A rejected plan applies nothing; None forces the scheduler's
            # refresh-and-retry path regardless of plan contents.
            return None, self.store.snapshot()

        index = self.next_index()
        alloc_lists = {
            nid: [a for a in allocs]
            for nid, allocs in plan.node_allocation.items()
            if nid not in self.partial_commit_nodes
        }
        allocs = [a for lst in alloc_lists.values() for a in lst]
        allocs.extend(plan.alloc_updates)
        stops = [a for lst in plan.node_update.values() for a in lst]
        preempts = [a for lst in plan.node_preemptions.values() for a in lst]
        self.store.upsert_plan_results(
            index,
            allocs,
            stops,
            preempts,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
        )
        result = PlanResult(
            node_allocation=alloc_lists,
            node_update=dict(plan.node_update),
            node_preemptions=dict(plan.node_preemptions),
            refresh_index=index,
            alloc_index=index,
        )
        snap = self.store.snapshot() if self.partial_commit_nodes else None
        return result, snap

    def update_eval(self, eval: Evaluation) -> None:
        self.evals.append(eval)
        self.store.upsert_evals(self.next_index(), [eval])

    def create_evals(self, evals: List[Evaluation]) -> None:
        self.created_evals.extend(evals)
        self.store.upsert_evals(self.next_index(), list(evals))

    def refresh_snapshot(self) -> StateSnapshot:
        return self.store.snapshot()

    def snapshot(self) -> StateSnapshot:
        return self.store.snapshot()

    def process(self, scheduler_factory, eval: Evaluation):
        """Run one scheduler invocation (testing.go Process)."""
        sched = scheduler_factory(self.snapshot(), self, self.store.matrix)
        sched.process(eval)
        return sched
