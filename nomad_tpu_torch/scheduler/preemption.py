"""Preemption victim selection — host-side residue of the vectorized search.

The kernel identifies nodes where evicting lower-priority work would make the
ask fit (prio_used prefix-sum, ops/kernels.preemption_state). This module
picks the *actual* victim allocs on the single chosen node — the reference's
greedy search (scheduler/preemption.go:198-557) reduced to one node.

Victims must have priority < job.priority − 10 (preemption.go:663); chosen
greedily by (priority, resource distance) until the deficit is covered,
then filtered back (superset elimination, preemption.go:702).
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..structs.types import (
    Allocation,
    Job,
    Node,
    PREEMPTION_PRIORITY_DELTA,
    Resources,
)


def resource_distance(delta: Resources, ask: Resources) -> float:
    """Euclidean distance between a victim's resources and the remaining
    deficit, normalized per-dimension (preemption.go basicResourceDistance
    :608)."""
    total = 0.0
    n = 0
    for d, a in (
        (delta.cpu, ask.cpu),
        (delta.memory_mb, ask.memory_mb),
        (delta.disk_mb, ask.disk_mb),
    ):
        if a > 0:
            total += ((d - a) / a) ** 2
            n += 1
    return math.sqrt(total / n) if n else 0.0


def select_victims(
    job: Job,
    node: Node,
    proposed: List[Allocation],
    ask: Resources,
    available: Resources,
) -> Optional[List[Allocation]]:
    """Pick allocs to evict so that ``ask`` fits in ``available`` + freed.

    Returns None when no admissible victim set covers the deficit.
    """
    deficit = Resources(
        cpu=max(0, ask.cpu - available.cpu),
        memory_mb=max(0, ask.memory_mb - available.memory_mb),
        disk_mb=max(0, ask.disk_mb - available.disk_mb),
    )
    if deficit.cpu == 0 and deficit.memory_mb == 0 and deficit.disk_mb == 0:
        return []

    threshold = job.priority - PREEMPTION_PRIORITY_DELTA
    candidates = [
        a
        for a in proposed
        if not a.terminal_status() and a.job_priority() < threshold
    ]
    # Lowest priority first, then best resource-distance match.
    candidates.sort(
        key=lambda a: (a.job_priority(), resource_distance(a.resources, deficit))
    )

    victims: List[Allocation] = []
    freed = Resources(cpu=0, memory_mb=0, disk_mb=0)
    for a in candidates:
        if (
            freed.cpu >= deficit.cpu
            and freed.memory_mb >= deficit.memory_mb
            and freed.disk_mb >= deficit.disk_mb
        ):
            break
        victims.append(a)
        freed.add(a.resources)

    if not (
        freed.cpu >= deficit.cpu
        and freed.memory_mb >= deficit.memory_mb
        and freed.disk_mb >= deficit.disk_mb
    ):
        return None

    # Superset elimination: drop victims whose removal still covers the
    # deficit (preemption.go filterSuperset :702).
    filtered: List[Allocation] = list(victims)
    for a in sorted(victims, key=lambda v: -v.job_priority()):
        without = Resources(
            cpu=freed.cpu - a.resources.cpu,
            memory_mb=freed.memory_mb - a.resources.memory_mb,
            disk_mb=freed.disk_mb - a.resources.disk_mb,
        )
        if (
            without.cpu >= deficit.cpu
            and without.memory_mb >= deficit.memory_mb
            and without.disk_mb >= deficit.disk_mb
        ):
            filtered.remove(a)
            freed = without
    return filtered
