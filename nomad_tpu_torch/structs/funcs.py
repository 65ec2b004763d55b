"""Scalar reference implementations of the scheduling math.

These mirror the semantics of the reference's ``nomad/structs/funcs.go``
(``AllocsFit`` :97, ``ScoreFitBinPack`` :186, ``ScoreFitSpread`` :213) and are
the *golden oracle* the vectorized JAX kernels in ``nomad_tpu.ops`` are
parity-tested against (SURVEY.md §7 step 2). They are also used host-side for
small-n paths where a device round-trip isn't worth it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .types import Allocation, Node, Resources

# Maximum possible bin-packing fitness score; used to normalize to [0, 1]
# (reference: scheduler/rank.go:12-16 binPackingMaxFitScore).
BINPACK_MAX_FIT_SCORE = 18.0


def allocs_resources(allocs: List[Allocation]) -> Resources:
    """Sum resources of non-terminal allocs (reference: funcs.go:98-122)."""
    used = Resources(cpu=0, memory_mb=0, disk_mb=0)
    for alloc in allocs:
        if alloc.terminal_status():
            continue
        used.add(alloc.resources)
    return used


def allocs_device_usage(allocs: List[Allocation]) -> Dict[str, int]:
    used: Dict[str, int] = {}
    for alloc in allocs:
        if alloc.terminal_status():
            continue
        for dev in alloc.resources.devices:
            used[dev.name] = used.get(dev.name, 0) + dev.count
    return used


def allocs_fit(
    node: Node,
    allocs: List[Allocation],
    check_devices: bool = False,
) -> Tuple[bool, str, Resources]:
    """Check whether a set of allocations fits on a node.

    Computes utilization from zero over non-terminal allocs, then verifies the
    node's comparable resources (total − reserved) are a superset. Returns
    (fit, exhausted_dimension, used). Reference: funcs.go:97-160.
    """
    used = allocs_resources(allocs)

    avail = node.comparable_resources()
    if used.cpu > avail.cpu:
        return False, "cpu", used
    if used.memory_mb > avail.memory_mb:
        return False, "memory", used
    if used.disk_mb > avail.disk_mb:
        return False, "disk", used

    # Reserved-port collision check (combinatorial — host-side only;
    # reference: NetworkIndex, nomad/structs/network.go:35).
    seen_ports = set(node.reserved.reserved_ports)
    for alloc in allocs:
        if alloc.terminal_status():
            continue
        for net in alloc.resources.networks:
            for port in net.reserved_ports:
                if port in seen_ports:
                    return False, "reserved port collision", used
                seen_ports.add(port)
            for port in net.assigned_ports.values():
                if port in seen_ports:
                    return False, "reserved port collision", used
                seen_ports.add(port)

    if check_devices:
        dev_used = allocs_device_usage(allocs)
        for name, count in dev_used.items():
            have = len(node.resources.devices.get(name, []))
            if count > have:
                return False, "devices", used
    return True, "", used


def compute_free_percentage(node: Node, util: Resources) -> Tuple[float, float]:
    """Free CPU/RAM fraction after ``util`` is placed (funcs.go:162-179)."""
    avail = node.comparable_resources()
    free_cpu = 1.0 - (util.cpu / avail.cpu) if avail.cpu > 0 else 0.0
    free_mem = 1.0 - (util.memory_mb / avail.memory_mb) if avail.memory_mb > 0 else 0.0
    return free_cpu, free_mem


def score_fit_binpack(node: Node, util: Resources) -> float:
    """Bin-packing score in [0, 18] — BestFit v3 (funcs.go:186-206).

    ``20 − (10^freeCpu + 10^freeMem)``: 18 at perfect fit, 0 when empty.
    """
    free_cpu, free_mem = compute_free_percentage(node, util)
    total = math.pow(10, free_cpu) + math.pow(10, free_mem)
    score = 20.0 - total
    return min(18.0, max(0.0, score))


def score_fit_spread(node: Node, util: Resources) -> float:
    """Worst-fit (spread) score in [0, 18] (funcs.go:213-224)."""
    free_cpu, free_mem = compute_free_percentage(node, util)
    total = math.pow(10, free_cpu) + math.pow(10, free_mem)
    score = total - 2.0
    return min(18.0, max(0.0, score))


def net_priority(priorities: List[int]) -> float:
    """Aggregate priority of a preempted-alloc set (rank.go netPriority):
    max priority plus the ratio of sum to max, penalizing many-victim sets."""
    if not priorities:
        return 0.0
    mx = float(max(priorities))
    if mx == 0:
        return 0.0
    return mx + (float(sum(priorities)) / mx)


def preemption_score(net_prio: float) -> float:
    """Logistic preemption score in (0, 1); 0.5 at netPriority 2048
    (reference: rank.go preemptionScore, rate=0.0048, origin=2048)."""
    rate = 0.0048
    origin = 2048.0
    return 1.0 / (1.0 + math.exp(rate * (net_prio - origin)))


def score_normalize(scores: List[float]) -> float:
    """Final score = arithmetic mean of component scores
    (reference: ScoreNormalizationIterator, rank.go:737-771)."""
    if not scores:
        return 0.0
    return sum(scores) / len(scores)


def filter_terminal_allocs(
    allocs: List[Allocation],
) -> Tuple[List[Allocation], Dict[str, Allocation]]:
    """Split out terminal allocs, keeping the latest terminal per name
    (reference: funcs.go:69-90)."""
    live: List[Allocation] = []
    terminal: Dict[str, Allocation] = {}
    for alloc in allocs:
        if alloc.terminal_status():
            prev = terminal.get(alloc.name)
            if prev is None or prev.create_index < alloc.create_index:
                terminal[alloc.name] = alloc
        else:
            live.append(alloc)
    return live, terminal
