"""Composite overload/health score — the admission-control hook.

Admission control needs a single signal that says "the control plane
is saturating" *before* latency SLOs burn: load shedding keyed off a
breached SLO is already too late.  This module
folds the queueing signals the server exposes into one pressure score:

* eval-broker backlog (ready + pending vs the dispatch rate's reach),
* blocked-evals backlog (placements failing for capacity),
* coalescer pipeline occupancy (in-flight vs configured depth),
* plan-queue depth and recent plan queue-wait p99,
* heartbeat misses (nodes silently dropping off).

Each input normalizes to a [0,1] pressure via a soft knee (value /
(value + knee)) so no single unbounded queue saturates the score
discontinuously; the composite is the weighted mean, and the status
bands are ``ok`` / ``degraded`` / ``critical``.  Any breached SLO
forces at least ``degraded`` — a burned latency budget IS degradation
even when queues look calm.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_CRITICAL = "critical"

DEGRADED_AT = 0.5
CRITICAL_AT = 0.85

# (name, knee, weight): pressure_i = min(1, v / (v + knee)) — at v=knee
# the input contributes 0.5.  Knees are sized to the 10K-node target's
# comfortable operating point, not the sim's.
_QUEUE_INPUTS = (
    ("broker_backlog", 256.0, 2.0),
    ("blocked_evals", 128.0, 1.0),
    ("plan_queue_depth", 64.0, 2.0),
    ("plan_queue_wait_p99_ms", 100.0, 1.5),
    ("heartbeat_miss_rate", 0.5, 1.5),
)
_PIPELINE_WEIGHT = 1.0


def _soft(value: float, knee: float) -> float:
    if value <= 0:
        return 0.0
    return min(1.0, value / (value + knee))


def compute_health(
    signals: Dict[str, float],
    breached_slos: Optional[List[str]] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """``signals`` carries the raw inputs (missing keys read as 0);
    returns the pressure breakdown, composite score, and status band.
    ``score`` is 0-100 where 100 is unloaded (operator-friendly);
    ``pressure`` is the raw composite in [0,1]."""
    breached = list(breached_slos or [])
    pressures: Dict[str, float] = {}
    total_w = 0.0
    acc = 0.0
    for name, knee, weight in _QUEUE_INPUTS:
        p = _soft(float(signals.get(name, 0.0)), knee)
        pressures[name] = round(p, 4)
        acc += p * weight
        total_w += weight
    # Pipeline occupancy is already a ratio; full pipeline = pressure 1.
    depth = float(signals.get("pipeline_depth", 0.0)) or 1.0
    occ = min(1.0, float(signals.get("pipeline_inflight", 0.0)) / depth)
    pressures["pipeline_occupancy"] = round(occ, 4)
    acc += occ * _PIPELINE_WEIGHT
    total_w += _PIPELINE_WEIGHT

    pressure = acc / total_w if total_w else 0.0
    if pressure >= CRITICAL_AT:
        status = STATUS_CRITICAL
    elif pressure >= DEGRADED_AT or breached:
        status = STATUS_DEGRADED
    else:
        status = STATUS_OK
    return {
        "status": status,
        "score": round(100.0 * (1.0 - pressure), 1),
        "pressure": round(pressure, 4),
        "inputs": pressures,
        "breached_slos": breached,
        "evaluated_at": now if now is not None else time.time(),
    }


def collect_signals(server) -> Dict[str, float]:
    """Pull the raw health inputs off a live Server.  Duck-typed (no
    import of server.py — obs must stay importable standalone); every
    read is a cheap counter/locked-len call, safe at tick rate."""
    signals: Dict[str, float] = {}
    try:
        b = server.eval_broker
        signals["broker_backlog"] = (
            b.ready_count() + b.pending_count() + b.unacked_count()
        )
    except Exception:
        pass
    try:
        signals["blocked_evals"] = server.blocked_evals.blocked_count()
    except Exception:
        pass
    try:
        signals["plan_queue_depth"] = server.plan_queue.depth()
    except Exception:
        pass
    try:
        c = server.coalescer
        signals["pipeline_inflight"] = c.inflight_depth()
        signals["pipeline_depth"] = c.pipeline_depth
    except Exception:
        pass
    try:
        t = server.metrics._timers.get("nomad.phase.plan.queue_wait")
        if t is not None:
            signals["plan_queue_wait_p99_ms"] = t.windowed(60.0)["p99_ms"]
    except Exception:
        pass
    # heartbeat_miss_rate is injected by the evaluator, which tracks the
    # nomad.heartbeat.missed counter's rate over its own rolling window.
    return signals
