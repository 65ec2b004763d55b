"""Declarative SLOs + multi-window burn-rate evaluation.

The paper's north star is itself an SLO — ≥50K evals/s at p99 < 5 ms —
and this module turns objectives like it into continuously evaluated
signals.  An :class:`SLOSpec` names an objective metric in the
MetricsRegistry, a comparison against a target, and a pair of sliding
windows; the engine samples the objective every tick, classifies each
sample good/bad, and computes the **burn rate** per window:

    burn = (bad samples / total samples in window) / error_budget

A burn rate of 1.0 consumes exactly the allowed violation budget; the
Google-SRE multi-window rule (alert only when BOTH the short and long
window burn hot) keeps a single slow eval from paging while still
catching sustained breaches fast.  Windowed sample storage is
``metrics.RollingWindow`` — the engine holds one per spec, so burn
rates need no second pass over raw latencies.

Three objective kinds cover the registry's value shapes:

* ``timer`` — the objective names a registry Timer; the sampled value
  is a windowed percentile field (``p99_ms`` by default), so the SLO is
  over the *recent* distribution, not the lifetime reservoir.
* ``gauge`` — the objective is a plain number in the snapshot
  (a gauge_fn, counter, or hand-rolled agent key).
* ``rate`` — the objective is a monotonic counter; the sampled value is
  its rate of change over the short window (Prometheus ``rate()``),
  which is how ``eval_throughput >= floor`` is expressed.

A copy of the reference package's engine; its lint rule O002 (every
literal ``objective=`` names a registered metric) is not part of this
package yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..metrics import MetricsRegistry, RollingWindow

# Objective kinds.
KIND_TIMER = "timer"
KIND_GAUGE = "gauge"
KIND_RATE = "rate"

STATUS_OK = "ok"
STATUS_BREACHED = "breached"
STATUS_PENDING = "pending"  # not enough samples to judge yet


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``objective`` is a metric name in the registry snapshot; ``kind``
    picks how it is sampled (see module docstring).  ``op`` is "<" or
    ">=" against ``target``.  ``windows`` is (short_s, long_s);
    ``budget`` is the allowed bad-sample fraction; breach requires
    burn > ``fast_burn`` on the short window AND > ``slow_burn`` on the
    long one, with at least ``min_samples`` in each (so a freshly
    started server never breaches off two noisy ticks).
    """

    name: str
    objective: str
    op: str
    target: float
    kind: str = KIND_GAUGE
    timer_field: str = "p99_ms"
    windows: Tuple[float, float] = (60.0, 300.0)
    budget: float = 0.05
    fast_burn: float = 2.0
    slow_burn: float = 1.0
    min_samples: int = 10
    description: str = ""

    def is_good(self, value: float) -> bool:
        if self.op == "<":
            return value < self.target
        if self.op == "<=":
            return value <= self.target
        if self.op == ">":
            return value > self.target
        return value >= self.target  # ">="


def default_slos() -> List[SLOSpec]:
    """The paper-derived objectives (BASELINE.json north star), sampled
    continuously by every leader.  Targets are the 10K-node goals; on
    the CPU sim they read as aspirational burn rates, and ``min_samples``
    keeps short-lived test servers from flapping into breach."""
    return [
        SLOSpec(
            name="placement_latency_p99_ms",
            objective="nomad.eval.latency",
            kind=KIND_TIMER,
            timer_field="p99_ms",
            op="<",
            target=5.0,
            description="end-to-end eval p99 under the 5 ms north star",
        ),
        SLOSpec(
            name="eval_throughput",
            objective="nomad.worker.evals_processed",
            kind=KIND_RATE,
            op=">=",
            target=50.0,
            description="sustained evals/s above the serving floor",
        ),
        SLOSpec(
            name="heartbeat_liveness",
            objective="nomad.heartbeat.missed",
            kind=KIND_RATE,
            op="<=",
            target=0.0,
            budget=0.10,
            description="no node lost to a missed heartbeat TTL",
        ),
    ]


@dataclass
class SLOState:
    """Mutable evaluation state for one spec."""

    spec: SLOSpec
    # good/bad decisions: value 1.0 = bad sample, 0.0 = good.
    samples: RollingWindow = field(default_factory=RollingWindow)
    # Level samples of the objective counter (rate kind only).
    counter_levels: RollingWindow = field(default_factory=RollingWindow)
    last_value: float = 0.0
    status: str = STATUS_PENDING
    breached_since: Optional[float] = None
    transitions: int = 0


class SLOEngine:
    """Evaluates a set of specs against successive registry snapshots.

    ``tick(snapshot)`` samples every objective once and returns the
    list of (spec, old_status, new_status) transitions — the evaluator
    loop publishes events and dumps the flight recorder off those, so
    steady states (even steadily-breached ones) stay quiet.
    """

    def __init__(self, specs: Optional[List[SLOSpec]] = None):
        self.specs = list(specs) if specs is not None else default_slos()
        self._states: Dict[str, SLOState] = {
            s.name: SLOState(spec=s) for s in self.specs
        }
        self.last_tick = 0.0

    # -- sampling ------------------------------------------------------

    def _sample_value(
        self, st: SLOState, snapshot: Dict[str, Any], now: float
    ) -> Optional[float]:
        spec = st.spec
        raw = snapshot.get(spec.objective)
        if spec.kind == KIND_TIMER:
            if not isinstance(raw, dict):
                return None
            # Windowed percentile when the caller passes the registry
            # (tick() resolves it); the snapshot only carries lifetime
            # reservoir percentiles.
            return float(raw.get(spec.timer_field, 0.0))
        if spec.kind == KIND_RATE:
            if not isinstance(raw, (int, float)):
                return None
            st.counter_levels.observe(float(raw), ts=now)
            return st.counter_levels.rate_of_change(spec.windows[0], now=now)
        if isinstance(raw, (int, float)):
            return float(raw)
        return None

    def _timer_windowed(
        self, registry: Optional[MetricsRegistry], spec: SLOSpec, now: float
    ) -> Optional[float]:
        """Prefer the live timer's sliding window over the snapshot's
        lifetime reservoir — the whole point of the rolling windows."""
        if registry is None:
            return None
        t = registry._timers.get(spec.objective)  # read-only peek
        if t is None:
            return None
        w = t.windowed(spec.windows[1])
        if not w["count"]:
            return None
        return float(w.get(spec.timer_field, 0.0))

    # -- evaluation ----------------------------------------------------

    def tick(
        self,
        snapshot: Dict[str, Any],
        registry: Optional[MetricsRegistry] = None,
        now: Optional[float] = None,
    ) -> List[Tuple[SLOSpec, str, str]]:
        now = now if now is not None else time.time()
        self.last_tick = now
        transitions: List[Tuple[SLOSpec, str, str]] = []
        for st in self._states.values():
            spec = st.spec
            value = None
            if spec.kind == KIND_TIMER:
                value = self._timer_windowed(registry, spec, now)
                if value is None:
                    value = self._sample_value(st, snapshot, now)
            else:
                value = self._sample_value(st, snapshot, now)
            if value is None:
                continue  # objective not yet registered — no sample
            st.last_value = value
            st.samples.observe(0.0 if spec.is_good(value) else 1.0, ts=now)
            old = st.status
            st.status = self._status(st, now)
            if st.status != old:
                if st.status == STATUS_BREACHED:
                    st.breached_since = now
                elif old == STATUS_BREACHED:
                    st.breached_since = None
                st.transitions += 1
                transitions.append((spec, old, st.status))
        return transitions

    def _burn(self, st: SLOState, window_s: float, now: float) -> Tuple[float, int]:
        vals = st.samples.values(window_s, now=now)
        if not vals:
            return 0.0, 0
        bad = sum(vals) / len(vals)
        return bad / max(st.spec.budget, 1e-9), len(vals)

    def _status(self, st: SLOState, now: float) -> str:
        spec = st.spec
        fast, n_fast = self._burn(st, spec.windows[0], now)
        slow, n_slow = self._burn(st, spec.windows[1], now)
        if min(n_fast, n_slow) < spec.min_samples:
            # Keep an existing verdict until the window can overturn it.
            return st.status if st.status != STATUS_PENDING else STATUS_PENDING
        if fast > spec.fast_burn and slow > spec.slow_burn:
            return STATUS_BREACHED
        return STATUS_OK

    # -- reporting -----------------------------------------------------

    def breached(self) -> List[str]:
        return [
            n for n, st in self._states.items()
            if st.status == STATUS_BREACHED
        ]

    def state(self, name: str) -> Optional[SLOState]:
        return self._states.get(name)

    def report(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = now if now is not None else time.time()
        out: List[Dict[str, Any]] = []
        for st in self._states.values():
            spec = st.spec
            fast, n_fast = self._burn(st, spec.windows[0], now)
            slow, n_slow = self._burn(st, spec.windows[1], now)
            out.append({
                "name": spec.name,
                "objective": spec.objective,
                "kind": spec.kind,
                "op": spec.op,
                "target": spec.target,
                "value": round(st.last_value, 4),
                "status": st.status,
                "burn_rate_fast": round(fast, 4),
                "burn_rate_slow": round(slow, 4),
                "windows_s": list(spec.windows),
                "budget": spec.budget,
                "samples": [n_fast, n_slow],
                "breached_since": st.breached_since,
                "description": spec.description,
            })
        return out
