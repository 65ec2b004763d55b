"""Overload controller — closes the SLO control loop.

The sensors are the multi-window burn rates (:mod:`.slo`), the
composite pressure score (:mod:`.health`), and the observatory loop
that evaluates both every second.  This module is the *decide* half of
the sense→decide→act→verify loop: a leader-side state machine that
consumes the composite pressure and the breached-SLO set each
observatory tick and drives three actuators:

* **admission gating** — ``server.admission_gate`` (per-namespace token
  buckets in :mod:`..server.admission`): engaging the gate scales every
  namespace's refill rate down, so excess submissions turn into HTTP
  429 + ``Retry-After`` instead of queue growth;
* **priority shedding** — ``server.eval_broker.set_shedding``: under
  sustained breach the broker defers the lowest-priority evals with
  jittered re-enqueue delays (backpressure, not backlog);
* **fair dequeue** is structural (per-namespace deficit round-robin in
  :mod:`..server.blocked_evals`) and always on — the controller only
  reports its stats.

Anti-oscillation is explicit, because a controller that flaps is worse
than no controller (each flip is a cluster-wide behavior change):

* **multi-window thresholds** — escalation is judged on the fast
  pressure window (react within one short burn period); de-escalation
  requires BOTH the fast and slow windows below the *exit* threshold,
  and every exit threshold sits below its enter threshold;
* **minimum dwell** — a new state holds for ``min_dwell`` seconds
  before any further transition is considered;
* **cooldown** — after any flip, no new flip for ``cooldown`` seconds;
* **bounded flip rate** — at most ``max_flips`` transitions per
  ``flip_window`` seconds; past the budget the controller freezes in
  its current state and counts the suppression instead of flapping.

Every actuator decision site emits a trace event and increments a
registered counter.  The full decision surface is :meth:`report` (the
reference serves it at ``GET /v1/overload``).  A copy of the reference
package's controller without its chaos seam (injected lost actuations,
so ``actuations_lost`` stays 0 here).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .. import trace
from ..metrics import RollingWindow
from ..retry import env_float, env_int

STATE_STEADY = "steady"
STATE_GATING = "gating"
STATE_SHEDDING = "shedding"

_LEVELS = {STATE_STEADY: 0, STATE_GATING: 1, STATE_SHEDDING: 2}
_STATES = {v: k for k, v in _LEVELS.items()}


@dataclass(frozen=True)
class OverloadConfig:
    """Controller thresholds + hysteresis knobs.

    Defaults come from ``NOMAD_TPU_OVERLOAD_*`` env vars (see README);
    enter thresholds are composite-pressure values in [0,1] sized so an
    idle or lightly loaded server (pressure ≈ 0) never engages.  A
    breached SLO scales the enter thresholds by ``breach_factor`` — a
    burning error budget lowers the bar, but pure breach with zero
    queue pressure (an idle test server missing its throughput floor)
    never actuates.
    """

    gate_enter: float = 0.35
    gate_exit: float = 0.20
    shed_enter: float = 0.50
    shed_exit: float = 0.30
    breach_factor: float = 0.75
    window_fast: float = 5.0
    window_slow: float = 30.0
    min_dwell: float = 5.0
    cooldown: float = 2.0
    max_flips: int = 6
    flip_window: float = 60.0
    # Shedding actuation parameters handed to the broker.
    shed_priority_floor: int = 50
    shed_delay: float = 2.0
    shed_jitter: float = 0.5
    # Admission-gate rate scale per level (index = level).
    gate_factors: tuple = (1.0, 0.5, 0.25)
    retry_after: float = 2.0

    @classmethod
    def from_env(cls) -> "OverloadConfig":
        return cls(
            gate_enter=env_float("NOMAD_TPU_OVERLOAD_GATE_ENTER", cls.gate_enter),
            gate_exit=env_float("NOMAD_TPU_OVERLOAD_GATE_EXIT", cls.gate_exit),
            shed_enter=env_float("NOMAD_TPU_OVERLOAD_SHED_ENTER", cls.shed_enter),
            shed_exit=env_float("NOMAD_TPU_OVERLOAD_SHED_EXIT", cls.shed_exit),
            breach_factor=env_float(
                "NOMAD_TPU_OVERLOAD_BREACH_FACTOR", cls.breach_factor
            ),
            window_fast=env_float(
                "NOMAD_TPU_OVERLOAD_WINDOW_FAST", cls.window_fast
            ),
            window_slow=env_float(
                "NOMAD_TPU_OVERLOAD_WINDOW_SLOW", cls.window_slow
            ),
            min_dwell=env_float("NOMAD_TPU_OVERLOAD_DWELL", cls.min_dwell),
            cooldown=env_float("NOMAD_TPU_OVERLOAD_COOLDOWN", cls.cooldown),
            max_flips=env_int("NOMAD_TPU_OVERLOAD_MAX_FLIPS", cls.max_flips),
            flip_window=env_float(
                "NOMAD_TPU_OVERLOAD_FLIP_WINDOW", cls.flip_window
            ),
            shed_priority_floor=env_int(
                "NOMAD_TPU_OVERLOAD_SHED_PRIORITY", cls.shed_priority_floor
            ),
            shed_delay=env_float(
                "NOMAD_TPU_OVERLOAD_SHED_DELAY", cls.shed_delay
            ),
            retry_after=env_float(
                "NOMAD_TPU_OVERLOAD_RETRY_AFTER", cls.retry_after
            ),
        )


class OverloadController:
    """One per server, stepped by the leader's observatory tick.

    Pure state machine otherwise: ``step(report, breached, now)`` takes
    the health report the observatory just computed, so unit tests
    drive it with synthetic pressure without a server (``server`` is
    duck-typed — only ``admission_gate``, ``eval_broker``,
    ``blocked_evals``, ``metrics`` are touched).
    """

    def __init__(self, server, config: Optional[OverloadConfig] = None):
        self.server = server
        self.cfg = config or OverloadConfig.from_env()
        self._lock = threading.Lock()
        self.state = STATE_STEADY
        self._entered_at = 0.0
        self._last_flip = 0.0
        self._pressure = RollingWindow(maxlen=2048)
        self._flip_times = RollingWindow(maxlen=512)
        self._fast = 0.0
        self._slow = 0.0
        self._breached: List[str] = []
        self.steps = 0
        self.flips_total = 0
        self.flips_suppressed = 0
        self.actuations_lost = 0
        self.decisions: deque = deque(maxlen=32)
        self._register_gauges()

    # -- gauges ---------------------------------------------------------

    def _register_gauges(self) -> None:
        m = getattr(self.server, "metrics", None)
        if m is None:
            return
        m.gauge_fn("nomad.overload.state", lambda: _LEVELS[self.state])
        m.gauge_fn("nomad.overload.pressure_fast", lambda: round(self._fast, 4))
        m.gauge_fn("nomad.overload.pressure_slow", lambda: round(self._slow, 4))
        m.gauge_fn("nomad.overload.flips_total", lambda: self.flips_total)

    # -- the decide step ------------------------------------------------

    def step(
        self,
        report: Dict[str, Any],
        breached: Optional[List[str]] = None,
        now: Optional[float] = None,
    ) -> str:
        """One control decision off a health report; returns the state
        after the step.  Called from the observatory tick (leader-only),
        so actuations happen at most once per tick."""
        now = now if now is not None else time.time()
        with self._lock:
            self.steps += 1
            self._breached = list(breached or [])
            self._pressure.observe(float(report.get("pressure", 0.0)), ts=now)
            fast_vals = self._pressure.values(self.cfg.window_fast, now=now)
            slow_vals = self._pressure.values(self.cfg.window_slow, now=now)
            self._fast = sum(fast_vals) / len(fast_vals) if fast_vals else 0.0
            self._slow = sum(slow_vals) / len(slow_vals) if slow_vals else 0.0
            target = self._target_locked()
            if target == _LEVELS[self.state]:
                return self.state
            if not self._may_flip_locked(now):
                return self.state
            return self._transition_locked(target, now)

    def _target_locked(self) -> int:
        c = self.cfg
        cur = _LEVELS[self.state]
        factor = c.breach_factor if self._breached else 1.0
        # Escalation: the fast window alone decides, so the controller
        # reacts within one short burn-rate period (and may jump
        # straight to shedding on a hard spike).
        if self._fast >= c.shed_enter * factor:
            return 2
        if self._fast >= c.gate_enter * factor and cur < 2:
            return max(cur, 1)
        # De-escalation: one level at a time, both windows must clear
        # the exit threshold.  Breach alone does NOT hold the gate —
        # an SLO can stay breached with zero queue pressure (an idle
        # server under its throughput floor), and gating fixes nothing
        # the pressure score can't see.
        worst = max(self._fast, self._slow)
        if cur == 2 and worst <= c.shed_exit:
            return 1
        if cur == 1 and worst <= c.gate_exit:
            return 0
        return cur

    def _may_flip_locked(self, now: float) -> bool:
        c = self.cfg
        if self._entered_at and now - self._entered_at < c.min_dwell:
            return False
        if self._last_flip and now - self._last_flip < c.cooldown:
            return False
        recent = len(self._flip_times.values(c.flip_window, now=now))
        if recent >= c.max_flips:
            # Flip budget exhausted: freeze rather than oscillate.
            self.flips_suppressed += 1
            m = getattr(self.server, "metrics", None)
            if m is not None:
                m.incr("nomad.overload.flips_suppressed")
            return False
        return True

    def _transition_locked(self, target: int, now: float) -> str:
        prev = self.state
        reason = (
            f"fast={self._fast:.3f} slow={self._slow:.3f} "
            f"breached={','.join(self._breached) or '-'}"
        )
        actuate = {
            0: self._actuate_steady,
            1: self._actuate_gating,
            2: self._actuate_shedding,
        }[target]
        if not actuate(reason):
            # Actuation lost: state unchanged, the next tick re-drives
            # the same target — no half-applied state.
            self.actuations_lost += 1
            return self.state
        self.state = _STATES[target]
        self._entered_at = now
        self._last_flip = now
        self._flip_times.observe(1.0, ts=now)
        self.flips_total += 1
        self.decisions.append({
            "at": round(now, 3), "from": prev, "to": self.state,
            "reason": reason,
        })
        return self.state

    # -- actuator decision sites (each emits a trace event and a
    # counter) ----------------------------------------------------------

    def _actuate_steady(self, reason: str) -> bool:
        srv = self.server
        srv.admission_gate.set_gate_level(1.0, retry_after=self.cfg.retry_after)
        srv.eval_broker.set_shedding(False)
        trace.event("seam.controller.actuate", target=STATE_STEADY,
                    reason=reason)
        srv.metrics.incr("nomad.overload.actuations", target=STATE_STEADY)
        return True

    def _actuate_gating(self, reason: str) -> bool:
        srv = self.server
        srv.admission_gate.set_gate_level(
            self.cfg.gate_factors[1], retry_after=self.cfg.retry_after
        )
        srv.eval_broker.set_shedding(False)
        trace.event("seam.controller.actuate", target=STATE_GATING,
                    reason=reason)
        srv.metrics.incr("nomad.overload.actuations", target=STATE_GATING)
        return True

    def _actuate_shedding(self, reason: str) -> bool:
        c = self.cfg
        srv = self.server
        srv.admission_gate.set_gate_level(
            c.gate_factors[2], retry_after=c.retry_after
        )
        srv.eval_broker.set_shedding(
            True, priority_floor=c.shed_priority_floor,
            delay=c.shed_delay, jitter=c.shed_jitter,
        )
        trace.event("seam.controller.actuate", target=STATE_SHEDDING,
                    reason=reason)
        srv.metrics.incr("nomad.overload.actuations", target=STATE_SHEDDING)
        return True

    # -- lifecycle ------------------------------------------------------

    def reset(self) -> None:
        """Release every actuator (leadership revoked / shutdown) —
        dwell and cooldown do not apply: a non-leader must not keep
        gating, and the flip budget should not count forced releases."""
        with self._lock:
            if self.state != STATE_STEADY and self._actuate_steady("reset"):
                self.state = STATE_STEADY
                self._entered_at = 0.0
            self._pressure = RollingWindow(maxlen=2048)
            self._fast = self._slow = 0.0
            self._breached = []

    # -- read surface (/v1/overload, nomad top) ------------------------

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = now if now is not None else time.time()
        srv = self.server
        with self._lock:
            out: Dict[str, Any] = {
                "state": self.state,
                "since": self._entered_at or None,
                "pressure": {
                    "fast": round(self._fast, 4),
                    "slow": round(self._slow, 4),
                },
                "breached_slos": list(self._breached),
                "thresholds": {
                    "gate_enter": self.cfg.gate_enter,
                    "gate_exit": self.cfg.gate_exit,
                    "shed_enter": self.cfg.shed_enter,
                    "shed_exit": self.cfg.shed_exit,
                    "breach_factor": self.cfg.breach_factor,
                },
                "hysteresis": {
                    "window_fast_s": self.cfg.window_fast,
                    "window_slow_s": self.cfg.window_slow,
                    "min_dwell_s": self.cfg.min_dwell,
                    "cooldown_s": self.cfg.cooldown,
                    "max_flips": self.cfg.max_flips,
                    "flip_window_s": self.cfg.flip_window,
                },
                "flips": {
                    "total": self.flips_total,
                    "suppressed": self.flips_suppressed,
                    "recent": len(
                        self._flip_times.values(self.cfg.flip_window, now=now)
                    ),
                },
                "steps": self.steps,
                "actuations_lost": self.actuations_lost,
                "decisions": list(self.decisions),
                "evaluated_at": now,
            }
        actuators: Dict[str, Any] = {}
        try:
            actuators["admission"] = srv.admission_gate.stats()
        except Exception:  # noqa: BLE001 — duck-typed server in tests
            pass
        try:
            actuators["shed"] = srv.eval_broker.shed_stats()
        except Exception:  # noqa: BLE001
            pass
        try:
            actuators["dequeue"] = srv.blocked_evals.fairness_stats()
        except Exception:  # noqa: BLE001
            pass
        out["actuators"] = actuators
        return out
