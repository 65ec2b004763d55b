"""Device fault domain — watchdog classification + circuit breaker.

The live dispatch path's most common real failure is not a wrong answer
but a *missing* one: a card that stops answering, or a pathologically
slow result.  The coalescer's resolver thread waits once per ticket for
the event that marks the ticket's kernels and its device→host copy
done; without a bound, a wedged launch stalls the whole pipeline and
every caller's future forever.  Three pieces close that hole:

* :func:`classify_stall` — the one shared wedged-vs-slow definition.
  A wait that finishes inside its deadline is ``ok``; inside
  ``deadline * wedge_factor`` it is ``slow`` (late but usable); past
  that bound it is ``wedged`` (abandoned).
* :func:`watchdog_fetch` — run a fetch under that deadline on a
  sacrificial daemon thread (a blocking wait cannot be interrupted from
  Python; a wedged one is abandoned, never joined) and return the
  verdict plus the value.  The coalescer's resolver polls its ticket's
  CUDA event instead (``scheduler.coalescer.poll_until``: the same bound
  and verdicts, no thread, no uninterruptible call).  A wedged ticket's
  futures complete with a typed :class:`DeviceWedgedError` — callers
  never hang.
* :class:`DeviceBreaker` — a closed→open→half-open breaker over the
  stream of fetch verdicts, with the hysteresis pattern of
  :class:`..obs.controller.OverloadController`: min-dwell
  (``probation_s`` in the open state), cooldown, and a bounded flip
  rate that freezes the breaker rather than let a flapping device make
  it oscillate.  After probation, half-open admits exactly one canary
  launch before re-closing.

A copy of the reference package's ``obs/breaker.py`` with one
difference in what an open breaker means: the reference degrades to a
host twin of the kernels, and this package has none on the card path (a
plain version run there would be a silent fallback).  So while the
breaker is open, or half-open with its canary in flight, the coalescer
launches nothing and completes the dispatch's lanes with
:class:`DeviceBreakerOpenError`; the worker nacks those evals, the
broker redelivers them up to its delivery limit, and the failed-eval
reaper retries them after ``ServerConfig.failed_eval_unblock_delay``.
``degraded_dispatches`` counts those refused dispatches.

Every breaker state transition emits a trace event AND increments a
registered counter.  The breaker's ``brief()`` rides on the observatory's
health report (the ``device`` block) and the ``top`` device row; knobs
are ``NOMAD_TPU_DEVICE_*`` (README).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from .. import trace
from ..metrics import RollingWindow
from ..retry import env_float, env_int

BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"

_LEVELS = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}
_STATES = {v: k for k, v in _LEVELS.items()}

STALL_OK = "ok"
STALL_SLOW = "slow"
STALL_WEDGED = "wedged"


class DeviceWedgedError(RuntimeError):
    """A wait on the card blew through its watchdog bound and was
    abandoned.

    Raised out of ``DeviceCoalescer.place`` for every lane of a wedged
    ticket; propagates scheduler → worker, where the existing exception
    path nacks the eval back to the broker via its delivery token, so a
    wedged launch costs one redelivery instead of a hung worker.
    """

    def __init__(
        self, message: str, elapsed_s: float = 0.0, deadline_s: float = 0.0
    ):
        super().__init__(message)
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s


class DeviceBreakerOpenError(RuntimeError):
    """The breaker refused a dispatch: it is open, or half-open with its
    one canary launch in flight.  Nothing was launched; like
    :class:`DeviceWedgedError` it propagates to the worker, which nacks
    the eval."""

    def __init__(self, state: str):
        super().__init__(f"device breaker {state}: dispatch refused")
        self.state = state


def classify_stall(
    elapsed_s: float, deadline_s: float, wedge_factor: float = 1.5
) -> str:
    """The shared wedged-vs-slow verdict for an elapsed device wait.

    ``deadline_s <= 0`` disables the watchdog (always ``ok``).  The
    slow band is ``(deadline, deadline * wedge_factor]`` — late enough
    to count against the breaker, alive enough to use the result.
    """
    if deadline_s <= 0 or elapsed_s <= deadline_s:
        return STALL_OK
    if elapsed_s <= deadline_s * wedge_factor:
        return STALL_SLOW
    return STALL_WEDGED


def watchdog_fetch(
    fetch: Callable[[], Any],
    deadline_s: float,
    wedge_factor: float = 1.5,
) -> Tuple[str, Any, float]:
    """Run ``fetch()`` under the watchdog; returns ``(verdict, value,
    elapsed_s)``.

    The fetch runs on a sacrificial daemon thread because a wait on a
    wedged card cannot be interrupted from Python — on a ``wedged``
    verdict the thread is abandoned (its eventual result, if any, is
    discarded) and ``value`` is ``None``.  A ``slow`` verdict means the
    fetch completed inside the wedge bound: the value is real and
    usable, just late.  An exception raised by the fetch inside the
    bound re-raises here so callers' existing error paths apply.
    """
    if deadline_s <= 0:
        t0 = time.monotonic()
        return STALL_OK, fetch(), time.monotonic() - t0
    box: Dict[str, Any] = {}
    fetched = threading.Event()

    def _run() -> None:
        try:
            box["value"] = fetch()
        except BaseException as e:  # noqa: BLE001 — ferried to the caller
            box["error"] = e
        finally:
            fetched.set()

    t0 = time.monotonic()
    th = threading.Thread(target=_run, name="device-fetch", daemon=True)
    th.start()
    if not fetched.wait(deadline_s):
        # Past the deadline: grant the slow band before declaring a
        # wedge — a fetch that lands here is recorded against the
        # breaker but its result still serves the waiting lanes.
        fetched.wait(max(0.0, deadline_s * (wedge_factor - 1.0)))
    elapsed = time.monotonic() - t0
    if not fetched.is_set():
        return STALL_WEDGED, None, elapsed
    if "error" in box:
        raise box["error"]
    return classify_stall(elapsed, deadline_s, wedge_factor), box["value"], elapsed


@dataclass(frozen=True)
class BreakerConfig:
    """Watchdog deadline + breaker thresholds and hysteresis knobs.

    Defaults come from ``NOMAD_TPU_DEVICE_*`` env vars (see README).
    ``deadline_ms <= 0`` disables the watchdog entirely (and with it
    the breaker's fault signal).  The first fetch after a (re)start gets
    ``deadline_ms * cold_scale``: in the reference it waits for an XLA
    compile; here the kernels' ``nvcc`` build runs in the dispatch
    thread before the ticket exists, so the first wait covers only the
    first launch's module load and run.
    """

    deadline_ms: float = 60000.0
    cold_scale: float = 5.0
    wedge_factor: float = 1.5
    # Trip thresholds over the outcome window: any `trip_wedges` wedges
    # open the breaker; a slow fraction >= slow_ratio (with at least
    # min_samples outcomes) opens it too.
    trip_wedges: int = 1
    slow_ratio: float = 0.5
    min_samples: int = 4
    window_s: float = 30.0
    # Hysteresis (the OverloadController pattern): the open state dwells
    # `probation_s` before half-open admits one canary; `cooldown_s`
    # spaces flips; past `max_flips` per `flip_window_s` the breaker
    # freezes in place and counts suppressions instead of flapping.
    probation_s: float = 5.0
    cooldown_s: float = 1.0
    max_flips: int = 6
    flip_window_s: float = 60.0

    @classmethod
    def from_env(cls) -> "BreakerConfig":
        return cls(
            deadline_ms=env_float("NOMAD_TPU_DEVICE_DEADLINE_MS", cls.deadline_ms),
            cold_scale=env_float("NOMAD_TPU_DEVICE_COLD_SCALE", cls.cold_scale),
            wedge_factor=env_float(
                "NOMAD_TPU_DEVICE_WEDGE_FACTOR", cls.wedge_factor
            ),
            trip_wedges=env_int("NOMAD_TPU_DEVICE_TRIP_WEDGES", cls.trip_wedges),
            slow_ratio=env_float("NOMAD_TPU_DEVICE_SLOW_RATIO", cls.slow_ratio),
            min_samples=env_int(
                "NOMAD_TPU_DEVICE_MIN_SAMPLES", cls.min_samples
            ),
            window_s=env_float("NOMAD_TPU_DEVICE_WINDOW", cls.window_s),
            probation_s=env_float(
                "NOMAD_TPU_DEVICE_PROBATION", cls.probation_s
            ),
            cooldown_s=env_float("NOMAD_TPU_DEVICE_COOLDOWN", cls.cooldown_s),
            max_flips=env_int("NOMAD_TPU_DEVICE_MAX_FLIPS", cls.max_flips),
            flip_window_s=env_float(
                "NOMAD_TPU_DEVICE_FLIP_WINDOW", cls.flip_window_s
            ),
        )


class DeviceBreaker:
    """Closed→open→half-open breaker over device-fetch verdicts.

    One per coalescer.  The resolver thread records every fetch verdict
    (``record_ok``/``record_slow``/``record_wedge``); the dispatch
    thread consults :meth:`allow_device_dispatch` before each launch.
    All timestamps are injectable so unit tests drive the hysteresis
    with synthetic clocks.
    """

    def __init__(
        self,
        metrics=None,
        config: Optional[BreakerConfig] = None,
    ):
        self.metrics = metrics
        self.cfg = config or BreakerConfig.from_env()
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self._entered_at = 0.0
        self._last_flip = 0.0
        self._seen = 0  # fetches observed; 0 → next deadline is cold-scaled
        self._wedges = RollingWindow(maxlen=512)
        self._slows = RollingWindow(maxlen=1024)
        self._oks = RollingWindow(maxlen=2048)
        self._flip_times = RollingWindow(maxlen=512)
        self._canary_inflight = False
        self.consecutive_wedges = 0
        self.wedges_total = 0
        self.slows_total = 0
        self.oks_total = 0
        self.trips_total = 0  # transitions INTO open
        self.flips_total = 0
        self.flips_suppressed = 0
        self.degraded_dispatches = 0
        self.evacuations = 0
        self.decisions: deque = deque(maxlen=32)
        self._register_gauges()

    # -- gauges ---------------------------------------------------------

    def _register_gauges(self) -> None:
        m = self.metrics
        if m is None:
            return
        m.gauge_fn("nomad.breaker.state", lambda: _LEVELS[self.state])
        m.gauge_fn("nomad.breaker.trips", lambda: self.trips_total)
        m.gauge_fn("nomad.breaker.wedged", lambda: self.wedges_total)
        m.gauge_fn("nomad.breaker.slow", lambda: self.slows_total)
        m.gauge_fn("nomad.breaker.degraded", lambda: self.degraded_dispatches)
        m.gauge_fn("nomad.breaker.evacuations", lambda: self.evacuations)

    # -- watchdog parameters -------------------------------------------

    def deadline_s(self) -> float:
        """Current fetch deadline in seconds (0 disables).  The first
        fetch after a (re)start gets ``cold_scale``."""
        base = max(0.0, self.cfg.deadline_ms) / 1000.0
        if base <= 0:
            return 0.0
        with self._lock:
            return base * (self.cfg.cold_scale if self._seen == 0 else 1.0)

    # -- verdict stream (resolver thread) ------------------------------

    def record_ok(
        self, elapsed_s: float = 0.0, canary: bool = False,
        now: Optional[float] = None,
    ) -> str:
        now = now if now is not None else time.time()
        with self._lock:
            self._seen += 1
            self.oks_total += 1
            self._oks.observe(1.0, ts=now)
            self.consecutive_wedges = 0
            if self.state == BREAKER_HALF_OPEN and canary:
                self._canary_inflight = False
                self._transition_locked(
                    0, now, f"canary ok in {elapsed_s * 1e3:.0f}ms"
                )
            return self.state

    def record_slow(
        self, elapsed_s: float = 0.0, canary: bool = False,
        now: Optional[float] = None,
    ) -> str:
        now = now if now is not None else time.time()
        with self._lock:
            self._seen += 1
            self.slows_total += 1
            self._slows.observe(1.0, ts=now)
            self.consecutive_wedges = 0
            if self.state == BREAKER_HALF_OPEN and canary:
                self._canary_inflight = False
                self._transition_locked(
                    2, now, f"canary slow ({elapsed_s * 1e3:.0f}ms)"
                )
            elif self.state == BREAKER_CLOSED and self._slow_trips_locked(now):
                self._transition_locked(
                    2, now, f"slow rate over {self.cfg.slow_ratio:.0%}"
                )
            return self.state

    def record_wedge(
        self, elapsed_s: float = 0.0, canary: bool = False,
        now: Optional[float] = None,
    ) -> str:
        now = now if now is not None else time.time()
        with self._lock:
            self._seen += 1
            self.wedges_total += 1
            self._wedges.observe(1.0, ts=now)
            self.consecutive_wedges += 1
            if canary:
                self._canary_inflight = False
            if self.state != BREAKER_OPEN:
                wedged = self._wedges.count(self.cfg.window_s, now=now)
                if wedged >= self.cfg.trip_wedges:
                    self._transition_locked(
                        2, now,
                        f"{wedged} wedge(s) in {self.cfg.window_s:.0f}s "
                        f"(last {elapsed_s * 1e3:.0f}ms)",
                    )
            return self.state

    def _slow_trips_locked(self, now: float) -> bool:
        c = self.cfg
        slow = self._slows.count(c.window_s, now=now)
        ok = self._oks.count(c.window_s, now=now)
        total = slow + ok + self._wedges.count(c.window_s, now=now)
        return total >= c.min_samples and slow / total >= c.slow_ratio

    # -- dispatch gate (dispatch thread) -------------------------------

    def allow_device_dispatch(
        self, now: Optional[float] = None
    ) -> Tuple[bool, bool]:
        """Consulted once per dispatch: ``(allowed, canary)``.

        Closed → always allowed.  Open → denied until ``probation_s``
        has elapsed, then the breaker moves to half-open and admits
        exactly one in-flight canary launch; further dispatches are
        refused until the canary's verdict lands.
        """
        now = now if now is not None else time.time()
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True, False
            if self.state == BREAKER_OPEN:
                if now - self._entered_at < self.cfg.probation_s:
                    return False, False
                self._transition_locked(1, now, "probation expired")
                if self.state != BREAKER_HALF_OPEN:
                    return False, False
            if not self._canary_inflight:
                self._canary_inflight = True
                return True, True
            return False, False

    def cancel_canary(self) -> None:
        """The canary launch died before producing a verdict (launch
        error, shutdown) — release the slot so half-open can retry."""
        with self._lock:
            self._canary_inflight = False

    def note_degraded(self) -> None:
        """A dispatch the breaker refused (nothing launched)."""
        with self._lock:
            self.degraded_dispatches += 1

    def note_evacuation(self) -> None:
        """A shard evacuation of the node-sharded dispatch
        (``DeviceCoalescer.evacuate_shard``)."""
        with self._lock:
            self.evacuations += 1

    # -- transitions (every _apply_transition call site must emit a
    # trace event AND increment a nomad.* counter) ---------------------

    def _transition_locked(self, target: int, now: float, reason: str) -> str:
        prev = self.state
        if target == _LEVELS[prev]:
            return self.state
        if not self._may_flip_locked(now):
            return self.state
        self._apply_transition(target, now)
        trace.event(
            "seam.breaker.transition", frm=prev, to=self.state, reason=reason
        )
        m = self.metrics
        if m is not None:
            m.incr("nomad.breaker.transitions", to=self.state)
        self.decisions.append({
            "at": round(now, 3), "from": prev, "to": self.state,
            "reason": reason,
        })
        return self.state

    def _may_flip_locked(self, now: float) -> bool:
        c = self.cfg
        if self._last_flip and now - self._last_flip < c.cooldown_s:
            return False
        recent = len(self._flip_times.values(c.flip_window_s, now=now))
        if recent >= c.max_flips:
            # Flip budget exhausted: freeze in place rather than
            # oscillate with a flapping device.
            self.flips_suppressed += 1
            m = self.metrics
            if m is not None:
                m.incr("nomad.breaker.flips_suppressed")
            return False
        return True

    def _apply_transition(
        self, target: int, now: float, count_flip: bool = True
    ) -> None:
        """State mutation only — the callers own the trace event +
        counter emission."""
        self.state = _STATES[target]
        self._entered_at = now
        if count_flip:
            self._last_flip = now
            self._flip_times.observe(1.0, ts=now)
            self.flips_total += 1
        if self.state == BREAKER_OPEN:
            self.trips_total += 1
            self._canary_inflight = False
        elif self.state == BREAKER_CLOSED:
            self._canary_inflight = False

    # -- lifecycle ------------------------------------------------------

    def reset(self) -> None:
        """Force-close and clear windows (leadership revoked /
        coalescer restart).  Dwell, cooldown, and the flip budget do not
        apply — a forced release is not a flap."""
        now = time.time()
        with self._lock:
            if self.state != BREAKER_CLOSED:
                prev = self.state
                self._apply_transition(0, now, count_flip=False)
                trace.event(
                    "seam.breaker.transition", frm=prev, to=self.state,
                    reason="reset",
                )
                m = self.metrics
                if m is not None:
                    m.incr("nomad.breaker.transitions", to=self.state)
            self._entered_at = 0.0
            self._wedges = RollingWindow(maxlen=512)
            self._slows = RollingWindow(maxlen=1024)
            self._oks = RollingWindow(maxlen=2048)
            self.consecutive_wedges = 0
            self._canary_inflight = False

    # -- read surface (the health report's "device" block, top) -------

    def brief(self) -> Dict[str, Any]:
        """Compact dict for the health report's ``device`` block."""
        with self._lock:
            return {
                "breaker": self.state,
                "since": self._entered_at or None,
                "trips": self.trips_total,
                "wedged": self.wedges_total,
                "slow": self.slows_total,
                "consecutive_wedges": self.consecutive_wedges,
                "degraded_dispatches": self.degraded_dispatches,
                "evacuations": self.evacuations,
            }

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = now if now is not None else time.time()
        c = self.cfg
        with self._lock:
            return {
                "state": self.state,
                "since": self._entered_at or None,
                "outcomes": {
                    "ok": self.oks_total,
                    "slow": self.slows_total,
                    "wedged": self.wedges_total,
                },
                "window": {
                    "ok": self._oks.count(c.window_s, now=now),
                    "slow": self._slows.count(c.window_s, now=now),
                    "wedged": self._wedges.count(c.window_s, now=now),
                    "width_s": c.window_s,
                },
                "consecutive_wedges": self.consecutive_wedges,
                "trips": self.trips_total,
                "flips": {
                    "total": self.flips_total,
                    "suppressed": self.flips_suppressed,
                    "recent": len(
                        self._flip_times.values(c.flip_window_s, now=now)
                    ),
                },
                "degraded_dispatches": self.degraded_dispatches,
                "evacuations": self.evacuations,
                "thresholds": {
                    "deadline_ms": c.deadline_ms,
                    "cold_scale": c.cold_scale,
                    "wedge_factor": c.wedge_factor,
                    "trip_wedges": c.trip_wedges,
                    "slow_ratio": c.slow_ratio,
                    "min_samples": c.min_samples,
                },
                "hysteresis": {
                    "probation_s": c.probation_s,
                    "cooldown_s": c.cooldown_s,
                    "max_flips": c.max_flips,
                    "flip_window_s": c.flip_window_s,
                },
                "decisions": list(self.decisions),
                "evaluated_at": now,
            }
