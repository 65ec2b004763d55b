"""The SLO observatory — the server-side evaluation loop.

One background thread per leader: every ``interval`` seconds it samples
the registry, ticks the :class:`~.slo.SLOEngine`, recomputes the
composite health score, and

* publishes ``SLO`` topic events on the store's EventBroker on every
  status transition (``SLOBreached`` / ``SLORecovered``), and
  ``Health`` topic events when the status band moves — the same stream
  the store's change events ride, so a subscriber sees breaches inline
  with the cluster lifecycle events;
* dumps the flight recorder (``trace.dump_flight_record``) on a breach
  transition, with the breached SLO's name and burn rates in the
  metadata;
* serves :meth:`SLOObservatory.slo_report` and
  :meth:`SLOObservatory.health_report` from its last tick (computing on
  demand before the first one), with the device breaker's ``brief()``
  as the health report's ``device`` block, and exposes the score as
  registry gauges (``nomad.health.*``, ``nomad.slo.*``);
* steps the :class:`~.controller.OverloadController` with the report it
  just computed.

A tick is a handful of locked counter reads plus one windowed-percentile
walk per timer SLO.  A copy of the reference package's observatory.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ..metrics import RollingWindow
from ..stream.broker import Event
from . import health as health_mod
from .slo import SLOEngine, SLOSpec, STATUS_BREACHED

log = logging.getLogger(__name__)

TOPIC_SLO = "SLO"
TOPIC_HEALTH = "Health"

# SLO breach dumps get their OWN per-process budget, separate from
# trace.auto_dump's shared cap: targets can legitimately burn hot on an
# idle or small cluster, and a few breach dumps must not starve the
# other automatic dumps that share auto_dump.
_BREACH_DUMP_CAP = 4
_breach_dump_lock = threading.Lock()
_breach_dumps_used = 0


def _breach_dump(reason: str, extra: dict) -> Optional[str]:
    global _breach_dumps_used
    from ..trace import core
    from ..trace.export import dump_flight_record

    if core.recorder().span_count() == 0:
        return None
    with _breach_dump_lock:
        if _breach_dumps_used >= _BREACH_DUMP_CAP:
            return None
        _breach_dumps_used += 1
    try:
        return dump_flight_record(reason=reason, extra=extra)
    except Exception:  # noqa: BLE001
        return None


class SLOObservatory:
    """Owns the engine + health state for one server.

    Constructed at server init (so the HTTP surface always has a
    responder), started/stopped with leadership (only the leader's
    signals are authoritative — a follower's queues are idle by
    construction and would read as healthy noise).
    """

    def __init__(
        self,
        server,
        specs: Optional[List[SLOSpec]] = None,
        interval: float = 1.0,
    ):
        self.server = server
        self.interval = interval
        self.engine = SLOEngine(specs)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_health: Optional[Dict[str, Any]] = None
        self._last_signals: Dict[str, float] = {}
        self._hb_levels = RollingWindow(maxlen=512)
        self.ticks = 0
        self.breach_dumps: List[str] = []
        self._register_gauges()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="slo-observatory", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the observatory must
                # never take the leader down; a broken gauge is a log line
                log.exception("SLO observatory tick failed")

    # -- one evaluation round ------------------------------------------

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = now if now is not None else time.time()
        srv = self.server
        snapshot = self._sample_snapshot(now)
        transitions = self.engine.tick(
            snapshot, registry=srv.metrics, now=now
        )
        signals = health_mod.collect_signals(srv)
        signals["heartbeat_miss_rate"] = self._hb_miss_rate(snapshot, now)
        report = health_mod.compute_health(
            signals, breached_slos=self.engine.breached(), now=now
        )
        # The device fault domain rides on the health report, so one
        # read answers "is the card path live or refusing dispatches"
        # beside cluster health.  Guarded — a breaker bug must not stop
        # SLO evaluation.
        coal = getattr(srv, "coalescer", None)
        if coal is not None:
            try:
                report["device"] = coal.breaker.brief()
            except Exception:  # noqa: BLE001
                log.exception("device breaker brief failed")
        events: List[Event] = []
        for spec, old, new in transitions:
            events.append(self._slo_event(spec, old, new, now))
            if new == STATUS_BREACHED:
                self._dump_breach(spec, now)
        with self._lock:
            prev = self._last_health
            self._last_health = report
            self._last_signals = signals
            self.ticks += 1
        # Close the control loop: the same tick that measured pressure
        # drives the actuators (sense → decide → act share one clock, so
        # hysteresis windows in the controller line up with burn windows
        # here).  Guarded — a controller bug must not stop SLO evaluation.
        ctrl = getattr(srv, "overload_controller", None)
        if ctrl is not None and getattr(
            srv.config, "overload_enabled", False
        ):
            try:
                ctrl.step(
                    report, breached=self.engine.breached(), now=now
                )
            except Exception:  # noqa: BLE001
                log.exception("overload controller step failed")
        if prev is not None and prev["status"] != report["status"]:
            events.append(Event(
                topic=TOPIC_HEALTH,
                type="HealthChanged",
                key=report["status"],
                index=self._event_index(),
                payload={
                    "from": prev["status"],
                    "to": report["status"],
                    "score": report["score"],
                    "pressure": report["pressure"],
                    "breached_slos": report["breached_slos"],
                },
            ))
        if events:
            try:
                srv.store.events.publish(events)
            except Exception:  # noqa: BLE001
                log.exception("publishing SLO events failed")
        return report

    def _sample_snapshot(self, now: float) -> Dict[str, Any]:
        """The cheap snapshot the engine samples: the hand-rolled broker
        / worker / heartbeat signals, NOT the full registry snapshot
        (timer SLOs read their windows directly off the registry)."""
        srv = self.server
        snap: Dict[str, Any] = {}
        try:
            snap["nomad.worker.evals_processed"] = sum(
                w.evals_processed for w in srv.workers
            )
        except Exception:
            pass
        try:
            snap["nomad.heartbeat.missed"] = srv.metrics._counters.get(
                "nomad.heartbeat.missed", 0
            )
        except Exception:
            pass
        try:
            b = srv.eval_broker
            snap["nomad.broker.total_ready"] = b.ready_count()
            snap["nomad.broker.total_pending"] = b.pending_count()
            snap["nomad.blocked_evals.total_blocked"] = (
                srv.blocked_evals.blocked_count()
            )
        except Exception:
            pass
        return snap

    def _hb_miss_rate(self, snapshot: Dict[str, Any], now: float) -> float:
        level = snapshot.get("nomad.heartbeat.missed")
        if isinstance(level, (int, float)):
            self._hb_levels.observe(float(level), ts=now)
        return self._hb_levels.rate_of_change(60.0, now=now)

    # -- events + breach dumps -----------------------------------------

    def _event_index(self) -> int:
        # Observations are not FSM commits; riding the store's latest
        # index keeps the stream's per-subscriber ordering monotonic
        # without burning raft indexes on monitoring chatter.
        try:
            return self.server.store.latest_index
        except Exception:
            return 0

    def _slo_event(
        self, spec: SLOSpec, old: str, new: str, now: float
    ) -> Event:
        st = self.engine.state(spec.name)
        if st is not None:
            fast, _ = self.engine._burn(st, spec.windows[0], now)
            slow, _ = self.engine._burn(st, spec.windows[1], now)
        else:
            fast = slow = 0.0
        return Event(
            topic=TOPIC_SLO,
            type="SLOBreached" if new == STATUS_BREACHED else "SLORecovered",
            key=spec.name,
            index=self._event_index(),
            payload={
                "slo": spec.name,
                "objective": spec.objective,
                "target": spec.target,
                "op": spec.op,
                "value": round(st.last_value, 4) if st else None,
                # Burn rates at transition time — the rolling windows
                # drain fast, so a late reader of /v1/slo can't recover
                # these from a live query.
                "burn_rate_fast": round(fast, 4),
                "burn_rate_slow": round(slow, 4),
                "from": old,
                "to": new,
                "at": now,
            },
        )

    def _dump_breach(self, spec: SLOSpec, now: float) -> None:
        st = self.engine.state(spec.name)
        fast, _ = self.engine._burn(st, spec.windows[0], now)
        slow, _ = self.engine._burn(st, spec.windows[1], now)
        path = _breach_dump(
            "slo-breach-%s" % spec.name,
            extra={
                "breached_slo": spec.name,
                "objective": spec.objective,
                "target": spec.target,
                "value": round(st.last_value, 4),
                "burn_rate_fast": round(fast, 4),
                "burn_rate_slow": round(slow, 4),
            },
        )
        if path:
            self.breach_dumps.append(path)
            log.warning(
                "SLO %s breached (value=%.4g target=%s%s) — "
                "flight record dumped: %s",
                spec.name, st.last_value, spec.op, spec.target, path,
            )

    # -- read surface (the reference's /v1/slo, /v1/health; gauges) ----

    def slo_report(self) -> Dict[str, Any]:
        return {
            "slos": self.engine.report(),
            "interval_s": self.interval,
            "ticks": self.ticks,
            "evaluated_at": self.engine.last_tick or None,
        }

    def health_report(self) -> Dict[str, Any]:
        with self._lock:
            last = self._last_health
        if last is None:
            # Before the first tick (or on a follower) compute on demand
            # so the endpoint never 404s during startup.
            return self.tick()
        return last

    def _register_gauges(self) -> None:
        m = self.server.metrics

        def _health(field: str):
            def read():
                with self._lock:
                    h = self._last_health
                return h[field] if h else 0
            return read

        m.gauge_fn("nomad.health.score", _health("score"))
        m.gauge_fn("nomad.health.pressure", _health("pressure"))
        m.gauge_fn(
            "nomad.health.degraded",
            lambda: int(bool(
                self._last_health
                and self._last_health["status"] != health_mod.STATUS_OK
            )),
        )
        for spec in self.engine.specs:
            st = self.engine.state(spec.name)
            m.gauge_fn(
                "nomad.slo.breached",
                (lambda s: lambda: int(s.status == STATUS_BREACHED))(st),
                slo=spec.name,
            )
            m.gauge_fn(
                "nomad.slo.burn_rate",
                (lambda s: lambda: round(
                    self.engine._burn(s, s.spec.windows[0], time.time())[0], 4
                ))(st),
                slo=spec.name,
            )
