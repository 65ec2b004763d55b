"""Cluster SLO observatory — burn rates, overload signals, and the
overload control loop.

The paper's north star (≥50K evals/s @ p99 < 5 ms) expressed as
declarative :class:`~.slo.SLOSpec` objectives, evaluated continuously by
the leader's :class:`~.evaluator.SLOObservatory`, fanned out as ``SLO`` /
``Health`` events on the store's EventBroker.  The loop is closed by
:class:`~.controller.OverloadController`: pressure + burn rates drive
admission gating and priority shedding.

The device fault domain lives in :mod:`.breaker`: the coalescer's
fetch watchdog (:func:`~.breaker.watchdog_fetch`), the wedged-vs-slow
verdict (:func:`~.breaker.classify_stall`), and the
closed→open→half-open :class:`~.breaker.DeviceBreaker`, under which a
sick card's dispatches are refused (:class:`~.breaker.DeviceBreakerOpenError`)
rather than scored on the host.  Its ``brief()`` rides on the health
report as the ``device`` block, and :mod:`.top` renders it.
"""

from .breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    BreakerConfig,
    DeviceBreaker,
    DeviceBreakerOpenError,
    DeviceWedgedError,
    STALL_OK,
    STALL_SLOW,
    STALL_WEDGED,
    classify_stall,
    watchdog_fetch,
)
from .controller import (
    OverloadConfig,
    OverloadController,
    STATE_GATING,
    STATE_SHEDDING,
    STATE_STEADY,
)
from .evaluator import SLOObservatory, TOPIC_HEALTH, TOPIC_SLO
from .health import compute_health, collect_signals
from .slo import (
    SLOEngine,
    SLOSpec,
    STATUS_BREACHED,
    STATUS_OK,
    STATUS_PENDING,
    default_slos,
)

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "BreakerConfig",
    "DeviceBreaker",
    "DeviceBreakerOpenError",
    "DeviceWedgedError",
    "OverloadConfig",
    "OverloadController",
    "SLOEngine",
    "SLOObservatory",
    "SLOSpec",
    "STATE_GATING",
    "STATE_SHEDDING",
    "STATE_STEADY",
    "STALL_OK",
    "STALL_SLOW",
    "STALL_WEDGED",
    "STATUS_BREACHED",
    "STATUS_OK",
    "STATUS_PENDING",
    "TOPIC_HEALTH",
    "TOPIC_SLO",
    "classify_stall",
    "collect_signals",
    "compute_health",
    "default_slos",
    "watchdog_fetch",
]
