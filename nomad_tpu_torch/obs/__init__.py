"""Cluster SLO observatory — burn rates, overload signals, and the
overload control loop.

The paper's north star (≥50K evals/s @ p99 < 5 ms) expressed as
declarative :class:`~.slo.SLOSpec` objectives, evaluated continuously by
the leader's :class:`~.evaluator.SLOObservatory`, fanned out as ``SLO`` /
``Health`` events on the store's EventBroker.  The loop is closed by
:class:`~.controller.OverloadController`: pressure + burn rates drive
admission gating and priority shedding.

A copy of the reference package's ``obs`` without the device breaker
(``breaker.py``) and the ``top`` dashboard, which are not part of this
package yet.
"""

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
    "OverloadConfig",
    "OverloadController",
    "SLOEngine",
    "SLOObservatory",
    "SLOSpec",
    "STATE_GATING",
    "STATE_SHEDDING",
    "STATE_STEADY",
    "STATUS_BREACHED",
    "STATUS_OK",
    "STATUS_PENDING",
    "TOPIC_HEALTH",
    "TOPIC_SLO",
    "collect_signals",
    "compute_health",
    "default_slos",
]
