"""Eval-lifecycle tracing: spans, flight recorder, exporters.

The reference package's ``trace`` package under the same names; the
worker, broker, plan queue, applier, blocked evals, admission gate,
overload controller, scheduler stack, WAL, coalescer and device breaker
report through it.  See OBSERVABILITY.md for the span taxonomy and the
``NOMAD_TPU_TRACE*`` knobs.
"""

from .core import (
    PHASE_PREFIX,
    FlightRecorder,
    SpanContext,
    clear,
    config,
    configure,
    current,
    dump,
    event,
    record_span,
    recorder,
    set_default_metrics,
    span,
    start_trace,
    traces_by_id,
)
from .export import auto_dump, chrome_trace, dump_flight_record, trace_dir

__all__ = [
    "PHASE_PREFIX",
    "FlightRecorder",
    "SpanContext",
    "auto_dump",
    "chrome_trace",
    "clear",
    "config",
    "configure",
    "current",
    "dump",
    "dump_flight_record",
    "event",
    "record_span",
    "recorder",
    "set_default_metrics",
    "span",
    "start_trace",
    "trace_dir",
    "traces_by_id",
]
