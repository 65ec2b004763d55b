"""No-op tracing hooks.

The copied host modules keep their ``trace.span`` / ``trace.event`` call
sites; in this package they record nothing.  The signatures match the
JAX package's ``trace`` so a later slice can put a recorder behind them
without touching a call site.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator, Optional


class SpanContext:
    """Placeholder trace context (no ids are allocated)."""


def current() -> Optional[SpanContext]:
    return None


def start_trace(trace_id: str) -> Optional[SpanContext]:
    return None


def set_default_metrics(registry: Any) -> None:
    return None


def record_span(name: str, t0: float, t1: float,
                ctx: Optional[SpanContext] = None,
                parent: Optional[int] = None, metrics: Any = None,
                **args: Any) -> None:
    return None


def event(name: str, ctx: Optional[SpanContext] = None,
          **args: Any) -> None:
    return None


@contextmanager
def span(name: str, ctx: Optional[SpanContext] = None,
         trace_id: Optional[str] = None, metrics: Any = None,
         **args: Any) -> Iterator[Optional[SpanContext]]:
    yield None
