"""Scheduler package — pure logic over a state snapshot.

Mirrors the reference's ``scheduler/`` package boundary: a scheduler is a
pure function of (snapshot, eval) → plan submitted through a ``Planner``
(scheduler/scheduler.go:54-119).  The ranking pipeline runs as kernels on
the card (``nomad_tpu_torch.ops.kernels``); this package is the host
orchestration around them: the service, batch and system schedulers, and
the core scheduler that runs garbage collection.
"""

from .core import CoreScheduler
from .generic import GenericScheduler
from .system import SystemScheduler
from .stack import GenericStack, SystemStack

BUILTIN_SCHEDULERS = {
    "service": lambda *a, **kw: GenericScheduler("service", *a, **kw),
    "batch": lambda *a, **kw: GenericScheduler("batch", *a, **kw),
    "system": lambda *a, **kw: SystemScheduler(*a, **kw),
    "_core": lambda *a, **kw: CoreScheduler(*a, **kw),
}


def new_scheduler(sched_type: str, snapshot, planner, matrix=None):
    """Factory (reference: scheduler.NewScheduler, scheduler/scheduler.go:36)."""
    factory = BUILTIN_SCHEDULERS.get(sched_type)
    if factory is None:
        raise ValueError(f"unknown scheduler type {sched_type!r}")
    return factory(snapshot, planner, matrix)
