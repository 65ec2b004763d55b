"""Server core — control plane around the card-resident scheduler.

The reference's server (``nomad/``) wires a state store, an eval broker,
blocked-eval tracking, scheduling workers, and a single serialized plan
applier (``nomad/server.go:95-257``); this package keeps those shapes on
the host.
"""

from .eval_broker import EvalBroker
from .blocked_evals import BlockedEvals
from .plan_queue import PlanQueue
from .plan_apply import PlanApplier
from .worker import Worker
from .server import Server, ServerConfig

__all__ = [
    "EvalBroker",
    "BlockedEvals",
    "PlanQueue",
    "PlanApplier",
    "Worker",
    "Server",
    "ServerConfig",
]
