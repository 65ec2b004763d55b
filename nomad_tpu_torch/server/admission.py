"""Job admission pipeline — mutate and validate at register.

Reference: ``nomad/job_endpoint_hooks.go`` (jobImpliedConstraints,
jobCanonicalizer, jobValidate): every registered job flows through an
ordered list of MUTATORS (canonicalize defaults, inject implied
constraints) and then VALIDATORS (structural sanity); violations reject
the registration with a 400 before anything journals.

The hook lists are module-level and extensible — the seam the reference
uses for Connect injection/expose checks is the same seam here.

Beyond structure, admission is also the cluster's *load* gate:
:class:`AdmissionGate` keeps a token bucket per namespace and an overload
factor driven by the :class:`~..obs.controller.OverloadController`.  A
submission that outruns its namespace's refill rate raises
:class:`RateLimitError` with a ``retry_after`` hint computed from the
bucket's actual deficit (an HTTP layer maps it to ``429 Too Many
Requests`` + ``Retry-After``).  A copy of the reference package's gate,
its ``admission.gate`` chaos seam (an injected spurious rejection)
included.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import trace
from ..chaos.injector import inject
from ..retry import env_float
from ..structs.types import Job, JobType, Op

# Job/group/task names the CLI and fs paths can safely carry.
_NAME_RE = re.compile(r"^[a-zA-Z0-9._/-]{1,128}$")

VALID_OPERANDS = {op.value for op in Op}


def mutate_canonicalize(job: Job) -> None:
    """Fill derivable defaults (jobCanonicalizer): name from id,
    datacenters default, per-group restart policy inheritance is handled
    by the dataclass defaults already."""
    if not job.name:
        job.name = job.id
    if not job.datacenters:
        job.datacenters = ["dc1"]
    if not job.namespace:
        job.namespace = "default"
    for tg in job.task_groups:
        for t in tg.tasks:
            if not t.name:
                t.name = "task"


# jobImpliedConstraints has no work to do here: driver and device
# feasibility are enforced directly by the scheduling kernel + host
# checkers (ops/kernels.py feasibility_mask, scheduler/feasible_host.py),
# so no marker constraints need injecting.  The MUTATORS list below is
# the extension seam the reference uses for Connect/vault injection.


def validate_structure(job: Job) -> List[str]:
    """jobValidate: structural errors, all collected (multierror)."""
    errs: List[str] = []
    if not job.id:
        errs.append("job id is required")
    elif not _NAME_RE.match(job.id):
        errs.append(f"invalid job id {job.id!r}")
    if job.type not in (t.value for t in JobType):
        errs.append(f"unknown job type {job.type!r}")
    if job.priority < 1 or job.priority > 100:
        errs.append(f"priority {job.priority} outside [1, 100]")
    if not job.task_groups:
        errs.append("job has no task groups")
    for c in job.constraints:
        if c.operand and c.operand not in VALID_OPERANDS:
            errs.append(f"unknown constraint operand {c.operand!r}")
    seen_groups = set()
    for tg in job.task_groups:
        if tg.name in seen_groups:
            errs.append(f"duplicate task group {tg.name!r}")
        seen_groups.add(tg.name)
        if tg.count < 0:
            errs.append(f"group {tg.name!r}: negative count")
        if not tg.tasks:
            errs.append(f"group {tg.name!r} has no tasks")
        seen_tasks = set()
        for t in tg.tasks:
            if t.name in seen_tasks:
                errs.append(
                    f"group {tg.name!r}: duplicate task {t.name!r}"
                )
            seen_tasks.add(t.name)
            if not t.driver:
                errs.append(f"task {t.name!r} has no driver")
            if t.resources.cpu < 0 or t.resources.memory_mb < 0:
                errs.append(f"task {t.name!r}: negative resources")
            for vm in t.volume_mounts:
                if vm.volume not in (tg.volumes or {}):
                    errs.append(
                        f"task {t.name!r}: volume_mount references "
                        f"undeclared volume {vm.volume!r}"
                    )
            for c in t.constraints:
                if c.operand and c.operand not in VALID_OPERANDS:
                    errs.append(
                        f"unknown constraint operand {c.operand!r}"
                    )
        for c in tg.constraints:
            if c.operand and c.operand not in VALID_OPERANDS:
                errs.append(f"unknown constraint operand {c.operand!r}")
        if tg.update and tg.update.canary < 0:
            errs.append(f"group {tg.name!r}: negative canary count")
        if tg.scaling and tg.scaling.max and (
            tg.scaling.min > tg.scaling.max
        ):
            errs.append(
                f"group {tg.name!r}: scaling min > max"
            )
    if job.is_periodic() and not job.periodic.spec:
        errs.append("periodic job has no cron spec")
    return errs


MUTATORS: List[Callable[[Job], None]] = [
    mutate_canonicalize,
]
VALIDATORS: List[Callable[[Job], List[str]]] = [
    validate_structure,
]


def admit(job: Job) -> None:
    """Run the pipeline; raises ValueError with every violation joined
    (the reference returns a multierror the same way)."""
    for m in MUTATORS:
        m(job)
    errs: List[str] = []
    for v in VALIDATORS:
        errs.extend(v(job))
    if errs:
        raise ValueError("; ".join(errs))


# ----------------------------------------------------------------------
# Load-aware admission: token buckets + overload gate
# ----------------------------------------------------------------------

class RateLimitError(Exception):
    """Submission rejected for load, not structure.  Maps to HTTP 429;
    ``retry_after`` (seconds) becomes the ``Retry-After`` header."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = max(0.1, float(retry_after))


class TokenBucket:
    """Classic token bucket: ``burst`` capacity refilled at ``rate``/s.

    ``take`` returns 0.0 on admit, else the seconds until the deficit
    refills — the Retry-After hint.  An effective-rate ``factor`` < 1
    (the overload gate) slows refill without discarding accrued tokens,
    so engaging the gate never retroactively punishes a quiet tenant.
    """

    __slots__ = ("rate", "burst", "_tokens", "_stamp")

    def __init__(self, rate: float, burst: float):
        self.rate = max(rate, 1e-9)
        self.burst = max(burst, 1.0)
        self._tokens = self.burst
        self._stamp: Optional[float] = None

    def take(
        self, n: float = 1.0, now: Optional[float] = None,
        factor: float = 1.0,
    ) -> float:
        now = now if now is not None else time.monotonic()
        rate = self.rate * max(factor, 1e-9)
        if self._stamp is not None:
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * rate
            )
        self._stamp = now
        if self._tokens >= n:
            self._tokens -= n
            return 0.0
        return (n - self._tokens) / rate


class AdmissionGate:
    """Per-namespace token buckets + the controller-driven overload gate.

    ``factor`` is the effective-rate scale the OverloadController sets
    (1.0 steady, <1.0 gated); ``check`` is called by
    ``Server.submit_job`` on every external register/dispatch.  Stats
    feed the controller's report.
    """

    def __init__(
        self,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        metrics=None,
    ):
        self.rate = rate if rate is not None else env_float(
            "NOMAD_TPU_OVERLOAD_RATE", 500.0
        )
        self.burst = burst if burst is not None else env_float(
            "NOMAD_TPU_OVERLOAD_BURST", 2.0 * self.rate
        )
        self.metrics = metrics
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._factor = 1.0
        self._retry_after = 2.0
        self._admitted = 0
        self._rejected = 0
        self._gate_changes = 0

    @property
    def factor(self) -> float:
        return self._factor

    def set_gate_level(self, factor: float, retry_after: float = 2.0) -> None:
        """Controller actuation point: scale every namespace's effective
        refill rate.  Callers are OverloadController actuator methods,
        each of which emits a trace event and a counter."""
        with self._lock:
            if factor != self._factor:
                self._gate_changes += 1
            self._factor = max(min(float(factor), 1.0), 0.0)
            self._retry_after = retry_after

    def check(
        self, namespace: str, priority: int = 0,
        now: Optional[float] = None,
    ) -> None:
        """Admit or raise :class:`RateLimitError`.  ``rate`` <= 0
        disables volumetric limiting entirely (the gate factor still
        reports, but nothing is rejected)."""
        if self.rate <= 0:
            return
        spec = inject("admission.gate", namespace=namespace)
        if spec is not None and spec.kind == "error":
            # Spurious 429: the gate rejects a submission it had capacity
            # for — exercises the client's Retry-After path end to end.
            trace.event(
                "seam.admission.gate", namespace=namespace, spurious=True
            )
            raise RateLimitError(
                f"namespace {namespace!r} rejected (injected)",
                retry_after=self._retry_after,
            )
        with self._lock:
            bucket = self._buckets.get(namespace)
            if bucket is None:
                bucket = self._buckets[namespace] = TokenBucket(
                    self.rate, self.burst
                )
            wait = bucket.take(1.0, now=now, factor=self._factor)
            if wait <= 0.0:
                self._admitted += 1
                return
            self._rejected += 1
            retry = max(wait, self._retry_after if self._factor < 1.0 else 0.1)
        trace.event(
            "seam.admission.gate", namespace=namespace, spurious=False,
            wait=round(wait, 4),
        )
        if self.metrics is not None:
            self.metrics.incr(
                "nomad.overload.admission_rejected", namespace=namespace
            )
        raise RateLimitError(
            f"namespace {namespace!r} over admission rate "
            f"(effective {self.rate * self._factor:g}/s); retry later",
            retry_after=retry,
        )

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "factor": self._factor,
                "rate": self.rate,
                "burst": self.burst,
                "admitted": self._admitted,
                "rejected": self._rejected,
                "gate_changes": self._gate_changes,
                "namespaces": len(self._buckets),
            }
