"""Job admission pipeline — mutate and validate at register.

Reference: ``nomad/job_endpoint_hooks.go`` (jobImpliedConstraints,
jobCanonicalizer, jobValidate): every registered job flows through an
ordered list of MUTATORS (canonicalize defaults, inject implied
constraints) and then VALIDATORS (structural sanity); violations reject
the registration with a 400 before anything journals.

The hook lists are module-level and extensible — the seam the reference
uses for Connect injection/expose checks is the same seam here.

The load gate (token buckets, overload factor) is not part of this
package yet.
"""

from __future__ import annotations

import re
from typing import Callable, List

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
