"""Deterministic fault injection + cluster invariant checking.

A copy of the reference package's ``chaos/``.  The seam catalog and the
fault kinds are in :mod:`.injector`'s docstring; the seeded scenarios,
each replayable from its seed, in :mod:`.scenarios`.
"""

from .injector import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    FiredFault,
    active,
    inject,
    injected,
    install,
    uninstall,
)
from .invariants import (  # noqa: F401
    check_allocs_fit,
    check_broker,
    check_cluster,
    check_convergence,
    check_replacement_coverage,
    check_store,
    check_volume_writers,
    wait_converged,
)
