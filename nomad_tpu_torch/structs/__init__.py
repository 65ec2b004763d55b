"""Shared types and scalar scheduling math (reference: nomad/structs/)."""

from .types import *  # noqa: F401,F403
from .funcs import (  # noqa: F401
    BINPACK_MAX_FIT_SCORE,
    allocs_fit,
    allocs_resources,
    allocs_device_usage,
    compute_free_percentage,
    filter_terminal_allocs,
    net_priority,
    preemption_score,
    score_fit_binpack,
    score_fit_spread,
    score_normalize,
)
