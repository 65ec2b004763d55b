"""Environment knobs and the shared backoff policy.

A copy of the reference package's ``retry.py`` without ``retry_call``
and ``env_defaults`` (their callers — RPC failover, client registration,
the tools — are not part of this package yet): a declarative
:class:`RetryPolicy` (jittered exponential backoff, hard deadline,
attempt cap, per-attempt timeout) and a stateful :class:`Backoff` for
long-lived loops that recover in place.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Optional


def env_int(name: str, default: int) -> int:
    """Tolerant integer env knob: unset, empty, or unparsable → default.
    The one parser for every ``NOMAD_TPU_*`` tuning variable, so a typo'd
    knob degrades to the default instead of crashing a server at import."""
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    """Tolerant float env knob — see :func:`env_int`."""
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


@dataclass(frozen=True)
class RetryPolicy:
    """Declarative backoff shape.

    ``base_delay`` grows by ``multiplier`` per failed attempt, capped at
    ``max_delay``; each sleep is jittered by ±``jitter`` fraction so herds
    of retriers decorrelate.  ``deadline`` is a hard wall-clock budget from
    the first attempt; ``max_attempts`` a hard attempt cap;
    ``attempt_timeout`` the per-attempt I/O timeout callers should pass to
    the underlying call.
    """

    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25
    max_attempts: Optional[int] = None
    deadline: Optional[float] = None
    attempt_timeout: Optional[float] = None


class Backoff:
    """Stateful delay generator for long-lived recovery loops.

    ``next_delay()`` advances the exponential schedule; ``reset()`` snaps
    back to ``base_delay`` on success.  Each loop owns its instance (a
    shared instance would interleave schedules).
    """

    def __init__(self, policy: RetryPolicy, rng: Optional[random.Random] = None):
        self.policy = policy
        self._rng = rng or random
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def reset(self) -> None:
        self._attempt = 0

    def next_delay(self) -> float:
        p = self.policy
        raw = min(p.base_delay * (p.multiplier ** self._attempt), p.max_delay)
        self._attempt += 1
        if p.jitter:
            raw *= 1.0 + p.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, raw)
