"""Seeded, deterministic fault injection at named cross-component seams.

A copy of the reference package's ``chaos/injector.py``.  The port's code
calls :func:`inject` at every seam a distributed failure can hit — RPC
dispatch (``api/rpc.py``), raft peer streams (``server/replication.py``),
WAL appends (``state/wal.py``), heartbeat TTL grants
(``server/heartbeat.py``), the client heartbeat loop
(``client/client.py``), task drivers (``client/driver.py``), the overload
actuators (``obs/controller.py``, ``server/admission.py``,
``server/eval_broker.py``, ``server/blocked_evals.py``) and the device
dispatch (``scheduler/coalescer.py``).  With no injector installed
(production, and every non-chaos test) the call is a module-global
``None`` check — effectively free next to the I/O it guards.

A chaos scenario installs a :class:`FaultInjector` built from a **seed**
and a declarative schedule of :class:`FaultSpec` entries.  Trigger
decisions are a pure function of ``(seed, seam, hit-number)`` — NOT a
shared RNG stream — so concurrent seams cannot perturb each other's
schedules and a scenario replays identically from its seed (the
discipline FoundationDB/Jepsen-style harnesses use: the fault schedule is
data, the run is a replayable function of it).

Seam catalog (ctx keys each seam passes):

- ``rpc.call``        — path, addr                 (client→server wire)
- ``raft.send``       — path, src, dst             (leader→peer stream)
- ``wal.write``       — op                         (journal append)
- ``heartbeat.ttl``   — node                       (server TTL grant)
- ``client.heartbeat``— node                       (client heartbeat loop)
- ``driver.start`` / ``driver.wait`` / ``driver.stop`` — driver, task
- ``controller.actuate`` — target                  (overload actuation:
  ``error`` = the actuation is lost; the controller stays in its old
  state and re-drives the same target next observatory tick)
- ``broker.shed``     — enabled                    (shed toggle lost)
- ``blocked.unblock`` — cls                        (capacity wakeup
  lost: blocked evals stay parked until the next capacity event)
- ``admission.gate``  — namespace                  (``error`` = spurious
  429: a submission with bucket capacity is rejected anyway —
  exercises the client's Retry-After path)
- ``coalescer.dispatch`` — lanes                   (a sealed batch
  before its launch; a delay point only)
- ``device.wedge``    — lanes                      (the ticket's wait
  is held past every watchdog bound: the resolver abandons it, the
  breaker trips, lanes fail with ``DeviceWedgedError``; the kernels
  still ran on the card, only their result is never read)
- ``device.slow``     — lanes                      (the ticket's wait
  is held past the deadline but inside the wedge bound — late but
  usable; feeds the breaker's slow-ratio trip)
- ``shard.loss``      — shards, lanes              (a whole matrix home
  shard dies mid-dispatch; ``lost`` evacuates it — survivors
  re-lay-out, in-flight tickets invalidate via the remap window)
- ``shard.partition`` — shards, lanes              (``dark`` marks one
  home shard's nodes ineligible mid-dispatch — healable partition,
  distinct from the permanent ``shard.loss`` evacuation)

Fault kinds each seam understands (others are ignored there):

- ``delay``   — handled centrally: sleep ``duration`` seconds, proceed
- ``drop``    — the seam raises its transport error (request lost;
  at ``raft.send`` this is also the partition primitive — match on
  src/dst to cut specific links, and sustained drops force elections)
- ``dup``     — the seam performs the operation twice (retry storms)
- ``error``   — the seam raises its domain error (5xx analog)
- ``torn``    — ``wal.write`` persists a prefix of the record then fails
- ``fsync_error`` — ``wal.write`` persists the record but reports failure
- ``skew``    — ``heartbeat.ttl`` scales the granted TTL by ``duration``
  (clock-skew analog: the client believes a TTL the server won't honor)
- ``skip``    — ``client.heartbeat`` silently misses a beat; at
  ``driver.stop`` the stop request is swallowed
- ``hang``    — driver seams block ``duration`` seconds (wedged syscall)
- ``wedge``   — ``driver.wait`` reports "still running" forever; at
  ``device.wedge`` the ticket's wait is held past every watchdog bound
  (``duration`` is the synthetic hold when > 0)
- ``slow``    — ``device.slow`` holds the ticket's wait into the slow
  band (past the deadline, inside the wedge bound)
- ``lost``    — ``shard.loss`` kills a matrix home shard; the
  coalescer evacuates it across the survivors
- ``dark``    — ``shard.partition`` marks a home shard's nodes
  ineligible (authoritative-state partition, healable)
- ``exit127`` — ``driver.start`` runs a command that exits 127
  (missing-binary analog)
"""

from __future__ import annotations

import fnmatch
import hashlib
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


@dataclass
class FaultSpec:
    """One declarative fault: where, what, when.

    ``seam`` is an exact name or fnmatch pattern (``raft.*``).  ``match``
    filters on seam ctx by string equality (e.g. ``{"dst": addr}``).
    Trigger: ``at_step`` fires on exactly the Nth matching hit (1-based);
    otherwise ``p`` is the per-hit probability (decided deterministically
    from the injector seed), considered only after ``after_step`` hits.
    ``count`` caps total fires; ``duration`` parameterizes delay/hang/skew.
    """

    seam: str
    kind: str
    p: float = 1.0
    at_step: Optional[int] = None
    after_step: int = 0
    duration: float = 0.0
    count: Optional[int] = None
    match: Dict[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class FiredFault:
    """One log record: enough to compare schedules across replays."""

    seam: str
    kind: str
    step: int


class FaultInjector:
    """Holds the schedule, the per-seam hit counters, and the fire log."""

    def __init__(self, seed: int, schedule: List[FaultSpec]):
        self.seed = seed
        self.schedule = list(schedule)
        self._hits: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}
        self.log: List[FiredFault] = []
        self._lock = threading.Lock()

    # -- deterministic per-(seam, hit) coin ----------------------------

    def _coin(self, seam: str, hit: int) -> float:
        h = hashlib.sha256(f"{self.seed}:{seam}:{hit}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    # -- the hot path --------------------------------------------------

    def fire(self, seam: str, **ctx: Any) -> Optional[FaultSpec]:
        """Record a hit on ``seam``; return the first matching spec that
        triggers (or None).  First-match-wins keeps schedules readable:
        order specs most-specific first."""
        with self._lock:
            hit = self._hits.get(seam, 0) + 1
            self._hits[seam] = hit
            for spec in self.schedule:
                if not _seam_matches(spec.seam, seam):
                    continue
                if any(
                    str(ctx.get(k)) != str(v) for k, v in spec.match.items()
                ):
                    continue
                fired = self._fires.get(id(spec), 0)
                if spec.count is not None and fired >= spec.count:
                    continue
                if spec.at_step is not None:
                    if hit != spec.at_step:
                        continue
                else:
                    if hit <= spec.after_step:
                        continue
                    if spec.p < 1.0 and self._coin(seam, hit) >= spec.p:
                        continue
                self._fires[id(spec)] = fired + 1
                self.log.append(FiredFault(seam=seam, kind=spec.kind, step=hit))
                return spec
        return None

    def hits(self, seam: str) -> int:
        with self._lock:
            return self._hits.get(seam, 0)


def _seam_matches(pattern: str, seam: str) -> bool:
    return pattern == seam or fnmatch.fnmatchcase(seam, pattern)


# ----------------------------------------------------------------------
# Global installation — the production seams consult this.
# ----------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> None:
    global _ACTIVE
    _ACTIVE = injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextmanager
def injected(
    seed: int, schedule: List[FaultSpec]
) -> Iterator[FaultInjector]:
    """Scoped install (the only way tests should enable chaos — an
    injector leaking across tests would poison the whole suite)."""
    inj = FaultInjector(seed, schedule)
    install(inj)
    try:
        yield inj
    finally:
        uninstall()


def inject(seam: str, **ctx: Any) -> Optional[FaultSpec]:
    """The production-seam entry point.  ``delay`` faults are absorbed
    here (sleep, return None); every other kind is returned for the seam
    to interpret, so each seam only handles the kinds that make sense for
    it."""
    inj = _ACTIVE
    if inj is None:
        return None
    spec = inj.fire(seam, **ctx)
    if spec is None:
        return None
    if spec.kind == "delay":
        time.sleep(spec.duration)
        return None
    return spec
