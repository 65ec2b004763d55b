"""Periodic job dispatcher — cron-style child-job launcher.

Reference: ``nomad/periodic.go`` (``NewPeriodicDispatch`` :160, ``Add``
:208, ``run`` :335, ``dispatch`` :360): the leader tracks every periodic
job, sleeps until the next launch time, then derives a child job named
``<parent>/periodic-<epoch>`` and submits it (which creates the eval);
``prohibit_overlap`` skips a launch while the previous child is live.
Launch times are recorded in state (``periodic_launch`` table) so a
leadership change never double-fires an already-covered launch.

The cron engine is a from-scratch 5-field parser (minute hour day-of-month
month day-of-week, supporting ``*``, ``*/n``, ``a-b``, lists, and the
``@hourly``/``@daily``/``@weekly`` shorthands) — the reference pulls in
``gorhill/cronexpr``; this build needs no dependency for the same core.

Children register through ``Server.submit_job(internal=True)``: the load
gate exempts them.
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Set, Tuple

from ..structs.types import Job

log = logging.getLogger(__name__)

_SHORTHAND = {
    "@minutely": "* * * * *",
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
}

_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


def _parse_field(spec: str, lo: int, hi: int) -> Set[int]:
    out: Set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo2, hi2 = int(a), int(b)
        else:
            lo2 = hi2 = int(part)
        for v in range(lo2, hi2 + 1, step):
            if lo <= v <= hi:
                out.add(v)
    return out


class CronExpr:
    """Parsed 5-field cron expression; ``next_after`` computes the next
    matching wall-clock time strictly after the given epoch (UTC)."""

    def __init__(self, spec: str):
        spec = _SHORTHAND.get(spec.strip(), spec.strip())
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec needs 5 fields: {spec!r}")
        self.minute, self.hour, self.dom, self.month, self.dow = (
            _parse_field(f, lo, hi)
            for f, (lo, hi) in zip(fields, _FIELD_RANGES)
        )
        self.dom_star = fields[2] == "*"
        self.dow_star = fields[4] == "*"

    def _day_matches(self, dt: datetime) -> bool:
        dom_ok = dt.day in self.dom
        dow_ok = dt.weekday() in self._py_dow()
        if self.dom_star and self.dow_star:
            return True
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok  # standard cron OR semantics

    def _py_dow(self) -> Set[int]:
        # cron: 0=Sunday; python weekday(): 0=Monday
        return {(d - 1) % 7 for d in self.dow}

    def next_after(self, epoch: float) -> float:
        dt = datetime.fromtimestamp(epoch, tz=timezone.utc)
        dt = dt.replace(second=0, microsecond=0) + timedelta(minutes=1)
        for _ in range(366 * 24 * 60):  # bounded scan: minute resolution
            if (
                dt.month in self.month
                and self._day_matches(dt)
                and dt.hour in self.hour
                and dt.minute in self.minute
            ):
                return dt.timestamp()
            dt += timedelta(minutes=1)
        raise ValueError("no cron match within a year")


class PeriodicDispatcher:
    def __init__(self, server):
        self.server = server
        self._lock = threading.Lock()
        self._tracked: Dict[Tuple[str, str], Job] = {}
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    def start(self) -> None:
        self._shutdown.clear()
        self._restore()
        self._thread = threading.Thread(
            target=self._run, name="periodic-dispatch", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _restore(self) -> None:
        """Re-track periodic jobs from state on leadership gain
        (leader.go:621 restorePeriodicDispatcher)."""
        for job in self.server.store.all_jobs():
            if job.is_periodic() and not job.stopped() and not job.parent_id:
                self.add(job)

    # ------------------------------------------------------------------

    @staticmethod
    def _next_launch(job: Job, base: float) -> float:
        """Next launch strictly after ``base``.  spec_type ``cron`` is the
        reference behavior; ``interval`` (spec = seconds) is an extension
        for sub-minute cadences (and sub-minute tests)."""
        p = job.periodic
        if p.spec_type == "interval":
            return base + float(p.spec)
        return CronExpr(p.spec).next_after(base)

    def add(self, job: Job) -> None:
        if not (job.periodic and job.periodic.enabled):
            return
        try:
            self._next_launch(job, time.time())
        except (ValueError, TypeError):
            log.warning("periodic job %s has bad spec %r", job.id,
                        job.periodic.spec)
            return
        with self._lock:
            self._tracked[(job.namespace, job.id)] = job
        self._wake.set()

    def remove(self, namespace: str, job_id: str) -> None:
        with self._lock:
            self._tracked.pop((namespace, job_id), None)
        self._wake.set()

    def tracked(self) -> List[Job]:
        with self._lock:
            return list(self._tracked.values())

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while not self._shutdown.is_set():
            now = time.time()
            next_launch: Optional[float] = None
            due: List[Tuple[Job, float]] = []
            with self._lock:
                jobs = list(self._tracked.values())
            for job in jobs:
                key = (job.namespace, job.id)
                last = self.server.store.periodic_launch.get(key, 0.0)
                base = max(last, job.submit_time or 0.0)
                t = self._next_launch(job, base)
                # Fast-forward past missed occurrences: a single catch-up
                # launch, not one per missed window (periodic.go forceRun
                # semantics on restore).
                while t <= now:
                    t_next = self._next_launch(job, t)
                    if t_next <= now:
                        t = t_next
                    else:
                        break
                if t <= now:
                    due.append((job, t))
                elif next_launch is None or t < next_launch:
                    next_launch = t
            for job, t in due:
                try:
                    self._dispatch(job, t)
                except Exception:  # noqa: BLE001
                    log.exception("periodic dispatch failed for %s", job.id)
            if due:
                continue  # re-evaluate immediately (next occurrence)
            wait = 1.0 if next_launch is None else min(
                max(next_launch - time.time(), 0.05), 60.0
            )
            self._wake.clear()
            self._wake.wait(timeout=wait)

    # ------------------------------------------------------------------

    def _dispatch(self, job: Job, launch_time: float) -> None:
        """Derive + submit the child job (periodic.go:360 dispatch +
        deriveJob)."""
        key = (job.namespace, job.id)
        if job.periodic.prohibit_overlap and self._child_running(job):
            log.info("skipping launch of %s: previous child running", job.id)
            self.server.record_periodic_launch(
                job.namespace, job.id, launch_time
            )
            return
        child = job.copy()
        child.id = f"{job.id}/periodic-{int(launch_time)}"
        child.parent_id = job.id
        child.periodic = None
        self.server.record_periodic_launch(job.namespace, job.id, launch_time)
        # internal: periodic children are server-originated — the load
        # gate must not shed scheduled work.
        self.server.submit_job(child, internal=True)

    def _child_running(self, job: Job) -> bool:
        store = self.server.store
        prefix = f"{job.id}/periodic-"
        for (ns, jid), child in list(store.jobs.items()):
            if ns != job.namespace or not jid.startswith(prefix):
                continue
            if child.stopped():
                continue
            for a in store.allocs_by_job(ns, jid):
                if not a.client_terminal():
                    return True
            for e in store.evals_by_job(ns, jid):
                if not e.terminal_status():
                    return True
        return False
