"""Node heartbeat TTL tracking.

Reference: ``nomad/heartbeat.go`` (``nodeHeartbeater`` :33-60) — the leader
keeps a TTL timer per node; a missed heartbeat marks the node ``down``,
which fans out one evaluation per affected job (``createNodeEvals``) so the
schedulers replace the lost allocations (§3.3 of SURVEY.md).

One heap-driven expiry thread serves every node (the reference uses one
``time.AfterFunc`` timer per node, which is cheap in Go; a Python thread
per node is not — at 10K nodes the bench previously had to disarm
heartbeats entirely).  Heap entries are lazily invalidated: a re-armed or
cleared node leaves its stale entry in the heap, and the expiry thread
discards entries whose deadline no longer matches the authoritative map.

The TTL jitter draws from the ``random.Random`` the owner passes in
(``ServerConfig.heartbeat_seed`` seeds the server's), so a run's TTLs
repeat under the same seed.
"""

from __future__ import annotations

import heapq
import random
import threading
from typing import Callable, Dict, List, Optional, Tuple
import time



class HeartbeatManager:
    def __init__(
        self,
        on_expire: Callable[[str], None],
        rng: random.Random,
        min_ttl: float = 10.0,
        max_ttl: float = 20.0,
    ):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._deadlines: Dict[str, float] = {}
        self._heap: List[Tuple[float, str]] = []
        self._on_expire = on_expire
        self._rng = rng
        self.min_ttl = min_ttl
        self.max_ttl = max_ttl
        self._enabled = False
        self._thread: Optional[threading.Thread] = None
        # Generation guard: each enable starts a fresh wheel thread bound
        # to its generation; older threads exit on observing a newer one
        # (leadership can cycle disable→enable faster than a thread exits).
        self._gen = 0

    def set_enabled(self, enabled: bool) -> None:
        start_gen = None
        with self._lock:
            was = self._enabled
            self._enabled = enabled
            if not enabled:
                self._deadlines.clear()
                self._heap.clear()
            elif not was:
                self._gen += 1
                start_gen = self._gen
            self._cond.notify_all()
        if start_gen is not None:
            self._thread = threading.Thread(
                target=self._run, args=(start_gen,),
                name="heartbeat-wheel", daemon=True,
            )
            self._thread.start()

    def reset_heartbeat(self, node_id: str) -> float:
        """(Re)arm the node's TTL; returns the granted TTL. TTLs are
        jittered to spread thundering herds (heartbeat.go:93)."""
        with self._lock:
            ttl = self.min_ttl + self._rng.random() * (
                self.max_ttl - self.min_ttl
            )
            if not self._enabled:
                return ttl
            deadline = time.monotonic() + ttl
            self._deadlines[node_id] = deadline
            wake = not self._heap or deadline < self._heap[0][0]
            heapq.heappush(self._heap, (deadline, node_id))
            if wake:
                # Only an earlier-than-head deadline changes the wheel's
                # wait; waking per heartbeat would thrash at 10K nodes.
                self._cond.notify_all()
        return ttl

    def clear_heartbeat(self, node_id: str) -> None:
        with self._lock:
            self._deadlines.pop(node_id, None)
            # Stale heap entry discarded lazily by the expiry thread.

    def _run(self, gen: int) -> None:
        while True:
            expired: List[str] = []
            with self._lock:
                if not self._enabled or self._gen != gen:
                    return
                now = time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    deadline, node_id = heapq.heappop(self._heap)
                    # Lazy invalidation: only the entry matching the
                    # node's current deadline fires.
                    if self._deadlines.get(node_id) == deadline:
                        del self._deadlines[node_id]
                        expired.append(node_id)
                timeout = (
                    max(0.0, self._heap[0][0] - now) if self._heap else None
                )
                if not expired:
                    self._cond.wait(timeout=timeout)
            for node_id in expired:
                try:
                    self._on_expire(node_id)
                except Exception:  # noqa: BLE001 — one bad node must not
                    # kill the wheel for the rest of the cluster
                    import logging

                    logging.getLogger(__name__).exception(
                        "heartbeat expiry for %s failed", node_id
                    )

    def tracked(self) -> int:
        with self._lock:
            return len(self._deadlines)
