"""Client core — registration, heartbeats, the alloc watch loop.

Reference: ``client/client.go``: ``registerAndHeartbeat`` (:1550), the
``watchAllocations`` blocking query on ``Node.GetClientAllocs`` (:1997),
``runAllocs`` diffing server state into AllocRunner add/update/destroy
(:2227), and batched alloc-status updates back to the server (200ms batches,
:95-97). The RPC boundary here is the in-process ``Server`` object; the wire
version slots in behind the same three calls (register/heartbeat/get-allocs/
update-allocs).

A copy of the reference package's ``client/client.py``, its
``client.heartbeat`` chaos seam and trace event included.  The server it
talks to schedules on the card; the agent itself is host Python and
touches no device.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import trace
from ..chaos import inject
from ..retry import Backoff, RetryPolicy, retry_call
from ..structs.types import (
    AllocDeploymentStatus,
    AllocDesiredStatus,
    Allocation,
    DriverInfo,
    Node,
    NodeStatus,
)
from .allocrunner import AllocRunner
from .driver import DriverRegistry
from .fingerprint import fingerprint

log = logging.getLogger(__name__)

# Batch window for alloc status updates (client.go:95-97).
UPDATE_BATCH_WINDOW = 0.2

# Initial registration: servers may still be electing when the agent
# boots; keep trying with backoff for a full minute before giving up
# (registerAndHeartbeat's retryIntv discipline, client.go:1550).
REGISTER_RETRY = RetryPolicy(
    base_delay=0.2, max_delay=2.0, deadline=60.0
)
# Disconnected-probe cadence: fast first probes (reconnection latency),
# backing off to 2s so a long outage doesn't burn CPU, reset on success.
DISCONNECT_RETRY = RetryPolicy(base_delay=0.25, max_delay=2.0)
# Alloc-watch recovery after a failed blocking query.
WATCH_RETRY = RetryPolicy(base_delay=0.25, max_delay=5.0)


class AllocFSError(Exception):
    """Task-filesystem access failure, carrying the HTTP status the API
    layer should surface (fs_endpoint.go error mapping)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


@dataclass
class ClientConfig:
    datacenter: str = "dc1"
    node_class: str = ""
    data_dir: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    # Fraction of the granted TTL at which to heartbeat (client sends early).
    heartbeat_factor: float = 0.5
    # Client GC (client/gc.go): keep at most this many terminal alloc dirs;
    # the oldest are evicted (runner destroyed, dir removed, state dropped).
    max_terminal_allocs: int = 50
    # Host path local (file://) artifact sources may read from; empty =
    # file sources restricted to the task dir (exfiltration sandbox).
    artifact_root: str = ""
    # Host volumes this node exposes (client host_volume config blocks):
    # name -> host path.  Feasibility (HostVolumeChecker) and the volume
    # mount hook resolve against these.
    host_volumes: Dict[str, str] = field(default_factory=dict)
    # Periodic re-fingerprint cadence (client/fingerprint_manager.go):
    # drifting facts (disk space, accelerator env, driver health) are
    # re-detected and pushed to the server.  0 disables.
    fingerprint_interval: float = 60.0
    # External driver plugins (client plugin "name" { binary = ... }
    # blocks): name -> {"binary": path}.  Dispensed into the driver
    # registry at boot (go-plugin analog; client/driver.py
    # ExternalPluginDriver).
    plugins: Dict[str, Dict[str, str]] = field(default_factory=dict)


class Client:
    def __init__(
        self,
        server,
        config: Optional[ClientConfig] = None,
        drivers: Optional[DriverRegistry] = None,
        node: Optional[Node] = None,
    ):
        self.server = server
        self.config = config or ClientConfig()
        self.drivers = drivers or DriverRegistry()
        self.data_dir = self.config.data_dir or tempfile.mkdtemp(
            prefix="nomad_tpu_client_"
        )
        # Dispense external driver plugins (go-plugin analog) with their
        # sidecar state rooted in this client's data dir.
        for pname, spec in (self.config.plugins or {}).items():
            if spec.get("binary"):
                self.drivers.register_plugin(
                    pname, spec["binary"], state_dir=self.data_dir
                )
        # Restart-recovery state (client/state/state_database.go analog).
        from .state import ClientStateDB

        self.state_db = ClientStateDB(self.data_dir)

        attrs, resources = fingerprint()
        attrs.update(self.drivers.fingerprint())
        self.node = node or Node(
            datacenter=self.config.datacenter,
            node_class=self.config.node_class,
            attributes=attrs,
            meta=dict(self.config.meta),
            resources=resources,
            drivers={
                name: DriverInfo(detected=True, healthy=True)
                for name in self.drivers.drivers
            },
            status=NodeStatus.INIT.value,
        )
        if self.config.host_volumes:
            self.node.host_volumes = dict(self.config.host_volumes)
        # A restarted agent MUST come back as the same node or its allocs
        # would be orphaned server-side.
        persisted_id = self.state_db.get_node_id()
        if node is None and persisted_id:
            self.node.id = persisted_id
        self.state_db.put_node_id(self.node.id)

        self.allocs: Dict[str, AllocRunner] = {}
        self._lock = threading.Lock()
        self._dirty: Dict[str, AllocRunner] = {}  # pending status updates
        self._dirty_cond = threading.Condition(self._lock)
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._ttl = 10.0
        # When heartbeats began failing, or None while connected
        # (heartbeat-stop policy, client/heartbeatstop.go).
        self._disconnected_since: Optional[float] = None
        # Last beat the server acknowledged — for client-side gap
        # detection: beats can be LOST without an error ever surfacing
        # here (lossy link, wedged thread), in which case the server
        # expires the node while this loop still believes it is healthy.
        self._last_beat_ok: Optional[float] = None

    # ------------------------------------------------------------------

    def start(self) -> None:
        """Register and launch the heartbeat / watch / update loops.
        Persisted allocs are restored FIRST so still-running tasks are
        re-attached before the watch loop reconciles with the server."""
        self._restore_allocs()
        # Register a COPY: the store owns objects handed to it (immutability
        # discipline, state/store.py) — in-process, passing self.node by
        # reference let the status mutation below leak into the store before
        # update_node_status read it, so became_ready never fired and
        # blocked evals missed the new node's capacity.  The HTTP wire
        # copies via serde; the in-process seam must match.
        import copy as _copy

        self._ttl = retry_call(
            lambda: self.server.register_node(_copy.deepcopy(self.node)),
            policy=REGISTER_RETRY,
            stop=self._shutdown,
            description="node register",
        )
        # Registration armed the server-side TTL: seed the gap detector
        # so an outage that starts before the FIRST acked beat is still
        # noticed (missed_window in _heartbeat_loop).
        self._last_beat_ok = time.time()
        self.node.status = NodeStatus.READY.value
        self.server.update_node_status(self.node.id, NodeStatus.READY.value)
        for target, name in (
            (self._heartbeat_loop, "heartbeat"),
            (self._watch_allocations, "watch-allocs"),
            (self._update_loop, "update-allocs"),
            (self._fingerprint_loop, "fingerprint"),
        ):
            t = threading.Thread(
                target=target, name=f"client-{name}-{self.node.id[:8]}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._dirty_cond:
            self._dirty_cond.notify_all()
        for ar in list(self.allocs.values()):
            ar.destroy()
        self.drivers.shutdown()

    def _restore_allocs(self) -> None:
        """Recover persisted allocs: re-attach or fail their tasks
        (client.go restore path + alloc_runner Restore)."""
        for alloc, states, handles in self.state_db.load_allocs():
            if alloc.terminal_status():
                self.state_db.delete_alloc(alloc.id)
                continue
            ar = AllocRunner(
                alloc, self.drivers, self.data_dir, self._alloc_updated,
                node=self.node,
                wait_for_prev_terminal=self._wait_prev_terminal,
                artifact_root=self.config.artifact_root,
                resolve_volume_source=getattr(
                    self.server, "get_volume_source", None
                ),
                alloc_fs_origin=getattr(
                    self.server, "get_alloc_fs_origin", None
                ),
                fetch_token=getattr(self.server, "token", ""),
            )
            with self._lock:
                self.allocs[alloc.id] = ar
            ar.run_restored(states, handles)

    def _persist(self, ar: AllocRunner) -> None:
        import dataclasses

        handles = {}
        for name, tr in list(ar.runners.items()):
            if tr.handle is not None:
                handles[name] = dataclasses.asdict(tr.handle)
        try:
            self.state_db.put_alloc_state(ar.alloc, ar.task_states, handles)
        except OSError:
            log.exception("persisting alloc state failed")

    # ------------------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        backoff = Backoff(DISCONNECT_RETRY)
        while not self._shutdown.is_set():
            if self._disconnected_since is not None:
                # Disconnected: probe fast so reconnection (and the stop
                # policy below) track real time, not the TTL cadence —
                # backing off while the outage persists.
                wait = backoff.next_delay()
            else:
                backoff.reset()
                # Cap the healthy cadence at 10s: the heartbeat doubles as
                # the disconnect DETECTOR, and stop_after_client_disconnect
                # windows must not wait out a long TTL before the first
                # failure is even observed.
                wait = min(
                    max(self._ttl * self.config.heartbeat_factor, 0.5),
                    10.0,
                )
            if self._shutdown.wait(timeout=wait):
                return
            try:
                # Chaos seam: a missed beat ("skip") models a lossy link or
                # a wedged agent thread; "error" models a reachable-but-
                # failing server.  Delays are absorbed inside inject —
                # a slow heartbeat that still lands within TTL must be
                # harmless.
                fault = inject("client.heartbeat", node=self.node.id)
                trace.event("seam.client.heartbeat", node=self.node.id)
                if fault is not None:
                    if fault.kind == "skip":
                        continue
                    if fault.kind == "error":
                        raise RuntimeError("injected heartbeat failure")
                # Did the TTL the server promised lapse between acked
                # beats?  If so the server may have expired us even though
                # no beat ever FAILED from this side (silently lost beats).
                missed_window = (
                    self._last_beat_ok is not None
                    and time.time() - self._last_beat_ok > self._ttl
                )
                self._ttl = self.server.heartbeat_node(self.node.id) or self._ttl
                self._last_beat_ok = time.time()
                if self._disconnected_since is not None or missed_window:
                    # Reconnected: the server demoted us DOWN -> INIT on
                    # this heartbeat (heartbeat_node) and waits for the
                    # client to assert readiness (node_endpoint.go:476) —
                    # without this push the node stays unschedulable.
                    self._disconnected_since = None
                    try:
                        self.server.update_node_status(
                            self.node.id, NodeStatus.READY.value
                        )
                        log.info("reconnected to servers; node ready")
                    except Exception:  # noqa: BLE001
                        log.warning("post-reconnect ready push failed",
                                    exc_info=True)
            except Exception:  # noqa: BLE001
                if self._disconnected_since is None:
                    self._disconnected_since = time.time()
                    log.warning("heartbeat failed; servers unreachable",
                                exc_info=True)
            self._heartbeat_stop_check()

    def _fingerprint_loop(self) -> None:
        """Periodic re-fingerprint (client/fingerprint_manager.go): when a
        detected fact changes — free disk, accelerator env, driver health —
        the node re-registers so schedulers see current truth."""
        interval = self.config.fingerprint_interval
        if not interval:
            return
        import copy as _copy

        while not self._shutdown.wait(timeout=interval):
            try:
                attrs, resources = fingerprint()
                attrs.update(self.drivers.fingerprint())
                # Preserve agent-stamped attributes (advertise addr).
                for k, v in self.node.attributes.items():
                    if k.startswith("nomad."):
                        attrs[k] = v
                changed = (
                    attrs != self.node.attributes
                    or resources.devices != self.node.resources.devices
                    # Capacity facts only — disk free drifts constantly
                    # and is already reported coarsely.
                    or resources.cpu != self.node.resources.cpu
                    or resources.memory_mb != self.node.resources.memory_mb
                )
                if changed:
                    self.node.attributes = attrs
                    self.node.resources.devices = resources.devices
                    self.node.resources.cpu = resources.cpu
                    self.node.resources.memory_mb = resources.memory_mb
                    self._ttl = self.server.register_node(
                        _copy.deepcopy(self.node)
                    ) or self._ttl
                    log.info("re-fingerprint: node facts changed; "
                             "re-registered")
            except Exception:  # noqa: BLE001
                log.debug("re-fingerprint failed", exc_info=True)

    def host_stats(self) -> Dict:
        """Host + device stats for /v1/client/stats (the ClientStats RPC,
        nomad/client_rpc.go forwarding -> client host stats)."""
        import shutil as _shutil

        la1, la5, la15 = os.getloadavg() if hasattr(os, "getloadavg") else (
            0.0, 0.0, 0.0
        )
        du = _shutil.disk_usage(self.data_dir)
        mem_total = self.node.resources.memory_mb * 1024 * 1024
        mem_avail = None
        try:
            with open("/proc/meminfo") as fh:
                for line in fh:
                    if line.startswith("MemAvailable:"):
                        mem_avail = int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
        return {
            "Timestamp": time.time(),
            "CPU": {"LoadAvg1": la1, "LoadAvg5": la5, "LoadAvg15": la15,
                    "Cores": int(self.node.attributes.get(
                        "cpu.numcores", "1"
                    ))},
            "Memory": {"Total": mem_total, "Available": mem_avail},
            "DataDir": {"Total": du.total, "Free": du.free},
            "Devices": {
                name: list(ids)
                for name, ids in self.node.resources.devices.items()
            },
            "AllocCount": len(self.allocs),
        }

    def _heartbeat_stop_check(self) -> None:
        """Disconnected-client policy (client/heartbeatstop.go): a group
        with ``stop_after_client_disconnect`` must not keep running
        unsupervised once this agent has lost its servers for longer than
        that window — the server has already marked the node down and
        rescheduled; two copies would run."""
        if self._disconnected_since is None:
            return
        disconnected_for = time.time() - self._disconnected_since
        with self._lock:
            runners = list(self.allocs.values())
        for ar in runners:
            job = ar.alloc.job
            tg = job.lookup_task_group(ar.alloc.task_group) if job else None
            window = tg.stop_after_client_disconnect if tg else None
            if window is None or ar.terminal:
                continue
            if disconnected_for > window:
                log.warning(
                    "stopping alloc %s: servers unreachable %.1fs > "
                    "stop_after_client_disconnect=%.1fs",
                    ar.alloc.id[:8], disconnected_for, window,
                )
                ar.kill()

    # ------------------------------------------------------------------

    def _watch_allocations(self) -> None:
        """Blocking-query loop (client.go:1997): wake on allocs-table bumps,
        diff into runAllocs."""
        index = 0
        backoff = Backoff(WATCH_RETRY)
        while not self._shutdown.is_set():
            try:
                allocs, index = self.server.get_client_allocs(
                    self.node.id, min_index=index, timeout=10.0
                )
            except Exception:  # noqa: BLE001
                log.exception("alloc watch failed")
                if self._shutdown.wait(timeout=backoff.next_delay()):
                    return
                continue
            backoff.reset()
            self._run_allocs(allocs)

    def _run_allocs(self, server_allocs: List[Allocation]) -> None:
        """Diff server view vs local runners (client.go:2227)."""
        server_by_id = {a.id: a for a in server_allocs}
        with self._lock:
            existing = dict(self.allocs)

        # Removed server-side (GC'd) → destroy local state.
        for aid, ar in existing.items():
            if aid not in server_by_id:
                ar.destroy()
                self.state_db.delete_alloc(aid)
                with self._lock:
                    self.allocs.pop(aid, None)

        for aid, alloc in server_by_id.items():
            ar = existing.get(aid)
            if ar is None:
                if alloc.terminal_status():
                    continue  # already finished; nothing to run
                if alloc.desired_status != AllocDesiredStatus.RUN.value:
                    continue
                ar = AllocRunner(
                    alloc, self.drivers, self.data_dir, self._alloc_updated,
                    node=self.node,
                    wait_for_prev_terminal=self._wait_prev_terminal,
                    artifact_root=self.config.artifact_root,
                    resolve_volume_source=getattr(
                        self.server, "get_volume_source", None
                    ),
                    alloc_fs_origin=getattr(
                        self.server, "get_alloc_fs_origin", None
                    ),
                    fetch_token=getattr(self.server, "token", ""),
                )
                with self._lock:
                    self.allocs[aid] = ar
                ar.run()
            elif alloc.modify_index > ar.alloc.modify_index:
                ar.update(alloc)
                self._persist(ar)

        self._gc_terminal_allocs()

    def _wait_prev_terminal(self, alloc_id: str, timeout: float) -> bool:
        """Block until the (local) replaced alloc stops running so disk
        migration never copies from a live writer (allocwatcher.Wait)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                ar = self.allocs.get(alloc_id)
            if ar is None or ar.terminal:
                return True
            time.sleep(0.1)
        return False

    def _gc_terminal_allocs(self) -> None:
        """Evict the oldest terminal AllocRunners past the budget so
        finished allocs don't accumulate dirs/state forever (client/gc.go
        AllocCounter eviction; disk/inode pressure trimmed to a count
        budget here)."""
        budget = self.config.max_terminal_allocs
        with self._lock:
            terminal = [
                (ar.alloc.modify_index, aid)
                for aid, ar in self.allocs.items()
                # Never evict before the final status update shipped.
                if ar.terminal and aid not in self._dirty
            ]
        if len(terminal) <= budget:
            return
        terminal.sort()
        for _, aid in terminal[: len(terminal) - budget]:
            with self._lock:
                ar = self.allocs.pop(aid, None)
            if ar is not None:
                ar.destroy()
                self.state_db.delete_alloc(aid)

    # ------------------------------------------------------------------

    def _alloc_updated(self, ar: AllocRunner) -> None:
        self._persist(ar)
        with self._dirty_cond:
            self._dirty[ar.alloc.id] = ar
            self._dirty_cond.notify_all()

    def _update_loop(self) -> None:
        """Batch status updates back to the server (Node.UpdateAlloc path,
        client.go:2363)."""
        while not self._shutdown.is_set():
            with self._dirty_cond:
                # Untimed: shutdown() and _alloc_updated() both notify
                # under _dirty_cond, so every predicate edge has a wake-up
                # (lint rule L004 — no polling around a lost notify).
                self._dirty_cond.wait_for(
                    lambda: self._dirty or self._shutdown.is_set()
                )
                if self._shutdown.is_set():
                    return
                if not self._dirty:
                    continue
                batch_start = time.time()
            # Let the batch window fill (200ms).
            time.sleep(UPDATE_BATCH_WINDOW)
            with self._dirty_cond:
                dirty, self._dirty = self._dirty, {}
            updates = []
            for ar in dirty.values():
                upd = ar.alloc.copy()
                upd.client_status = ar.client_status
                upd.task_states = {
                    k: v for k, v in ar.task_states.items()
                }
                if ar.deployment_health is not None:
                    # Preserve the server-stamped canary flag; only health
                    # is client-determined (Node.UpdateAlloc merge).
                    prev = upd.deployment_status
                    upd.deployment_status = AllocDeploymentStatus(
                        healthy=ar.deployment_health,
                        timestamp=ar.deployment_health_at,
                        canary=prev.canary if prev is not None else False,
                    )
                updates.append(upd)
            if updates:
                try:
                    self.server.update_allocs_from_client(updates)
                except Exception:  # noqa: BLE001
                    log.exception("alloc update failed")

    # ------------------------------------------------------------------

    def num_allocs(self) -> int:
        with self._lock:
            return len(self.allocs)

    # ------------------------------------------------------------------
    # Task filesystem access (reference: client FileSystem RPCs served
    # over the reverse session, nomad/client_rpc.go +
    # command/agent/fs_endpoint.go; logs stream from the task dirs the
    # drivers write into)
    # ------------------------------------------------------------------

    def _alloc_fs_dir(self, alloc_id: str) -> str:
        with self._lock:
            ar = self.allocs.get(alloc_id)
        if ar is None:
            raise AllocFSError(404, f"unknown allocation {alloc_id}")
        return ar.alloc_dir

    def _resolve_fs_path(self, alloc_id: str, rel_path: str) -> str:
        """Path inside the alloc dir; rejects escapes (fs_endpoint.go
        sandboxing)."""
        import os

        base = os.path.realpath(self._alloc_fs_dir(alloc_id))
        target = os.path.realpath(os.path.join(base, rel_path or "."))
        if target != base and not target.startswith(base + os.sep):
            raise AllocFSError(403, "path escapes allocation directory")
        return target

    def list_files(self, alloc_id: str, rel_path: str = "") -> List[Dict]:
        import os

        target = self._resolve_fs_path(alloc_id, rel_path)
        if not os.path.isdir(target):
            raise AllocFSError(404, f"not a directory: {rel_path!r}")
        out = []
        for name in sorted(os.listdir(target)):
            p = os.path.join(target, name)
            st = os.stat(p)
            out.append({
                "Name": name,
                "IsDir": os.path.isdir(p),
                "Size": st.st_size,
                "ModTime": st.st_mtime,
            })
        return out

    def read_file(
        self, alloc_id: str, rel_path: str, offset: int = 0,
        limit: int = 1 << 20,
    ) -> bytes:
        """Read up to ``limit`` bytes at ``offset`` (negative = from EOF,
        tail semantics)."""
        import os

        target = self._resolve_fs_path(alloc_id, rel_path)
        if not os.path.isfile(target):
            raise AllocFSError(404, f"no such file: {rel_path!r}")
        with open(target, "rb") as fh:
            if offset < 0:
                fh.seek(0, os.SEEK_END)
                fh.seek(max(0, fh.tell() + offset))
            else:
                fh.seek(offset)
            return fh.read(limit)

    @staticmethod
    def task_log_path(task: str, log_type: str) -> str:
        """Alloc-dir-relative path of a task's stdout/stderr (the drivers
        write <task>/<task>.<type>)."""
        if log_type not in ("stdout", "stderr"):
            raise AllocFSError(400, f"bad log type {log_type!r}")
        return f"{task}/{task}.{log_type}"

