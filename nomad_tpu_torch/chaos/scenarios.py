"""Seeded chaos scenarios — a copy of the reference package's nine.

Each scenario is a function ``(seed, workdir, **knobs) -> report dict``:

```
{"name": ..., "seed": ..., "faults": [(seam, kind, step), ...],
 "violations": [...], ...extra per-scenario facts}
```

An empty ``violations`` list means every invariant
(:mod:`nomad_tpu.chaos.invariants`) held.  Scenarios never assert —
callers (tests, the repro tool) decide how to react, so a violating run
can still be inspected.

Replayability: fault *decisions* are a pure function of
``(seed, seam, hit-number)`` (see injector.py).  Scenarios built from
``at_step``/``count`` triggers reproduce the identical fired-fault
schedule run-to-run; probabilistic (``p``) triggers reproduce the same
decision table, with the fired subset following the seam's actual hit
count (thread timing can shift how many hits occur before quiescence).

Every scenario takes a ``device`` knob (default ``"cuda"``: its servers,
agents, coalescers and meshes run on the card unless the caller asks for
the CPU), and the three device scenarios an ``n_nodes`` knob (default the
reference's count).  Run one on the CPU with
``SCENARIOS["partition_then_heal"](3, workdir, device="cpu")``.

Differences from the reference, each because the port has no host twin
(an open breaker launches nothing and fails its lanes with
``DeviceBreakerOpenError``, so the evals come back through nack,
redelivery and the failed-eval reaper):

- ``wedged_dispatch_recovers``: ``degraded_dispatches`` counts the
  dispatches refused while the breaker was open (nothing launched then).
  The server's ``failed_eval_unblock_delay`` is short, so the reaper
  re-runs the refused evals inside the scenario's window; the report adds
  ``placed_after_close`` (every crowd job placed in full once the breaker
  re-closed), ``crowd_placed`` and the breaker's seconds.
- ``device_slow_flapping``: a dispatch an open breaker refused is sent
  again after the probation, as a worker's nack would; ``placed`` counts
  it once placed, ``refused`` counts the refusals.
- ``shard_loss_evacuation``: the coalescer runs on a mesh of eight
  virtual devices (two batch rows by four node shards) of ``device``; the
  report adds ``resident_mismatches`` (the mesh-resident copy after the
  evacuation against a from-scratch ``sync_sharded`` of the same layout)
  and the evacuation's host milliseconds and re-upload bytes.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, Dict, List

from .injector import FaultSpec, injected
from .invariants import check_store, wait_converged
from .wal_tools import complete_entries_at, sweep


def _wait(pred, timeout: float = 30.0, every: float = 0.05) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def _free_ports(n: int) -> List[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _http_cluster(n: int = 3, device="cuda"):
    """Spin an n-server HTTP control plane (the test_replication idiom)."""
    from ..api.agent import Agent, AgentConfig
    from ..server import ServerConfig

    ports = _free_ports(n)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    agents = []
    for i in range(n):
        agents.append(Agent(AgentConfig(
            name=f"server-{i}",
            server_enabled=True,
            client_enabled=False,
            http_host="127.0.0.1",
            http_port=ports[i],
            server_config=ServerConfig(
                num_workers=2,
                heartbeat_min_ttl=60,
                heartbeat_max_ttl=90,
                server_id=f"server-{i}",
                peers=list(addrs),
                election_timeout=(0.15, 0.3),
                raft_heartbeat_interval=0.05,
            ),
        ), device=device))
    for a in agents:
        a.start()
    return agents, addrs


def _leader(agents):
    leaders = [
        a for a in agents
        if a.server is not None and a.server.replicator is not None
        and a.server.replicator.is_leader
    ]
    return leaders[0] if len(leaders) == 1 else None


def _small_job(i: int = 0):
    from .. import mock

    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 2
    for t in tg.tasks:
        t.resources.cpu = 20 + 5 * (i % 4)
        t.resources.memory_mb = 32
        t.config = {"run_for": 0}
    tg.ephemeral_disk.size_mb = 10
    return job


def _evals_settled(server) -> bool:
    """Quiescence: nothing ready/pending/checked-out in the broker.
    ``ready_count`` matters: right after a submit burst the evals sit
    *ready* (not yet dequeued), so pending+unacked alone reads settled
    during the window before any worker picks them up."""
    broker = server.eval_broker
    return (
        broker.ready_count() == 0
        and broker.pending_count() == 0
        and broker.unacked_count() == 0
    )


def _fault_rows(inj) -> List[tuple]:
    return [(f.seam, f.kind, f.step) for f in inj.log]


# ----------------------------------------------------------------------
# Scenario 1: leader killed while plans/entries are in flight
# ----------------------------------------------------------------------

def leader_kill_mid_apply(seed: int, workdir: str, device="cuda") -> Dict:
    """Delay the leader's peer streams (widening the mid-replication
    window), kill the leader while entries are in flight, and require the
    survivors to elect, finish the work, and converge byte-identically."""
    from .. import mock

    schedule = [
        FaultSpec("raft.send", "delay", p=0.4, duration=0.05),
    ]
    report: Dict = {"name": "leader_kill_mid_apply", "seed": seed}
    with injected(seed, schedule) as inj:
        agents, addrs = _http_cluster(3, device)
        try:
            assert _wait(lambda: _leader(agents) is not None, timeout=20)
            leader = _leader(agents)
            for i in range(2):
                leader.server.register_node(mock.node())
            evs = [leader.server.submit_job(_small_job(i)) for i in range(3)]
            # Kill the leader with the tail of those submissions still
            # streaming to peers (the injected delays hold the window
            # open) — no drain, no goodbye.
            leader.shutdown()
            survivors = [a for a in agents if a is not leader]
            assert _wait(
                lambda: _leader(survivors) is not None, timeout=30
            ), "survivors failed to elect"
            new_leader = _leader(survivors)
            # The new leader must still serve writes.
            post_ev = new_leader.server.submit_job(_small_job(9))
            assert _wait(
                lambda: _evals_settled(new_leader.server), timeout=30
            )
            report["pre_kill_evals"] = [e.id for e in evs if e is not None]
            report["post_kill_eval"] = post_ev.id if post_ev else None
            servers = [a.server for a in survivors]
            violations = wait_converged(servers, timeout=20)
            violations += check_store(new_leader.server)
            report["violations"] = violations
        finally:
            for a in agents:
                try:
                    a.shutdown()
                except Exception:  # noqa: BLE001
                    pass
        report["faults"] = _fault_rows(inj)
    return report


# ----------------------------------------------------------------------
# Scenario 2: WAL truncated at every offset, restore must hold
# ----------------------------------------------------------------------

def wal_truncation_sweep(
    seed: int, workdir: str, stride: int = 0, device="cuda"
) -> Dict:
    """Build real server state, then restore from a copy of its data dir
    cut at every byte offset (strided).  Every cut must restore without
    error (torn final record dropped), applied entries must grow
    monotonically with the offset, and invariants must hold at each cut."""
    from .. import mock
    from ..server import Server, ServerConfig

    import shutil

    live_dir = os.path.join(workdir, "wal-live")
    srv = Server(ServerConfig(
        num_workers=1, heartbeat_min_ttl=600, heartbeat_max_ttl=900,
        data_dir=live_dir, snapshot_every=10_000,
    ), device=device)
    srv.start()
    try:
        for _ in range(2):
            srv.register_node(mock.node())
        for i in range(3):
            ev = srv.submit_job(_small_job(i))
            if ev is not None:
                srv.wait_for_eval(ev.id, timeout=60)
        # Capture the CRASH-STOP disk image now: the WAL flushes after
        # every append, and a clean shutdown would compact the whole log
        # into a snapshot, leaving no append surface to cut.
        data_dir = os.path.join(workdir, "wal-src")
        shutil.copytree(live_dir, data_dir)
    finally:
        srv.shutdown()

    # Strides are seeded so different seeds probe different offset
    # phases; stride=1 is exhaustive.
    if stride <= 0:
        stride = 61 + (seed % 13)
    report: Dict = {
        "name": "wal_truncation_sweep", "seed": seed, "stride": stride,
        "faults": [], "cuts": 0,
    }
    violations: List[str] = []
    prev_entries = -1
    prev_index = -1
    scratch = os.path.join(workdir, "wal-cuts")
    for offset, cut_dir in sweep(data_dir, scratch, stride=stride):
        entries = complete_entries_at(data_dir, offset)
        try:
            restored = Server(ServerConfig(
                num_workers=1, heartbeat_min_ttl=600,
                heartbeat_max_ttl=900, data_dir=cut_dir,
            ), device=device)
        except Exception as exc:  # noqa: BLE001
            violations.append(f"offset {offset}: restore raised {exc!r}")
            continue
        report["cuts"] += 1
        if entries < prev_entries:
            violations.append(
                f"offset {offset}: complete entries went backwards"
            )
        idx = restored.store.latest_index
        if entries >= prev_entries and idx < prev_index:
            violations.append(
                f"offset {offset}: latest_index regressed "
                f"{prev_index} -> {idx}"
            )
        prev_entries, prev_index = entries, idx
        for v in check_store(restored):
            violations.append(f"offset {offset}: {v}")
        if restored.store.wal is not None:
            restored.store.wal.close()
    report["violations"] = violations
    return report


# ----------------------------------------------------------------------
# Scenario 3: partition a follower, write through it, heal, converge
# ----------------------------------------------------------------------

def partition_then_heal(seed: int, workdir: str, device="cuda") -> Dict:
    """Cut the leader→follower link for a deterministic number of sends
    (count-based: the fired schedule is identical run-to-run), keep
    writing through the partition, then let the link heal and require all
    three FSM images to converge."""
    from .. import mock

    drops = 12 + (seed % 8)
    report: Dict = {
        "name": "partition_then_heal", "seed": seed, "drops": drops,
    }
    agents, addrs = _http_cluster(3, device)
    try:
        assert _wait(lambda: _leader(agents) is not None, timeout=20)
        leader = _leader(agents)
        victim = next(a for a in agents if a is not leader)
        schedule = [FaultSpec(
            "raft.send", "drop", match={"dst": victim.rpc_addr},
            count=drops,
        )]
        with injected(seed, schedule) as inj:
            leader.server.register_node(mock.node())
            for i in range(3):
                leader.server.submit_job(_small_job(i))
            # Hold the partition open until the budgeted drops are spent
            # (the heal is part of the schedule, not test timing).
            assert _wait(
                lambda: sum(
                    1 for f in inj.log if f.kind == "drop"
                ) >= drops,
                timeout=30,
            ), "partition never exhausted its drop budget"
            report["faults"] = _fault_rows(inj)
        assert _wait(lambda: _evals_settled(leader.server), timeout=30)
        violations = wait_converged(
            [a.server for a in agents], timeout=20
        )
        violations += check_store(leader.server)
        report["violations"] = violations
    finally:
        for a in agents:
            try:
                a.shutdown()
            except Exception:  # noqa: BLE001
                pass
    return report


# ----------------------------------------------------------------------
# Scenario 4: drain a node whose driver is wedged
# ----------------------------------------------------------------------

def wedged_driver_during_drain(
    seed: int, workdir: str, device="cuda"
) -> Dict:
    """Drain a node whose driver swallows stop requests and never reports
    task exit.  The kill path must time out past the wedge, the drain must
    complete, and the job must end up whole on the other node."""
    from .. import mock
    from ..client import Client, ClientConfig
    from ..server import Server, ServerConfig
    from ..structs.types import AllocClientStatus, DrainStrategy

    report: Dict = {"name": "wedged_driver_during_drain", "seed": seed}
    srv = Server(ServerConfig(
        num_workers=2, heartbeat_min_ttl=60, heartbeat_max_ttl=90,
    ), device=device)
    srv.start()
    clients = []
    try:
        for name in ("c1", "c2"):
            c = Client(srv, ClientConfig(
                data_dir=os.path.join(workdir, name),
            ))
            c.start()
            clients.append(c)
        job = _small_job()
        tg = job.task_groups[0]
        tg.count = 2
        for t in tg.tasks:
            t.config = {}  # run until stopped
            t.kill_timeout = 0.3
        ev = srv.submit_job(job)
        srv.wait_for_eval(ev.id, timeout=60)

        def running():
            return [
                a for a in srv.store.allocs_by_job(job.namespace, job.id)
                if a.client_status == AllocClientStatus.RUNNING.value
                and not a.terminal_status()
            ]

        assert _wait(lambda: len(running()) == 2, timeout=30)
        target = clients[0].node.id
        schedule = [
            FaultSpec("driver.stop", "skip"),
            FaultSpec("driver.wait", "wedge", after_step=1),
        ]
        with injected(seed, schedule) as inj:
            srv.update_node_drain(
                target,
                DrainStrategy(
                    deadline=60.0, force_deadline=time.time() + 60.0
                ),
            )
            srv.drainer.notify()
            assert _wait(lambda: not [
                a for a in srv.store.allocs_by_node(target)
                if not a.terminal_status()
            ], timeout=60), "drain never finished past the wedged driver"
            assert _wait(
                lambda: len(set(a.node_id for a in running())) == 1
                and len(running()) == 2,
                timeout=60,
            ), "job did not recover at full count off the drained node"
            report["faults"] = _fault_rows(inj)
        assert _wait(lambda: _evals_settled(srv), timeout=30)
        report["violations"] = check_store(srv)
    finally:
        for c in clients:
            try:
                c.shutdown()
            except Exception:  # noqa: BLE001
                pass
        srv.shutdown()
    return report


# ----------------------------------------------------------------------
# Overload scenarios: the control loop under chaos
# ----------------------------------------------------------------------

def _overload_tuned_config():
    """Controller thresholds scaled down so a test-sized flash crowd
    (hundreds of evals, one worker) crosses them within a couple of
    observatory ticks — same state machine, compressed constants."""
    from ..obs import OverloadConfig

    return OverloadConfig(
        gate_enter=0.03, gate_exit=0.012,
        shed_enter=0.05, shed_exit=0.025,
        window_fast=0.6, window_slow=3.0,
        min_dwell=0.4, cooldown=0.2,
        max_flips=8, flip_window=20.0,
        shed_priority_floor=50, shed_delay=0.3, shed_jitter=0.5,
        retry_after=0.5,
    )


def _pressure_at_end(server) -> Dict:
    """What the controller saw when recovery was judged: its fast and
    slow pressure, the health inputs that were not zero, and the blocked
    evals (a job the cluster has no room for stays blocked, and counts as
    pressure, until room appears)."""
    from ..obs.health import collect_signals, compute_health

    ctrl = server.overload_controller
    inputs = compute_health(collect_signals(server))["inputs"]
    return {
        "fast": round(ctrl._fast, 4), "slow": round(ctrl._slow, 4),
        "inputs": {k: v for k, v in inputs.items() if v},
        "blocked_evals": server.blocked_evals.blocked_count(),
    }


def _overload_cluster(n: int = 3, device="cuda"):
    """3-server raft control plane tuned for overload scenarios: one
    worker (so a crowd actually builds backlog), a fast observatory
    tick, compressed controller thresholds, and a small admission
    bucket the crowd can empty."""
    from ..api.agent import Agent, AgentConfig
    from ..server import ServerConfig

    ports = _free_ports(n)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    agents = []
    for i in range(n):
        agents.append(Agent(AgentConfig(
            name=f"server-{i}",
            server_enabled=True,
            client_enabled=False,
            http_host="127.0.0.1",
            http_port=ports[i],
            server_config=ServerConfig(
                num_workers=1,
                heartbeat_min_ttl=60,
                heartbeat_max_ttl=90,
                server_id=f"server-{i}",
                peers=list(addrs),
                # Roomier than the replication tests: overload runs keep
                # the GIL busy scheduling, and a spurious election mid-
                # crowd would make the goodput numbers lie.
                election_timeout=(0.5, 1.0),
                raft_heartbeat_interval=0.15,
                slo_interval=0.15,
                overload_config=_overload_tuned_config(),
                admission_rate=50.0,
                admission_burst=50.0,
            ),
        ), device=device))
    for a in agents:
        a.start()
    return agents, addrs


def _drain_rate(server, n_evals: int, timeout: float = 60.0):
    """Submit-side throughput: wait for the broker to drain and return
    (evals/s over the drain, drained_ok)."""
    start = time.time()
    ok = _wait(lambda: _evals_settled(server), timeout=timeout)
    elapsed = max(time.time() - start, 1e-6)
    return n_evals / elapsed, ok


def _submit_crowd(server, count: int, offset: int = 0,
                  low_priority_every: int = 2):
    """Blast ``count`` registrations as fast as the gate allows; every
    ``low_priority_every``-th job is priority-10 batch work (shed bait —
    the default floor only defers priority < 50).  Returns
    (admitted, rejected)."""
    from ..server.admission import RateLimitError

    admitted = rejected = 0
    for i in range(count):
        job = _small_job(offset + i)
        if low_priority_every and i % low_priority_every == 0:
            job.priority = 10
        try:
            server.submit_job(job)
            admitted += 1
        except RateLimitError:
            rejected += 1
    return admitted, rejected


def flash_crowd_flapping_partition(
    seed: int, workdir: str, crowd: int = 200, second_wave: int = 100,
    device="cuda",
) -> Dict:
    """A flash crowd hits the leader while one leader→follower link
    flaps (probabilistic drops).  The controller must engage shedding
    within its fast pressure window, goodput must not collapse while
    shedding, state flips must stay inside the hysteresis budget, and
    the cluster must return to steady with store invariants intact.

    ``second_wave`` submissions arrive paced *after* engagement — the
    shed path only defers evals enqueued while shedding is on, so the
    continuing-arrivals wave is what exercises it (set 0 to skip)."""
    from .. import mock

    report: Dict = {"name": "flash_crowd_flapping_partition", "seed": seed}
    schedule = [
        # The flapping partition: one link drops ~35% of sends for the
        # whole run.  Leadership holds through the second follower.
        FaultSpec("raft.send", "drop", p=0.35, match={"dst": "@victim"}),
    ]
    agents = []
    try:
        agents, addrs = _overload_cluster(3, device)
        assert _wait(lambda: _leader(agents) is not None, timeout=20)
        leader = _leader(agents)
        victim = next(a for a in agents if a is not leader)
        schedule[0].match = {"dst": victim.rpc_addr}
        for _ in range(2):
            leader.server.register_node(mock.node())
        srv = leader.server
        ctrl = srv.overload_controller

        # -- warm-up (first-eval kernel load must not skew rates) ------
        _submit_crowd(srv, 5, low_priority_every=0)
        assert _wait(lambda: _evals_settled(srv), timeout=60)
        # -- pre-overload baseline: a modest burst, fully drained ------
        n_pre, _ = _submit_crowd(srv, 30, offset=10, low_priority_every=0)
        pre_rate, drained = _drain_rate(srv, n_pre, timeout=60)
        assert drained, "baseline burst never drained"
        report["pre_rate"] = round(pre_rate, 1)
        _wait(lambda: ctrl.state == "steady", timeout=20)
        state_pre = ctrl.state

        with injected(seed, schedule) as inj:
            # -- the flash crowd under the flapping link --------------
            crowd_start = time.time()
            admitted, rejected = _submit_crowd(srv, crowd, offset=100)
            engaged = _wait(
                lambda: ctrl.state != "steady", timeout=10
            )
            t_engage = time.time() - crowd_start
            state_under_load = ctrl.state
            # -- continuing arrivals while engaged: paced so the gate's
            # throttled refill admits a trickle, and the low-priority
            # half of what lands gets shed-deferred.
            wave2_admitted = wave2_rejected = 0
            for i in range(second_wave):
                a2, r2 = _submit_crowd(
                    srv, 1, offset=1000 + i,
                    low_priority_every=1 if i % 2 == 0 else 0,
                )
                wave2_admitted += a2
                wave2_rejected += r2
                time.sleep(0.02)
            # Goodput over the whole overload phase: everything the
            # gate admitted, divided by crowd-start → queues-empty.
            drained = _wait(lambda: _evals_settled(srv), timeout=90)
            overload_rate = (admitted + wave2_admitted) / max(
                time.time() - crowd_start, 1e-6
            )
            shed_stats = srv.eval_broker.shed_stats()
            report["faults"] = _fault_rows(inj)

        report.update({
            "state_pre_crowd": state_pre,
            "admitted": admitted,
            "rejected": rejected,
            "wave2_admitted": wave2_admitted,
            "wave2_rejected": wave2_rejected,
            "engaged": engaged,
            "time_to_engage_s": round(t_engage, 3),
            "fast_window_s": ctrl.cfg.window_fast,
            "state_under_load": state_under_load,
            "crowd_drained": drained,
            "overload_rate": round(overload_rate, 1),
            "goodput_ratio": round(
                overload_rate / pre_rate, 3
            ) if pre_rate > 0 else None,
            "total_shed": shed_stats["total_shed"],
        })

        # -- recovery: de-escalate back to steady ----------------------
        recovered = _wait(lambda: ctrl.state == "steady", timeout=30)
        report["recovered"] = recovered
        report["pressure_at_end"] = _pressure_at_end(srv)
        report["flips"] = ctrl.flips_total
        report["flips_suppressed"] = ctrl.flips_suppressed
        report["flip_budget"] = ctrl.cfg.max_flips
        report["violations"] = check_store(srv)
    finally:
        for a in agents:
            try:
                a.shutdown()
            except Exception:  # noqa: BLE001
                pass
    return report


def breach_while_leader_killed(
    seed: int, workdir: str, device="cuda"
) -> Dict:
    """Kill the leader while its controller is actively shedding.  The
    dying leader must release its actuators on the way down, the
    survivors must elect, the new leader must keep serving writes (and
    re-judge overload from its own restored backlog), and the cluster
    must end steady with invariants intact."""
    from .. import mock

    report: Dict = {"name": "breach_while_leader_killed", "seed": seed}
    agents = []
    try:
        agents, addrs = _overload_cluster(3, device)
        assert _wait(lambda: _leader(agents) is not None, timeout=20)
        leader = _leader(agents)
        for _ in range(2):
            leader.server.register_node(mock.node())
        srv = leader.server
        ctrl = srv.overload_controller

        # Warm up the scheduler, then drive the controller out of
        # steady with a crowd.
        _submit_crowd(srv, 5, low_priority_every=0)
        assert _wait(lambda: _evals_settled(srv), timeout=60)
        admitted, rejected = _submit_crowd(srv, 200, offset=10)
        engaged = _wait(lambda: ctrl.state != "steady", timeout=10)
        report.update({
            "admitted": admitted,
            "rejected": rejected,
            "engaged_pre_kill": engaged,
            "state_pre_kill": ctrl.state,
            "shed_pre_kill": srv.eval_broker.shed_stats()["total_shed"],
        })

        # Kill it mid-shed — no drain, no goodbye.
        leader.shutdown()
        # shutdown() → overload_controller.reset(): the dead leader's
        # gate must not stay engaged (a zombie 429 source).
        report["old_leader_released"] = (
            ctrl.state == "steady"
            and srv.admission_gate.factor == 1.0
        )

        survivors = [a for a in agents if a is not leader]
        assert _wait(
            lambda: _leader(survivors) is not None, timeout=30
        ), "survivors failed to elect"
        new_leader = _leader(survivors)
        nsrv = new_leader.server
        # The new leader serves writes immediately (its own gate starts
        # steady — overload state is leader-local, not replicated).
        post_ev = nsrv.submit_job(_small_job(999))
        report["post_kill_eval"] = post_ev.id if post_ev else None
        report["new_leader_state_initial"] = (
            nsrv.overload_controller.state
        )

        assert _wait(lambda: _evals_settled(nsrv), timeout=60)
        recovered = _wait(
            lambda: nsrv.overload_controller.state == "steady",
            timeout=30,
        )
        report["recovered"] = recovered
        report["pressure_at_end"] = _pressure_at_end(nsrv)
        report["new_leader_flips"] = nsrv.overload_controller.flips_total
        report["flip_budget"] = nsrv.overload_controller.cfg.max_flips
        violations = wait_converged(
            [a.server for a in survivors], timeout=20
        )
        violations += check_store(nsrv)
        report["violations"] = violations
    finally:
        for a in agents:
            try:
                a.shutdown()
            except Exception:  # noqa: BLE001
                pass
    return report


# ----------------------------------------------------------------------
# Device fault domain scenarios: watchdog, breaker, evacuation
# ----------------------------------------------------------------------

class _pinned_env:
    """Set env knobs for the scenario's lifetime, restoring on exit —
    breaker config is read from the env at coalescer construction, so
    the knobs must be pinned before the Server/DeviceCoalescer exists."""

    def __init__(self, **kv):
        self._kv = {k: str(v) for k, v in kv.items()}
        self._saved: Dict[str, object] = {}

    def __enter__(self):
        for k, v in self._kv.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        return False


def _capacity(n_nodes: int, floor: int = 1024) -> int:
    """Matrix rows for ``n_nodes`` nodes: the server's default 1,024, or
    the next multiple of 1,024 (a 10,000-node cluster gets the north
    star's 10,240), so registration never grows the matrix."""
    return max(floor, -(-n_nodes // 1024) * 1024)


# How long the reaper waits before re-running an eval that failed its
# deliveries: the port has no host twin, so the evals an open breaker
# refused come back only this way (the server default is 60 s).
FAILED_EVAL_DELAY_S = 0.5


def _live(server, job) -> int:
    return sum(
        1 for a in server.store.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    )


def _quiet(server) -> bool:
    """Settled, and no failed eval's follow-up waiting in the broker."""
    return _evals_settled(server) and server.eval_broker.delayed_count() == 0


def _coalescer_inputs(m, job):
    """Compiled placement-request operands for one job (the
    tests/test_pipeline.py idiom)."""
    import numpy as np

    from ..ops.encode import RequestEncoder
    from ..scheduler.coalescer import MAX_DELTA_ROWS

    enc = RequestEncoder(m)
    compiled = enc.compile(job, job.task_groups[0])
    n = m.capacity
    return dict(
        request=compiled.request,
        delta_rows=np.full((MAX_DELTA_ROWS,), -1, np.int32),
        delta_vals=np.zeros((MAX_DELTA_ROWS, 3), np.float32),
        tg_count=np.zeros((n,), np.int32),
        spread_counts=np.zeros_like(compiled.request.s_desired),
        penalty=np.zeros((n,), bool),
        class_elig=np.ones((2,), bool),
        host_mask=np.ones((n,), bool),
    )


def wedged_dispatch_recovers(
    seed: int, workdir: str, crowd: int = 24, device="cuda",
    n_nodes: int = 4,
) -> Dict:
    """One device→host wait wedges at full pipeline depth: the watchdog
    must classify and abandon it inside its bound (no future ever
    hangs), the breaker must trip and refuse dispatches while open
    (launching nothing), the wedged and refused evals must come back
    through the worker's nack path, redelivery and the failed-eval
    reaper, the breaker must re-close through its half-open canary once
    the fault schedule is spent, every crowd job must then be placed in
    full (or blocked for room), and live throughput must recover to
    ≥50% of the healthy baseline within the scenario window (the bursts
    while open and the post-re-close burst both count)."""
    from .. import mock
    from ..server import Server, ServerConfig

    report: Dict = {"name": "wedged_dispatch_recovers", "seed": seed}
    violations: List[str] = []
    env = _pinned_env(
        NOMAD_TPU_DEVICE_DEADLINE_MS="150",
        NOMAD_TPU_DEVICE_COLD_SCALE="1",
        NOMAD_TPU_DEVICE_PROBATION="0.3",
        NOMAD_TPU_DEVICE_COOLDOWN="0.05",
    )
    with env:
        srv = Server(ServerConfig(
            num_workers=2,
            heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0,
            eval_nack_timeout=5.0, pipeline_depth=8,
            slo_enabled=False, node_capacity=_capacity(n_nodes),
            failed_eval_unblock_delay=FAILED_EVAL_DELAY_S,
        ), device=device)
        srv.start()
        try:
            for _ in range(n_nodes):
                srv.register_node(mock.node())
            coal = srv.coalescer
            brk = coal.breaker

            def burst(count, offset):
                """Submit→queues-empty wall time for one burst (the
                submission loop is part of the measured phase — both
                phases pay it identically).  The drain poll is much
                tighter than elsewhere: a burst this small settles in
                milliseconds, so a 10 ms poll would *be* the
                measurement."""
                t0 = time.time()
                for i in range(count):
                    srv.submit_job(_small_job(offset + i))
                ok = _wait(
                    lambda: _evals_settled(srv), timeout=60, every=0.0005
                )
                return count / max(time.time() - t0, 1e-6), ok

            def best_burst(offsets):
                """Max rate over repeated measurement bursts.  A burst
                of `crowd` small jobs drains in milliseconds — one
                scheduler hiccup dominates the rate — so the measured
                bursts are 4× the crowd (amortize) and a hiccup can only
                *lower* a measurement, so best-of-N estimates
                capability."""
                best = 0.0
                all_ok = True
                for off in offsets:
                    rate, ok = burst(4 * crowd, off)
                    best = max(best, rate)
                    all_ok = all_ok and ok
                return best, all_ok

            # Warm-up (first-eval kernel load and encoder caches), then
            # the healthy baseline bursts.
            _, ok = burst(5, 0)
            if not ok:
                violations.append("warm-up burst never drained")
            pre_rate, ok = best_burst((1000, 1200, 1400))
            if not ok:
                violations.append("baseline burst never drained")
            report["pre_rate"] = round(pre_rate, 1)

            # -- the wedge: one wait blows through the watchdog --------
            schedule = [FaultSpec("device.wedge", "wedge", count=1)]
            crowd_jobs = [_small_job(100 + i) for i in range(crowd)]
            with injected(seed, schedule) as inj:
                t_crowd = time.time()
                for job in crowd_jobs:
                    srv.submit_job(job)
                tripped = _wait(
                    lambda: brk.brief()["breaker"] != "closed",
                    timeout=15,
                )
                drained = _wait(
                    lambda: _evals_settled(srv), timeout=60
                )
                report["faults"] = _fault_rows(inj)

            # -- throughput while the breaker is open: the refused
            # dispatches launch nothing and their evals fail over to the
            # reaper (the breaker re-closes through its half-open canary
            # somewhere inside these bursts once probation elapses —
            # both regimes count toward the ≥50% floor).
            post_rate, ok = best_burst((2000, 2200, 2400))
            if not ok:
                violations.append("burst while open never drained")

            brief = brk.brief()
            report.update({
                "tripped": tripped,
                "wedged_dispatches": coal.wedged_dispatches,
                "degraded_dispatches": brief["degraded_dispatches"],
                "trips": brief["trips"],
                "crowd_drained": drained,
                "post_rate": round(post_rate, 1),
            })
            if not any(k == "wedge" for _, k, _ in report["faults"]):
                violations.append("wedge fault never fired")
            if not tripped:
                violations.append("breaker never left closed")
            if coal.wedged_dispatches < 1:
                violations.append("no dispatch classified wedged")
            if brief["degraded_dispatches"] < 1:
                violations.append("no dispatch was refused while open")
            if not drained:
                violations.append(
                    "wedged crowd never drained — a future hung past "
                    "the watchdog or redelivery stalled"
                )
            # Recovery: the half-open canary needs live dispatches to
            # carry its verdict — trickle until the breaker re-closes.
            deadline = time.time() + 15
            i = 0
            while (
                brk.brief()["breaker"] != "closed"
                and time.time() < deadline
            ):
                srv.submit_job(_small_job(500 + i))
                i += 1
                _wait(lambda: _evals_settled(srv), timeout=10)
                time.sleep(0.05)
            recovered = brk.brief()["breaker"] == "closed"
            report["recovered"] = recovered
            if not recovered:
                violations.append(
                    "breaker never re-closed once the schedule was spent"
                )
            # The recovery floor spans the whole post-wedge window: the
            # bursts while open above AND a post-re-close burst — "live
            # throughput recovers to ≥50% of healthy within the
            # scenario window".
            rec_rate, ok = best_burst((3000, 3200))
            if not ok:
                violations.append("post-recovery burst never drained")
            best_post = max(post_rate, rec_rate)
            ratio = best_post / pre_rate if pre_rate > 0 else None
            report["recovered_rate"] = round(rec_rate, 1)
            report["throughput_ratio"] = (
                round(ratio, 3) if ratio is not None else None
            )
            if ratio is not None and ratio < 0.5:
                violations.append(
                    f"throughput never recovered to ≥50% of healthy: "
                    f"best post-wedge {best_post:.1f}/s vs "
                    f"{pre_rate:.1f}/s healthy"
                )

            # -- the crowd after the re-close: the reaper's follow-ups
            # place every crowd job (the wedged and refused evals failed
            # their deliveries; no host twin placed them meanwhile).
            def unplaced():
                return [
                    j for j in crowd_jobs
                    if _live(srv, j) < j.task_groups[0].count
                ]

            _wait(lambda: not unplaced() or _quiet(srv), timeout=60,
                  every=0.005)
            t_placed = time.time()
            left = unplaced()
            report["crowd_placed"] = crowd - len(left)
            report["placed_after_close"] = recovered and not left
            # A crowd job the cluster has no room for ends blocked, as in
            # the reference; anything else was lost on the way back.
            lost = [
                j.id for j in left
                if not any(
                    e.status == "blocked"
                    for e in srv.store.evals_by_job(j.namespace, j.id)
                )
            ]
            if lost:
                violations.append(
                    f"{len(lost)} crowd job(s) neither placed in full nor "
                    f"blocked for room after the breaker re-closed"
                )
            decisions = brk.report()["decisions"]
            trip = next((d["at"] for d in decisions if d["to"] == "open"),
                        None)
            close = next((d["at"] for d in reversed(decisions)
                          if d["to"] == "closed"), None)
            report.update({
                "crowd_to_trip_s": (round(trip - t_crowd, 3)
                                    if trip is not None else None),
                "trip_to_close_s": (round(close - trip, 3)
                                    if trip is not None
                                    and close is not None else None),
                "crowd_to_placed_s": (round(t_placed - t_crowd, 3)
                                      if not left else None),
            })
            violations += check_store(srv)
            report["violations"] = violations
        finally:
            srv.shutdown()
    return report


def device_slow_flapping(
    seed: int, workdir: str, dispatches: int = 60, device="cuda",
    n_nodes: int = 8,
) -> Dict:
    """A flapping ``device.slow`` seam (p=0.5) drives the breaker's
    slow-ratio trip back and forth through open/half-open/closed; the
    flip budget must bound the oscillation and every placement must
    still complete (a dispatch the open breaker refused is sent again
    after the probation, as a worker's nack would; the refusals are
    counted apart)."""
    from .. import mock
    from ..obs.breaker import DeviceBreakerOpenError
    from ..scheduler.coalescer import DeviceCoalescer
    from ..state.matrix import NodeMatrix

    report: Dict = {"name": "device_slow_flapping", "seed": seed}
    violations: List[str] = []
    env = _pinned_env(
        NOMAD_TPU_DEVICE_DEADLINE_MS="40",
        NOMAD_TPU_DEVICE_COLD_SCALE="1",
        NOMAD_TPU_DEVICE_MIN_SAMPLES="4",
        NOMAD_TPU_DEVICE_WINDOW="30",
        NOMAD_TPU_DEVICE_PROBATION="0.05",
        NOMAD_TPU_DEVICE_COOLDOWN="0.02",
        NOMAD_TPU_DEVICE_MAX_FLIPS="4",
        NOMAD_TPU_DEVICE_FLIP_WINDOW="60",
    )
    with env:
        m = NodeMatrix(
            capacity=16 if n_nodes <= 16 else _capacity(n_nodes),
            device=device,
        )
        for _ in range(n_nodes):
            m.upsert_node(mock.node())
        coal = DeviceCoalescer(
            m, max_lanes=1, linger_s=0.0, pipeline_depth=1, device=device
        )
        coal.start()
        try:
            inputs = _coalescer_inputs(m, _small_job())
            schedule = [FaultSpec("device.slow", "slow", p=0.5)]
            placed = refused = 0
            with injected(seed, schedule) as inj:
                for _ in range(dispatches):
                    while True:
                        try:
                            out = coal.place(**inputs)
                            break
                        except DeviceBreakerOpenError:
                            # Nothing launched: send it again after the
                            # probation, as a worker's nack would.
                            refused += 1
                            time.sleep(coal.breaker.cfg.probation_s)
                    if out is not None:
                        placed += 1
                report["faults"] = _fault_rows(inj)
        finally:
            coal.stop()
        brk = coal.breaker
        brief = brk.brief()
        report.update({
            "placed": placed,
            "refused": refused,
            "slow_recorded": brief["slow"],
            "trips": brief["trips"],
            "flips": brk.flips_total,
            "flips_suppressed": brk.flips_suppressed,
            "flip_budget": brk.cfg.max_flips,
            "final_state": brief["breaker"],
        })
        if placed != dispatches:
            violations.append(
                f"only {placed}/{dispatches} placements completed"
            )
        if not any(k == "slow" for _, k, _ in report["faults"]):
            violations.append("slow fault never fired")
        if brief["slow"] < 1:
            violations.append("no fetch classified slow")
        if brk.flips_total > brk.cfg.max_flips:
            violations.append(
                f"flip budget breached: {brk.flips_total} flips > "
                f"budget {brk.cfg.max_flips}"
            )
        report["violations"] = violations
    return report


def _resident_mismatches(m, mesh) -> int:
    """Fields of the mesh-resident copy that differ, bit for bit, from a
    from-scratch lay-out of the matrix's host arrays over ``mesh``."""
    import torch

    from ..parallel.sharding import shard_matrix_arrays
    from ..state.matrix import DeviceArrays

    resident = m.sync_sharded(mesh)
    with m._host_lock:
        host = DeviceArrays(**{
            f: m.snapshot_host()[f].copy() for f in DeviceArrays._fields})
    scratch = shard_matrix_arrays(mesh, host)
    bad = 0
    for row_a, row_b in zip(resident.shards, scratch.shards):
        for a, b in zip(row_a, row_b):
            for f in DeviceArrays._fields:
                x, y = getattr(a, f), getattr(b, f)
                if x.dtype.is_floating_point:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                if x.shape != y.shape or not torch.equal(x, y):
                    bad += 1
    return bad


def shard_loss_evacuation(
    seed: int, workdir: str, device="cuda", n_nodes: int = 12,
) -> Dict:
    """Lose a whole matrix home shard mid-dispatch: the matrix must
    evacuate it (re-lay-out across the survivors), the post-evacuation
    layout must be bit-identical to inserting the same nodes in old-row
    order into a from-scratch survivor matrix (the PARITY.md proof), the
    mesh-resident copy must equal a from-scratch lay-out of it, the
    in-flight placement must still complete against the re-homed layout
    on the survivors' mesh, and ``heal`` must restore the original shard
    count with store invariants green."""
    from .. import mock
    from ..scheduler.coalescer import DeviceCoalescer
    from ..server import Server, ServerConfig
    from ..state.matrix import NodeMatrix

    report: Dict = {"name": "shard_loss_evacuation", "seed": seed}
    violations: List[str] = []
    srv = Server(ServerConfig(
        num_workers=2,
        heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0,
        node_capacity=_capacity(n_nodes),
    ), device=device)
    srv.start()
    try:
        m = srv.store.matrix
        m.set_shard_count(4)
        nodes = [mock.node() for _ in range(n_nodes)]
        for n in nodes:
            srv.register_node(n)
        pre_counts = m.shard_row_counts()
        # Old-row insertion order: what the evacuation replay (and
        # the from-scratch parity twin below) both iterate.
        order = [m.node_of[r] for r in sorted(m.node_of)]
        by_id = {n.id: n for n in nodes}

        # Four virtual node shards of one device: make_mesh puts an
        # even device count into two batch rows, so eight devices.
        coal = DeviceCoalescer(
            m, max_lanes=2, linger_s=0.0, pipeline_depth=1,
            device=[device] * 8,
        )
        evac_s: List[float] = []
        evacuate = coal.evacuate_shard

        def timed_evacuate(shard):
            t0 = time.perf_counter()
            out = evacuate(shard)
            evac_s.append(time.perf_counter() - t0)
            return out

        coal.evacuate_shard = timed_evacuate
        coal.start()
        try:
            # One placement on the four-shard mesh before the loss (no
            # injector yet, so it is no hit of the schedule).
            out0 = coal.place(**_coalescer_inputs(m, mock.job()))
            uploaded = m.upload_bytes_total
            schedule = [FaultSpec("shard.loss", "lost", count=1)]
            with injected(seed, schedule) as inj:
                out = coal.place(**_coalescer_inputs(m, mock.job()))
                report["faults"] = _fault_rows(inj)
            report.update({
                "pre_shards": 4,
                "pre_counts": pre_counts,
                "pre_placed_row": int(out0.rows[0]),
                "post_shards": int(m.shard_count),
                "post_counts": m.shard_row_counts(),
                "evacuations": coal.shard_evacuations,
                "placed_row": int(out.rows[0]),
                "evacuation_ms": (round(evac_s[0] * 1e3, 3)
                                  if evac_s else None),
                "reupload_bytes": int(m.upload_bytes_total - uploaded),
            })
            if not any(
                k == "lost" for _, k, _ in report["faults"]
            ):
                violations.append("loss fault never fired")
            if int(m.shard_count) != 3:
                violations.append(
                    f"expected 3 survivor shards, got {m.shard_count}"
                )
            if coal.shard_evacuations != 1:
                violations.append("evacuation counter did not move")
            if out0.rows[0] < 0:
                violations.append("placement before the loss failed")
            if out.rows[0] < 0:
                violations.append(
                    "in-flight placement failed after evacuation"
                )
            # Parity: a from-scratch 3-shard matrix fed the same
            # nodes in old-row order must assign identical rows.
            twin = NodeMatrix(capacity=m.capacity, device=device)
            twin.set_shard_count(int(m.shard_count))
            for nid in order:
                twin.upsert_node(by_id[nid])
            mismatches = [
                nid for nid in order
                if twin.row_of[nid] != m.row_of[nid]
            ]
            report["parity_mismatches"] = len(mismatches)
            if mismatches:
                violations.append(
                    f"evacuated layout diverges from from-scratch "
                    f"survivor layout for {len(mismatches)} node(s)"
                )
            # The survivors' mesh holds the re-homed layout as a fresh
            # lay-out of the host arrays would.
            resident = _resident_mismatches(m, coal._mesh)
            report["resident_mismatches"] = resident
            if resident:
                violations.append(
                    f"{resident} mesh-resident field(s) differ from a "
                    f"from-scratch lay-out after the evacuation"
                )
            # Heal: full re-layout back to the original partition.
            restored = coal.heal_shard_evacuations()
            report["restored_shards"] = restored
            if restored != 4 or int(m.shard_count) != 4:
                violations.append("heal did not restore shard count")
            out2 = coal.place(**_coalescer_inputs(m, mock.job()))
            if out2.rows[0] < 0:
                violations.append("post-heal placement failed")
        finally:
            coal.stop()
        violations += check_store(srv)
        report["violations"] = violations
    finally:
        srv.shutdown()
    return report


SCENARIOS: Dict[str, Callable[..., Dict]] = {
    "leader_kill_mid_apply": leader_kill_mid_apply,
    "wal_truncation_sweep": wal_truncation_sweep,
    "partition_then_heal": partition_then_heal,
    "wedged_driver_during_drain": wedged_driver_during_drain,
    "flash_crowd_flapping_partition": flash_crowd_flapping_partition,
    "breach_while_leader_killed": breach_while_leader_killed,
    "wedged_dispatch_recovers": wedged_dispatch_recovers,
    "device_slow_flapping": device_slow_flapping,
    "shard_loss_evacuation": shard_loss_evacuation,
}
