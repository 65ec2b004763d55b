"""The port's node lifecycle on the CPU: heartbeat expiry, a down node's
return, and a system job's blocked eval.

These run the port alone (``Server(device="cpu")``) with short TTLs and a
seeded TTL generator.  Every wait carries its own timeout, so a fault
fails the test instead of hanging the suite.
"""

import random
import threading
import time

import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.server.heartbeat import HeartbeatManager
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs.types import Constraint, NetworkResource

# One intra-op thread: these tests share the host's cores with the
# other test workers, whose timing tests a thread pool would starve.
torch.set_num_threads(1)

WAIT = 20.0  # seconds any one condition may take


def wait_until(pred, what, timeout=WAIT):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.02)


def live_allocs(srv, job_id):
    return [a for a in srv.store.allocs.values()
            if a.job_id == job_id and not a.terminal_status()]


def play_client(srv, status="running", only=None):
    """Report pending allocs (or the ``only`` ids) with ``status``."""
    updates = []
    for a in list(srv.store.allocs.values()):
        pick = a.id in only if only is not None else (
            a.client_status == "pending" and a.desired_status == "run")
        if pick:
            upd = a.copy()
            upd.client_status = status
            updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)


@pytest.fixture
def server():
    made = []

    def make(**kw):
        cfg = ServerConfig(num_workers=2, node_capacity=16, **kw)
        srv = Server(cfg, device="cpu")
        srv.start()
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.shutdown()


def test_ttl_jitter_follows_the_seed():
    def ttls(seed):
        hb = HeartbeatManager(lambda _: None, random.Random(seed),
                              min_ttl=0.2, max_ttl=0.5)
        return [hb.reset_heartbeat(f"n{i}") for i in range(16)]

    a, b = ttls(5), ttls(5)
    assert a == b
    assert ttls(6) != a
    assert all(0.2 <= x <= 0.5 for x in a)


def test_missed_heartbeat_marks_down_and_replaces(server):
    srv = server(heartbeat_min_ttl=0.4, heartbeat_max_ttl=0.5, heartbeat_seed=3)
    nodes = [mock.node() for _ in range(5)]
    silent = set()
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            for n in nodes:
                if n.id not in silent:
                    srv.heartbeat_node(n.id)
            stop.wait(0.05)

    for n in nodes:
        srv.register_node(n)
    beater = threading.Thread(target=beat, daemon=True)
    beater.start()
    try:
        web = mock.job()
        web.task_groups[0].count = 3
        web.task_groups[0].constraints = [Constraint(operand="distinct_hosts")]
        sysjob = mock.system_job()
        for job in (web, sysjob):
            ev = srv.submit_job(job)
            assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
        play_client(srv)
        assert len(live_allocs(srv, sysjob.id)) == 5
        victim = live_allocs(srv, web.id)[0].node_id
        lost_ids = {a.id for a in srv.store.allocs_by_node(victim)}
        assert len(lost_ids) == 2  # one web, one system alloc

        silent.add(victim)
        wait_until(lambda: srv.store.node_by_id(victim).status == "down",
                   "the silent node to go down")
        wait_until(lambda: all(srv.store.alloc_by_id(i).client_status == "lost"
                               for i in lost_ids), "its allocs to be lost")
        wait_until(lambda: len(live_allocs(srv, web.id)) == 3,
                   "the web alloc to be replaced")
        assert victim not in {a.node_id for a in live_allocs(srv, web.id)}
        assert len(live_allocs(srv, sysjob.id)) == 4
        assert srv.metrics.snapshot()["nomad.heartbeat.missed"] >= 1
        # Every other node kept beating and stayed up.
        for n in nodes:
            if n.id != victim:
                assert srv.store.node_by_id(n.id).status == "ready"

        # A heartbeat from the down node brings it back as initializing;
        # once it reports ready the system job lands on it again.
        silent.discard(victim)
        wait_until(lambda: srv.store.node_by_id(victim).status == "initializing",
                   "the returning node to re-register")
        srv.update_node_status(victim, "ready")
        wait_until(lambda: len(live_allocs(srv, sysjob.id)) == 5,
                   "the system job to return to the node")
    finally:
        stop.set()
        beater.join(timeout=5)
    assert not beater.is_alive()


def test_exhausted_system_eval_blocks_then_unblocks(server):
    srv = server(heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
    nodes = [mock.node() for _ in range(3)]
    for n in nodes:
        srv.register_node(n)
    big = mock.batch_job()
    big.task_groups[0].count = 1
    big.task_groups[0].tasks[0].resources.cpu = 3000
    ev = srv.submit_job(big)
    assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
    play_client(srv)
    busy = live_allocs(srv, big.id)[0]

    tk.reset_counts()
    sysjob = mock.system_job()
    sysjob.task_groups[0].tasks[0].resources.cpu = 2000
    ev = srv.submit_job(sysjob)
    done = srv.wait_for_eval(ev.id, WAIT)
    assert done.status == "complete"
    metric = done.failed_tg_allocs["system"]
    assert metric.nodes_exhausted == 1 and metric.coalesced_failures == 1
    assert done.queued_allocations == {"system": 1}
    assert done.blocked_eval
    assert srv.store.eval_by_id(done.blocked_eval).status == "blocked"
    assert {a.node_id for a in live_allocs(srv, sysjob.id)} == (
        {n.id for n in nodes} - {busy.node_id})

    # The batch alloc completes on the client: its node frees capacity
    # and the blocked system eval runs again and places there.
    play_client(srv, status="complete", only={busy.id})
    wait_until(lambda: srv.store.eval_by_id(done.blocked_eval).status
               == "complete", "the blocked eval to run again")
    wait_until(lambda: len(live_allocs(srv, sysjob.id)) == 3,
               "the system alloc on the freed node")
    assert tk.system_feasible_plain.calls == 2
    assert tk.system_feasible.launches == 0


def test_static_port_system_job_keeps_its_allocs(server):
    """A node joins and the system job with a static port is evaluated
    again: it keeps its alloc on every node and adds the new node.  The
    job's own ports do not make its own nodes infeasible (the JAX package
    stops all but the new node's alloc here: ROADMAP queue 3, R3)."""
    srv = server(heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
    for _ in range(6):
        srv.register_node(mock.node())
    sysjob = mock.system_job()
    sysjob.task_groups[0].tasks[0].resources.networks = [
        NetworkResource(reserved_ports=[9100])]
    ev = srv.submit_job(sysjob)
    assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
    first = {a.id for a in live_allocs(srv, sysjob.id)}
    assert len(first) == 6
    srv.register_node(mock.node())
    wait_until(lambda: len(live_allocs(srv, sysjob.id)) == 7,
               "the system job on the new node")
    wait_until(lambda: all(e.terminal_status()
                           for e in list(srv.store.evals.values())),
               "the node-update eval")
    live = {a.id for a in live_allocs(srv, sysjob.id)}
    assert first < live and len(live) == 7
    assert all(9100 in a.assigned_ports["sys"].values()
               for a in live_allocs(srv, sysjob.id))


class _Planner:
    """The planner a worker would be, without the worker thread: plans go
    straight to the server's applier."""

    def __init__(self, srv):
        self.srv = srv

    def submit_plan(self, plan):
        return self.srv.plan_applier.apply(plan), None

    def update_eval(self, ev):
        self.srv.store.upsert_evals(self.srv.next_index(), [ev])

    def create_evals(self, evals):
        self.srv.store.upsert_evals(self.srv.next_index(), list(evals))

    def refresh_snapshot(self):
        return self.srv.store.snapshot()


def test_system_eval_on_an_old_snapshot_marks_allocs_lost():
    """An eval whose snapshot predates a node going down sees the node
    infeasible in the (live) matrix: the alloc it stops there is lost,
    not "not needed" (ROADMAP queue 3, R5)."""
    from nomad_tpu_torch.scheduler.system import SystemScheduler
    from nomad_tpu_torch.structs.types import Evaluation

    srv = Server(ServerConfig(num_workers=1, node_capacity=8), device="cpu")
    srv.matrix.coalescer = None  # device work inline: the server is not started
    nodes = [mock.node() for _ in range(3)]
    for n in nodes:
        srv.store.upsert_node(srv.next_index(), n)
    job = mock.system_job()
    srv.store.upsert_job(srv.next_index(), job)
    planner = _Planner(srv)

    def evaluate(snapshot):
        ev = Evaluation(job_id=job.id, type="system")
        SystemScheduler(snapshot, planner, srv.matrix).process(ev)

    evaluate(srv.store.snapshot())
    assert len(live_allocs(srv, job.id)) == 3
    old = srv.store.snapshot()
    srv.store.update_node_status(srv.next_index(), nodes[0].id, "down")
    evaluate(old)
    stopped = srv.store.allocs_by_node(nodes[0].id)
    assert len(stopped) == 1
    assert stopped[0].desired_status == "stop"
    assert stopped[0].client_status == "lost"
    assert len(live_allocs(srv, job.id)) == 2


def test_pick_that_fails_the_cross_lane_verify_is_made_again():
    """When the device's cross-lane verify says an earlier lane of the same
    launch took a node's room, the stack picks again without that node
    instead of handing the applier a plan it must reject (ROADMAP queue 3,
    R4)."""
    import numpy as np

    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.stack import GenericStack
    from nomad_tpu_torch.structs.types import Plan

    srv = Server(ServerConfig(num_workers=1, node_capacity=8), device="cpu")
    srv.matrix.coalescer = None  # device work inline: the server is not started
    nodes = [mock.node() for _ in range(3)]
    for n in nodes:
        srv.store.upsert_node(srv.next_index(), n)
    job = mock.job()
    stack = GenericStack(EvalContext(srv.store.snapshot(), Plan(job=job)),
                         srv.matrix)
    stack.set_job(job)
    masks = []

    def dispatch(compiled, deltas, tg_count, spread_counts, penalty,
                 class_elig, host_mask, remaining):
        masks.append(None if host_mask is None else host_mask.copy())
        row = len(masks) - 1  # row 0 first, then row 1
        one = np.ones(1, np.int32)
        return (np.array([row], np.int32), np.ones(1, np.float32),
                np.ones(1, np.float32), np.zeros(1, bool), one, 0 * one,
                0 * one, np.array([row != 0]))

    stack._dispatch_place = dispatch
    (opt,) = stack.select(job.task_groups[0], 1)
    assert len(masks) == 2
    assert masks[0] is None and not masks[1][0] and masks[1][1]
    assert opt.row == 1 and opt.fit_verified is True
    assert opt.node_id == srv.matrix.node_of[1]


def test_matrix_eligible_row_follows_the_node_rpcs(server):
    """The card-resident eligible row (what both kernels read) tracks every
    node RPC that changes readiness, as in the JAX package."""
    from nomad_tpu_torch.structs.types import DrainStrategy

    srv = server(heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
    node = mock.node()
    srv.register_node(node)
    row = srv.matrix.row_of[node.id]

    def eligible():
        return bool(srv.matrix.sync().eligible[row])

    steps = [
        (lambda: None, True),
        (lambda: srv.update_node_drain(node.id, DrainStrategy()), False),
        (lambda: srv.complete_node_drain(node.id), False),
        (lambda: srv.update_node_eligibility(node.id, "eligible"), True),
        (lambda: srv.update_node_status(node.id, "down"), False),
        (lambda: srv.heartbeat_node(node.id), False),  # back as initializing
        (lambda: srv.update_node_status(node.id, "ready"), True),
        (lambda: srv.update_node_eligibility(node.id, "ineligible"), False),
    ]
    for i, (rpc, want) in enumerate(steps):
        rpc()
        assert eligible() == want == srv.store.node_by_id(node.id).ready(), i


def test_partial_commits_that_make_progress_keep_the_eval_going(server,
                                                                 monkeypatch):
    """An eval whose plans the applier keeps committing only in part still
    places its whole count: each round that commits something starts the
    retry budget again (Nomad's retryMax with progressMade).  Without it,
    five partial rounds fail the eval with its job short (ROADMAP queue 3,
    R4)."""
    from nomad_tpu_torch.scheduler.generic import MAX_SERVICE_SCHEDULE_ATTEMPTS
    from nomad_tpu_torch.server.plan_apply import PlanApplier

    srv = server(heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
    for _ in range(16):
        srv.register_node(mock.node())
    rounds = []
    real = PlanApplier._evaluate

    def one_node_a_round(self, plan):
        # Commit the placements of one node of each plan; refuse the rest.
        failed = real(self, plan)
        ok = sorted(set(plan.node_allocation) - failed)
        rounds.append(len(ok))
        return failed | set(ok[1:])

    count = 2 * MAX_SERVICE_SCHEDULE_ATTEMPTS + 2
    job = mock.job()
    job.task_groups[0].count = count
    job.task_groups[0].constraints = [Constraint(operand="distinct_hosts")]
    monkeypatch.setattr(PlanApplier, "_evaluate", one_node_a_round)
    ev = srv.submit_job(job)
    done = srv.wait_for_eval(ev.id, WAIT)
    assert done.status == "complete", done.status_description
    assert len(live_allocs(srv, job.id)) == count
    assert len(rounds) >= count > MAX_SERVICE_SCHEDULE_ATTEMPTS


def test_eval_that_loses_every_plan_round_is_retried_from_a_blocked_eval(
        server, monkeypatch):
    """An eval whose plan the applier refuses in every one of its rounds
    fails with "maximum attempts reached" and leaves a blocked eval
    (Nomad's createBlockedEval(planFailure)); the server retries it after
    failed_eval_unblock_interval and the job places in full.  Without it
    the job stays short for good (ROADMAP queue 3, R4)."""
    from nomad_tpu_torch.scheduler.generic import (
        BLOCKED_EVAL_MAX_PLAN_DESC,
        MAX_SERVICE_SCHEDULE_ATTEMPTS,
    )
    from nomad_tpu_torch.server.plan_apply import PlanApplier

    srv = server(heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0,
                 failed_eval_unblock_interval=0.2)
    for _ in range(4):
        srv.register_node(mock.node())
    rounds = []
    real = PlanApplier._evaluate

    def lose_the_first_rounds(self, plan):
        # Refuse every node of the eval's first `limit` plans.
        failed = real(self, plan)
        rounds.append(plan.eval_id)
        if len(rounds) <= MAX_SERVICE_SCHEDULE_ATTEMPTS:
            return failed | set(plan.node_allocation)
        return failed

    job = mock.job()
    job.task_groups[0].count = 3
    monkeypatch.setattr(PlanApplier, "_evaluate", lose_the_first_rounds)
    ev = srv.submit_job(job)
    failed = srv.wait_for_eval(ev.id, WAIT)
    assert failed.status == "failed"
    assert failed.status_description == "maximum attempts reached"
    assert failed.blocked_eval
    wait_until(lambda: len(live_allocs(srv, job.id)) == 3, "the retry")
    retry = srv.wait_for_eval(failed.blocked_eval, WAIT)
    assert retry.status == "complete", retry.status_description
    assert retry.triggered_by == "max-plan-attempts"
    assert retry.previous_eval == ev.id
    assert srv.store.eval_by_id(ev.id).status == "failed"
    assert rounds == [ev.id] * MAX_SERVICE_SCHEDULE_ATTEMPTS + [retry.id]
    blocked = [e for e in srv.store.evals.values()
               if e.status_description == BLOCKED_EVAL_MAX_PLAN_DESC]
    assert [e.id for e in blocked] == [retry.id]


def test_unblock_failed_retries_only_evals_blocked_on_plan_conflicts():
    """``BlockedEvals.unblock_failed`` re-enqueues the evals blocked after
    placement conflicts and leaves those waiting for capacity."""
    from nomad_tpu_torch.server.blocked_evals import BlockedEvals
    from nomad_tpu_torch.structs.types import Evaluation

    enqueued = []
    blocked = BlockedEvals(enqueued.append)
    blocked.set_enabled(True)
    conflict = Evaluation(job_id="a", status="blocked",
                          triggered_by="max-plan-attempts",
                          escaped_computed_class=True)
    no_room = Evaluation(job_id="b", status="blocked",
                         triggered_by="queued-allocs",
                         class_eligibility={"c1": True})
    for ev in (conflict, no_room):
        blocked.block(ev)
    assert blocked.blocked_count() == 2
    blocked.unblock_failed()
    assert [(e.id, e.status) for e in enqueued] == [(conflict.id, "pending")]
    assert blocked.blocked_count() == 1
    blocked.unblock_failed()
    assert len(enqueued) == 1
