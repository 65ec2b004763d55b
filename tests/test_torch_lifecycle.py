"""The port's job lifecycle on the CPU, against the JAX package's.

Each server script runs on the JAX ``Server`` (``JAX_PLATFORMS=cpu``, SLO
and overload control off) and on the port's ``Server(device="cpu")``, and
the tests compare end states — deployment statuses, live allocs by job
version, child-job counts, validation errors, scaling events, the sets of
GC'd objects, plan annotations — never ids or timestamps.  The tests play
the client: ``update_allocs_from_client`` with copies of the allocs
reporting ``running`` (and, under a deployment, a health verdict).

* the failed-eval reaper (ROADMAP queue 3, R6): an eval past its delivery
  limit ends ``failed`` with a delayed follow-up, and the job's next eval
  runs (port-only broker script, and a server script in both packages);
* ``CronExpr.next_after`` on seeded specs and bases (exact);
* deployments: a multi-batch rolling update, canary auto-promote,
  auto-revert of a failing update, pause and resume;
* periodic interval children and ``prohibit_overlap``, ``dispatch_job``
  validation and a dispatched child, ``scale_job`` bounds and events,
  ``plan_job`` annotations with nothing committed;
* ``system_gc``: a dead job's evals and allocs and a down empty node are
  reaped; a node registered into the GC-freed matrix row is placed on,
  and the freed row is never placed on before that.

Every wait is on a predicate with its own deadline.
"""

import collections
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.scheduler import generic as jgeneric
from nomad_tpu.server.periodic import CronExpr as JCronExpr
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.structs import types as jtypes
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.scheduler import generic as tgeneric
from nomad_tpu_torch.server.periodic import CronExpr as TCronExpr
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import types as ttypes

# One intra-op thread: these tests share the host's cores with the
# other test workers, whose timing tests a thread pool would starve.
torch.set_num_threads(1)

WAIT = 45.0  # seconds any one condition may take

JAX = (JServer, JServerConfig, jmock, jtypes, jgeneric)
PORT = (Server, ServerConfig, tmock, ttypes, tgeneric)


def make_server(pkg, **kw):
    server_cls, config_cls = pkg[0], pkg[1]
    kw.setdefault("num_workers", 2)
    kw.setdefault("node_capacity", 32)
    kw.setdefault("heartbeat_min_ttl", 3600.0)
    kw.setdefault("heartbeat_max_ttl", 7200.0)
    if pkg is JAX:
        return server_cls(config_cls(slo_enabled=False,
                                     overload_enabled=False, **kw))
    return server_cls(config_cls(**kw), device="cpu")


def wait_until(pred, what, timeout=WAIT):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.02)


def settle(srv, timeout=WAIT):
    """No eval queued, pending, delayed or in flight, and every stored
    eval terminal or blocked, three polls in a row."""
    broker = srv.eval_broker
    deadline = time.time() + timeout
    quiet = 0
    while quiet < 3:
        if time.time() > deadline:
            raise AssertionError(f"server did not settle in {timeout} s")
        busy = (broker.ready_count() + broker.unacked_count()
                + broker.pending_count() + broker.delayed_count())
        open_evals = [e for e in list(srv.store.evals.values())
                      if not e.terminal_status() and e.status != "blocked"]
        quiet = quiet + 1 if not busy and not open_evals else 0
        time.sleep(0.03)


def play_client(srv, types, healthy=lambda a: True, status="running"):
    """Report each alloc the scheduler wants running that the client has
    not reported yet (or, under a deployment, not judged yet) with
    ``status`` and, under a deployment, the ``healthy`` verdict."""
    updates = []
    for a in list(srv.store.allocs.values()):
        if a.desired_status != "run" or a.terminal_status():
            continue
        unjudged = a.deployment_id and (
            a.deployment_status is None or a.deployment_status.healthy is None)
        if a.client_status != "pending" and not unjudged:
            continue
        upd = a.copy()
        upd.client_status = status
        if a.deployment_id:
            prev = a.deployment_status
            upd.deployment_status = types.AllocDeploymentStatus(
                healthy=healthy(a), timestamp=time.time(),
                canary=prev.canary if prev is not None else False)
        updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)
    return len(updates)


def drive(srv, types, pred, what, healthy=lambda a: True, timeout=WAIT,
          check=None):
    """Play the client until ``pred()``; ``check()`` runs every round."""
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        play_client(srv, types, healthy)
        if check is not None:
            check()
        time.sleep(0.05)


def live(srv, job_id):
    return [a for a in list(srv.store.allocs.values())
            if a.job_id == job_id and not a.terminal_status()]


def small_job(mock, job_id, count, job_type="service"):
    job = mock.job()
    job.id = job.name = job_id
    job.type = job_type
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 64
    return job


def register_nodes(srv, mock, n, first=0):
    nodes = []
    for i in range(first, first + n):
        node = mock.node()
        node.id = node.name = f"node-{i:02d}"
        srv.register_node(node)
        nodes.append(node)
    return nodes


def run(pkg, script, **cfg):
    srv = make_server(pkg, **cfg)
    srv.start()
    try:
        return script(srv, pkg)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# R6: the failed-eval reaper
# ---------------------------------------------------------------------------


def test_eval_past_its_delivery_limit_is_reaped_and_the_job_goes_on():
    """The broker script of the fault: an eval nacked past the delivery
    limit keeps its job's token in the failed queue, so the job's next
    eval parks in pending.  The reaper marks it failed, cuts a delayed
    follow-up, and the follow-up's ack hands the job to the next eval."""
    srv = Server(ServerConfig(num_workers=0, eval_delivery_limit=1,
                              failed_eval_unblock_delay=0.2), device="cpu")
    srv.start()
    try:
        broker = srv.eval_broker

        def job_eval():
            return ttypes.Evaluation(
                namespace="default", priority=50, type="service",
                triggered_by="job-register", job_id="stuck",
                status="pending")

        e1, e2 = job_eval(), job_eval()
        srv.apply_eval_updates([e1])
        ev, token = broker.dequeue(["service"], timeout=2.0)
        assert ev.id == e1.id
        broker.nack(e1.id, token)
        srv.apply_eval_updates([e2])
        assert broker.dequeue(["service"], timeout=0.1) == (None, "")
        assert broker.pending_count() == 1

        wait_until(lambda: srv.store.eval_by_id(e1.id).status == "failed",
                   "the reaper to fail e1")
        failed = srv.store.eval_by_id(e1.id)
        assert failed.status_description == "maximum attempts reached (1)"
        follow = [e for e in srv.store.evals.values()
                  if e.triggered_by == ttypes.EvalTrigger.FAILED_FOLLOW_UP.value]
        assert len(follow) == 1 and follow[0].job_id == "stuck"
        assert follow[0].wait_until > 0

        ev, token = broker.dequeue(["service"], timeout=5.0)
        assert ev is not None and ev.id == follow[0].id
        broker.ack(ev.id, token)
        ev, token = broker.dequeue(["service"], timeout=5.0)
        assert ev is not None and ev.id == e2.id
        broker.ack(ev.id, token)
        assert broker.pending_count() == 0
    finally:
        srv.shutdown()


def r6_script(srv, pkg):
    mock, types, generic = pkg[2], pkg[3], pkg[4]
    register_nodes(srv, mock, 4)
    real = generic.GenericScheduler.process
    raised = []

    def raise_once(self, ev):
        if not raised:
            raised.append(ev.id)
            raise RuntimeError("scheduler fault")
        return real(self, ev)

    generic.GenericScheduler.process = raise_once
    try:
        job = small_job(mock, "flaky", 2)
        e1 = srv.submit_job(job)
        wait_until(lambda: srv.eval_broker.stats["total_failed_deliveries"] == 1,
                   "the first delivery to fail")
        again = small_job(mock, "flaky", 3)
        e2 = srv.submit_job(again)
        wait_until(lambda: srv.store.eval_by_id(e1.id).status == "failed",
                   "the reaper to fail the first eval")
        settle(srv)
    finally:
        generic.GenericScheduler.process = real
    follow = [e for e in srv.store.evals.values()
              if e.triggered_by == types.EvalTrigger.FAILED_FOLLOW_UP.value]
    return dict(
        raised=raised == [e1.id],
        first=(srv.store.eval_by_id(e1.id).status,
               srv.store.eval_by_id(e1.id).status_description),
        follow=[(e.job_id, e.status, e.wait_until > 0) for e in follow],
        second=srv.store.eval_by_id(e2.id).status,
        pending=[e.triggered_by for e in srv.store.evals.values()
                 if e.status == "pending"],
        allocs=len(live(srv, "flaky")),
    )


R6_CFG = dict(num_workers=1, eval_delivery_limit=1,
              failed_eval_unblock_delay=0.3)


@pytest.fixture(scope="module")
def r6_runs():
    return run(JAX, r6_script, **R6_CFG), run(PORT, r6_script, **R6_CFG)


def test_failed_eval_gets_a_follow_up_and_the_job_places(r6_runs):
    _, port = r6_runs
    assert port["raised"]
    assert port["first"] == ("failed", "maximum attempts reached (1)")
    assert port["follow"] == [("flaky", "complete", True)]
    assert port["second"] == "complete"
    assert port["pending"] == []  # no stored eval left pending
    assert port["allocs"] == 3


def test_failed_eval_end_state_matches_reference(r6_runs):
    ref, port = r6_runs
    assert port == ref


# ---------------------------------------------------------------------------
# CronExpr
# ---------------------------------------------------------------------------


def cron_specs(rng, n):
    """Seeded 5-field specs (steps, ranges, lists, day-of-week and
    day-of-month mixes) that match at least once a month, and the
    shorthands."""
    def field(lo, hi, star_p):
        r = rng.random()
        if r < star_p:
            return "*"
        if r < star_p + 0.2:
            return f"*/{int(rng.integers(2, max(3, (hi - lo) // 2)))}"
        if r < star_p + 0.4:
            a = int(rng.integers(lo, hi))
            return f"{a}-{int(rng.integers(a, hi + 1))}"
        if r < star_p + 0.6:
            vals = sorted({int(v) for v in rng.integers(lo, hi + 1, 3)})
            return ",".join(map(str, vals))
        return str(int(rng.integers(lo, hi + 1)))

    specs = ["@hourly", "@daily", "@weekly", "@monthly", "@midnight",
             "@minutely", "0 0 * * 0", "15 10 1,15 * 1-5"]
    while len(specs) < n:
        specs.append(" ".join([
            field(0, 59, 0.2), field(0, 23, 0.3), field(1, 28, 0.6),
            "*" if rng.random() < 0.8 else field(1, 12, 0.0),
            field(0, 6, 0.6),
        ]))
    return specs


def test_cron_next_after_matches_reference():
    rng = np.random.default_rng(11)
    specs = cron_specs(rng, 48)
    bases = rng.uniform(1.58e9, 1.9e9, len(specs))
    for spec, base in zip(specs, bases):
        want = JCronExpr(spec).next_after(float(base))
        got = TCronExpr(spec).next_after(float(base))
        assert got == want, (spec, base)
        assert got > base
    for bad in ("* * *", "x * * * *", "1 2 3 4 5 6"):
        with pytest.raises(ValueError):
            JCronExpr(bad)
        with pytest.raises(ValueError):
            TCronExpr(bad)


# ---------------------------------------------------------------------------
# Deployments
# ---------------------------------------------------------------------------


def update_stanza(types, **kw):
    kw.setdefault("max_parallel", 1)
    kw.setdefault("min_healthy_time", 0.1)
    kw.setdefault("healthy_deadline", 20.0)
    kw.setdefault("progress_deadline", 60.0)
    return types.UpdateStrategy(**kw)


def deployment_of(srv, job_id, version):
    for d in list(srv.store.deployments.values()):
        if d.job_id == job_id and d.job_version == version:
            return d
    return None


def deployment_done(srv, job_id, version, status="successful"):
    d = deployment_of(srv, job_id, version)
    return d is not None and d.status == status


def new_version(job, env):
    job2 = job.copy()
    job2.task_groups[0].tasks[0].env = dict(env)
    return job2


def deployments_script(srv, pkg):
    mock, types = pkg[2], pkg[3]
    register_nodes(srv, mock, 8)
    out = {}

    # Rolling: 8 allocs, two at a time.
    web = small_job(mock, "web", 8)
    web.task_groups[0].update = update_stanza(types, max_parallel=2)
    srv.submit_job(web)
    drive(srv, types, lambda: deployment_done(srv, "web", 0), "web v0")
    srv.submit_job(new_version(web, {"V": "2"}))
    unhealthy_max = []

    def in_flight():
        unjudged = [a for a in live(srv, "web") if a.job.version == 1 and (
            a.deployment_status is None or a.deployment_status.healthy is None)]
        unhealthy_max.append(len(unjudged))

    drive(srv, types, lambda: deployment_done(srv, "web", 1), "web v1",
          check=in_flight)
    dep = deployment_of(srv, "web", 1)
    out["web_batches"] = sum(
        1 for e in list(srv.store.evals.values())
        if e.job_id == "web" and e.deployment_id == dep.id
        and e.triggered_by == "deployment-watcher")
    out["web_in_flight_max"] = max(unhealthy_max)

    # Canary with auto-promote.  The first version has no canary: a first
    # version's deployment with canaries never completes in either package
    # (ROADMAP queue 3, R7).
    api = small_job(mock, "api", 3)
    api.task_groups[0].update = update_stanza(types)
    srv.submit_job(api)
    drive(srv, types, lambda: deployment_done(srv, "api", 0), "api v0")
    api1 = new_version(api, {"V": "2"})
    api1.task_groups[0].update = update_stanza(types, canary=1,
                                               auto_promote=True)
    srv.submit_job(api1)
    settle(srv)
    out["api_canaries_before_promotion"] = sorted(
        (a.job.version, bool(a.deployment_status and a.deployment_status.canary))
        for a in live(srv, "api"))
    drive(srv, types, lambda: deployment_done(srv, "api", 1), "api v1")
    dep = deployment_of(srv, "api", 1)
    out["api_promoted"] = [s.promoted for s in dep.task_groups.values()]

    # A failing update with auto-revert.
    rev = small_job(mock, "rev", 2)
    rev.task_groups[0].update = update_stanza(types, auto_revert=True,
                                              progress_deadline=600.0)
    srv.submit_job(rev)
    drive(srv, types, lambda: deployment_done(srv, "rev", 0), "rev v0")
    srv.submit_job(new_version(rev, {"BAD": "1"}))
    healthy = lambda a: not a.job.task_groups[0].tasks[0].env.get("BAD")

    def reverted():
        allocs = live(srv, "rev")
        return (srv.store.job_by_id("default", "rev").version == 2
                and len(allocs) == 2
                and all(a.job.version == 2 and a.client_status == "running"
                        for a in allocs))

    # The revert's own deployment stays running: the v0 alloc that the
    # failed rollout left is updated in place and not counted (R7).
    drive(srv, types, reverted, "rev revert", healthy=healthy)
    settle(srv)

    # Pause and resume.
    slow = small_job(mock, "slow", 4)
    slow.task_groups[0].update = update_stanza(types)
    srv.submit_job(slow)
    drive(srv, types, lambda: deployment_done(srv, "slow", 0), "slow v0")
    srv.submit_job(new_version(slow, {"V": "2"}))
    settle(srv)
    dep = deployment_of(srv, "slow", 1)
    srv.pause_deployment(dep.id, True)
    play_client(srv, types)
    time.sleep(1.0)  # four watcher polls: a running deployment would move
    settle(srv)
    out["slow_while_paused"] = (
        deployment_of(srv, "slow", 1).status,
        sorted(a.job.version for a in live(srv, "slow")))
    srv.pause_deployment(dep.id, False)
    drive(srv, types, lambda: deployment_done(srv, "slow", 1), "slow v1")
    settle(srv)

    out["deployments"] = sorted(
        (d.job_id, d.job_version, d.status, d.status_description)
        for d in srv.store.deployments.values())
    out["live"] = sorted(collections.Counter(
        (a.job_id, a.job.version) for a in list(srv.store.allocs.values())
        if not a.terminal_status()).items())
    out["versions"] = sorted((j.id, j.version) for j in srv.store.all_jobs())
    return out


@pytest.fixture(scope="module")
def deployment_runs():
    return run(JAX, deployments_script), run(PORT, deployments_script)


def test_rolling_update_goes_through_every_batch(deployment_runs):
    _, port = deployment_runs
    assert port["web_batches"] >= 3  # batches 2-4 of four
    assert port["web_in_flight_max"] <= 2  # max_parallel
    assert ("web", 1, "successful", "Deployment completed successfully") \
        in port["deployments"]
    assert ("web", 1) in dict(port["live"]) and dict(port["live"])[("web", 1)] == 8


def test_canary_is_placed_first_then_promoted(deployment_runs):
    _, port = deployment_runs
    assert port["api_canaries_before_promotion"] == [(0, False), (0, False),
                                                     (0, False), (1, True)]
    assert port["api_promoted"] == [True]
    assert dict(port["live"])[("api", 1)] == 3


def test_failing_update_auto_reverts(deployment_runs):
    _, port = deployment_runs
    deps = {(d[0], d[1]): d[2:] for d in port["deployments"]}
    assert deps[("rev", 1)] == ("failed", "Failed due to unhealthy allocations")
    assert deps[("rev", 2)][0] == "running"
    assert dict(port["live"])[("rev", 2)] == 2
    assert ("rev", 2) in port["versions"]


def test_paused_deployment_holds_until_resumed(deployment_runs):
    _, port = deployment_runs
    assert port["slow_while_paused"] == ("paused", [0, 0, 0, 1])
    assert dict(port["live"])[("slow", 1)] == 4


def test_deployment_end_states_match_reference(deployment_runs):
    ref, port = deployment_runs
    for key in ("deployments", "live", "versions", "api_promoted",
                "api_canaries_before_promotion", "slow_while_paused"):
        assert port[key] == ref[key], key
    assert ref["web_batches"] >= 3 and ref["web_in_flight_max"] <= 2


# ---------------------------------------------------------------------------
# Periodic, dispatch, scale and plan
# ---------------------------------------------------------------------------


def children_of(srv, job_id, kind):
    prefix = f"{job_id}/{kind}-"
    return sorted(jid for (_, jid) in list(srv.store.jobs)
                  if jid.startswith(prefix))


def error_of(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def jobs_script(srv, pkg):
    mock, types = pkg[2], pkg[3]
    register_nodes(srv, mock, 6)
    out = {}

    # An interval periodic batch job: two children or more, each placed.
    cron = small_job(mock, "cron", 1, "batch")
    cron.periodic = types.PeriodicConfig(spec="0.5", spec_type="interval")
    out["periodic_submit"] = srv.submit_job(cron)
    drive(srv, types, lambda: len(children_of(srv, "cron", "periodic")) >= 2,
          "two periodic children", timeout=WAIT)
    srv.deregister_job("default", "cron")
    wait_until(lambda: not srv.periodic.tracked(), "the dispatcher to drop cron")
    settle(srv)
    kids = children_of(srv, "cron", "periodic")
    out["periodic_children"] = len(kids) >= 2
    out["periodic_placed"] = all(
        len(srv.store.allocs_by_job("default", jid)) == 1 for jid in kids)
    out["periodic_parent"] = {srv.store.job_by_id("default", j).parent_id
                              for j in kids}

    # prohibit_overlap: the first child keeps running, so no second one.
    lap = small_job(mock, "lap", 1)
    lap.periodic = types.PeriodicConfig(spec="0.3", spec_type="interval",
                                        prohibit_overlap=True)
    srv.submit_job(lap)
    drive(srv, types, lambda: children_of(srv, "lap", "periodic"),
          "the first overlap child")
    settle(srv)
    play_client(srv, types)
    time.sleep(1.2)  # four intervals
    out["overlap_children"] = len(children_of(srv, "lap", "periodic"))
    srv.deregister_job("default", "lap")
    settle(srv)

    # Dispatch: validation, then one child with meta and a payload.
    param = small_job(mock, "param", 1, "batch")
    param.parameterized = {"meta_required": ["k"], "meta_optional": ["o"],
                           "payload": "optional"}
    out["param_submit"] = srv.submit_job(param)
    nopay = small_job(mock, "nopay", 1, "batch")
    nopay.parameterized = {"payload": "forbidden"}
    srv.submit_job(nopay)
    needpay = small_job(mock, "needpay", 1, "batch")
    needpay.parameterized = {"payload": "required"}
    srv.submit_job(needpay)
    plain = small_job(mock, "plain", 1)
    srv.submit_job(plain)
    settle(srv)
    d = srv.dispatch_job
    out["dispatch_errors"] = [
        error_of(lambda: d("default", "missing", meta={"k": "v"})),
        error_of(lambda: d("default", "plain")),
        error_of(lambda: d("default", "param")),
        error_of(lambda: d("default", "param", meta={"k": "v", "z": "1"})),
        error_of(lambda: d("default", "nopay", payload=b"x")),
        error_of(lambda: d("default", "needpay")),
        error_of(lambda: d("default", "param", meta={"k": "v"},
                           payload=b"x" * (16 * 1024 + 1))),
    ]
    child, ev = d("default", "param", payload=b"hello", meta={"k": "v"})
    settle(srv)
    out["dispatched"] = (
        child.id.startswith("param/dispatch-"), child.parent_id,
        child.meta.get("k"), child.payload, child.parameterized,
        srv.store.eval_by_id(ev.id).status,
        len(srv.store.allocs_by_job("default", child.id)))
    srv.deregister_job("default", "plain")
    settle(srv)

    # Scale within the group's policy.
    sc = small_job(mock, "scaled", 2)
    sc.task_groups[0].scaling = types.ScalingPolicy(min=1, max=5)
    srv.submit_job(sc)
    settle(srv)
    s = srv.scale_job
    out["scale_errors"] = [
        error_of(lambda: s("default", "scaled", "web", 6)),
        error_of(lambda: s("default", "scaled", "web", 0)),
        error_of(lambda: s("default", "scaled", "web", -1)),
        error_of(lambda: s("default", "scaled", "web", 3, error=True)),
        error_of(lambda: s("default", "scaled", "nope", 3)),
        error_of(lambda: s("default", "missing", "web", 3)),
    ]
    counts = []
    for count in (4, 2):
        s("default", "scaled", "web", count, message=f"to {count}")
        settle(srv)
        counts.append(len(live(srv, "scaled")))
    s("default", "scaled", "", None, message="note", error=True)
    out["scale_counts"] = counts
    out["scale_events"] = [
        (e.count, e.previous_count, e.message, e.error, bool(e.eval_id))
        for e in srv.store.scaling_events[("default", "scaled", "web")]]

    # plan_job: annotations, nothing committed.
    before = (len(srv.store.evals), len(srv.store.allocs),
              srv.store.latest_index)
    planned = small_job(mock, "planned", 3)
    p1 = srv.plan_job(planned)
    committed = (len(srv.store.evals), len(srv.store.allocs),
                 srv.store.job_by_id("default", "planned"))
    srv.submit_job(small_job(mock, "planned", 3))
    settle(srv)
    bigger = new_version(small_job(mock, "planned", 5), {"V": "2"})
    p2 = srv.plan_job(bigger, diff=True)
    huge = small_job(mock, "huge", 2)
    huge.task_groups[0].tasks[0].resources.cpu = 100000
    p3 = srv.plan_job(huge)
    out["plan"] = [(p["Annotations"], p["CreatedEvals"],
                    sorted(p["FailedTGAllocs"])) for p in (p1, p2, p3)]
    out["plan_diff"] = p2["Diff"]
    out["plan_committed_nothing"] = (
        committed[:2] == before[:2] and committed[2] is None)
    out["plan_failed_metrics"] = {
        tg: (m["nodes_evaluated"], m["nodes_exhausted"])
        for tg, m in p3["FailedTGAllocs"].items()}
    settle(srv)
    return out


@pytest.fixture(scope="module")
def jobs_runs():
    return run(JAX, jobs_script), run(PORT, jobs_script)


def test_periodic_children_launch_and_stop(jobs_runs):
    _, port = jobs_runs
    assert port["periodic_submit"] is None
    assert port["periodic_children"] and port["periodic_placed"]
    assert port["periodic_parent"] == {"cron"}
    assert port["overlap_children"] == 1


def test_dispatch_validates_and_launches(jobs_runs):
    _, port = jobs_runs
    assert port["param_submit"] is None
    assert port["dispatch_errors"] == [
        "job not found", "job is not parameterized",
        "missing required meta: ['k']", "unpermitted meta: ['z']",
        "payload forbidden by parameterized block",
        "payload required by parameterized block",
        "payload exceeds 16 KiB limit",
    ]
    assert port["dispatched"] == (True, "param", "v", "aGVsbG8=", None,
                                  "complete", 1)


def test_scale_keeps_to_the_policy(jobs_runs):
    _, port = jobs_runs
    assert port["scale_errors"][:3] == [
        "count 6 outside policy bounds [1, 5]",
        "count 0 outside policy bounds [1, 5]",
        "count cannot be negative",
    ]
    assert all(port["scale_errors"])
    assert port["scale_counts"] == [4, 2]
    assert port["scale_events"] == [(4, 2, "to 4", False, True),
                                    (2, 4, "to 2", False, True),
                                    (None, 2, "note", True, False)]


def test_plan_job_annotates_without_committing(jobs_runs):
    _, port = jobs_runs
    assert port["plan_committed_nothing"]
    new, bigger, huge = port["plan"]
    assert new[0]["DesiredTGUpdates"]["web"]["place"] == 3
    assert bigger[0]["DesiredTGUpdates"]["web"]
    assert port["plan_diff"]["Type"] == "Edited"
    assert huge[2] == ["web"]


def test_job_rpc_end_states_match_reference(jobs_runs):
    ref, port = jobs_runs
    assert port == ref


# ---------------------------------------------------------------------------
# Core GC
# ---------------------------------------------------------------------------


def gc_script(srv, pkg):
    mock, types = pkg[2], pkg[3]
    nodes = register_nodes(srv, mock, 5)
    out = {}
    done = small_job(mock, "done", 2, "batch")
    done.constraints = [types.Constraint(
        l_target="${node.unique.id}", operand="!=", r_target="node-04")]
    srv.submit_job(done)
    keep = small_job(mock, "keep", 2)
    keep.constraints = list(done.constraints)
    srv.submit_job(keep)
    settle(srv)
    play_client(srv, types)
    for a in list(srv.store.allocs_by_job("default", "done")):
        upd = a.copy()
        upd.client_status = "complete"
        srv.update_allocs_from_client([upd])
    srv.deregister_job("default", "done")
    settle(srv)
    srv.update_node_status("node-04", types.NodeStatus.DOWN.value)
    settle(srv)
    freed_row = srv.matrix.row_of["node-04"]

    jobs0 = set(j.id for j in srv.store.all_jobs())
    allocs0 = {a.id: (a.job_id, a.name) for a in srv.store.allocs.values()}
    evals0 = {e.id: (e.job_id, e.triggered_by)
              for e in srv.store.evals.values()}
    nodes0 = set(srv.store.nodes)
    srv.system_gc()
    wait_until(lambda: any(e.type == "_core" and e.status == "complete"
                           for e in list(srv.store.evals.values())),
               "the force-gc eval")
    settle(srv)
    out["gc_jobs"] = sorted(jobs0 - {j.id for j in srv.store.all_jobs()})
    out["gc_allocs"] = sorted(v for k, v in allocs0.items()
                              if k not in srv.store.allocs)
    out["gc_evals"] = sorted(v for k, v in evals0.items()
                             if k not in srv.store.evals)
    out["gc_nodes"] = sorted(nodes0 - set(srv.store.nodes))
    out["kept"] = len(live(srv, "keep"))

    # The freed row is never placed on: five distinct hosts, four nodes.
    wide = small_job(mock, "wide", 5)
    wide.task_groups[0].constraints = [types.Constraint(
        operand="distinct_hosts")]
    srv.submit_job(wide)
    settle(srv)
    out["wide_before"] = sorted(a.node_id for a in live(srv, "wide"))
    # A node registered into the freed row takes the fifth alloc.
    new = mock.node()
    new.id = new.name = "node-05"
    srv.register_node(new)
    out["reused_row"] = srv.matrix.row_of["node-05"] == freed_row
    settle(srv)
    out["wide_after"] = sorted(a.node_id for a in live(srv, "wide"))
    pinned = small_job(mock, "pinned", 1)
    pinned.constraints = [types.Constraint(
        l_target="${node.unique.id}", operand="=", r_target="node-05")]
    srv.submit_job(pinned)
    settle(srv)
    out["pinned"] = sorted(a.node_id for a in live(srv, "pinned"))
    out["known_nodes"] = all(srv.store.node_by_id(a.node_id) is not None
                             for a in list(srv.store.allocs.values()))
    arrays = srv.matrix.sync()
    host = srv.matrix.snapshot_host()
    out["row_synced"] = bool(
        np.array_equal(np.asarray(arrays.totals[freed_row]),
                       host["totals"][freed_row])
        and bool(arrays.eligible[freed_row]))
    return out


@pytest.fixture(scope="module")
def gc_runs():
    return run(JAX, gc_script), run(PORT, gc_script)


def test_force_gc_reaps_dead_job_and_down_empty_node(gc_runs):
    _, port = gc_runs
    assert port["gc_jobs"] == ["done"]
    assert port["gc_allocs"] == [("done", "done.web[0]"),
                                 ("done", "done.web[1]")]
    assert {job for job, _ in port["gc_evals"]} == {"done"}
    assert port["gc_nodes"] == ["node-04"]
    assert port["kept"] == 2


def test_node_in_a_gc_freed_row_is_placed_on(gc_runs):
    _, port = gc_runs
    assert port["reused_row"]
    assert port["wide_before"] == ["node-00", "node-01", "node-02", "node-03"]
    assert port["wide_after"] == ["node-00", "node-01", "node-02", "node-03",
                                  "node-05"]
    assert port["pinned"] == ["node-05"]
    assert port["known_nodes"] and port["row_synced"]


def test_gc_end_states_match_reference(gc_runs):
    ref, port = gc_runs
    assert port == ref
