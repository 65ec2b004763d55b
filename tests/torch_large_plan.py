"""One system plan over every node of a replicated cluster, in either package.

A system job on every node of a three-member cluster commits as one plan:
one ``upsert_plan_results`` entry that holds an alloc for each node.  The
leader ships it to its peers and waits ``Replicator.append_timeout`` (1.5
s) for each ack; the follower applies the entry before it answers, and its
apply grows with the number of allocs.  With one member down, as after a
failover, the leader's one live peer decides every write, and a plan whose
apply outlasts the window costs the leader its quorum: the write raises
and the leader steps down.  The follower, which did apply the entry, can
then lead and complete the eval.

``large_system_plan`` drives that path in one package and returns its
outcome; ``tests/test_torch_replication_cluster.py`` holds the port's to
the reference's with the follower's apply held past the window.  Run as
a script, it measures where such a plan's time goes in either package,
with nothing held and the members electing on phase 17's timers, at a
width of its choice::

    PYTHONPATH=. python tests/torch_large_plan.py 10009 port jax

It prints one JSON line a package: the outcome, the seconds (from the
submit) at which the plan was enqueued and verified, each replicated
write of the plan on a leader (seconds, result, the entry's bytes) and
each apply of it on a follower, every step-down with its reason, and
the seconds until one leader first held the job on every node once and
the eval terminal, with both live images equal.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from test_torch_replication import JAX, PORT, WAIT, seeded_node  # noqa: E402
from torch_parity import elect, free_ports, wait_until  # noqa: E402

torch.set_num_threads(1)

N_NODES = 40
PLAN_OP = "upsert_plan_results"
# The test's raft timers: no member campaigns on its own within a test, and
# the test chooses each leader (``elect``); the script takes phase 17's on
# the card and lets the members elect.
QUIET_TIMERS = ((60.0, 90.0), 0.25)
SMOKE_TIMERS = ((1.0, 2.0), 0.1)
# The hold of the follower's apply past the leader's append window.
HOLD_PAST_WINDOW_S = 1.5


def package(pkg):
    if pkg == JAX:
        from nomad_tpu import mock
        from nomad_tpu.api.agent import Agent, AgentConfig
        from nomad_tpu.server.server import ServerConfig
        from nomad_tpu.state.matrix import NodeMatrix
        from nomad_tpu.state.store import StateStore
        return mock, Agent, AgentConfig, ServerConfig, NodeMatrix, StateStore
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.api.agent import Agent, AgentConfig
    from nomad_tpu_torch.server.server import ServerConfig
    from nomad_tpu_torch.state.matrix import NodeMatrix
    from nomad_tpu_torch.state.store import StateStore
    return mock, Agent, AgentConfig, ServerConfig, NodeMatrix, StateStore


def capacity(n_nodes):
    return (n_nodes + 15) // 16 * 16 + 16


def seeded_image(pkg, n_nodes):
    """The image every member starts from: ``n_nodes`` seeded nodes."""
    _, _, _, _, NodeMatrix, StateStore = package(pkg)
    kw = {} if pkg == JAX else {"device": "cpu"}
    store = StateStore(matrix=NodeMatrix(capacity=capacity(n_nodes), **kw))
    rng = np.random.default_rng(5)
    for i in range(n_nodes):
        store.upsert_node(i + 1, seeded_node(pkg, rng, i))
    return store.to_snapshot_wire()


def exporter(pkg):
    job = package(pkg)[0].system_job()
    job.id = job.name = "node-exporter"
    job.datacenters = ["dc1", "dc2"]
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb = 10, 16
    return job


def members(pkg, image, n_nodes, timers):
    _, Agent, AgentConfig, ServerConfig, _, _ = package(pkg)
    ports = free_ports(3)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    agents = []
    for i in range(3):
        sc = ServerConfig(num_workers=1, node_capacity=capacity(n_nodes),
                          heartbeat_min_ttl=3600, heartbeat_max_ttl=7200,
                          server_id=f"server-{i}", peers=list(addrs),
                          raft_enabled=True, election_timeout=timers[0],
                          raft_heartbeat_interval=timers[1],
                          slo_enabled=False, overload_enabled=False)
        cfg = AgentConfig(name=f"server-{i}", server_enabled=True,
                          client_enabled=False, http_host="127.0.0.1",
                          http_port=ports[i], server_config=sc)
        a = Agent(cfg) if pkg == JAX else Agent(cfg, device="cpu")
        a.server.store.restore(image, [])
        agents.append(a)
    return agents


def leader_of(agents):
    leads = [a for a in agents
             if a.server.replicator.is_leader and a.server._leader]
    return leads[0] if len(leads) == 1 else None


def traced(agents, t0, log, hold_s=None):
    """Record the plan's path on every member: each replicated write of
    the plan on a leader, each apply of it on a follower (the first one
    held ``hold_s`` seconds when given), the plan's enqueue and
    verification, and every step-down with its reason."""
    held = []

    def clock():
        return time.perf_counter() - t0[0]

    for a in agents:
        name, srv = a.config.name, a.server
        rep, store = srv.replicator, srv.store

        def replicate(entry, orig=rep.replicate, name=name):
            if entry["op"] != PLAN_OP:
                return orig(entry)
            start = clock()
            try:
                orig(entry)
                ok = True
                return None
            except Exception as exc:  # noqa: BLE001 — recorded, re-raised
                ok = type(exc).__name__
                raise
            finally:
                log["replicate"].append({
                    "member": name, "at_s": start, "s": clock() - start,
                    "ok": ok, "bytes": len(json.dumps(entry))})

        def apply_remote(entry, orig=store.apply_remote, name=name):
            if entry["op"] != PLAN_OP:
                return orig(entry)
            start = clock()
            if hold_s is not None and not held:
                held.append(name)
                time.sleep(hold_s)
            orig(entry)
            log["follower_apply"].append(
                {"member": name, "at_s": start, "s": clock() - start})
            return None

        def enqueue(plan, orig=srv.plan_queue.enqueue, name=name):
            log["plan_enqueued"].append({"member": name, "at_s": clock()})
            return orig(plan)

        def evaluate(plan, orig=srv.plan_applier._evaluate, name=name):
            start = clock()
            out = orig(plan)
            log["plan_evaluate"].append(
                {"member": name, "at_s": start, "s": clock() - start})
            return out

        def step_down(term, reason, orig=rep._step_down, name=name):
            log["step_downs"].append(
                {"member": name, "reason": reason, "at_s": clock()})
            return orig(term, reason)

        rep.replicate = replicate
        store.apply_remote = apply_remote
        srv.plan_queue.enqueue = enqueue
        srv.plan_applier._evaluate = evaluate
        rep._step_down = step_down


def large_system_plan(pkg, n_nodes=N_NODES, hold=False, settle_s=WAIT,
                      chosen=True, timeout=WAIT):
    """A system job on every one of ``n_nodes`` nodes, through a cluster
    whose leader has one live peer (with ``hold``, the follower's first
    apply of the plan waits the leader's append window and
    HOLD_PAST_WINDOW_S more).  With ``chosen``, member 0 is elected
    first and the follower once the issuer has stepped down; else the
    members elect on phase 17's timers.  Waits for the plan's first
    replicated write, the issuer's step-down if it steps down, and then
    up to ``settle_s`` for one leader that holds the job on every node
    once and the eval terminal, with both live images equal, and reads
    the outcome there.
    Returns the outcome and the log of the plan's path (seconds from the
    submit)."""
    image = seeded_image(pkg, n_nodes)
    agents = members(pkg, image, n_nodes,
                     QUIET_TIMERS if chosen else SMOKE_TIMERS)
    t0 = [time.perf_counter()]
    log = {k: [] for k in ("replicate", "follower_apply", "plan_enqueued",
                           "plan_evaluate", "step_downs")}
    try:
        for a in agents:
            a.start()
        if chosen:
            elect(agents[0])
        wait_until(lambda: leader_of(agents) is not None, "one leader",
                   timeout)
        lead = leader_of(agents)
        down = next(a for a in agents if a is not lead)
        down.shutdown()
        live = [a for a in agents if a is not down]
        follower = next(a for a in live if a is not lead)
        wait_until(lambda: lead.server.store.to_snapshot_wire()
                   == follower.server.store.to_snapshot_wire(),
                   "the follower in step", timeout)
        window = lead.server.replicator.append_timeout
        traced(live, t0, log,
               window + HOLD_PAST_WINDOW_S if hold else None)
        job = exporter(pkg)
        t0[0] = time.perf_counter()
        ev = lead.server.submit_job(job)
        wait_until(lambda: log["replicate"], "the plan's first write",
                   timeout)
        first = log["replicate"][0]
        if first["ok"] is not True:
            wait_until(lambda: any(s["member"] == lead.config.name
                                   for s in log["step_downs"]),
                       "the issuer's step-down", timeout)
            if chosen and settle_s:
                elect(follower)

        def placed(now):
            """Nodes holding one live alloc of the job, and more than one,
            in ``now``'s store."""
            per_node = {}
            for alloc in list(now.server.store.allocs.values()):
                if alloc.job_id == job.id and not alloc.terminal_status():
                    per_node[alloc.node_id] = per_node.get(
                        alloc.node_id, 0) + 1
            return (sum(1 for c in per_node.values() if c == 1),
                    sum(1 for c in per_node.values() if c > 1))

        def settled():
            """The one leader, when its store holds the job on every node
            once and the submitted eval terminal, and every live image
            equals its own; else None."""
            now = leader_of(live)
            if now is None or placed(now) != (n_nodes, 0):
                return None
            got = now.server.store.eval_by_id(ev.id)
            if got is None or not got.terminal_status():
                return None
            image = now.server.store.to_snapshot_wire()
            if any(a.server.store.to_snapshot_wire() != image for a in live):
                return None
            return now

        outcome = {
            "plan_acked_first": first["ok"],
            "issuer_lost_replication_quorum": any(
                s["member"] == lead.config.name
                and s["reason"] == "lost replication quorum"
                for s in log["step_downs"]),
            "settled": False,
        }
        deadline = time.perf_counter() + settle_s
        now = settled()
        while now is None and time.perf_counter() < deadline:
            time.sleep(0.05)
            now = settled()
        if now is None:
            log["unsettled_after_s"] = time.perf_counter() - t0[0]
            lead = leader_of(live)
            log["placed_at_end"] = placed(lead) if lead else None
            return outcome, log
        log["settled_s"] = time.perf_counter() - t0[0]
        got = now.server.store.eval_by_id(ev.id)
        outcome.update(
            settled=True,
            leads_after="follower" if now is follower else "issuer",
            eval=got.status if got else None)
        return outcome, log
    finally:
        for a in agents:
            try:
                a.shutdown()
            except Exception:  # noqa: BLE001 — stopped already
                pass


def main(argv):
    n_nodes = int(argv[1])
    for pkg in argv[2:] or (PORT, JAX):
        outcome, log = large_system_plan(pkg, n_nodes, chosen=False,
                                         settle_s=300.0, timeout=600.0)
        print(json.dumps({"package": pkg, "nodes": n_nodes,
                          "outcome": outcome, "log": log}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
