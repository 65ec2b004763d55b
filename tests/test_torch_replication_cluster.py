"""Clusters of port agents on loopback HTTP, against the JAX package's.

Three in-process port agents (``device="cpu"``) elect a leader and
replicate every write; a follower answers a write with the 409
``leader=`` hint (as the reference's); failover loses no committed write
(diskless and with a ``data_dir``); a late follower catches up by
snapshot and by re-send; the raft RPCs' peer check answers as the
reference's; a cluster grows from one server, survives the loss of its
leader and ``remove-peer``; a leader lost while its image transfer to a
joiner hangs is replaced by the member in step, which installs the
joiner itself; ``FailoverRPC`` follows the new leader;
after a failover the new leader places onto the nodes a reference server
restored from the same image picks; and a system plan acknowledged past
the leader's append window costs each package's leader its quorum alike
(``torch_large_plan``).

Every wait is on a condition with its own deadline; the raft timers run
at the test suite's 2.0 scale (``tests/conftest.py``).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nomad_tpu.api.agent import Agent as JAgent
from nomad_tpu.api.agent import AgentConfig as JAgentConfig
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.api.rpc import FailoverRPC
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.server import replication as treplication
from nomad_tpu_torch.server.replication import NotLeaderError
from nomad_tpu_torch.server.server import ServerConfig
from test_torch_replication import (CAPACITY, JAX, PORT, WAIT, seeded_job,
                                    seeded_node)
from torch_large_plan import large_system_plan
from torch_parity import (at_lowest_priority, free_ports, http, mask,
                          settle_agent, wait_until)

torch.set_num_threads(1)

# The reference test suite's cluster timers (tests/test_replication.py),
# widened by NOMAD_TPU_RAFT_TIMEOUT_SCALE.
ELECTION = (0.15, 0.3)
HEARTBEAT = 0.05


def small_job(i=0):
    """The reference cluster tests' job (tests/test_replication.py)."""
    job = tmock.job()
    tg = job.task_groups[0]
    tg.count = 2
    for t in tg.tasks:
        t.resources.cpu = 20 + 5 * (i % 4)
        t.resources.memory_mb = 32
    tg.ephemeral_disk.size_mb = 10
    return job


# ---------------------------------------------------------------------------
# Clusters of in-process agents on loopback HTTP
# ---------------------------------------------------------------------------


def agent(pkg, i, port, peers, data_dir=None, raft=False, workers=2,
          client=False, client_dir=None, **server_kw):
    sc_cls, ac_cls = ((JServerConfig, JAgentConfig) if pkg == JAX
                      else (ServerConfig, AgentConfig))
    sc = sc_cls(num_workers=workers, node_capacity=CAPACITY,
                heartbeat_min_ttl=60, heartbeat_max_ttl=90,
                server_id=f"server-{i}", peers=list(peers),
                raft_enabled=raft, election_timeout=ELECTION,
                raft_heartbeat_interval=HEARTBEAT,
                data_dir=str(data_dir) if data_dir else None,
                slo_enabled=False, overload_enabled=False, **server_kw)
    cfg = ac_cls(name=f"server-{i}", server_enabled=True,
                 client_enabled=client, http_host="127.0.0.1",
                 http_port=port, server_config=sc)
    if client:
        cfg.client_config.data_dir = str(client_dir)
    return JAgent(cfg) if pkg == JAX else Agent(cfg, device="cpu")


def leader_of(agents):
    """The one agent that leads with its leader services up: the role
    flips first and ``establish_leadership`` follows on its own."""
    leaders = [a for a in agents if a.server.replicator is not None
               and a.server.replicator.is_leader and a.server._leader]
    return leaders[0] if len(leaders) == 1 else None


def wait_leader(agents, timeout=WAIT):
    wait_until(lambda: leader_of(agents) is not None, "one leader", timeout)
    return leader_of(agents)


def shutdown_all(agents):
    for a in agents:
        try:
            a.shutdown()
        except Exception:  # noqa: BLE001 — already stopped
            pass


def start_cluster(pkg, n=3, data_root=None, **kw):
    ports = free_ports(n)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    agents = [agent(pkg, i, ports[i], addrs,
                    data_dir=(data_root / f"s{i}") if data_root else None,
                    **kw)
              for i in range(n)]
    for a in agents:
        a.start()
    return agents, addrs


@pytest.fixture
def cluster():
    agents, addrs = start_cluster(PORT)
    try:
        wait_leader(agents)
        yield agents, addrs
    finally:
        shutdown_all(agents)


def settled_leader(agents):
    """The one leader, once every other server follows it with its leader
    services off (a follower whose timer ran out before the leader's
    first heartbeat campaigns, and one that led an earlier term revokes
    its services on a thread of its own); else None."""
    leader = leader_of(agents)
    if leader is None:
        return None
    for f in (a for a in agents if a is not leader):
        rep = f.server.replicator
        if (rep.role != "follower" or rep.leader_addr != leader.rpc_addr
                or f.server.eval_broker.enabled):
            return None
    return leader


def test_single_leader_elected(cluster):
    agents, _ = cluster
    wait_until(lambda: settled_leader(agents) is not None,
               "one leader that every other server follows")
    leader = settled_leader(agents)
    # Followers launch nothing.
    for f in (a for a in agents if a is not leader):
        assert f.server.coalescer.dispatches == 0


def test_writes_replicate_to_followers(cluster):
    agents, _ = cluster
    leader = leader_of(agents)
    for i in range(4):
        leader.server.register_node(tmock.node())
    job = small_job()
    ev = leader.server.submit_job(job)
    assert leader.server.wait_for_eval(ev.id, WAIT).status == "complete"
    for a in agents:
        wait_until(lambda a=a: a.server.store.job_by_id(
            job.namespace, job.id) is not None
            and a.server.store.eval_by_id(ev.id) is not None
            and len(a.server.store.allocs) == 2, "the write on every server")
    wait_until(lambda: len({json.dumps(a.server.store.to_snapshot_wire(),
                                       sort_keys=True) for a in agents}) == 1,
               "equal images")


def follower_write_answers(pkg):
    """What a write to each follower answers, once it knows the leader."""
    agents, _ = start_cluster(pkg)
    try:
        leader = wait_leader(agents)
        followers = [a for a in agents if a is not leader]
        wait_until(lambda: all(f.server.replicator.leader_addr
                               == leader.rpc_addr for f in followers),
                   "every follower to learn the leader")
        out = []
        for f in followers:
            code, body, _ = http(f.rpc_addr, "PUT", "/v1/jobs",
                                 {"Job": {"ID": "x", "TaskGroups": []}})
            assert code == 409
            assert body["error"] == f"not leader; leader={leader.rpc_addr}"
            out.append((code, mask(body)))
            with pytest.raises(treplication.NotLeaderError
                               if pkg == PORT else Exception):
                f.server.store.replicator.ensure_leader()
        return out
    finally:
        shutdown_all(agents)


def test_follower_write_gets_409_with_the_reference_hint():
    assert follower_write_answers(PORT) == follower_write_answers(JAX)


def raft_rpc_answers(pkg, mode):
    """The raft routes' peer check on a one-server cluster: a
    ``cluster_secret`` that must match, or with ACLs on and no secret a
    management token."""
    port = free_ports(1)[0]
    kw = ({"cluster_secret": "s3cret"} if mode == "secret"
          else {"acl_enabled": True})
    a = agent(pkg, 0, port, [], raft=True, **kw)
    a.start()
    try:
        wait_leader([a])
        addr = a.rpc_addr
        out = {}

        def post(path, body, **headers):
            req = urllib.request.Request(
                addr + path, data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json", **headers})
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    return resp.status, mask(json.loads(resp.read()))
            except urllib.error.HTTPError as exc:
                return exc.code, json.loads(exc.read())

        evil = {"Term": 10 ** 6, "LeaderID": "mallory",
                "LeaderAddr": "http://127.0.0.1:1", "Seq": 10 ** 6,
                "Snapshot": {}}
        out["snapshot bare"] = post("/v1/internal/raft/snapshot", evil)
        out["vote bare"] = post("/v1/internal/raft/vote",
                                {"Term": 10 ** 6, "CandidateID": "mallory"})
        if mode == "secret":
            wrong = {"X-Nomad-Cluster-Secret": "wrong"}
            right = {"X-Nomad-Cluster-Secret": "s3cret"}
        else:
            mgmt = a.server.bootstrap_acl().secret_id
            wrong = {"X-Nomad-Token": "not-a-token"}
            right = {"X-Nomad-Token": mgmt}
        out["vote wrong"] = post("/v1/internal/raft/vote",
                                 {"Term": 10 ** 6, "CandidateID": "m"},
                                 **wrong)
        out["stats right"] = post("/v1/internal/raft/stats", {}, **right)
        out["unknown right"] = post("/v1/internal/raft/nope", {}, **right)
        out["still leader"] = a.server.replicator.is_leader
        return out
    finally:
        a.shutdown()


@pytest.mark.parametrize("mode", ["secret", "management_token"])
def test_raft_rpcs_need_the_secret_or_a_management_token(mode):
    got = raft_rpc_answers(PORT, mode)
    assert got == raft_rpc_answers(JAX, mode)
    assert got["snapshot bare"][0] == got["vote bare"][0] == 403
    assert got["vote wrong"][0] == 403
    assert got["stats right"][0] == 200 and got["unknown right"][0] == 404
    assert got["stats right"][1]["ID"] == "server-0"
    assert got["still leader"] is True


def test_cluster_with_a_secret_replicates_among_its_members():
    agents, addrs = start_cluster(PORT, cluster_secret="s3cret")
    try:
        leader = wait_leader(agents)
        code, _, _ = http(addrs[0], "POST", "/v1/internal/raft/stats", {})
        assert code == 403
        job = small_job()
        leader.server.submit_job(job)
        wait_until(lambda: all(a.server.store.job_by_id(
            job.namespace, job.id) is not None for a in agents),
            "the job on every server")
    finally:
        shutdown_all(agents)


@pytest.mark.parametrize("disk", ["diskless", "data_dir"])
def test_failover_preserves_committed_state(tmp_path, disk):
    agents, addrs = start_cluster(
        PORT, data_root=(tmp_path / "servers") if disk == "data_dir" else None)
    client = None
    try:
        leader = wait_leader(agents)
        client = Client(FailoverRPC(addrs),
                        ClientConfig(data_dir=str(tmp_path / "client")))
        client.start()
        jobs = [small_job(i) for i in range(6)]
        evals = [leader.server.submit_job(j) for j in jobs]
        for ev in evals:
            assert leader.server.wait_for_eval(ev.id, WAIT) is not None
        committed = {a.id for a in leader.server.store.allocs.values()
                     if not a.terminal_status()}
        assert committed, "the burst placed nothing"

        leader.shutdown()
        rest = [a for a in agents if a is not leader]
        new_leader = wait_leader(rest)
        assert new_leader.server.eval_broker.enabled
        assert committed <= set(new_leader.server.store.allocs)
        for j in jobs:
            assert new_leader.server.store.job_by_id(j.namespace, j.id)
        if disk == "data_dir":
            term_file = tmp_path / "servers" / f"s{agents.index(new_leader)}"
            state = json.loads((term_file / "raft_state.json").read_text())
            assert state["term"] == new_leader.server.replicator.term

        # The client follows the new leader through FailoverRPC: its
        # heartbeats reach it, and new work runs on the node.
        node_id = client.node.id
        wait_until(lambda: (n := new_leader.server.store.node_by_id(
            node_id)) is not None and n.status == "ready", "the node ready")
        job = small_job(99)
        ev = new_leader.server.submit_job(job)
        assert new_leader.server.wait_for_eval(ev.id, WAIT) is not None
        wait_until(lambda: [a for a in new_leader.server.store.allocs_by_job(
            job.namespace, job.id) if a.client_status == "running"],
            "an alloc running after the failover", timeout=60)
        assert client.server.current == new_leader.rpc_addr
    finally:
        if client is not None:
            client.shutdown()
        shutdown_all(agents)


def late_joiner(monkeypatch, ring):
    """Two servers take four jobs; a third starts with an empty log."""
    if ring is not None:
        monkeypatch.setattr(treplication, "LOG_RING_CAPACITY", ring)
    ports = free_ports(3)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    agents = [agent(PORT, i, ports[i], addrs, workers=1) for i in range(2)]
    for a in agents:
        a.start()
    leader = wait_leader(agents)
    jobs = [small_job(i) for i in range(4)]
    for j in jobs:
        leader.server.submit_job(j)
    late = agent(PORT, 2, ports[2], addrs, workers=1)
    agents.append(late)
    late.start()
    wait_until(lambda: all(late.server.store.job_by_id(
        j.namespace, j.id) is not None for j in jobs), "the late server")
    assert late.server.replicator.role == "follower"
    return agents, late


def test_lagging_follower_catches_up_by_snapshot(monkeypatch):
    """With the log ring shorter than the late server's gap, only the
    image can catch it up."""
    agents = []
    try:
        agents, late = late_joiner(monkeypatch, ring=4)
        # The follower counts its install after the image is in.
        wait_until(lambda: late.server.replicator.snapshots_installed >= 1,
                   "the install counted")
        assert sum(a.server.replicator.repair_resends for a in agents) == 0
        assert late.server.coalescer.dispatches == 0
    finally:
        shutdown_all(agents)


def test_behind_follower_repaired_by_resend_not_snapshot(monkeypatch):
    agents = []
    try:
        agents, late = late_joiner(monkeypatch, ring=None)
        # The leader counts a re-send when the follower's answer is back,
        # after the follower applied it.
        wait_until(lambda: sum(a.server.replicator.repair_resends
                               for a in agents) >= 1, "the re-send counted")
        assert late.server.replicator.snapshots_installed == 0
    finally:
        shutdown_all(agents)


def test_grow_from_one_survive_leader_loss_and_remove_peer():
    ports = free_ports(3)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    s0 = agent(PORT, 0, ports[0], [], raft=True, workers=1)
    agents = [s0]
    try:
        s0.start()
        wait_until(lambda: s0.server.replicator.is_leader, "s0 to lead")
        job = small_job()
        s0.server.submit_job(job)
        api = APIClient(addrs[0])
        for i in (1, 2):
            api.server_join(addrs[i])
            a = agent(PORT, i, ports[i], [addrs[0]], raft=True, workers=1)
            agents.append(a)
            a.start()
            wait_until(lambda a=a: a.server.store.job_by_id(
                job.namespace, job.id) is not None, f"s{i} caught up")
        wait_until(lambda: all(len(a.server.replicator.peers) == 2
                               for a in agents), "three members everywhere")
        members = api.members()
        assert sorted(m["Addr"] for m in members["Members"]) == sorted(addrs)

        s0.shutdown()
        rest = agents[1:]
        new_leader = wait_leader(rest)
        job2 = small_job(1)
        deadline = time.time() + WAIT
        while True:
            try:
                new_leader.server.submit_job(job2)
                break
            except NotLeaderError:
                assert time.time() < deadline
                new_leader = wait_leader(rest)
        wait_until(lambda: all(a.server.store.job_by_id(
            job2.namespace, job2.id) is not None for a in rest),
            "the write on both survivors")
        out = APIClient(new_leader.rpc_addr).server_remove_peer(addrs[0])
        assert addrs[0] not in out["Members"]
        wait_until(lambda: all(addrs[0] not in a.server.replicator.peers
                               for a in rest), "the dead peer removed")
    finally:
        shutdown_all(agents)


def test_leader_lost_during_a_joiners_install(monkeypatch):
    """A cluster grown from one loses its leader while the leader's image
    transfer to the newest member hangs: the member in step is elected,
    catches the joiner up by snapshot itself, and both hold every
    acknowledged write."""
    monkeypatch.setattr(treplication, "LOG_RING_CAPACITY", 2)
    ports = free_ports(3)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    s0 = agent(PORT, 0, ports[0], [], raft=True, workers=1)
    agents = [s0]
    try:
        s0.start()
        wait_until(lambda: s0.server.replicator.is_leader, "s0 to lead")
        rng = np.random.default_rng(21)
        for i in range(4):
            s0.server.register_node(seeded_node(PORT, rng, i))
        api = APIClient(addrs[0])
        api.server_join(addrs[1])
        s1 = agent(PORT, 1, ports[1], [addrs[0]], raft=True, workers=1)
        agents.append(s1)
        s1.start()
        wait_until(lambda: s1.server.replicator.snapshots_installed >= 1
                   and len(s1.server.store.nodes) == 4, "s1 caught up")
        rep0 = s0.server.replicator
        post = rep0._post

        def hung(addr, path, payload, timeout=None):
            if path.endswith("/snapshot"):
                while not rep0._stop.wait(0.02):  # a transfer that hangs
                    pass
                raise OSError("stopped")
            return post(addr, path, payload, timeout)

        rep0._post = hung
        wait_until(lambda: leader_of(agents) is s0, "s0 leading with s1")
        api.server_join(addrs[2])
        s2 = agent(PORT, 2, ports[2], [addrs[0]], raft=True, workers=1)
        agents.append(s2)
        s2.start()
        wait_until(lambda: rep0._installing(addrs[2]), "s2's install")
        s0.shutdown()
        rest = [s1, s2]
        assert wait_leader(rest) is s1
        wait_until(lambda: s2.server.replicator.snapshots_installed >= 1
                   and s2.server.replicator.leader_addr == addrs[1],
                   "s2 installed from s1")
        node = seeded_node(PORT, rng, 9)
        deadline = time.time() + WAIT
        while True:
            try:
                s1.server.register_node(node)
                break
            except (NotLeaderError, treplication.ReplicationError):
                assert time.time() < deadline
                wait_leader(rest)
        wait_until(lambda: s2.server.store.node_by_id(node.id) is not None,
                   "the write on s2")
        wait_until(lambda: s1.server.store.to_snapshot_wire()
                   == s2.server.store.to_snapshot_wire(), "equal images")
        assert len(s2.server.store.nodes) == 5
    finally:
        shutdown_all(agents)


def test_new_leader_places_as_a_reference_server_restored_from_its_image():
    """After a failover the new leader places a job on the nodes a
    reference server restored from the same image picks."""
    agents, _ = start_cluster(PORT)
    try:
        leader = wait_leader(agents)
        rng = np.random.default_rng(17)
        for i in range(24):
            leader.server.register_node(seeded_node(PORT, rng, i))
        for k in range(3):
            ev = leader.server.submit_job(seeded_job(PORT, f"pre-{k}", 3))
            assert leader.server.wait_for_eval(ev.id, WAIT).status == (
                "complete")
        leader.shutdown()
        rest = [a for a in agents if a is not leader]
        new_leader = wait_leader(rest)
        settle_agent(new_leader)
        image = new_leader.server.store.to_snapshot_wire()

        ref = JServer(JServerConfig(
            num_workers=1, node_capacity=CAPACITY, heartbeat_min_ttl=3600.0,
            heartbeat_max_ttl=7200.0, slo_enabled=False,
            overload_enabled=False))
        ref.store.restore(image, [])
        ref.start()
        try:
            placed = {}
            for name, srv, pkg in (("port", new_leader.server, PORT),
                                   ("jax", ref, JAX)):
                ev = srv.submit_job(seeded_job(pkg, "after", 4, cpu=700))
                assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
                placed[name] = sorted(
                    (a.node_id, srv.store.matrix.row_of[a.node_id])
                    for a in srv.store.allocs.values()
                    if a.job_id == "after" and not a.terminal_status())
            assert len(placed["port"]) == 4
            assert placed["port"] == placed["jax"]
        finally:
            ref.shutdown()
    finally:
        shutdown_all(agents)


@at_lowest_priority
def test_a_plan_acked_past_the_append_window_costs_both_leaders_alike():
    """A system job on every node of a cluster whose leader has one live
    peer; that follower's apply of the plan is held past the leader's
    append window.  In both packages the plan's write raises and the
    issuer steps down for its lost replication quorum; the follower,
    which applied the plan, is elected and holds the job on every node
    once, with both live images equal, and the eval completes."""
    got = {pkg: large_system_plan(pkg, hold=True)[0] for pkg in (JAX, PORT)}
    assert got[JAX] == {
        "plan_acked_first": "ReplicationError",
        "issuer_lost_replication_quorum": True, "settled": True,
        "leads_after": "follower", "eval": "complete"}
    assert got[PORT] == got[JAX]
