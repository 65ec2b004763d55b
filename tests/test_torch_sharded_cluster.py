"""Node-sharded server agents as members of a replicated cluster.

Three in-process port agents on loopback HTTP, each with its coalescer
over ``device=["cpu"] * 8`` (``make_mesh``: two batch rows by four node
shards), at 24 seeded nodes of capacity 64.  A follower claims the
stream's rows densely and launches nothing; its first dispatch as leader
homes later claims on four shards (``set_shard_count``) and lays the
matrix out over its own mesh in full.  Checked here:

- (a) a failover onto a follower that never led: its rows stay where the
  dense claims put them, its first dispatch is one full lay-out, its
  resident copy equals a from-scratch ``shard_matrix_arrays`` bit for bit,
  and it places where a JAX reference ``Server`` restored from the same
  image places;
- (b) a snapshot install into a follower that once led (a partition
  while it led): the rows homed on its four shards as a from-scratch
  four-shard restore homes them, one full lay-out next, and as leader
  again the reference's placements;
- (c) the shutdown of a leader that evacuated a shard mid-burst: the next
  leader places on four shards of its own mesh and every acknowledged
  eval completes;
- (d) mixed members, a sharded leader over one-device followers and the
  reverse: the failover places as the reference.

Placements are compared by node id (row numbers depend on each member's
history), exactly, as the kernels' contract holds picks
(``tests/test_fake_device.py:99-110``: picks exact, scores rtol 1e-4 /
atol 1e-5; no score is compared here).  The seeded nodes' capacities are
distinct, so no two candidates tie on score and the argmax never falls
to the row tie-break.  The reference runs unsharded (ROADMAP R1).

Leadership is chosen, not waited for: every member's election timeout
is far longer than a test, and the test calls ``_campaign`` on the
member it wants to lead.
"""

import numpy as np
import pytest
import torch

from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.chaos.injector import FaultSpec, injected
from nomad_tpu_torch.parallel.sharding import shard_matrix_arrays
from nomad_tpu_torch.server import replication as treplication
from nomad_tpu_torch.server.server import ServerConfig
from nomad_tpu_torch.state.matrix import DEVICE_LOCK, DeviceArrays, NodeMatrix
from nomad_tpu_torch.state.store import StateStore
from test_torch_replication import JAX, PORT, WAIT, seeded_job, seeded_node
from torch_parity import (at_lowest_priority, elect, free_ports,
                          settle_agent, wait_until)

torch.set_num_threads(1)

MESH = ["cpu"] * 8  # two batch rows by four node shards
SHARDS = 4
CAP = 64  # a multiple of SHARDS: the first dispatch homes the matrix
N_NODES = 24  # dense rows 0..23: two of the four 16-row shards hold some
# No member campaigns on its own within a test (scaled by the suite's
# NOMAD_TPU_RAFT_TIMEOUT_SCALE); leaders are elected with ``elect``.
QUIET_ELECTION = (60.0, 90.0)
HEARTBEAT = 0.25
# Two workers a member select at most two evals at once; a sharded
# dispatch on the CPU scans every lane, live or not.
LANES = 4


def member(i, port, peers, device):
    sc = ServerConfig(num_workers=2, coalescer_lanes=LANES,
                      node_capacity=CAP, heartbeat_min_ttl=3600,
                      heartbeat_max_ttl=7200,
                      server_id=f"server-{i}", peers=list(peers),
                      election_timeout=QUIET_ELECTION,
                      raft_heartbeat_interval=HEARTBEAT,
                      slo_enabled=False, overload_enabled=False)
    return Agent(AgentConfig(name=f"server-{i}", server_enabled=True,
                             client_enabled=False, http_host="127.0.0.1",
                             http_port=port, server_config=sc),
                 device=device)


def start_members(devices):
    ports = free_ports(len(devices))
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    agents = [member(i, ports[i], addrs, dev)
              for i, dev in enumerate(devices)]
    for a in agents:
        a.start()
    return agents


def shutdown_all(agents):
    for a in agents:
        try:
            a.shutdown()
        except Exception:  # noqa: BLE001 — already stopped
            pass


def build(agents, leader, seed=23):
    """The leader registers the seeded nodes and places two jobs; every
    member ends with the same image."""
    rng = np.random.default_rng(seed)
    for i in range(N_NODES):
        leader.server.register_node(seeded_node(PORT, rng, i))
    for k in range(2):
        ev = leader.server.submit_job(seeded_job(PORT, f"pre-{k}", 3))
        assert leader.server.wait_for_eval(ev.id, WAIT).status == "complete"
    settle_agent(leader)
    converged(agents)


def converged(agents):
    wait_until(lambda: all(a.server.store.to_snapshot_wire()
                           == agents[0].server.store.to_snapshot_wire()
                           for a in agents[1:]), "equal images", every=0.1)


def never_led(agent):
    """A follower of the stream: nothing dispatched, no mesh built, every
    row claimed densely in stream order."""
    srv = agent.server
    assert srv.coalescer.dispatches == 0
    assert srv.coalescer._mesh is None
    assert srv.matrix.shard_count == 1
    assert sorted(srv.matrix.row_of.values()) == list(range(N_NODES))


def resident_is_fresh(srv):
    """The mesh-resident copy, synced, equals a from-scratch lay-out of
    the host arrays, bit for bit on every shard of every batch row."""
    m, mesh = srv.matrix, srv.coalescer._mesh
    with DEVICE_LOCK:
        resident = m.sync_sharded(mesh)
        with m._host_lock:
            host = DeviceArrays(**{f: m.snapshot_host()[f].copy()
                                   for f in DeviceArrays._fields})
        fresh = shard_matrix_arrays(mesh, host)
    assert resident.n_local == fresh.n_local
    for got_row, want_row in zip(resident.shards, fresh.shards):
        for got, want in zip(got_row, want_row):
            for f in DeviceArrays._fields:
                assert getattr(got, f).numpy().tobytes() == (
                    getattr(want, f).numpy().tobytes()), f


def reference(image):
    ref = JServer(JServerConfig(
        num_workers=1, node_capacity=CAP, heartbeat_min_ttl=3600.0,
        heartbeat_max_ttl=7200.0, slo_enabled=False, overload_enabled=False))
    ref.store.restore(image, [])
    ref.start()
    return ref


def places_as_reference(agent, job_id="after"):
    """A count-4 job lands on the nodes a reference server restored from
    the agent's image picks (by node id); returns them."""
    settle_agent(agent)
    ref = reference(agent.server.store.to_snapshot_wire())
    try:
        placed = {}
        for name, srv, pkg in (("port", agent.server, PORT),
                               ("jax", ref, JAX)):
            ev = srv.submit_job(seeded_job(pkg, job_id, 4, cpu=700))
            assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
            placed[name] = sorted(
                a.node_id for a in srv.store.allocs.values()
                if a.job_id == job_id and not a.terminal_status())
        assert len(placed["port"]) == 4
        assert placed["port"] == placed["jax"]
        return placed["port"]
    finally:
        ref.shutdown()


def allocs_fit(srv):
    """Every node's usage fits its totals (the host AllocsFit)."""
    host = srv.matrix.snapshot_host()
    for nid, row in srv.matrix.row_of.items():
        assert np.all(host["used"][row] <= host["totals"][row]), nid


def on_own_mesh(srv):
    """The server dispatches over four node shards of its own full mesh."""
    assert srv.matrix.shard_count == SHARDS
    assert srv.coalescer._mesh.shape == (2, SHARDS)
    assert srv.coalescer._pre_evac_shards is None


# ---------------------------------------------------------------------------


@at_lowest_priority
def test_failover_onto_a_never_led_sharded_follower():
    agents = start_members([MESH] * 3)
    try:
        old = elect(agents[0])
        build(agents, old)
        assert old.server.matrix.shard_count == SHARDS
        for f in agents[1:]:
            never_led(f)
        old.shutdown()
        new, other = agents[1], agents[2]
        elect(new)
        settle_agent(new)
        m = new.server.matrix
        rows, uploads = dict(m.row_of), m.full_uploads
        counts_dense = [16, 8, 0, 0]  # 24 dense rows over 16-row blocks
        places_as_reference(new)
        # The first dispatch homed later claims and kept every row where
        # the dense claims put it; it laid the matrix out once.
        on_own_mesh(new.server)
        assert m.row_of == rows
        assert m.shard_row_counts() == counts_dense
        assert m.full_uploads == uploads + 1
        resident_is_fresh(new.server)
        # A node registered now lands on the least-claimed shard, and the
        # next sync only scatters it into that shard.
        node = seeded_node(PORT, np.random.default_rng(5), N_NODES)
        new.server.register_node(node)
        row = m.row_of[node.id]
        assert m.home_shard(row) == counts_dense.index(min(counts_dense))
        resident_is_fresh(new.server)
        assert m.full_uploads == uploads + 1
        assert other.server.coalescer.dispatches == 0
        converged([new, other])
    finally:
        shutdown_all(agents)


@at_lowest_priority
def test_install_into_a_sharded_follower_that_once_led(monkeypatch):
    """A leader partitioned away falls behind the log ring; once the
    partition heals it installs the new leader's image into its
    four-shard matrix, and leads again on a fresh lay-out."""
    monkeypatch.setattr(treplication, "LOG_RING_CAPACITY", 4)
    agents = start_members([MESH] * 3)
    try:
        a0, a1, a2 = agents
        elect(a0)
        build(agents, a0)
        assert a0.server.matrix.shard_count == SHARDS
        mesh = a0.server.coalescer._mesh
        cut = [FaultSpec("raft.send", "drop", match={"dst": a0.rpc_addr}),
               FaultSpec("raft.send", "drop", match={"src": "server-0"})]
        with injected(0, cut):
            wait_until(lambda: not a0.server.replicator.is_leader
                       and not a0.server._leader, "the cut leader steps down")
            elect(a1)
            rng = np.random.default_rng(31)
            for i in range(N_NODES, N_NODES + 4):
                a1.server.register_node(seeded_node(PORT, rng, i))
            for k in range(4):
                ev = a1.server.submit_job(seeded_job(PORT, f"cut-{k}", 2))
                assert a1.server.wait_for_eval(ev.id, WAIT).status == (
                    "complete")
        wait_until(lambda: a0.server.replicator.snapshots_installed >= 1,
                   "the healed member's install")
        converged([a1, a0, a2])
        m = a0.server.matrix
        # The install kept the partition: every row homed as a
        # from-scratch four-shard restore of the same image homes it.
        twin = StateStore(matrix=NodeMatrix(capacity=CAP, device="cpu"))
        twin.matrix.set_shard_count(SHARDS)
        twin.restore(a0.server.store.to_snapshot_wire(), [])
        assert m.shard_count == SHARDS
        assert m.row_of == twin.matrix.row_of
        assert m.shard_row_counts() == [7, 7, 7, 7]
        assert a0.server.coalescer._mesh is mesh
        uploads = m.full_uploads
        a1.shutdown()
        elect(a0)
        places_as_reference(a0)
        # The mesh and its programs outlived the install; the matrix they
        # read was laid out anew, once.
        assert a0.server.coalescer._mesh is mesh
        on_own_mesh(a0.server)
        assert m.full_uploads == uploads + 1
        resident_is_fresh(a0.server)
        converged([a0, a2])
    finally:
        shutdown_all(agents)


@at_lowest_priority
def test_an_evacuated_leaders_shutdown_hands_over_to_four_shards():
    agents = start_members([MESH] * 3)
    try:
        old = elect(agents[0])
        build(agents, old)
        jobs = [seeded_job(PORT, f"burst-{k}", 2) for k in range(12)]
        acked = [old.server.submit_job(j).id for j in jobs[:4]]
        assert old.server.coalescer.evacuate_shard(1) == SHARDS - 1
        acked += [old.server.submit_job(j).id for j in jobs[4:8]]
        wait_until(lambda: old.server.coalescer._mesh is not None
                   and old.server.coalescer._mesh.shape == (2, SHARDS - 1),
                   "a dispatch on the survivors' mesh")
        old.shutdown()
        # The evacuation outlives the leadership: the old coalescer keeps
        # the survivors' devices and the count to heal back to.
        co = old.server.coalescer
        assert co._pre_evac_shards == SHARDS and co.n_device_shards == 6
        new, other = agents[1], agents[2]
        elect(new)
        acked += [new.server.submit_job(j).id for j in jobs[8:]]
        for eval_id in acked:
            wait_until(lambda e=eval_id: (ev := new.server.store.eval_by_id(
                e)) is not None and ev.status == "complete",
                f"eval {eval_id} complete")
        settle_agent(new)
        on_own_mesh(new.server)
        assert new.server.matrix.capacity == CAP
        assert other.server.coalescer.dispatches == 0
        for j in jobs:
            allocs = [a for a in new.server.store.allocs_by_job(
                j.namespace, j.id) if not a.terminal_status()]
            assert len(allocs) == 2, j.id
        allocs_fit(new.server)
        resident_is_fresh(new.server)
        converged([new, other])
    finally:
        shutdown_all(agents)


@pytest.mark.parametrize("layout", ["sharded_leader", "sharded_followers"])
@at_lowest_priority
def test_mixed_members_fail_over(layout):
    devices = ([MESH, "cpu", "cpu"] if layout == "sharded_leader"
               else ["cpu", MESH, MESH])
    agents = start_members(devices)
    try:
        old = elect(agents[0])
        build(agents, old)
        assert old.server.matrix.shard_count == (
            SHARDS if layout == "sharded_leader" else 1)
        old.shutdown()
        new, other = agents[1], agents[2]
        elect(new)
        places_as_reference(new)
        if layout == "sharded_leader":
            assert new.server.coalescer.n_device_shards == 1
            assert new.server.matrix.shard_count == 1
            assert new.server.coalescer.fused_dispatches > 0
        else:
            on_own_mesh(new.server)
            resident_is_fresh(new.server)
        assert other.server.coalescer.dispatches == 0
        allocs_fit(new.server)
        converged([new, other])
    finally:
        shutdown_all(agents)
