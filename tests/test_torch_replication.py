"""Replication and membership of the port, against the JAX package's.

- The replicator's handlers: the same vote, append and snapshot bodies go
  to the reference's ``Replicator`` and the port's, each over a real store
  of its package; their answers and the bytes of ``raft_state.json`` are
  equal step by step, the hard-state cases included.
- The entry stream: the same seeded work (64 nodes, jobs, the plans the
  scheduler makes) through a reference and a port server, each with a
  recording one-member replicator, journals the same entries; each
  package's follower applies the other's stream to the same image, and
  the port follower's matrix equals the reference's rows.
- The card path's trouble spots on the CPU: a leader demoted mid-burst
  that then installs an image clears its matrix only once no select runs;
  a follower's first dispatch after its election uploads a matrix equal
  to a from-scratch one; a writer demoted mid-replicate and the new
  leader's append both finish.
- Snapshot installs: an image taken while a write waits for its quorum
  holds that write; an installing peer keeps its leader in the role, and
  a follower that asked for an image holds off its campaign, only for the
  install's grace.
- Where a whole run hands out the cluster tests (``--dist loadfile``).

Clusters of agents on loopback HTTP are in
``test_torch_replication_cluster.py``.  Every wait is on a condition with
its own deadline.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.server.replication import Replicator as JReplicator
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.state.matrix import NodeMatrix as JNodeMatrix
from nomad_tpu.state.store import StateStore as JStateStore
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.server.replication import Replicator as TReplicator
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.state import carry
from nomad_tpu_torch.state.matrix import DeviceArrays
from nomad_tpu_torch.state.matrix import NodeMatrix as TNodeMatrix
from nomad_tpu_torch.state.store import StateStore as TStateStore
from torch_parity import assert_same, wait_until

torch.set_num_threads(1)

JAX, PORT = "jax", "port"
WAIT = 45.0
CAPACITY = 128


# ---------------------------------------------------------------------------
# Seeded inputs
# ---------------------------------------------------------------------------


def seeded_node(pkg, rng, i):
    node = (jmock if pkg == JAX else tmock).node()
    node.id = node.name = f"node-{i:02d}"
    node.datacenter = f"dc{1 + i % 2}"
    node.attributes = dict(node.attributes)
    node.attributes["rack"] = f"r{i % 4}"
    node.resources.cpu = int(rng.integers(2000, 8000))
    node.resources.memory_mb = int(rng.integers(4096, 16384))
    return node


def seeded_job(pkg, job_id, count=2, cpu=200, mem=128):
    job = (jmock if pkg == JAX else tmock).job()
    job.id = job.name = job_id
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    return job


class Recorder:
    """A one-member replicator that keeps every entry it is handed."""

    def __init__(self):
        self.entries = []
        self.last_seq = 0

    def replicate(self, entry):
        self.entries.append(json.loads(json.dumps(entry)))
        self.last_seq = entry["s"]

    def update_peers(self, addrs):
        pass


class FakeServer:
    """What a replicator needs of its server: the store, the install and
    the leadership transitions (no-ops here)."""

    def __init__(self, store):
        self.store = store

    def install_snapshot(self, image, seq):
        self.store.install_snapshot(image, seq)

    def establish_leadership(self):
        pass

    def revoke_leadership(self):
        pass


def new_store(pkg):
    if pkg == JAX:
        return JStateStore(matrix=JNodeMatrix(capacity=CAPACITY))
    return TStateStore(matrix=TNodeMatrix(capacity=CAPACITY, device="cpu"))


def new_replicator(pkg, state_dir=None, store=None):
    cls = JReplicator if pkg == JAX else TReplicator
    store = store if store is not None else new_store(pkg)
    rep = cls(
        server=FakeServer(store), server_id="s1",
        self_addr="http://127.0.0.1:0", peer_addrs=[],
        state_dir=str(state_dir) if state_dir else None,
    )
    store.replicator = rep  # as Server.setup_replication links them
    return rep


def recorded_entries(n_nodes=6, seed=3):
    """Node registrations journaled by a reference store: the append
    bodies of the handler parity test."""
    store = new_store(JAX)
    rec = Recorder()
    store.replicator = rec
    rng = np.random.default_rng(seed)
    for i in range(n_nodes):
        store.upsert_node(i + 1, seeded_node(JAX, rng, i))
    return rec.entries


def other_image(n_nodes=4):
    store = new_store(JAX)
    rng = np.random.default_rng(11)
    for i in range(n_nodes):
        node = seeded_node(JAX, rng, i)
        node.id = node.name = f"other-{i:02d}"
        store.upsert_node(i + 1, node)
    store.set_raft_peers(n_nodes + 1, ["http://127.0.0.1:0",
                                       "http://127.0.0.1:9"])
    return store.to_snapshot_wire()


# ---------------------------------------------------------------------------
# The replicator's handlers and hard state, against the reference's
# ---------------------------------------------------------------------------


def handler_script(entries, image):
    """(handler, body) steps: votes granted, denied and stale; appends in
    order, out of order and as heartbeats; a snapshot install; a higher
    term's append after it; the stats."""
    lead = {"LeaderID": "L", "LeaderAddr": "http://127.0.0.1:7"}
    return [
        ("vote", {"Term": 1, "CandidateID": "a", "LastSeq": 0}),
        ("vote", {"Term": 1, "CandidateID": "b", "LastSeq": 9}),
        ("vote", {"Term": 1, "CandidateID": "a", "LastSeq": 0}),
        ("append", dict(lead, Term=1, PrevSeq=0, Entries=entries[:3])),
        ("append", dict(lead, Term=1, PrevSeq=3, Entries=[])),
        ("append", dict(lead, Term=1, PrevSeq=1, Entries=[])),
        ("append", dict(lead, Term=1, PrevSeq=5, Entries=entries[5:])),
        ("append", dict(lead, Term=1, PrevSeq=3, Entries=entries[3:])),
        ("vote", {"Term": 2, "CandidateID": "c", "LastSeq": 2}),
        ("vote", {"Term": 3, "CandidateID": "d", "LastSeq": 6}),
        ("append", dict(lead, Term=0, PrevSeq=6, Entries=[])),
        ("snapshot", dict(lead, Term=4, Seq=40, Snapshot=image)),
        ("append", dict(lead, Term=4, PrevSeq=6, Entries=[])),
        ("append", dict(lead, Term=4, PrevSeq=40, Entries=[])),
        ("snapshot", dict(lead, Term=2, Seq=50, Snapshot=image)),
        ("vote", {"Term": 5, "CandidateID": "e", "LastSeq": 40}),
        ("stats", None),
    ]


def run_handlers(pkg, state_dir, steps):
    os.makedirs(state_dir)
    rep = new_replicator(pkg, state_dir)
    out = []
    path = os.path.join(str(state_dir), "raft_state.json")
    for name, body in steps:
        if name == "stats":
            got = rep.stats()
        elif name == "vote":
            got = rep.handle_vote(body)
        elif name == "append":
            got = rep.handle_append(body)
        else:
            got = rep.handle_snapshot_install(body)
        with open(path, "rb") as fh:
            state = fh.read()
        out.append((name, got, state, rep.last_seq, rep.term,
                    rep.voted_for, rep.leader_addr))
    return out, rep


def test_replicator_handlers_match_reference(tmp_path):
    entries, image = recorded_entries(), other_image()
    steps = handler_script(entries, image)
    jout, jrep = run_handlers(JAX, tmp_path / "jax", steps)
    tout, trep = run_handlers(PORT, tmp_path / "port", steps)
    for (name, *want), (_, *got) in zip(jout, tout):
        assert got == want, name
    assert trep.server.store.to_snapshot_wire() == (
        jrep.server.store.to_snapshot_wire())
    assert trep.snapshots_installed == jrep.snapshots_installed == 1
    # The image's membership reached the port's replicator as the
    # reference's.
    assert sorted(trep.peers) == sorted(jrep.peers) == ["http://127.0.0.1:9"]


def hard_state_case(pkg, tmp_path, case):
    """The reference's hard-state tests (test_replication_hardening.py),
    as a record of what each step answered."""
    d = tmp_path / pkg
    d.mkdir()
    if case == "no_double_vote_after_restart":
        rep = new_replicator(pkg, d)
        first = rep.handle_vote({"Term": 5, "CandidateID": "a", "LastSeq": 0})
        rep2 = new_replicator(pkg, d)
        denied = rep2.handle_vote(
            {"Term": 5, "CandidateID": "b", "LastSeq": 100})
        again = rep2.handle_vote({"Term": 5, "CandidateID": "a", "LastSeq": 0})
        got = [first, (rep2.term, rep2.voted_for), denied, again]
    elif case == "term_persists_diskless_does_not":
        new_replicator(pkg, d).handle_vote(
            {"Term": 9, "CandidateID": "x", "LastSeq": 0})
        mem = new_replicator(pkg, None)
        mem.handle_vote({"Term": 9, "CandidateID": "x", "LastSeq": 0})
        got = [new_replicator(pkg, d).term, mem.term,
               new_replicator(pkg, None).term]
    else:
        (d / "raft_state.json").write_text("{not json")
        rep = new_replicator(pkg, d)
        got = [rep.term, rep.voted_for]
    state = d / "raft_state.json"
    return got, state.read_bytes() if state.exists() else None


@pytest.mark.parametrize("case", ["no_double_vote_after_restart",
                                  "term_persists_diskless_does_not",
                                  "corrupt_state_file_tolerated"])
def test_hard_state_matches_reference(tmp_path, case):
    want = hard_state_case(JAX, tmp_path, case)
    got = hard_state_case(PORT, tmp_path, case)
    assert got == want
    if case == "no_double_vote_after_restart":
        assert got[0][0]["Granted"] and not got[0][2]["Granted"]
        assert got[0][3]["Granted"] and got[0][1] == (5, "a")
    elif case == "term_persists_diskless_does_not":
        assert got[0] == [9, 9, 0]
    else:
        assert got[0] == [0, None]


# ---------------------------------------------------------------------------
# The entry stream of a leader, against the reference's
# ---------------------------------------------------------------------------

_UUID = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
_STAMPS = frozenset(("now", "create_time", "modify_time", "submit_time",
                     "allocation_time", "timestamp", "time",
                     "reschedule_time", "wait_until"))


def canonical(entries):
    """The entries with every uuid replaced by its order of first
    appearance (so references between objects still compare) and the
    wall-clock stamps masked."""
    seen = {}

    def walk(obj, key=None):
        if isinstance(obj, dict):
            return {k: walk(v, k) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v, key) for v in obj]
        if key in _STAMPS and isinstance(obj, (int, float)) and not (
                isinstance(obj, bool)):
            return "<stamp>"
        if isinstance(obj, str):
            return _UUID.sub(
                lambda m: seen.setdefault(m.group(0), f"u{len(seen):04d}"),
                obj)
        return obj

    return walk(entries)


def stream_server(pkg):
    kw = dict(num_workers=1, node_capacity=CAPACITY, heartbeat_min_ttl=3600.0,
              heartbeat_max_ttl=7200.0, slo_enabled=False,
              overload_enabled=False)
    if pkg == JAX:
        srv = JServer(JServerConfig(**kw))
    else:
        srv = Server(ServerConfig(**kw), device="cpu")
    rec = Recorder()
    srv.store.replicator = rec
    srv.start()
    return srv, rec


def settle(srv):
    broker = srv.eval_broker

    def quiet():
        busy = (broker.ready_count() + broker.unacked_count()
                + broker.pending_count() + broker.delayed_count())
        return not busy and not [
            e for e in list(srv.store.evals.values())
            if not e.terminal_status() and e.status != "blocked"]

    for _ in range(3):
        wait_until(quiet, "a quiet server", timeout=WAIT)
        time.sleep(0.03)


def stream_workload(srv, pkg):
    rng = np.random.default_rng(5)
    for i in range(64):
        srv.register_node(seeded_node(pkg, rng, i))
    for k in range(6):
        srv.submit_job(seeded_job(pkg, f"web-{k}", count=2 + k % 3,
                                  cpu=300 + 100 * k))
        settle(srv)
    srv.update_node_eligibility("node-03", "ineligible")
    srv.update_node_status("node-05", "down")
    settle(srv)
    srv.store.set_raft_peers(srv.next_index(), ["http://127.0.0.1:1",
                                                "http://127.0.0.1:2"])


def matrix_tensors(m):
    return m.sync("cpu")


def test_entry_stream_matches_reference():
    streams, images, matrices = {}, {}, {}
    for pkg in (JAX, PORT):
        srv, rec = stream_server(pkg)
        try:
            stream_workload(srv, pkg)
            settle(srv)
        finally:
            srv.shutdown()
        streams[pkg] = rec.entries
        images[pkg] = srv.store.to_snapshot_wire()
        matrices[pkg] = srv.store.matrix
    ops = [e["op"] for e in streams[PORT]]
    assert ops.count("upsert_node") == 64
    assert ops.count("upsert_plan_results") >= 6
    assert [e["s"] for e in streams[PORT]] == list(range(1, len(ops) + 1))
    assert_same(canonical(streams[JAX]), canonical(streams[PORT]),
                path="entries")

    # Each package's follower applies the other's stream.
    port_follower, jax_follower = new_store(PORT), new_store(JAX)
    for e in streams[JAX]:
        port_follower.apply_remote(e)
    for e in streams[PORT]:
        jax_follower.apply_remote(e)
    assert port_follower.to_snapshot_wire() == images[JAX]
    assert jax_follower.to_snapshot_wire() == images[PORT]
    # The port follower's matrix, synced, holds the reference's rows.
    ref = matrices[JAX]
    carried = carry.matrix_from_host(
        ref.snapshot_host(), ref.attrs.slot_of, ref.class_ids, ref.row_of,
        "cpu", class_repr=ref.class_repr, dev_slots=ref.devices.slot_of)
    assert port_follower.matrix.row_of == ref.row_of
    got, want = matrix_tensors(port_follower.matrix), carried.sync("cpu")
    for f in DeviceArrays._fields:
        a, b = getattr(got, f).numpy(), getattr(want, f).numpy()
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f


# ---------------------------------------------------------------------------
# The card path's trouble spots, on the CPU
# ---------------------------------------------------------------------------


def replicated_server(election=(60.0, 120.0), workers=4):
    """A port server with a replicator of no peers; it leads once it
    campaigns (the long election timeout keeps its own timer quiet)."""
    srv = Server(ServerConfig(
        num_workers=workers, node_capacity=32, heartbeat_min_ttl=3600.0,
        heartbeat_max_ttl=7200.0, slo_enabled=False, overload_enabled=False,
        election_timeout=election), device="cpu")
    srv.setup_replication("http://127.0.0.1:1")
    srv.start()
    return srv


def elect(srv):
    srv.replicator._campaign()
    wait_until(lambda: srv._leader, "leader services")


def port_image(prefix, n, seed):
    store = new_store(PORT)
    rng = np.random.default_rng(seed)
    for i in range(n):
        node = seeded_node(PORT, rng, i)
        node.id = node.name = f"{prefix}-{i:02d}"
        store.upsert_node(i + 1, node)
    return store.to_snapshot_wire()


def test_demoted_leader_installs_only_once_no_select_runs():
    """A leader demoted by a higher term while its burst is in flight,
    then handed an image: when the matrix clears, no worker runs and no
    dispatch is in flight; every eval it took was acked or nacked; its
    next election starts the workers again and places on the image."""
    srv = replicated_server()
    rep = srv.replicator
    try:
        elect(srv)
        rng = np.random.default_rng(2)
        for i in range(16):
            srv.register_node(seeded_node(PORT, rng, i))
        taken, settled, at_clear = set(), set(), []
        broker = srv.eval_broker
        dequeue, ack, nack = broker.dequeue, broker.ack, broker.nack

        def rec_dequeue(*a, **k):
            ev, token = dequeue(*a, **k)
            if ev is not None:
                taken.add(ev.id)
            return ev, token

        def rec_settle(fn):
            def wrapped(eval_id, token):
                settled.add(eval_id)
                return fn(eval_id, token)
            return wrapped

        broker.dequeue = rec_dequeue
        broker.ack, broker.nack = rec_settle(ack), rec_settle(nack)
        clear = srv.matrix.clear

        def checked_clear():
            at_clear.append((
                [w._thread is not None and w._thread.is_alive()
                 for w in srv.workers],
                srv.coalescer.inflight_depth()))
            clear()

        srv.matrix.clear = checked_clear
        for k in range(12):
            srv.submit_job(seeded_job(PORT, f"burst-{k}", 2))
        wait_until(lambda: taken, "a dequeued eval")
        term = rep.term + 1
        lead = {"LeaderID": "other", "LeaderAddr": "http://127.0.0.1:2"}
        out = rep.handle_append(dict(lead, Term=term, PrevSeq=0, Entries=[]))
        assert out["OK"] and rep.role == "follower"
        image = port_image("img", 8, seed=4)
        out = rep.handle_snapshot_install(
            dict(lead, Term=term, Seq=rep.last_seq, Snapshot=image))
        assert out == {"OK": True, "Term": term}
        assert at_clear == [([False] * len(srv.workers), 0)]
        assert taken <= settled
        assert srv.store.to_snapshot_wire() == image
        assert not srv._leader and not broker.enabled

        elect(srv)
        ev = srv.submit_job(seeded_job(PORT, "after", 2))
        assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
        nodes = {a.node_id for a in srv.store.allocs.values()}
        assert len(nodes) == 2 and nodes <= set(srv.store.nodes)
    finally:
        srv.shutdown()


def test_follower_first_dispatch_after_election_uploads_its_matrix():
    """A follower's matrix changes only through the stream and an install
    (here one that grows it past its capacity); its first dispatch after
    its election uploads all of it: the device copy equals one built from
    scratch from its store."""
    srv = replicated_server(workers=1)
    rep = srv.replicator
    try:
        leader_store = new_store(PORT)
        rec = Recorder()
        leader_store.replicator = rec
        rng = np.random.default_rng(8)
        for i in range(6):
            leader_store.upsert_node(i + 1, seeded_node(PORT, rng, i))
        lead = {"LeaderID": "L", "LeaderAddr": "http://127.0.0.1:2",
                "Term": 1}
        assert rep.handle_append(dict(lead, PrevSeq=0,
                                      Entries=rec.entries))["OK"]
        image = port_image("big", 48, seed=6)  # past the capacity of 32
        assert rep.handle_snapshot_install(dict(lead, Seq=6,
                                                Snapshot=image))["OK"]
        store2 = new_store(PORT)
        rec2 = Recorder()
        rec2.last_seq = 6
        store2.restore(image, [])
        store2.replicator = rec2
        node = seeded_node(PORT, rng, 99)
        store2.upsert_node(60, node)
        assert rep.handle_append(dict(lead, PrevSeq=6,
                                      Entries=rec2.entries))["OK"]
        assert srv.matrix.capacity >= 49 and srv.matrix.full_uploads == 0

        first = []
        sync_locked = srv.matrix._sync_locked

        def traced_sync(dev):
            out = sync_locked(dev)
            if not first:
                first.append(DeviceArrays(*(t.clone() for t in out)))
            return out

        srv.matrix._sync_locked = traced_sync
        elect(srv)
        before = srv.store.to_snapshot_wire()
        ev = srv.submit_job(seeded_job(PORT, "first", 2))
        assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
        assert srv.matrix.full_uploads >= 1 and first
        device = first[0]
        fresh = TStateStore(matrix=TNodeMatrix(
            capacity=srv.matrix.capacity, device="cpu"))
        fresh.restore(before, [])
        want = fresh.matrix.sync("cpu")
        assert set(fresh.matrix.row_of) == set(srv.matrix.row_of)
        rows_t = [srv.matrix.row_of[n] for n in sorted(srv.matrix.row_of)]
        rows_f = [fresh.matrix.row_of[n] for n in sorted(fresh.matrix.row_of)]
        for f in DeviceArrays._fields:
            a = getattr(device, f).numpy()[rows_t]
            b = getattr(want, f).numpy()[rows_f]
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f
    finally:
        srv.shutdown()


def test_writer_demoted_mid_replicate_and_the_new_leaders_append_finish():
    """A journaled writer holds the store's write lock across
    ``replicate()``; the new leader's append waits for it in
    ``apply_remote`` (write lock before read lock), never while holding
    the read lock the writer's apply needs."""
    store = new_store(PORT)
    rep = TReplicator(FakeServer(store), "s0", "http://127.0.0.1:1",
                      ["http://127.0.0.1:2"], election_timeout=(60, 120))
    store.replicator = rep
    rep.role, rep.term = rep.LEADER, 1
    posted, release = threading.Event(), threading.Event()

    def post(addr, path, payload, timeout=None):
        posted.set()
        release.wait(10)
        return {"OK": True, "Term": 1}

    rep._post = post
    rng = np.random.default_rng(1)
    writer = threading.Thread(
        target=store.upsert_node, args=(1, seeded_node(PORT, rng, 0)),
        daemon=True)
    writer.start()
    assert posted.wait(10)

    leader_store = new_store(PORT)
    rec = Recorder()
    leader_store.replicator = rec
    leader_store.upsert_node(1, seeded_node(PORT, rng, 1))
    entered, answer = threading.Event(), {}
    apply_remote = store.apply_remote

    def traced_apply(entry):
        entered.set()
        apply_remote(entry)

    store.apply_remote = traced_apply
    appender = threading.Thread(target=lambda: answer.update(
        rep.handle_append({"Term": 2, "LeaderID": "n",
                           "LeaderAddr": "http://127.0.0.1:3", "PrevSeq": 0,
                           "Entries": rec.entries})), daemon=True)
    appender.start()
    assert entered.wait(10)
    time.sleep(0.1)
    release.set()
    writer.join(10)
    appender.join(10)
    assert not writer.is_alive() and not appender.is_alive()
    assert answer["OK"] and rep.role == "follower" and rep.term == 2
    assert {"node-00", "node-01"} == set(store.nodes)


def test_image_taken_while_a_write_waits_for_its_quorum_holds_it():
    """A catch-up image captured while a write is between its quorum and
    its apply waits for that apply: the joiner's image labelled with the
    write's seq holds the write, and the next append lands on it."""
    leader_store = new_store(PORT)
    rep = TReplicator(FakeServer(leader_store), "L", "http://127.0.0.1:1",
                      ["http://f", "http://j"], election_timeout=(60, 120))
    leader_store.replicator = rep
    rep.role, rep.term = rep.LEADER, 1
    follower, joiner = (new_replicator(PORT) for _ in range(2))
    f_posted, f_release = threading.Event(), threading.Event()

    def post(addr, path, payload, timeout=None):
        if path.endswith("/snapshot"):
            return joiner.handle_snapshot_install(payload)
        if addr == "http://j":
            if not joiner.snapshots_installed:  # behind the leader's ring
                return {"OK": False, "Term": 1, "NeedSnapshot": True,
                        "Seq": -1}
            return joiner.handle_append(payload)
        if payload["Entries"] and not f_release.is_set():
            f_posted.set()
            f_release.wait(10)
        return follower.handle_append(payload)

    rep._post = post
    rng = np.random.default_rng(5)
    f_release.set()
    for i in range(3):
        leader_store.upsert_node(i + 1, seeded_node(PORT, rng, i))
    f_release.clear()
    writer = threading.Thread(
        target=leader_store.upsert_node,
        args=(4, seeded_node(PORT, rng, 3)), daemon=True)
    writer.start()
    assert f_posted.wait(10)  # the write is in its quorum round
    built = []
    to_wire = leader_store.to_snapshot_wire

    def slow_to_wire():
        # The quorum completes while the image is built (if it can).
        if not built:
            built.append(1)
            deadline = time.time() + 2.0
            while rep.last_seq < 4 and time.time() < deadline:
                time.sleep(0.01)
        return to_wire()

    leader_store.to_snapshot_wire = slow_to_wire
    installer = threading.Thread(target=rep._install_snapshot,
                                 args=(rep.peers["http://j"], 1), daemon=True)
    installer.start()
    time.sleep(0.2)
    f_release.set()
    writer.join(10)
    installer.join(10)
    assert not writer.is_alive() and not installer.is_alive()
    assert joiner.last_seq == 4 and joiner.snapshots_installed == 1
    leader_store.upsert_node(5, seeded_node(PORT, rng, 4))
    assert joiner.last_seq == follower.last_seq == rep.last_seq == 5
    leader_store.to_snapshot_wire = to_wire
    image = leader_store.to_snapshot_wire()
    assert joiner.server.store.to_snapshot_wire() == image
    assert follower.server.store.to_snapshot_wire() == image


def test_leader_whose_only_live_peer_is_installing_steps_down():
    """A leader cut off from all but a peer whose install hangs keeps its
    role for the install's grace, not for the transfer's timeout."""
    store = new_store(PORT)
    rep = TReplicator(FakeServer(store), "L", "http://127.0.0.1:1",
                      ["http://installing", "http://dead"],
                      election_timeout=(0.05, 0.1), heartbeat_interval=0.02)
    store.replicator = rep

    def post(addr, path, payload, timeout=None):
        if addr == "http://dead":
            raise OSError("connection refused")
        if path.endswith("/snapshot"):
            while not rep._stop.wait(0.02):  # a transfer that hangs
                pass
            raise OSError("stopped")
        return {"OK": False, "Term": 1, "NeedSnapshot": True, "Seq": -1}

    rep._post = post
    rep.role, rep.term = rep.CANDIDATE, 1
    rep._become_leader(1)
    t0 = time.monotonic()
    try:
        wait_until(lambda: rep._installing("http://installing"),
                   "the catch-up to start")
        time.sleep(rep.install_grace / 2)
        assert rep.role == rep.LEADER
        wait_until(lambda: rep.role == rep.FOLLOWER, "the step-down",
                   timeout=rep.install_grace + WAIT)
        assert time.monotonic() - t0 >= rep.install_grace
    finally:
        rep.stop()


def test_follower_waiting_for_a_snapshot_does_not_campaign():
    """A follower that asked its leader for a snapshot does not campaign
    while the image is built and sent (the leader sends no heartbeat to a
    peer it is installing); a follower that heard the same leader as
    recently but is in step does, once its timer runs out.  After the
    install the waiting follower's timer runs again.  One whose leader
    goes silent campaigns once the install's grace has passed."""
    votes = {}

    def follower(name, election_timeout=(0.1, 0.2)):
        rep = TReplicator(FakeServer(new_store(PORT)), name,
                          f"http://{name}", ["http://127.0.0.1:2"],
                          election_timeout=election_timeout)

        def post(addr, path, payload, timeout=None):
            if path.endswith("/vote"):
                votes[name] = votes.get(name, 0) + 1
                votes.setdefault(name + "@", time.monotonic())
            return {"Granted": False, "Term": 0}

        rep._post = post
        return rep

    waiting, control = follower("waiting"), follower("control")
    abandoned = follower("abandoned", election_timeout=(0.02, 0.04))
    reps = (waiting, control, abandoned)
    lead = {"Term": 1, "LeaderID": "L", "LeaderAddr": "http://127.0.0.1:2",
            "Entries": []}
    assert waiting.handle_append(dict(lead, PrevSeq=50))["NeedSnapshot"]
    asked = time.monotonic()
    assert abandoned.handle_append(dict(lead, PrevSeq=50))["NeedSnapshot"]
    assert control.handle_append(dict(lead, PrevSeq=0))["OK"]
    for rep in reps:
        rep.start()
    try:
        wait_until(lambda: votes.get("control", 0) >= 2,
                   "the control follower to campaign twice")
        assert "waiting" not in votes and waiting.term == 1
        out = waiting.handle_snapshot_install(
            dict(lead, Seq=50, Snapshot=port_image("img", 2, seed=1)))
        assert out["OK"] and waiting.last_seq == 50
        wait_until(lambda: votes.get("waiting", 0) >= 1,
                   "the installed follower to campaign")
        wait_until(lambda: votes.get("abandoned", 0) >= 1,
                   "the abandoned follower to campaign")
        assert votes["abandoned@"] - asked >= abandoned.install_grace
    finally:
        for rep in reps:
            rep.stop()


def test_leadership_transitions_follow_the_replicators_role():
    """A revoke queued by a step-down that runs after the next election
    leaves the re-elected leader's services on; an establish that runs
    after a step-down starts none."""
    srv = replicated_server(workers=1)
    rep = srv.replicator
    try:
        elect(srv)
        srv.revoke_leadership()  # late: the role is leader again
        assert srv._leader and srv.eval_broker.enabled
        rng = np.random.default_rng(3)
        for i in range(4):
            srv.register_node(seeded_node(PORT, rng, i))
        ev = srv.submit_job(seeded_job(PORT, "still-leading", 1))
        assert srv.wait_for_eval(ev.id, WAIT).status == "complete"

        lead = {"LeaderID": "n", "LeaderAddr": "http://127.0.0.1:2",
                "Term": rep.term + 1, "PrevSeq": 0, "Entries": []}
        assert rep.handle_append(lead)["OK"] and rep.role == "follower"
        wait_until(lambda: not srv._leader, "the step-down's revoke")
        srv.establish_leadership()  # late: the role is follower
        assert not srv._leader and not srv.eval_broker.enabled
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# Where the clusters run in a whole run
# ---------------------------------------------------------------------------

# Files ordered by test count that must lie between tests/test_chaos.py and
# test_torch_replication_cluster.py when a run collects both (ROADMAP R2).
CHAOS_GAP = 24


def loadfile_order(items):
    """The test files in the order ``--dist loadfile`` hands them out:
    most tests first, ties in collection order."""
    counts = {}
    for item in items:
        path = item.nodeid.split("::", 1)[0]
        counts[path] = counts.get(path, 0) + 1
    return sorted(counts, key=lambda path: -counts[path])


# The port's files that run three-agent clusters or the chaos scenarios.
CLUSTER_FILES = ("test_torch_replication_cluster.py",
                 "test_torch_chaos_cluster.py",
                 "test_torch_chaos_overload.py",
                 "test_torch_chaos_device.py",
                 "test_torch_chaos_host.py",
                 "test_torch_chaos_tsan.py")


def test_clusters_are_handed_out_well_after_the_chaos_scenarios(request):
    """``--dist loadfile`` hands out the files with the most tests first.
    ``tests/test_chaos.py``'s flash-crowd case failed in each of four
    whole runs in which the port's cluster tests were handed out 12 files
    after it, and passed with 30 files between.  In a run that collects
    ``test_chaos.py`` and any of ``CLUSTER_FILES``, CHAOS_GAP files must
    lie between it and each of them; a run of fewer files holds nothing
    to check."""
    order = loadfile_order(request.session.items)
    chaos = [p for p in order if p.endswith("/test_chaos.py")]
    for name in CLUSTER_FILES:
        here = [p for p in order if p.endswith("/" + name)]
        if chaos and here:
            gap = order.index(here[0]) - order.index(chaos[0]) - 1
            assert gap >= CHAOS_GAP, (
                f"{here[0]} is handed out {gap} files after {chaos[0]}: "
                f"run clusters from a file with fewer tests (ROADMAP R2)")
