"""The port's durability on the CPU, against the JAX package's.

A server of either package writes a ``data_dir`` (the write-ahead log, and
on a clean shutdown the snapshot); servers of both packages restore it.
The on-disk format and the wire tags are the same in both, so after the
restore each holds the writer's ``to_snapshot_wire()`` image, the writer's
matrix host arrays row for row and its ``latest_index``, and both place
the same new job on the same nodes.  Also: compaction at
``snapshot_every``, a blocked eval that survives the restart, a torn final
log line, ``install_snapshot`` of the JAX store's image into a port server
whose matrix already holds other rows (one full upload after it, with
scheduling quiesced across it), a dispatch in flight across a matrix
clear, and a ``kill -9`` of a port server mid-workload.

Clusters are seeded (≤ 16 nodes); every wait is on a predicate with its
own deadline.
"""

import os
import queue
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.state.matrix import NodeMatrix as JNodeMatrix
from nomad_tpu.state.store import StateStore as JStateStore
from nomad_tpu.state.wal import WriteAheadLog as JWAL
from nomad_tpu.structs import serde as jserde
from nomad_tpu.structs import types as jtypes
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.retry import Backoff as TBackoff
from nomad_tpu_torch.retry import RetryPolicy as TRetryPolicy
from nomad_tpu_torch.scheduler import coalescer as tcoalescer
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.state.store import StateStore as TStateStore
from nomad_tpu_torch.state.wal import WriteAheadLog as TWAL
from nomad_tpu_torch.structs import serde as tserde
from nomad_tpu_torch.structs import types as ttypes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 45.0

JAX = "jax"
PORT = "port"
PKGS = {
    JAX: (JServer, JServerConfig, jmock, jtypes, jserde, JWAL, JStateStore),
    PORT: (Server, ServerConfig, tmock, ttypes, tserde, TWAL, TStateStore),
}


def make_server(pkg, data_dir, **kw):
    server_cls, config_cls = PKGS[pkg][0], PKGS[pkg][1]
    kw.setdefault("num_workers", 1)
    kw.setdefault("node_capacity", 32)
    kw.setdefault("heartbeat_min_ttl", 3600.0)
    kw.setdefault("heartbeat_max_ttl", 7200.0)
    cfg = config_cls(data_dir=str(data_dir), slo_enabled=False,
                     overload_enabled=False, **kw)
    if pkg == JAX:
        return server_cls(cfg)
    return server_cls(cfg, device="cpu")


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


def crash_stop(srv):
    """Stop every thread but write no snapshot: what is on disk is what a
    crash leaves, since each append is flushed before its mutation
    applies."""
    wal = srv.store.wal
    srv.store.wal = None
    srv.shutdown()
    wal.close()


def stop(srv, mode):
    if mode == "crash":
        crash_stop(srv)
    else:
        srv.shutdown()


def seeded_node(pkg, rng, i):
    mock = PKGS[pkg][2]
    node = mock.node()
    node.id = node.name = f"node-{i:02d}"
    node.attributes = dict(node.attributes)
    node.attributes["rack"] = f"r{i % 3}"
    node.resources.cpu = int(rng.integers(2000, 8000))
    node.resources.memory_mb = int(rng.integers(4096, 16384))
    return node


def seeded_job(pkg, job_id, count, cpu=300, mem=128, job_type="service"):
    mock = PKGS[pkg][2]
    job = mock.system_job() if job_type == "system" else mock.job()
    job.id = job.name = job_id
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    return job


def play_client(srv):
    updates = []
    for a in list(srv.store.allocs.values()):
        if a.client_status == "pending" and a.desired_status == "run":
            upd = a.copy()
            upd.client_status = "running"
            updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)


def workload(srv, pkg, seed=5, n_nodes=12):
    """Nodes, a service job, a system job, a job too big for any node
    (its eval blocks), the client's running reports, a node marked
    ineligible and one down."""
    rng = np.random.default_rng(seed)
    for i in range(n_nodes):
        srv.register_node(seeded_node(pkg, rng, i))
    srv.submit_job(seeded_job(pkg, "web", 3))
    settle(srv)
    srv.submit_job(seeded_job(pkg, "sys", 0, cpu=100, mem=64,
                              job_type="system"))
    settle(srv)
    srv.submit_job(seeded_job(pkg, "huge", 1, cpu=500_000))
    settle(srv)
    play_client(srv)
    settle(srv)
    srv.update_node_eligibility("node-01", "ineligible")
    srv.update_node_status("node-02", "down")
    settle(srv)
    play_client(srv)
    settle(srv)
    srv.store.set_raft_peers(srv.next_index(), ["10.0.0.1:4647",
                                                "10.0.0.2:4647"])


def host_arrays_equal(ma, mb):
    ha, hb = ma.snapshot_host(), mb.snapshot_host()
    assert sorted(ha) == sorted(hb)
    for f in ha:
        assert ha[f].dtype == hb[f].dtype, f
        assert ha[f].shape == hb[f].shape, f
        assert np.array_equal(ha[f], hb[f], equal_nan=ha[f].dtype.kind == "f"), f
    assert ma.row_of == mb.row_of


def placed_nodes(srv, job_id):
    return sorted(a.node_id for a in srv.store.allocs.values()
                  if a.job_id == job_id and not a.terminal_status())


# ---------------------------------------------------------------------------
# Wire codec and backoff: the same in both packages
# ---------------------------------------------------------------------------


def test_wire_forms_are_interchangeable():
    """A wire form of either package decodes in the other to an object
    whose wire form is the same."""
    rng = np.random.default_rng(3)
    for make in (lambda p: seeded_node(p, rng, 4),
                 lambda p: seeded_job(p, "web", 3)):
        for src, dst in ((JAX, PORT), (PORT, JAX)):
            obj = make(src)
            wire = PKGS[src][4].to_wire(obj)
            back = PKGS[dst][4].from_wire(wire)
            assert type(back).__module__.startswith(
                "nomad_tpu_torch" if dst == PORT else "nomad_tpu.")
            assert PKGS[dst][4].to_wire(back) == wire
    wire = jserde.to_wire(jtypes.Evaluation(
        job_id="j1", class_eligibility={"v1:abc": True}))
    wire["some_future_field"] = {"x": 1}
    ev = tserde.from_wire(wire)
    assert isinstance(ev, ttypes.Evaluation)
    assert ev.class_eligibility == {"v1:abc": True}
    with pytest.raises(TypeError):
        tserde.from_wire({"__t": "NoSuchType"})


def test_backoff_matches_reference():
    import random

    from nomad_tpu.retry import Backoff as JBackoff
    from nomad_tpu.retry import RetryPolicy as JRetryPolicy

    kw = dict(base_delay=0.01, max_delay=0.3, multiplier=3.0, jitter=0.2)
    jb = JBackoff(JRetryPolicy(**kw), random.Random(11))
    tb = TBackoff(TRetryPolicy(**kw), random.Random(11))
    assert [jb.next_delay() for _ in range(8)] == [
        tb.next_delay() for _ in range(8)]
    jb.reset()
    tb.reset()
    assert jb.attempt == tb.attempt == 0
    assert jb.next_delay() == tb.next_delay()


# ---------------------------------------------------------------------------
# The write-ahead log and snapshot, in both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["crash", "clean"])
@pytest.mark.parametrize("writer", [JAX, PORT])
def test_restore_across_packages(tmp_path, writer, mode):
    data = tmp_path / "data"
    src = make_server(writer, data)
    src.start()
    workload(src, writer)
    image = src.store.to_snapshot_wire()
    latest = src.store.latest_index
    assert any(e.status == "blocked" for e in src.store.evals.values())
    stop(src, mode)
    snap, entries = PKGS[writer][5](str(data)).load()
    if mode == "crash":
        assert snap is None and entries
    else:
        assert snap is not None and entries == []

    restored = {}
    for pkg in (JAX, PORT):
        copy = tmp_path / f"restore-{pkg}"
        shutil.copytree(data, copy)
        srv = make_server(pkg, copy)
        restored[pkg] = srv
        assert srv.store.to_snapshot_wire() == image, pkg
        assert srv.store.latest_index == latest, pkg
        host_arrays_equal(src.matrix, srv.matrix)
    port = restored[PORT]
    assert port.matrix.full_uploads == 0
    port.matrix.sync(device="cpu")
    assert port.matrix.full_uploads == 1

    placed = {}
    for pkg, srv in restored.items():
        srv.start()
        try:
            ev = srv.submit_job(seeded_job(pkg, "extra", 4, cpu=700, mem=512))
            assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
            settle(srv)
            placed[pkg] = placed_nodes(srv, "extra")
            assert [e.status for e in srv.store.evals.values()
                    if e.job_id == "huge"].count("blocked") == 1
        finally:
            srv.shutdown()
    assert len(placed[PORT]) == 4
    assert placed[JAX] == placed[PORT]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_snapshot_every_compacts_the_log(tmp_path, writer, reader):
    data = tmp_path / "data"
    srv = make_server(writer, data, snapshot_every=10)
    srv.start()
    rng = np.random.default_rng(1)
    for i in range(4):
        srv.register_node(seeded_node(writer, rng, i))
    for i in range(12):
        srv.submit_job(seeded_job(writer, f"job-{i:02d}", 1))
    settle(srv)
    assert srv.store.wal.appends_since_snapshot < 10
    assert os.path.exists(srv.store.wal.snapshot_path)
    image = srv.store.to_snapshot_wire()
    crash_stop(srv)
    snap, entries = PKGS[reader][5](str(data)).load()
    assert snap is not None and len(entries) < 10
    back = make_server(reader, data)
    assert back.store.to_snapshot_wire() == image
    assert len(back.store.jobs) == 12
    back.shutdown()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_blocked_eval_survives_and_places(tmp_path, writer, reader):
    data = tmp_path / "data"
    srv = make_server(writer, data)
    srv.start()
    srv.register_node(seeded_node(writer, np.random.default_rng(2), 0))
    ev = srv.submit_job(seeded_job(writer, "big", 1, cpu=100_000))
    wait_until(lambda: any(e.status == "blocked" and e.job_id == "big"
                           for e in srv.store.evals.values()),
               "the big job's eval to block")
    settle(srv)
    crash_stop(srv)

    back = make_server(reader, data)
    back.start()
    try:
        assert [e.job_id for e in back.store.evals.values()
                if e.status == "blocked"] == ["big"]
        assert back.store.eval_by_id(ev.id) is not None
        giant = PKGS[reader][2].node()
        giant.id = giant.name = "giant"
        giant.resources.cpu = 200_000
        giant.resources.memory_mb = 1 << 20
        back.register_node(giant)
        wait_until(lambda: placed_nodes(back, "big") == ["giant"],
                   "the restored blocked eval to place")
    finally:
        back.shutdown()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_torn_final_line_is_dropped(tmp_path, writer, reader):
    data = tmp_path / "data"
    srv = make_server(writer, data)
    srv.start()
    rng = np.random.default_rng(4)
    for i in range(3):
        srv.register_node(seeded_node(writer, rng, i))
    settle(srv)
    image = srv.store.to_snapshot_wire()
    crash_stop(srv)
    log = data / "wal.jsonl"
    whole = log.read_text()
    n_entries = len(whole.splitlines())
    with open(log, "a", encoding="utf-8") as fh:
        fh.write('{"i": 99, "s": 99, "op": "upsert_node", "a": {"ar')
    snap, entries = PKGS[reader][5](str(data)).load()
    assert snap is None and len(entries) == n_entries
    back = make_server(reader, data)
    assert back.store.to_snapshot_wire() == image
    back.shutdown()
    # A corrupt line that is not the last one is not a torn append.
    log.write_text('{"broken\n' + whole)
    with pytest.raises(ValueError):
        PKGS[reader][5](str(data)).load()


def test_apply_remote_follows_the_jax_log(tmp_path):
    """The follower seam: each entry of a log the JAX server wrote, applied
    to a port store through ``apply_remote``, lands in the port's own log
    with the leader's sequence, and the store ends at the leader's
    image."""
    data = tmp_path / "jax"
    jsrv = make_server(JAX, data)
    jsrv.start()
    workload(jsrv, JAX)
    image = jsrv.store.to_snapshot_wire()
    crash_stop(jsrv)
    _, entries = JWAL(str(data)).load()

    follower = TStateStore()
    follower.attach_wal(TWAL(str(tmp_path / "port")))
    for entry in entries:
        follower.apply_remote(entry)
    assert follower.to_snapshot_wire() == image
    assert follower.raft_peers == ["10.0.0.1:4647", "10.0.0.2:4647"]
    assert follower.wal.seq == entries[-1]["s"]
    _, mirrored = TWAL(str(tmp_path / "port")).load()
    assert mirrored == entries


# ---------------------------------------------------------------------------
# install_snapshot into a live port store, and the matrix it rebuilds
# ---------------------------------------------------------------------------


def test_install_snapshot_of_the_jax_image(tmp_path):
    jsrv = make_server(JAX, tmp_path / "jax")
    jsrv.start()
    workload(jsrv, JAX)
    image = jsrv.store.to_snapshot_wire()
    jsrv.shutdown()

    srv = make_server(PORT, tmp_path / "port")
    srv.start()
    try:
        rng = np.random.default_rng(9)
        for i in range(20):
            node = seeded_node(PORT, rng, i)
            node.id = node.name = f"other-{i:02d}"
            srv.register_node(node)
        settle(srv)
        before = srv.matrix.sync(device="cpu")
        uploads = srv.matrix.full_uploads
        srv.install_snapshot(image, seq=7)

        assert srv.store.to_snapshot_wire() == image
        assert srv.store.wal.seq == 7
        assert not srv.matrix._device_valid
        assert set(srv.matrix.row_of) == set(jsrv.store.nodes)
        ref = JStateStore(matrix=JNodeMatrix(capacity=32))
        ref.restore(image, [])
        host_arrays_equal(ref.matrix, srv.matrix)
        after = srv.matrix.sync(device="cpu")
        assert srv.matrix.full_uploads == uploads + 1
        assert all(a is not b for a, b in zip(after, before))
        host = srv.matrix.snapshot_host()
        for f, t in after._asdict().items():
            assert np.array_equal(t.numpy().view(host[f].dtype), host[f],
                                  equal_nan=host[f].dtype.kind == "f"), f
        # The installed image is what the snapshot on disk holds.
        snap, entries = TWAL(str(tmp_path / "port")).load()
        assert snap["wal_seq"] == 7 and entries == []
        # The installed cluster schedules: a new job places on its nodes.
        ev = srv.submit_job(seeded_job(PORT, "after", 2))
        assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
        assert set(placed_nodes(srv, "after")) <= set(jsrv.store.nodes)
        assert len(placed_nodes(srv, "after")) == 2
    finally:
        srv.shutdown()


def test_server_install_snapshot_quiesces_scheduling(tmp_path):
    """``Server.install_snapshot`` clears the matrix only once the server
    has stepped down and every worker has finished its eval, so no select
    holds rows that the rebuilt matrix gives to other nodes; leadership
    comes back after, and the image's open eval places."""
    src = make_server(PORT, tmp_path / "src")
    src.start()
    try:
        rng = np.random.default_rng(4)
        for i in range(6):
            src.register_node(seeded_node(PORT, rng, i))
        settle(src)
        src.eval_broker.set_enabled(False)  # the image holds an open eval
        open_ev = src.submit_job(seeded_job(PORT, "open", 2))
        image = src.store.to_snapshot_wire()
    finally:
        src.shutdown()

    srv = make_server(PORT, tmp_path / "dst", num_workers=4)
    srv.start()
    seen = {}
    install = srv.store.install_snapshot

    def watched(wire, seq):
        seen["leader"] = srv._leader
        seen["workers_alive"] = sum(
            w._thread.is_alive() for w in srv.workers)
        seen["inflight"] = srv.coalescer.inflight_depth()
        seen["queued"] = len(srv.coalescer._queue)
        install(wire, seq)

    srv.store.install_snapshot = watched
    try:
        rng = np.random.default_rng(5)
        for i in range(8):
            node = seeded_node(PORT, rng, i)
            node.id = node.name = f"other-{i:02d}"
            srv.register_node(node)
        for i in range(4):  # work in flight when the install starts
            srv.submit_job(seeded_job(PORT, f"busy-{i}", 1))
        srv.install_snapshot(image, seq=3)
        assert seen == {"leader": False, "workers_alive": 0, "inflight": 0,
                        "queued": 0}
        assert srv._leader
        assert all(w._thread.is_alive() for w in srv.workers)
        assert srv.wait_for_eval(open_ev.id, WAIT).status == "complete"
        assert len(placed_nodes(srv, "open")) == 2
        assert set(placed_nodes(srv, "open")) <= set(src.store.nodes)
    finally:
        srv.shutdown()


def test_dispatch_in_flight_across_a_clear_counts_stale():
    """A dispatch launched before ``NodeMatrix.clear()`` resolves after
    it: the version bump counts it stale, as after a growth."""
    from nomad_tpu_torch.state.matrix import NodeMatrix

    m = NodeMatrix(capacity=8, device="cpu")
    for i in range(4):
        m.upsert_node(tmock.node())
    coal = tcoalescer.DeviceCoalescer(m, max_lanes=2, device="cpu")

    def ticket():
        p = tcoalescer._Pending(
            request=None, delta_rows=None, delta_vals=None, tg_count=None,
            spread_counts=None, penalty=None, class_elig=None,
            host_mask=None)
        packed = torch.zeros((1, coal.scan_length, 8))
        return p, tcoalescer._Ticket(packed, None, [p], m.version)

    p, t = ticket()
    coal._resolve(t)
    assert p.error is None and p.outcome is not None
    assert coal.stale_dispatches == 0

    p, t = ticket()
    m.clear()
    coal._resolve(t)
    assert p.done.is_set()
    assert coal.stale_dispatches == 1


# ---------------------------------------------------------------------------
# kill -9 of a port server mid-workload
# ---------------------------------------------------------------------------

KILL9_CHILD = r"""
import sys, time
sys.path.insert(0, {repo!r})
from nomad_tpu_torch import mock
from nomad_tpu_torch.server.server import Server, ServerConfig

cfg = ServerConfig(num_workers=1, node_capacity=32, data_dir={data!r},
                   heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
srv = Server(cfg, device="cpu")
srv.start()
for i in range(4):
    srv.register_node(mock.node())
job = mock.job()
job.id = "kill9-job"
job.task_groups[0].count = 3
ev = srv.submit_job(job)
done = srv.wait_for_eval(ev.id, timeout=60)
assert done.status == "complete", done.status
for i in range(4):
    more = mock.job()
    more.id = "kill9-more-%d" % i
    more.task_groups[0].count = 1
    srv.submit_job(more)
print("READY", flush=True)
time.sleep(300)  # the parent SIGKILLs us here
"""


def test_kill9_mid_workload_recovers(tmp_path):
    data = str(tmp_path / "data")
    proc = subprocess.Popen(
        [sys.executable, "-c", KILL9_CHILD.format(repo=REPO, data=data)],
        stdout=subprocess.PIPE, text=True, cwd=REPO,
    )
    lines = queue.Queue()

    def read():
        for out in proc.stdout:
            lines.put(out)
        lines.put(None)  # end of the child's output

    threading.Thread(target=read, daemon=True).start()
    try:
        deadline = time.time() + 120
        line = ""
        while line is not None and "READY" not in line:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                raise AssertionError("the child printed no READY in 120 s")
        assert line is not None, "the child exited before READY"
    finally:
        proc.kill()  # SIGKILL: no atexit, no shutdown snapshot
        proc.wait(timeout=30)

    srv = make_server(PORT, data)
    assert srv.store.job_by_id("default", "kill9-job") is not None
    assert len(placed_nodes(srv, "kill9-job")) == 3
    assert len(srv.store.nodes) == 4
    assert {j for _, j in srv.store.jobs} >= {
        "kill9-job", *(f"kill9-more-{i}" for i in range(4))}
    evals = {e.job_id: e for e in srv.store.evals.values()}
    assert evals["kill9-job"].status == "complete"
    # The restarted server finishes what the killed one left open.
    srv.start()
    try:
        wait_until(lambda: all(
            len(placed_nodes(srv, f"kill9-more-{i}")) == 1 for i in range(4)),
            "the open evals to place after the restart")
        ev = srv.submit_job(tmock.job())
        assert srv.wait_for_eval(ev.id, WAIT).status == "complete"
    finally:
        srv.shutdown()
