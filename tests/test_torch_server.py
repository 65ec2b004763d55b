"""The port's server against the JAX package's, end to end on the CPU.

Both servers run one worker and get the same fixed-id nodes and the same
jobs, one eval at a time; every placement must land on the same node.  The
job mix covers the coalesced fused path (plain, constrained, affinity,
spread) and the solo path: a distinct_hosts group of 56 whose fourth
select carries more than 32 plan deltas, so it runs ``fused_place`` at
B=1 over the dense proposed usage.
"""

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.structs import types as jtypes
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import types as ttypes

# One intra-op thread: these tests share the host's cores with the
# other test workers, whose timing tests a thread pool would starve.
torch.set_num_threads(1)

N_NODES = 64


def nodes(mock, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_NODES):
        node = mock.node()
        node.id = f"node-{i:03d}"
        node.name = node.id
        node.node_class = f"class-{i % 3}"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 4}"
        node.resources.cpu = int(rng.integers(3000, 9000))
        node.resources.memory_mb = int(rng.integers(4096, 16384))
        out.append(node)
    return out


def jobs(mock, types):
    out = []
    for i in range(10):
        job = mock.job()
        job.id = job.name = f"job-{i}"
        tg = job.task_groups[0]
        tg.count = 2 + i % 3
        tg.tasks[0].resources.cpu = 200 + 150 * (i % 4)
        tg.tasks[0].resources.memory_mb = 128 + 96 * (i % 3)
        if i % 4 == 1:
            tg.affinities = [types.Affinity(
                l_target="${attr.rack}", r_target="r2", operand="=",
                weight=60)]
        if i % 4 == 2:
            tg.spreads = [types.Spread(attribute="${attr.rack}", weight=50)]
        if i % 4 == 3:
            tg.constraints = [types.Constraint(
                l_target="${node.class}", r_target="class-1", operand="!=")]
        out.append(job)
    wide = mock.job()
    wide.id = wide.name = "job-wide"
    wide.task_groups[0].count = 56
    wide.task_groups[0].tasks[0].resources.cpu = 100
    wide.task_groups[0].tasks[0].resources.memory_mb = 64
    wide.task_groups[0].constraints = [types.Constraint(operand="distinct_hosts")]
    out.append(wide)
    return out


def drive(srv, mock, types):
    for node in nodes(mock):
        srv.register_node(node)
    statuses = []
    for job in jobs(mock, types):
        ev = srv.submit_job(job)
        done = srv.wait_for_eval(ev.id, timeout=120.0)
        statuses.append(done.status)
    placed = {
        (a.job_id, a.name): a.node_id
        for a in srv.store.allocs.values() if not a.terminal_status()
    }
    return statuses, placed


@pytest.fixture(scope="module")
def reference():
    srv = JServer(JServerConfig(
        num_workers=1, node_capacity=N_NODES, heartbeat_min_ttl=3600.0,
        heartbeat_max_ttl=7200.0, slo_enabled=False, overload_enabled=False,
    ))
    srv.start()
    try:
        return drive(srv, jmock, jtypes)
    finally:
        srv.shutdown()


def test_same_allocations_on_same_nodes(reference):
    tk.reset_counts()
    srv = Server(ServerConfig(num_workers=1, node_capacity=N_NODES),
                 device="cpu")
    srv.start()
    try:
        statuses, placed = drive(srv, tmock, ttypes)
        solo = srv.coalescer.solo_ops
    finally:
        srv.shutdown()
    want_statuses, want = reference
    assert statuses == want_statuses
    assert set(statuses) == {"complete"}
    assert len(placed) == sum(j.task_groups[0].count for j in jobs(tmock, ttypes))
    assert placed == want
    assert solo > 0, "no eval took the solo path"
    # On the CPU every dispatch ran the plain version, never a kernel.
    assert tk.place_lanes.calls > 0
    assert tk.fused_place.launches == 0
    assert tk.allocs_fit_verify.launches == 0


def test_concurrent_burst_keeps_capacity():
    """Eight workers racing through the coalescer on a small cluster: every
    eval reaches a terminal status, every completed eval has all its
    allocations, and no node ends over capacity.  Picks that collide are
    the applier's to reject (optimistic concurrency, as in the reference):
    under this contention an eval may exhaust its plan attempts and fail,
    which is the reference's behaviour too."""
    srv = Server(ServerConfig(num_workers=8, node_capacity=N_NODES,
                              coalescer_lanes=8), device="cpu")
    srv.start()
    try:
        for node in nodes(tmock):
            srv.register_node(node)
        evs = []
        for i in range(24):
            job = tmock.job()
            job.task_groups[0].count = 3
            evs.append(srv.submit_job(job))
        done = [srv.wait_for_eval(e.id, timeout=120.0) for e in evs]
        host = srv.matrix.snapshot_host()
        per_job = {}
        for a in srv.store.allocs.values():
            if not a.terminal_status():
                per_job[a.job_id] = per_job.get(a.job_id, 0) + 1
    finally:
        srv.shutdown()
    assert all(d.terminal_status() for d in done)
    complete = [d for d in done if d.status == "complete"]
    assert complete
    assert all(per_job.get(d.job_id) == 3 for d in complete)
    assert np.all(host["used"] <= host["totals"])
    assert srv.coalescer.fused_lanes > srv.coalescer.fused_dispatches
