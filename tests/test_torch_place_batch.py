"""The staged dispatch (``place_batch``, K2) of the port against the JAX
package's, on the CPU.

* The kernel entry: the JAX ``kernels.place_batch`` (jit on the CPU)
  against the port's ``place_batch`` on a CPU tensor (its plain version,
  ``place_lanes`` with every lane live), on seeded inputs carried across
  with ``state/carry.py``: the bench's eight shapes, the feature batch
  (preemption, ports, distinct_hosts, spreads, in-flight deltas with a
  row twice, tg counts, penalties), lanes that collide on a tiny cluster,
  and a pad lane with an all-False host mask.  The contract is the one of
  ``tests/test_fake_device.py``: rows, flags and counters exact; scores
  and binpack within rtol 1e-4, atol 1e-5.
* The staged server path: a burst under ``NOMAD_TPU_MEGABATCH=0`` in both
  packages places the same allocs per job, every alloc fits, and the
  port's coalescer launched only staged dispatches.
"""

import collections
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops import kernels as jk
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.state import NodeMatrix
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.server.server import Server, ServerConfig

import torch_edge_cases as edge_cases
from test_torch_score_batch import bench_cluster, bench_shapes, widened
from torch_parity import (
    jax_edge_pkg,
    SCAN,
    assert_packed_equal,
    build_cluster,
    compile_lanes,
    lane_jobs,
    lane_operands,
    port_matrix,
    port_requests,
    stack,
    t,
)

# One intra-op thread: these tests share the host's cores with the
# other test workers, whose timing tests a thread pool would starve.
torch.set_num_threads(1)


def run_both(m, pm, reqs, ops, f, scan=SCAN):
    """(port, reference) packed (B, P, 7) results on the same inputs."""
    arrays = m.sync()
    want = np.asarray(jk.place_batch(
        arrays, arrays.used, *ops[:5], reqs, *ops[5:],
        n_placements=scan, features=f,
    ))
    pa = pm.sync()
    ri, rf = port_requests(reqs)
    tk.reset_counts()
    got = tk.place_batch(
        pa, pa.used, t(ops[0]), t(ops[1]), t(ops[2]), t(ops[3]), t(ops[4]),
        ri, rf, t(ops[5]), t(ops[6]), scan, tk.Features(*f),
    ).numpy()
    assert tk.place_batch.launches == 0 and tk.place_lanes.calls == 1
    return got, want


@pytest.mark.parametrize("mode", ["full", "widened"])
def test_bench_shapes_match(mode):
    """B=16 lanes, lane i the bench's shape i mod 8, the bench's operands
    (no deltas, zero counts, every node allowed)."""
    m = bench_cluster()
    shapes = bench_shapes(m)
    b, n = 16, m.capacity
    reqs = stack([shapes[i % len(shapes)] for i in range(b)])
    ops = lane_operands(b, n, len(m.class_ids))
    f = jk.FULL_FEATURES if mode == "full" else widened(shapes)
    got, want = run_both(m, port_matrix(m), reqs, ops, f)
    assert got.shape == (b, SCAN, jk.PACKED_WIDTH)
    assert_packed_equal(got, want)
    assert (want[:, :, jk.PACKED_ROW] >= 0).all()


@pytest.fixture(scope="module")
def feature_world():
    m, nodes = build_cluster(seed=17)
    comp = compile_lanes(m, lane_jobs())
    return m, nodes, stack([c.request for c in comp]), port_matrix(m)


def test_feature_batch_matches(feature_world):
    """Preemption, ports, distinct_hosts, spreads and an infeasible ask,
    with in-flight deltas (one row twice), tg counts and penalties, and a
    last pad lane whose host mask is all False."""
    m, nodes, reqs, pm = feature_world
    b, n = reqs.ask.shape[0], m.capacity
    r3 = m.row_of[nodes[3].id]
    deltas = {1: [(r3, (500.0, 256.0, 0.0)), (r3, (100.0, 0.0, 0.0))],
              4: [(5, (1000.0, 1000.0, 0.0))],
              6: [(9, (200.0, 100.0, 0.0))]}
    ops = lane_operands(b, n, len(m.class_ids), deltas=deltas,
                        tg_counts={2: {7: 1}, 6: {8: 2}},
                        penalties={0: [1, 2], 5: [3]})
    ops[6][b - 1] = False  # the reference's padding lane
    got, want = run_both(m, pm, reqs, ops, jk.FULL_FEATURES)
    assert_packed_equal(got, want)
    pad = want[b - 1]
    assert (pad[:, jk.PACKED_ROW] == -1).all()
    assert (pad[:, jk.PACKED_EVALUATED] == 0).all()
    assert (pad[:, jk.PACKED_FILTERED] == np.asarray(m.sync().eligible).sum()).all()
    assert want[:, :, jk.PACKED_PREEMPT].any()
    assert (want[:, :, jk.PACKED_ROW] >= 0).sum() > b


def test_colliding_lanes_match():
    """Tiny cluster and fat asks: every lane picks the same nodes (there is
    no verify column; the applier sorts the collisions out)."""
    m = NodeMatrix(capacity=8)
    for _ in range(4):
        m.upsert_node(jmock.node())
    job = jmock.job()
    job.task_groups[0].tasks[0].resources.cpu = 1200
    job.task_groups[0].tasks[0].resources.memory_mb = 900
    req = RequestEncoder(m).compile(job, job.task_groups[0]).request
    b, scan = 8, 3
    reqs = stack([req] * b)
    ops = lane_operands(b, m.capacity, len(m.class_ids))
    got, want = run_both(m, port_matrix(m), reqs, ops,
                         jk.features_of(reqs), scan)
    assert_packed_equal(got, want)
    rows = want[:, :, jk.PACKED_ROW]
    assert (rows == rows[0]).all() and (rows[0] >= 0).all()


def test_place_batch_is_fused_place_with_every_lane_live(feature_world):
    """On the CPU both wrappers run the same plain scan: place_batch's
    output is fused_place's with an all-True lane mask."""
    m, _, reqs, pm = feature_world
    b, n = reqs.ask.shape[0], m.capacity
    ops = lane_operands(b, n, len(m.class_ids))
    pa = pm.sync()
    ri, rf = port_requests(reqs)
    args = (pa, pa.used, t(ops[0]), t(ops[1]), t(ops[2]), t(ops[3]),
            t(ops[4]), ri, rf, t(ops[5]), t(ops[6]))
    staged = tk.place_batch(*args, SCAN)
    fused = tk.fused_place(*args, torch.ones((b,), dtype=torch.bool), SCAN)
    assert torch.equal(staged, fused)


def test_place_batch_refuses_other_devices(feature_world):
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises."""
    m, _, reqs, pm = feature_world
    b, n = reqs.ask.shape[0], m.capacity
    ops = lane_operands(b, n, len(m.class_ids))
    pa = pm.sync()
    ri, rf = port_requests(reqs)
    with pytest.raises(ValueError, match="place_batch: unsupported device"):
        tk.place_batch(pa, pa.used.to("meta"), t(ops[0]), t(ops[1]),
                       t(ops[2]), t(ops[3]), t(ops[4]), ri, rf, t(ops[5]),
                       t(ops[6]), SCAN)


# ---------------------------------------------------------------------------
# The staged server path
# ---------------------------------------------------------------------------

N_NODES, N_JOBS, COUNT = 48, 16, 2


def staged_burst(srv, mock):
    for i in range(N_NODES):
        node = mock.node()
        node.id = node.name = f"node-{i:02d}"
        srv.register_node(node)
    evals = []
    for i in range(N_JOBS):
        job = mock.job()
        job.id = job.name = f"job-{i:02d}"
        tg = job.task_groups[0]
        tg.count = COUNT
        tg.tasks[0].resources.cpu = 300 + 100 * (i % 4)
        tg.tasks[0].resources.memory_mb = 256 + 128 * (i % 3)
        evals.append(srv.submit_job(job))
    deadline = time.time() + 60.0
    for ev in evals:
        while not srv.store.eval_by_id(ev.id).terminal_status():
            assert time.time() < deadline, "burst did not finish"
            time.sleep(0.02)
    allocs = [a for a in srv.store.allocs.values() if not a.terminal_status()]
    host = srv.matrix.snapshot_host()
    fits = all(
        srv.store.node_by_id(a.node_id) is not None
        and np.all(host["used"][srv.matrix.row_of[a.node_id]]
                   <= host["totals"][srv.matrix.row_of[a.node_id]])
        for a in allocs)
    return dict(
        per_job=sorted(collections.Counter(a.job_id for a in allocs).items()),
        fits=fits,
        statuses=sorted({srv.store.eval_by_id(e.id).status for e in evals}),
        fused=srv.coalescer.fused_dispatches,
        dispatches=srv.coalescer.dispatches,
        megabatch=srv.coalescer.megabatch,
    )


@pytest.fixture(scope="module")
def staged_runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_MEGABATCH", "0")
    try:
        ref = JServer(JServerConfig(
            num_workers=4, node_capacity=64, heartbeat_min_ttl=3600.0,
            heartbeat_max_ttl=7200.0, slo_enabled=False,
            overload_enabled=False))
        ref.start()
        try:
            want = staged_burst(ref, jmock)
        finally:
            ref.shutdown()
        tk.reset_counts()
        srv = Server(ServerConfig(num_workers=4, node_capacity=64,
                                  heartbeat_min_ttl=3600.0,
                                  heartbeat_max_ttl=7200.0), device="cpu")
        srv.start()
        try:
            got = staged_burst(srv, tmock)
        finally:
            srv.shutdown()
        got["counts"] = (tk.place_batch.launches, tk.fused_place.launches,
                         tk.allocs_fit_verify.launches,
                         tk.verify_lanes.calls, tk.place_lanes.calls)
    finally:
        mp.undo()
    return want, got


def test_staged_burst_places_every_job(staged_runs):
    _, got = staged_runs
    assert got["megabatch"] is False
    assert got["per_job"] == [(f"job-{i:02d}", COUNT) for i in range(N_JOBS)]
    assert got["fits"] and got["statuses"] == ["complete"]
    assert got["fused"] == 0 and got["dispatches"] > 0
    staged, fused, verify, verify_plain, plain = got["counts"]
    # CPU tensors: the plain scan ran once per dispatch, no kernel, no
    # verify column.
    assert (staged, fused, verify, verify_plain) == (0, 0, 0, 0)
    assert plain == got["dispatches"]


def test_staged_burst_matches_reference(staged_runs):
    want, got = staged_runs
    assert want["megabatch"] is False and want["fused"] == 0
    assert got["per_job"] == want["per_job"]
    assert got["fits"] and want["fits"]


@pytest.mark.parametrize("case", edge_cases.CASES)
def test_edge_shapes_match(case):
    """The staged dispatch at full features (as the staged path runs it) on
    each edge case of tests/torch_edge_cases.py; a dead lane of the case
    becomes a padding lane with an all-False host mask."""
    w = edge_cases.build(jax_edge_pkg(), case)
    hm = w["hm"].copy()
    hm[~w["lane_mask"]] = False
    ops = (w["drows"], w["dvals"], w["tg"], w["counts"], w["pen"], w["ce"],
           hm)
    got, want = run_both(w["m"], port_matrix(w["m"]), w["reqs"], ops,
                         jk.FULL_FEATURES, w["scan"])
    assert_packed_equal(got, want)
    if case == "ties":
        np.testing.assert_array_equal(want[:3, 0, jk.PACKED_ROW], [0, 140, 257])
