"""The port's plan verify (``verify_plan_fit``) against the JAX package's.

The applier's AllocsFit re-check, per plan row: ``used + delta <=
totals`` on all three dimensions and the node eligible where the row
places new allocations; padding rows (-1) pass.  The port's plain
version, the JAX jit and the port applier's numpy twin
(``server/plan_apply.py:host_verify``) must agree on every row.  The
hand-written kernel is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nomad_tpu.ops import kernels as jk
from nomad_tpu.state import NodeMatrix
from nomad_tpu.structs import (
    Allocation,
    DriverInfo,
    Job,
    Node,
    NodeResources,
    Resources,
)
from nomad_tpu_torch import mock
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.server import plan_apply
from nomad_tpu_torch.server.server import Server, ServerConfig

from torch_parity import build_cluster, port_matrix, t

torch.set_num_threads(1)


def make_node(cpu, mem):
    return Node(
        resources=NodeResources(cpu=cpu, memory_mb=mem, disk_mb=100 * 1024),
        drivers={"mock": DriverInfo()},
    )


def setup(nodes):
    m = NodeMatrix(capacity=max(16, len(nodes)))
    for n in nodes:
        m.upsert_node(n)
    return m


def three_ways(m, rows, deltas, elig_required):
    """(JAX, port plain, port host_verify) verdicts on one matrix."""
    rows = np.asarray(rows, np.int32)
    deltas = np.asarray(deltas, np.float32)
    elig_required = np.asarray(elig_required, bool)
    want = np.asarray(jk.verify_plan_fit(
        m.sync(), jnp.asarray(rows), jnp.asarray(deltas),
        jnp.asarray(elig_required)))
    before = tk.verify_plan_fit_plain.calls
    got = tk.verify_plan_fit(port_matrix(m).sync(), t(rows), t(deltas),
                             t(elig_required))
    assert tk.verify_plan_fit_plain.calls == before + 1
    assert got.dtype == torch.bool and got.shape == rows.shape
    host = host_verify_on(m, rows, deltas, elig_required)
    return want, got.numpy(), host


def host_verify_on(m, rows, deltas, elig_required):
    return plan_apply.host_verify(m.snapshot_host(), rows, list(deltas),
                                  elig_required)


def test_reference_case():
    """tests/test_kernels.py TestVerifyPlanFit.test_verify: an overfull
    node, a node with room, a padding row."""
    n1 = make_node(cpu=1000, mem=1024)
    n2 = make_node(cpu=4000, mem=8192)
    m = setup([n1, n2])
    m.add_alloc(Allocation(node_id=n1.id, job=Job(),
                           resources=Resources(cpu=800, memory_mb=100)))
    rows = [m.row_of[n1.id], m.row_of[n2.id], -1]
    deltas = [[500.0, 10.0, 0.0], [500.0, 10.0, 0.0], [0, 0, 0]]
    want, got, host = three_ways(m, rows, deltas, [True, True, True])
    np.testing.assert_array_equal(want, [False, True, True])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host, want)


def test_reference_host_twin_case():
    """tests/test_kernels.py TestVerifyPlanFit.test_host_twin_matches_kernel:
    twelve nodes, half with allocs, one ineligible, random deltas and a
    random eligible_required."""
    rng = np.random.default_rng(3)
    nodes = [make_node(cpu=int(c), mem=int(mm))
             for c, mm in rng.integers(500, 8000, (12, 2))]
    m = setup(nodes)
    for n in nodes[:6]:
        m.add_alloc(Allocation(node_id=n.id, job=Job(), resources=Resources(
            cpu=int(rng.integers(100, 2000)),
            memory_mb=int(rng.integers(100, 2000)))))
    m.snapshot_host()["eligible"][3] = False
    m._dirty.add(3)
    k = 12
    rows = np.arange(k, dtype=np.int32)
    deltas = rng.uniform(0, 4000, (k, 3)).astype(np.float32)
    elig_required = rng.random(k) < 0.5
    want, got, host = three_ways(m, rows, deltas, elig_required)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_plan_with_padding(seed):
    """A 200-node cluster with existing allocs, 300 plan rows: padding,
    repeated rows, overfull deltas, negative deltas (in-place shrink),
    ineligible nodes and a mixed eligible_required."""
    rng = np.random.default_rng(seed)
    m, _ = build_cluster(seed=seed + 20)
    host = m.snapshot_host()
    ineligible = rng.choice(200, 30, replace=False)
    host["eligible"][ineligible] = False
    m._dirty.update(int(r) for r in ineligible)
    k = 300
    rows = rng.integers(0, 200, k).astype(np.int32)
    rows[rng.random(k) < 0.1] = -1
    room = host["totals"][np.maximum(rows, 0)] - host["used"][np.maximum(rows, 0)]
    deltas = (room * rng.uniform(0.2, 1.4, (k, 3))).astype(np.float32)
    deltas[rng.random(k) < 0.1] *= -1.0
    exact = rng.random(k) < 0.05  # lands exactly on the capacity
    deltas[exact] = room[exact]
    elig_required = rng.random(k) < 0.6
    want, got, hv = three_ways(m, rows, deltas, elig_required)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hv, want)
    assert want[rows < 0].all()
    live = rows >= 0
    assert want[live].any() and not want[live].all()
    # Every cause of a refusal occurs: too big, and ineligible with room.
    fits = np.all(host["used"][np.maximum(rows, 0)] + deltas
                  <= host["totals"][np.maximum(rows, 0)], axis=1)
    assert (live & ~fits).any()
    assert (live & fits & elig_required & ~host["eligible"][np.maximum(rows, 0)]).any()


def test_row_past_the_matrix_reads_its_last_row():
    """JAX's gather clamps an out-of-range row to the last one; the port's
    plain version (and kernel) do the same."""
    m = setup([make_node(cpu=1000 + 100 * i, mem=2048) for i in range(16)])
    rows = np.array([15, 16, 99], np.int32)
    deltas = np.full((3, 3), 1050.0, np.float32)
    want, got, _ = three_ways(m, rows, deltas, [False] * 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, [True, True, True])


def test_applier_host_verify_matches_plain(monkeypatch):
    """The port applier's own calls: every (rows, deltas, elig_required) it
    checks while a CPU server places jobs, held against the plain version
    on the host mirror it read."""
    calls = []
    real = plan_apply.host_verify

    def record(host, rows, deltas, elig_required):
        out = real(host, rows, deltas, elig_required)
        calls.append(dict(
            used=np.array(host["used"]), totals=np.array(host["totals"]),
            eligible=np.array(host["eligible"]),
            rows=np.asarray(rows, np.int32), deltas=np.stack(deltas),
            elig_required=np.asarray(elig_required, bool), verdicts=out))
        return out

    monkeypatch.setattr(plan_apply, "host_verify", record)
    srv = Server(ServerConfig(num_workers=2, node_capacity=64), device="cpu")
    srv.start()
    try:
        for i in range(20):
            node = mock.node()
            node.resources.cpu = 1500 + 250 * (i % 5)
            srv.register_node(node)
        evals = []
        for i in range(4):
            job = mock.job()
            job.task_groups[0].count = 6
            evals.append(srv.submit_job(job))
        for ev in evals:
            assert srv.wait_for_eval(ev.id, 60.0).status == "complete"
    finally:
        srv.shutdown()
    assert calls, "the applier never verified a plan"
    assert sum(len(c["rows"]) for c in calls) >= 4
    for c in calls:
        arrays = types.SimpleNamespace(
            used=t(c["used"]), totals=t(c["totals"]), eligible=t(c["eligible"]))
        got = tk.verify_plan_fit(arrays, t(c["rows"]), t(c["deltas"]),
                                 t(c["elig_required"]))
        np.testing.assert_array_equal(got.numpy(), c["verdicts"])


def test_wrapper_refuses_other_devices():
    arrays = types.SimpleNamespace(
        used=torch.empty((16, 3), device="meta"),
        totals=torch.empty((16, 3), device="meta"),
        eligible=torch.empty((16,), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        tk.verify_plan_fit(arrays, torch.empty((2,), dtype=torch.int32,
                                               device="meta"),
                           torch.empty((2, 3), device="meta"),
                           torch.empty((2,), dtype=torch.bool, device="meta"))
