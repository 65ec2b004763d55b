"""Shared inputs for the port-vs-reference parity tests (test_torch_*.py).

Builds seeded clusters and request mixes with the JAX package, and hands
them to the port as plain numpy through ``nomad_tpu_torch.state.carry``.
Sizes stay small (≤ 256 nodes, ≤ 8 lanes, ≤ 4 placements) so the suite
runs in seconds on the CPU.
"""

import numpy as np
import torch

from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops.encode import MAX_SPREADS, MAX_SPREAD_VALUES
from nomad_tpu.state import NodeMatrix
from nomad_tpu.structs import (
    Affinity,
    Allocation,
    Constraint,
    DriverInfo,
    Job,
    NetworkResource,
    Node,
    NodeResources,
    Resources,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
)
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.state import carry

SCAN = 4
# Parity contract (the one tests/test_fake_device.py holds the numpy twin
# to): rows, preemption flags, counters and VERIFIED exact; scores and
# binpack within these.
RTOL, ATOL = 1e-4, 1e-5


def make_node(rng, i, dc=None):
    attrs = {
        "rack": f"r{i % 8}",
        "kernel.name": "linux" if i % 5 else "darwin",
        "os.version": f"{1 + i % 3}.{i % 4}.0",
    }
    if i % 7:  # some nodes lack the attribute (missing-attr rules)
        attrs["cpu.numcores"] = str(int(rng.integers(2, 64)))
    if i % 11 == 0:  # unparseable numeric → NaN column
        attrs["cpu.numcores"] = "many"
    return Node(
        datacenter=dc or ("dc1" if i % 3 else "dc2"),
        node_class=f"class-{i % 4}",
        attributes=attrs,
        resources=NodeResources(
            cpu=int(rng.integers(2000, 8000)),
            memory_mb=int(rng.integers(2048, 16384)),
            disk_mb=100 * 1024,
        ),
        drivers={"mock": DriverInfo()},
    )


def make_job(cpu=500, mem=256, count=1, constraints=None, affinities=None,
             spreads=None, networks=None, **kw):
    tg = TaskGroup(
        name="web",
        count=count,
        tasks=[Task(resources=Resources(cpu=cpu, memory_mb=mem,
                                        networks=networks or []))],
        constraints=constraints or [],
        affinities=affinities or [],
        spreads=spreads or [],
    )
    return Job(task_groups=[tg], **kw)


def build_cluster(seed=7, n_nodes=200, capacity=256, n_allocs=80):
    """A seeded reference matrix: heterogeneous nodes, existing allocs at
    several priorities (prio_used), and a few occupied static ports."""
    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=capacity)
    nodes = [make_node(rng, i) for i in range(n_nodes)]
    for node in nodes:
        m.upsert_node(node)
    for i in rng.choice(n_nodes, size=n_allocs, replace=False):
        nets = []
        if i % 4 == 0:
            nets = [NetworkResource(reserved_ports=[8080])]
        m.add_alloc(Allocation(
            node_id=nodes[i].id,
            job=Job(priority=int(rng.integers(10, 90))),
            resources=Resources(
                cpu=int(rng.integers(100, 2500)),
                memory_mb=int(rng.integers(64, 4096)),
                networks=nets,
            ),
        ))
    return m, nodes


def lane_jobs():
    """(job, algorithm, preemption) covering every scoring stage."""
    rank = [SpreadTarget(value="r1", percent=50),
            SpreadTarget(value="r2", percent=25)]
    return [
        (make_job(cpu=400, mem=300), "binpack", False),
        (make_job(cpu=700, mem=512, count=SCAN), "spread", False),
        (make_job(cpu=300, mem=256, constraints=[
            Constraint(l_target="${attr.kernel.name}", operand="=",
                       r_target="linux"),
            Constraint(l_target="${attr.cpu.numcores}", operand=">=",
                       r_target="16"),
            Constraint(l_target="${attr.os.version}", operand="version",
                       r_target=">= 2.1"),
        ]), "binpack", False),
        (make_job(cpu=200, mem=128, constraints=[
            Constraint(l_target="${attr.cpu.numcores}", operand="!=",
                       r_target="8"),
        ], affinities=[
            Affinity(l_target="${attr.rack}", operand="=", r_target="r3",
                     weight=80),
            Affinity(l_target="${attr.kernel.name}", operand="=",
                     r_target="darwin", weight=-40),
        ]), "binpack", False),
        (make_job(cpu=250, mem=200, count=SCAN, spreads=[
            Spread(attribute="${attr.rack}", weight=70),
            Spread(attribute="${node.datacenter}", weight=30, targets=rank),
        ]), "binpack", False),
        (make_job(cpu=3500, mem=6000, priority=90), "binpack", True),
        (make_job(cpu=300, mem=256, count=SCAN, networks=[
            NetworkResource(reserved_ports=[8080], dynamic_ports=["http"]),
        ], constraints=[
            Constraint(operand="distinct_hosts"),
        ]), "binpack", False),
        (make_job(cpu=100000, mem=100), "binpack", False),  # never fits
    ]


def compile_lanes(m, jobs):
    enc = RequestEncoder(m)
    return [enc.compile(j, j.task_groups[0], algorithm=alg,
                        preemption_enabled=pre) for j, alg, pre in jobs]


def stack(reqs):
    return type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])


def lane_operands(b, n, n_classes, deltas=None, tg_counts=None,
                  penalties=None, max_deltas=4):
    drows = np.full((b, max_deltas), -1, np.int32)
    dvals = np.zeros((b, max_deltas, 3), np.float32)
    for lane, items in (deltas or {}).items():
        for j, (row, vals) in enumerate(items):
            drows[lane, j] = row
            dvals[lane, j] = vals
    tg = np.zeros((b, n), np.int32)
    for lane, counts in (tg_counts or {}).items():
        for row, c in counts.items():
            tg[lane, row] = c
    pen = np.zeros((b, n), bool)
    for lane, rows in (penalties or {}).items():
        pen[lane, list(rows)] = True
    sc = np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32)
    ce = np.ones((b, max(2, n_classes)), bool)
    hm = np.ones((b, n), bool)
    return drows, dvals, tg, sc, pen, ce, hm


def port_matrix(m):
    """The reference matrix carried into the port, on the CPU."""
    return carry.matrix_from_host(
        m.snapshot_host(), m.attrs.slot_of, m.class_ids, m.row_of, "cpu",
        class_repr=m.class_repr, dev_slots=m.devices.slot_of,
    )


def port_requests(reqs_np):
    ri, rf = tk.pack_requests(reqs_np)
    return torch.from_numpy(ri), torch.from_numpy(rf)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_packed_equal(got, want, cols=None):
    """Exact rows/flags/counters/VERIFIED; scores and binpack in tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    exact = [0, 3, 4, 5, 6] + ([7] if want.shape[-1] == 8 else [])
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=RTOL,
                               atol=ATOL)
