"""The node-sharded dispatch (K9) of the port against the JAX package's,
on the CPU.

The port shards over ``["cpu"] * n`` (virtual shards, its counterpart of
the reference's eight virtual CPU devices, the ``eight_devices``
fixture); both packages get the same seeded inputs carried across with
``state/carry.py``.  Contract: rows, counters, preemption flags and
VERIFIED exact; scores and binpack within rtol 1e-4 / atol 1e-5.

* ``sharded_place_batch`` against JAX's on the same mesh shape, on the
  world batch and on ``torch_edge_cases.SHARDED_CASES`` (what the card's
  hoisted scan over shards must get right).
* ``sharded_fused_place_batch`` against JAX's unsharded
  ``fused_place_batch`` (the JAX sharded fused program does not trace on
  this JAX, ROADMAP R1), with colliding lanes so VERIFIED 0.0 appears.
* ``sharded_schedule_step`` against JAX's on inputs with no tie, and a
  constructed tie that the port gives to the lowest row (the reference's
  step gives it to the highest, R8).
* The port's sharded programs against its own unsharded ones, bit for
  bit, and the kernel wrapper's plain version through the shard loop;
  the step's usage update (``sharded_usage``) on one shard's window.
* A live server sharded over eight virtual CPU shards against the JAX
  server on one device, and ``dryrun_multichip`` in a fresh process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nomad_tpu import mock as jmock
from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops import kernels as jk
from nomad_tpu.parallel import make_mesh as jmake_mesh
from nomad_tpu.parallel import shard_matrix_arrays as jshard
from nomad_tpu.parallel import sharded_place_batch as jsharded_place_batch
from nomad_tpu.parallel import sharded_schedule_step as jsharded_step
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.state import NodeMatrix
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.parallel import sharding as tsh
from nomad_tpu_torch.server.server import Server, ServerConfig

import torch_edge_cases as edge_cases
from torch_parity import (
    ATOL,
    RTOL,
    SCAN,
    assert_packed_equal,
    build_cluster,
    compile_lanes,
    jax_edge_pkg,
    lane_jobs,
    lane_operands,
    port_matrix,
    port_requests,
    stack,
    t,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (devices, batch): both axes, and a node axis of 4 and 8.
MESHES = [(4, 1), (4, 2), (8, 1), (8, 2)]


@pytest.fixture(scope="module")
def world():
    m, nodes = build_cluster(seed=23)
    comp = compile_lanes(m, lane_jobs())
    reqs = stack([c.request for c in comp])
    b, n = reqs.ask.shape[0], m.capacity
    r3 = m.row_of[nodes[3].id]
    # In-flight deltas (one row twice, one on the last shard), tg counts
    # and penalties.
    deltas = {1: [(r3, (500.0, 256.0, 0.0)), (r3, (100.0, 0.0, 0.0))],
              4: [(5, (1000.0, 1000.0, 0.0))],
              6: [(250, (200.0, 100.0, 0.0))]}
    ops = lane_operands(b, n, len(m.class_ids), deltas=deltas,
                        tg_counts={2: {7: 1}, 6: {8: 2}},
                        penalties={0: [1, 2], 5: [3]})
    return dict(m=m, nodes=nodes, reqs=reqs, ops=ops, pm=port_matrix(m))


def port_mesh(n, batch):
    return tsh.make_mesh(n, batch=batch, devices=["cpu"] * n)


def port_operands(world):
    ri, rf = port_requests(world["reqs"])
    return ri.numpy(), rf.numpy()


@pytest.mark.parametrize("n_dev,batch", MESHES)
def test_sharded_place_batch_matches_jax(world, eight_devices, n_dev, batch):
    m, reqs, ops = world["m"], world["reqs"], world["ops"]
    arrays = m.sync()
    jmesh = jmake_mesh(n_dev, batch=batch)
    jreqs = jax.tree_util.tree_map(jnp.asarray, reqs)
    want = np.asarray(jsharded_place_batch(jmesh, SCAN)(
        jshard(jmesh, arrays), jshard(jmesh, arrays).used, *ops[:5], jreqs,
        *ops[5:]))

    mesh = port_mesh(n_dev, batch)
    sharded = tsh.shard_matrix_arrays(mesh, world["pm"].sync())
    ri, rf = port_operands(world)
    tk.reset_counts()
    got = tsh.sharded_place_batch(mesh, SCAN)(
        sharded, *ops[:5], ri, rf, *ops[5:]).numpy()
    assert tk.sharded_place.launches == 0
    assert tk.sharded_place_plain.calls == batch
    assert_packed_equal(got, want)
    assert (want[:, :, jk.PACKED_ROW] >= 0).sum() > reqs.ask.shape[0]


@pytest.mark.parametrize("n_dev,batch", [(4, 2), (8, 1)])
@pytest.mark.parametrize("case", edge_cases.SHARDED_CASES)
def test_sharded_edge_cases_match_jax(eight_devices, case, n_dev, batch):
    """Each case of torch_edge_cases.SHARDED_CASES: the port's staged
    sharded program (the plain version through the shard loop) against
    JAX's and against the port's unsharded ``place_batch`` (rows and
    counters exact: on the CPU the plain version's exp2 may round a shard's
    rows apart from the whole axis's in the last bit); and the case holds
    what it is there for."""
    w = edge_cases.sharded_case(jax_edge_pkg(), case)
    m, reqs, scan = w["m"], w["reqs"], w["scan"]
    ops = (w["drows"], w["dvals"], w["tg"], w["counts"], w["pen"], w["ce"],
           w["hm"])
    arrays = m.sync()
    jmesh = jmake_mesh(n_dev, batch=batch)
    want = np.asarray(jsharded_place_batch(jmesh, scan)(
        jshard(jmesh, arrays), jshard(jmesh, arrays).used, *ops[:5],
        jax.tree_util.tree_map(jnp.asarray, reqs), *ops[5:]))
    pa = port_matrix(m).sync()
    mesh = port_mesh(n_dev, batch)
    ri, rf = port_requests(reqs)
    tk.reset_counts()
    got = tsh.sharded_place_batch(mesh, scan)(
        tsh.shard_matrix_arrays(mesh, pa), *ops[:5], ri.numpy(), rf.numpy(),
        *ops[5:])
    assert tk.sharded_place_plain.calls == batch
    assert_packed_equal(got.numpy(), want)
    assert_packed_equal(got.numpy(), tk.place_batch(
        pa, pa.used, *(t(x) for x in ops[:5]), ri, rf, t(ops[5]), t(ops[6]),
        scan).numpy())
    rows = want[:, :, jk.PACKED_ROW].astype(int)
    n_local = edge_cases.SHARDED_ROWS // mesh.shape[1]
    if case == "spread_mid_scan":
        # A rack new to a lane's table enters after step 0, from a winner
        # on another shard than an earlier pick's.
        racks = [[edge_cases.sharded_rack(r) for r in lane] for lane in rows]
        assert any(racks[0][t] not in racks[0][:t] + ["r0", "r5"]
                   and rows[0][t] // n_local != rows[0][0] // n_local
                   for t in range(1, scan))
    elif case == "distinct_hosts":
        for lane in range(6):
            picked = rows[lane][rows[lane] >= 0]
            assert len(set(picked)) == len(picked)
        assert len({r // n_local for r in rows[:6].ravel() if r >= 0}) > 1
    elif case == "cross_shard_tie":
        assert rows[0, 0] == 37 and rows[4, 0] == 24 and rows[6, 0] == 50
    elif case == "empty_shard":
        assert (rows[5] == -1).all() and (rows[7] == -1).all()
        assert (rows[6] >= 175).all()
        assert not ((rows >= 50) & (rows < 125)).any()
    elif case == "delta_cap":
        assert w["drows"].shape[1] == tk.MAX_LANE_DELTAS
    assert (rows >= 0).sum() > scan


def collision_world():
    """A tiny cluster with fat asks: later lanes collide with earlier
    winners (VERIFIED 0.0), one lane is dead."""
    m = NodeMatrix(capacity=16)
    for _ in range(6):
        m.upsert_node(jmock.node())
    job = jmock.job()
    job.task_groups[0].tasks[0].resources.cpu = 1200
    job.task_groups[0].tasks[0].resources.memory_mb = 900
    req = RequestEncoder(m).compile(job, job.task_groups[0]).request
    reqs = stack([req] * 8)
    ops = lane_operands(8, m.capacity, len(m.class_ids))
    lm = np.ones((8,), bool)
    lm[5] = False
    return m, reqs, ops, lm


@pytest.mark.parametrize("n_dev,batch", MESHES)
def test_sharded_fused_matches_jax_unsharded(world, n_dev, batch):
    """The feature batch (a dead lane) and the collision batch, each
    against JAX's unsharded fused program."""
    m, reqs, ops = world["m"], world["reqs"], world["ops"]
    b = reqs.ask.shape[0]
    lm = np.ones((b,), bool)
    lm[b - 1] = False
    cases = [(m, world["pm"], reqs, ops, lm, SCAN)]
    cm, creqs, cops, clm = collision_world()
    cases.append((cm, port_matrix(cm), creqs, cops, clm, 2))
    zeros = 0
    for jm, pm, rq, op, mask, scan in cases:
        arrays = jm.sync()
        f = jk.features_of(rq)
        want = np.asarray(jk.fused_place_batch(
            arrays, arrays.used, *op[:5], rq, *op[5:], mask,
            n_placements=scan, features=f))
        mesh = port_mesh(n_dev, batch)
        sharded = tsh.shard_matrix_arrays(mesh, pm.sync())
        ri, rf = port_requests(rq)
        got = tsh.sharded_fused_place_batch(mesh, scan)(
            sharded, *op[:5], ri.numpy(), rf.numpy(), *op[5:], mask,
            features=tk.Features(*f)).numpy()
        assert_packed_equal(got, want)
        assert (want[~mask, :, jk.FUSED_PACKED_VERIFIED] == -1.0).all()
        zeros += int(((want[..., jk.FUSED_PACKED_VERIFIED] == 0.0)
                      & (want[..., jk.PACKED_ROW] >= 0)).sum())
    assert zeros > 0


def jax_step(m, reqs, ops, n_dev, batch):
    arrays = m.sync()
    jmesh = jmake_mesh(n_dev, batch=batch)
    sharded = jshard(jmesh, arrays)
    jreqs = jax.tree_util.tree_map(jnp.asarray, reqs)
    out = jsharded_step(jmesh)(sharded, sharded.used, ops[2], ops[3], ops[4],
                               jreqs, ops[5], ops[6])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("n_dev,batch", MESHES)
def test_sharded_schedule_step_matches_jax(world, eight_devices, n_dev,
                                           batch):
    """No tie on these inputs (checked): rows, scores, preemption, the
    evaluated count and the usage after every pick."""
    m, reqs, ops, pm = world["m"], world["reqs"], world["ops"], world["pm"]
    arrays = m.sync()
    res = jk.score_nodes(
        arrays, arrays.used, ops[2][0], ops[3][0], ops[4][0],
        jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), reqs),
        ops[5][0], ops[6][0])
    final = np.asarray(res.final)
    assert (final == final.max()).sum() == 1, "the seeded lane 0 has a tie"
    rows, scores, pre, evaluated, used_after = jax_step(m, reqs, ops, n_dev,
                                                        batch)
    mesh = port_mesh(n_dev, batch)
    sharded = tsh.shard_matrix_arrays(mesh, pm.sync())
    ri, rf = port_operands(world)
    got, got_used = tsh.sharded_schedule_step(mesh)(sharded, *ops[2:5], ri, rf,
                                                    *ops[5:])
    np.testing.assert_array_equal(got.rows.numpy(), rows)
    np.testing.assert_array_equal(got.preempted.numpy(), pre)
    np.testing.assert_array_equal(got.nodes_evaluated.numpy(), evaluated)
    np.testing.assert_allclose(got.scores.numpy(), scores, rtol=RTOL,
                               atol=ATOL)
    for i in range(batch):
        full = torch.cat(got_used[i]).numpy()
        np.testing.assert_array_equal(full, used_after)
    # And the unsharded score_batch on the same inputs, exactly.
    pa = pm.sync()
    want = tk.score_batch(pa, pa.used, *(t(x) for x in ops[2:5]),
                          *port_requests(reqs), t(ops[5]), t(ops[6]))
    assert torch.equal(tk.pack_batch_result(got), tk.pack_batch_result(want))


def crowded_world():
    """Twelve nodes of which only two fit the asks, of different sizes
    (no tie): every lane of both batch rows picks the same node.  Three
    job shapes, so the picked row sums several asks in lane order."""
    from nomad_tpu.structs import NodeResources

    m = NodeMatrix(capacity=16)
    for i in range(12):
        cpu, mem = {4: (20000, 40000), 9: (12000, 24000)}.get(i, (800, 512))
        m.upsert_node(jmock.node(resources=NodeResources(
            cpu=cpu, memory_mb=mem, disk_mb=100 * 1024)))
    reqs = []
    for cpu, mem in ((1200, 900), (1500, 700), (900, 1100)):
        job = jmock.job()
        job.task_groups[0].tasks[0].resources.cpu = cpu
        job.task_groups[0].tasks[0].resources.memory_mb = mem
        reqs.append(RequestEncoder(m).compile(job, job.task_groups[0]).request)
    reqs = stack([reqs[i % 3] for i in range(12)])
    return m, reqs, lane_operands(12, m.capacity, len(m.class_ids))


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_step_usage_where_every_lane_picks_one_node(eight_devices,
                                                            n_dev):
    """Many lanes of both batch rows pick the same node: the usage after
    the step (``sharded_usage`` on each shard) equals the JAX step's
    ``used_after`` on every row, and the picked node carries all twelve
    asks."""
    m, reqs, ops = crowded_world()
    rows, _, _, _, used_after = jax_step(m, reqs, ops, n_dev, 2)
    assert len(set(rows.tolist())) == 1 and rows[0] >= 0
    pm = port_matrix(m)
    mesh = port_mesh(n_dev, 2)
    sharded = tsh.shard_matrix_arrays(mesh, pm.sync())
    ri, rf = port_requests(reqs)
    tk.reset_counts()
    got, got_used = tsh.sharded_schedule_step(mesh)(
        sharded, *ops[2:5], ri.numpy(), rf.numpy(), *ops[5:])
    np.testing.assert_array_equal(got.rows.numpy(), rows)
    for i in range(2):
        np.testing.assert_array_equal(torch.cat(got_used[i]).numpy(),
                                      used_after)
    base = pm.sync().used.numpy()
    hot = int(rows[0])
    assert (used_after[hot] - base[hot] == reqs.ask.sum(axis=0)).all()
    assert tk.sharded_usage_plain.calls == n_dev


def test_sharded_schedule_step_tie_goes_to_lowest_row(eight_devices):
    """Two identical empty nodes, one on each half of the node axis: the
    port (every mesh, and the unsharded kernel) picks the lower row."""
    m = NodeMatrix(capacity=16)
    a, b_ = jmock.node(), jmock.node()
    ra = m.upsert_node(a)
    # Park rows 1..8 with ineligible nodes so b lands on the second half.
    filler = []
    for _ in range(8):
        n = jmock.node()
        n.status = "down"
        m.upsert_node(n)
        filler.append(n)
    rb = m.upsert_node(b_)
    assert ra < 8 <= rb
    job = jmock.job()
    req = RequestEncoder(m).compile(job, job.task_groups[0]).request
    reqs = stack([req] * 4)
    ops = lane_operands(4, m.capacity, len(m.class_ids))
    pm = port_matrix(m)
    pa = pm.sync()
    ri, rf = port_requests(reqs)
    want = tk.score_batch(pa, pa.used, *(t(x) for x in ops[2:5]), ri, rf,
                          t(ops[5]), t(ops[6]))
    assert (want.rows.numpy() == ra).all()
    for n_dev, batch in MESHES:
        mesh = port_mesh(n_dev, batch)
        sharded = tsh.shard_matrix_arrays(mesh, pa)
        got, _ = tsh.sharded_schedule_step(mesh)(
            sharded, *ops[2:5], ri.numpy(), rf.numpy(), *ops[5:])
        assert (got.rows.numpy() == ra).all(), (n_dev, batch)
        assert torch.equal(got.scores, want.scores)
    # The reference's step: the same score, the tie given to the highest
    # row (R8).
    rows, scores, *_ = jax_step(m, reqs, ops, 4, 2)
    np.testing.assert_allclose(scores, want.scores.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert set(rows.tolist()) <= {ra, rb}


@pytest.mark.parametrize("n_dev,batch", MESHES)
def test_sharded_programs_equal_the_unsharded_port(world, n_dev, batch):
    """Bit for bit: the staged and fused sharded programs against the
    port's unsharded ``place_batch``/``fused_place_batch``, and the
    ``sharded_place`` wrapper on the shard groups against its plain
    version."""
    m, reqs, ops, pm = world["m"], world["reqs"], world["ops"], world["pm"]
    pa = pm.sync()
    ri, rf = port_requests(reqs)
    b = reqs.ask.shape[0]
    lm = np.ones((b,), bool)
    lm[2] = False
    mesh = port_mesh(n_dev, batch)
    sharded = tsh.shard_matrix_arrays(mesh, pa)
    staged = tsh.sharded_place_batch(mesh, SCAN)(
        sharded, *ops[:5], ri.numpy(), rf.numpy(), *ops[5:])
    want = tk.place_batch(pa, pa.used, *(t(x) for x in ops[:5]), ri, rf,
                          t(ops[5]), t(ops[6]), SCAN)
    assert torch.equal(staged, want)
    fused = tsh.sharded_fused_place_batch(mesh, SCAN)(
        sharded, *ops[:5], ri.numpy(), rf.numpy(), *ops[5:], lm)
    want = tk.fused_place_batch(pa, pa.used, *(t(x) for x in ops[:5]), ri, rf,
                                t(ops[5]), t(ops[6]), t(lm), SCAN)
    assert torch.equal(fused, want)
    groups = tsh._lane_groups(sharded, *ops[:5], ri.numpy(), rf.numpy(),
                              *ops[5:], lm)
    outs = tk.sharded_place(groups, SCAN)
    for row, out in zip(groups, outs):
        assert torch.equal(out, tk.sharded_place_plain(row, SCAN))


def test_windowed_verify_is_the_unsharded_verify(world):
    """The window [0, N) with no other columns is the unsharded scan, and
    the AND of every shard's windowed verdicts equals it too."""
    m, reqs, ops, pm = world["m"], world["reqs"], world["ops"], world["pm"]
    pa = pm.sync()
    ri, rf = port_requests(reqs)
    b = reqs.ask.shape[0]
    lm = t(np.ones((b,), bool))
    packed = tk.place_batch(pa, pa.used, *(t(x) for x in ops[:5]), ri, rf,
                            t(ops[5]), t(ops[6]), SCAN)
    args = (rf, t(ops[0]), t(ops[1]), lm)
    want = tk.allocs_fit_verify(pa.totals, pa.used, packed, *args)
    tk.reset_counts()
    assert torch.equal(tk.allocs_fit_verify(pa.totals, pa.used, packed,
                                            *args, row_offset=0), want)
    n = pa.used.shape[0]
    half = n // 2
    hi = tk.allocs_fit_verify(pa.totals[half:].contiguous(),
                              pa.used[half:].contiguous(), packed, *args,
                              row_offset=half)
    cols = hi[:, :, tk.FUSED_PACKED_VERIFIED][None].contiguous()
    got = tk.allocs_fit_verify(pa.totals[:half].contiguous(),
                               pa.used[:half].contiguous(), packed, *args,
                               row_offset=0, and_with=cols)
    assert torch.equal(got, want)
    assert tk.verify_lanes.calls == 3


@pytest.mark.parametrize("n_batch", [1, 2])
def test_sharded_usage_sums_picks_in_the_window(n_batch):
    """The step's usage update on one shard: picks inside the window add
    their asks (in lane order per batch row, the rows' parts then added
    in order), picks outside it and failed ones (-1) add nothing."""
    rng = np.random.default_rng(5)
    n_local, off, b = 8, 16, 8
    used = torch.from_numpy(rng.random((n_local, 3), dtype=np.float32) * 100)
    rows = np.array([17, 17, -1, 3, 17, 23, 24, 16], np.int64)
    packed = torch.zeros((b, 1, tk.PACKED_WIDTH), dtype=torch.float32)
    packed[:, 0, tk.PACKED_ROW] = torch.from_numpy(rows.astype(np.float32))
    req_f = torch.from_numpy(
        rng.random((b, tk.REQ_FLOAT_WIDTH), dtype=np.float32) * 1000)
    ask = tk.REQ_FLOAT_OFF["ask"][0]
    want = used.numpy().copy()
    delta = np.zeros_like(want)
    per = b // n_batch
    for i in range(n_batch):
        part = np.zeros_like(want)
        for lane in range(i * per, (i + 1) * per):
            if off <= rows[lane] < off + n_local:
                part[rows[lane] - off] += req_f[lane, ask:ask + 3].numpy()
        delta = delta + part
    want = want + delta
    got = tk.sharded_usage(used, packed, req_f, n_batch, off)
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = [r for r in range(n_local) if r + off not in rows]
    assert torch.equal(got[untouched], used[untouched])


def test_mesh_shapes_and_devices():
    mesh = tsh.make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape == (2, 4) and mesh.axis_names == ("batch", "node")
    assert tsh.node_shard_count(mesh) == 4
    assert tsh.make_mesh(3, devices=["cpu"] * 3).shape == (1, 3)
    with pytest.raises(ValueError):
        tsh.make_mesh(6, batch=4, devices=["cpu"] * 6)
    with pytest.raises(ValueError):
        tsh.make_mesh(4, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        # No fallback: a CUDA device list without a card raises.
        with pytest.raises(RuntimeError, match="CUDA"):
            tsh.make_mesh(4, devices=["cuda:0"] * 4)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            Server(ServerConfig(), device=["cuda:0"] * 2)


def test_sharded_row_scatter_writes_every_copy(world):
    pm = world["pm"]
    mesh = port_mesh(8, 2)
    pa = pm.sync()
    sharded = tsh.shard_matrix_arrays(mesh, pa)
    host = pm.snapshot_host()
    rows = np.array([0, 40, 130, 255], np.int64)
    data = {f: host[f][rows].copy() for f in tk.DeviceArrays._fields}
    data["used"][:] = 7.0
    tsh.make_sharded_row_scatter(mesh)(sharded, rows, data)
    for i in range(2):
        used = torch.cat([a.used for a in sharded.shards[i]]).numpy()
        assert (used[rows] == 7.0).all()
        others = np.setdiff1d(np.arange(used.shape[0]), rows)
        np.testing.assert_array_equal(used[others], pa.used.numpy()[others])


# ---------------------------------------------------------------------------
# The live server
# ---------------------------------------------------------------------------


def run_cluster(make_server, mock):
    srv = make_server()
    srv.start()
    try:
        for i in range(16):
            node = mock.node()
            node.id = f"node-{i:02d}"
            node.name = f"n{i}"
            node.attributes = dict(node.attributes)
            node.attributes["rack"] = f"r{i % 4}"
            srv.register_node(node)
        placements = {}
        for i in range(6):
            job = mock.job()
            job.id = f"job-{i}"
            tg = job.task_groups[0]
            tg.count = 2
            tg.tasks[0].resources.cpu = 100 + 50 * (i % 3)
            tg.tasks[0].resources.memory_mb = 64
            ev = srv.submit_job(job)
            done = srv.wait_for_eval(ev.id, timeout=120)
            assert done is not None and done.status == "complete"
            for a in srv.store.allocs_by_job("default", job.id):
                placements[(job.id, a.name)] = srv.store.node_by_id(
                    a.node_id).name
        assert srv.coalescer.dispatches > 0
        return placements, srv
    finally:
        srv.shutdown()


def test_live_sharded_server_places_as_the_jax_server(eight_devices):
    """Broker → worker → sharded coalescer → applier on eight virtual CPU
    shards places every alloc where the JAX server on one device does."""
    cfg = dict(num_workers=2, heartbeat_min_ttl=60, heartbeat_max_ttl=90,
               node_capacity=64)
    want, jsrv = run_cluster(lambda: JServer(JServerConfig(
        n_device_shards=1, **cfg)), jmock)
    tk.reset_counts()
    got, srv = run_cluster(lambda: Server(ServerConfig(
        slo_enabled=False, overload_enabled=False, **cfg),
        device=["cpu"] * 8), tmock)
    assert jsrv.coalescer.n_device_shards == 1
    assert srv.coalescer.n_device_shards == 8
    # Homed at the first dispatch, after the nodes claimed their rows.
    assert srv.matrix.shard_count == 4
    assert sum(srv.matrix.shard_row_counts()) == 16
    assert tk.sharded_place_plain.calls > 0 and tk.place_lanes.calls == 0
    assert want and got == want


def test_dryrun_multichip_fresh_process():
    proc = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.entry", "--dryrun", "8",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip ok: mesh=(2, 4)" in proc.stdout
    assert "(shards=8)" in proc.stdout
