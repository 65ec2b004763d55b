"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode); they carry
the ``cuda`` marker and skip where there is none.  The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

import torch_edge_cases as edge_cases
from nomad_tpu_torch import mock
from nomad_tpu_torch.ops import kernels as k
from nomad_tpu_torch.ops.encode import (
    MAX_SPREAD_VALUES,
    MAX_SPREADS,
    RequestEncoder,
)
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.state.matrix import NodeMatrix
from nomad_tpu_torch.structs.types import (
    Affinity,
    Allocation,
    Constraint,
    Job,
    NetworkResource,
    Resources,
    Spread,
)

SCAN = 8
N_NODES = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def cluster(device, seed=4):
    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=512, device=device)
    nodes = []
    for i in range(N_NODES):
        node = mock.node()
        node.id = node.name = f"node-{i:03d}"
        node.datacenter = "dc1" if i % 3 else "dc2"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 6}"
        node.resources.cpu = int(rng.integers(2000, 8000))
        m.upsert_node(node)
        nodes.append(node)
    for j in range(120):
        node = nodes[int(rng.integers(0, N_NODES))]
        m.add_alloc(Allocation(
            node_id=node.id, job=Job(priority=int(rng.integers(10, 90))),
            resources=Resources(
                cpu=int(rng.integers(100, 1500)),
                memory_mb=int(rng.integers(64, 2048)),
                networks=[NetworkResource(reserved_ports=[9000])]
                if j % 5 == 0 else [],
            ),
        ))
    return m


def requests(m):
    enc = RequestEncoder(m)
    out = []
    shapes = [
        ({}, False),
        ({"affinities": [Affinity(l_target="${attr.rack}", r_target="r1",
                                  operand="=", weight=70)]}, False),
        ({"spreads": [Spread(attribute="${attr.rack}", weight=50)]}, False),
        ({"constraints": [Constraint(l_target="${node.datacenter}",
                                     r_target="dc2", operand="!=")]}, False),
        ({"constraints": [Constraint(operand="distinct_hosts")]}, False),
        ({}, True),
    ]
    for i, (tg_kw, pre) in enumerate(shapes):
        job = mock.job(priority=80)
        tg = job.task_groups[0]
        for key, val in tg_kw.items():
            setattr(tg, key, val)
        tg.tasks[0].resources.cpu = 300 + 400 * i
        if i == 0:
            tg.tasks[0].resources.networks = [NetworkResource(
                reserved_ports=[9000], dynamic_ports=["http"])]
        out.append(enc.compile(job, tg, preemption_enabled=pre).request)
    return out


def batch_args(m, reqs, dev, lanes=8):
    arrays = m.sync()
    n = arrays.used.shape[0]
    reqs = [reqs[i % len(reqs)] for i in range(lanes)]
    stacked = type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])
    ri, rf = k.pack_requests(stacked)
    drows = np.full((lanes, 4), -1, np.int32)
    dvals = np.zeros((lanes, 4, 3), np.float32)
    drows[1, :2] = [5, 5]
    dvals[1, :2] = [[300, 200, 0], [100, 50, 0]]
    tg = np.zeros((lanes, n), np.int32)
    tg[2, 10:20] = 1
    pen = np.zeros((lanes, n), bool)
    pen[3, :40] = True
    lm = np.ones((lanes,), bool)
    lm[-1] = False

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    args = (arrays, arrays.used, on(drows), on(dvals), on(tg),
            on(np.zeros((lanes, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32)),
            on(pen), on(ri), on(rf), on(np.ones((lanes, 8), bool)),
            on(np.ones((lanes, n), bool)), on(lm))
    return args, k.features_of(stacked)


def assert_same(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    exact = [0, 3, 4, 5, 6] + ([7] if got.shape[-1] == 8 else [])
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_fused_place_matches_plain(cuda, full):
    m = cluster(cuda)
    args, feats = batch_args(m, requests(m), cuda)
    if full:
        feats = k.FULL_FEATURES
    before = k.fused_place.launches
    got = k.fused_place(*args, SCAN, feats)
    want = k.place_lanes(*args, SCAN, feats)
    assert k.fused_place.launches == before + 1
    assert_same(got, want)
    assert (got.cpu().numpy()[:-1, :, 0] >= 0).any()


@pytest.mark.cuda
def test_allocs_fit_verify_matches_plain(cuda):
    m = cluster(cuda)
    args, feats = batch_args(m, requests(m), cuda)
    packed = k.fused_place(*args, SCAN, feats)
    arrays = args[0]
    vargs = (arrays.totals, arrays.used, packed, args[8], args[2], args[3],
             args[11])
    before = k.allocs_fit_verify.launches
    got = k.allocs_fit_verify(*vargs)
    assert k.allocs_fit_verify.launches == before + 1
    assert_same(got, k.verify_lanes(*vargs))
    assert (got.cpu().numpy()[-1, :, 7] == -1.0).all()


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands(cuda):
    m = cluster(cuda)
    args, feats = batch_args(m, requests(m), cuda)
    bad = list(args)
    bad[2] = args[2].to(torch.int64)  # delta_rows must be int32
    with pytest.raises(TypeError):
        k.fused_place(*bad, SCAN, feats)
    bad = list(args)
    bad[4] = args[4].cpu()  # a CPU operand next to CUDA ones
    with pytest.raises(ValueError):
        k.fused_place(*bad, SCAN, feats)


def widen_deltas(args, width):
    """``batch_args``' operands with each lane's delta rows padded to
    ``width`` (-1 rows, zero values)."""
    b, d = args[2].shape
    rows = torch.full((b, width), -1, dtype=torch.int32, device=args[2].device)
    vals = torch.zeros((b, width, 3), device=args[3].device)
    rows[:, :d] = args[2]
    vals[:, :d] = args[3]
    return args[:2] + (rows, vals) + args[4:]


@pytest.mark.cuda
def test_fused_place_at_the_delta_cap(cuda):
    """A lane carrying MAX_LANE_DELTAS delta rows (the usage map's cap)
    still equals the plain version; one more is refused before launch."""
    m = cluster(cuda)
    args, feats = batch_args(m, requests(m), cuda)
    wide = widen_deltas(args, k.MAX_LANE_DELTAS)
    assert_same(k.fused_place(*wide, SCAN, feats),
                k.place_lanes(*wide, SCAN, feats))
    before = k.fused_place.launches
    with pytest.raises(ValueError):
        k.fused_place(*widen_deltas(args, k.MAX_LANE_DELTAS + 1), SCAN, feats)
    assert k.fused_place.launches == before


@pytest.mark.cuda
def test_solo_place_task_group_matches_plain(cuda):
    m = cluster(cuda)
    req = requests(m)[1]
    arrays = m.sync()
    n = arrays.used.shape[0]
    ins = (torch.zeros((n,), dtype=torch.int32),
           torch.zeros((MAX_SPREADS, MAX_SPREAD_VALUES)),
           torch.zeros((n,), dtype=torch.bool),
           torch.ones((8,), dtype=torch.bool),
           torch.ones((n,), dtype=torch.bool))
    got = k.place_task_group(arrays, req, arrays.used.clone(),
                             *[x.to(cuda) for x in ins], SCAN)
    cpu_m = cluster("cpu")
    cpu_arrays = cpu_m.sync()
    want = k.place_task_group(cpu_arrays, req, cpu_arrays.used.clone(),
                              *ins, SCAN)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_server_on_card_places_like_cpu(cuda):
    """One worker, the same nodes and jobs in sequence: the server on the
    card places every allocation where the CPU server does."""

    def drive(device):
        srv = Server(ServerConfig(num_workers=1, node_capacity=64),
                     device=device)
        srv.start()
        try:
            for i in range(48):
                node = mock.node()
                node.id = node.name = f"node-{i:02d}"
                node.resources.cpu = 3000 + 100 * (i % 7)
                srv.register_node(node)
            for i in range(12):
                job = mock.job()
                job.id = job.name = f"job-{i}"
                job.task_groups[0].count = 3
                job.task_groups[0].tasks[0].resources.cpu = 200 + 50 * (i % 5)
                ev = srv.submit_job(job)
                assert srv.wait_for_eval(ev.id, 60.0).status == "complete"
            return {(a.job_id, a.name): a.node_id
                    for a in srv.store.allocs.values()}
        finally:
            srv.shutdown()

    before = k.fused_place.launches
    on_card = drive(cuda)
    assert k.fused_place.launches > before
    assert on_card == drive("cpu")


def system_requests(m):
    """System-job requests: a held static port, a datacenter list, numeric,
    version and presence constraints, and an ask that exhausts nodes."""
    enc = RequestEncoder(m)
    out = []
    for i in range(5):
        job = mock.system_job()
        job.datacenters = ["dc1", "dc2"]
        tg = job.task_groups[0]
        if i == 0:
            tg.tasks[0].resources.networks = [NetworkResource(
                reserved_ports=[9000])]
        if i == 1:
            job.datacenters = ["dc2"]
        if i == 2:
            tg.constraints = [
                Constraint(l_target="${attr.os.version}", operand="version",
                           r_target=">= 20.0"),
                Constraint(l_target="${attr.rack}", operand="is_set"),
                Constraint(l_target="${attr.kernel.name}", operand=">",
                           r_target="3"),  # a NaN column: fails everywhere
            ]
        if i == 3:
            tg.constraints = [Constraint(l_target="${attr.rack}",
                                         operand="!=", r_target="r2")]
        if i == 4:
            tg.tasks[0].resources.cpu = 5000
        out.append(enc.compile(job, tg).request)
    return out


@pytest.mark.cuda
def test_system_feasible_matches_plain(cuda):
    m = cluster(cuda)
    arrays = m.sync()
    n = arrays.used.shape[0]
    rng = np.random.default_rng(8)
    used0 = arrays.used.clone()
    rows = torch.from_numpy(rng.choice(N_NODES, 40, replace=False)).to(cuda)
    used0[rows[:20]] -= 200.0
    used0[rows[20:]] += 900.0
    host_mask = torch.ones((n,), dtype=torch.bool, device=cuda)
    host_mask[::11] = False
    for req in system_requests(m):
        ri, rf = k.pack_request(req, cuda)
        for ce in (torch.ones((8,), dtype=torch.bool),
                   torch.tensor([False, True])):
            ce = ce.to(cuda)
            before = k.system_feasible.launches
            got = k.system_feasible(arrays, used0, ri, rf, ce, host_mask)
            assert k.system_feasible.launches == before + 1
            want = k.system_feasible_plain(arrays, used0, ri, rf, ce,
                                           host_mask)
            torch.cuda.synchronize()
            assert got.dtype == torch.bool and got.shape == (2, n)
            # Exactly 0 or 1 in every byte.
            assert int(got.view(torch.uint8).max()) <= 1
            assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_system_server_on_card_places_like_cpu(cuda):
    """A system job on 48 nodes, then 4 more nodes and one node down: the
    card server ends with the allocations the CPU server ends with."""

    def drive(device):
        srv = Server(ServerConfig(num_workers=1, node_capacity=64,
                                  heartbeat_min_ttl=3600.0,
                                  heartbeat_max_ttl=7200.0), device=device)
        srv.start()
        try:
            nodes = []
            for i in range(52):
                node = mock.node()
                node.id = node.name = f"node-{i:02d}"
                node.datacenter = "dc1" if i % 4 else "dc2"
                node.resources.cpu = 1500 + 500 * (i % 7)  # some too small
                nodes.append(node)
            for node in nodes[:48]:
                srv.register_node(node)
            job = mock.system_job()
            job.id = job.name = "exporter"
            job.datacenters = ["dc1", "dc2"]
            job.task_groups[0].tasks[0].resources.cpu = 2200
            ev = srv.submit_job(job)
            assert srv.wait_for_eval(ev.id, 60.0).status == "complete"
            for node in nodes[48:]:
                srv.register_node(node)
            srv.update_node_status("node-05", "down")
            deadline = time.time() + 60.0
            while any(not e.terminal_status() and e.status != "blocked"
                      for e in list(srv.store.evals.values())):
                assert time.time() < deadline, "evals did not finish"
                time.sleep(0.05)
            return {(a.name, a.node_id): (a.desired_status, a.client_status)
                    for a in srv.store.allocs.values()}
        finally:
            srv.shutdown()

    before = k.system_feasible.launches
    on_card = drive(cuda)
    assert k.system_feasible.launches >= before + 6
    assert on_card == drive("cpu")


def score_batch_args(m, reqs, dev, lanes=24, seed=6):
    """Per-lane operands that are not trivial: tg counts, penalties, class
    eligibility, host masks (one lane masked out), spread counts."""
    rng = np.random.default_rng(seed)
    arrays = m.sync()
    n = arrays.used.shape[0]
    reqs = [reqs[i % len(reqs)] for i in range(lanes)]
    stacked = type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])
    ri, rf = k.pack_requests(stacked)
    tg = np.zeros((lanes, n), np.int32)
    tg[:, 10:40] = rng.integers(0, 3, (lanes, 30))
    pen = rng.random((lanes, n)) < 0.1
    ce = np.ones((lanes, 8), bool)
    ce[3, 1] = False
    hm = rng.random((lanes, n)) < 0.9
    hm[5] = False
    sc = rng.integers(0, 4, (lanes, MAX_SPREADS, MAX_SPREAD_VALUES))

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    args = (arrays, arrays.used, on(tg), on(sc.astype(np.float32)), on(pen),
            on(ri), on(rf), on(ce), on(hm))
    return args, k.features_of(stacked)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_score_batch_matches_plain(cuda, full):
    m = cluster(cuda)
    args, feats = score_batch_args(m, requests(m), cuda)
    if full:
        feats = k.FULL_FEATURES
    before = k.score_batch.launches
    got = k.score_batch(*args, feats)
    want = k.score_batch_plain(*args, feats)
    assert k.score_batch.launches == before + 1
    assert got.rows.dtype == torch.int32 and got.preempted.dtype == torch.bool
    assert_same(k.pack_batch_result(got)[:, None],
                k.pack_batch_result(want)[:, None])
    rows = got.rows.cpu().numpy()
    assert rows[5] == -1 and (rows >= 0).sum() > 12


@pytest.mark.cuda
def test_entry_runs_on_the_card(cuda):
    from nomad_tpu_torch.entry import entry

    fn, args = entry()
    assert args[1].device.type == "cuda"
    got = fn(*args)
    want = k.score_batch_plain(*args)
    assert_same(k.pack_batch_result(got)[:, None],
                k.pack_batch_result(want)[:, None])


@pytest.mark.cuda
def test_verify_plan_fit_matches_plain(cuda):
    from nomad_tpu_torch.server.plan_apply import host_verify

    m = cluster(cuda)
    arrays = m.sync()
    host = m.snapshot_host()
    rng = np.random.default_rng(12)
    kk = 700
    rows = rng.integers(0, N_NODES, kk).astype(np.int32)
    rows[rng.random(kk) < 0.1] = -1
    safe = np.maximum(rows, 0)
    room = host["totals"][safe] - host["used"][safe]
    deltas = (room * rng.uniform(0.2, 1.4, (kk, 3))).astype(np.float32)
    elig_required = rng.random(kk) < 0.6
    elig = arrays.eligible.clone()
    elig[torch.from_numpy(rng.choice(N_NODES, 40, replace=False)).to(cuda)] = False
    view = arrays._replace(eligible=elig)
    host_elig = dict(host, eligible=elig.cpu().numpy())
    ins = [torch.from_numpy(x).to(cuda) for x in (rows, deltas, elig_required)]
    before = k.verify_plan_fit.launches
    got = k.verify_plan_fit(view, *ins)
    assert k.verify_plan_fit.launches == before + 1
    want = k.verify_plan_fit_plain(view, *ins)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == (kk,)
    assert int(got.view(torch.uint8).max()) <= 1
    assert torch.equal(got.cpu(), want.cpu())
    np.testing.assert_array_equal(
        got.cpu().numpy(), host_verify(host_elig, rows, deltas, elig_required))
    assert not bool(got.all()) and bool(got.any())


# ---------------------------------------------------------------------------
# The redesigned kernels on the edge shapes of tests/torch_edge_cases.py,
# past the shared-memory limit, and their operand checks
# ---------------------------------------------------------------------------


def edge_args(case):
    """A case of tests/torch_edge_cases.py built with the port on the card:
    (arrays, numpy request, operands on the card)."""
    w = edge_cases.build(edge_cases.port_pkg(), case)
    arrays = w["m"].sync()
    ri, rf = k.pack_requests(w["reqs"])

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to("cuda")

    ops = {name: on(w[name]) for name in (
        "drows", "dvals", "tg", "counts", "pen", "ce", "hm", "lane_mask")}
    ops["ri"], ops["rf"] = on(ri), on(rf)
    return arrays, w, ops


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("case", edge_cases.CASES)
def test_score_batch_edge_shapes(cuda, case, full):
    arrays, w, o = edge_args(case)
    feats = k.FULL_FEATURES if full else k.features_of(w["reqs"])
    args = (arrays, arrays.used, o["tg"], o["counts"], o["pen"], o["ri"],
            o["rf"], o["ce"], o["hm"])
    got = k.score_batch(*args, feats)
    want = k.score_batch_plain(*args, feats)
    assert_same(k.pack_batch_result(got)[:, None],
                k.pack_batch_result(want)[:, None])
    if case == "ties":
        np.testing.assert_array_equal(got.rows.cpu().numpy()[:7],
                                      [0, 140, 257, 0, 1, 129, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", edge_cases.CASES)
def test_fused_place_edge_shapes(cuda, case):
    """fused_place at the case's own widths and place_batch at full widths,
    each against its plain version, exactly."""
    arrays, w, o = edge_args(case)
    args = (arrays, arrays.used, o["drows"], o["dvals"], o["tg"], o["counts"],
            o["pen"], o["ri"], o["rf"], o["ce"], o["hm"])
    feats = k.features_of(w["reqs"])
    got = k.fused_place(*args, o["lane_mask"], w["scan"], feats)
    want = k.place_lanes(*args, o["lane_mask"], w["scan"], feats)
    assert_same(got, want)
    got = k.place_batch(*args, w["scan"])
    want = k.place_batch_plain(*args, w["scan"])
    assert_same(got, want)


def replicated_cluster(capacity, seed=9):
    """A matrix of `capacity` rows: 64 registered nodes, their host rows
    copied over the rest (as chip_smoke.py builds its cluster), with usage
    on every row."""
    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=capacity)
    for i in range(64):
        node = mock.node()
        node.datacenter = "dc1" if i % 3 else "dc2"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 8}"
        m.upsert_node(node)
    host = m.snapshot_host()
    rows = np.arange(64, capacity)
    for key in host:
        host[key][rows] = host[key][rows % 64]
    host["used"][:] = np.round(host["totals"] * rng.uniform(0.0, 0.6,
                                                            (capacity, 1)))
    m._dirty.update(range(capacity))
    m.version += 1
    return m


@pytest.mark.cuda
def test_kernels_past_the_shared_memory_limit(cuda):
    """At 80,000 rows one lane's candidate state no longer fits a cluster's
    shared memory: fused_place keeps it in device scratch in the same
    kernel, and both kernels still equal their plain versions."""
    m = replicated_cluster(80_000)
    arrays = m.sync()
    reqs = requests(m)
    lanes = 4
    args, feats = batch_args(m, reqs, cuda, lanes=lanes)
    args = (arrays, arrays.used) + args[2:]
    shape = k.fused_place_shape(arrays.used.shape[0], lanes,
                                args[2].shape[1], SCAN, feats)
    assert not shape["state_in_smem"] and shape["scratch_cta"] > 0
    assert_same(k.fused_place(*args, SCAN, feats),
                k.place_lanes(*args, SCAN, feats))
    sb = (arrays, arrays.used, args[4], args[5], args[6], args[7], args[8],
          args[9], args[10])
    assert_same(k.pack_batch_result(k.score_batch(*sb, feats))[:, None],
                k.pack_batch_result(k.score_batch_plain(*sb, feats))[:, None])


@pytest.mark.cuda
def test_score_batch_rejects_bad_operands(cuda):
    """The wrapper checks every operand on every call, the matrix columns
    too after a good call with the same matrix."""
    m = cluster(cuda)
    args, feats = score_batch_args(m, requests(m), cuda)
    k.score_batch(*args, feats)
    bad = list(args)
    bad[2] = args[2].to(torch.int64)  # tg_counts must be int32
    with pytest.raises(TypeError):
        k.score_batch(*bad, feats)
    bad = list(args)
    bad[4] = args[4].cpu()  # a CPU operand next to CUDA ones
    with pytest.raises(ValueError):
        k.score_batch(*bad, feats)
    bad = list(args)
    bad[0] = args[0]._replace(attr_num=args[0].attr_num.double())
    with pytest.raises(TypeError):
        k.score_batch(*bad, feats)


# ---------------------------------------------------------------------------
# The row-segmented allocs_fit_verify and the tiled system_feasible on the
# edge shapes of tests/torch_edge_cases.py
# ---------------------------------------------------------------------------


def verify_operands(case, device):
    """Case ``case`` of torch_edge_cases.VERIFY_CASES as the seven
    operands of allocs_fit_verify on ``device``."""
    w = edge_cases.verify_case(case)
    b = w["asks"].shape[0]
    req_f = np.zeros((b, k.REQ_FLOAT_WIDTH), np.float32)
    off = k.REQ_FLOAT_OFF["ask"][0]
    req_f[:, off:off + 3] = w["asks"]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (
        w["totals"], w["used"], w["packed"], req_f, w["drows"], w["dvals"],
        w["lane_mask"]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", edge_cases.VERIFY_CASES)
def test_allocs_fit_verify_edge_cases(cuda, case):
    """Every column exactly as the plain version's, in the tier the event
    count calls for (the keys in device scratch past shared memory)."""
    ops = verify_operands(case, cuda)
    n, (b, p, _), d = ops[0].shape[0], ops[2].shape, ops[4].shape[1]
    plan = k.allocs_fit_verify_shape(n, b, p, d)
    assert plan["tier"] == (1 if case == "large" else 0)
    before = k.allocs_fit_verify.launches
    got = k.allocs_fit_verify(*ops)
    assert k.allocs_fit_verify.launches == before + 1
    want = k.verify_lanes(*[x.cpu() for x in ops])
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    verified = want.numpy()[..., k.FUSED_PACKED_VERIFIED]
    if case in ("bench", "hot_row", "large"):
        assert (verified == 0.0).any() and (verified == 1.0).any()
    if case == "all_dead":
        assert (verified == -1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", edge_cases.SYSTEM_ROWS)
def test_system_feasible_edge_rows(cuda, n):
    """Every constraint kind, an escaped class, a device ask and a static
    port at ragged and large node counts: both rows exactly as the plain
    version's, every byte 0 or 1."""
    w = edge_cases.system_case(edge_cases.port_pkg(), n)
    arrays = edge_cases.first_rows(w["m"].sync(cuda), n)
    for label, req, class_elig, host_mask in w["reqs"]:
        ri, rf = k.pack_request(req, cuda)
        ce = torch.from_numpy(class_elig).to(cuda)
        hm = torch.from_numpy(host_mask[:n].copy()).to(cuda)
        got = k.system_feasible(arrays, arrays.used, ri, rf, ce, hm)
        want = k.system_feasible_plain(arrays, arrays.used, ri, rf, ce, hm)
        torch.cuda.synchronize()
        assert int(got.view(torch.uint8).max()) <= 1, label
        assert torch.equal(got.cpu(), want.cpu()), label


@pytest.mark.cuda
def test_trimmed_wrappers_still_refuse_bad_operands(cuda):
    """system_feasible and allocs_fit_verify check every operand on every
    call, the matrix columns too after a good call with the same matrix."""
    m = cluster(cuda)
    arrays = m.sync()
    n = arrays.used.shape[0]
    ri, rf = k.pack_request(system_requests(m)[0], cuda)
    ce = torch.ones((8,), dtype=torch.bool, device=cuda)
    hm = torch.ones((n,), dtype=torch.bool, device=cuda)
    k.system_feasible(arrays, arrays.used, ri, rf, ce, hm)
    with pytest.raises(TypeError):
        k.system_feasible(arrays, arrays.used, ri.to(torch.int64), rf, ce, hm)
    with pytest.raises(ValueError):
        k.system_feasible(arrays, arrays.used, ri, rf, ce, hm.cpu())
    with pytest.raises(ValueError):
        k.system_feasible(arrays, arrays.used, ri, rf, ce[:0], hm)
    with pytest.raises(TypeError):
        k.system_feasible(arrays._replace(attr_ver=arrays.attr_ver.double()),
                          arrays.used, ri, rf, ce, hm)
    ops = verify_operands("bench", cuda)
    k.allocs_fit_verify(*ops)
    with pytest.raises(TypeError):
        k.allocs_fit_verify(*ops[:4], ops[4].to(torch.int64), *ops[5:])
    with pytest.raises(ValueError):
        k.allocs_fit_verify(*ops[:6], ops[6].cpu())


# ---------------------------------------------------------------------------
# Several cards, and the node-sharded dispatch
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_every_kernel_on_the_last_card(cuda):
    """Each kernel launched on the last visible card while the first one
    is current: the wrappers make the tensors' card current, and each
    kernel sets its one-time attributes (fused_place's and
    allocs_fit_verify's dynamic shared memory past 48 KB) on that card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from nomad_tpu_torch.parallel import sharding

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    m = cluster(last)
    args, feats = batch_args(m, requests(m), last)
    packed = k.fused_place(*args, SCAN, k.FULL_FEATURES)
    assert packed.device == last
    assert_same(packed, k.place_lanes(*args, SCAN, k.FULL_FEATURES))
    arrays = args[0]
    vargs = (arrays.totals, arrays.used, packed, args[8], args[2], args[3],
             args[11])
    assert_same(k.allocs_fit_verify(*vargs), k.verify_lanes(*vargs))
    sargs, sfeats = score_batch_args(m, requests(m), last)
    assert_same(k.pack_batch_result(k.score_batch(*sargs, sfeats))[:, None],
                k.pack_batch_result(k.score_batch_plain(*sargs, sfeats))[:, None])
    req = system_requests(m)[0]
    ri, rf = k.pack_request(req, last)
    ce = torch.ones((8,), dtype=torch.bool, device=last)
    hm = torch.ones((arrays.used.shape[0],), dtype=torch.bool, device=last)
    assert torch.equal(
        k.system_feasible(arrays, arrays.used, ri, rf, ce, hm).cpu(),
        k.system_feasible_plain(arrays, arrays.used, ri, rf, ce, hm).cpu())
    rows = torch.arange(0, 64, dtype=torch.int32, device=last)
    deltas = torch.full((64, 3), 100.0, device=last)
    er = torch.ones((64,), dtype=torch.bool, device=last)
    assert torch.equal(k.verify_plan_fit(arrays, rows, deltas, er).cpu(),
                       k.verify_plan_fit_plain(arrays, rows, deltas, er).cpu())
    mesh = sharding.make_mesh(devices=[last] * 2)
    sharded = sharding.shard_matrix_arrays(mesh, arrays)
    host = [a.cpu().numpy() for a in args[2:]]
    got = sharding.sharded_fused_place_batch(mesh, SCAN)(
        sharded, *host, features=feats)
    assert got.device == last
    want = k.fused_place_batch(*args, SCAN, feats)
    assert torch.equal(got, want)
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_programs_match_unsharded_on_the_card(cuda, n_dev):
    """Virtual shards of one card: the three sharded programs equal the
    unsharded kernels exactly, and ``sharded_place`` its plain version."""
    from nomad_tpu_torch.parallel import sharding

    m = cluster(cuda)
    args, feats = batch_args(m, requests(m), cuda)
    arrays = args[0]
    host = [a.cpu().numpy() for a in args[2:]]
    mesh = sharding.make_mesh(devices=[cuda] * n_dev)
    sharded = sharding.shard_matrix_arrays(mesh, arrays)
    before = (k.sharded_place.launches, k.allocs_fit_verify.window_launches,
              k.sharded_place.copies)
    got = sharding.sharded_fused_place_batch(mesh, SCAN)(
        sharded, *host, features=feats)
    assert torch.equal(got, k.fused_place_batch(*args, SCAN, feats))
    # One launch a step over every virtual shard of the card; offers never
    # leave the card.
    assert k.sharded_place.launches == before[0] + SCAN + 1
    assert k.sharded_place.copies == before[2]
    assert k.allocs_fit_verify.window_launches == (
        before[1] + sharding.node_shard_count(mesh))
    staged = sharding.sharded_place_batch(mesh, SCAN)(sharded, *host[:-1])
    assert torch.equal(staged, k.place_batch(*args[:-1], SCAN))
    sargs, _ = score_batch_args(m, requests(m), cuda)
    usage_before = k.sharded_usage.launches
    res, used_after = sharding.sharded_schedule_step(mesh)(
        sharded, *[a.cpu().numpy() for a in sargs[2:]])
    assert k.sharded_usage.launches == usage_before + n_dev
    want = k.score_batch(*sargs)
    assert torch.equal(k.pack_batch_result(res), k.pack_batch_result(want))
    # The usage after the step: the unsharded usage plus each pick's ask
    # (summed in lane order per batch row, then over batch rows).
    packed = k.pack_batch_result(want)[:, None].contiguous()
    want_used = k.sharded_usage_plain(arrays.used.cpu(), packed.cpu(),
                                      sargs[6].cpu(), mesh.shape[0])
    for row in used_after:
        assert torch.equal(torch.cat([u.cpu() for u in row]), want_used)
    assert torch.equal(
        k.sharded_usage(arrays.used, packed, sargs[6], mesh.shape[0]).cpu(),
        want_used)
    groups = sharding._lane_groups(sharded, *host)
    for row, out in zip(groups, k.sharded_place(groups, SCAN, feats)):
        assert torch.equal(out, k.sharded_place_plain(row, SCAN, feats))


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("case", edge_cases.SHARDED_CASES)
def test_sharded_place_edge_cases_on_the_card(cuda, case, n_dev):
    """The cases of tests/torch_edge_cases.py SHARDED_CASES (lane 3 dead)
    on virtual shards of the card, at P = 1 and P = 64: ``sharded_place``
    equals its plain version, the fused and staged sharded programs the
    unsharded kernels, every column exactly; P + 1 launches and no offer
    copy a dispatch.  The shards' rows are a multiple of no CTA span."""
    from nomad_tpu_torch.parallel import sharding

    w = edge_cases.sharded_case(edge_cases.port_pkg(), case)
    arrays = w["m"].sync()
    assert arrays.used.device.type == "cuda"
    ri, rf = k.pack_requests(w["reqs"])
    host = [w["drows"], w["dvals"], w["tg"], w["counts"], w["pen"], ri, rf,
            w["ce"], w["hm"], w["lane_mask"]]
    on = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in host]
    feats = k.features_of(w["reqs"])
    mesh = sharding.make_mesh(devices=[cuda] * n_dev)
    sharded = sharding.shard_matrix_arrays(mesh, arrays)
    b_row = w["lane_mask"].shape[0] // mesh.shape[0]
    shape = k.sharded_place_shape(
        sharded.n_local, b_row * n_dev, w["drows"].shape[1], SCAN, feats)
    assert sharded.n_local % shape["span"] != 0
    groups = sharding._lane_groups(sharded, *host)
    for p in (1, 64):
        k.reset_counts()
        outs = k.sharded_place(groups, p, feats)
        assert k.sharded_place.launches == p + 1
        assert k.sharded_place.copies == 0
        for row, out in zip(groups, outs):
            assert torch.equal(out, k.sharded_place_plain(row, p, feats))
        got = sharding.sharded_fused_place_batch(mesh, p)(
            sharded, *host, features=feats)
        assert torch.equal(got, k.fused_place_batch(
            arrays, arrays.used, *on, p, feats))
        staged = sharding.sharded_place_batch(mesh, p)(sharded, *host[:-1])
        assert torch.equal(staged, k.place_batch(
            arrays, arrays.used, *on[:-1], p))
        dead = torch.from_numpy(~w["lane_mask"]).to(cuda)
        assert (got[dead][:, :, k.PACKED_ROW] == -1).all()


# ---------------------------------------------------------------------------
# sharded_usage and verify_plan_fit at the edges of their staging
# ---------------------------------------------------------------------------


def usage_on(case, dev):
    """A case of tests/torch_edge_cases.py ``usage_case`` on ``dev``:
    ((used, packed, req_f), the case)."""
    w = edge_cases.usage_case(case)
    ops = edge_cases.usage_operands(w, k.PACKED_WIDTH, k.REQ_FLOAT_WIDTH,
                                    k.REQ_FLOAT_OFF["ask"][0])
    return tuple(torch.from_numpy(x).to(dev) for x in ops), w


def usage_plain(ops, w):
    return k.sharded_usage_plain(*(x.cpu() for x in ops), w["n_batch"],
                                 w["row_offset"])


def same_bits(got, want) -> bool:
    return torch.equal(got.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", edge_cases.USAGE_CASES)
def test_sharded_usage_edge_cases(cuda, case):
    """Every case (B of 1, 63, 64, 4,096 and the limit, ragged spans, one
    hot row across both batch rows, no pick in the window, the last
    shard, order-sensitive asks): the kernel equals its plain version bit
    for bit, one launch and no plain call."""
    ops, w = usage_on(case, cuda)
    before = (k.sharded_usage.launches, k.sharded_usage_plain.calls)
    got = k.sharded_usage(*ops, w["n_batch"], w["row_offset"])
    torch.cuda.synchronize()
    assert (k.sharded_usage.launches, k.sharded_usage_plain.calls) == (
        before[0] + 1, before[1])
    assert same_bits(got, usage_plain(ops, w))


@pytest.mark.cuda
def test_sharded_usage_unaligned_rows(cuda):
    """A shard's usage that starts off a 16-byte boundary takes the
    kernel's scalar copy, with the same result."""
    ops, w = usage_on("b4096", cuda)
    used = torch.cat([ops[0][:1], ops[0]])[1:]
    assert used.is_contiguous() and used.data_ptr() % 16
    got = k.sharded_usage(used, *ops[1:], w["n_batch"], w["row_offset"])
    assert same_bits(got, usage_plain((used, *ops[1:]), w))


@pytest.mark.cuda
def test_sharded_usage_refuses_lanes_past_the_limit(cuda):
    """One lane past SHARDED_USAGE_MAX_LANES is refused on both devices
    before any launch."""
    (used, packed, req_f), w = usage_on("limit", cuda)
    more = torch.cat([packed, packed[:2]])
    more_f = torch.cat([req_f, req_f[:2]])
    before = k.sharded_usage.launches
    for dev in (cuda, torch.device("cpu")):
        with pytest.raises(ValueError, match="at most"):
            k.sharded_usage(used.to(dev), more.to(dev), more_f.to(dev),
                            w["n_batch"], w["row_offset"])
    assert k.sharded_usage.launches == before


def plan_on(kk, dev, padding_only=False):
    """A plan of tests/torch_edge_cases.py ``plan_case`` on ``dev``:
    (matrix columns, (rows, deltas, elig_required), the numpy case)."""
    import types

    w = edge_cases.plan_case(kk, padding_only=padding_only)
    cols = types.SimpleNamespace(**{
        f: torch.from_numpy(w[f]).to(dev)
        for f in ("used", "totals", "eligible")})
    ins = tuple(torch.from_numpy(w[f]).to(dev)
                for f in ("rows", "deltas", "elig_required"))
    return cols, ins, w


@pytest.mark.cuda
@pytest.mark.parametrize("padding_only", [False, True])
@pytest.mark.parametrize("kk", edge_cases.PLAN_ROWS)
def test_verify_plan_fit_edge_plans(cuda, kk, padding_only):
    """Plans of 1, 3, 255, 10,000 and 80,000 rows (most a multiple of no
    row group), rows past the matrix, and all-padding plans: the kernel
    equals its plain version and the applier's host_verify, every byte 0
    or 1, one launch and no plain call."""
    from nomad_tpu_torch.server.plan_apply import host_verify

    cols, ins, w = plan_on(kk, cuda, padding_only)
    before = (k.verify_plan_fit.launches, k.verify_plan_fit_plain.calls)
    got = k.verify_plan_fit(cols, *ins)
    torch.cuda.synchronize()
    assert (k.verify_plan_fit.launches, k.verify_plan_fit_plain.calls) == (
        before[0] + 1, before[1])
    assert got.dtype == torch.bool and got.shape == (kk,)
    assert int(got.view(torch.uint8).max()) <= 1
    assert torch.equal(got.cpu(), k.verify_plan_fit_plain(cols, *ins).cpu())
    hv = host_verify({f: w[f] for f in ("used", "totals", "eligible")},
                     w["rows"], list(w["deltas"]), w["elig_required"])
    np.testing.assert_array_equal(got.cpu().numpy(), hv)
    if padding_only:
        assert bool(got.all())


@pytest.mark.cuda
def test_verify_plan_fit_unaligned_operands(cuda):
    """Operands that start off their wide accesses' alignment take the
    scalar path, with the same verdicts."""
    cols, ins, _ = plan_on(10_000, cuda)
    shifted = tuple(torch.cat([x[:1], x])[1:] for x in ins)
    assert all(x.is_contiguous() for x in shifted)
    assert shifted[0].data_ptr() % 16 and shifted[2].data_ptr() % 4
    got = k.verify_plan_fit(cols, *shifted)
    assert int(got.view(torch.uint8).max()) <= 1
    assert torch.equal(got.cpu(),
                       k.verify_plan_fit_plain(cols, *shifted).cpu())


@pytest.mark.cuda
def test_usage_and_plan_fit_wrappers_refuse_bad_operands(cuda):
    """Both trimmed wrappers keep every check: a wrong dtype raises
    TypeError, another device, shape or a non-contiguous operand
    ValueError, the matrix columns too after a good call with the same
    matrix; nothing launches.  (``used`` names the device: on the CPU it
    takes the plain version.)"""
    ops, w = usage_on("b64", cuda)
    cols, ins, _ = plan_on(255, cuda)
    k.sharded_usage(*ops, w["n_batch"], w["row_offset"])
    k.verify_plan_fit(cols, *ins)
    torch.cuda.synchronize()
    before = (k.sharded_usage.launches, k.verify_plan_fit.launches)
    bad = {
        "dtype": (lambda x: x.double(), TypeError),
        "device": (lambda x: x.cpu(), ValueError),
        "shape": (lambda x: x[..., :-1].contiguous(), ValueError),
        "contiguity": (lambda x: torch.stack([x, x], dim=-1)[..., 0],
                       ValueError),
    }
    for kind, (change, error) in bad.items():
        for i in range(3):
            args = list(ops)
            args[i] = change(args[i])
            if not (i == 0 and kind == "device"):
                with pytest.raises(error):
                    k.sharded_usage(*args, w["n_batch"], w["row_offset"])
            args = list(ins)
            args[i] = change(args[i])
            with pytest.raises(error):
                k.verify_plan_fit(cols, *args)
        for f in ("used", "totals", "eligible"):
            if f == "used" and kind == "device":
                continue
            other = type(cols)(**vars(cols))
            setattr(other, f, change(getattr(cols, f)))
            with pytest.raises(error):
                k.verify_plan_fit(other, *ins)
    assert (k.sharded_usage.launches, k.verify_plan_fit.launches) == before
