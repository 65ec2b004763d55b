"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode); they carry
the ``cuda`` marker and skip where there is none.  The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
