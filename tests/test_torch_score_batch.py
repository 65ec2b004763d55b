"""The port's batched-eval scoring (``score_batch``) against the JAX
package's.

``score_batch`` scores every node for each of B independent evals
against one shared usage and picks each eval's best node.  Seeded
clusters and request batches are built with ``nomad_tpu`` and carried
into ``nomad_tpu_torch`` as plain numpy (``state/carry.py``); the port's
plain version must agree with the JAX jit under the parity contract of
tests/test_fake_device.py:99-110: rows, preemption flags and the three
node counters exact, scores and binpack within rtol 1e-4 / atol 1e-5.
The hand-written kernel is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops import kernels as jk
from nomad_tpu.ops.encode import MAX_SPREADS, MAX_SPREAD_VALUES
from nomad_tpu.parallel import build_batch_inputs as j_build_batch_inputs
from nomad_tpu.state import NodeMatrix
from nomad_tpu.state.matrix import stable_hash
from nomad_tpu.structs import Affinity, Constraint, Op, Spread
from nomad_tpu_torch.entry import entry as t_entry
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.parallel import build_batch_inputs as t_build_batch_inputs
from nomad_tpu_torch.state import carry

import torch_edge_cases as edge_cases
from torch_parity import (
    jax_edge_pkg,
    ATOL,
    RTOL,
    build_cluster,
    compile_lanes,
    lane_jobs,
    port_matrix,
    port_requests,
    stack,
    t,
)

torch.set_num_threads(1)

JOB_SHAPES = 8
FEATURE_MODES = ["full", "narrowed"]


def as_packed(res):
    """A BatchScoreResult of either package as the (B, 7) float32 array."""
    return np.stack([
        np.asarray(res.rows, np.float32), np.asarray(res.scores, np.float32),
        np.asarray(res.binpack, np.float32),
        np.asarray(res.preempted, np.float32),
        np.asarray(res.nodes_evaluated, np.float32),
        np.asarray(res.nodes_filtered, np.float32),
        np.asarray(res.nodes_exhausted, np.float32),
    ], axis=1)


def assert_batch_equal(got, want):
    """The contract: rows, preempted, counters exact; scores and binpack
    within tolerance.  Also the result types of the port."""
    assert got.rows.dtype == torch.int32
    assert got.preempted.dtype == torch.bool
    for name in ("nodes_evaluated", "nodes_filtered", "nodes_exhausted"):
        assert getattr(got, name).dtype == torch.int32
    g, w = as_packed(got), as_packed(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g[:, [0, 3, 4, 5, 6]], w[:, [0, 3, 4, 5, 6]])
    np.testing.assert_allclose(g[:, 1:3], w[:, 1:3], rtol=RTOL, atol=ATOL)


def port_request(req):
    return carry.request_from_numpy(req._asdict())


# ---------------------------------------------------------------------------
# The bench's eight job shapes (bench.py build_requests)
# ---------------------------------------------------------------------------


def bench_cluster(n_nodes=160, capacity=256, seed=42):
    """The bench cluster's shape at a small size: four datacenters, six
    classes, 32 racks, two TPU types, usage up to 75% over four priority
    buckets."""
    from nomad_tpu.state.matrix import PRIORITY_BUCKETS

    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=capacity)
    for i in range(n_nodes):
        node = jmock.node()
        node.datacenter = f"dc{i % 4 + 1}"
        node.node_class = f"class-{i % 6}"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 32}"
        node.attributes["platform.tpu.type"] = "v5e" if i % 3 else "v5p"
        m.upsert_node(node)
    host = m.snapshot_host()
    usage = np.round(rng.uniform(0.0, 0.75, (n_nodes, 3))
                     * host["totals"][:n_nodes])
    host["used"][:n_nodes] = usage
    shares = rng.dirichlet(np.ones(4), n_nodes)
    for j, b in enumerate(rng.choice(PRIORITY_BUCKETS, 4, replace=False)):
        host["prio_used"][:n_nodes, b] = np.round(usage * shares[:, j:j + 1])
    m._dirty.update(range(n_nodes))
    return m


def bench_shapes(m):
    enc = RequestEncoder(m)
    shapes = []
    for i in range(JOB_SHAPES):
        job = jmock.job()
        tg = job.task_groups[0]
        tg.tasks[0].resources.cpu = 100 + 50 * (i % 4)
        tg.tasks[0].resources.memory_mb = 128 + 64 * (i % 3)
        if i % 4 == 1:
            tg.affinities = [Affinity(l_target="${attr.platform.tpu.type}",
                                      r_target="v5e", operand=Op.EQ.value,
                                      weight=50)]
        if i % 4 == 2:
            tg.spreads = [Spread(attribute="${attr.rack}", weight=50)]
        if i % 4 == 3:
            tg.constraints = [Constraint(l_target="${attr.kernel.name}",
                                         r_target="linux",
                                         operand=Op.EQ.value)]
        shapes.append(enc.compile(job, tg).request)
    return shapes


def widened(shapes):
    feats = jk.features_of(shapes[0])
    for s in shapes[1:]:
        feats = feats.widen(jk.features_of(s))
    return feats


def run_both(m, inp_j, inp_t, features):
    arrays = m.sync()
    want = jk.score_batch(
        arrays, arrays.used, inp_j["tg_counts"], inp_j["spread_counts"],
        inp_j["penalties"], inp_j["reqs"], inp_j["class_eligs"],
        inp_j["host_masks"], features=features)
    pa = port_matrix(m).sync()
    got = tk.score_batch(
        pa, pa.used, inp_t["tg_counts"], inp_t["spread_counts"],
        inp_t["penalties"], inp_t["req_i"], inp_t["req_f"],
        inp_t["class_eligs"], inp_t["host_masks"], tk.Features(*features))
    return got, want


@pytest.mark.parametrize("wide", [True, False], ids=["widened", "full"])
def test_bench_shapes_match(wide):
    """B=24 lanes, lane i the bench's shape i mod 8, the bench's operands
    (build_batch_inputs), at the bench's widened features and at full."""
    m = bench_cluster()
    shapes = bench_shapes(m)
    reqs = [shapes[i % JOB_SHAPES] for i in range(24)]
    feats = widened(shapes) if wide else jk.FULL_FEATURES
    inp_j = j_build_batch_inputs(m, reqs)
    inp_t = t_build_batch_inputs(port_matrix(m), [port_request(r) for r in reqs],
                                 "cpu")
    before = tk.score_batch_plain.calls
    got, want = run_both(m, inp_j, inp_t, feats)
    assert tk.score_batch_plain.calls == before + 1
    assert_batch_equal(got, want)
    rows = np.asarray(want.rows)
    assert (rows >= 0).all()
    # The affinity lanes prefer v5e nodes, the others differ by shape.
    assert len(set(rows.tolist())) > 1


# ---------------------------------------------------------------------------
# Every scoring stage, with non-zero per-lane operands
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lanes():
    """torch_parity's lane mix (binpack, spread algorithm, constraints,
    affinities, two spreads with targets, preemption, ports and
    distinct_hosts, an ask that never fits) with tg counts, penalties,
    class eligibility, host masks and spread tables that are not trivial;
    one lane with every node masked out."""
    m, nodes = build_cluster(seed=13)
    comp = compile_lanes(m, lane_jobs())
    reqs = stack([c.request for c in comp])
    rng = np.random.default_rng(9)
    b, n = len(comp), m.capacity
    s_hash = np.array(reqs.s_value_hash, copy=True)
    counts = np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32)
    for lane in range(b):
        for s in range(MAX_SPREADS):
            if reqs.s_slot[lane, s] < 0:
                continue
            for v in range(4):
                if s_hash[lane, s, v] == 0:
                    s_hash[lane, s, v] = stable_hash(f"r{v}")
                counts[lane, s, v] = float(rng.integers(0, 4))
    reqs = reqs._replace(s_value_hash=s_hash)
    tg = np.zeros((b, n), np.int32)
    tg[:, 10:40] = rng.integers(0, 3, (b, 30))
    pen = np.zeros((b, n), bool)
    pen[:, 40:70] = rng.random((b, 30)) < 0.5
    ce = np.ones((b, 4), bool)
    ce[2, 1] = False
    ce[4, 3] = False
    hm = rng.random((b, n)) < 0.9
    hm[b - 2] = False  # every node masked out
    return dict(m=m, reqs=reqs, tg=tg, pen=pen, counts=counts, ce=ce, hm=hm)


def run_lanes(w, features):
    m = w["m"]
    arrays = m.sync()
    want = jk.score_batch(arrays, arrays.used, w["tg"], w["counts"], w["pen"],
                          w["reqs"], w["ce"], w["hm"], features=features)
    pa = port_matrix(m).sync()
    ri, rf = port_requests(w["reqs"])
    got = tk.score_batch(pa, pa.used, t(w["tg"]), t(w["counts"]), t(w["pen"]),
                         ri, rf, t(w["ce"]), t(w["hm"]),
                         tk.Features(*features))
    return got, want


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_lane_jobs_match(lanes, mode):
    feats = (jk.FULL_FEATURES if mode == "full"
             else jk.features_of(lanes["reqs"]))
    got, want = run_lanes(lanes, feats)
    assert_batch_equal(got, want)
    rows = np.asarray(want.rows)
    assert (rows >= 0).sum() >= len(rows) - 2
    if mode == "full":
        assert np.asarray(want.preempted).any(), "no preempting pick"


def test_infeasible_lanes(lanes):
    """The ask that never fits and the lane with every node masked out:
    row -1, zero score and binpack, no preemption, and their counters
    still counted over every row."""
    got, want = run_lanes(lanes, jk.FULL_FEATURES)
    assert_batch_equal(got, want)
    b = len(np.asarray(want.rows))
    never_fits, masked = b - 1, b - 2
    n_elig = int(np.asarray(lanes["m"].snapshot_host()["eligible"]).sum())
    for lane in (never_fits, masked):
        assert int(got.rows[lane]) == -1
        assert float(got.scores[lane]) == 0.0
        assert float(got.binpack[lane]) == 0.0
        assert not bool(got.preempted[lane])
    # Feasible everywhere it is eligible, exhausted everywhere it is
    # feasible: the counters run although nothing was picked.
    assert int(got.nodes_evaluated[never_fits]) > 0
    assert int(got.nodes_exhausted[never_fits]) == int(
        got.nodes_evaluated[never_fits])
    assert int(got.nodes_evaluated[masked]) == 0
    assert int(got.nodes_filtered[masked]) == n_elig


def test_identical_nodes_lowest_row_wins():
    """Sixteen identical empty nodes tie on every score: each package picks
    the lowest row, as jnp.argmax does; a penalty on it moves the pick to
    the next row."""
    m = NodeMatrix(capacity=32)
    for _ in range(16):
        m.upsert_node(jmock.node())
    job = jmock.job()
    req = RequestEncoder(m).compile(job, job.task_groups[0]).request
    b, n = 3, m.capacity
    reqs = stack([req] * b)
    tg = np.zeros((b, n), np.int32)
    sc = np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32)
    pen = np.zeros((b, n), bool)
    pen[1, 0] = True
    ce = np.ones((b, 2), bool)
    hm = np.ones((b, n), bool)
    hm[2, :5] = False
    w = dict(m=m, reqs=reqs, tg=tg, pen=pen, counts=sc, ce=ce, hm=hm)
    got, want = run_lanes(w, jk.FULL_FEATURES)
    assert_batch_equal(got, want)
    np.testing.assert_array_equal(got.rows.numpy(), [0, 1, 5])


# ---------------------------------------------------------------------------
# Batch assembly and the entry point
# ---------------------------------------------------------------------------


def test_build_batch_inputs_matches_reference():
    """Shapes, dtypes and values of every operand; the narrowed stacked
    request field for field; the packed request equal to the full-width
    stack's."""
    m = bench_cluster(n_nodes=40, capacity=64)
    shapes = bench_shapes(m)
    reqs = [shapes[i % JOB_SHAPES] for i in range(12)]
    want = j_build_batch_inputs(m, reqs)
    got = t_build_batch_inputs(port_matrix(m), [port_request(r) for r in reqs],
                               "cpu")
    for key in ("tg_counts", "spread_counts", "penalties", "class_eligs",
                "host_masks"):
        w = np.asarray(want[key])
        g = got[key]
        assert g.device.type == "cpu"
        assert tuple(g.shape) == w.shape, key
        assert g.numpy().dtype == w.dtype, key
        np.testing.assert_array_equal(g.numpy(), w)
    n_cls = len(m.class_ids)
    assert got["class_eligs"].shape[1] == 1 << (n_cls - 1).bit_length()
    for name in want["reqs"]._fields:
        w = np.asarray(getattr(want["reqs"], name))
        g = np.asarray(getattr(got["reqs"], name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    assert got["reqs"].c_slot.shape[1] < tk.MAX_CONSTRAINTS  # narrowed
    ri, rf = tk.pack_requests(stack([port_request(r) for r in reqs]))
    np.testing.assert_array_equal(got["req_i"].numpy(), ri)
    np.testing.assert_array_equal(got["req_f"].numpy(), rf)


def test_entry_matches_reference_entry():
    """``nomad_tpu_torch.entry.entry("cpu")`` against
    ``__graft_entry__.entry()``: the same cluster and batch, the same
    picks."""
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    want = jfn(*jargs)
    fn, args = t_entry("cpu")
    assert fn is tk.score_batch
    assert all(a.device.type == "cpu" for a in args[1:])
    got = fn(*args)
    assert_batch_equal(got, want)
    assert (got.rows.numpy() >= 0).all()


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_entry()


def test_wrapper_refuses_other_devices(lanes):
    pa = port_matrix(lanes["m"]).sync()
    meta = pa.used.to("meta")
    b, n = 2, meta.shape[0]
    with pytest.raises(ValueError):
        tk.score_batch(pa, meta, torch.empty((b, n), dtype=torch.int32,
                                             device="meta"),
                       torch.empty((b, MAX_SPREADS, MAX_SPREAD_VALUES),
                                   device="meta"),
                       torch.empty((b, n), dtype=torch.bool, device="meta"),
                       torch.empty((b, tk.REQ_INT_WIDTH), dtype=torch.int32,
                                   device="meta"),
                       torch.empty((b, tk.REQ_FLOAT_WIDTH), device="meta"),
                       torch.empty((b, 2), dtype=torch.bool, device="meta"),
                       torch.empty((b, n), dtype=torch.bool, device="meta"))


# ---------------------------------------------------------------------------
# Edge shapes of the tiled kernel (tests/torch_edge_cases.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", FEATURE_MODES)
@pytest.mark.parametrize("case", edge_cases.CASES)
def test_edge_shapes_match(case, mode):
    """Each edge case (ragged node and lane counts, B=1, ties across node
    tiles, duplicate spread hashes and s_width=2, lanes with nothing to
    pick) at full and at the batch's own widths."""
    w = edge_cases.build(jax_edge_pkg(), case)
    feats = (jk.FULL_FEATURES if mode == "full"
             else jk.features_of(w["reqs"]))
    got, want = run_lanes(w, feats)
    assert_batch_equal(got, want)
    rows = got.rows.numpy()
    if case == "ties":
        # The lowest of the tied rows, whichever tile or CTA holds it.
        np.testing.assert_array_equal(rows[:7], [0, 140, 257, 0, 1, 129, 1])
    if case == "fails_first":
        assert rows[0] == -1 and rows[1] == -1
        assert int(got.nodes_evaluated[1]) == 0
        assert rows[4] >= 250
    if case == "single_lane":
        assert rows.shape == (1,) and rows[0] >= 0
