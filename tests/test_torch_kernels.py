"""The port's plain PyTorch kernels vs the JAX package's kernels.

Seeded clusters and request mixes are built with ``nomad_tpu`` and carried
into ``nomad_tpu_torch`` as plain numpy (``state/carry.py``); every
function of the scoring pipeline, the solo placement scan and the fused
batch entry must agree under the parity contract: rows, preemption flags,
counters and VERIFIED exact, scores and binpack within rtol 1e-4 /
atol 1e-5 (the contract tests/test_fake_device.py holds the numpy twin
to).  The hand-written kernels are held against the plain version on the
card by tests/test_torch_cuda.py.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nomad_tpu import mock as jmock
from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops import kernels as jk
from nomad_tpu.ops.encode import MAX_SPREADS, MAX_SPREAD_VALUES
from nomad_tpu.state.matrix import stable_hash
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.state import carry
from nomad_tpu_torch.structs import funcs as tfuncs
from nomad_tpu_torch.structs.types import Node as TNode, NodeResources as TRes
from nomad_tpu_torch.structs.types import Resources as TResources

import torch_edge_cases as edge_cases
from torch_parity import (
    jax_edge_pkg,
    ATOL,
    RTOL,
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

FEATURE_MODES = ["full", "narrowed"]


@pytest.fixture(scope="module")
def world():
    """Reference matrix, its port twin, the compiled lane mix and per-lane
    state (usage, tg counts, penalties, spread tables) with every scoring
    stage live."""
    m, nodes = build_cluster(seed=11)
    comp = compile_lanes(m, lane_jobs())
    reqs = stack([c.request for c in comp])
    rng = np.random.default_rng(5)
    b, n = len(comp), m.capacity
    # Spread tables with known values and counts, so even and targeted
    # scoring see real statistics.
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
    used = np.asarray(m.snapshot_host()["used"], np.float32)
    lane_used = np.repeat(used[None], b, axis=0)
    lane_used[:, :50] += rng.integers(0, 800, (b, 50, 3)).astype(np.float32)
    tg = np.zeros((b, n), np.int32)
    tg[:, 10:30] = rng.integers(0, 3, (b, 20))
    pen = np.zeros((b, n), bool)
    pen[:, 40:60] = True
    ce = np.ones((b, 4), bool)
    ce[2, 1] = False
    hm = np.ones((b, n), bool)
    hm[3, ::9] = False
    return dict(m=m, nodes=nodes, reqs=reqs, used=lane_used, tg=tg, pen=pen,
                counts=counts, ce=ce, hm=hm, pm=port_matrix(m))


def features(world, mode):
    if mode == "full":
        return jk.FULL_FEATURES
    return jk.features_of(world["reqs"])


def lane_req(reqs, lane):
    return type(reqs)(*[np.asarray(f)[lane] for f in reqs])


def port_lane_request(world):
    ri, rf = port_requests(world["reqs"])
    return tk.unpack_requests(ri, rf)


def jax_per_lane(world, fn, *lane_args):
    """``fn(arrays, request, *lane_args)`` vmapped over the lanes (the
    request and every ``lane_args`` entry carry a leading lane axis),
    jitted, as numpy."""
    arrays = world["m"].sync()
    vm = jax.jit(jax.vmap(fn, in_axes=(None, 0) + (0,) * len(lane_args)))
    return [np.asarray(o) for o in vm(arrays, world["reqs"], *lane_args)]


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_feasibility_mask_matches(world, mode):
    f = features(world, mode)
    (want,) = jax_per_lane(world, lambda a, r, ce, hm: (
        jk.feasibility_mask(a, r, ce, hm, f),), world["ce"], world["hm"])
    pa = world["pm"].sync()
    got = tk.feasibility_mask(pa, port_lane_request(world), t(world["ce"]),
                              t(world["hm"]), tk.Features(*f))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_fit_and_binpack_matches(world):
    fits_w, score_w = jax_per_lane(
        world, lambda a, r, u: jk.fit_and_binpack(a, u, r)[:2], world["used"])
    pa = world["pm"].sync()
    fits, score = tk.fit_and_binpack(pa, t(world["used"]),
                                     port_lane_request(world))
    np.testing.assert_array_equal(fits.numpy(), fits_w)
    np.testing.assert_allclose(score.numpy(), score_w, rtol=RTOL, atol=ATOL)


def test_anti_affinity_and_penalty_match(world):
    aa_w, aa_app_w = jax_per_lane(
        world, lambda a, r, tg: jk.anti_affinity_score(tg, r), world["tg"])
    aa, aa_app = tk.anti_affinity_score(t(world["tg"]), port_lane_request(world))
    np.testing.assert_array_equal(aa_app.numpy(), aa_app_w)
    np.testing.assert_allclose(aa.numpy(), aa_w, rtol=RTOL, atol=ATOL)
    pen, pen_app = tk.penalty_score(t(world["pen"]))
    pen_w, _ = jk.penalty_score(jnp.asarray(world["pen"]))
    np.testing.assert_array_equal(pen.numpy(), np.asarray(pen_w))
    np.testing.assert_array_equal(pen_app.numpy(), world["pen"])


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_affinity_score_matches(world, mode):
    f = features(world, mode)
    sw, aw = jax_per_lane(world, lambda a, r: jk.affinity_score(
        a, r, f.a_width))
    pa = world["pm"].sync()
    s, app = tk.affinity_score(pa, port_lane_request(world), f.a_width)
    np.testing.assert_array_equal(app.numpy(), aw)
    np.testing.assert_allclose(s.numpy(), sw, rtol=RTOL, atol=ATOL)
    assert aw.any()


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_spread_score_matches(world, mode):
    """Even (rack) and targeted (datacenter) stanzas over carried value
    tables with non-zero counts."""
    f = features(world, mode)
    sw, aw = jax_per_lane(world, lambda a, r, c: jk.spread_score(
        a, r, c, f.s_width), world["counts"])
    pa = world["pm"].sync()
    req = port_lane_request(world)
    s, app = tk.spread_score(pa, req, req.s_value_hash, t(world["counts"]),
                             f.s_width)
    np.testing.assert_array_equal(app.numpy(), aw)
    np.testing.assert_allclose(s.numpy(), sw, rtol=RTOL, atol=ATOL)
    assert aw.any()


def test_preemption_state_matches(world):
    fw, sw, uw = jax_per_lane(world, jk.preemption_state)
    pa = world["pm"].sync()
    free, score, usable = tk.preemption_state(pa, port_lane_request(world))
    np.testing.assert_array_equal(usable.numpy(), uw)
    np.testing.assert_array_equal(free.numpy(), fw)
    np.testing.assert_allclose(score.numpy(), sw, rtol=RTOL, atol=ATOL)
    assert uw.any()


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_score_nodes_matches(world, mode):
    f = features(world, mode)
    final_w, feas_w, fits_w, pre_w, bin_w = jax_per_lane(
        world, lambda a, r, u, tg, c, pen, ce, hm: jk.score_nodes(
            a, u, tg, c, pen, r, ce, hm, f)[:5],
        world["used"], world["tg"], world["counts"], world["pen"],
        world["ce"], world["hm"])
    pa = world["pm"].sync()
    ri, rf = port_requests(world["reqs"])
    res = tk.score_nodes(pa, t(world["used"]), t(world["tg"]),
                         t(world["counts"]), t(world["pen"]), ri, rf,
                         t(world["ce"]), t(world["hm"]), tk.Features(*f))
    np.testing.assert_array_equal(res.feasible.numpy(), feas_w)
    np.testing.assert_array_equal(res.fits.numpy(), fits_w)
    np.testing.assert_array_equal(res.needs_preempt.numpy(), pre_w)
    np.testing.assert_allclose(res.final.numpy(), final_w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.binpack.numpy(), bin_w, rtol=RTOL, atol=ATOL)
    assert pre_w.any(), "no preemption-assisted node: the case lost its teeth"


def test_place_task_group_matches(world):
    """The solo path: one request, dense used0, through fused_place at B=1."""
    m, pm = world["m"], world["pm"]
    arrays, pa = m.sync(), pm.sync()
    n = arrays.used.shape[0]
    for lane in range(world["reqs"].ask.shape[0]):
        req = lane_req(world["reqs"], lane)
        want = jk.place_task_group(
            arrays, req, jnp.asarray(world["used"][lane]),
            jnp.asarray(world["tg"][lane]), jnp.asarray(world["counts"][lane]),
            jnp.asarray(world["pen"][lane]), jnp.asarray(world["ce"][lane]),
            jnp.asarray(world["hm"][lane]), SCAN,
        )
        got = tk.place_task_group(
            pa, req, t(world["used"][lane]), t(world["tg"][lane]),
            t(world["counts"][lane]), t(world["pen"][lane]),
            t(world["ce"][lane]), t(world["hm"][lane]), SCAN,
        )
        np.testing.assert_array_equal(got.rows, np.asarray(want.rows))
        np.testing.assert_array_equal(got.preempted, np.asarray(want.preempted))
        for name in ("nodes_evaluated", "nodes_filtered", "nodes_exhausted"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.binpack, np.asarray(want.binpack),
                                   rtol=RTOL, atol=ATOL)
        assert n == pa.used.shape[0]


def run_fused(m, pm, reqs, ops, lm, f, scan=SCAN):
    arrays = m.sync()
    want = np.asarray(jk.fused_place_batch(
        arrays, arrays.used, *ops[:5], reqs, *ops[5:], lm,
        n_placements=scan, features=f,
    ))
    pa = pm.sync()
    ri, rf = port_requests(reqs)
    got = tk.fused_place_batch(
        pa, pa.used, t(ops[0]), t(ops[1]), t(ops[2]), t(ops[3]), t(ops[4]),
        ri, rf, t(ops[5]), t(ops[6]), t(lm), scan, tk.Features(*f),
    ).numpy()
    return got, want


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_fused_place_batch_matches(world, mode):
    """Dead lane, in-flight deltas (one row twice), existing allocs of the
    lane's job, penalties: the packed (B, P, 8) output."""
    m, nodes = world["m"], world["nodes"]
    reqs = world["reqs"]
    b, n = reqs.ask.shape[0], m.capacity
    r3 = m.row_of[nodes[3].id]
    deltas = {1: [(r3, (500.0, 256.0, 0.0)), (r3, (100.0, 0.0, 0.0))],
              4: [(5, (1000.0, 1000.0, 0.0))]}
    ops = lane_operands(b, n, len(m.class_ids), deltas=deltas,
                        tg_counts={2: {7: 1}}, penalties={0: [1, 2]})
    lm = np.ones((b,), bool)
    lm[b - 1] = False
    got, want = run_fused(m, world["pm"], reqs, ops, lm, features(world, mode))
    assert_packed_equal(got, want)
    assert (want[b - 1, :, jk.FUSED_PACKED_VERIFIED] == -1.0).all()
    assert (want[:, :, jk.PACKED_ROW] >= 0).sum() > b


def test_fused_cross_lane_conflicts_match():
    """Tiny cluster + fat asks: later lanes collide with earlier winners and
    the VERIFIED column flags the same rejections."""
    from nomad_tpu.state import NodeMatrix

    m = NodeMatrix(capacity=8)
    for _ in range(4):
        m.upsert_node(jmock.node())
    job = jmock.job()
    job.task_groups[0].tasks[0].resources.cpu = 1200
    job.task_groups[0].tasks[0].resources.memory_mb = 900
    req = RequestEncoder(m).compile(job, job.task_groups[0]).request
    b, scan = 8, 2
    reqs = stack([req] * b)
    ops = lane_operands(b, m.capacity, len(m.class_ids))
    lm = np.ones((b,), bool)
    got, want = run_fused(m, port_matrix(m), reqs, ops, lm,
                          jk.features_of(reqs), scan)
    assert (want[:, :, jk.FUSED_PACKED_VERIFIED] == 0.0).any()
    assert_packed_equal(got, want)


def test_binpack_matches_scalar_oracle():
    """The port's fit_and_binpack against its copy of structs/funcs.py."""
    node = TNode(resources=TRes(cpu=4000, memory_mb=8192, disk_mb=100 * 1024))
    host = {"totals": np.array([[4000.0, 8192.0, 102400.0]], np.float32)}
    util = TResources(cpu=1500, memory_mb=2304)
    want = tfuncs.score_fit_binpack(node, util) / 18.0
    want_spread = tfuncs.score_fit_spread(node, util) / 18.0
    totals = torch.from_numpy(np.repeat(host["totals"], 16, axis=0))
    arrays = type("A", (), {"totals": totals})
    used = torch.zeros((2, 16, 3))
    used[:, 0] = torch.tensor([1000.0, 2048.0, 0.0])
    ri = torch.zeros((2, tk.REQ_INT_WIDTH), dtype=torch.int32)
    rf = torch.zeros((2, tk.REQ_FLOAT_WIDTH), dtype=torch.float32)
    off = tk.REQ_FLOAT_OFF["ask"][0]
    rf[:, off:off + 3] = torch.tensor([500.0, 256.0, 0.0])
    ri[1, tk.REQ_INT_OFF["algorithm"][0]] = 1
    fits, score = tk.fit_and_binpack(arrays, used, tk.unpack_requests(ri, rf))
    assert bool(fits[0, 0])
    assert abs(float(score[0, 0]) - want) < 1e-5
    assert abs(float(score[1, 0]) - want_spread) < 1e-5


def test_pack_requests_roundtrip(world):
    reqs = world["reqs"]
    ri, rf = port_requests(reqs)
    lr = tk.unpack_requests(ri, rf)
    for name in lr._fields:
        want = np.asarray(getattr(reqs, name))
        got = getattr(lr, name).numpy()
        np.testing.assert_array_equal(got.reshape(want.shape),
                                      want.astype(got.dtype))


def test_wrappers_refuse_other_devices(world):
    """A wrapper takes the plain version only for CPU tensors; any other
    device launches the kernel or raises."""
    pa = world["pm"].sync()
    meta = pa.used.to("meta")
    with pytest.raises(ValueError):
        tk.allocs_fit_verify(pa.totals.to("meta"), meta,
                             torch.empty((1, 1, 7), device="meta"),
                             torch.empty((1, tk.REQ_FLOAT_WIDTH), device="meta"),
                             torch.empty((1, 1), dtype=torch.int32, device="meta"),
                             torch.empty((1, 1, 3), device="meta"),
                             torch.empty((1,), dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("entry", ["fused_place", "place_batch"])
def test_delta_rows_past_the_kernel_cap_are_refused(world, entry):
    """Both devices refuse a lane carrying more delta rows than
    csrc/fused_place.cu keeps (MAX_LANE_DELTAS); at the cap the entry runs
    and the padding changes nothing."""
    pa = world["pm"].sync()
    ri, rf = port_requests(world["reqs"])
    b = ri.shape[0]
    tail = (t(world["tg"]), t(world["counts"]), t(world["pen"]), ri, rf,
            t(world["ce"]), t(world["hm"]))
    if entry == "fused_place":
        tail += (torch.ones((b,), dtype=torch.bool),)
    fn = getattr(tk, entry)

    def run(width):
        rows = torch.full((b, width), -1, dtype=torch.int32)
        vals = torch.zeros((b, width, 3))
        rows[1, :2] = torch.tensor([5, 5], dtype=torch.int32)
        vals[1, :2] = torch.tensor([[300.0, 200.0, 0.0], [100.0, 50.0, 0.0]])
        return fn(pa, pa.used, rows, vals, *tail, SCAN)

    np.testing.assert_array_equal(run(tk.MAX_LANE_DELTAS).numpy(),
                                  run(4).numpy())
    with pytest.raises(ValueError, match="delta rows"):
        run(tk.MAX_LANE_DELTAS + 1)


def test_matrix_check_memo_holds_no_matrix(world):
    """The wrappers check a matrix's columns once per set of columns; the
    memo keeps none of them alive, and a changed column is checked again."""
    cpu = torch.device("cpu")
    pa = world["pm"].sync()
    arrays = pa._replace(attr_num=pa.attr_num.clone())
    assert tk._check_matrix(arrays, arrays.used, cpu) == pa.used.shape[0]
    col = weakref.ref(arrays.attr_num)
    del arrays
    gc.collect()
    assert col() is None
    tk._check_matrix(pa, pa.used, cpu)
    with pytest.raises(TypeError):
        tk._check_matrix(pa._replace(attr_num=pa.attr_num.double()),
                         pa.used, cpu)


def test_carried_request_roundtrips(world):
    req = lane_req(world["reqs"], 2)
    back = carry.request_from_numpy(req._asdict())
    for a, b in zip(req, back):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_xla_divides_by_18_as_a_multiply():
    """Why the port scales binpack by float32(1/18) instead of dividing:
    XLA rewrites a division by a constant as a multiply by its reciprocal,
    which rounds differently from true division for some inputs."""
    x = np.random.default_rng(0).uniform(0, 18, 100_000).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a: a / 18.0)(x))
    np.testing.assert_array_equal(xla, x * np.float32(1.0 / 18.0))
    assert (xla != x / np.float32(18.0)).any()
    port = (torch.from_numpy(x) * tk.INV_18).numpy()
    np.testing.assert_array_equal(port, xla)


@pytest.mark.parametrize("mode", FEATURE_MODES)
@pytest.mark.parametrize("case", edge_cases.CASES)
def test_edge_shapes_fused_match(case, mode):
    """The fused entry on each edge case of tests/torch_edge_cases.py: the
    placement scan on ragged node and lane counts, B=1, ties across node
    tiles and cluster CTAs, spread values inserted mid-scan into tables
    with duplicates and a free slot between used ones, a full table,
    s_width=2, and lanes that fail at step 0 — with in-flight deltas, a
    dead lane, distinct_hosts and preemption."""
    w = edge_cases.build(jax_edge_pkg(), case)
    f = jk.FULL_FEATURES if mode == "full" else jk.features_of(w["reqs"])
    ops = (w["drows"], w["dvals"], w["tg"], w["counts"], w["pen"], w["ce"],
           w["hm"])
    got, want = run_fused(w["m"], port_matrix(w["m"]), w["reqs"], ops,
                          w["lane_mask"], f, w["scan"])
    assert_packed_equal(got, want)
    rows = want[:, :, jk.PACKED_ROW]
    if case == "ties":
        np.testing.assert_array_equal(rows[:3, 0], [0, 140, 257])
    if case == "fails_first":
        assert (rows[:2] == -1).all()
    if case == "spread_tables":
        assert (rows[:3] >= 0).all()
