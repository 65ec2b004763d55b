"""The plain placement scan over the live lanes only.

``place_lanes`` (the plain version of ``fused_place``) gathers the live
lanes' rows of the request, the operands and the carries, scans them and
scatters the result back into the (B, P, PACKED_WIDTH) output; dead lanes
read row -1 and zeros. Lanes never read each other's state, so the live
lanes' output is bit for bit that of a scan over every lane, and the fused
entry agrees with the JAX package's ``_fused_place_batch_impl`` under the
parity contract (rows, flags, counters and VERIFIED exact) on masks that
are partly live, one live lane of 64 among them.
"""

import numpy as np
import pytest
import torch

from nomad_tpu.ops import kernels as jk
from nomad_tpu_torch.ops import kernels as tk

from torch_parity import (
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

torch.set_num_threads(1)

B = 64

MASKS = {
    "one_of_64": [37],
    "first_only": [0],
    "last_only": [B - 1],
    "alternate": list(range(0, B, 2)),
    "ragged": [1, 2, 3, 11, 12, 40, 41, 42, 43, 62],
    "all": list(range(B)),
    "none": [],
}


@pytest.fixture(scope="module")
def world():
    m, nodes = build_cluster(seed=11, n_nodes=150, capacity=192)
    jobs = lane_jobs()
    reqs1 = compile_lanes(m, jobs)
    reqs = stack([reqs1[i % len(reqs1)].request for i in range(B)])
    n = m.capacity
    rng = np.random.default_rng(5)
    deltas = {lane: [(int(rng.integers(0, 150)),
                      (float(rng.integers(100, 900)),
                       float(rng.integers(64, 512)), 0.0))]
              for lane in range(0, B, 3)}
    deltas[6].append((deltas[6][0][0], (50.0, 10.0, 0.0)))
    tg_counts = {lane: {int(rng.integers(0, 150)): 1}
                 for lane in range(1, B, 7)}
    penalties = {lane: [int(rng.integers(0, 150))] for lane in range(2, B, 9)}
    ops = lane_operands(B, n, len(m.class_ids), deltas=deltas,
                        tg_counts=tg_counts, penalties=penalties)
    return dict(m=m, pm=port_matrix(m), reqs=reqs, ops=ops)


def _mask(name):
    lm = np.zeros((B,), bool)
    lm[MASKS[name]] = True
    return lm


def _port_args(w):
    pa = w["pm"].sync()
    ri, rf = port_requests(w["reqs"])
    o = w["ops"]
    return pa, (pa, pa.used, t(o[0]), t(o[1]), t(o[2]), t(o[3]), t(o[4]),
                ri, rf, t(o[5]), t(o[6]))


@pytest.mark.parametrize("name", sorted(MASKS))
def test_live_lane_scan_is_bitwise_the_all_lane_scan(world, name):
    """Each live lane's output equals, bit for bit, the same lane's output
    from a scan of all 64 lanes; each dead lane reads row -1 and zeros."""
    _, args = _port_args(world)
    lm = _mask(name)
    full = tk.place_lanes(*args, t(np.ones((B,), bool)), SCAN,
                          tk.FULL_FEATURES).numpy()
    got = tk.place_lanes(*args, t(lm), SCAN, tk.FULL_FEATURES).numpy()
    want = full.copy()
    want[~lm] = 0.0
    want[~lm, :, tk.PACKED_ROW] = -1.0
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["one_of_64", "alternate", "ragged", "none"])
def test_fused_entry_matches_reference_on_partly_live_masks(world, name):
    """``fused_place_batch`` (live-lane ``place_lanes`` then
    ``verify_lanes``) against the JAX package's fused entry under the
    parity contract."""
    m, reqs, o = world["m"], world["reqs"], world["ops"]
    lm = _mask(name)
    arrays = m.sync()
    want = np.asarray(jk._fused_place_batch_impl(
        arrays, arrays.used, *o[:5], reqs, *o[5:], lm,
        n_placements=SCAN, features=jk.FULL_FEATURES))
    _, args = _port_args(world)
    got = tk.fused_place_batch(*args, t(lm), SCAN, tk.FULL_FEATURES).numpy()
    assert_packed_equal(got, want)
    assert (got[~lm, :, tk.PACKED_ROW] == -1).all()
    assert (got[lm, 0, tk.PACKED_ROW] >= 0).any() or not lm.any()


def test_scan_scores_only_the_live_lanes(world, monkeypatch):
    """With one live lane of 64 every scoring step sees one lane."""
    seen = []
    real = tk._score_step

    def spy(arrays, req, sp, used, *rest):
        seen.append(used.shape[0])
        return real(arrays, req, sp, used, *rest)

    monkeypatch.setattr(tk, "_score_step", spy)
    _, args = _port_args(world)
    tk.place_lanes(*args, t(_mask("one_of_64")), SCAN, tk.FULL_FEATURES)
    assert seen == [1] * SCAN


SPARSE = ("tail", "none_eligible", "last_only", "holes")


@pytest.fixture(scope="module")
def sparse_worlds():
    """Matrices whose capacity far exceeds their nodes (rows past the last
    eligible one are left out of the plain scan), one with no eligible
    row, one whose only eligible row is the last claimed one, and one
    with ineligible rows between eligible ones."""
    out = {}
    for name in SPARSE:
        m, nodes = build_cluster(seed=13, n_nodes=40, capacity=256,
                                 n_allocs=15)
        if name == "none_eligible":
            for n in nodes:
                m.set_eligibility(n.id, False)
        elif name == "last_only":
            for n in nodes[:-1]:
                m.set_eligibility(n.id, False)
        elif name == "holes":
            for n in nodes[5:30:3]:
                m.set_eligibility(n.id, False)
        reqs1 = compile_lanes(m, lane_jobs())
        reqs = stack([reqs1[i % len(reqs1)].request for i in range(B)])
        ops = lane_operands(B, m.capacity, len(m.class_ids),
                            deltas={3: [(250, (500.0, 64.0, 0.0)),
                                        (7, (100.0, 0.0, 0.0))]},
                            tg_counts={2: {1: 1}}, penalties={4: [0, 39]})
        out[name] = dict(m=m, pm=port_matrix(m), reqs=reqs, ops=ops)
    return out


@pytest.mark.parametrize("mask", ["alternate", "all"])
@pytest.mark.parametrize("name", SPARSE)
def test_sparse_matrix_matches_reference(sparse_worlds, name, mask):
    """Leaving out the rows past the last eligible one changes no output:
    the fused entry against the JAX package's on matrices of 40 nodes at
    capacity 256."""
    w = sparse_worlds[name]
    lm = _mask(mask)
    arrays = w["m"].sync()
    want = np.asarray(jk._fused_place_batch_impl(
        arrays, arrays.used, *w["ops"][:5], w["reqs"], *w["ops"][5:], lm,
        n_placements=SCAN, features=jk.FULL_FEATURES))
    _, args = _port_args(w)
    got = tk.fused_place_batch(*args, t(lm), SCAN, tk.FULL_FEATURES).numpy()
    assert_packed_equal(got, want)
    rows = got[lm, :, tk.PACKED_ROW]
    if name == "none_eligible":
        assert (rows == -1).all()
    elif name == "last_only":
        assert set(rows[rows >= 0].tolist()) <= {39.0}
    else:
        assert (rows >= 0).any()
