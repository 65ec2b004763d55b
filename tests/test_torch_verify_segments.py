"""The row-segmented cross-lane AllocsFit of ``csrc/allocs_fit_verify.cu``,
on the CPU.

The kernel cannot run here, so its algorithm is modelled in numpy below,
step for step: every event of a live lane (its D delta rows, then its P
picks) gets the sequence number lane·(D + P) + j; the events without an
effect (dead lanes, rows < 0 or >= n) are dropped and the rest sorted
stably by row; one walker per row segment adds the deltas and asks in sequence order in
float32 (the segment's first event carrying used[r], from -0.0) and
writes each pick's verdict.  Three parts:

* the model agrees bit for bit with ``verify_lanes`` (the plain version
  the kernel is held to on the card) on hypothesis-drawn event streams —
  hot rows picked by every lane, deltas on other lanes' picks,
  order-sensitive values (1e8, 1, -1e8), rows < 0 and >= n, dead lanes
  carrying stale deltas, P = 1 and B = 1 — and on the edge cases of
  ``tests/torch_edge_cases.py`` that the card tests and the smoke use;
* ``verify_lanes`` (through the port's fused entry) against the JAX
  ``fused_place_batch`` on lanes that collide on a few small nodes, over
  seeds and lane counts: rows, counters and VERIFIED exact;
* the plain version's contract at the edges: a pick with no row reads
  1.0, a dead lane -1.0 and row -1, and dead lanes change no later
  verdict.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nomad_tpu import mock as jmock
from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops import kernels as jk
from nomad_tpu.state import NodeMatrix
from nomad_tpu_torch.ops import kernels as tk

import torch_edge_cases as edge_cases
from torch_parity import (
    assert_packed_equal,
    lane_operands,
    port_matrix,
    port_requests,
    stack,
    t,
)

torch.set_num_threads(1)

def model_verify(totals, used, packed, asks, drows, dvals, lane_mask):
    """The kernel's algorithm on numpy operands; returns (B, P, 8) f32."""
    b, p = packed.shape[:2]
    d = drows.shape[1]
    n = totals.shape[0]
    live = np.asarray(lane_mask, bool)
    out = np.zeros((b, p, 8), np.float32)
    out[..., :7] = packed
    out[~live] = 0.0
    out[~live, :, 0] = -1.0
    out[~live, :, 7] = -1.0
    picks = packed[..., 0].astype(np.int32)  # the kernel's (int) cast
    no_row = (picks < 0) | (picks >= n)
    out[..., 7][live[:, None] & no_row] = 1.0

    # The events with an effect, in sequence order, sorted stably by row
    # (the kernel's LSD radix sort is stable: within a row, sequence order).
    stride = d + p
    rows = np.concatenate([drows, picks], axis=1).reshape(-1)
    seqs = np.arange(b * stride)
    keep = np.repeat(live, stride) & (rows >= 0) & (rows < n)
    rows, seqs = rows[keep], seqs[keep]
    order = np.argsort(rows, kind="stable")
    rows, seqs = rows[order], seqs[order]
    assert np.all(np.diff(rows) >= 0)

    # One walker per row segment.  The segment's first event carries
    # used[r] plus its values (the row's first addition); the walk starts
    # from -0.0, the additive identity.
    heads = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]]) if len(rows) \
        else np.zeros(0, np.int64)
    ends = np.r_[heads[1:], len(rows)]
    for h, e in zip(heads, ends):
        r = rows[h]
        u = np.full(3, -0.0, np.float32)
        for k, s in enumerate(seqs[h:e]):
            lane, j = divmod(int(s), stride)
            val = dvals[lane, j] if j < d else asks[lane]
            if k == 0:
                val = used[r] + val
            u = u + val
            if j >= d:
                out[lane, j - d, 7] = 1.0 if bool(np.all(u <= totals[r])) \
                    else 0.0
    return out


def plain_verify(totals, used, packed, asks, drows, dvals, lane_mask):
    """``verify_lanes`` on the same numpy operands."""
    b = packed.shape[0]
    req_f = np.zeros((b, tk.REQ_FLOAT_WIDTH), np.float32)
    off = tk.REQ_FLOAT_OFF["ask"][0]
    req_f[:, off:off + 3] = asks
    return tk.verify_lanes(t(totals), t(used), t(packed), t(req_f), t(drows),
                           t(dvals), t(lane_mask)).numpy()


def assert_bits_equal(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


VALUES = [1e8, -1e8, 1.0, -1.0, 0.5, 3.0, 1e-3, 0.0, 2e7, -3e7]
LIMITS = [1e8, 2.0, 0.0, 1.0, 5e7, -1.0, 3e8]


@st.composite
def event_streams(draw):
    """Operands of one verify: few rows so lanes collide, one hot row
    drawn often, out-of-range rows, order-sensitive values."""
    b = draw(st.integers(1, 6))
    p = draw(st.integers(1, 5))
    d = draw(st.integers(0, 5))
    n = draw(st.integers(1, 9))
    hot = draw(st.integers(0, n - 1))
    row = st.one_of(st.just(hot), st.integers(0, n - 1),
                    st.sampled_from([-1, -4, n, n + 6]))

    def arr(strategy, shape, dtype):
        size = int(np.prod(shape))
        return np.array(draw(st.lists(strategy, min_size=size,
                                      max_size=size)), dtype).reshape(shape)

    packed = arr(st.sampled_from(VALUES), (b, p, 7), np.float32)
    packed[..., 0] = arr(row, (b, p), np.int32)
    return dict(
        totals=arr(st.sampled_from(LIMITS), (n, 3), np.float32),
        used=arr(st.sampled_from(VALUES), (n, 3), np.float32),
        packed=packed,
        asks=arr(st.sampled_from(VALUES), (b, 3), np.float32),
        drows=arr(row, (b, d), np.int32),
        dvals=arr(st.sampled_from(VALUES), (b, d, 3), np.float32),
        lane_mask=arr(st.booleans(), (b,), bool),
    )


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(event_streams())
def test_model_matches_plain_on_drawn_streams(w):
    assert_bits_equal(model_verify(**w), plain_verify(**w))


def stream(rng, b, p, d, n, hot_every_lane=False, dead=(), stale=False):
    """A seeded stream with the named features (see the callers)."""
    totals = rng.choice(LIMITS, (n, 3)).astype(np.float32)
    used = rng.choice(VALUES, (n, 3)).astype(np.float32)
    packed = rng.choice(VALUES, (b, p, 7)).astype(np.float32)
    packed[..., 0] = rng.integers(-2, n + 2, (b, p))
    if hot_every_lane:
        packed[:, : max(1, p // 2), 0] = 0
    drows = rng.integers(-1, n + 1, (b, d)).astype(np.int32)
    if d:
        # Deltas on the rows other lanes picked.
        drows[:, 0] = np.roll(packed[:, 0, 0], 1)
    dvals = rng.choice(VALUES, (b, d, 3)).astype(np.float32)
    lane_mask = np.ones((b,), bool)
    lane_mask[list(dead)] = False
    if stale:
        drows[list(dead)] = 0
        dvals[list(dead)] = 1e8
    return dict(totals=totals, used=used, packed=packed,
                asks=rng.choice(VALUES, (b, 3)).astype(np.float32),
                drows=drows, dvals=dvals, lane_mask=lane_mask)


NAMED_STREAMS = {
    "hot_row_every_lane": dict(b=8, p=4, d=2, n=6, hot_every_lane=True),
    "dead_lanes_stale_deltas": dict(b=6, p=3, d=3, n=5, dead=(1, 4),
                                    stale=True),
    "one_pick": dict(b=5, p=1, d=2, n=4),
    "one_lane": dict(b=1, p=6, d=4, n=3),
    "no_deltas": dict(b=4, p=4, d=0, n=3),
    "one_row": dict(b=4, p=3, d=2, n=1),
    "rows_past_16_bits": dict(b=3, p=3, d=3, n=70_000),
}


@pytest.mark.parametrize("name", sorted(NAMED_STREAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches_plain_on_named_streams(name, seed):
    w = stream(np.random.default_rng(seed), **NAMED_STREAMS[name])
    if name == "rows_past_16_bits":
        # Rows over all 17 row bits, some sharing a segment.
        rng = np.random.default_rng(seed)
        w["packed"][..., 0] = rng.choice([5, 70_000 - 1, 1 << 16, 300], (3, 3))
    assert_bits_equal(model_verify(**w), plain_verify(**w))


@pytest.mark.parametrize("case", edge_cases.VERIFY_CASES)
def test_model_matches_plain_on_edge_cases(case):
    """The cases the card tests and the smoke hold the kernel to."""
    w = edge_cases.verify_case(case)
    want = plain_verify(**w)
    assert_bits_equal(model_verify(**w), want)
    verified = want[..., 7]
    if case == "all_dead":
        assert (verified == -1.0).all()
    else:
        assert (verified == 1.0).any()
    if case in ("bench", "hot_row", "large", "order"):
        assert (verified == 0.0).any()


def test_plain_contract_at_the_edges():
    """No row: 1.0; a dead lane: row -1, zeros, -1.0, and its stale deltas
    change no later verdict."""
    w = stream(np.random.default_rng(3), b=4, p=3, d=2, n=4, dead=(1,),
               stale=True)
    w["packed"][0, 0, 0] = -1
    w["packed"][0, 1, 0] = 4
    out = plain_verify(**w)
    assert out[0, 0, 7] == 1.0 and out[0, 1, 7] == 1.0
    assert (out[1, :, 0] == -1.0).all() and (out[1, :, 7] == -1.0).all()
    assert (out[1, :, 1:7] == 0.0).all()
    w2 = dict(w, drows=w["drows"].copy(), dvals=w["dvals"].copy())
    w2["drows"][1] = -1
    np.testing.assert_array_equal(plain_verify(**w2), out)


def colliding_world(seed, lanes):
    """Four small nodes, lanes of mixed fat asks, deltas on rows other
    lanes pick, and (from three lanes on) a dead lane with stale deltas."""
    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=8)
    for _ in range(4):
        m.upsert_node(jmock.node())
    enc = RequestEncoder(m)
    reqs = []
    for _ in range(lanes):
        job = jmock.job()
        res = job.task_groups[0].tasks[0].resources
        res.cpu = int(rng.choice([600, 900, 1200, 1500]))
        res.memory_mb = int(rng.choice([256, 700, 900, 1400]))
        reqs.append(enc.compile(job, job.task_groups[0]).request)
    deltas = {}
    for lane in range(1, lanes, 2):
        deltas[lane] = [(int(rng.integers(0, 4)),
                         tuple(float(v) for v in rng.integers(-300, 900, 3)))
                        for _ in range(int(rng.integers(1, 4)))]
    lm = np.ones((lanes,), bool)
    if lanes >= 3:
        lm[lanes // 2] = False
        deltas[lanes // 2] = [(0, (1e6, 1e6, 0.0))]
    ops = lane_operands(lanes, m.capacity, len(m.class_ids), deltas=deltas)
    return m, stack(reqs), ops, lm


@pytest.mark.parametrize("lanes", [1, 3, 6, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_verify_matches_jax_on_colliding_lanes(seed, lanes):
    """The port's fused entry (placement scan, then ``verify_lanes``)
    against the JAX ``fused_place_batch``: rows, counters and VERIFIED
    exact, scores within the parity tolerance."""
    m, reqs, ops, lm = colliding_world(seed, lanes)
    scan = 3
    feats = jk.features_of(reqs)
    arrays = m.sync()
    want = np.asarray(jk.fused_place_batch(
        arrays, arrays.used, *ops[:5], reqs, *ops[5:], lm,
        n_placements=scan, features=feats))
    pa = port_matrix(m).sync()
    ri, rf = port_requests(reqs)
    got = tk.fused_place_batch(
        pa, pa.used, t(ops[0]), t(ops[1]), t(ops[2]), t(ops[3]), t(ops[4]),
        ri, rf, t(ops[5]), t(ops[6]), t(lm), scan, tk.Features(*feats),
    ).numpy()
    assert_packed_equal(got, want)
    if lanes >= 6:
        assert (want[..., jk.FUSED_PACKED_VERIFIED] == 0.0).any()
