"""The coalescer's four counters against the reference's on the same burst.

Each package's ``DeviceCoalescer`` (the port's on the CPU) gets the same
matrix and the same lanes, queued together so that each batch is one
dispatch: eight colliding lanes (every node fits one ask, so the verify
column refuses every pick after the first on a node), then a spread lane
that widens the features, then a narrow batch that does not.

- ``verify_conflicts``, ``feature_recompiles`` and, on the fused path,
  ``topk_host_bytes_total`` equal the reference's.
- ``operand_bytes_total`` differs by design: the reference counts its
  request slab's numpy fields, the port uploads the slab packed into two
  tensors (``kernels.pack_requests``); the lane buffers are the same. The
  test holds the port's count to the bytes of the ten tensors it uploads.
- The staged path (``NOMAD_TPU_MEGABATCH=0``) uploads and reads back the
  live lanes only, where the reference pads to ``max_lanes``: both
  counters count the live lanes' bytes.
- The sharded path uploads each batch row's lanes to its node shards
  (here four virtual shards of the CPU) and the verify's operands once
  more to the lead: the counter counts exactly those.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

LANES = 8
SCAN = 2


def _pkg(name):
    if name == "jax":
        from nomad_tpu import mock
        from nomad_tpu.ops import RequestEncoder
        from nomad_tpu.scheduler import coalescer
        from nomad_tpu.state.matrix import NodeMatrix
        from nomad_tpu.structs import types
        return mock, RequestEncoder, coalescer, NodeMatrix, types, {}
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.encode import RequestEncoder
    from nomad_tpu_torch.scheduler import coalescer
    from nomad_tpu_torch.state.matrix import NodeMatrix
    from nomad_tpu_torch.structs import types
    return mock, RequestEncoder, coalescer, NodeMatrix, types, {
        "device": "cpu"}


def _world(name, n_nodes=8):
    mock, RequestEncoder, coalescer, NodeMatrix, types, kw = _pkg(name)
    m = NodeMatrix(capacity=16, **kw)
    for i in range(n_nodes):
        node = mock.node()
        node.id = node.name = f"node-{i:02d}"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 2}"
        node.resources.cpu = 1000 + 10 * i
        node.resources.memory_mb = 4096
        m.upsert_node(node)
    enc = RequestEncoder(m)

    def request(cpu, spread=False):
        job = mock.job()
        tg = job.task_groups[0]
        tg.tasks[0].resources.cpu = cpu
        tg.tasks[0].resources.memory_mb = 64
        if spread:
            tg.spreads = [types.Spread(attribute="${attr.rack}", weight=50)]
        return enc.compile(job, tg).request

    return m, request, coalescer


def _lane(coalescer, m, req):
    n = m.capacity
    return coalescer._Pending(
        request=req,
        delta_rows=np.full((coalescer.MAX_DELTA_ROWS,), -1, np.int32),
        delta_vals=np.zeros((coalescer.MAX_DELTA_ROWS, 3), np.float32),
        tg_count=np.zeros((n,), np.int32),
        spread_counts=np.zeros_like(req.s_desired),
        penalty=np.zeros((n,), bool),
        class_elig=np.ones((2,), bool),
        host_mask=np.ones((n,), bool),
    )


def _burst(name, device=None):
    """The three batches through one coalescer; returns it (stopped) and
    the outcomes of every lane, batch by batch."""
    m, request, coalescer = _world(name)
    kw = {} if name == "jax" else {"device": device or "cpu"}
    coal = coalescer.DeviceCoalescer(m, max_lanes=LANES, scan_length=SCAN,
                                     linger_s=0.0, pipeline_depth=1, **kw)
    batches = [
        [request(900) for _ in range(LANES)],
        [request(300, spread=True)],
        [request(200), request(250)],
    ]
    outcomes = []
    coal.start()
    try:
        for reqs in batches:
            lanes = [_lane(coalescer, m, r) for r in reqs]
            with coal._cond:
                coal._queue.extend(lanes)
                coal._cond.notify_all()
            for p in lanes:
                assert p.done.wait(60), "lane never resolved"
                assert p.error is None, p.error
            outcomes.append([p.outcome for p in lanes])
    finally:
        coal.stop()
    assert coal.dispatches == len(batches)
    return coal, outcomes


def _conflicts(outcomes):
    return sum(int((~o.fit_verified).sum()) for batch in outcomes
               for o in batch if o.fit_verified is not None)


def _lane_bytes(n, cw, sc_shape, k):
    """Bytes of the staged lane buffers for ``k`` lanes (host mask, tg
    counts, penalty, class eligibility, spread counts, delta rows and
    values; the lane mask is added by the caller)."""
    from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS

    per = (n + 4 * n + n + cw + 4 * int(np.prod(sc_shape))
           + 4 * MAX_DELTA_ROWS + 12 * MAX_DELTA_ROWS)
    return k * per


def _request_bytes(k, ints=True):
    """Bytes of ``k`` packed requests: the int32 and float32 tensors, or
    the float32 one alone."""
    from nomad_tpu_torch.ops import kernels as tk

    return k * 4 * ((tk.REQ_INT_WIDTH if ints else 0) + tk.REQ_FLOAT_WIDTH)


@pytest.fixture(scope="module")
def fused_pair():
    return {name: _burst(name) for name in ("jax", "port")}


def test_verify_conflicts_match_the_reference(fused_pair):
    (jc, jout), (pc, pout) = fused_pair["jax"], fused_pair["port"]
    assert pc.verify_conflicts == jc.verify_conflicts
    assert pc.verify_conflicts == _conflicts(pout) == _conflicts(jout)
    # Eight lanes on one best node: at least the first pick stands.
    assert 0 < pc.verify_conflicts < LANES * SCAN
    for pb, jb in zip(pout, jout):
        for po, jo in zip(pb, jb):
            np.testing.assert_array_equal(po.rows, jo.rows)
            np.testing.assert_array_equal(po.fit_verified, jo.fit_verified)


def test_feature_recompiles_match_the_reference(fused_pair):
    (jc, _), (pc, _) = fused_pair["jax"], fused_pair["port"]
    assert pc.feature_recompiles == jc.feature_recompiles == 2
    assert pc._features == type(pc._features)(*jc._features)


def test_topk_host_bytes_match_the_reference(fused_pair):
    """Three fused tickets, each a (max_lanes, P, 8) float32 result."""
    (jc, _), (pc, _) = fused_pair["jax"], fused_pair["port"]
    assert pc.topk_host_bytes_total == jc.topk_host_bytes_total
    assert pc.topk_host_bytes_total == 3 * LANES * SCAN * 8 * 4


def test_operand_bytes_are_what_the_fused_dispatch_uploads(fused_pair):
    """The port's count is the ten uploaded tensors of three full-width
    dispatches; it differs from the reference's only by the request
    encoding (slab fields there, two packed tensors here)."""
    (jc, _), (pc, _) = fused_pair["jax"], fused_pair["port"]
    st = pc._stage
    n, cw = st["host_mask"].shape[1], st["class_elig"].shape[1]
    sc_shape = st["spread_counts"].shape[1:]
    per_dispatch = (_lane_bytes(n, cw, sc_shape, LANES) + LANES
                    + _request_bytes(LANES))
    assert pc.operand_bytes_total == 3 * per_dispatch
    lanes_only = 3 * (_lane_bytes(n, cw, sc_shape, LANES) + LANES)
    assert (jc.operand_bytes_total - lanes_only
            == 3 * jc._req_slab.nbytes())


def test_staged_path_counts_the_live_lanes(monkeypatch):
    """Without the megabatch the port launches the live lanes only: each
    dispatch uploads and reads back ``k`` lanes (8, 1, 2), where the
    reference pads every dispatch to ``max_lanes``."""
    monkeypatch.setenv("NOMAD_TPU_MEGABATCH", "0")
    pc, pout = _burst("port")
    assert not pc.megabatch and pc.fused_dispatches == 0
    assert pc.verify_conflicts == 0 and _conflicts(pout) == 0
    st = pc._stage
    n, cw = st["host_mask"].shape[1], st["class_elig"].shape[1]
    sc_shape = st["spread_counts"].shape[1:]
    ks = (LANES, 1, 2)
    assert pc.operand_bytes_total == sum(
        _lane_bytes(n, cw, sc_shape, k) + _request_bytes(k) for k in ks)
    assert pc.topk_host_bytes_total == sum(k * SCAN * 7 * 4 for k in ks)
    assert pc.feature_recompiles == 0


def test_sharded_path_counts_each_shards_cut():
    """Four virtual node shards of the CPU (one batch row): the lane-wide
    operands go up once, each shard gets its cut of the node-axis ones,
    and the verify uploads its four operands once more; the conflicts and
    the result bytes equal the unsharded port's."""
    pc, pout = _burst("port", device=["cpu"] * 4)
    fc, fout = _burst("port")
    assert pc.fused_dispatches == 3
    assert pc.verify_conflicts == fc.verify_conflicts == _conflicts(pout)
    assert pc.topk_host_bytes_total == fc.topk_host_bytes_total
    assert pc.feature_recompiles == fc.feature_recompiles
    st = pc._stage
    n, cw = st["host_mask"].shape[1], st["class_elig"].shape[1]
    sc_shape = st["spread_counts"].shape[1:]
    from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS

    lanes = _lane_bytes(n, cw, sc_shape, LANES) + LANES + _request_bytes(
        LANES)
    verify = (LANES * (4 * MAX_DELTA_ROWS + 12 * MAX_DELTA_ROWS + 1)
              + _request_bytes(LANES, ints=False))
    assert pc.operand_bytes_total == 3 * (lanes + verify)
