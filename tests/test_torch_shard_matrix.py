"""The port's sharded node matrix against the JAX package's, on the CPU.

Home-shard claims and growth (the reference's tests/test_parallel.py
TestShardHoming), the evacuation layout and ``translate_rows``
(tests/test_device_fault.py TestShardEvacuationParity) and the
incremental sharded sync (tests/test_pipeline.py TestShardedResidency),
each run on both packages with the same nodes in the same order: the
port's rows must equal the reference's.  Then the coalescer's
evacuation and heal on a live sharded server, and the sharded mirror
after a snapshot install.
"""

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.state import NodeMatrix as JMatrix
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.obs import top
from nomad_tpu_torch.parallel import sharding as tsh
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.state.matrix import DeviceArrays, NodeMatrix
from nomad_tpu_torch.structs import serde

torch.set_num_threads(1)


def twin_nodes(k, seed=0):
    """k (JAX node, port node) pairs with the same id and resources."""
    pairs = []
    for i in range(k):
        j = jmock.node()
        j.id = f"node-{seed}-{i:03d}"
        j.name = f"n{i}"
        t = tmock.node()
        t.id, t.name = j.id, j.name
        pairs.append((j, t))
    return pairs


def both(capacity=16, shards=4):
    jm, tm = JMatrix(capacity=capacity), NodeMatrix(capacity=capacity,
                                                   device="cpu")
    if shards > 1:
        jm.set_shard_count(shards)
        tm.set_shard_count(shards)
    return jm, tm


def test_claims_and_growth_keep_home_shards():
    """Claims balance across home shards, growth keeps every row's shard,
    translate_rows maps rows from before the growth, and a removal then
    a reclaim stay balanced — row for row as in the reference."""
    jm, tm = both()
    pairs = twin_nodes(12)
    for j, t in pairs:
        assert jm.upsert_node(j) == tm.upsert_node(t)
    assert tm.shard_row_counts() == [3, 3, 3, 3] == jm.shard_row_counts()
    homes = {t.id: tm.home_shard(tm.row_of[t.id]) for _, t in pairs}
    v0 = tm.version
    old_rows = np.array([tm.row_of[t.id] for _, t in pairs], np.int32)
    for j, t in twin_nodes(8, seed=1):
        assert jm.upsert_node(j) == tm.upsert_node(t)
    assert tm.capacity == 32 == jm.capacity
    assert tm.row_of == jm.row_of
    for _, t in pairs:
        assert tm.home_shard(tm.row_of[t.id]) == homes[t.id]
    want = np.array([tm.row_of[t.id] for _, t in pairs], np.int32)
    np.testing.assert_array_equal(tm.translate_rows(old_rows, v0), want)
    np.testing.assert_array_equal(
        tm.translate_rows(old_rows, v0), jm.translate_rows(old_rows, v0))
    np.testing.assert_array_equal(
        tm.translate_rows(np.array([-1, -1], np.int32), v0), [-1, -1])
    np.testing.assert_array_equal(tm.translate_rows(want, tm.version), want)
    for j, t in pairs[:4]:
        jm.remove_node(j.id)
        tm.remove_node(t.id)
    j, t = twin_nodes(1, seed=2)[0]
    assert jm.upsert_node(j) == tm.upsert_node(t)
    assert sum(tm.shard_row_counts()) == 17
    assert tm.shard_row_counts() == jm.shard_row_counts()
    for f in DeviceArrays._fields:
        np.testing.assert_array_equal(tm.snapshot_host()[f],
                                      jm.snapshot_host()[f], err_msg=f)


def test_unsharded_matrix_keeps_the_dense_policy():
    tm = NodeMatrix(capacity=16, device="cpu")
    for _, t in twin_nodes(20):
        tm.upsert_node(t)
    assert tm.capacity == 32 and tm.n_rows == 20 and not tm._remaps
    np.testing.assert_array_equal(
        tm.translate_rows(np.array([5], np.int32), 0), [5])
    assert tm.shard_row_counts() == [20]


def test_remap_window_drops_rows_older_than_it():
    tm = NodeMatrix(capacity=16, device="cpu")
    tm.set_shard_count(2)
    for _, t in twin_nodes(4):
        tm.upsert_node(t)
    v0 = tm.version
    rows = np.array([0, 8, -1], np.int32)
    for _ in range(NodeMatrix._REMAP_KEEP + 1):
        tm.relayout_shards(2)
    np.testing.assert_array_equal(tm.translate_rows(rows, v0), [-1, -1, -1])


@pytest.mark.parametrize("lost", [0, 1, 3])
def test_evacuation_layout_matches_from_scratch_survivors(lost):
    jm, tm = both()
    pairs = twin_nodes(12)
    for j, t in pairs:
        jm.upsert_node(j)
        tm.upsert_node(t)
    order = [tm.node_of[r] for r in sorted(tm.node_of)]
    by_id = {t.id: t for _, t in pairs}
    before = tm.version
    mapping = tm.evacuate_shard(lost)
    np.testing.assert_array_equal(mapping, jm.evacuate_shard(lost))
    assert tm.shard_count == 3 and tm.version > before
    assert tm.row_of == jm.row_of
    twin = NodeMatrix(capacity=tm.capacity, device="cpu")
    twin.set_shard_count(3)
    for nid in order:
        twin.upsert_node(by_id[nid])
    assert twin.row_of == tm.row_of
    assert tm.capacity % 3 == 0


def test_relayout_translates_inflight_rows():
    tm = NodeMatrix(capacity=16, device="cpu")
    tm.set_shard_count(4)
    for _, t in twin_nodes(8):
        tm.upsert_node(t)
    old = dict(tm.row_of)
    v0 = tm.version
    tm.evacuate_shard(0)
    nids = sorted(old)
    got = tm.translate_rows(np.array([old[n] for n in nids], np.int32), v0)
    assert got.tolist() == [tm.row_of[n] for n in nids]
    with pytest.raises(ValueError):
        NodeMatrix(capacity=16, device="cpu").evacuate_shard(0)
    with pytest.raises(ValueError):
        tm.evacuate_shard(7)


def test_incremental_sharded_sync_scatters_only_dirty_rows():
    """After the first full lay-out the sharded copy stays resident: a
    clean sync moves nothing, dirty rows scatter O(rows) bytes, and every
    copy equals the host rows."""
    tm = NodeMatrix(capacity=16, device="cpu")
    nodes = [t for _, t in twin_nodes(12)]
    for n in nodes:
        tm.upsert_node(n)
    mesh = tsh.make_mesh(8, batch=2, devices=["cpu"] * 8)

    def assert_parity(sharded):
        for f in DeviceArrays._fields:
            host = tm.snapshot_host()[f]
            for row in sharded.shards:
                got = torch.cat([getattr(a, f) for a in row]).numpy()
                if f == "port_words":
                    got = got.view(np.uint32)
                np.testing.assert_array_equal(got, host, err_msg=f)

    dev = tm.sync_sharded(mesh)
    assert tm.full_uploads == 1 and tm.scatter_syncs == 0
    full = tm.upload_bytes_total
    assert_parity(dev)
    assert tm.sync_sharded(mesh) is dev and tm.upload_bytes_total == full
    tm.set_eligibility(nodes[3].id, False)
    tm.add_alloc(tmock.alloc(tmock.job(), nodes[5]))
    dev3 = tm.sync_sharded(mesh)
    assert dev3 is dev
    assert tm.full_uploads == 1 and tm.scatter_syncs == 1
    assert 1 <= tm.rows_scattered_total <= 4
    assert 0 < tm.upload_bytes_total - full < full // 2
    assert_parity(dev3)
    # A clear (a snapshot install) and a new mesh lay out anew,
    # into new tensors.
    tm.clear()
    after = tm.sync_sharded(mesh)
    assert after is not dev and tm.full_uploads == 2
    assert_parity(after)
    other = tsh.make_mesh(4, batch=2, devices=["cpu"] * 4)
    assert tm.sync_sharded(other).mesh is other and tm.full_uploads == 3


# ---------------------------------------------------------------------------
# The coalescer on a live server
# ---------------------------------------------------------------------------


def settle(srv, evals, timeout=60):
    for ev in evals:
        done = srv.wait_for_eval(ev.id, timeout=timeout)
        assert done is not None and done.status == "complete", done


def service(i, count=2):
    job = tmock.job()
    job.id = f"svc-{i}"
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 64
    return job


def test_evacuate_and_heal_on_a_live_server():
    """Four virtual CPU shards (batch 2 x node 2): evacuating node shard 1
    mid-burst leaves every eval complete, the survivors' layout equals a
    from-scratch one, and the heal restores two shards; the gauges and the
    breaker count the evacuation."""
    srv = Server(ServerConfig(num_workers=4, node_capacity=64,
                              heartbeat_min_ttl=3600, heartbeat_max_ttl=7200,
                              slo_enabled=False, overload_enabled=False),
                 device=["cpu"] * 4)
    srv.start()
    try:
        nodes = [t for _, t in twin_nodes(24)]
        evals = [srv.submit_job(service(0))]
        settle(srv, evals)  # the first dispatch homes the matrix
        coal = srv.coalescer
        assert coal.n_device_shards == 4 and srv.matrix.shard_count == 2
        for n in nodes:
            srv.register_node(n)
        evals = [srv.submit_job(service(i)) for i in range(1, 9)]
        order = [srv.matrix.node_of[r] for r in sorted(srv.matrix.node_of)]
        assert coal.evacuate_shard(1) == 1
        evals += [srv.submit_job(service(i)) for i in range(9, 17)]
        settle(srv, evals)
        assert coal.n_device_shards == 2 and coal.shard_evacuations == 1
        twin = NodeMatrix(capacity=srv.matrix.capacity, device="cpu")
        by_id = {n.id: n for n in nodes}
        for nid in order:
            twin.upsert_node(by_id[nid])
        assert twin.row_of == srv.matrix.row_of
        snap = srv.metrics.snapshot()
        assert snap["nomad.coalescer.shard_evacuations"] == 1
        assert coal.breaker.evacuations == 1
        # `top`'s shard-balance row reads the shard_rows gauges.
        assert "shards  : rows " in top.render(snap, None, None)
        assert coal.heal_shard_evacuations() == 2
        assert coal.heal_shard_evacuations() is None
        evals = [srv.submit_job(service(i)) for i in range(17, 25)]
        settle(srv, evals)
        assert srv.matrix.shard_count == 2 and coal.n_device_shards == 4
        assert sum(srv.matrix.shard_row_counts()) == 24
        assert len(srv.store.allocs) == 2 * 25
        for a in srv.store.allocs.values():
            assert a.node_id in srv.matrix.row_of
    finally:
        srv.shutdown()


def test_install_snapshot_relays_the_sharded_copy():
    """After an install the first sharded sync lays the image out in full,
    into new tensors, and the server keeps placing over the mesh."""
    src = Server(ServerConfig(num_workers=2, node_capacity=64,
                              slo_enabled=False, overload_enabled=False),
                 device="cpu")
    dst = Server(ServerConfig(num_workers=2, node_capacity=64,
                              heartbeat_min_ttl=3600, heartbeat_max_ttl=7200,
                              slo_enabled=False, overload_enabled=False),
                 device=["cpu"] * 4)
    src.start()
    dst.start()
    try:
        for _, t in twin_nodes(6, seed=5):
            src.register_node(t)
        for _, t in twin_nodes(6, seed=6):
            dst.register_node(t)
        settle(dst, [dst.submit_job(service(0))])
        before = dst.matrix._sharded_device
        uploads = dst.matrix.full_uploads
        image = serde.to_wire(src.store.to_snapshot_wire())
        dst.install_snapshot(image, src.store.latest_index)
        settle(dst, [dst.submit_job(service(1))])
        assert dst.matrix._sharded_device is not before
        assert dst.matrix.full_uploads > uploads
        placed = {a.node_id for a in dst.store.allocs_by_job("default",
                                                             "svc-1")}
        assert placed and placed <= set(src.matrix.row_of)
    finally:
        src.shutdown()
        dst.shutdown()
