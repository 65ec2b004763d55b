"""The port's node matrix: host mirror and resident tensors.

After seeded upserts, alloc add/remove, eligibility flips, node removal and
capacity growth, ``sync(device="cpu")`` must equal ``snapshot_host()`` bit
for bit; the port's host mirror must track the JAX package's under the
same mutations; and ``carry.matrix_from_host`` must round-trip.
"""

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.state import NodeMatrix as JNodeMatrix
from nomad_tpu.structs import types as jtypes
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.state import carry
from nomad_tpu_torch.state.matrix import DeviceArrays, NodeMatrix
from nomad_tpu_torch.structs import types as ttypes


# One intra-op thread: these tests share the host's cores with the
# other test workers, whose timing tests a thread pool would starve.
torch.set_num_threads(1)

def bits(a: np.ndarray) -> np.ndarray:
    """A bitwise view (NaN payloads compare too)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.float32 or a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def assert_synced(m: NodeMatrix) -> None:
    arrays = m.sync("cpu")
    host = m.snapshot_host()
    for f in DeviceArrays._fields:
        got = getattr(arrays, f).numpy()
        np.testing.assert_array_equal(bits(got), bits(host[f]), err_msg=f)


def mutate(mock, types, m, seed=3, n_nodes=40):
    """A seeded mutation sequence on either package's matrix; returns the
    node ids in registration order."""
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(n_nodes):
        node = mock.node()
        node.id = f"node-{i:03d}"
        node.name = node.id
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 5}"
        if i % 6 == 0:
            node.attributes["cpu.numcores"] = str(int(rng.integers(2, 64)))
        if i % 9 == 0:
            node.reserved.reserved_ports = [22, 8500]
        m.upsert_node(node)
        ids.append(node.id)
        yield "upsert"
    allocs = []
    for j in range(60):
        nid = ids[int(rng.integers(0, n_nodes))]
        nets = []
        if j % 4 == 0:
            nets = [types.NetworkResource(reserved_ports=[8080 + j])]
        alloc = types.Allocation(
            id=f"alloc-{j}",
            node_id=nid,
            job=types.Job(priority=int(rng.integers(10, 95))),
            resources=types.Resources(
                cpu=int(rng.integers(50, 900)),
                memory_mb=int(rng.integers(32, 1024)),
                networks=nets,
            ),
        )
        if j % 7 == 0:
            alloc.assigned_ports = {"web": {"http": 20000 + j}}
        m.add_alloc(alloc)
        allocs.append(alloc)
    yield "allocs"
    for alloc in allocs[::3]:
        m.remove_alloc(alloc)
    for nid in ids[::4]:
        m.set_eligibility(nid, False)
    yield "remove+flip"
    for nid in ids[5:9]:
        m.remove_node(nid)
    yield "remove-nodes"


@pytest.mark.parametrize("checkpoint", ["upsert", "allocs", "remove+flip",
                                        "remove-nodes"])
def test_sync_equals_host_bit_for_bit(checkpoint):
    m = NodeMatrix(capacity=16, device="cpu")
    seen = False
    for step in mutate(tmock, ttypes, m):
        if step == "upsert" and m.n_rows in (8, 17, 33):
            assert_synced(m)  # before and after the growth to 32 / 64
        if step == checkpoint:
            seen = True
            assert_synced(m)
    assert seen
    assert m.capacity == 64
    assert m.full_uploads >= 2  # growth re-uploads in full
    assert_synced(m)


def test_dirty_rows_scatter_incrementally():
    m = NodeMatrix(capacity=64, device="cpu")
    for _ in mutate(tmock, ttypes, m):
        pass
    m.sync()
    full, scatters = m.full_uploads, m.scatter_syncs
    nid = m.node_of[3]
    m.set_eligibility(nid, True)
    m.set_eligibility(nid, False)
    arrays = m.sync()
    assert m.full_uploads == full
    assert m.scatter_syncs == scatters + 1
    assert not bool(arrays.eligible[3])
    assert m.sync() is arrays  # nothing dirty: no transfer


def test_host_mirror_tracks_reference():
    """Same mutations on both packages' matrices → identical host arrays,
    registries and row maps."""
    jm = JNodeMatrix(capacity=16)
    tm = NodeMatrix(capacity=16, device="cpu")
    for a, b in zip(mutate(jmock, jtypes, jm), mutate(tmock, ttypes, tm)):
        assert a == b
        for f in DeviceArrays._fields:
            np.testing.assert_array_equal(
                bits(tm.snapshot_host()[f]), bits(jm.snapshot_host()[f]),
                err_msg=f"{f} after {a}")
    assert tm.row_of == jm.row_of
    assert tm.class_ids == jm.class_ids
    assert tm.attrs.slot_of == jm.attrs.slot_of


def test_matrix_from_host_roundtrips():
    jm = JNodeMatrix(capacity=16)
    for _ in mutate(jmock, jtypes, jm):
        pass
    host = jm.snapshot_host()
    pm = carry.matrix_from_host(host, jm.attrs.slot_of, jm.class_ids,
                                jm.row_of, "cpu", class_repr=jm.class_repr,
                                dev_slots=jm.devices.slot_of)
    for f in DeviceArrays._fields:
        np.testing.assert_array_equal(bits(pm.snapshot_host()[f]),
                                      bits(host[f]), err_msg=f)
    assert_synced(pm)
    assert pm.row_of == jm.row_of and pm.class_repr == jm.class_repr
    # The carried matrix keeps working: a new node lands on the same row
    # the reference would give it.
    node_j, node_t = jmock.node(), tmock.node()
    node_j.id = node_t.id = "late-node"
    assert pm.upsert_node(node_t) == jm.upsert_node(node_j)
    assert_synced(pm)


def test_cuda_sync_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = NodeMatrix(capacity=16)
    m.upsert_node(tmock.node())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.sync()
