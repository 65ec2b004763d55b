"""The encoded-matrix cache (``NodeMatrix.save_encoded``/``load_encoded``)
against the reference's, on the CPU.

The same seeded nodes and allocs are encoded by each package; a file
written by either loads in the other, equal array by array (NaNs in their
places) and meta by meta, densely and with four home shards. A file of
another format, with a field or an array missing, with a wrong shape, or
not an ``.npz`` at all returns False and leaves the matrix as it was. The
port's first sync after a load is one full upload into new tensors, equal
to a matrix built from scratch, and a sharded sync keeps the home shards.
"""

import copy
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_NODES = 40
CAPACITY = 64


def _pkg(name):
    if name == "jax":
        from nomad_tpu import mock
        from nomad_tpu.state.matrix import NodeMatrix
        from nomad_tpu.structs import types
        return mock, NodeMatrix, types, {}
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.matrix import NodeMatrix
    from nomad_tpu_torch.structs import types
    return mock, NodeMatrix, types, {"device": "cpu"}


def build(name, shard_count=1, seed=3):
    """A matrix of package ``name`` with seeded nodes (classes, racks,
    devices, static ports) and allocs; two nodes removed, so the free
    list is not empty."""
    mock, NodeMatrix, types, kw = _pkg(name)
    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=CAPACITY, **kw)
    if shard_count > 1:
        m.set_shard_count(shard_count)
    nodes = []
    for i in range(N_NODES):
        node = mock.node()
        node.id = node.name = f"node-{i:03d}"
        node.node_class = f"class-{i % 3}"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 4}"
        node.attributes[f"custom.k{i % 5}"] = str(i)
        node.resources.cpu = int(rng.integers(2000, 8000))
        node.resources.memory_mb = int(rng.integers(2048, 16384))
        m.upsert_node(node)
        nodes.append(node)
    for i in rng.choice(N_NODES, size=15, replace=False):
        job = mock.job()
        job.id = f"job-{i}"
        job.priority = int(rng.integers(10, 90))
        nets = ([types.NetworkResource(reserved_ports=[8000 + int(i)])]
                if i % 3 == 0 else [])
        m.add_alloc(types.Allocation(
            id=f"alloc-{i}", node_id=nodes[i].id, job=job,
            resources=types.Resources(
                cpu=int(rng.integers(100, 1500)),
                memory_mb=int(rng.integers(64, 1024)), networks=nets)))
    m.remove_node(nodes[5].id)
    m.remove_node(nodes[17].id)
    return m


def arrays_of(m):
    return {k: np.array(v) for k, v in m.snapshot_host().items()}


def assert_arrays_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def meta_of(path):
    with np.load(str(path)) as data:
        return json.loads(bytes(data["__meta__"]).decode())


def state_of(m):
    """Everything ``load_encoded`` may change, copied."""
    return dict(
        arrays=arrays_of(m), capacity=m.capacity, next_row=m._next_row,
        free=list(m._free), row_of=dict(m.row_of), node_of=dict(m.node_of),
        class_ids=dict(m.class_ids), class_repr=dict(m.class_repr),
        attrs=(m.attrs.slots, dict(m.attrs.slot_of)),
        devs=(m.devices.slots, dict(m.devices.slot_of)),
        shard_count=m.shard_count, version=m.version)


def assert_state_equal(a, b):
    assert_arrays_equal(a["arrays"], b["arrays"])
    assert {k: v for k, v in a.items() if k != "arrays"} == {
        k: v for k, v in b.items() if k != "arrays"}


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_file_of_either_package_loads_in_the_other(tmp_path, writer, reader,
                                                   shards):
    src = build(writer, shards)
    twin = build(reader, shards)
    # Both packages encode the same cluster the same, before any file.
    assert_arrays_equal(arrays_of(src), arrays_of(twin))
    path = tmp_path / "m.npz"
    src.save_encoded(path)
    _, NodeMatrix, _, kw = _pkg(reader)
    dst = NodeMatrix(capacity=16, **kw)
    assert dst.load_encoded(path)
    assert_arrays_equal(arrays_of(dst), arrays_of(src))
    assert dst.snapshot_host()["port_words"].dtype == np.uint32
    for attr in ("capacity", "_next_row", "_free", "row_of", "node_of",
                 "class_ids", "class_repr", "shard_count"):
        assert getattr(dst, attr) == getattr(src, attr), attr
    assert dst.shard_row_counts() == src.shard_row_counts()
    assert dst.attrs.slot_of == src.attrs.slot_of
    assert dst.devices.slot_of == src.devices.slot_of
    # Saved again by the reader: the same arrays and the same meta.
    back = tmp_path / "back.npz"
    dst.save_encoded(back)
    assert meta_of(back) == meta_of(path)
    with np.load(str(path)) as a, np.load(str(back)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _rewrite(src, dst, meta=None, drop=(), arrays=None):
    with np.load(str(src)) as data:
        payload = {k: np.array(data[k]) for k in data.files if k not in drop}
    if meta is not None:
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                            np.uint8)
    payload.update(arrays or {})
    with open(dst, "wb") as fh:
        np.savez(fh, **payload)


def _bad_files(tmp_path, good):
    meta = meta_of(good)
    with np.load(str(good)) as data:
        used = np.array(data["used"])
        port_words = np.array(data["port_words"])
    cases = {}

    def case(name, **kw):
        path = tmp_path / f"{name}.npz"
        _rewrite(good, path, **kw)
        cases[name] = path

    case("format", meta=dict(meta, format=1))
    for field in ("capacity", "next_row", "row_of", "attr_slot_of"):
        m = copy.deepcopy(meta)
        del m[field]
        case(f"no_{field}", meta=m)
    case("no_array", drop=("dyn_used",))
    case("no_meta", drop=("__meta__",))
    case("short_rows", arrays={"used": used[:-1]})
    case("port_words_int32", arrays={"port_words": port_words.view(np.int32)})
    case("capacity_mismatch", meta=dict(meta, capacity=meta["capacity"] * 2))
    case("row_out_of_range", meta=dict(
        meta, row_of=dict(meta["row_of"], ghost=meta["capacity"] + 3)))
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"not a zip file at all")
    cases["junk"] = junk
    cases["missing"] = tmp_path / "nope.npz"
    return cases


def test_mismatch_returns_false_and_leaves_the_matrix(tmp_path):
    good = tmp_path / "good.npz"
    build("port", 4).save_encoded(good)
    for name, path in _bad_files(tmp_path, good).items():
        m = build("port", seed=9)
        before = state_of(m)
        assert m.load_encoded(path) is False, name
        assert_state_equal(state_of(m), before)


def test_reference_refuses_what_the_port_refuses_by_format(tmp_path):
    """The format and a missing array: the reference's own checks, the
    same verdicts."""
    good = tmp_path / "good.npz"
    build("jax").save_encoded(good)
    bad = _bad_files(tmp_path, good)
    for name in ("format", "no_array", "junk", "missing"):
        assert build("jax").load_encoded(bad[name]) is False, name
        assert build("port").load_encoded(bad[name]) is False, name


def test_first_sync_after_a_load_is_a_full_upload(tmp_path):
    from nomad_tpu_torch.ops import kernels as tk
    from nomad_tpu_torch.state.matrix import DeviceArrays

    path = tmp_path / "m.npz"
    built = build("jax")
    built.save_encoded(path)
    m = build("port", seed=9)
    old = m.sync("cpu")
    uploads, scatters = m.full_uploads, m.scatter_syncs
    old_ptr = tk._check_matrix(old, old.used, torch.device("cpu"))
    assert m.load_encoded(path)
    new = m.sync("cpu")
    assert m.full_uploads == uploads + 1 and m.scatter_syncs == scatters
    assert all(getattr(new, f) is not getattr(old, f)
               for f in DeviceArrays._fields)
    fresh = build("port").sync("cpu")
    for f in DeviceArrays._fields:
        a, b = getattr(new, f), getattr(fresh, f)
        assert a.dtype == b.dtype, f
        assert a.numpy().tobytes() == b.numpy().tobytes(), f
    assert tk._check_matrix(new, new.used, torch.device("cpu")) == (
        new.used.shape[0])
    assert old_ptr == old.used.shape[0]
    # The next sync with nothing dirty moves nothing.
    m.sync("cpu")
    assert m.full_uploads == uploads + 1 and m.scatter_syncs == scatters


def test_sharded_sync_after_a_load_keeps_the_home_shards(tmp_path):
    from nomad_tpu_torch.parallel.sharding import (
        make_mesh,
        shard_matrix_arrays,
    )
    from nomad_tpu_torch.state.matrix import DeviceArrays

    src = build("jax", 4)
    path = tmp_path / "m.npz"
    src.save_encoded(path)
    m = build("port", seed=9)
    assert m.load_encoded(path)
    assert m.shard_count == 4
    assert m.shard_row_counts() == src.shard_row_counts()
    assert all(m.home_shard(r) == src.home_shard(r) for r in m.node_of)
    mesh = make_mesh(devices=["cpu"] * 4, batch=1)
    resident = m.sync_sharded(mesh)
    want = shard_matrix_arrays(mesh, DeviceArrays(**{
        f: src.snapshot_host()[f] for f in DeviceArrays._fields}))
    for got_row, want_row in zip(resident.shards, want.shards):
        for g, w in zip(got_row, want_row):
            for f in DeviceArrays._fields:
                assert getattr(g, f).numpy().tobytes() == (
                    getattr(w, f).numpy().tobytes()), f
    # A node registered after the load claims a row on the emptiest shard.
    from nomad_tpu_torch import mock

    node = mock.node()
    row = m.upsert_node(node)
    counts = src.shard_row_counts()
    assert m.home_shard(row) == counts.index(min(counts))
