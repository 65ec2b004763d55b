"""Edge shapes for the tiled ``score_batch`` and the hoisted ``fused_place``
scan, buildable with either package.

The CPU parity tests build each case with the JAX package and carry it
into the port (``state/carry.py``); the card tests and ``chip_smoke.py``
build the same case with the port alone (the chip machine has no JAX).
:func:`build` takes a package's types as a namespace (:func:`package`;
``torch_parity.jax_edge_pkg`` for the JAX package) and returns numpy
operands, so both see identical inputs.  This file imports neither
package itself.

The cases stress what the kernels' tiling and hoisting make risky:

* ``ragged`` — 300 nodes at capacity 333 (a multiple of no tile) and 11
  lanes (a multiple of no lane tile): every scoring stage, in-flight
  deltas with a row twice, tg counts, penalties, distinct_hosts,
  preemption and an ask that never fits.
* ``single_lane`` — B=1, a spread lane whose value table the scan fills.
* ``ties`` — 300 identical nodes: the best score ties on every feasible
  row, and host masks start the feasible rows past one and two node
  tiles (rows 140 and 257), so the lowest row must win across tiles and
  across the CTAs of a cluster.
* ``spread_tables`` — two spread stanzas (``s_width=2``), value tables
  with duplicate hashes and a free slot between used ones (a new value
  lands there mid-scan), a full table (no value can be added), even and
  targeted stanzas with counts.
* ``fails_first`` — lanes whose scan fails at step 0 (an ask that never
  fits, a host mask with no node), a distinct_hosts lane that already
  holds allocs on its best nodes, and preemption.
"""

import types

import numpy as np

CASES = ("ragged", "single_lane", "ties", "spread_tables", "fails_first")
SCAN = 4


def package(structs, encode, matrix):
    """The types :func:`build` needs, from a package's ``structs``,
    ``ops.encode`` and ``state.matrix`` modules."""
    ns = types.SimpleNamespace(**{
        name: getattr(structs, name) for name in (
            "Affinity", "Allocation", "Constraint", "DriverInfo", "Job",
            "NetworkResource", "Node", "NodeResources", "RequestedDevice",
            "Resources", "Spread", "SpreadTarget", "Task", "TaskGroup")})
    ns.RequestEncoder = encode.RequestEncoder
    ns.MAX_SPREADS = encode.MAX_SPREADS
    ns.MAX_SPREAD_VALUES = encode.MAX_SPREAD_VALUES
    ns.NodeMatrix = matrix.NodeMatrix
    ns.stable_hash = matrix.stable_hash
    return ns


def port_pkg():
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.ops import encode
    from nomad_tpu_torch.state import matrix

    return package(structs, encode, matrix)


def _node(pkg, rng, i, identical=False):
    if identical:
        attrs = {"rack": "r0", "kernel.name": "linux"}
        res = pkg.NodeResources(cpu=4000, memory_mb=8192, disk_mb=100 * 1024)
        return pkg.Node(datacenter="dc1", node_class="class-0",
                        attributes=attrs, resources=res,
                        drivers={"mock": pkg.DriverInfo()})
    attrs = {"rack": f"r{i % 8}",
             "kernel.name": "linux" if i % 5 else "darwin",
             "os.version": f"{1 + i % 3}.{i % 4}.0"}
    if i % 7:
        attrs["cpu.numcores"] = str(int(rng.integers(2, 64)))
    return pkg.Node(
        datacenter="dc1" if i % 3 else "dc2", node_class=f"class-{i % 4}",
        attributes=attrs,
        resources=pkg.NodeResources(cpu=int(rng.integers(2000, 8000)),
                                    memory_mb=int(rng.integers(2048, 16384)),
                                    disk_mb=100 * 1024),
        drivers={"mock": pkg.DriverInfo()})


def _cluster(pkg, rng, n_nodes, capacity, identical=False, n_allocs=0):
    m = pkg.NodeMatrix(capacity=capacity)
    nodes = [_node(pkg, rng, i, identical) for i in range(n_nodes)]
    for node in nodes:
        m.upsert_node(node)
    for i in rng.choice(n_nodes, size=n_allocs, replace=False):
        m.add_alloc(pkg.Allocation(
            node_id=nodes[i].id, job=pkg.Job(priority=int(rng.integers(10, 90))),
            resources=pkg.Resources(
                cpu=int(rng.integers(100, 2500)),
                memory_mb=int(rng.integers(64, 4096)),
                networks=[pkg.NetworkResource(reserved_ports=[8080])]
                if i % 4 == 0 else [])))
    return m


def _job(pkg, cpu=400, mem=256, count=1, constraints=(), affinities=(),
         spreads=(), networks=(), **kw):
    tg = pkg.TaskGroup(
        name="web", count=count,
        tasks=[pkg.Task(resources=pkg.Resources(cpu=cpu, memory_mb=mem,
                                                networks=list(networks)))],
        constraints=list(constraints), affinities=list(affinities),
        spreads=list(spreads))
    return pkg.Job(task_groups=[tg], **kw)


def _jobs(pkg, name):
    """(job, algorithm, preemption) per lane."""
    C, A, S, T = pkg.Constraint, pkg.Affinity, pkg.Spread, pkg.SpreadTarget
    rack = S(attribute="${attr.rack}", weight=70)
    dcs = S(attribute="${node.datacenter}", weight=30,
            targets=[T(value="dc1", percent=70), T(value="dc2", percent=30)])
    mix = [
        (_job(pkg), "binpack", False),
        (_job(pkg, cpu=700, mem=512), "spread", False),
        (_job(pkg, cpu=300, constraints=[
            C(l_target="${attr.kernel.name}", operand="=", r_target="linux"),
            C(l_target="${attr.cpu.numcores}", operand=">=", r_target="16"),
            C(l_target="${attr.os.version}", operand="version",
              r_target=">= 2.1")]), "binpack", False),
        (_job(pkg, cpu=200, affinities=[
            A(l_target="${attr.rack}", operand="=", r_target="r3", weight=80),
            A(l_target="${attr.kernel.name}", operand="=", r_target="darwin",
              weight=-40)]), "binpack", False),
        (_job(pkg, cpu=250, spreads=[rack, dcs]), "binpack", False),
        (_job(pkg, cpu=3500, mem=6000, priority=90), "binpack", True),
        (_job(pkg, cpu=300, networks=[pkg.NetworkResource(
            reserved_ports=[8080], dynamic_ports=["http"])],
            constraints=[C(operand="distinct_hosts")]), "binpack", False),
        (_job(pkg, cpu=100000, mem=100), "binpack", False),  # never fits
    ]
    if name == "ragged":
        return mix + mix[:3]
    if name == "single_lane":
        return [(_job(pkg, cpu=250, spreads=[rack]), "binpack", False)]
    if name == "ties":
        return [(_job(pkg), "binpack", False)] * 9
    if name == "spread_tables":
        return [
            (_job(pkg, spreads=[rack]), "binpack", False),
            (_job(pkg, spreads=[dcs]), "binpack", False),
            (_job(pkg, spreads=[rack, dcs]), "binpack", False),
            (_job(pkg, spreads=[rack]), "binpack", False),  # a full table
            (_job(pkg), "binpack", False),
        ]
    if name == "fails_first":
        return [mix[7], mix[0], mix[6], mix[5], mix[6]]
    raise ValueError(name)


def build(pkg, name, seed=23):
    """Case ``name`` with ``pkg``'s types: ``m`` (its NodeMatrix), ``reqs``
    (the lanes' stacked numpy request) and the numpy per-lane operands
    ``drows``, ``dvals``, ``tg``, ``counts``, ``pen``, ``ce``, ``hm`` and
    ``lane_mask``."""
    rng = np.random.default_rng(seed)
    n_nodes, capacity = (300, 333) if name == "ragged" else (300, 300)
    m = _cluster(pkg, rng, n_nodes, capacity, identical=name == "ties",
                 n_allocs=0 if name == "ties" else 90)
    enc = pkg.RequestEncoder(m)
    comp = [enc.compile(j, j.task_groups[0], algorithm=alg,
                        preemption_enabled=pre)
            for j, alg, pre in _jobs(pkg, name)]
    reqs = [c.request for c in comp]
    reqs = type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])
    b, n = reqs.ask.shape[0], m.capacity
    S, V = pkg.MAX_SPREADS, pkg.MAX_SPREAD_VALUES
    h = pkg.stable_hash
    s_hash = np.array(reqs.s_value_hash, copy=True)
    s_desired = np.array(reqs.s_desired, copy=True)
    counts = np.zeros((b, S, V), np.float32)
    drows = np.full((b, 4), -1, np.int32)
    dvals = np.zeros((b, 4, 3), np.float32)
    tg = np.zeros((b, n), np.int32)
    pen = np.zeros((b, n), bool)
    n_cls = max(2, len(m.class_ids))
    ce = np.ones((b, n_cls), bool)
    hm = np.ones((b, n), bool)
    hm[:, n_nodes:] = False
    lane_mask = np.ones((b,), bool)

    if name == "ragged":
        drows[1, :2] = [5, 5]
        dvals[1, :2] = [[300, 200, 0], [100, 50, 0]]
        drows[4, 0] = 17
        dvals[4, 0] = [900, 700, 0]
        tg[:, 10:30] = rng.integers(0, 3, (b, 20))
        pen[:, 40:60] = rng.random((b, 20)) < 0.5
        ce[2, 1] = False
        hm[3, ::9] = False
        lane_mask[b - 2] = False
    elif name == "single_lane":
        s_hash[0, 0, :3] = [h("r1"), h("r4"), h("r1")]
        counts[0, 0, :3] = [1, 2, 1]
    elif name == "ties":
        hm[1, :140] = False
        hm[2, :257] = False
        hm[3, 257:] = False
        pen[4, 0] = True
        hm[5, :] = False
        hm[5, [129, 131, 299]] = True
        tg[6, 0] = 2
    elif name == "spread_tables":
        # Stanza 0 (rack, even): a duplicate and a free slot between used
        # ones; the scan's new racks land in slot 2 first.
        for lane in (0, 2):
            s_hash[lane, 0, :4] = [h("r1"), h("r1"), 0, h("r3")]
            counts[lane, 0, :4] = [1, 2, 0, 1]
        # The targeted dc stanza with a duplicate of its first target.
        for lane, s in ((1, 0), (2, 1)):
            s_hash[lane, s, 3] = s_hash[lane, s, 0]
            s_desired[lane, s, 3] = s_desired[lane, s, 0]
            counts[lane, s, :4] = [2, 1, 0, 1]
        # A full table: every value hash distinct, no room for another.
        s_hash[3, 0, :] = [h(f"x{v}") for v in range(V)]
        s_hash[3, 0, :3] = [h("r0"), h("r2"), h("r5")]
        counts[3, 0, :] = rng.integers(0, 3, V)
    elif name == "fails_first":
        hm[1, :] = False
        # The distinct_hosts lanes already hold allocs on a third of the nodes.
        tg[2, ::3] = 1
        tg[4, :] = 1
        tg[4, 250:] = 0
    reqs = reqs._replace(s_value_hash=s_hash, s_desired=s_desired)
    return dict(m=m, reqs=reqs, drows=drows, dvals=dvals, tg=tg,
                counts=counts, pen=pen, ce=ce, hm=hm, lane_mask=lane_mask,
                scan=SCAN)


# ---------------------------------------------------------------------------
# allocs_fit_verify: event streams for the row-segmented cross-lane scan
# ---------------------------------------------------------------------------

# * ``bench`` — the bench batch's sizes (B=64, P=16, D=32) on 10,240 rows:
#   lanes that collide on a few nearly full rows, in-flight deltas, picks
#   with no row, six dead lanes.
# * ``hot_row`` — every pick of every lane on one row, deltas on it too:
#   one segment of 1,000-odd events.
# * ``large`` — B=64 with D = 1,024 delta rows a lane (MAX_LANE_DELTAS):
#   past the kernel's shared-memory tier.
# * ``single_lane`` — B=1.
# * ``all_dead`` — every lane dead, with stale deltas and picks.
# * ``order`` — order-sensitive values (1e8, 1, -1e8) on shared rows,
#   delta and pick rows < 0 and >= n, dead lanes with stale deltas.
VERIFY_CASES = ("bench", "hot_row", "large", "single_lane", "all_dead",
                "order")
VERIFY_ROWS = 10_240
VERIFY_MAX_DELTAS = 1024  # ops/kernels.py MAX_LANE_DELTAS


def verify_case(name, n=VERIFY_ROWS, seed=31):
    """numpy operands of ``allocs_fit_verify`` for case ``name``:
    ``totals``/``used`` (n, 3) f32, ``packed`` (B, P, 7) f32 (column 0 the
    row), ``asks`` (B, 3) f32 (the callers pack them into ``req_f``),
    ``drows`` (B, D) i32, ``dvals`` (B, D, 3) f32 and ``lane_mask`` (B,)."""
    rng = np.random.default_rng(seed)
    b, p, d = {"large": (64, 16, VERIFY_MAX_DELTAS),
               "single_lane": (1, 16, 32)}.get(name, (64, 16, 32))
    totals = np.round(rng.uniform(2000, 16000, (n, 3))).astype(np.float32)
    used = np.round(totals * rng.uniform(0.0, 0.8, (n, 1))).astype(np.float32)
    asks = np.round(rng.uniform(100, 1500, (b, 3))).astype(np.float32)
    packed = rng.uniform(-2, 2, (b, p, 7)).astype(np.float32)
    drows = np.full((b, d), -1, np.int32)
    dvals = np.zeros((b, d, 3), np.float32)
    lane_mask = np.ones((b,), bool)
    hot = np.array([11, 12, 13, n - 1])
    # Hot rows start one or two asks short of full.
    used[hot] = totals[hot] - 1.5 * asks.max(axis=0)
    rows = rng.choice(n, (b, p))
    if name == "bench":
        rows[b // 2:b // 2 + 12] = rng.choice(hot, (12, p))
        rows[3, -4:] = -1
        for lane in range(0, b, 5):
            k = int(rng.integers(1, 8))
            drows[lane, :k] = rng.choice(hot, k)
            dvals[lane, :k] = rng.integers(50, 400, (k, 3))
        lane_mask[b - 6:] = False
    elif name == "hot_row":
        rows[:] = hot[0]
        drows[::4, :3] = hot[0]
        dvals[::4, :3] = rng.integers(-300, 300, (len(drows[::4]), 3, 3))
    elif name == "large":
        drows[:] = rng.choice(n, (b, d))
        drows[:, ::9] = -1
        drows[:, 5::37] = n + 3  # past the matrix: dropped, as JAX drops it
        drows[:, 1::11] = rng.choice(hot, drows[:, 1::11].shape)
        dvals[:] = rng.integers(-50, 50, (b, d, 3))
        rows[::3] = rng.choice(hot, rows[::3].shape)
        lane_mask[[5, 40]] = False
    elif name == "single_lane":
        rows[0, ::2] = hot[1]
        drows[0, :6] = [hot[1], 3, hot[1], -1, n, 3]
        dvals[0, :6] = rng.integers(-200, 400, (6, 3))
    elif name == "all_dead":
        lane_mask[:] = False
        drows[:, :4] = rng.choice(hot, (b, 4))
        dvals[:, :4] = 1e9
    elif name == "order":
        big = np.float32(1e8)
        totals[hot] = big
        used[hot] = 0.0
        asks[:] = [1.0, 1.0, 1.0]
        rows[:] = rng.choice(hot, (b, p))
        rows[::7, 2] = -1
        rows[1::9, 5] = n + 1
        drows[:, :3] = rng.choice(np.append(hot, [-1, n]), (b, 3))
        dvals[:, 0] = big
        dvals[:, 1] = 1.0
        dvals[:, 2] = -big
        lane_mask[2::6] = False
    else:
        raise ValueError(name)
    packed[..., 0] = rows
    packed[~lane_mask] = rng.uniform(-2, 2, (int((~lane_mask).sum()), p, 7))
    return dict(totals=totals, used=used, packed=packed, asks=asks,
                drows=drows, dvals=dvals, lane_mask=lane_mask)


# ---------------------------------------------------------------------------
# system_feasible: every constraint kind at ragged and large node counts
# ---------------------------------------------------------------------------

SYSTEM_ROWS = (1, 31, 333, 10_240, 10_241, 80_000)
SYSTEM_REGISTERED = 96  # distinct nodes; rows past them copy their host rows


def system_case(pkg, n, seed=29):
    """A matrix of max(n, 16) rows for ``system_feasible`` at n rows (the
    callers slice the first n): up to SYSTEM_REGISTERED nodes registered
    (every fifth with two GPUs, allocs holding port 8080 on some), the
    rest copies of their host rows with usage of their own; and
    ``reqs``, a list of (label, request, class_elig, host_mask) covering
    every constraint kind the kernel evaluates, a datacenter list, a
    device ask, a static port, all sixteen constraint slots, an ask that
    exhausts nodes, and an escaped class (class ids past the end of
    ``class_elig``) with a host mask."""
    rng = np.random.default_rng(seed)
    m = pkg.NodeMatrix(capacity=max(n, 16))
    reg = min(n, SYSTEM_REGISTERED)
    nodes = []
    for i in range(reg):
        node = _node(pkg, rng, i)
        if i % 5 == 0:
            node.resources.devices = {"gpu": ["gpu-0", "gpu-1"]}
        m.upsert_node(node)
        nodes.append(node)
    for i in rng.choice(reg, size=reg // 3, replace=False):
        m.add_alloc(pkg.Allocation(
            node_id=nodes[i].id, job=pkg.Job(priority=50),
            resources=pkg.Resources(
                cpu=int(rng.integers(100, 2500)),
                memory_mb=int(rng.integers(64, 4096)),
                networks=[pkg.NetworkResource(reserved_ports=[8080])]
                if i % 2 == 0 else [])))
    host = m.snapshot_host()
    if n > reg:
        rows = np.arange(reg, n)
        for key in host:
            host[key][rows] = host[key][rows % reg]
        host["used"][rows] = np.round(host["totals"][rows] * rng.uniform(
            0.0, 0.7, (len(rows), 1)))
        m._dirty.update(range(n))
        m.version += 1

    C = pkg.Constraint
    jobs = [
        ("ordered", [C(l_target="${attr.cpu.numcores}", operand=o,
                       r_target=v)
                     for o, v in (("<", "40"), ("<=", "48"), (">", "4"),
                                  (">=", "8"))], {}),
        ("equality", [C(l_target="${attr.kernel.name}", operand="=",
                        r_target="linux"),
                      C(l_target="${attr.rack}", operand="!=",
                        r_target="r3")], {}),
        ("presence", [C(l_target="${attr.cpu.numcores}", operand="is_set"),
                      C(l_target="${attr.gpu.model}",
                        operand="is_not_set")], {}),
        ("version", [C(l_target="${attr.os.version}", operand="version",
                       r_target=">= 1.1"),
                     C(l_target="${attr.os.version}", operand="version",
                       r_target="< 3.0")], {}),
        ("nan_column", [C(l_target="${attr.rack}", operand="<",
                          r_target="100")], {}),
        ("device_dc", [], {"devices": True, "datacenters": ["dc1"]}),
        ("static_port", [], {"port": 8080}),
        ("all_slots", [C(l_target=f"${{attr.{a}}}", operand=o, r_target=v)
                       for a, o, v in (
                           ("rack", "!=", "r1"), ("rack", "!=", "r2"),
                           ("kernel.name", "=", "linux"),
                           ("cpu.numcores", ">", "2"),
                           ("cpu.numcores", "<=", "60"),
                           ("os.version", "is_set", ""),
                           ("gpu.model", "is_not_set", ""),
                           ("rack", "is_set", ""),
                           ("cpu.numcores", ">=", "3"),
                           ("cpu.numcores", "<", "64"),
                           ("kernel.name", "!=", "plan9"),
                           ("rack", "!=", "r6"),
                           ("os.version", "!=", "9.9.9"),
                           ("cpu.numcores", "!=", "7"),
                           ("rack", "!=", "r0"),
                           ("kernel.name", "is_set", ""))], {}),
        ("exhausting", [], {"cpu": 6000}),
        ("escaped", [C(l_target="${attr.rack}", operand="regexp",
                       r_target="r[0-5]")], {"escaped": True}),
    ]
    enc = pkg.RequestEncoder(m)
    n_cls = max(2, len(m.class_ids))
    reqs = []
    for label, cons, kw in jobs:
        res = pkg.Resources(cpu=kw.get("cpu", 300), memory_mb=256)
        if "port" in kw:
            res.networks = [pkg.NetworkResource(reserved_ports=[kw["port"]])]
        if kw.get("devices"):
            res.devices = [pkg.RequestedDevice(name="gpu", count=2)]
        tg = pkg.TaskGroup(name="sys", count=1, constraints=list(cons),
                           tasks=[pkg.Task(resources=res)])
        job = pkg.Job(type="system", task_groups=[tg],
                      datacenters=kw.get("datacenters", ["dc1", "dc2"]))
        req = enc.compile(job, tg).request
        class_elig = np.ones((n_cls,), bool)
        host_mask = np.ones((max(n, 16),), bool)
        if kw.get("escaped"):
            # Fewer entries than class ids: the ids past the end read the
            # last one.
            class_elig = np.array([False, True, True])
            host_mask[::7] = False
        reqs.append((label, req, class_elig, host_mask))
    return dict(m=m, reqs=reqs)


def first_rows(arrays, n):
    """A DeviceArrays-like tuple cut to its first n rows (each column a
    contiguous view)."""
    return type(arrays)(*[col[:n] for col in arrays])
