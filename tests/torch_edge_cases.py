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

:func:`sharded_case` builds the node-sharded scan's cases the same way
(``SHARDED_CASES``: spread values entering mid-scan across shards,
distinct_hosts, ties across shards, shards with no candidate, lanes at
the delta cap).  :func:`usage_case` and :func:`plan_case` give numpy
operands of ``sharded_usage`` and ``verify_plan_fit`` at the lane counts
and plan lengths their kernels' staging makes risky.
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
# sharded_place: what the hoisted scan over node shards must get right
# ---------------------------------------------------------------------------

# * ``spread_mid_scan`` — spread lanes whose value tables start with one or
#   two racks: every rack lies on every node shard (rack = (row // 10) % 8),
#   so a winner on one shard enters a value mid-scan that moves candidates
#   on the others off "no match".
# * ``distinct_hosts`` — distinct_hosts lanes (tg counts on some rows)
#   whose winners land on several shards, each row once.
# * ``cross_shard_tie`` — identical empty nodes: the first pick ties on
#   every row a lane's host mask keeps, across shards (rows 37 and 137,
#   and the rows either side of each eighth's boundary), and the lowest
#   global row must win.
# * ``empty_shard`` — rows [50, 100) masked for every lane and [100, 125)
#   down: node shards with no candidate; a lane with no candidate anywhere
#   and a lane whose only candidates are on the last eighth.
# * ``delta_cap`` — 1,024 in-flight delta rows a lane (MAX_LANE_DELTAS):
#   rows on every shard, repeats, padding.
# Every case has 8 lanes (lane 3 dead where the caller uses the mask) on
# 200 rows: 25 rows a node shard at 8 shards, a multiple of no CTA span.
SHARDED_CASES = ("spread_mid_scan", "distinct_hosts", "cross_shard_tie",
                 "empty_shard", "delta_cap")
SHARDED_ROWS = 200
SHARDED_SCAN = 6


def sharded_rack(row: int) -> str:
    """The rack of a row of a sharded case's matrix."""
    return f"r{(row // 10) % 8}"


def _sharded_jobs(pkg, name):
    C, S, T = pkg.Constraint, pkg.Spread, pkg.SpreadTarget
    rack = S(attribute="${attr.rack}", weight=70)
    dcs = S(attribute="${node.datacenter}", weight=30,
            targets=[T(value="dc1", percent=70), T(value="dc2", percent=30)])
    distinct = C(operand="distinct_hosts")
    if name == "spread_mid_scan":
        return [
            (_job(pkg, cpu=250, spreads=[rack]), "binpack", False),
            (_job(pkg, cpu=400, spreads=[rack]), "spread", False),
            (_job(pkg, cpu=300, spreads=[rack, dcs]), "binpack", False),
            (_job(pkg, cpu=200, spreads=[dcs]), "binpack", False),
            (_job(pkg, cpu=250, spreads=[rack]), "binpack", False),
            (_job(pkg, cpu=500, count=3, spreads=[rack]), "binpack", False),
            (_job(pkg, cpu=350, spreads=[rack, dcs]), "spread", False),
            (_job(pkg, cpu=150, spreads=[rack]), "binpack", False),
        ]
    if name == "distinct_hosts":
        return [(_job(pkg, cpu=200 + 150 * i, constraints=[distinct]),
                 "spread" if i == 4 else "binpack", False)
                for i in range(6)] + [
            (_job(pkg, cpu=300), "binpack", False),
            (_job(pkg, cpu=3500, mem=6000, priority=90,
                  constraints=[distinct]), "binpack", True),
        ]
    if name == "cross_shard_tie":
        return [(_job(pkg, cpu=300 + 50 * (i % 3)), "binpack", False)
                for i in range(7)] + [
            (_job(pkg, cpu=300, spreads=[rack]), "binpack", False)]
    if name == "empty_shard":
        return [(_job(pkg, cpu=300 + 100 * i), "binpack", False)
                for i in range(7)] + [
            (_job(pkg, cpu=100000, mem=100), "binpack", False)]
    if name == "delta_cap":
        return [(_job(pkg, cpu=200 + 100 * i), "binpack", False)
                for i in range(7)] + [
            (_job(pkg, cpu=300, spreads=[rack]), "binpack", False)]
    raise ValueError(name)


def sharded_case(pkg, name, seed=37):
    """Case ``name`` of SHARDED_CASES with ``pkg``'s types, in
    :func:`build`'s form (``m``, ``reqs``, the numpy lane operands,
    ``lane_mask``, ``scan``)."""
    rng = np.random.default_rng(seed)
    n = SHARDED_ROWS
    identical = name == "cross_shard_tie"
    m = pkg.NodeMatrix(capacity=n)
    nodes = []
    for i in range(n):
        node = _node(pkg, rng, i, identical)
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = sharded_rack(i)
        if name == "empty_shard" and 100 <= i < 125:
            node.status = "down"
        m.upsert_node(node)
        nodes.append(node)
    if not identical:
        for i in rng.choice(n, size=70, replace=False):
            m.add_alloc(pkg.Allocation(
                node_id=nodes[i].id,
                job=pkg.Job(priority=int(rng.integers(10, 90))),
                resources=pkg.Resources(
                    cpu=int(rng.integers(100, 2500)),
                    memory_mb=int(rng.integers(64, 4096)))))
    enc = pkg.RequestEncoder(m)
    comp = [enc.compile(j, j.task_groups[0], algorithm=alg,
                        preemption_enabled=pre)
            for j, alg, pre in _sharded_jobs(pkg, name)]
    reqs = [c.request for c in comp]
    reqs = type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])
    b = reqs.ask.shape[0]
    S, V = pkg.MAX_SPREADS, pkg.MAX_SPREAD_VALUES
    h = pkg.stable_hash
    s_hash = np.array(reqs.s_value_hash, copy=True)
    counts = np.zeros((b, S, V), np.float32)
    d = VERIFY_MAX_DELTAS if name == "delta_cap" else 4
    drows = np.full((b, d), -1, np.int32)
    dvals = np.zeros((b, d, 3), np.float32)
    tg = np.zeros((b, n), np.int32)
    pen = np.zeros((b, n), bool)
    ce = np.ones((b, max(2, len(m.class_ids))), bool)
    hm = np.ones((b, n), bool)
    lane_mask = np.ones((b,), bool)
    lane_mask[3] = False

    if name == "spread_mid_scan":
        # Tables that hold one or two racks (the rest enter mid-scan), one
        # with a free entry between used ones.
        for lane in (0, 4, 7):
            s_hash[lane, 0, :3] = [h("r0"), 0, h("r5")]
            counts[lane, 0, :3] = [3, 0, 1]
        s_hash[5, 0, 0] = h("r2")
        counts[5, 0, 0] = 2
        drows[1, :2] = [15, 115]
        dvals[1, :2] = [[400, 300, 0], [200, 100, 0]]
    elif name == "distinct_hosts":
        tg[:, ::7] = 1
        tg[2, :] = 0
        hm[5, :40] = False
        drows[0, :3] = [10, 110, 10]
        dvals[0, :3] = [[300, 200, 0], [100, 100, 0], [50, 0, 0]]
    elif name == "cross_shard_tie":
        hm[0, :] = False
        hm[0, [37, 137]] = True
        hm[1, :] = False
        hm[1, [199, 60, 120]] = True
        hm[2, :100] = False
        hm[4, :] = False
        hm[4, [24, 25, 49, 50, 74, 75]] = True
        pen[5, :100] = True
        hm[6, :] = False
        hm[6, [150, 50]] = True
    elif name == "empty_shard":
        hm[:, 50:100] = False
        hm[5, :] = False
        hm[5, 100:125] = True  # only down nodes: no candidate anywhere
        hm[6, :175] = False
        tg[1, 150:] = 2
    elif name == "delta_cap":
        drows[:] = rng.choice(n, (b, d))
        drows[:, ::9] = -1
        drows[:, 1::13] = 42  # one row many times
        dvals[:] = rng.integers(0, 40, (b, d, 3))
    reqs = reqs._replace(s_value_hash=s_hash)
    return dict(m=m, reqs=reqs, drows=drows, dvals=dvals, tg=tg,
                counts=counts, pen=pen, ce=ce, hm=hm, lane_mask=lane_mask,
                scan=SHARDED_SCAN)


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


# ---------------------------------------------------------------------------
# sharded_usage: the step's usage update on one node shard
# ---------------------------------------------------------------------------

# The wrapper's lane limit (ops/kernels.py SHARDED_USAGE_MAX_LANES, the
# kernel's 16-bit list lanes).
USAGE_MAX_LANES = 65_536
# Each case: lanes, batch rows, the shard's rows and its row offset in a
# matrix of USAGE_MATRIX_ROWS rows.
# * ``b1``, ``b63`` (three batch rows), ``b64``, ``b4096`` — B as the
#   step runs it, on the x4 mesh's node shard 1 (5,120 rows from 5,120);
# * ``ragged`` — 5,119 rows: a multiple of no CTA span;
# * ``one_row`` — every pick of both batch rows on one row;
# * ``all_failed`` — every pick -1;
# * ``outside`` — every pick a row of another shard;
# * ``last_shard`` — node shard 3 of x8 (2,560 rows from 7,680), picks
#   over the whole matrix and past it;
# * ``grouping`` — asks of 2**24 and 1.0 on a few rows: the sum depends
#   on the order and on where a batch row's part closes;
# * ``runs`` — most picks on the shard's first 40 rows (one CTA's span
#   on 132 SMs, part of one on fewer) as runs of 16 to 70 lanes on one
#   row between runs of 1 to 3 on other rows, a run across the two batch
#   rows: 16-entry blocks on one row, blocks mixing rows and windows of
#   both; a window on one row with a short tail; a window of runs on two
#   rows; order-sensitive asks;
# * ``limit`` — USAGE_MAX_LANES lanes.
USAGE_MATRIX_ROWS = 10_240
USAGE_SHAPES = {
    "b1": (1, 1, 5120, 5120),
    "b63": (63, 3, 5120, 5120),
    "b64": (64, 2, 5120, 5120),
    "b4096": (4096, 2, 5120, 5120),
    "ragged": (4096, 2, 5119, 5120),
    "one_row": (4096, 2, 5120, 5120),
    "all_failed": (4096, 2, 5120, 5120),
    "outside": (4096, 2, 2560, 2560),
    "last_shard": (4096, 2, 2560, 7680),
    "grouping": (4096, 2, 5120, 5120),
    "runs": (4096, 2, 5120, 5120),
    "limit": (USAGE_MAX_LANES, 2, 5120, 5120),
}
USAGE_CASES = tuple(USAGE_SHAPES)


def usage_case(name, seed=41):
    """numpy operands of ``sharded_usage`` for case ``name``: ``used``
    (n, 3) f32 (a few rows -0.0, which a row without picks must turn into
    +0.0 as the plain version's ``used + 0.0`` does), ``picks`` (B,) f32
    global rows (-1 a failed pick), ``asks`` (B, 3) f32, ``n_batch`` and
    ``row_offset``; :func:`usage_operands` packs them."""
    rng = np.random.default_rng(seed)
    b, n_batch, n, off = USAGE_SHAPES[name]
    used = np.round(rng.uniform(0, 4000, (n, 3))).astype(np.float32)
    used[::97] = -0.0
    picks = rng.integers(0, USAGE_MATRIX_ROWS, b).astype(np.float32)
    picks[rng.random(b) < 0.05] = -1.0
    asks = rng.uniform(10, 1500, (b, 3)).astype(np.float32)
    if name == "b1":
        picks[0] = off + 7
    elif name == "one_row":
        picks[:] = off + n // 3
    elif name == "all_failed":
        picks[:] = -1.0
    elif name == "outside":
        picks[:] = np.where(rng.random(b) < 0.5,
                            rng.integers(0, off, b),
                            rng.integers(off + n, USAGE_MATRIX_ROWS, b))
    elif name == "last_shard":
        picks[::5] = rng.integers(off, off + n, len(picks[::5]))
        picks[1::17] = USAGE_MATRIX_ROWS + 3  # past the matrix
    elif name == "grouping":
        hot = off + np.array([0, 1, 2, n - 1])
        picks[::2] = rng.choice(hot, len(picks[::2]))
        asks[::2] = 1.0
        asks[::7] = np.float32(2.0 ** 24)
        asks[::11] = -np.float32(2.0 ** 24)
    elif name == "runs":
        at = 0
        while at < b:
            long = rng.random() < 0.5
            size = int(rng.integers(16, 71) if long else rng.integers(1, 4))
            picks[at:at + size] = off + rng.integers(0, 40)
            at += size
        picks[b // 2 - 20:b // 2 + 20] = off + 5
        elsewhere = rng.random(b) < 0.04
        picks[elsewhere] = rng.integers(0, USAGE_MATRIX_ROWS,
                                        int(elsewhere.sum()))
        picks[rng.random(b) < 0.01] = -1.0
        # On 132 SMs (spans of 40 rows), the first batch row's picks in
        # the second CTA: 512 on one row (a window on one row), then 16 on
        # another and 5 on the first (a window of a run and a block cut
        # short, beside the first window's stale entries on its row); in
        # the third: 16 on one row and 16 on another (a window of runs on
        # two rows).
        second, third = (picks >= off + 40) & (picks < off + 80), \
            (picks >= off + 80) & (picks < off + 120)
        picks[second | third] = -1.0
        picks[100:612] = off + 45
        picks[612:628] = off + 46
        picks[628:633] = off + 45
        picks[1000:1016] = off + 85
        picks[1016:1032] = off + 86
        asks[::2] = 1.0
        asks[::9] = np.float32(2.0 ** 24)
    elif name not in USAGE_SHAPES:
        raise ValueError(name)
    return dict(used=used, picks=picks, asks=asks, n_batch=n_batch,
                row_offset=off)


def usage_operands(w, packed_width, req_float_width, ask_offset, p=1):
    """(used, packed (B, p, packed_width), req_f (B, req_float_width)) of
    a :func:`usage_case`, numpy: the picks in step 0's row column, the
    other columns and fields noise."""
    rng = np.random.default_rng(7)
    b = w["picks"].shape[0]
    packed = rng.uniform(-3, 3, (b, p, packed_width)).astype(np.float32)
    packed[:, 0, 0] = w["picks"]
    req_f = rng.uniform(-5, 5, (b, req_float_width)).astype(np.float32)
    req_f[:, ask_offset:ask_offset + 3] = w["asks"]
    return w["used"], packed, req_f


# ---------------------------------------------------------------------------
# verify_plan_fit: plans of every length the kernel's row groups make risky
# ---------------------------------------------------------------------------

PLAN_ROWS = (1, 3, 255, 10_000, 80_000)
PLAN_MATRIX_ROWS = 10_240


def plan_case(k, n=PLAN_MATRIX_ROWS, seed=53, padding_only=False):
    """numpy operands of ``verify_plan_fit`` for a plan of ``k`` rows on
    ``n`` nodes: ``used``/``totals`` (n, 3) f32, ``eligible`` (n,) bool,
    ``rows`` (k,) i32 (padding -1, some past the matrix), ``deltas`` (k,
    3) f32 (past the node's room, exactly its room, negative),
    ``elig_required`` (k,) bool.  ``padding_only``: every row -1."""
    rng = np.random.default_rng(seed)
    totals = np.round(rng.uniform(2000, 16000, (n, 3))).astype(np.float32)
    used = np.round(totals * rng.uniform(0.0, 0.9, (n, 1))).astype(np.float32)
    eligible = rng.random(n) < 0.9
    rows = rng.integers(0, n, k).astype(np.int32)
    rows[rng.random(k) < 0.05] = -1
    rows[rng.random(k) < 0.03] = n + rng.integers(0, 5)
    if k >= 3:
        rows[-1] = n  # past the matrix on the ragged end
        rows[-2] = -1
    if padding_only:
        rows[:] = -1
    safe = np.clip(rows, 0, n - 1)
    room = totals[safe] - used[safe]
    deltas = (room * rng.uniform(0.3, 1.3, (k, 3))).astype(np.float32)
    deltas[rng.random(k) < 0.05] *= -1.0
    exact = rng.random(k) < 0.05
    deltas[exact] = room[exact]
    elig_required = rng.random(k) < 0.6
    return dict(used=used, totals=totals, eligible=eligible, rows=rows,
                deltas=deltas, elig_required=elig_required)
