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
            "NetworkResource", "Node", "NodeResources", "Resources", "Spread",
            "SpreadTarget", "Task", "TaskGroup")})
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
