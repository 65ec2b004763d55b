"""Dispatch contracts: the port's counterpart of the reference's contract
rows (``nomad_tpu/lint/contracts.py``), for the checks that mean
something without a tracer.

Each :class:`DispatchContract` row names one dispatch entry point of the
port and the bytes its result may carry to the host.  :func:`run` calls
the entry on CPU tensors (the kernels' plain versions) at two node
counts and reports:

* **D001 node-count dependence** — the output's shape or its host bytes
  differ between the two node counts: the result that crosses to the
  host must be O(lanes · placements), never node-axis shaped;
* **D002 over budget** — the output's host bytes exceed the row's
  budget (one packed (B, P, width) float32 block).

What the reference's rows prove from a traced program has no
counterpart here, and is left out on purpose, not forgotten: the
jaxpr-level checks of ``nomad_tpu/lint/jaxprpass.py`` (no host
callbacks in the trace, nothing node-axis shaped across a shard_map
boundary), the donation sets that must survive ``lower()``, and the
compile-cache cardinality of an occupancy sweep.  The port traces
nothing, donates nothing and builds each kernel once per source; its
lane mask is a launch argument, so occupancy never rebuilds anything.
The dirty-row scatter (``NodeMatrix.sync``'s ``index_copy_``) writes the
resident matrix and returns nothing to the host, so it has no row.

Operands are built on the CPU only (``device="cpu"``); the same entries
on the card are held against these plain versions by ``chip_smoke.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np

from . import Finding


class Grid(NamedTuple):
    """One point of the check grid: ``live`` of the ``batch`` lanes are
    live, each with ``deltas`` in-flight delta rows."""

    nodes: int
    batch: int
    placements: int
    deltas: int
    live: int


@dataclass(frozen=True)
class DispatchContract:
    """One dispatch entry point: ``call(grid)`` runs it on fresh CPU
    operands and returns its result tensor; ``out_budget(grid)`` is the
    host bytes that result may carry."""

    name: str
    path: str  # repo-relative, forward slashes — Finding's path
    call: Callable[[Grid], Any]
    out_budget: Callable[[Grid], int]


# Two node counts (prime-ish, colliding with no slot width, batch,
# placement or delta dimension) prove node-count independence.
N_A, N_B = 97, 159
GRID = Grid(nodes=N_A, batch=6, placements=3, deltas=5, live=4)


def _arrays(n: int):
    from ..state.matrix import (
        ATTR_SLOTS,
        DEVICE_SLOTS,
        PORT_WORDS,
        PRIORITY_BUCKETS,
        DeviceArrays,
        host_to_tensor,
    )

    host = dict(
        totals=np.full((n, 3), 100.0, np.float32),
        used=np.zeros((n, 3), np.float32),
        eligible=np.ones((n,), bool),
        attr_hash=np.zeros((n, ATTR_SLOTS), np.int32),
        attr_num=np.zeros((n, ATTR_SLOTS), np.float32),
        attr_ver=np.zeros((n, ATTR_SLOTS), np.float32),
        class_id=np.zeros((n,), np.int32),
        dev_total=np.zeros((n, DEVICE_SLOTS), np.int32),
        dev_used=np.zeros((n, DEVICE_SLOTS), np.int32),
        prio_used=np.zeros((n, PRIORITY_BUCKETS, 3), np.float32),
        port_words=np.zeros((n, PORT_WORDS), np.uint32),
        dyn_used=np.zeros((n,), np.int32),
    )
    return DeviceArrays(**{f: host_to_tensor(f, host[f], "cpu")
                           for f in DeviceArrays._fields}), host


def _requests(b: int):
    from ..ops.encode import (
        MAX_AFFINITIES,
        MAX_CONSTRAINTS,
        MAX_DATACENTERS,
        MAX_SPREAD_VALUES,
        MAX_SPREADS,
        MAX_STATIC_PORTS,
        SchedRequest,
    )
    from ..ops.kernels import pack_requests
    from ..state.matrix import DEVICE_SLOTS

    f32, i32 = np.float32, np.int32
    req = SchedRequest(
        ask=np.ones((b, 3), f32),
        c_slot=np.full((b, MAX_CONSTRAINTS), -1, i32),
        c_op=np.zeros((b, MAX_CONSTRAINTS), i32),
        c_hash=np.zeros((b, MAX_CONSTRAINTS), i32),
        c_num=np.zeros((b, MAX_CONSTRAINTS), f32),
        dc_hash=np.full((b, MAX_DATACENTERS), -1, i32),
        dev_ask=np.zeros((b, DEVICE_SLOTS), i32),
        algorithm=np.zeros((b,), i32),
        desired_count=np.ones((b,), f32),
        a_slot=np.full((b, MAX_AFFINITIES), -1, i32),
        a_op=np.zeros((b, MAX_AFFINITIES), i32),
        a_hash=np.zeros((b, MAX_AFFINITIES), i32),
        a_num=np.zeros((b, MAX_AFFINITIES), f32),
        a_weight=np.zeros((b, MAX_AFFINITIES), f32),
        s_slot=np.full((b, MAX_SPREADS), -1, i32),
        s_weight=np.zeros((b, MAX_SPREADS), f32),
        s_even=np.zeros((b, MAX_SPREADS), bool),
        s_value_hash=np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES), i32),
        s_desired=np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES), f32),
        s_implicit=np.zeros((b, MAX_SPREADS), f32),
        s_sum_weights=np.zeros((b,), f32),
        preempt_bucket=np.full((b,), -1, i32),
        distinct_hosts=np.zeros((b,), bool),
        p_static=np.full((b, MAX_STATIC_PORTS), -1, i32),
        p_dyn=np.zeros((b,), i32),
    )
    return pack_requests(req)


def lane_operands(g: Grid) -> Tuple[Any, ...]:
    """The lanes' host operands in the coalescer's order: delta rows and
    values, tg counts, spread counts, penalties, packed requests, class
    eligibility, host masks and the lane mask."""
    from ..ops.encode import MAX_SPREAD_VALUES, MAX_SPREADS

    n, b, k = g.nodes, g.batch, g.deltas
    lane_mask = np.zeros((b,), bool)
    lane_mask[:g.live] = True
    ri, rf = _requests(b)
    return (
        np.full((b, k), -1, np.int32),
        np.zeros((b, k, 3), np.float32),
        np.zeros((b, n), np.int32),
        np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32),
        np.zeros((b, n), bool),
        ri, rf,
        np.ones((b, 2), bool),
        np.ones((b, n), bool),
        lane_mask,
    )


def _tensors(ops):
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in ops)


def _fused(g: Grid):
    from ..ops import kernels

    arrays, _ = _arrays(g.nodes)
    return kernels.fused_place_batch(arrays, arrays.used,
                                     *_tensors(lane_operands(g)),
                                     g.placements, kernels.FULL_FEATURES)


def _staged(g: Grid):
    from ..ops import kernels

    arrays, _ = _arrays(g.nodes)
    ops = _tensors(lane_operands(g))[:-1]  # every lane live, no mask
    return kernels.place_batch(arrays, arrays.used, *ops, g.placements,
                               kernels.FULL_FEATURES)


def _sharded(g: Grid):
    from ..parallel import sharding
    from ..state.matrix import DeviceArrays

    mesh = sharding.make_mesh(devices=["cpu"], batch=1)
    _, host = _arrays(g.nodes)
    sharded = sharding.shard_matrix_arrays(
        mesh, DeviceArrays(**{f: host[f] for f in DeviceArrays._fields}))
    fn = sharding.sharded_fused_place_batch(mesh, g.placements)
    return fn(sharded, *lane_operands(g))


def _packed_budget(width: int) -> Callable[[Grid], int]:
    # One packed (B, P, width) float32 result: 4·width bytes a placement
    # row a lane, whatever the node count.
    return lambda g: g.batch * g.placements * width * 4


def table() -> Tuple[DispatchContract, ...]:
    from ..ops.kernels import FUSED_PACKED_WIDTH, PACKED_WIDTH

    return (
        DispatchContract(
            name="fused_place_batch",
            path="nomad_tpu_torch/ops/kernels.py",
            call=_fused,
            out_budget=_packed_budget(FUSED_PACKED_WIDTH),
        ),
        DispatchContract(
            name="place_batch",
            path="nomad_tpu_torch/ops/kernels.py",
            call=_staged,
            out_budget=_packed_budget(PACKED_WIDTH),
        ),
        DispatchContract(
            name="sharded_fused_place_batch",
            path="nomad_tpu_torch/parallel/sharding.py",
            call=_sharded,
            out_budget=_packed_budget(FUSED_PACKED_WIDTH),
        ),
    )


def check(c: DispatchContract, grid: Grid = GRID,
          other_nodes: int = N_B) -> List[Finding]:
    """D001/D002 for one row: the entry at ``grid`` and at
    ``other_nodes`` nodes."""
    findings: List[Finding] = []
    outs = []
    for n in (grid.nodes, other_nodes):
        g = grid._replace(nodes=n)
        out = c.call(g)
        outs.append((g, tuple(out.shape), out.numel() * out.element_size()))
    (ga, shape_a, bytes_a), (gb, shape_b, bytes_b) = outs
    if shape_a != shape_b or bytes_a != bytes_b:
        findings.append(Finding(
            "D001", c.path, 1, c.name,
            f"result depends on the node count: {shape_a} ({bytes_a} B) at "
            f"N={ga.nodes}, {shape_b} ({bytes_b} B) at N={gb.nodes} — only "
            f"an O(lanes·placements) block may cross to the host",
        ))
    for g, shape, nbytes in outs:
        budget = c.out_budget(g)
        if nbytes > budget:
            findings.append(Finding(
                "D002", c.path, 1, c.name,
                f"result {shape} carries {nbytes} B to the host at "
                f"N={g.nodes}, over the row's budget of {budget} B",
            ))
            break
    return findings


def run(root: str = "") -> List[Finding]:
    """Every row of :func:`table`, on the CPU."""
    findings: List[Finding] = []
    for c in table():
        findings += check(c)
    return findings
